"""Train-to-signal: the trainer LEARNS, not only lowers its loss.
Counterpart of `contrastors_tpu/scripts/train_to_signal.py`.

A learnable topic corpus (the same world, draw for draw, as JAX's): T
disjoint topics, each owning a block of vocabulary words split into a query
half and a document half, so a query and its relevant document share no
word. A model at init ranks near chance; ranking the held-out same-topic
document first needs the query-word -> document-word association learnt
from the training pairs. The pretrain-style recipe trains through the
port's `TextTextTrainer` (`train.run`'s trainer) for a few hundred steps,
and its in-train retrieval eval (`Encoder` + `evaluate_retrieval`) runs
before and after. JAX's bars hold the result: nDCG@10 after training above
its value at init, and above 0.9.

Text goes through `eval/stub_tokenizer.py:VocabTokenizer` over the world's
vocab.txt, which gives `BertTokenizerFast`'s ids there. `build_world`
writes JAX's files: where `transformers` and `safetensors` import it
writes JAX's HF checkpoint (torch.manual_seed(0) weights, tokenizer
files); elsewhere (the card's machine) config.json, vocab.txt and the same
weights, built without transformers (`hf_bert_state_dict`), as
pytorch_model.bin. The run starts from those weights, as JAX's does. The model's head dim is 16, so its
attention runs the plain `sdpa`, as JAX's does (`attn_impl: sdpa`).

  python -m contrastors_tpu_torch.scripts.train_to_signal \\
      [--out result.json] [--steps 320] [--device cuda]

prints its result as JSON (the loss curve too) and writes it where --out
is given.
"""

import argparse
import json
import os
import pathlib
import shutil
import tempfile

import numpy as np

TOPICS = 128
WORDS_PER_TOPIC = 12
PAIRS_PER_TOPIC = 64
BATCH = 128
SPECIAL = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
# the tiny BERT of JAX's world (transformers' BertConfig fields)
BERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, type_vocab_size=2, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def vocab_words():
    return [f"word{i}" for i in range(TOPICS * WORDS_PER_TOPIC)]


def hf_initialise(model, init) -> dict:
    """`init` applied to every module of model children first, as
    transformers' `post_init` applies `_init_weights`; the state dict."""
    for m in model.children():
        hf_initialise(m, init)
    init(model)
    return model.state_dict()


def hf_bert_state_dict(vocab_size: int, seed: int, hf_config) -> dict:
    """The state dict of transformers' `BertModel(BertConfig(...))` built at
    torch.manual_seed(seed), without transformers: the same modules built
    in the same order (each one's default init drawing from the generator
    as it is built), then BertPreTrainedModel._init_weights applied children
    first (transformers 4.57; the tests hold it equal to HF's bit for
    bit)."""
    import torch
    from torch import nn

    H, n_int = hf_config["hidden_size"], hf_config["intermediate_size"]

    def holder(**children):
        m = nn.Module()
        for k, v in children.items():
            setattr(m, k, v)
        return m

    torch.manual_seed(seed)
    embeddings = holder(word_embeddings=nn.Embedding(vocab_size, H, padding_idx=0),
                        position_embeddings=nn.Embedding(hf_config["max_position_embeddings"], H),
                        token_type_embeddings=nn.Embedding(hf_config["type_vocab_size"], H),
                        LayerNorm=nn.LayerNorm(H, eps=1e-12))
    layers = nn.ModuleList()
    for _ in range(hf_config["num_hidden_layers"]):
        self_attn = holder(query=nn.Linear(H, H), key=nn.Linear(H, H), value=nn.Linear(H, H))
        attention = holder(self=self_attn, output=holder(dense=nn.Linear(H, H), LayerNorm=nn.LayerNorm(H, eps=1e-12)))
        layers.append(holder(attention=attention, intermediate=holder(dense=nn.Linear(H, n_int)),
                             output=holder(dense=nn.Linear(n_int, H), LayerNorm=nn.LayerNorm(H, eps=1e-12))))
    model = holder(embeddings=embeddings, encoder=holder(layer=layers), pooler=holder(dense=nn.Linear(H, H)))
    std = 0.02

    def init(m):
        if isinstance(m, nn.Linear):
            m.weight.data.normal_(mean=0.0, std=std)
            if m.bias is not None:
                m.bias.data.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.data.normal_(mean=0.0, std=std)
            if m.padding_idx is not None:
                m.weight.data[m.padding_idx].zero_()
        elif isinstance(m, nn.LayerNorm):
            m.bias.data.zero_()
            m.weight.data.fill_(1.0)

    with torch.no_grad():
        return hf_initialise(model, init)


def write_bert(ckpt: pathlib.Path, vocab, seed: int, hf_config, weights: bool):
    """A tiny BERT checkpoint directory: with transformers, JAX's (HF
    BertModel at torch.manual_seed(seed), BertTokenizerFast files);
    without, the config.json that `BertConfig.save_pretrained` would hold
    the model's geometry in, vocab.txt, and the same weights
    (`hf_bert_state_dict`) as pytorch_model.bin."""
    ckpt.mkdir(parents=True)
    if weights:
        import torch
        from safetensors.torch import save_file
        from transformers import BertConfig, BertModel, BertTokenizerFast

        torch.manual_seed(seed)
        cfg = BertConfig(vocab_size=len(vocab), **hf_config)
        cfg.save_pretrained(str(ckpt))
        save_file({k: v.contiguous() for k, v in BertModel(cfg).state_dict().items()},
                  str(ckpt / "model.safetensors"))
        (ckpt / "vocab.txt").write_text("\n".join(vocab))
        BertTokenizerFast(vocab_file=str(ckpt / "vocab.txt")).save_pretrained(str(ckpt))
        return
    import torch

    cfg = dict(model_type="bert", architectures=["BertModel"], vocab_size=len(vocab), hidden_act="gelu",
               layer_norm_eps=1e-12, pad_token_id=0, position_embedding_type="absolute", **hf_config)
    (ckpt / "config.json").write_text(json.dumps(cfg, indent=2))
    (ckpt / "vocab.txt").write_text("\n".join(vocab))
    torch.save(hf_bert_state_dict(len(vocab), seed, hf_config), ckpt / "pytorch_model.bin")


def hf_available() -> bool:
    try:
        import safetensors  # noqa: F401
        import transformers  # noqa: F401
    except ImportError:
        return False
    return True


def build_world(tmp: pathlib.Path, seed: int = 0, weights=None):
    """JAX's world: (checkpoint dir, pairs.jsonl, BEIR-format retrieval dir
    of corpus.jsonl / queries.jsonl / qrels.tsv). weights: write JAX's HF
    checkpoint files with transformers (default: where transformers and
    safetensors import); else the same weights through
    `hf_bert_state_dict`."""
    rng = np.random.default_rng(seed)
    ckpt = tmp / "tiny-bert"
    write_bert(ckpt, SPECIAL + vocab_words(), 0, BERT, hf_available() if weights is None else weights)

    def sample_text(topic: int, n_words: int, side: str) -> str:
        # query side draws from the topic's first word-half, document side
        # from the second: no lexical overlap between query and document
        half = WORDS_PER_TOPIC // 2
        lo = topic * WORDS_PER_TOPIC + (0 if side == "q" else half)
        ws = rng.integers(lo, lo + half, size=n_words)
        return " ".join(f"word{w}" for w in ws)

    pairs = tmp / "pairs.jsonl"
    with open(pairs, "w") as f:
        for t in range(TOPICS):
            for _ in range(PAIRS_PER_TOPIC):
                f.write(json.dumps({
                    "query": sample_text(t, int(rng.integers(4, 9)), "q"),
                    "document": sample_text(t, int(rng.integers(12, 25)), "d"),
                }) + "\n")

    ev = tmp / "nanobeir"
    ev.mkdir()
    with open(ev / "corpus.jsonl", "w") as f:
        for t in range(TOPICS):
            f.write(json.dumps({"_id": f"d{t}", "title": "", "text": sample_text(t, 20, "d")}) + "\n")
    with open(ev / "queries.jsonl", "w") as f:
        for t in range(TOPICS):
            f.write(json.dumps({"_id": f"q{t}", "text": sample_text(t, 6, "q")}) + "\n")
    with open(ev / "qrels.tsv", "w") as f:
        for t in range(TOPICS):
            f.write(f"q{t}\td{t}\t1\n")
    return str(ckpt), str(pairs), str(ev)


def world_tokenizer(ckpt: str):
    from contrastors_tpu_torch.eval.stub_tokenizer import VocabTokenizer

    with open(os.path.join(ckpt, "vocab.txt")) as f:
        return VocabTokenizer(f.read().split("\n"))


def run_config(ckpt: str, pairs: str, ev_dir: str, out_dir: str, steps: int, lr: float):
    """JAX's run config (the finetune recipe's shape: linear schedule and
    warmup, lr scaled up for the tiny random-init model)."""
    from contrastors_tpu_torch.config import Config

    return Config.from_dict(dict(
        train_args=dict(num_train_steps=steps, learning_rate=lr, weight_decay=0.01,
                        warmup_steps=max(steps // 10, 1), schedule_type="linear", max_grad_norm=1.0,
                        adam_beta1=0.9, adam_beta2=0.999, log_lr_every=10, log_grads_every=1000, wandb=False,
                        output_dir=out_dir, clamp_logits=True),
        data_args=dict(input_shards=pairs, batch_size=BATCH, seed=0, workers=0, shuffle=True, streaming=False,
                       query_max_length=16, document_max_length=32, eval_retrieval=ev_dir, eval_batch_size=64),
        model_args=dict(model_type="encoder", model_name=ckpt, pooling="mean", logit_scale=50,
                        trainable_logit_scale=False, pretrained=True, attn_impl="sdpa", num_negatives=-1),
    ))


def run(steps: int = 320, lr: float = 1e-3, tmp=None, device="cuda", dtype: str = "fp32", weights=None,
        log=print):
    """Build the world in tmp (a new temporary directory by default, removed
    after), eval, train `steps` steps, eval again: the result dict."""
    from contrastors_tpu_torch.trainers import TextTextTrainer

    own = tmp is None
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="train_to_signal_") if own else tmp)
    try:
        ckpt, pairs, ev_dir = build_world(tmp, weights=weights)
        out_dir = str(tmp / "run")
        tok = world_tokenizer(ckpt)

        class SignalTrainer(TextTextTrainer):
            def get_tokenizer(self):
                return tok

        trainer = SignalTrainer(run_config(ckpt, pairs, ev_dir, out_dir, steps, lr), dtype, device)
        before = trainer.eval_loop(step=0)
        log("init:", {k: round(v, 4) for k, v in before.items()})
        steps_run = trainer.train()
        after = trainer.eval_loop(step=steps_run)
        log("after:", {k: round(v, 4) for k, v in after.items()})
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    key = "retrieval/ndcg@10"
    return {
        "steps": steps_run,
        "batch": BATCH,
        "topics": TOPICS,
        "ndcg@10_init": before[key],
        "ndcg@10_after": after[key],
        "recall@10_init": before["retrieval/recall@10"],
        "recall@10_after": after["retrieval/recall@10"],
        "loss_curve": [(m["step"], m["loss"]) for m in metrics if "loss" in m and "step" in m],
        "device": str(trainer.device),
    }


def check(result) -> None:
    """JAX's bars: nDCG@10 above its value at init, and above 0.9."""
    b, a = result["ndcg@10_init"], result["ndcg@10_after"]
    if not a > b:
        raise AssertionError(f"retrieval did not improve over init: {b} -> {a}")
    if not a > 0.9:
        raise AssertionError(f"trained nDCG@10 {a} below the learnable-corpus bar 0.9")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the result JSON here too")
    ap.add_argument("--steps", type=int, default=320)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tmp", default=None, help="the world's directory (default: a temporary one, removed)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"])
    args = ap.parse_args(argv)
    tmp = None
    if args.tmp:
        tmp = pathlib.Path(args.tmp)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    result = run(args.steps, args.lr, tmp, args.device, args.dtype)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    check(result)
    print("TRAIN-TO-SIGNAL OK")
    return result


if __name__ == "__main__":
    main()
