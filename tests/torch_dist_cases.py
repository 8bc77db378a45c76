"""What each rank runs for tests/test_torch_dist.py (through
tests/torch_dist_worker.py): a trainer's refusals, the all-gather, the
host reductions, the losses' group forms, grad cache over the data axis
(dense and MoE), the dropout draws, the Encoder's mesh form and the
sharded AdamW. Inputs come
from numpy generators with fixed seeds (the test process rebuilds them for
JAX from the same functions) and, for grad cache, from the state dicts the
test process writes to the work directory. No JAX here."""

import os

import numpy as np
import torch
import torch.distributed as dist

from contrastors_tpu_torch.grad_cache import chunk_generator, grad_cache_loss_and_grads
from contrastors_tpu_torch.losses import (clip_loss, clip_loss_symmetric, matryoshka_clip_loss,
                                          router_aux_loss)
from contrastors_tpu_torch.losses_distill import _infonce, distill_loss
from contrastors_tpu_torch.ops.dropout import dropout, noise_seed, site_generator, step_generator
from contrastors_tpu_torch.parallel import all_gather_rows, make_mesh, reduce_metrics
from contrastors_tpu_torch.utils.dist import process_allmean, process_allmin

GROUP = dist.group.WORLD
N, DIM, SCALE, TEMP = 16, 8, 10.0, 0.05
MATRYOSHKA = dict(dims=(4, 8), weights=(1.0, 0.5))
# router aux: L layers of B x S tokens, E experts, top-k
AUX_L, AUX_B, AUX_S, AUX_E, AUX_K = 2, 8, 4, 4, 2
# grad cache: the tiny BiEncoders' presets and the batch
DENSE = dict(n_layer=2, n_embd=64, n_head=2, n_inner=128, vocab_size=256)
MOE = dict(n_layer=2, n_embd=64, n_head=2, n_inner=128, vocab_size=256, num_experts=4, moe_top_k=2,
           moe_every_n_layers=2)
GC_PAIRS, GC_LQ, GC_LD, GC_CHUNK, GC_AUX = 8, 6, 10, 2, 0.01
KEEP = 0.9
MASK_N = 20000


def rows(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def loss_inputs():
    """The global q, d, d with one hard negative per query (pos, neg
    interleaved), teacher q and d, and the router aux's logits [L, B*S, E]
    and mask [B, S]."""
    rng = np.random.default_rng(7)
    f = lambda *s: _unit(rng.normal(size=s)).astype(np.float32)  # noqa: E731
    out = dict(q=f(N, DIM), d=f(N, DIM), d_neg=f(2 * N, DIM), tq=f(N, DIM), td=f(N, DIM))
    out["router_logits"] = rng.normal(size=(AUX_L, AUX_B * AUX_S, AUX_E)).astype(np.float32)
    out["router_mask"] = (np.arange(AUX_S)[None] < rng.integers(1, AUX_S + 1, size=AUX_B)[:, None]).astype(np.int64)
    return out


def gc_batches(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(5, 250, size=(GC_PAIRS, GC_LQ))
    d = rng.integers(5, 250, size=(GC_PAIRS, GC_LD))
    d[:, :GC_LQ] = q
    d_mask = (np.arange(GC_LD)[None] < rng.integers(GC_LQ, GC_LD + 1, size=GC_PAIRS)[:, None]).astype(np.int64)
    return ({"input_ids": q, "attention_mask": np.ones_like(q)},
            {"input_ids": d * d_mask, "attention_mask": d_mask})


def case_gather(rank, world, workdir):
    """all_gather_rows of this rank's rows, and the gradient of
    sum(gathered * (W + rank)) for its rows."""
    x_all = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    w = np.random.default_rng(1).normal(size=(6, 3)).astype(np.float32)
    x = torch.tensor(rows(x_all, rank, world), requires_grad=True)
    y = all_gather_rows(x, GROUP)
    (y * (torch.from_numpy(w) + rank)).sum().backward()
    return {"gathered": y.detach(), "grad": x.grad}


def case_reductions(rank, world, workdir):
    host = {"metric": float(10 * (rank + 1)), "other": float(rank) - 0.5, "name": "kept"}
    device = {"loss": torch.tensor(1.0 + rank), "router_aux": torch.tensor(0.25), "accuracy": torch.tensor(float(rank))}
    summed = reduce_metrics(device, GROUP, summed=("loss", "router_aux"))
    return {"mean": process_allmean(host), "min": process_allmin(host),
            "device": {k: float(v) for k, v in reduce_metrics(device, GROUP).items()},
            "device_summed": {k: float(v) for k, v in summed.items()}}


def case_losses(rank, world, workdir):
    """Each loss's local value (and accuracy) and the gradients of its
    global form (the mean over ranks, or the router aux's summed shares)
    for this rank's rows."""
    x = loss_inputs()
    local = {k: torch.tensor(rows(v, rank, world)) for k, v in x.items() if k not in ("router_logits", "router_mask")}
    scale = lambda s: s * SCALE  # noqa: E731
    fns = {
        "clip": lambda t: clip_loss(t["q"], t["d"], scale, group=GROUP),
        "clip_neg": lambda t: clip_loss(t["q"], t["d_neg"], scale, group=GROUP),
        "clip_bidirectional": lambda t: clip_loss(t["q"], t["d"], scale, bidirectional=True, group=GROUP),
        "symmetric": lambda t: (clip_loss_symmetric(t["q"], t["d"], scale, group=GROUP), None),
        "matryoshka": lambda t: matryoshka_clip_loss(t["q"], t["d"], scale, group=GROUP, **MATRYOSHKA),
        "infonce": lambda t: (_infonce(t["q"], t["d"], TEMP, GROUP), None),
        "towers": lambda t: (distill_loss("towers", t["q"], t["d"], t["tq"], t["td"], TEMP, group=GROUP)["loss"],
                             None),
    }
    out = {}
    for name, fn in fns.items():
        t = {k: v.clone().requires_grad_(k in ("q", "d", "d_neg")) for k, v in local.items()}
        loss, acc = fn(t)
        (loss / world).backward()
        out[name] = {"loss": loss.detach(), "accuracy": acc,
                     "grads": {k: v.grad for k, v in t.items() if v.grad is not None}}
    # the router aux: this rank's share (its value over the world size) of
    # the global tokens' loss, what the standard step backpropagates
    logits = torch.tensor(x["router_logits"]).reshape(AUX_L, AUX_B, AUX_S, AUX_E)
    logits = rows(logits.transpose(0, 1), rank, world).transpose(0, 1).reshape(AUX_L, -1, AUX_E)
    logits = logits.contiguous().requires_grad_()
    mask = torch.tensor(rows(x["router_mask"], rank, world))
    share = router_aux_loss(list(logits), AUX_E, AUX_K, attention_mask=mask, group=GROUP) / world
    share.backward()
    out["router_aux"] = {"share": share.detach(), "grad": logits.grad}
    return out


def _tiny_biencoder(workdir, kind):
    from contrastors_tpu_torch.models import BiEncoder, LogitScale
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    state = torch.load(os.path.join(workdir, f"gc_{kind}.pt"))
    model = BiEncoder(nomic_bert_2048(attn_impl="flash", **(MOE if kind == "moe" else DENSE)), pooling="mean",
                      device="cpu")
    model.load_state_dict(state["model"], strict=True)
    scale = LogitScale(SCALE, trainable=True, device="cpu")
    scale.load_state_dict(state["logit_scale"], strict=True)
    return model, scale


def _grad_cache(rank, world, workdir, kind):
    from contrastors_tpu_torch.trainers.text_text import encode_batch

    model, scale = _tiny_biencoder(workdir, kind)
    qb, db = ({k: torch.from_numpy(rows(v, rank, world)) for k, v in b.items()} for b in gc_batches())

    def loss_fn(q, d, s):
        loss, acc = clip_loss(q, d, s, group=GROUP)
        return loss, {"accuracy": acc}

    loss, metrics = grad_cache_loss_and_grads(
        model, qb, db, encode_batch, encode_batch, loss_fn, chunk_size=GC_CHUNK, extra_params=scale,
        router_aux_coef=GC_AUX if kind == "moe" else 0.0, return_metrics=True, loss_has_aux=True, group=GROUP)
    grads = {f"model.{n}": p.grad for n, p in model.named_parameters()}
    grads.update({f"logit_scale.{n}": p.grad for n, p in scale.named_parameters()})
    return {"loss": loss, "metrics": metrics, "grads": grads}


def case_grad_cache_dense(rank, world, workdir):
    return _grad_cache(rank, world, workdir, "dense")


def case_grad_cache_moe(rank, world, workdir):
    return _grad_cache(rank, world, workdir, "moe")


def case_dropout(rank, world, workdir):
    """Keep masks of one rank: the standard step's (the step generator with
    the rank folded in, then a site's generator) and grad cache's (a chunk
    generator with the rank)."""
    step = step_generator(torch.Generator().manual_seed(5), rank)
    ones = torch.ones(MASK_N)
    standard = dropout(ones, 1 - KEEP, site_generator(noise_seed(step), 0, device="cpu")) != 0
    chunk = dropout(ones, 1 - KEEP, chunk_generator(123, 0, 0, "cpu", rank)) != 0
    return {"standard": standard, "chunk": chunk}


def case_encoder(rank, world, workdir):
    """The Encoder's mesh form against the same Encoder on one rank's
    whole batches, on every rank."""
    from contrastors_tpu_torch.eval.encoder import Encoder
    from contrastors_tpu_torch.eval.stub_tokenizer import StubTokenizer
    from contrastors_tpu_torch.models import BiEncoder
    from contrastors_tpu_torch.models.presets import nomic_bert_2048

    torch.manual_seed(0)
    model = BiEncoder(nomic_bert_2048(attn_impl="flash", **DENSE), pooling="mean", device="cpu")
    texts = [" ".join(f"w{(i * 7 + j) % 50}" for j in range(1 + i % 9)) for i in range(23)]
    kw = dict(seq_len=16, batch_size=5, query_prefix=None, document_prefix=None)
    tok = StubTokenizer(vocab_size=256)
    alone = Encoder(model, tok, **kw).encode(texts)
    meshed = Encoder(model, tok, mesh=make_mesh(), **kw).encode(texts)
    return {"alone": alone, "meshed": meshed}


def case_sharded_adamw(rank, world, workdir):
    """Three clipped AdamW steps on the same summed gradients, with the
    moments of the two large leaves sharded and replicated: the parameters
    of each run, and the moment shapes of the sharded one."""
    from contrastors_tpu_torch.parallel.collectives import all_reduce_grads
    from contrastors_tpu_torch.parallel.sharding import shard_optimizer_state
    from contrastors_tpu_torch.utils.optim import make_optimizer

    runs = {}
    for sharded in (False, True):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.LayerNorm(64), torch.nn.Linear(64, 30))
        opt = make_optimizer(model.named_parameters(), 1e-2, weight_decay=0.1, max_grad_norm=0.5)
        if sharded:
            opt = shard_optimizer_state(opt, make_mesh(), min_size=1000)
        gen = torch.Generator().manual_seed(rank)
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            x = torch.randn(8, 32, generator=gen)
            model(x).square().mean().backward()
            all_reduce_grads(model.parameters(), GROUP)
            opt.step()
        runs[sharded] = {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                         "grad_norm": opt.grad_norm.clone(),
                         "moments": [tuple(s["exp_avg"].shape) for s in opt.state.values()]}
    return runs


def case_refusals(rank, world, workdir):
    """What a trainer on this group refuses: a global batch that does not
    divide over the ranks, and a data axis other than the world size."""
    from contrastors_tpu_torch.config import Config
    from contrastors_tpu_torch.trainers import TextTextTrainer

    out = {}
    for name, batch, data in (("batch", 15, -1), ("data", 16, 4)):
        raw = dict(train_args=dict(learning_rate=1e-3), parallel_args=dict(data=data),
                   data_args=dict(batch_size=batch, input_shards="pairs.jsonl"),
                   model_args=dict(model_type="encoder", model_name="m"))
        try:
            TextTextTrainer(Config.from_dict(raw), "fp32", "cpu")
        except ValueError as e:
            out[name] = str(e)
    return out


CASES = {
    "refusals": case_refusals,
    "gather": case_gather,
    "reductions": case_reductions,
    "losses": case_losses,
    "grad_cache_dense": case_grad_cache_dense,
    "grad_cache_moe": case_grad_cache_moe,
    "dropout": case_dropout,
    "encoder": case_encoder,
    "sharded_adamw": case_sharded_adamw,
}
