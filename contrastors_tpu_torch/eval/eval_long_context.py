"""Long-context retrieval evaluation (LoCo / Jina-LC style), counterpart of
`contrastors_tpu/eval/eval_long_context.py`.

BEIR-format retrieval over documents of 2048-8192 tokens. Past the trained
window the rotary base is stretched by DynamicNTK (`layers/rotary.py:
ntk_scaled_base`), inference only: `build_long_context_encoder` sets
`rotary_scaling_factor` on the trunk config when seq_len exceeds
max_trained_positions. The scaled base depends on the length of the batch
it rotates, so every power-of-two bucket of the Encoder gets the table of
its own length, as in JAX.

Dataset layout (local, BEIR): <dir>/corpus.jsonl ({_id, title?, text}),
queries.jsonl ({_id, text}), qrels.tsv (qid \\t did \\t rel; a header line
is skipped). `eval/loco_data.py` writes such directories.

  python -m contrastors_tpu_torch.eval.eval_long_context \\
      --model_name <dir> --data <dir> [--seq_len 8192] \\
      [--rotary_scaling_factor 2.0] [--batch_size 8] [--device cuda] [--dtype bf16]
"""

import argparse
import json
import os


def load_beir_dir(path):
    """(corpus, queries, qrels) of a BEIR-format directory."""
    corpus, queries, qrels = {}, {}, {}
    with open(os.path.join(path, "corpus.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            corpus[str(r["_id"])] = {"title": r.get("title", ""), "text": r["text"]}
    with open(os.path.join(path, "queries.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            queries[str(r["_id"])] = r["text"]
    with open(os.path.join(path, "qrels.tsv")) as f:
        for line in f:
            parts = line.strip().split("\t")
            if parts[0].lower() in ("query-id", "qid"):
                continue
            qid, did, rel = parts[:3]
            qrels.setdefault(qid, {})[did] = int(float(rel))
    return corpus, queries, qrels


def build_long_context_encoder(
    model_name: str,
    seq_len: int = 8192,
    rotary_scaling_factor: float = 2.0,
    batch_size: int = 8,
    query_prefix="search_query",
    document_prefix="search_document",
    dtype="bf16",
    device="cuda",
    tokenizer=None,
):
    """An `Encoder` over a local checkpoint with mean pooling, DynamicNTK on
    (`rotary_scaling_factor`) when the trunk is rotary and seq_len exceeds
    its max_trained_positions. `tokenizer` defaults to the directory's
    AutoTokenizer."""
    from contrastors_tpu_torch.config import ModelArgs
    from contrastors_tpu_torch.eval.encoder import Encoder, auto_tokenizer, load_encoder_model
    from contrastors_tpu_torch.models.auto import resolve_trunk_config

    overrides = {}
    _, _, _, cfg = resolve_trunk_config(ModelArgs(model_type="encoder", model_name=model_name, pooling="mean"))
    if cfg.rotary_emb_fraction > 0 and seq_len > cfg.max_trained_positions:
        overrides["rotary_scaling_factor"] = rotary_scaling_factor
    module, _ = load_encoder_model(model_name, "mean", dtype, device, trunk_overrides=overrides)
    return Encoder(
        module, tokenizer if tokenizer is not None else auto_tokenizer(model_name),
        seq_len=seq_len, batch_size=batch_size, query_prefix=query_prefix, document_prefix=document_prefix,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="long-context retrieval over local BEIR-format dirs")
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--data", required=True, nargs="+", help="BEIR-format dirs")
    parser.add_argument("--seq_len", type=int, default=8192)
    parser.add_argument("--rotary_scaling_factor", type=float, default=2.0)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--ks", type=int, nargs="+", default=[10])
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    args = parser.parse_args(argv)

    from contrastors_tpu_torch.eval.retrieval import run_beir_dirs

    enc = build_long_context_encoder(args.model_name, args.seq_len, args.rotary_scaling_factor, args.batch_size,
                                     dtype=args.dtype, device=args.device)
    return run_beir_dirs(enc, args.data, ks=args.ks, output=args.output)


if __name__ == "__main__":
    main()
