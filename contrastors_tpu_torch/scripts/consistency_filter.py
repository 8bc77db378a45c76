"""Consistency filtering of noisy pairs, counterpart of
`contrastors_tpu/scripts/consistency_filter.py`: embed with a teacher and
keep a pair only when its document ranks in its query's top_k against a
pool of documents (all of them, or `pool_size` drawn with numpy's
default_rng(seed)). The pool is scored exactly, one product a chunk of
queries on the device.

  python -m contrastors_tpu_torch.scripts.consistency_filter \\
      --pairs data/pairs.jsonl --model <teacher dir> --output kept.jsonl \\
      [--top_k 2] [--pool_size 100000] [--device cuda] [--dtype fp32]
"""

import argparse
import json

import numpy as np
import torch


def consistency_keep_mask(
    query_embs: np.ndarray,
    doc_embs: np.ndarray,
    top_k: int = 2,
    pool_size: int = 0,
    seed: int = 0,
    chunk: int = 1024,
    device="cuda",
) -> np.ndarray:
    """keep[i]: fewer than top_k pool documents outscore document i for
    query i."""
    from contrastors_tpu_torch._device import resolve_device

    device = resolve_device(device)
    n = len(query_embs)
    rng = np.random.default_rng(seed)
    if pool_size and pool_size < n:
        pool_idx = rng.choice(n, size=pool_size, replace=False)
    else:
        pool_idx = np.arange(n)
    pool = torch.from_numpy(np.ascontiguousarray(doc_embs[pool_idx], np.float32)).to(device)
    keep = np.zeros(n, dtype=bool)
    for start in range(0, n, chunk):
        q_np = query_embs[start:start + chunk]
        q = torch.from_numpy(np.ascontiguousarray(q_np, np.float32)).to(device)
        pos = torch.from_numpy(np.einsum("nd,nd->n", q_np, doc_embs[start:start + chunk]).astype(np.float32))
        higher = ((q @ pool.T) > pos.to(device)[:, None]).sum(dim=1).cpu().numpy()
        keep[start:start + q.shape[0]] = higher < top_k
    return keep


def main(argv=None):
    parser = argparse.ArgumentParser(description="keep the pairs whose document ranks in its query's top_k")
    parser.add_argument("--pairs", required=True)
    parser.add_argument("--model", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--top_k", type=int, default=2)
    parser.add_argument("--pool_size", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="fp32", choices=["bf16", "fp32"])
    args = parser.parse_args(argv)

    from contrastors_tpu_torch.eval.encoder import Encoder, auto_tokenizer, load_encoder_model

    with open(args.pairs) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    module, _ = load_encoder_model(args.model, "mean", args.dtype, args.device)
    enc = Encoder(module, auto_tokenizer(args.model), seq_len=args.seq_len, batch_size=args.batch_size)
    q = enc.encode_queries([r["query"] for r in rows])
    d = enc.encode_corpus([r["document"] for r in rows])
    keep = consistency_keep_mask(q, d, top_k=args.top_k, pool_size=args.pool_size, device=args.device)
    with open(args.output, "w") as f:
        for r, k in zip(rows, keep):
            if k:
                f.write(json.dumps(r) + "\n")
    print(f"kept {int(keep.sum())}/{len(rows)} pairs -> {args.output}")
    return keep


if __name__ == "__main__":
    main()
