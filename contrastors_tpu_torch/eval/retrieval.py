"""Dense retrieval evaluation, counterpart of
`contrastors_tpu/eval/retrieval.py` (`dense_retrieve`,
`evaluate_retrieval`, `run_beir_dirs`, `main`): encode corpus and queries,
take the cosine top-k with torch, score nDCG@k and Recall@k with
`eval/metrics.py`, over local BEIR-format directories.

  python -m contrastors_tpu_torch.eval.retrieval --model_name <dir> \
      --data <beir dir> [<beir dir> ...] [--seq_len 512] [--batch_size 32] \
      [--ks 10 100] [--output results.json] [--device cuda] [--dtype bf16]

For lengths past the trained window use `eval/eval_long_context.py`
(DynamicNTK); this CLI builds the same encoder with its own defaults.
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from contrastors_tpu_torch.eval.metrics import ndcg_at_k, recall_at_k


def stable_top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, best first, equal
    scores in index order, as `jax.lax.top_k` gives them (`torch.topk`
    leaves the order of ties open): a stable descending sort."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def dense_retrieve(query_embs: np.ndarray, corpus_embs: np.ndarray, corpus_ids: List[str],
                   top_k: int = 100) -> List[List[str]]:
    """The top_k corpus ids of each query by dot product, best first (ties
    to the lower index, as in JAX)."""
    scores = torch.from_numpy(np.asarray(query_embs, np.float32)) @ torch.from_numpy(
        np.asarray(corpus_embs, np.float32)).T
    k = min(top_k, corpus_embs.shape[0])
    idx = stable_top_k(scores, k)[1].numpy()
    return [[corpus_ids[j] for j in row] for row in idx]


def evaluate_retrieval(
    encoder,
    corpus: Dict[str, dict],
    queries: Dict[str, str],
    qrels: Dict[str, Dict[str, int]],
    ks: Sequence[int] = (10, 100),
) -> Dict[str, float]:
    """corpus: id -> {title?, text}; queries: id -> text; qrels: query_id
    -> {doc_id: relevance}. Queries without qrels are skipped."""
    corpus_ids = list(corpus)
    corpus_embs = encoder.encode_corpus([corpus[c] for c in corpus_ids])
    query_ids = [q for q in queries if q in qrels]
    query_embs = encoder.encode_queries([queries[q] for q in query_ids])

    ranked = dense_retrieve(query_embs, corpus_embs, corpus_ids, top_k=max(ks))
    relevant = [qrels[q] for q in query_ids]
    out = {}
    for k in ks:
        out[f"ndcg@{k}"] = ndcg_at_k(ranked, relevant, k=k)
        out[f"recall@{k}"] = recall_at_k(ranked, relevant, k=k)
    return out


def run_beir_dirs(enc, dirs: Sequence[str], ks: Sequence[int] = (10, 100), output: Optional[str] = None):
    """Evaluate an encoder over local BEIR-format directories: per-dataset
    scores (a repeated basename gets a "+"), printed, and the average of
    nDCG@ks[0] under "avg"; written as JSON to `output` when given."""
    from contrastors_tpu_torch.eval.eval_long_context import load_beir_dir

    results = {}
    for path in dirs:
        corpus, queries, qrels = load_beir_dir(path)
        res = evaluate_retrieval(enc, corpus, queries, qrels, ks=tuple(ks))
        name = os.path.basename(os.path.normpath(path))
        while name in results:
            name += "+"
        results[name] = res
        print(f"{name}: {json.dumps(res)}")
    key = f"ndcg@{ks[0]}"
    avg = float(np.mean([r[key] for r in results.values()]))
    results["avg"] = {key: avg}
    print(f"avg {key}: {avg:.4f}")
    if output:
        with open(output, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="dense retrieval over local BEIR-format dirs")
    parser.add_argument("--model_name", required=True, help="local HF model dir")
    parser.add_argument("--data", required=True, nargs="+", help="BEIR-format dirs")
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--ks", type=int, nargs="+", default=[10, 100])
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    args = parser.parse_args(argv)

    from contrastors_tpu_torch.eval.eval_long_context import build_long_context_encoder

    enc = build_long_context_encoder(args.model_name, seq_len=args.seq_len, batch_size=args.batch_size,
                                     dtype=args.dtype, device=args.device)
    return run_beir_dirs(enc, args.data, ks=args.ks, output=args.output)


if __name__ == "__main__":
    main()
