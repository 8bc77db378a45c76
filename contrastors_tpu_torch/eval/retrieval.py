"""Dense retrieval evaluation, counterpart of
`contrastors_tpu/eval/retrieval.py` (`dense_retrieve`,
`evaluate_retrieval`): encode corpus and queries, take the cosine top-k
with torch, score nDCG@k and Recall@k with `eval/metrics.py`."""

from typing import Dict, List, Sequence

import numpy as np
import torch

from contrastors_tpu_torch.eval.metrics import ndcg_at_k, recall_at_k


def dense_retrieve(query_embs: np.ndarray, corpus_embs: np.ndarray, corpus_ids: List[str],
                   top_k: int = 100) -> List[List[str]]:
    """The top_k corpus ids of each query by dot product, best first."""
    scores = torch.from_numpy(np.asarray(query_embs, np.float32)) @ torch.from_numpy(
        np.asarray(corpus_embs, np.float32)).T
    k = min(top_k, corpus_embs.shape[0])
    idx = torch.topk(scores, k, dim=-1).indices.numpy()
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
