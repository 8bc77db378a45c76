"""Retrieval metrics, counterpart of `contrastors_tpu/eval/metrics.py`
(`ndcg_at_k`, `recall_at_k`): BEIR's numbers without the beir package."""

from typing import Dict, List

import numpy as np


def ndcg_at_k(ranked_ids: List[List[str]], relevant: List[Dict[str, int]], k: int = 10) -> float:
    """ranked_ids[i]: doc ids ranked for query i; relevant[i]: {doc_id: gain}.
    Linear gain (gain / log2(rank + 1)), as trec_eval's ndcg_cut and so
    BEIR compute it."""
    scores = []
    for ranked, rel in zip(ranked_ids, relevant):
        dcg = 0.0
        for rank, doc in enumerate(ranked[:k]):
            gain = rel.get(doc, 0)
            if gain > 0:
                dcg += gain / np.log2(rank + 2)
        ideal = sorted(rel.values(), reverse=True)[:k]
        idcg = sum(g / np.log2(r + 2) for r, g in enumerate(ideal) if g > 0)
        scores.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def recall_at_k(ranked_ids: List[List[str]], relevant: List[Dict[str, int]], k: int = 10) -> float:
    scores = []
    for ranked, rel in zip(ranked_ids, relevant):
        pos = {d for d, g in rel.items() if g > 0}
        if not pos:
            continue
        scores.append(len(pos & set(ranked[:k])) / len(pos))
    return float(np.mean(scores)) if scores else 0.0
