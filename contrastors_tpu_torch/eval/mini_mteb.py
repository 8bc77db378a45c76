"""Offline MTEB-compatible runner over local task data, counterpart of
`contrastors_tpu/eval/mini_mteb.py`.

`MTEB(tasks=[...]).run(model, output_folder=...)` is the constructor / run
surface of the `mteb` package, over local data directories, so that the
chain checkpoint -> encoder -> task loop -> per-task result JSON -> score
table -> model card runs with no network and no benchmark package.
`eval_mteb.main --local_data_dir=<dir>` uses it in place of `mteb`.

All six MTEB task types, with the headline metric the score table reads
(`mteb_tools.MAIN_METRIC`):

  type                 data files in <data_dir>/<TaskName>/          metric
  retrieval            corpus.jsonl queries.jsonl qrels.tsv (BEIR)   ndcg_at_10
  sts                  pairs.jsonl {sentence1,sentence2,score}       cos_sim.spearman
  classification       train.jsonl test.jsonl {text,label}           accuracy
  clustering           docs.jsonl {text,label}                       v_measure
  pair_classification  pairs.jsonl {sentence1,sentence2,label}       cos_sim.ap
  reranking            samples.jsonl {query,positive[],negative[]}   map

Models plug in through encode() / encode_queries() / encode_corpus()
(`eval/encoder.py`'s Encoder and HFEncoder both have them). The metrics
(`spearman`, `average_precision`, `v_measure`, `kmeans`,
`softmax_regression`) are numpy, the same code as JAX's, on the embeddings
the model returns. Result JSONs are shaped like mteb's
({"mteb_dataset_name", "test": {...}}).
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

_DATA_DIR: Optional[str] = None


def set_data_dir(path: str) -> None:
    global _DATA_DIR
    _DATA_DIR = path


def _read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _encode(model, texts: Sequence[str]) -> np.ndarray:
    emb = np.asarray(model.encode(list(texts)))
    # metrics below assume cosine geometry; normalize defensively in case
    # the adapter was built with normalize=False
    return emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)


# ---- per-type metric kernels (numpy-only; no sklearn/scipy) ----------------


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    def rank(x):
        order = np.argsort(x, kind="stable")
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(len(x))
        # average ranks over ties (scipy.rankdata semantics)
        vals, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
        sums = np.zeros(len(vals))
        np.add.at(sums, inv, r)
        return sums[inv] / counts[inv]

    ra, rb = rank(np.asarray(a, np.float64)), rank(np.asarray(b, np.float64))
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(-scores, kind="stable")
    y = np.asarray(labels)[order]
    hits = np.cumsum(y)
    precisions = hits / np.arange(1, len(y) + 1)
    total = y.sum()
    return float((precisions * y).sum() / total) if total > 0 else 0.0


def v_measure(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Entropy-based homogeneity/completeness harmonic mean (sklearn
    v_measure_score semantics, beta=1)."""
    t = np.unique(labels_true, return_inverse=True)[1]
    p = np.unique(labels_pred, return_inverse=True)[1]
    n = len(t)
    cont = np.zeros((t.max() + 1, p.max() + 1))
    np.add.at(cont, (t, p), 1.0)

    def entropy(counts):
        q = counts[counts > 0] / n
        return float(-(q * np.log(q)).sum())

    h_t, h_p = entropy(cont.sum(1)), entropy(cont.sum(0))
    nz = cont > 0
    pij = cont[nz] / n
    mi = float((pij * (np.log(cont[nz]) - np.log(np.outer(cont.sum(1), cont.sum(0))[nz] / n))).sum())
    hom = mi / h_t if h_t > 0 else 1.0
    com = mi / h_p if h_p > 0 else 1.0
    return 0.0 if hom + com == 0 else 2 * hom * com / (hom + com)


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    assign = np.zeros(len(x), np.int64)
    x_sq = (x**2).sum(-1, keepdims=True)  # [n, 1]
    for _ in range(iters):
        # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 via one [n, k] matmul —
        # the [n, k, d] broadcast difference OOMs on modest corpora
        d = x_sq - 2.0 * (x @ centers.T) + (centers**2).sum(-1)[None, :]
        new = d.argmin(1)
        if (new == assign).all():
            break
        assign = new
        for j in range(k):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return assign


def softmax_regression(
    x_train: np.ndarray, y_train: np.ndarray, x_test: np.ndarray,
    epochs: int = 200, lr: float = 1.0,
) -> np.ndarray:
    """Tiny multinomial logistic regression (mteb trains sklearn LR on the
    train-split embeddings; full-batch GD is plenty at mini-task scale)."""
    classes, y = np.unique(y_train, return_inverse=True)
    n, d, c = len(x_train), x_train.shape[1], len(classes)
    w = np.zeros((d, c))
    b = np.zeros(c)
    onehot = np.eye(c)[y]
    for _ in range(epochs):
        z = x_train @ w + b
        z -= z.max(1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(1, keepdims=True)
        g = (p - onehot) / n
        w -= lr * (x_train.T @ g)
        b -= lr * g.sum(0)
    return classes[(x_test @ w + b).argmax(1)]


# ---- task runners ----------------------------------------------------------


def _run_retrieval(model, task_dir: str) -> Dict:
    from contrastors_tpu_torch.eval.eval_long_context import load_beir_dir
    from contrastors_tpu_torch.eval.retrieval import evaluate_retrieval

    corpus, queries, qrels = load_beir_dir(task_dir)
    res = evaluate_retrieval(model, corpus, queries, qrels, ks=(1, 10))
    return {
        "ndcg_at_1": res["ndcg@1"],
        "ndcg_at_10": res["ndcg@10"],
        "recall_at_10": res["recall@10"],
        "main_score": res["ndcg@10"],
    }


def _run_sts(model, task_dir: str) -> Dict:
    rows = _read_jsonl(os.path.join(task_dir, "pairs.jsonl"))
    a = _encode(model, [r["sentence1"] for r in rows])
    b = _encode(model, [r["sentence2"] for r in rows])
    gold = np.array([float(r["score"]) for r in rows])
    cos = (a * b).sum(-1)
    rho = spearman(cos, gold)
    return {"cos_sim": {"spearman": rho}, "main_score": rho}


def _run_classification(model, task_dir: str) -> Dict:
    train = _read_jsonl(os.path.join(task_dir, "train.jsonl"))
    test = _read_jsonl(os.path.join(task_dir, "test.jsonl"))
    xtr = _encode(model, [r["text"] for r in train])
    xte = _encode(model, [r["text"] for r in test])
    ytr = np.array([r["label"] for r in train])
    yte = np.array([r["label"] for r in test])
    pred = softmax_regression(xtr, ytr, xte)
    acc = float((pred == yte).mean())
    return {"accuracy": acc, "main_score": acc}


def _run_clustering(model, task_dir: str) -> Dict:
    rows = _read_jsonl(os.path.join(task_dir, "docs.jsonl"))
    x = _encode(model, [r["text"] for r in rows])
    labels = np.array([r["label"] for r in rows])
    k = len(np.unique(labels))
    assign = kmeans(x, k)
    vm = v_measure(labels, assign)
    return {"v_measure": vm, "main_score": vm}


def _run_pair_classification(model, task_dir: str) -> Dict:
    rows = _read_jsonl(os.path.join(task_dir, "pairs.jsonl"))
    a = _encode(model, [r["sentence1"] for r in rows])
    b = _encode(model, [r["sentence2"] for r in rows])
    labels = np.array([int(r["label"]) for r in rows])
    ap = average_precision((a * b).sum(-1), labels)
    return {"cos_sim": {"ap": ap}, "main_score": ap}


def _run_reranking(model, task_dir: str) -> Dict:
    rows = _read_jsonl(os.path.join(task_dir, "samples.jsonl"))
    if not rows:
        return {"map": 0.0, "main_score": 0.0}
    # two batched encodes (all queries; all docs concatenated with offsets) —
    # per-sample encode() calls each pad to the Encoder's fixed batch and
    # round-trip the device once per sample
    q_embs = _encode(model, [r["query"] for r in rows])
    docs, spans, labels = [], [], []
    for r in rows:
        start = len(docs)
        docs.extend(list(r["positive"]) + list(r["negative"]))
        spans.append((start, len(docs)))
        labels.append(np.array([1] * len(r["positive"]) + [0] * len(r["negative"])))
    d_embs = _encode(model, docs)
    aps = [
        average_precision(d_embs[a:b] @ q_embs[i], labels[i])
        for i, (a, b) in enumerate(spans)
    ]
    m = float(np.mean(aps))
    return {"map": m, "main_score": m}


_FILES2RUNNER = [
    (("qrels.tsv",), _run_retrieval),
    (("train.jsonl", "test.jsonl"), _run_classification),
    (("docs.jsonl",), _run_clustering),
    (("samples.jsonl",), _run_reranking),
    # pairs.jsonl is shared by sts and pair_classification; decided by field
]


def _detect_runner(task_name: str, task_dir: str):
    for files, runner in _FILES2RUNNER:
        if all(os.path.exists(os.path.join(task_dir, f)) for f in files):
            return runner
    pairs = os.path.join(task_dir, "pairs.jsonl")
    if os.path.exists(pairs):
        first = _read_jsonl(pairs)[0]
        return _run_sts if "score" in first else _run_pair_classification
    raise FileNotFoundError(
        f"no recognized task data in {task_dir} for task {task_name}"
    )


class MTEB:
    """Drop-in for mteb.MTEB over local data (constructor/run surface of
    reference eval_mteb.py:164-186). task_langs is accepted for signature
    parity; local data is monolingual by construction."""

    def __init__(self, tasks: List[str], task_langs=None, data_dir: Optional[str] = None):
        self.tasks = list(tasks)
        self.data_dir = data_dir or _DATA_DIR or os.environ.get("CONTRASTORS_MTEB_DATA")
        if not self.data_dir:
            raise ValueError(
                "mini_mteb needs a data dir: pass data_dir=, call "
                "set_data_dir(), or set $CONTRASTORS_MTEB_DATA"
            )

    def run(self, model, output_folder: str, eval_splits=("test",), **kw) -> Dict[str, Dict]:
        os.makedirs(output_folder, exist_ok=True)
        results = {}
        for task in self.tasks:
            task_dir = os.path.join(self.data_dir, task)
            runner = _detect_runner(task, task_dir)
            scores = runner(model, task_dir)
            payload = {"mteb_dataset_name": task, "test": scores}
            with open(os.path.join(output_folder, f"{task}.json"), "w") as f:
                json.dump(payload, f, indent=2)
            results[task] = payload
            print(f"[mini_mteb] {task}: main_score={scores['main_score']:.4f}")
        return results
