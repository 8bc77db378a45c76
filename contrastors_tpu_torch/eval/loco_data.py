"""LoCo long-context datasets -> BEIR triples, counterpart of
`contrastors_tpu/eval/loco_data.py`.

Sources are local `datasets.save_to_disk` directories (`datasets` is
imported when one is read). Each loader returns the BEIR triple (corpus,
queries, qrels) that `eval/retrieval.py` and `eval/eval_long_context.py`
read, and `export_beir_dir` writes it as corpus.jsonl / queries.jsonl /
qrels.tsv. Every LoCo task is 1:1 retrieval: Query_i's one relevant
document is Passage_i.

  python -m contrastors_tpu_torch.eval.loco_data --dataset qasper \\
      --path <saved dataset> --output <beir dir> [--split validation]
"""

import json
import os
from typing import Dict, Tuple

Corpus = Dict[str, Dict[str, str]]
Queries = Dict[str, str]
Qrels = Dict[str, Dict[str, int]]


def _load_split(path: str, split: str):
    from datasets import load_from_disk

    ds = load_from_disk(path)
    if hasattr(ds, "keys") and split in ds:
        return ds[split]
    return ds


def _one_to_one(texts_q, texts_d) -> Tuple[Corpus, Queries, Qrels]:
    corpus, queries, qrels = {}, {}, {}
    for i, (q, d) in enumerate(zip(texts_q, texts_d)):
        corpus[f"Passage_{i}"] = {"title": "", "text": d}
        queries[f"Query_{i}"] = q
        qrels[f"Query_{i}"] = {f"Passage_{i}": 1}
    return corpus, queries, qrels


def load_scrolls(path: str, split: str = "validation", document_column: str = "input",
                 query_column: str = "output"):
    """tau/scrolls summ_screen_fd / gov_report / qmsum: the summary
    (output) retrieves its long source document (input)."""
    ds = _load_split(path, split)
    return _one_to_one([r[query_column] for r in ds], [r[document_column] for r in ds])


def qasper_full_text(record_full_text: dict) -> str:
    """A QASPER paper body: "section\\nparagraphs" blocks."""
    parts = []
    paragraphs = [" ".join(p) for p in record_full_text["paragraphs"]]
    for header, para in zip(record_full_text["section_name"], paragraphs):
        if header is None and not para:
            continue
        if header is None:
            parts.append(para)
        elif not para:
            parts.append(header)
        else:
            parts.append(f"{header}\n{para}")
    return "\n".join(parts).strip()


def load_qasper(path: str, split: str = "validation", document_column: str = "full_text",
                query_column: str = "abstract"):
    """QASPER: the abstract retrieves the assembled paper body."""
    ds = _load_split(path, split)
    docs = [qasper_full_text(r[document_column]) if document_column == "full_text" else r[document_column]
            for r in ds]
    return _one_to_one([r[query_column] for r in ds], docs)


def load_pairs(path: str, split: str = "validation", document_column: str = "document",
               query_column: str = "query"):
    """Any 1:1 pair dataset."""
    ds = _load_split(path, split)
    return _one_to_one([r[query_column] for r in ds], [r[document_column] for r in ds])


LOCO_LOADERS = {
    "qasper": load_qasper,
    "summ_screen_fd": load_scrolls,
    "gov_report": load_scrolls,
    "qmsum": load_scrolls,
    "pairs": load_pairs,
}


def export_beir_dir(corpus: Corpus, queries: Queries, qrels: Qrels, out_dir: str) -> str:
    """Write the BEIR-format directory the retrieval evals read."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "corpus.jsonl"), "w") as f:
        for cid, doc in corpus.items():
            f.write(json.dumps({"_id": cid, "title": doc.get("title", ""), "text": doc["text"]}) + "\n")
    with open(os.path.join(out_dir, "queries.jsonl"), "w") as f:
        for qid, text in queries.items():
            f.write(json.dumps({"_id": qid, "text": text}) + "\n")
    with open(os.path.join(out_dir, "qrels.tsv"), "w") as f:
        for qid, rel in qrels.items():
            for cid, score in rel.items():
                f.write(f"{qid}\t{cid}\t{score}\n")
    return out_dir


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="LoCo dataset -> BEIR dir converter")
    parser.add_argument("--dataset", required=True, choices=sorted(LOCO_LOADERS))
    parser.add_argument("--path", required=True, help="local datasets.save_to_disk dir")
    parser.add_argument("--split", default="validation")
    parser.add_argument("--document_column", default=None)
    parser.add_argument("--query_column", default=None)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    kw = {}
    if args.document_column:
        kw["document_column"] = args.document_column
    if args.query_column:
        kw["query_column"] = args.query_column
    corpus, queries, qrels = LOCO_LOADERS[args.dataset](args.path, split=args.split, **kw)
    export_beir_dir(corpus, queries, qrels, args.output)
    print(f"wrote {len(queries)} queries / {len(corpus)} passages to {args.output}")


if __name__ == "__main__":
    main()
