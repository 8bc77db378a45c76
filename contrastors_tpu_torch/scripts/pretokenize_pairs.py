"""Pretokenize contrastive-pair shards into token-array shards, counterpart
of `contrastors_tpu/scripts/pretokenize_pairs.py`.

HF tokenization is ~98% of the host cost of the streaming pipeline
(ROADMAP "Host input pipeline"); the reference ships the same structural
fix for the MLM side (reference: scripts/text/pretokenize.py) but has no
contrastive-pair equivalent. This writer runs the EXACT batch construction
the streaming loader performs at train time — _extract_pair (negative
selection/cycle-pad, kd_scores alignment) + TokenizeCollator (prefixing,
truncation, EOS pin) — once, offline, and emits per-shard token-array
directories the loader streams back with zero tokenizer work:

  <out>/<dataset>/shard-XXXXX.tokens/
      query_input_ids.npy      [N, Lq]  int32
      query_lengths.npy        [N]      int32   (mask = arange(Lq) < len)
      document_input_ids.npy   [N*m, Ld] int32  (m = docs per query)
      document_lengths.npy     [N*m]    int32
      kd_scores.npy            [N, m]   float32 (kd datasets only)
      meta.json                geometry + collator settings
  <out>/<dataset>/counts.json  (same indexing convention as jsonl buckets)
  <out>/spec.yaml              drop-in replacement data spec

The port's StreamingShardDataset recognizes `.tokens` shard urls and reads windows by
row arithmetic (no offsets.json needed — records are fixed-size), keeping
the rank-quota / cursor / resume machinery identical. Equivalence with the
on-the-fly path is exact and unit-tested (tests/test_torch_data_tools.py).

Usage:
  python -m contrastors_tpu_torch.scripts.pretokenize_pairs \
      --spec configs/data/x.yaml --tokenizer <dir> --out <dir> \
      [--query_max_length 32] [--document_max_length 256] \
      [--num_negatives -1] [--add_eos] [--add_prefix]

Negative SAMPLING (sample_negatives) is a per-epoch random draw and cannot
be baked into a static file; the writer takes first-k (the deterministic
default) and errors if sampling is requested.
"""

import argparse
import gzip
import json
import os
import random
from pathlib import Path
from typing import Dict, List

import numpy as np

from contrastors_tpu_torch.data.text import (
    DEFAULT_MAX_TOKENS,
    MAPPED_NAMES,
    TokenizeCollator,
    _extract_pair,
    expand_urls,
)
from contrastors_tpu_torch.data.indexing import norm_shard_key

TOKENS_SUFFIX = ".tokens"
CHUNK = 2048  # records tokenized per collator call


def write_token_shard(
    records: List[Dict],
    out_dir: str,
    collator: TokenizeCollator,
    objective: Dict,
    num_negatives: int,
    prefixes=None,
    query_only: bool = False,
    kd_loss: bool = False,
) -> int:
    """Tokenize one source shard's records and write a .tokens directory.
    Returns the number of pairs written."""
    rng = random.Random(0)  # never consumed: sampling is rejected upstream
    # num_negatives=-1 ("keep all") must resolve to ONE uniform docs-per-query
    # for the whole shard: the collator's ragged cycle-pad works per CHUNK,
    # and chunk-local maxima would bake differing row counts into a single
    # fixed-stride file — the reader's row arithmetic (_read_token_batch)
    # would then pair queries with other records' documents. Pre-scan the
    # shard and pad every record to the global max instead.
    if num_negatives < 0 and "negative" in MAPPED_NAMES[objective["type"]] and records:
        neg_col = objective["columns"][MAPPED_NAMES[objective["type"]].index("negative")]
        num_negatives = max(len(r.get(neg_col) or []) for r in records)
    cols: Dict[str, List[np.ndarray]] = {}
    kd: List[np.ndarray] = []
    has_kd = False
    for lo in range(0, len(records), CHUNK):
        chunk = records[lo : lo + CHUNK]
        pairs = []
        for r in chunk:
            p, neg_idx = _extract_pair(r, objective, num_negatives, False, rng)
            # kd baking follows the SPEC's kd_loss flag — the same gate the
            # streaming path applies at batch time — never record sniffing,
            # so behavior cannot diverge after migration
            if kd_loss and neg_idx is not None:
                if "document_score" not in r or "negatives_scores" not in r:
                    raise ValueError(
                        "kd_loss dataset record lacks document_score/"
                        "negatives_scores — cannot bake kd_scores"
                    )
                p["kd_scores"] = [r["document_score"]] + [
                    r["negatives_scores"][j] for j in neg_idx
                ]
            pairs.append(p)
        batch = collator(
            pairs, objective["type"], prefixes=prefixes, query_only=query_only
        )
        for col in ("query", "document"):
            ids = batch.get(f"{col}_input_ids")
            if ids is None:
                continue
            mask = batch[f"{col}_attention_mask"]
            cols.setdefault(f"{col}_input_ids", []).append(ids)
            cols.setdefault(f"{col}_lengths", []).append(
                mask.sum(axis=1).astype(np.int32)
            )
        if "kd_scores" in batch:
            has_kd = True
            kd.append(batch["kd_scores"])

    os.makedirs(out_dir, exist_ok=True)
    n_pairs = 0
    meta = {"objective_type": objective["type"], "columns": {}}
    for name, parts in cols.items():
        arr = np.concatenate(parts, axis=0)
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        if name == "query_input_ids":
            n_pairs = arr.shape[0]
        if name.endswith("_input_ids"):
            col = name[: -len("_input_ids")]
            meta["columns"][col] = {
                "rows": int(arr.shape[0]),
                "max_length": int(arr.shape[1]),
            }
    if has_kd:
        np.save(os.path.join(out_dir, "kd_scores.npy"), np.concatenate(kd, axis=0))
    if n_pairs == 0:  # self objective: only query arrays exist
        n_pairs = meta["columns"]["query"]["rows"]
    doc_rows = meta["columns"].get("document", {}).get("rows", n_pairs)
    if n_pairs and doc_rows % n_pairs:
        raise ValueError(
            f"{out_dir}: {doc_rows} document rows not divisible by "
            f"{n_pairs} queries — non-uniform docs-per-query would corrupt "
            "the reader's row arithmetic"
        )
    meta.update(
        n_pairs=n_pairs,
        docs_per_query=doc_rows // max(n_pairs, 1),
        kd_scores=has_kd,
        add_eos=collator.add_eos,
        add_prefix=collator.add_prefix,
        prefixes=prefixes,
        query_only=query_only,
    )
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return n_pairs


def read_jsonl_gz(path: str) -> List[Dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True, help="source data-spec YAML")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--query_max_length", type=int, default=None)
    ap.add_argument("--document_max_length", type=int, default=None)
    ap.add_argument("--num_negatives", type=int, default=-1)
    ap.add_argument("--add_eos", action="store_true")
    ap.add_argument("--add_prefix", action="store_true")
    args = ap.parse_args(argv)

    import yaml
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    col_max = dict(DEFAULT_MAX_TOKENS)
    if args.query_max_length:
        col_max["query"] = args.query_max_length
    if args.document_max_length:
        col_max["document"] = args.document_max_length
        col_max["negative"] = args.document_max_length
    collator = TokenizeCollator(tokenizer, args.add_eos, args.add_prefix, col_max)

    with open(args.spec) as f:
        spec = yaml.safe_load(f)
    out_spec = {"datasets": []}
    for ds in spec["datasets"]:
        name = ds.get("name") or Path(ds["bucket"]).parent.name
        prefixes = None
        if ds.get("query_prefix"):
            prefixes = {
                "query": ds["query_prefix"],
                "document": ds.get("document_prefix", ds["query_prefix"]),
                "negative": ds.get("document_prefix", ds["query_prefix"]),
            }
        ds_out = os.path.join(args.out, name)
        os.makedirs(ds_out, exist_ok=True)
        counts = {}
        urls = expand_urls(ds["bucket"])
        # num_negatives=-1 ("keep all") must resolve to ONE docs-per-query
        # stride for the WHOLE dataset, not per shard: the streaming reader
        # validates a single stride per dataset, and shard-local maxima
        # would silently bake differing row counts across shards. Pre-scan
        # every shard for the global max before writing any of them.
        eff_negatives = args.num_negatives
        if eff_negatives < 0 and "negative" in MAPPED_NAMES[ds["objective"]["type"]]:
            neg_idx = MAPPED_NAMES[ds["objective"]["type"]].index("negative")
            neg_col = ds["objective"]["columns"][neg_idx]
            eff_negatives = 0
            for url in urls:
                for r in read_jsonl_gz(url.replace("file://", "")):
                    eff_negatives = max(eff_negatives, len(r.get(neg_col) or []))
        for url in urls:
            src = url.replace("file://", "")
            stem = Path(src).name
            for suf in (".jsonl.gz", ".jsonl", ".json.gz", ".gz"):
                if stem.endswith(suf):
                    stem = stem[: -len(suf)]
                    break
            shard_out = os.path.join(ds_out, stem + TOKENS_SUFFIX)
            n = write_token_shard(
                read_jsonl_gz(src), shard_out, collator, ds["objective"],
                eff_negatives, prefixes=prefixes,
                query_only=ds.get("query_only", False),
                kd_loss=ds.get("kd_loss", False),
            )
            counts[norm_shard_key(shard_out)] = n
            print(f"[pretokenize] {src} -> {shard_out} ({n} pairs)", flush=True)
        with open(os.path.join(ds_out, "counts.json"), "w") as f:
            json.dump(counts, f)
        entry = dict(ds)
        # preserve the source brace pattern: shard stems map 1:1, so the
        # loader's expand_urls resolves the same shard set
        pat = Path(ds["bucket"]).name
        for suf in (".jsonl.gz", ".jsonl", ".json.gz", ".gz"):
            if pat.endswith(suf):
                pat = pat[: -len(suf)]
                break
        entry["bucket"] = os.path.join(ds_out, pat + TOKENS_SUFFIX)
        entry["pretokenized"] = True
        out_spec["datasets"].append(entry)
    with open(os.path.join(args.out, "spec.yaml"), "w") as f:
        yaml.safe_dump(out_spec, f)
    print(f"[pretokenize] spec written to {os.path.join(args.out, 'spec.yaml')}")


if __name__ == "__main__":
    main()
