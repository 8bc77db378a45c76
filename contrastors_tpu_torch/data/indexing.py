"""Shard bookkeeping for the streaming pair data, counterpart of
`contrastors_tpu/data/indexing.py`: counts.json (rows per shard) and
offsets.json.gz (row -> (start, end) byte range in the DECOMPRESSED
stream) for a bucket of gzip JSONL shards, and the key rules both sides
use to look shards up. The index is built by the C++ data plane
(`native/`, thread-parallel inflate and index) where it builds, else with
Python's gzip, shard by shard where the plane fails on one; the files are
the same."""

import gzip
import json
import os
import re
from typing import Dict, List


def norm_shard_key(url: str) -> str:
    """Canonical shard key: trailing 3-4 path segments, scheme stripped."""
    url = re.sub(r"^[a-z0-9]+://", "", url)
    parts = [p for p in url.split("/") if p]
    return "/".join(parts[-4:]) if len(parts) >= 6 else "/".join(parts[-3:])


def resolve_shard_key(url: str, keys) -> str:
    """Find the index key for `url`, tolerant of mount-depth differences:
    every trailing-suffix depth of the url, then a unique basename match.
    Raises KeyError when nothing, or more than one key, matches."""
    path = re.sub(r"^[a-z0-9]+://", "", url)
    parts = [p for p in path.split("/") if p]
    for depth in range(min(len(parts), 6), 0, -1):
        suffix = "/".join(parts[-depth:])
        if suffix in keys:
            return suffix
    base = parts[-1]
    base_matches = [k for k in keys if k.split("/")[-1] == base]
    if len(base_matches) == 1:
        return base_matches[0]
    detail = f"{len(base_matches)} keys share basename {base!r}" if base_matches else "no key matches"
    raise KeyError(f"shard {url} not found in the bucket index ({detail}); rebuild the bucket's index")


def index_shard(path: str) -> Dict[str, List[int]]:
    offsets = {}
    pos = 0
    with gzip.open(path, "rb") as f:
        for i, line in enumerate(f):
            offsets[str(i)] = [pos, pos + len(line)]
            pos += len(line)
    return offsets


def build_bucket_index(bucket_dir: str, pattern_suffix: str = ".jsonl.gz"):
    """Writes counts.json and offsets.json.gz next to the shards, keyed by
    `norm_shard_key`, and returns the counts."""
    from contrastors_tpu_torch.native import index_many

    shards = sorted(f for f in os.listdir(bucket_dir) if f.endswith(pattern_suffix))
    fulls = [os.path.join(bucket_dir, s) for s in shards]
    native = index_many(fulls) or [None] * len(fulls)
    counts, offsets = {}, {}
    for full, off in zip(fulls, native):
        if off is None:
            off = index_shard(full)
        key = norm_shard_key(full)
        counts[key] = len(off)
        offsets[key] = off
    with open(os.path.join(bucket_dir, "counts.json"), "w") as f:
        json.dump(counts, f)
    with gzip.open(os.path.join(bucket_dir, "offsets.json.gz"), "wt") as f:
        json.dump(offsets, f)
    return counts
