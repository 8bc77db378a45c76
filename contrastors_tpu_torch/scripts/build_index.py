"""Shard bookkeeping CLI: counts.json + offsets.json.gz for a bucket
(reference: scripts/text/offsets_count.py, get_lengths.py), counterpart of
`contrastors_tpu/scripts/build_index.py` on the port's
`data/indexing.py:build_bucket_index` (the C++ data plane where it builds).

Usage: python -m contrastors_tpu_torch.scripts.build_index --bucket <dir> [...]
"""

import argparse

from contrastors_tpu_torch.data.indexing import build_bucket_index


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--bucket", required=True, nargs="+", help="shard directories")
    parser.add_argument("--suffix", default=".jsonl.gz")
    args = parser.parse_args(argv)
    for bucket in args.bucket:
        counts = build_bucket_index(bucket, pattern_suffix=args.suffix)
        total = sum(counts.values())
        print(f"{bucket}: {len(counts)} shards, {total} rows")


if __name__ == "__main__":
    main()
