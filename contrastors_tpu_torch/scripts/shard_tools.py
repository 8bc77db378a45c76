"""Shard maintenance CLI, counterpart of `contrastors_tpu/scripts/shard_tools.py`:
the reference's loose collection of one-off shard
scripts folded into one tool (reference: scripts/text/filter_rows.py,
remove_lines.py, get_lengths.py, convert_to_arrow.py,
multilingual/process_mc4.py, process_multilingual_cc_news.py,
scripts/image/dataset_size.py).

Subcommands (all operate on gzip-JSONL shard dirs unless noted):

  filter     keep rows whose GLOBAL row id (position across the sorted
             shard list) appears in ids_to_keep_*.json files, or that pass
             simple predicates (--min_chars/--require_cols) — the
             filter_rows.py role. Drop-lists invert via --drop.
  lengths    per-shard row counts and char-length percentiles of a column
             (get_lengths.py role; token lengths if --tokenizer given).
  sizes      row counts for shard dirs, HF-dataset dirs, or wds .tar
             shards (dataset_size.py + get_lengths roles).
  to_paired  convert a raw corpus (HF dataset dir / jsonl / jsonl.gz) into
             paired gzip-JSONL shards + the objective metadata consumed by
             StreamingShardDataset specs; --split_title_text derives the
             query column from a document's first line (the mc4/cc-news
             processors' recipe, process_mc4.py:34-41). Per-language
             corpora land in per-language subdirs (--lang_col).

After filter/to_paired, run build_index to regenerate counts/offsets.
"""

import argparse
import glob
import gzip
import json
import os


def _open_text(path, mode="rt"):
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode.rstrip("t"))


def _shards(input_dir, pattern):
    out = sorted(glob.glob(os.path.join(input_dir, pattern)))
    if not out:
        raise SystemExit(f"no shards matching {pattern} in {input_dir}")
    return out


def cmd_filter(args):
    ids = set()
    for f in glob.glob(os.path.join(args.ids_dir, "ids_to_keep_*.json")) if args.ids_dir else []:
        with open(f) as fh:
            ids.update(json.load(fh))
    os.makedirs(args.output_dir, exist_ok=True)
    gid = 0
    kept = total = 0
    for shard in _shards(args.input_dir, args.pattern):
        out_path = os.path.join(args.output_dir, os.path.basename(shard))
        with _open_text(shard) as fin, gzip.open(out_path, "wt") as fout:
            for line in fin:
                total += 1
                keep = True
                if args.ids_dir:
                    keep = (gid in ids) != args.drop
                if keep and (args.min_chars or args.require_cols):
                    try:
                        r = json.loads(line)
                    except json.JSONDecodeError:
                        keep = False
                        r = None
                    if r is not None:
                        if args.require_cols:
                            keep = all(r.get(c) for c in args.require_cols)
                        if keep and args.min_chars:
                            # scope the length test to the named columns, or
                            # to the standard text columns — auxiliary string
                            # fields (ids, language tags) must not drop rows
                            cols = args.require_cols or [
                                c for c in ("query", "document", "text") if c in r
                            ]
                            if not cols:
                                raise SystemExit(
                                    "--min_chars found no text column to test "
                                    f"(row keys: {sorted(r)[:6]}); pass --require_cols"
                                )
                            keep = all(
                                len(str(r.get(c, ""))) >= args.min_chars
                                for c in cols
                                if isinstance(r.get(c), str)
                            )
                gid += 1
                if keep:
                    fout.write(line)
                    kept += 1
        print(f"{os.path.basename(shard)}: kept so far {kept}/{total}")
    print(f"kept {kept}/{total} rows -> {args.output_dir}")


def cmd_lengths(args):
    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer)
    import numpy as np

    all_lens = []
    for shard in _shards(args.input_dir, args.pattern):
        lens = []
        with _open_text(shard) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                text = str(r.get(args.column, ""))
                lens.append(len(tok.encode(text)) if tok else len(text))
        all_lens.extend(lens)
        if lens:
            print(f"{os.path.basename(shard)}: {len(lens)} rows, mean {np.mean(lens):.0f}")
    if all_lens:
        a = np.asarray(all_lens)
        unit = "tokens" if tok else "chars"
        print(
            f"total {len(a)} rows; {unit} p50={np.percentile(a, 50):.0f} "
            f"p90={np.percentile(a, 90):.0f} p99={np.percentile(a, 99):.0f} max={a.max()}"
        )


def cmd_sizes(args):
    results = {}
    for path in args.paths:
        if os.path.isdir(path):
            shards = glob.glob(os.path.join(path, "**", "*.jsonl*"), recursive=True)
            if shards:
                n = 0
                for s in shards:
                    with _open_text(s) as f:
                        n += sum(1 for _ in f)
                results[path] = n
                continue
            arrow = glob.glob(os.path.join(path, "**", "*.arrow"), recursive=True)
            if arrow or os.path.exists(os.path.join(path, "dataset_info.json")):
                try:
                    from datasets import load_from_disk

                    results[path] = len(load_from_disk(path))
                    continue
                except Exception as e:  # noqa: BLE001 — report and move on
                    results[path] = f"error: {e}"
                    continue
            results[path] = 0
        elif path.endswith(".tar"):
            import tarfile

            with tarfile.open(path) as tf:
                keys = {os.path.splitext(m.name)[0] for m in tf.getmembers() if m.isfile()}
            results[path] = len(keys)
        else:
            with _open_text(path) as f:
                results[path] = sum(1 for _ in f)
    for k, v in results.items():
        print(f"{k}: {v}")
    print(json.dumps(results))


def _iter_corpus(src, text_col):
    if os.path.isdir(src) and (
        os.path.exists(os.path.join(src, "dataset_info.json"))
        or glob.glob(os.path.join(src, "*.arrow"))
    ):
        from datasets import load_from_disk

        for r in load_from_disk(src):
            yield r
    elif os.path.isdir(src):
        for shard in sorted(glob.glob(os.path.join(src, "*.jsonl*"))):
            with _open_text(shard) as f:
                for line in f:
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue
    else:
        with _open_text(src) as f:
            for line in f:
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


def cmd_to_paired(args):
    os.makedirs(args.output_dir, exist_ok=True)
    writers = {}
    counts = {}

    def get_writer(lang):
        if lang not in writers:
            sub = os.path.join(args.output_dir, lang) if lang else args.output_dir
            os.makedirs(sub, exist_ok=True)
            counts[lang] = [0, 0]  # rows in current shard, shard index
            writers[lang] = [sub, gzip.open(os.path.join(sub, "shard-00000.jsonl.gz"), "wt")]
        return writers[lang]

    meta = {"objective": {"self": [], "paired": [[args.query_col, args.document_col]], "triplet": []}}
    n = 0
    for r in _iter_corpus(args.input, args.document_col):
        if args.split_title_text:
            text = str(r.get(args.text_col, ""))
            lines = text.split("\n", 1)
            q = lines[0].strip()
            d = lines[1].strip() if len(lines) > 1 else ""
        else:
            q = str(r.get(args.query_col, "") or "")
            d = str(r.get(args.document_col, "") or "")
        if not q or not d:
            continue
        lang = str(r.get(args.lang_col)) if args.lang_col and r.get(args.lang_col) else ""
        sub, fh = get_writer(lang)
        row = {args.query_col: q, args.document_col: d, "metadata": meta}
        fh.write(json.dumps(row, ensure_ascii=False) + "\n")
        c = counts[lang]
        c[0] += 1
        n += 1
        if c[0] >= args.shard_size:
            fh.close()
            c[1] += 1
            c[0] = 0
            writers[lang][1] = gzip.open(
                os.path.join(sub, f"shard-{c[1]:05d}.jsonl.gz"), "wt"
            )
    for _sub, fh in writers.values():
        fh.close()
    print(f"wrote {n} pairs across {len(writers) or 1} language dir(s) -> {args.output_dir}")
    print("next: python -m contrastors_tpu_torch.scripts.build_index --bucket", args.output_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("filter")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--ids_dir", default=None, help="dir of ids_to_keep_*.json (global row ids)")
    p.add_argument("--drop", action="store_true", help="treat ids as a drop-list")
    p.add_argument("--pattern", default="shard-*.jsonl.gz")
    p.add_argument("--min_chars", type=int, default=0)
    p.add_argument("--require_cols", nargs="+", default=None)
    p.set_defaults(fn=cmd_filter)

    p = sub.add_parser("lengths")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--pattern", default="shard-*.jsonl.gz")
    p.add_argument("--column", default="document")
    p.add_argument("--tokenizer", default=None)
    p.set_defaults(fn=cmd_lengths)

    p = sub.add_parser("sizes")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=cmd_sizes)

    p = sub.add_parser("to_paired")
    p.add_argument("--input", required=True, help="HF dataset dir, jsonl(.gz) file, or shard dir")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--query_col", default="title")
    p.add_argument("--document_col", default="text")
    p.add_argument("--lang_col", default=None, help="split output into per-language subdirs")
    p.add_argument("--split_title_text", action="store_true")
    p.add_argument("--text_col", default="text", help="source column for --split_title_text")
    p.add_argument("--shard_size", type=int, default=100_000)
    p.set_defaults(fn=cmd_to_paired)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
