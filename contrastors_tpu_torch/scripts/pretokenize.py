"""Pack raw text into fixed-length token sequences for MLM pretraining.

Counterpart of `contrastors_tpu/scripts/pretokenize.py` (the reference MLM
data prep (reference:
scripts/text/pretokenize.py + tokenize_arrow.py — pack wiki+books into
2048-token rows). Documents are tokenized, concatenated with EOS/SEP
separators, and sliced into contiguous max_length windows (no padding
waste), then saved as an HF dataset consumable by MLMTrainer.

Usage:
  python -m contrastors_tpu_torch.scripts.pretokenize \
      --input data/*.jsonl --text_column text \
      --tokenizer <dir> --max_length 2048 --output data/packed
"""

import argparse
import glob
import json

import numpy as np


class TokenPacker:
    """Concatenate token lists with separators and emit fixed windows. One
    buffer for the WHOLE corpus: a per-call buffer would silently drop its
    partial tail (up to max_length-1 tokens) at every tokenizer-batch
    boundary and split documents at arbitrary batch edges."""

    def __init__(self, max_length: int, sep_id: int):
        self.max_length = max_length
        self.sep_id = sep_id
        self.buf: list = []

    def add(self, token_lists):
        for toks in token_lists:
            self.buf.extend(toks)
            self.buf.append(self.sep_id)
            while len(self.buf) >= self.max_length:
                yield self.buf[: self.max_length]
                self.buf = self.buf[self.max_length :]


def pack_tokens(token_lists, max_length: int, sep_id: int):
    """One-shot convenience over TokenPacker (drops the final partial
    window, as the corpus-level packing contract specifies)."""
    yield from TokenPacker(max_length, sep_id).add(token_lists)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="glob of jsonl/txt files")
    parser.add_argument("--text_column", default="text")
    parser.add_argument("--tokenizer", required=True)
    parser.add_argument("--max_length", type=int, default=2048)
    parser.add_argument("--output", required=True)
    parser.add_argument("--val_pct", type=float, default=0.01)
    args = parser.parse_args(argv)

    from datasets import Dataset, DatasetDict
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.tokenizer)
    sep_id = next(
        (t for t in (tok.sep_token_id, tok.eos_token_id) if t is not None), 0
    )  # `or`-chaining would skip a legitimate id 0 (e.g. GPT-NeoX EOS)

    def texts():
        for path in sorted(glob.glob(args.input)):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if path.endswith(".jsonl"):
                        yield json.loads(line)[args.text_column]
                    else:
                        yield line

    rows = []
    packer = TokenPacker(args.max_length, sep_id)
    batch = []
    for text in texts():
        batch.append(text)
        if len(batch) == 1000:
            enc = tok(batch, add_special_tokens=False)["input_ids"]
            rows.extend(packer.add(enc))
            batch = []
    if batch:
        enc = tok(batch, add_special_tokens=False)["input_ids"]
        rows.extend(packer.add(enc))

    n_val = max(1, int(len(rows) * args.val_pct))
    dd = DatasetDict(
        {
            "train": Dataset.from_dict({"input_ids": rows[n_val:]}),
            "validation": Dataset.from_dict({"input_ids": rows[:n_val]}),
        }
    )
    dd.save_to_disk(args.output)
    print(f"packed {len(rows)} sequences of {args.max_length} -> {args.output}")


if __name__ == "__main__":
    main()
