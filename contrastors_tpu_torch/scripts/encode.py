"""Embedding CLI: text in, embeddings out. Counterpart of
`contrastors_tpu/scripts/encode.py`.

  python -m contrastors_tpu_torch.scripts.encode \\
      --model_name <local HF dir> --input texts.txt --output embs.npy \\
      [--prefix search_document] [--seq_len 512] [--batch_size 256] \\
      [--pooling mean] [--matryoshka_dim 256] [--binarize] [--no_normalize] \\
      [--device cuda] [--dtype bf16]

Input: one text per line (.txt), or jsonl with --column. Output: .npy
float32 [N, D], or with --binarize the signs packed 8 to a byte (uint8
[N, ceil(D / 8)]), row-aligned with the input. `encode_texts` is the CLI
over a loaded model and tokenizer; `main` loads a local checkpoint
(`models/auto.py:load_biencoder`) and its `AutoTokenizer`. The model runs
on the card unless --device cpu.
"""

import argparse
import json
from typing import List, Optional

import numpy as np


def read_texts(path: str, column: str = "text") -> List[str]:
    """One text per non-empty line of a .txt, or `column` of each jsonl row."""
    texts = []
    with open(path) as f:
        if path.endswith(".jsonl"):
            for line in f:
                line = line.strip()
                if line:
                    texts.append(str(json.loads(line)[column]))
        else:
            texts = [line.rstrip("\n") for line in f if line.strip()]
    if not texts:
        raise SystemExit(f"no texts in {path}")
    return texts


def encode_texts(
    module,
    tokenizer,
    texts: List[str],
    prefix: Optional[str] = None,
    seq_len: int = 512,
    batch_size: int = 256,
    matryoshka_dim: Optional[int] = None,
    binarize: bool = False,
    normalize: bool = True,
) -> np.ndarray:
    """The CLI's output for `texts` through a loaded BiEncoder: float32
    embeddings, or with binarize their signs packed into uint8 bytes."""
    from contrastors_tpu_torch.eval.encoder import Encoder

    enc = Encoder(module, tokenizer, seq_len=seq_len, batch_size=batch_size, normalize=normalize,
                  binarize=binarize, matryoshka_dim=matryoshka_dim)
    embs = enc.encode(texts, prefix=prefix)
    if binarize:
        embs = np.packbits((np.asarray(embs) > 0).astype(np.uint8), axis=-1)
    return np.asarray(embs)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_name", required=True, help="local HF model dir")
    parser.add_argument("--input", required=True, help=".txt (one per line) or .jsonl")
    parser.add_argument("--column", default="text", help="jsonl column holding the text")
    parser.add_argument("--output", required=True, help=".npy output path")
    parser.add_argument("--prefix", default=None, help="task prefix, e.g. search_query")
    parser.add_argument("--seq_len", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--pooling", default="mean")
    parser.add_argument("--matryoshka_dim", type=int, default=None)
    parser.add_argument("--binarize", action="store_true")
    parser.add_argument("--no_normalize", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    texts = read_texts(args.input, args.column)

    from contrastors_tpu_torch.eval.encoder import auto_tokenizer, load_encoder_model

    module, _ = load_encoder_model(args.model_name, args.pooling, args.dtype, args.device)
    embs = encode_texts(
        module, auto_tokenizer(args.model_name), texts, prefix=args.prefix, seq_len=args.seq_len,
        batch_size=args.batch_size, matryoshka_dim=args.matryoshka_dim, binarize=args.binarize,
        normalize=not args.no_normalize,
    )
    np.save(args.output, embs)
    print(f"{len(texts)} texts -> {embs.shape} saved to {args.output}")
    return embs


if __name__ == "__main__":
    main()
