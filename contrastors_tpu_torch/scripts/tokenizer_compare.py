"""Compare two tokenizers over a text sample (reference:
tokenizer_compare.py at the repo root), counterpart of
`contrastors_tpu/scripts/tokenizer_compare.py`: vocab overlap, per-text
token counts, and exact-tokenization agreement rate. `transformers` is
imported in `main`.

Usage: python -m contrastors_tpu_torch.scripts.tokenizer_compare \
           --a <dir> --b <dir> --texts sample.txt
"""

import argparse


def compare(tok_a, tok_b, texts):
    va, vb = set(tok_a.get_vocab()), set(tok_b.get_vocab())
    overlap = len(va & vb) / max(len(va | vb), 1)
    same = 0
    len_a = len_b = 0
    for t in texts:
        ea = tok_a.encode(t, add_special_tokens=False)
        eb = tok_b.encode(t, add_special_tokens=False)
        len_a += len(ea)
        len_b += len(eb)
        same += int(ea == eb)
    n = max(len(texts), 1)
    return {
        "vocab_jaccard": overlap,
        "identical_tokenizations": same / n,
        "avg_tokens_a": len_a / n,
        "avg_tokens_b": len_b / n,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--a", required=True)
    parser.add_argument("--b", required=True)
    parser.add_argument("--texts", required=True, help="one text per line")
    args = parser.parse_args(argv)
    from transformers import AutoTokenizer

    with open(args.texts) as f:
        texts = [line.strip() for line in f if line.strip()]
    out = compare(
        AutoTokenizer.from_pretrained(args.a), AutoTokenizer.from_pretrained(args.b), texts
    )
    for k, v in out.items():
        print(f"{k}: {v:.4f}")
    return out


if __name__ == "__main__":
    main()
