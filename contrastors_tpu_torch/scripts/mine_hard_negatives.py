"""Hard-negative mining with false-negative filtering, counterpart of
`contrastors_tpu/scripts/mine_hard_negatives.py`.

Candidates are exact (not approximate): each chunk of queries is scored
against every document by one product q @ D.T on the device and the top
num_negatives + 32 taken on the device, equal scores in index order as
`jax.lax.top_k` gives them (`eval/retrieval.py:stable_top_k`). A query's negatives are its
top-ranked documents other than its positive, skipping those that score
at least margin x the positive's score (probable false negatives); a row
left short is filled from the skipped candidates, least similar first.

  python -m contrastors_tpu_torch.scripts.mine_hard_negatives \\
      --pairs data/pairs.jsonl --model <dir> --output mined.jsonl \\
      [--num_negatives 7] [--margin 0.95] [--device cuda] [--dtype fp32]
"""

import argparse
import json

import numpy as np
import torch


def mine(
    query_embs: np.ndarray,
    doc_embs: np.ndarray,
    positives: np.ndarray,
    num_negatives: int = 7,
    margin: float = 0.95,
    chunk: int = 1024,
    device="cuda",
):
    """positives[i]: the index of query i's positive document. Returns one
    list of negative document indices per query, best first."""
    from contrastors_tpu_torch._device import resolve_device
    from contrastors_tpu_torch.eval.retrieval import stable_top_k

    device = resolve_device(device)
    docs = torch.from_numpy(np.ascontiguousarray(doc_embs, np.float32)).to(device)
    k = min(num_negatives + 32, doc_embs.shape[0])
    out = []
    for start in range(0, len(query_embs), chunk):
        q = torch.from_numpy(np.ascontiguousarray(query_embs[start:start + chunk], np.float32)).to(device)
        scores, idx = (t.cpu().numpy() for t in stable_top_k(q @ docs.T, k))
        for row in range(q.shape[0]):
            qi = start + row
            pos = positives[qi]
            pos_score = float(query_embs[qi] @ doc_embs[pos])
            negs, overflow = [], []
            for s, j in zip(scores[row], idx[row]):
                if j == pos:
                    continue
                if s >= margin * pos_score:  # probable false negative
                    overflow.append(int(j))
                    continue
                negs.append(int(j))
                if len(negs) == num_negatives:
                    break
            # an under-filled row takes the least similar skipped candidates
            while len(negs) < num_negatives and overflow:
                negs.append(overflow.pop())
            out.append(negs)
    short = sum(1 for n in out if len(n) < num_negatives)
    if short:
        print(f"[mine] {short}/{len(out)} queries have < {num_negatives} negatives")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="mine hard negatives for query/document pairs")
    parser.add_argument("--pairs", required=True, help="jsonl with query/document")
    parser.add_argument("--model", required=True, help="local HF checkpoint dir")
    parser.add_argument("--output", required=True)
    parser.add_argument("--num_negatives", type=int, default=7)
    parser.add_argument("--margin", type=float, default=0.95)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--seq_len", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="fp32", choices=["bf16", "fp32"])
    args = parser.parse_args(argv)

    from contrastors_tpu_torch.eval.encoder import Encoder, auto_tokenizer, load_encoder_model

    with open(args.pairs) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    queries = [r["query"] for r in rows]
    docs = [r["document"] for r in rows]
    module, _ = load_encoder_model(args.model, "mean", args.dtype, args.device)
    enc = Encoder(module, auto_tokenizer(args.model), seq_len=args.seq_len, batch_size=args.batch_size)
    q_embs = enc.encode_queries(queries)
    d_embs = enc.encode_corpus(docs)

    negatives = mine(q_embs, d_embs, np.arange(len(rows)), args.num_negatives, args.margin, device=args.device)
    with open(args.output, "w") as f:
        for r, negs in zip(rows, negatives):
            r["negatives"] = [docs[j] for j in negs]
            f.write(json.dumps(r) + "\n")
    print(f"mined negatives for {len(rows)} pairs -> {args.output}")
    return negatives


if __name__ == "__main__":
    main()
