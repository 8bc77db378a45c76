"""Static-shape sequence packing, counterpart of
`contrastors_tpu/data/packing.py` (host numpy; the port keeps its own copy).

A batch of B padded sequences packs into exactly R = ceil(B / max_segments)
rows of row_len tokens, each row holding at most max_segments segments.
First-fit-decreasing keeps the rows balanced; a sequence that does not fit
in its row's remaining space is truncated (choose max_segments ~ row_len /
mean length so that this stays rare). Pad tokens then leave every matmul,
and attention stays within segments through the flash kernels' segment ids.

Output contract (the packed mode of `models/biencoder.py:BiEncoder`):
  input_ids    [R, row_len]  packed tokens, pad_id elsewhere
  segment_ids  [R, row_len]  1..max_segments per segment, 0 = pad
  position_ids [R, row_len]  restarting at 0 at each segment start
  pair_index   [B]           flat gather index row * max_segments + (seg - 1)
                             of sequence i's pooled embedding in the
                             [R * max_segments, D] per-segment matrix
  last_token_index [B]       flat gather index row * row_len + last-token
                             position (per-segment last-token pooling)
"""

from typing import Dict, List

import numpy as np


def pack_tokenized(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    row_len: int,
    max_segments: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Pack padded [B, L] tokenized sequences into [R, row_len] rows."""
    B = input_ids.shape[0]
    lengths = attention_mask.sum(axis=1).astype(np.int64)
    R = -(-B // max_segments)

    ids = np.full((R, row_len), pad_id, dtype=input_ids.dtype)
    seg = np.zeros((R, row_len), dtype=np.int32)
    pos = np.zeros((R, row_len), dtype=np.int32)
    pair_index = np.zeros(B, dtype=np.int32)
    last_token_index = np.zeros(B, dtype=np.int32)
    used = np.zeros(R, dtype=np.int64)
    nseg = np.zeros(R, dtype=np.int64)
    zero_seqs: List[int] = []

    order = np.argsort(-lengths, kind="stable")  # longest first
    for i in order:
        n = int(min(lengths[i], row_len))
        # the first row with room for the whole sequence and a free slot;
        # else the free-slot row with the most room (truncating)
        candidates = np.flatnonzero((nseg < max_segments) & (used + n <= row_len))
        if candidates.size:
            r = int(candidates[0])
        else:
            free = np.flatnonzero(nseg < max_segments)
            r = int(free[np.argmax(row_len - used[free])])
            n = int(row_len - used[r])
            if n == 0:
                print(
                    f"[packing] sequence {i} truncated to 0 tokens "
                    f"(row_len={row_len}, max_segments={max_segments} too tight)",
                    flush=True,
                )
        start = int(used[r])
        if n > 0:
            ids[r, start : start + n] = input_ids[i, :n]
            seg[r, start : start + n] = nseg[r] + 1
            pos[r, start : start + n] = np.arange(n, dtype=np.int32)
            last_token_index[i] = r * row_len + start + n - 1
        else:
            # a 0-token slot sits in a full row, where a clamped index would
            # alias another sequence's last token: it points at a genuine pad
            # slot instead, resolved once the free space is final
            zero_seqs.append(i)
        pair_index[i] = r * max_segments + int(nseg[r])
        used[r] += n
        nseg[r] += 1

    for i in zero_seqs:
        free_rows = np.flatnonzero(used < row_len)
        if free_rows.size:
            r0 = int(free_rows[0])
            last_token_index[i] = r0 * row_len + int(used[r0])  # a pad slot
        else:
            # no pad slot anywhere: the sequence's own row; the packed 'last'
            # pooling zeroes the embeddings of 0-token slots
            last_token_index[i] = (pair_index[i] // max_segments) * row_len + row_len - 1

    return {
        "input_ids": ids,
        "segment_ids": seg,
        "position_ids": pos,
        "pair_index": pair_index,
        "last_token_index": last_token_index,
    }


def packing_efficiency(attention_mask: np.ndarray, row_len: int, max_segments: int) -> float:
    """Padded-token budget over packed-token budget, (B * L) / (R * row_len):
    above 1, packing shrinks the matmul work. Geometry only; whether the
    geometry truncates is `packing_kept_fraction`'s question."""
    B, L = attention_mask.shape
    R = -(-B // max_segments)
    return (B * L) / (R * row_len)


def packing_kept_fraction(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    row_len: int,
    max_segments: int,
    pad_id: int = 0,
) -> float:
    """The share of real tokens that survive a dry pack at this geometry
    (below 1, `pack_tokenized` would truncate)."""
    real = float(attention_mask.sum())
    if real == 0:
        return 1.0
    packed = pack_tokenized(input_ids, attention_mask, row_len=row_len, max_segments=max_segments, pad_id=pad_id)
    return float((packed["segment_ids"] > 0).sum()) / real
