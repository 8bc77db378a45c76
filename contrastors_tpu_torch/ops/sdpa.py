"""Plain scaled-dot-product attention in PyTorch (einsum + softmax).

Counterpart of `contrastors_tpu/ops/sdpa.py`: the non-flash dispatch of
`attention_core` and the numerics oracle. It is plain tensor code on any
device, not a kernel port (the JAX side is XLA code outside any Pallas
kernel too).

Conventions:
  q: [B, S, H, D]; k, v: [B, T, Hkv, D] (GQA when Hkv < H)
  attention_mask: [B, T] 1 = valid key
  segment_ids / kv_segment_ids: int, 0 = padding; attention only within
    equal nonzero segments
"""

from typing import Optional, Tuple

import torch

from contrastors_tpu_torch.ops.dropout import dropout

NEG_INF = -1e30


def attention_bias(
    q_len: int,
    kv_len: int,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Optional[torch.Tensor]:
    """Additive bias [B or 1, 1, S, T] (broadcastable over heads)."""
    bias = None

    def add(extra):
        nonlocal bias
        bias = extra if bias is None else torch.minimum(bias, extra)

    def where(cond):
        return torch.where(cond, 0.0, NEG_INF).to(dtype)

    if attention_mask is not None:
        device = attention_mask.device
        add(where(attention_mask[:, None, None, :].bool()))
    if segment_ids is not None:
        device = segment_ids.device
        kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
        same = segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
        valid = (segment_ids[:, None, :, None] != 0) & (kv_seg[:, None, None, :] != 0)
        add(where(same & valid))
    if causal or window > 0:
        row = torch.arange(q_len, device=device)[:, None]
        col = torch.arange(kv_len, device=device)[None, :]
        if causal:
            add(where(row + (kv_len - q_len) >= col)[None, None])
        if window > 0:
            # sliding window: attend iff |i - j| <= window // 2
            add(where((row - col).abs() <= window // 2)[None, None])
    return bias


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    softmax_scale: Optional[float] = None,
    dropout_p: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    dropout_heads: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Returns [B, S, H, D] in q.dtype. Softmax in fp32; probabilities are
    cast to v.dtype before the PV product, as on the JAX side. Attention
    dropout is drawn only from `dropout_generator` (JAX's `dropout_rng`),
    by `ops/dropout.py:dropout` on the fp32 probabilities: without a
    generator, dropout_p has no effect. dropout_heads = (h0, all): q holds
    heads [h0, h0 + H) of `all`, and the mask is drawn for all of them and
    sliced, so that a tensor rank draws the whole layer's noise."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if softmax_scale is None:
        softmax_scale = 1.0 / (D**0.5)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)

    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * softmax_scale
    bias = attention_bias(
        S, T, attention_mask, segment_ids, kv_segment_ids, causal, window, device=q.device
    )
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    if dropout_generator is not None:  # JAX: only with a dropout_rng
        probs = dropout(probs, dropout_p, dropout_generator,
                        mask_part=None if dropout_heads is None else (1, *dropout_heads))
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
    return out.to(q.dtype)
