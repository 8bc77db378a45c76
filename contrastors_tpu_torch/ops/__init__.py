"""Attention dispatch: the plain SDPA path and the Hopper flash kernel.

Counterpart of `contrastors_tpu/ops/__init__.py`.
"""

from typing import Optional, Tuple

import torch

from contrastors_tpu_torch.ops import flash_attention as _flash  # the module; keeps its name
from contrastors_tpu_torch.ops.sdpa import sdpa

# JAX attention_core's flash_min_seq: below it JAX runs SDPA, whose padded
# query rows attend to the valid keys
FLASH_MIN_SEQ = 512


# a dead row's k is scaled by this so that its logits are 0 to fp32
# precision; a power of two, so bf16 and fp32 values of |k| > 2^-62 stay exact
DEAD_ROW_K_SCALE = 2.0**-64


class _DeadRows(torch.autograd.Function):
    """SDPA on the batch rows whose mask is all 0 (`dead` [B], bool), by the
    flash kernel itself. SDPA adds -1e30 to every logit of such a row, so its
    softmax is uniform over all T keys: the output is mean(v) of each kv
    head (JAX `ops/sdpa.py`), and autograd's gradient is the ordinary softmax
    backward with p = 1/T, dq and dk included, since q.k still receives the
    logits' gradient. The kernel computes that when the row's keys are all
    valid and its k is scaled by DEAD_ROW_K_SCALE, which makes every logit
    0: O, dk and dv come out as SDPA's, and dq comes out DEAD_ROW_K_SCALE
    times SDPA's. So the forward scales k (live rows by 1), and the backward
    passes dk through and divides dq by the same scale."""

    @staticmethod
    def forward(ctx, q, k, dead):
        scale = torch.where(dead, DEAD_ROW_K_SCALE, 1.0).to(k.dtype)[:, None, None, None]
        ctx.save_for_backward(scale)
        return q.view_as(q), k * scale

    @staticmethod
    def backward(ctx, dq, dk):
        (scale,) = ctx.saved_tensors
        return dq / scale, dk, None


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "sdpa",
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    softmax_scale: Optional[float] = None,
    dropout_p: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    dropout_heads: Optional[Tuple[int, int]] = None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    rotary_interleaved: bool = False,
    rotary_position_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single entry point for every attention call in the model zoo.

    impl="flash" (or "flash_always") goes to `flash_attention` whenever
    there is no attention dropout and `flash_shape_ok` holds (JAX's rule:
    q heads a multiple of kv heads, a head dim that is a multiple of 8 and
    at least 64, with no upper bound): on a CUDA tensor the Hopper kernels
    (bf16 at a head dim of 64 or 128), the generic kernels (fp32, and bf16
    at the other head dims, up to 256) or the wide kernels (above 256), as
    `flash_route` decides; the plain version on a CPU tensor. Unlike the
    JAX package there is no minimum-length gate (JAX's `flash_min_seq=512`
    came from TPU v5e measurements); every length goes to the kernel, and
    whether a gate returns is for H100 measurements to decide. Below JAX's
    gate, impl="flash" keeps the row convention of the SDPA path JAX takes
    there: with an attention_mask only, padded query rows attend to the
    valid keys (the kernel gets seg_q = 1, seg_kv = mask) instead of being
    zeroed; "flash_always" and longer kv keep the kernel's zeroed rows, as
    in JAX. A batch row whose mask is all 0 gets SDPA's result there too:
    mean(v) over all T keys, with its gradient, from the kernel with that
    row's keys all valid and its k scaled (`_DeadRows`), with no host sync.
    The JAX `block_q`/`block_kv`/`flash_min_seq` arguments have no
    counterpart here, and `dropout_generator` (a torch.Generator) stands for
    `dropout_rng`. Otherwise the plain `sdpa` runs, on any device;
    `dropout_heads` = (first head, all heads) of a tensor rank's heads
    draws the mask of all heads and keeps this rank's (`sdpa`).

    rotary_cos/rotary_sin make this the single rotary application point: the
    flash path rotates q/k inside the kernels (their fused-rotary variants),
    the SDPA path applies layers/rotary.py's apply_rotary outside, which is
    numerically identical.
    """
    if impl in ("flash", "flash_always") and dropout_p == 0.0 and _flash.flash_shape_ok(q, k):
        if (impl == "flash" and attention_mask is not None and segment_ids is None
                and k.shape[1] < FLASH_MIN_SEQ):
            dead = attention_mask.sum(-1) == 0
            q, k = _DeadRows.apply(q, k, dead)
            segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
            attention_mask, kv_segment_ids = None, torch.where(dead[:, None], 1, attention_mask)
        return _flash.flash_attention(
            q,
            k,
            v,
            attention_mask=attention_mask,
            segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids,
            causal=causal,
            window=window,
            softmax_scale=softmax_scale,
            rotary_cos=rotary_cos,
            rotary_sin=rotary_sin,
            rotary_interleaved=rotary_interleaved,
            rotary_position_ids=rotary_position_ids,
        )
    if rotary_cos is not None:
        from contrastors_tpu_torch.layers.rotary import apply_rotary

        q = apply_rotary(q, rotary_cos, rotary_sin, rotary_interleaved, rotary_position_ids)
        k = apply_rotary(k, rotary_cos, rotary_sin, rotary_interleaved, rotary_position_ids)
    return sdpa(
        q,
        k,
        v,
        attention_mask=attention_mask,
        segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids,
        causal=causal,
        window=window,
        softmax_scale=softmax_scale,
        dropout_p=dropout_p,
        dropout_generator=dropout_generator,
        dropout_heads=dropout_heads,
    )
