"""Rotary position embeddings as plain functions.

Counterpart of `contrastors_tpu/layers/rotary.py`. The cos/sin tables are
built in numpy fp32 with the same code as the JAX package, so their bits
match; `apply_rotary` rotates in fp32 and casts back to the input dtype, as
the JAX version does. The 2-D ViT rope ("cat" rope, EVA02) is
`build_2d_rope_cat` (its table, built in numpy as JAX builds it, so the
bits match) and `apply_rope_cat` / `apply_rope_cat_prefixed` (the rotation
in fp32, cast back once); it is applied outside attention.

The fused-rotary flash kernels take the tables expanded to full-D fp32 rows
(`expanded_tables`, JAX `flash_attention.py:876-899`), padded with identity
rows (`_pad_tables`, `:759-768`); `rotate` is the rotation with those
tables and `rotate_adjoint` its exact adjoint, which the kernels apply to
the fp32 dq and dk before their one cast.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from contrastors_tpu_torch._device import DeviceLike, resolve_device


def rotary_inv_freq(dim: int, base: float) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def ntk_scaled_base(base: float, dim: int, seqlen: int, max_trained: int, scaling_factor: float) -> float:
    """DynamicNTK base extension past the trained context."""
    if seqlen <= max_trained:
        return base
    return base * ((scaling_factor * seqlen / max_trained) - (scaling_factor - 1)) ** (
        dim / (dim - 2)
    )


def llama3_inv_freq(dim: int, base: float, rope_scaling: dict) -> np.ndarray:
    """Llama-3 frequency-band smoothing."""
    inv_freq = rotary_inv_freq(dim, base)
    factor = rope_scaling["factor"]
    low = rope_scaling["low_freq_factor"]
    high = rope_scaling["high_freq_factor"]
    old_ctx = rope_scaling["original_max_position_embeddings"]

    wavelen = 2 * math.pi / inv_freq
    scaled = np.where(wavelen > old_ctx / low, inv_freq / factor, inv_freq)
    smooth = (old_ctx / wavelen - low) / (high - low)
    smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    is_medium = ~(wavelen < old_ctx / high) & ~(wavelen > old_ctx / low)
    return np.where(is_medium, smoothed, scaled).astype(np.float32)


def rotary_cos_sin(
    seqlen: int,
    rotary_dim: int,
    base: float = 10_000.0,
    rope_scaling: Optional[dict] = None,
    rotary_scaling_factor: Optional[float] = None,
    max_trained_positions: int = 2048,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [seqlen, rotary_dim // 2], built in numpy fp32 and
    returned as fp32 tensors on `device`: rope_scaling selects llama3
    bands, rotary_scaling_factor DynamicNTK, else plain RoPE."""
    device = resolve_device(device)
    if rope_scaling is not None:
        inv_freq = llama3_inv_freq(rotary_dim, base, rope_scaling)
    else:
        if rotary_scaling_factor is not None:
            base = ntk_scaled_base(base, rotary_dim, seqlen, max_trained_positions, rotary_scaling_factor)
        inv_freq = rotary_inv_freq(rotary_dim, base)
    t = np.arange(seqlen, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    return torch.from_numpy(np.cos(freqs)).to(device), torch.from_numpy(np.sin(freqs)).to(device)


def _expand_tables(cos, sin, dim, interleaved):
    """[L, rot/2] tables -> [L, dim] fp32 (repeat-interleave for GPT-J pairs,
    duplicated halves for NeoX), with identity rows (cos=1, sin=0) over any
    pass-through tail."""
    cos, sin = cos.float(), sin.float()
    if interleaved:
        cos_d, sin_d = cos.repeat_interleave(2, dim=-1), sin.repeat_interleave(2, dim=-1)
    else:
        cos_d, sin_d = torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)
    pad = dim - cos_d.shape[-1]
    if pad:
        cos_d = torch.nn.functional.pad(cos_d, (0, pad), value=1.0)
        sin_d = torch.nn.functional.pad(sin_d, (0, pad), value=0.0)
    return cos_d, sin_d


def _rotate(x: torch.Tensor, rot_dim: int, interleaved: bool) -> torch.Tensor:
    """The rotate-half permutation on the first rot_dim features and zeros
    over the tail: exactly `x @ R` of the JAX package's signed one-hot R."""
    tail = torch.zeros_like(x[..., rot_dim:])
    if interleaved:
        x1, x2 = x[..., 0:rot_dim:2], x[..., 1:rot_dim:2]
        rot = torch.stack([-x2, x1], dim=-1).flatten(-2)  # (x0, x1) -> (-x1, x0)
    else:
        half = rot_dim // 2
        rot = torch.cat([-x[..., half:rot_dim], x[..., :half]], dim=-1)
    return torch.cat([rot, tail], dim=-1)


def _pad_tables(cos: torch.Tensor, sin: torch.Tensor, to_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad expanded [..., L, D] tables to L == to_len with identity rows
    (cos=1, sin=0)."""
    pad = to_len - cos.shape[-2]
    if pad:
        cos = torch.nn.functional.pad(cos, (0, 0, 0, pad), value=1.0)
        sin = torch.nn.functional.pad(sin, (0, 0, 0, pad), value=0.0)
    return cos, sin


def expanded_tables(
    cos: torch.Tensor,
    sin: torch.Tensor,
    dim: int,
    interleaved: bool,
    seqlen: int,
    position_ids: Optional[torch.Tensor] = None,
    pad_to: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[max_seq, rot/2] tables -> contiguous fp32 rows of `dim` columns, one
    per sequence position: [L, dim] for positions 0..seqlen-1, or [B, L, dim]
    gathered at position_ids [B, seqlen] (packed rows). L is seqlen rounded
    up to a multiple of pad_to; the rows past seqlen are identity rows."""
    if position_ids is None:
        cos_d, sin_d = _expand_tables(cos[:seqlen], sin[:seqlen], dim, interleaved)
    else:
        cos_d, sin_d = _expand_tables(cos, sin, dim, interleaved)
        cos_d, sin_d = cos_d[position_ids], sin_d[position_ids]
    cos_d, sin_d = _pad_tables(cos_d, sin_d, -(-seqlen // pad_to) * pad_to)
    return cos_d.contiguous(), sin_d.contiguous()


def _per_row(table: torch.Tensor, seqlen: int) -> torch.Tensor:
    # [L, D] -> [S, 1, D]; [B, L, D] -> [B, S, 1, D]: broadcasts over heads
    return table[..., :seqlen, :].unsqueeze(-2)


def rotate(x: torch.Tensor, cos_d: torch.Tensor, sin_d: torch.Tensor, rot_dim: int,
           interleaved: bool) -> torch.Tensor:
    """x * cos + rotate_half(x) * sin with expanded tables (`expanded_tables`),
    combined in fp32 and cast once to x.dtype. x: [B, S, H, D]."""
    S = x.shape[1]
    out = x.float() * _per_row(cos_d, S) + _rotate(x, rot_dim, interleaved).float() * _per_row(sin_d, S)
    return out.to(x.dtype)


def rotate_adjoint(g: torch.Tensor, cos_d: torch.Tensor, sin_d: torch.Tensor, rot_dim: int,
                   interleaved: bool) -> torch.Tensor:
    """The exact adjoint of `rotate` on an fp32 gradient g [B, S, H, D]:
    g * cos + rotate_half^T(g * sin). The rotate-half matrix R is a signed
    permutation with R^T = -R, so rotate_half^T(y) = -rotate_half(y) in index
    form, equal to JAX's (g * sin) @ R^T (`_rot_adjoint`)."""
    S = g.shape[1]
    return g * _per_row(cos_d, S) - _rotate(g * _per_row(sin_d, S), rot_dim, interleaved)


def apply_rotary(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    interleaved: bool = False,
    position_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotate the first 2*cos.shape[-1] features of each head.

    x: [batch, seq, heads, head_dim]; cos/sin: [max_seq, rot_dim/2] fp32.
    position_ids: optional [batch, seq] gather indices into the tables
    (packed sequences, where positions restart at segment starts).
    """
    cos_d, sin_d = expanded_tables(cos, sin, x.shape[-1], interleaved, x.shape[1], position_ids)
    return rotate(x, cos_d, sin_d, cos.shape[-1] * 2, interleaved)


# ---------------------------------------------------------------------------
# 2-D rotary for ViT (EVA02-style "cat" rope), JAX `rotary.py:168-232`.
# ---------------------------------------------------------------------------


def build_2d_rope_cat(
    dim: int,
    feat_shape: Tuple[int, int],
    temperature: float = 10_000.0,
    ref_feat_shape: Optional[Tuple[int, int]] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """[H*W, 2*dim] fp32 on `device`: sin||cos, each repeat-interleaved x2.
    dim is the per-head dimension; dim // 4 bands per spatial axis."""
    device = resolve_device(device)
    num_bands = dim // 4
    exp = np.arange(0, num_bands, 1, dtype=np.float32) / num_bands
    bands = 1.0 / (temperature**exp)
    t = [np.arange(s, dtype=np.float32) for s in feat_shape]
    if ref_feat_shape is not None:
        t = [x / f * r for x, f, r in zip(t, feat_shape, ref_feat_shape)]
    grid = np.stack(np.meshgrid(*t, indexing="ij"), axis=-1)  # [H, W, 2]
    pos = grid[..., None] * bands  # [H, W, 2, nb]
    n = feat_shape[0] * feat_shape[1]
    sin = np.repeat(np.sin(pos).reshape(n, -1), 2, axis=-1)
    cos = np.repeat(np.cos(pos).reshape(n, -1), 2, axis=-1)
    return torch.from_numpy(np.concatenate([sin, cos], axis=-1)).to(device)


def apply_rope_cat(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """x: [..., N, dim]; rope: [N, 2*dim] (sin||cos). Interleaved pairs
    (x0, x1) -> (-x1, x0), combined in fp32 and cast back to x.dtype."""
    sin, cos = rope.float().chunk(2, dim=-1)
    xf = x.float()
    return (xf * cos + _rotate(xf, xf.shape[-1], True) * sin).to(x.dtype)


def apply_rope_cat_prefixed(x: torch.Tensor, rope: torch.Tensor, n_prefix: int) -> torch.Tensor:
    """The 2-D rope over x [B, S, H, dim], the first `n_prefix` tokens (cls,
    registers) left unrotated: the table gets n_prefix identity rows in
    front (sin = 0, cos = 1), as in JAX."""
    sin, cos = rope.float().chunk(2, dim=-1)
    if n_prefix:
        sin = torch.nn.functional.pad(sin, (0, 0, n_prefix, 0), value=0.0)
        cos = torch.nn.functional.pad(cos, (0, 0, n_prefix, 0), value=1.0)
    sin, cos = sin[:, None], cos[:, None]  # [S, 1, dim]: broadcast over heads
    rot = _rotate(x, x.shape[-1], True)  # a signed permutation: exact in x.dtype
    return (x.float() * cos + rot.float() * sin).to(x.dtype)
