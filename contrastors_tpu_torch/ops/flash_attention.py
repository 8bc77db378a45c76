"""Flash attention: the Hopper CUDA kernels, their wrappers and their plain
PyTorch versions, forward and backward.

Counterpart of `contrastors_tpu/ops/flash_attention.py`. One CUDA kernel,
`csrc/flash_fwd.cu`, stands for both Pallas forward kernels there
(`_fwd_kernel_single` for T <= block_kv and the multi-block `_fwd_kernel`):
a persistent block walks the 64-row kv tiles of each of its q tiles with an
online softmax, so T within one tile is simply a walk of one step.
`csrc/flash_bwd.cu` holds the two backward kernels, `flash_bwd_dq` (for
`_bwd_dq_kernel`) and `flash_bwd_dkv` (for `_bwd_dkv_kernel`). All three
load their operands by TMA through tensor maps over the strided storage
(`csrc/flash_common.cuh`).

Semantics kept from the JAX wrapper:
  - logits s = q k^T in fp32, unscaled; c = softmax_scale * log2(e) enters
    only inside p = exp2(s*c - m*c); the row max has a floor of -1e20/c so a
    fully masked tile gives p == 0;
  - p is cast to v.dtype before the PV product, which accumulates in fp32;
  - masks: segments (valid iff seg_q == seg_kv != 0), bottom-right causal
    (row + T - S >= col), window (|row - col| <= window // 2);
  - attention_mask and segment_ids merge into int32 ids; with the mask only
    and S == T, seg_q = mask, so padded query rows output 0;
  - GQA: q head h reads kv head h // (H / Hkv);
  - O = acc / l with O = 0 where l == 0, and a base-2 LSE m*c + log2(l) that
    is -1e30 on fully masked rows.
Backward (JAX `_bwd`): delta = rowsum(dO * O) in fp32 (inside the dq
kernel, which writes it for the dk/dv kernel; JAX computes it outside);
p = exp2(s*c - lse) from the saved base-2 LSE, p = 0 on rows whose LSE is
-1e30; ds = p * (dp - delta) * softmax_scale with dp = dO v^T;
dq = ds k, dk = ds^T q (ds cast to q's dtype), dv = p^T dO; GQA sums dk/dv
over the q heads of each kv head.

Fused rotary (JAX `rotary_cos/rotary_sin/rotary_interleaved/
rotary_position_ids`, `:802-909`): with S == T the kernels' fused variants
rotate q and k as they load them (`_rot_block`: fp32 combine, one cast) and
the backward applies the rotation's adjoint to the fp32 dq and dk before
their cast (`_rot_adjoint`); the tables are expanded to full-D fp32 rows,
gathered per batch row for position_ids and padded with identity rows to a
multiple of the 64-row tile (`layers/rotary.py:expanded_tables`). With
S != T the wrapper rotates outside (position_ids then raise ValueError, as
in JAX). The plain versions follow the same arithmetic: rotate, then the
plain forward; the plain backward on the rotated operands in fp32, the
adjoint, then the cast.

Routing (`flash_route`, from dtype, shape and strides alone), over every
input the Pallas kernels take (fp32 or bf16, D % 8 == 0, any head dim), the
same semantics everywhere, rotary a run-time choice:
  - "hopper": bf16 at a head dim of 64 or 128 with TMA-aligned operands (and
    a rotary dim that is a multiple of 16), the kernels above;
  - "generic": every other input up to D = 256 (GENERIC_MAX_HEAD_DIM): bf16
    to `csrc/flash_generic.cu` (`flash_generic_fwd`, `flash_generic_dq`,
    `flash_generic_dkv`), fp32 to `csrc/flash_tf32.cu` (`flash_tf32_fwd`,
    `flash_tf32_dq`, `flash_tf32_dkv`: the tensor cores in 3xTF32, three
    TF32 products for each fp32 product);
  - "wide": D > 256 in either dtype, `csrc/flash_wide.cu`
    (`flash_wide_{fwd,dq,dkv}_{bf16,f32}`): the output's columns split into
    slices across blocks, so that no tile or accumulator grows with D. The
    forward streams the products over D in 64-column (bf16) or 32-column
    (fp32) chunks; up to D = 1024 the dq and dk/dv run as thread-block
    clusters of 128-column slices whose blocks sum their shares of S and dP
    through distributed shared memory, above it as the forward. With rotary
    their dq and dk come out in fp32 before the adjoint, which
    `flash_wide_adjoint_*` applies with the cast (`launches_wide_adjoint`).
All run on mma.sync over tiles that arrive by cp.async, or through registers
where a row is not 16-byte aligned or is rotated on load. `flash_shape_ok`
is JAX's rule: what it refuses (D < 64, D % 8 != 0) runs the plain `sdpa` in
`attention_core`, as in JAX.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernels, or the call raises. The call is a `torch.autograd.Function` whose
backward runs the backward kernels (or, on a CPU tensor, their plain
version). It saves q and k un-rotated, with the tables.
"""

from typing import NamedTuple, Optional, Tuple

import ctypes
import math

import torch

from contrastors_tpu_torch._device import on_device
from contrastors_tpu_torch.ops._build import load_library, ptr, stream

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # log2(e)
KERNEL_HEAD_DIMS = (64, 128)  # the Hopper kernels' (bf16 only)
GENERIC_MAX_HEAD_DIM = 256  # the generic kernels' largest head dim (their fp32 tiles fill shared memory); above: wide
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the generic grouped matmul's dtype argument
# fp32 bars of the generic kernels against their plain versions (both
# compute in fp32; the order of sums and exp2's rounding differ, and the
# kernels' products run in 3xTF32 on the tensor cores, about 2^-21 of each
# product):
# max |out - ref| <= FP32_REL * max |ref| for O, dq, dk and dv, and the LSE
# within FP32_LSE_ATOL
FP32_REL = 1e-4
FP32_LSE_ATOL = 1e-4
# How far the kernel's bf16 O may lie from its plain version's, per element:
# O_REL * |ref| (the two fp32 values may round to neighbouring bf16 values,
# one ulp <= 2^-7 |x|) plus O_ABS_FRAC * max |ref| over the call (summation
# order, and p rounded to bf16 against a running rather than the final max).
O_REL = 2.0**-7
O_ABS_FRAC = 2.0**-8
# LSE is fp32 on both sides; only summation order and exp2 rounding differ.
LSE_ATOL = 1e-3
# How far the backward kernels' bf16 dq, dk, dv may lie from the plain
# version's, per element: GRAD_REL * |ref| + GRAD_ABS_FRAC[name] * max |ref|
# over the call. GRAD_REL is one bf16 ulp of the value (both sides round
# their fp32 sum to bf16). The absolute part covers summation order, ds
# values that round to neighbouring bf16 values on the two sides (dq, dk),
# and, for dv only, the kernel's bf16 p in p^T dO, where the plain version
# keeps JAX's fp32 p: a relative error <= 2^-9 on every term of the sum.
GRAD_REL = 2.0**-7
GRAD_ABS_FRAC = {"dq": 2.0**-8, "dk": 2.0**-8, "dv": 2.0**-7}

KERNEL_TILE = 64  # rows of the kernels' walked tiles; the rotary tables are padded to it

# kernel launches made by this process (read and reset by chip_smoke.py)
launches = 0  # flash_fwd
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_rot = 0  # their fused-rotary variants
launches_bwd_dq_rot = 0
launches_bwd_dkv_rot = 0
launches_generic = 0  # the generic forward (flash_generic_fwd, flash_tf32_fwd), with or without rotary
launches_generic_dq = 0
launches_generic_dkv = 0
launches_wide = 0  # the wide forward (flash_wide_fwd_*, D > 256), with or without rotary
launches_wide_dq = 0
launches_wide_dkv = 0
launches_wide_adjoint = 0  # the rotary adjoint pass of the wide dq and dk/dv (rotary only)


class RotaryTables(NamedTuple):
    """The fused variants' rotary: expanded fp32 tables [L, D] (shared by the
    batch) or [B, L, D] (packed position_ids), L >= S a multiple of
    KERNEL_TILE, from `layers.rotary.expanded_tables`."""

    cos: torch.Tensor
    sin: torch.Tensor
    rot_dim: int
    interleaved: bool


def flash_shape_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shapes attention_core sends to the flash path, JAX's rule
    (`contrastors_tpu/ops/flash_attention.py:62-68`): q heads an integer
    multiple of kv heads and a head dim that is a multiple of 8, at least
    64, with no upper bound."""
    return q.shape[2] % k.shape[2] == 0 and q.shape[3] % 8 == 0 and q.shape[3] >= 64


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor, rot_dim: int = 0) -> str:
    """The kernel that takes these operands on the card, from their dtype,
    shape and strides alone: "hopper" (csrc/flash_fwd.cu, flash_bwd.cu) for
    bf16 at a head dim in KERNEL_HEAD_DIMS with TMA-aligned operands
    (`_aligned`) and a rotary dim (0: none) that is a multiple of 16;
    "generic" (csrc/flash_generic.cu, fp32: csrc/flash_tf32.cu) for every
    other head dim up to GENERIC_MAX_HEAD_DIM; "wide" (csrc/flash_wide.cu)
    above it. `more` are the backward's dO and O, of q's shape. Raises
    TypeError / ValueError for what no kernel takes: another dtype or mixed
    dtypes, a head dim that is not a multiple of 8, q heads not a multiple of
    kv heads."""
    B, S, H, D = q.shape
    xs = (q, k, v) + more
    if q.dtype not in KERNEL_DTYPES or any(x.dtype != q.dtype for x in xs):
        raise TypeError(f"flash kernels take float32 or bfloat16 operands of one dtype, got "
                        f"{[x.dtype for x in xs]}")
    if D % 8 or k.shape[3] != D or v.shape[3] != D:
        raise ValueError(f"flash kernels take one head_dim, a multiple of 8, for q, k and v, got "
                         f"{D}, {k.shape[3]}, {v.shape[3]}")
    Hkv = k.shape[2]
    if (Hkv == 0 or H % Hkv != 0 or v.shape[:3] != k.shape[:3] or k.shape[0] != B
            or any(x.shape != q.shape for x in more)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if rot_dim % 2 or rot_dim > D:
        raise ValueError(f"flash kernels take an even rotary dim of at most head_dim {D}, got {rot_dim}")
    if (q.dtype == torch.bfloat16 and D in KERNEL_HEAD_DIMS and rot_dim % 16 == 0
            and all(_aligned(x) for x in xs)):
        return "hopper"
    return "generic" if D <= GENERIC_MAX_HEAD_DIM else "wide"


def max_rel_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / max |ref|: the fp32 bar of the generic kernels is
    this <= FP32_REL."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def output_error_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| over its per-element tolerance (O_REL, O_ABS_FRAC);
    the kernel agrees with its plain version when this is <= 1."""
    out, ref = out.float(), ref.float()
    tol = O_REL * ref.abs() + O_ABS_FRAC * ref.abs().max()
    return ((out - ref).abs() / tol.clamp_min(1e-30)).max().item()


def grad_error_ratio(grad: torch.Tensor, ref: torch.Tensor, name: str) -> float:
    """Largest |grad - ref| over its per-element tolerance (GRAD_REL,
    GRAD_ABS_FRAC[name]) for name in ("dq", "dk", "dv"); the backward kernels
    agree with their plain version when this is <= 1."""
    grad, ref = grad.float(), ref.float()
    tol = GRAD_REL * ref.abs() + GRAD_ABS_FRAC[name] * ref.abs().max()
    return ((grad - ref).abs() / tol.clamp_min(1e-30)).max().item()


def merge_segments(
    B: int,
    S: int,
    T: int,
    attention_mask: Optional[torch.Tensor],
    segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    device: torch.device,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Merge attention_mask and segment ids into int32 [B, S] / [B, T] ids,
    0 = pad (JAX wrapper `flash_attention.py:841-855`). (None, None) means
    unmasked."""
    if segment_ids is not None:
        seg_q = segment_ids.to(device=device, dtype=torch.int32)
        seg_kv = (kv_segment_ids if kv_segment_ids is not None else segment_ids).to(
            device=device, dtype=torch.int32
        )
        if attention_mask is not None:
            seg_kv = seg_kv * attention_mask.to(device=device, dtype=torch.int32)
        return seg_q.contiguous(), seg_kv.contiguous()
    if attention_mask is not None:
        m = attention_mask.to(device=device, dtype=torch.int32).contiguous()
        seg_q = torch.ones((B, S), dtype=torch.int32, device=device) if S != T else m
        return seg_q, m
    return None, None


def _valid(seg_q, seg_kv, S, T, causal_offset, causal, window, device):
    """Boolean [B or 1, 1, S, T] validity of each (row, col) pair, or None."""
    valid = None
    if seg_q is not None:
        valid = (seg_q[:, None, :, None] == seg_kv[:, None, None, :]) & (
            seg_kv[:, None, None, :] != 0
        )
    if causal or window > 0:
        rows = torch.arange(S, device=device)[:, None]
        cols = torch.arange(T, device=device)[None, :]
        band = torch.ones((S, T), dtype=torch.bool, device=device)
        if causal:
            band &= rows + causal_offset >= cols
        if window > 0:
            band &= (rows - cols).abs() <= window // 2
        valid = band[None, None] if valid is None else valid & band
    return valid


def _reference_core(q, k, v, seg_q, seg_kv, causal, causal_offset, window, softmax_scale):
    """Plain PyTorch forward on merged ids. q [B,S,H,D], k/v [B,T,Hkv,D].
    Returns (O [B,S,H,D] in q.dtype, LSE [B,H,S] fp32). Large intermediates
    are updated in place so that the long-context shapes fit on the card."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    c = softmax_scale * LOG2E
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float())  # unscaled fp32
    valid = _valid(seg_q, seg_kv, S, T, causal_offset, causal, window, q.device)
    if valid is not None:
        s.masked_fill_(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min_(-1e20 / c)
    p = s.mul_(c).sub_(m * c).exp2_()  # p = exp2(s*c - m*c), in place of s
    l = p.sum(dim=-1, keepdim=True)
    p.copy_(p.to(v.dtype))  # the kernel's bf16 cast of p, kept in fp32 storage
    acc = torch.einsum("bhst,bthd->bhsd", p, v.float())
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype).transpose(1, 2)
    lse = torch.where(l == 0.0, NEG_INF, m * c + torch.log2(l_safe))[..., 0]
    return out, lse


def _reference_backward_core(q, k, v, out, lse, dout, seg_q, seg_kv, causal, causal_offset,
                             window, softmax_scale, cast=True):
    """Plain PyTorch backward on merged ids, with JAX `_bwd`'s arithmetic
    (fp32 throughout; ds cast to q's dtype before dq and dk, p kept fp32 for
    dv). Not autograd of `_reference_core`, which updates in place. Returns
    (dq [B,S,H,D], dk [B,T,Hkv,D], dv [B,T,Hkv,D]) in q/k/v's dtypes, or in
    fp32 when not cast."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    gq = H // Hkv
    kr, vr = (x.repeat_interleave(gq, dim=2) if gq > 1 else x for x in (k, v))
    c = softmax_scale * LOG2E
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2)[..., None]  # [B,H,S,1]
    lse = lse.float()[..., None]
    s = torch.einsum("bshd,bthd->bhst", q.float(), kr.float()).mul_(c)
    valid = _valid(seg_q, seg_kv, S, T, causal_offset, causal, window, q.device)
    if valid is not None:
        s.masked_fill_(~valid, NEG_INF)
    p = s.sub_(lse).exp2_()  # p = exp2(s*c - lse), in place of s
    p.masked_fill_(lse <= NEG_INF / 2, 0.0)  # fully masked rows: O = 0, no gradient
    dp = torch.einsum("bshd,bthd->bhst", dout.float(), vr.float())
    ds = dp.sub_(delta).mul_(p).mul_(softmax_scale)  # in place of dp
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhst,bthd->bshd", ds, kr.float())
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float())
    dv = torch.einsum("bhst,bshd->bthd", p, dout.float())
    if gq > 1:  # sum over the q heads that read each kv head
        dk = dk.view(B, T, Hkv, gq, D).sum(3)
        dv = dv.view(B, T, Hkv, gq, D).sum(3)
    if not cast:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rotated(rot, *xs):
    from contrastors_tpu_torch.layers.rotary import rotate  # layers imports ops: import at call

    return [rotate(x, rot.cos, rot.sin, rot.rot_dim, rot.interleaved) for x in xs]


def _reference_forward(q, k, v, seg_q, seg_kv, rot, *args):
    """The forward kernel's plain version: q and k rotated (fp32 combine, one
    cast) when rot is given, then `_reference_core`."""
    if rot is not None:
        q, k = _rotated(rot, q, k)
    return _reference_core(q, k, v, seg_q, seg_kv, *args)


def _reference_backward(q, k, v, out, lse, dout, seg_q, seg_kv, rot, *args):
    """The backward kernels' plain version. With rot: the plain backward on
    the rotated q and k, in fp32, then the rotation's adjoint on dq and dk,
    then one cast (JAX `_bwd_dq_kernel`/`_bwd_dkv_kernel` finalize), not
    autograd through the rotation, which would cast twice."""
    if rot is None:
        return _reference_backward_core(q, k, v, out, lse, dout, seg_q, seg_kv, *args)
    from contrastors_tpu_torch.layers.rotary import rotate_adjoint

    qr, kr = _rotated(rot, q, k)
    dq, dk, dv = _reference_backward_core(qr, kr, v, out, lse, dout, seg_q, seg_kv, *args, cast=False)
    dq, dk = (rotate_adjoint(g, rot.cos, rot.sin, rot.rot_dim, rot.interleaved) for g in (dq, dk))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_devices(*xs):
    if len({x.device for x in xs}) != 1:
        raise ValueError("the flash kernels' operands must be on one device")


def _aligned(x):
    # TMA tensor maps (every flash kernel): unit stride over D, other strides
    # positive multiples of 8 elements, the base pointer a multiple of 16 bytes
    return (x.stride(3) == 1 and all(s > 0 and s % 8 == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _kernel_ids(seg_q, seg_kv, device):
    if seg_q is None:
        return None, None
    return (seg_q.to(device=device, dtype=torch.int32).contiguous(),
            seg_kv.to(device=device, dtype=torch.int32).contiguous())


def _rot_args(rot, q, k):
    """The kernels' C rotary arguments (cos, sin, batch stride, rot_dim / 2,
    interleaved); a NULL cos selects the variant without rotary. The rotary
    dim itself is checked by `flash_route` (a multiple of 16 selects the
    Hopper kernels, any even one the generic kernels)."""
    if rot is None:
        return ptr(None), ptr(None), 0, 0, 0
    B, S, _, D = q.shape
    if k.shape[1] != S:
        raise ValueError(f"the fused-rotary kernels need S == T, got {S} and {k.shape[1]}")
    if not 0 < rot.rot_dim <= D:
        raise ValueError(f"the fused-rotary kernels take a rotary dim of at most head_dim {D}, got {rot.rot_dim}")
    rows = -(-S // KERNEL_TILE) * KERNEL_TILE
    for t in (rot.cos, rot.sin):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
                or t.shape[-1] != D or t.shape[-2] < rows or t.shape[:-2] not in ((), (B,))):
            raise ValueError(f"rotary tables must be contiguous fp32 [L, {D}] or [{B}, L, {D}] "
                             f"with L >= {rows} on {q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    sb = rot.cos.shape[1] * D if rot.cos.dim() == 3 else 0
    return ptr(rot.cos), ptr(rot.sin), sb, rot.rot_dim // 2, int(rot.interleaved)


def _rot_dim(rot):
    return 0 if rot is None else rot.rot_dim


def _entry(route, dtype, kernel):
    """The C entry point of `kernel` ("fwd", "dq", "dkv"; "adjoint" for
    "wide") on `route` for operands of dtype: csrc/flash_fwd.cu's or
    flash_bwd.cu's (hopper, bf16); csrc/flash_tf32.cu's for fp32 and
    csrc/flash_generic.cu's for bf16 (generic); csrc/flash_wide.cu's
    (wide)."""
    if route == "hopper":
        if kernel == "fwd":
            return load_library("flash_fwd").flash_fwd_bf16
        return getattr(load_library("flash_bwd"), f"flash_bwd_{kernel}_bf16")
    if route == "wide":
        return getattr(load_library("flash_wide"), f"flash_wide_{kernel}_{'f32' if dtype == torch.float32 else 'bf16'}")
    if dtype == torch.float32:
        return getattr(load_library("flash_tf32"), f"flash_tf32_{kernel}")
    return getattr(load_library("flash_generic"), f"flash_generic_{kernel}")


def _wide_adjoint(g, out, rot):
    """The rotary adjoint pass of the wide dq and dk/dv: g, their fp32
    gradient before the adjoint, into out (contiguous, q's or k's dtype).
    Returns out."""
    global launches_wide_adjoint
    B, L, Hx, D = g.shape
    err = _entry("wide", out.dtype, "adjoint")(ptr(g), ptr(out), B, L, Hx, D, *_rot_args(rot, g, g), stream(g))
    if err != 0:
        raise RuntimeError(f"flash wide rotary adjoint launch failed: CUDA error {err}")
    launches_wide_adjoint += 1
    return out


def _count(route, rot, kernel):
    """One more launch on the counter of `kernel` ("fwd", "dq", "dkv") on
    `route`; on the Hopper kernels, their fused-rotary variant's with rot."""
    if route == "hopper":
        name = dict(fwd="launches", dq="launches_bwd_dq", dkv="launches_bwd_dkv")[kernel]
        name += "" if rot is None else "_rot"
    else:
        name = f"launches_{route}" + ("" if kernel == "fwd" else f"_{kernel}")
    globals()[name] += 1


def _launch_kernel(q, k, v, seg_q, seg_kv, rot, causal, causal_offset, window, softmax_scale):
    """Launch the forward kernel the operands route to (`flash_route`) on
    the current stream: csrc/flash_fwd.cu (its fused-rotary variant when rot
    is given), the generic or the wide forward (`_entry`). Returns (O,
    LSE)."""
    _check_devices(q, k, v)
    q, k, v = (x if _aligned(x) else x.contiguous() for x in (q, k, v))
    route = flash_route(q, k, v, rot_dim=_rot_dim(rot))
    rot_args = _rot_args(rot, q, k)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    seg_q, seg_kv = _kernel_ids(seg_q, seg_kv, q.device)
    args = (
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), ptr(seg_q), ptr(seg_kv),
        B, S, T, H, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(causal_offset), int(window),
        ctypes.c_float(softmax_scale * LOG2E), *rot_args, stream(q),
    )
    err = _entry(route, q.dtype, "fwd")(*args)
    if err != 0:
        raise RuntimeError(f"flash forward ({route}) kernel launch failed: CUDA error {err}")
    _count(route, rot, "fwd")
    return out, lse


def _bwd_call(q, k, v, dout, causal, causal_offset, window, softmax_scale, rot, out=None):
    """The C arguments the two backward kernels share, after the pointers:
    shapes, the strides of q, k, v (and O, for dq) and dO, the options."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    strided = (q, k, v, dout) if out is None else (q, k, v, out, dout)
    return (
        B, S, T, H, Hkv, D,
        *(st for x in strided for st in x.stride()[:3]),
        int(causal), int(causal_offset), int(window),
        ctypes.c_float(softmax_scale * LOG2E), ctypes.c_float(softmax_scale),
        *_rot_args(rot, q, k), stream(q),
    )


def launch_bwd_dq(q, k, v, dout, out, lse, delta, seg_q, seg_kv, route, causal, causal_offset, window,
                  softmax_scale, rot=None):
    """Launch the dq kernel of `route`: flash_bwd_dq of csrc/flash_bwd.cu
    (its fused-rotary variant when rot is given), the generic or the wide dq
    (`_entry`), on prepared inputs (as `prepare_backward` prepares them,
    given the same rot: q/k/v/dout/out of one dtype with a unit stride over
    D, contiguous fp32 lse and the delta buffer [B, H, S], contiguous int32
    ids or None, and the route). Writes delta = rowsum(dO * O) into `delta`,
    for `launch_bwd_dkv`. The wide dq with rot writes an fp32 dq before the
    adjoint, which `_wide_adjoint` finishes. Returns dq."""
    B, S, H, D = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    pre = dq if route != "wide" or rot is None else torch.empty(dq.shape, dtype=torch.float32, device=q.device)
    args = (
        ptr(q), ptr(k), ptr(v), ptr(dout), ptr(out), ptr(lse), ptr(delta), ptr(pre),
        ptr(seg_q), ptr(seg_kv),
        *_bwd_call(q, k, v, dout, causal, causal_offset, window, softmax_scale, rot, out),
    )
    err = _entry(route, q.dtype, "dq")(*args)
    if err != 0:
        raise RuntimeError(f"flash dq ({route}) kernel launch failed: CUDA error {err}")
    _count(route, rot, "dq")
    return dq if pre is dq else _wide_adjoint(pre, dq, rot)


def launch_bwd_dkv(q, k, v, dout, out, lse, delta, seg_q, seg_kv, route, causal, causal_offset, window,
                   softmax_scale, rot=None):
    """Launch the dk/dv kernel of `route`: flash_bwd_dkv of
    csrc/flash_bwd.cu (its fused-rotary variant when rot is given), the
    generic or the wide dk/dv (`_entry`), on prepared inputs (see
    `launch_bwd_dq`, which must have written delta first, on the same
    stream; out is not read). The wide dk/dv with rot writes an fp32 dk
    before the adjoint, which `_wide_adjoint` finishes. Returns (dk, dv)."""
    B, T, Hkv, D = k.shape
    dk = torch.empty((B, T, Hkv, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, T, Hkv, D), dtype=v.dtype, device=v.device)
    pre = dk if route != "wide" or rot is None else torch.empty(dk.shape, dtype=torch.float32, device=k.device)
    args = (
        ptr(q), ptr(k), ptr(v), ptr(dout), ptr(lse), ptr(delta), ptr(pre), ptr(dv),
        ptr(seg_q), ptr(seg_kv),
        *_bwd_call(q, k, v, dout, causal, causal_offset, window, softmax_scale, rot),
    )
    err = _entry(route, q.dtype, "dkv")(*args)
    if err != 0:
        raise RuntimeError(f"flash dk/dv ({route}) kernel launch failed: CUDA error {err}")
    _count(route, rot, "dkv")
    return (dk if pre is dk else _wide_adjoint(pre, dk, rot)), dv


def prepare_backward(q, k, v, out, lse, dout, seg_q, seg_kv, rot=None):
    """Check and lay out the backward kernels' inputs, with no elementwise
    work, and route them once (`flash_route`, with rot's rotary dim): delta
    = rowsum(dO * O) is computed by the dq kernel into the [B, H, S] fp32
    buffer allocated here. Returns (q, k, v, dout, out, lse, delta, seg_q,
    seg_kv, route) for the two launchers."""
    _check_devices(q, k, v)
    for name, x in (("dout", dout), ("out", out)):
        if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    q, k, v, dout, out = (x if _aligned(x) else x.contiguous() for x in (q, k, v, dout, out))
    route = flash_route(q, k, v, dout, out, rot_dim=_rot_dim(rot))  # raises for what no kernel takes
    B, S, H, _ = q.shape
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lse = lse.to(torch.float32).contiguous()
    return (q, k, v, dout, out, lse, delta, *_kernel_ids(seg_q, seg_kv, q.device), route)


def _launch_backward(q, k, v, out, lse, dout, seg_q, seg_kv, rot, *args):
    """Both backward kernels on the current stream. Returns (dq, dk, dv)."""
    inputs = prepare_backward(q, k, v, out, lse, dout, seg_q, seg_kv, rot)
    dq = launch_bwd_dq(*inputs, *args, rot=rot)
    return (dq, *launch_bwd_dkv(*inputs, *args, rot=rot))


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, rot_cos, rot_sin, rot_dim, rot_interleaved, causal,
                causal_offset, window, softmax_scale):
        rot = None if rot_cos is None else RotaryTables(rot_cos, rot_sin, rot_dim, rot_interleaved)
        args = (causal, causal_offset, window, softmax_scale)
        out, lse = on_device(q, _reference_forward, _launch_kernel, q, k, v, seg_q, seg_kv, rot, *args)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_kv, rot_cos, rot_sin)
        ctx.rot, ctx.args = (rot_dim, rot_interleaved), args
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, seg_q, seg_kv, rot_cos, rot_sin = ctx.saved_tensors
        rot = None if rot_cos is None else RotaryTables(rot_cos, rot_sin, *ctx.rot)
        dq, dk, dv = on_device(q, _reference_backward, _launch_backward,
                                q, k, v, out, lse, dout, seg_q, seg_kv, rot, *ctx.args)
        return (dq, dk, dv) + (None,) * 10


def _prepare(q, k, attention_mask, segment_ids, kv_segment_ids, causal, softmax_scale):
    B, S, _, D = q.shape
    T = k.shape[1]
    seg_q, seg_kv = merge_segments(B, S, T, attention_mask, segment_ids, kv_segment_ids, q.device)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    return seg_q, seg_kv, (T - S) if causal else 0, scale


def _rotary(q, k, cos, sin, interleaved, position_ids, outside_ok=True):
    """(q, k, rot) for the rotary arguments: rot = RotaryTables for the fused
    variants (S == T), or None with q and k rotated here (S != T, the JAX
    wrapper's rule, `:808-821`) or without rotary. The backward entry points
    take S == T only (outside_ok=False): their gradients are those of the
    un-rotated q and k."""
    if cos is None:
        return q, k, None
    S, T, D = q.shape[1], k.shape[1], q.shape[3]
    if S != T:
        if position_ids is not None or not outside_ok:
            raise ValueError(
                f"rotary_position_ids is a [B, S] q-side table and cannot rotate a length-{T} k "
                f"(S={S} != T); fused rotary needs S == T, rotate q/k outside the kernel")
        from contrastors_tpu_torch.layers.rotary import apply_rotary

        return apply_rotary(q, cos, sin, interleaved), apply_rotary(k, cos, sin, interleaved), None
    from contrastors_tpu_torch.layers.rotary import expanded_tables

    cos_d, sin_d = expanded_tables(cos.to(q.device), sin.to(q.device), D, interleaved, S,
                                   position_ids, pad_to=KERNEL_TILE)
    return q, k, RotaryTables(cos_d, sin_d, 2 * cos.shape[-1], bool(interleaved))


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    softmax_scale: Optional[float] = None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    rotary_interleaved: bool = False,
    rotary_position_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward returning (O [B,S,H,D], base-2 LSE [B,H,S] fp32): the kernel
    on a CUDA tensor, the plain version on a CPU tensor. rotary_cos/sin
    ([L >= S, rot_dim/2] fp32, layers/rotary.py conventions) select the
    fused-rotary variants; rotary_position_ids [B, S] gathers per-row
    positions (packed rows)."""
    q, k, rot = _rotary(q, k, rotary_cos, rotary_sin, rotary_interleaved, rotary_position_ids)
    seg_q, seg_kv, offset, scale = _prepare(
        q, k, attention_mask, segment_ids, kv_segment_ids, causal, softmax_scale
    )
    cos_d, sin_d, rot_dim, interleaved = rot if rot is not None else (None, None, 0, False)
    return _FlashForward.apply(q, k, v, seg_q, seg_kv, cos_d, sin_d, rot_dim, interleaved,
                               causal, offset, window, scale)


def flash_attention(*args, **kwargs) -> torch.Tensor:
    """Public entry, with the arguments of `flash_attention_fwd`. q [B,S,H,D];
    k/v [B,T,Hkv,D] (any strides with a unit stride over D); returns O
    [B,S,H,D]."""
    return flash_attention_fwd(*args, **kwargs)[0]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    softmax_scale: Optional[float] = None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    rotary_interleaved: bool = False,
    rotary_position_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version on any device: (O, LSE) with the
    same semantics, including O = 0 and LSE = -1e30 on fully masked rows;
    with rotary tables, that of the fused-rotary variant."""
    q, k, rot = _rotary(q, k, rotary_cos, rotary_sin, rotary_interleaved, rotary_position_ids)
    seg_q, seg_kv, offset, scale = _prepare(
        q, k, attention_mask, segment_ids, kv_segment_ids, causal, softmax_scale
    )
    return _reference_forward(q, k, v, seg_q, seg_kv, rot, causal, offset, window, scale)


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    softmax_scale: Optional[float] = None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    rotary_interleaved: bool = False,
    rotary_position_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the forward's (O, LSE) and the gradient dout of O:
    the backward kernels on a CUDA tensor, the plain version on a CPU
    tensor. This is what the autograd backward of `flash_attention` runs.
    q and k are un-rotated; rotary needs S == T."""
    q, k, rot = _rotary(q, k, rotary_cos, rotary_sin, rotary_interleaved, rotary_position_ids,
                        outside_ok=False)
    seg_q, seg_kv, offset, scale = _prepare(
        q, k, attention_mask, segment_ids, kv_segment_ids, causal, softmax_scale
    )
    return on_device(q, _reference_backward, _launch_backward,
                      q, k, v, out, lse, dout, seg_q, seg_kv, rot, causal, offset, window, scale)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: int = 0,
    softmax_scale: Optional[float] = None,
    rotary_cos: Optional[torch.Tensor] = None,
    rotary_sin: Optional[torch.Tensor] = None,
    rotary_interleaved: bool = False,
    rotary_position_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain PyTorch version on any device: (dq, dk,
    dv) with JAX `_bwd`'s arithmetic, dq = 0 on fully masked rows; with
    rotary tables (S == T), that of the fused-rotary variants."""
    q, k, rot = _rotary(q, k, rotary_cos, rotary_sin, rotary_interleaved, rotary_position_ids,
                        outside_ok=False)
    seg_q, seg_kv, offset, scale = _prepare(
        q, k, attention_mask, segment_ids, kv_segment_ids, causal, softmax_scale
    )
    return _reference_backward(q, k, v, out, lse, dout, seg_q, seg_kv, rot, causal, offset,
                               window, scale)
