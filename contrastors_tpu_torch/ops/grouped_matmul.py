"""Grouped matmul for the dropless MoE layer: the Hopper CUDA kernels, their
wrappers, their plain PyTorch versions and the dispatch layout helpers.

Counterpart of `contrastors_tpu/ops/grouped_matmul.py`. The A = N*k
(token, expert) assignments are laid out sorted by expert, with every group
start aligned to `block_m` rows, so each `block_m`-row block belongs to one
expert (`aligned_group_layout`). Then:
  - `gmm(lhs [M, K], rhs [E, K, N], group_sizes [E]) -> [M, N]`: each
    active block times its expert's [K, N] panel; blocks past
    sum(group_sizes) are padding and come out 0. A `torch.autograd.Function`
    whose backward is, as the JAX custom VJP's, dlhs = gmm(dout, rhs^T) on
    the `rhs.transpose(1, 2)` view (the kernel takes it through its
    strides) and drhs = tgmm(lhs, dout);
  - tgmm: drhs[e] = sum over e's blocks of lhs_b^T @ dout_b, 0 for an
    expert with no rows.
`csrc/gmm.cu` holds both kernels (`gmm_bf16` for `_gmm_kernel`, `tgmm_bf16`
for `_tgmm_kernel`): TMA loads into a ring of shared-memory stages guarded
by mbarriers, products by wgmma. They take bf16 operands, accumulate in
fp32 and write bf16, with block_m = 128 and K, N multiples of 64. tgmm's
blocks take the experts largest first, all tiles of one expert together.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel, or the call raises. The plain versions compute what the Pallas
kernels compute: each row of an active block is that row times its
expert's panel in fp32, cast to the output dtype (they take the blocks of
one expert together, which gives each row the same product). The layout
helpers keep group sizes, offsets and the block -> expert table on the
device: no host sync per layer, and P = round_up(A, block_m) + E * block_m
is static.
"""

from typing import Optional, Tuple

import torch

from contrastors_tpu_torch._device import on_device
from contrastors_tpu_torch.ops._build import load_library, ptr, stream
from contrastors_tpu_torch.ops.flash_attention import O_ABS_FRAC, O_REL, output_error_ratio

# How far a kernel's bf16 result may lie from its plain version's, per
# element: REL * |ref| (both round an fp32 sum to bf16; they may land on
# neighbouring values, one ulp <= 2^-7 |x|) plus ABS_FRAC * max |ref| over
# the call (summation order). The flash forward's rule: `error_ratio` <= 1.
REL, ABS_FRAC, error_ratio = O_REL, O_ABS_FRAC, output_error_ratio
KERNEL_BLOCK_M = 128

# kernel launches made by this process (read and reset by chip_smoke.py)
launches_gmm = 0
launches_tgmm = 0


def block_experts(group_sizes: torch.Tensor, num_blocks: int, block_m: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block -> owning expert, block -> active flag), int32 [num_blocks].
    group_sizes are block_m-aligned; empty groups own no blocks; blocks past
    the last group map to the last expert with active = 0 (JAX
    `_block_experts`)."""
    gs = group_sizes.to(torch.int64)
    offsets = torch.cumsum(gs, 0) - gs  # aligned starts
    starts = torch.arange(num_blocks, dtype=torch.int64, device=gs.device) * block_m
    # last e with offsets[e] <= start, skipping empty groups (equal offsets)
    blk_e = (torch.searchsorted(offsets, starts, right=True) - 1).clamp_min(0)
    active = starts < gs.sum()
    return blk_e.to(torch.int32), active.to(torch.int32)


def aligned_group_layout(flat_e: torch.Tensor, num_groups: int, block_m: int,
                         src_of: Optional[torch.Tensor] = None, sentinel: Optional[int] = None):
    """Dropless dispatch layout of the A = len(flat_e) assignments: expert-
    sorted (stably), every group start aligned to block_m.

    Returns (dest [A], group_sizes_padded [E], P), plus src [P] when src_of
    (the source token of each assignment) is given: the source token of each
    aligned row, `sentinel` on padding rows (callers point it at an appended
    zero row). dest[a] is the row of assignment a in the [P, ...] buffer;
    P = round_up(A, block_m) + E * block_m covers the worst-case padding.
    Everything stays on flat_e's device; nothing is read back to the host.
    """
    A, E = flat_e.shape[0], num_groups
    dev = flat_e.device
    flat_e = flat_e.to(torch.int64)
    g = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(0, flat_e, torch.ones_like(flat_e))
    gp = (g + block_m - 1) // block_m * block_m  # padded sizes
    off = torch.cumsum(gp, 0) - gp  # aligned starts
    uoff = torch.cumsum(g, 0) - g  # unpadded starts within the sorted order
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    rank = torch.arange(A, dtype=torch.int64, device=dev) - uoff[e_sorted]
    dest = torch.empty(A, dtype=torch.int64, device=dev)
    dest[order] = off[e_sorted] + rank
    P = (A + block_m - 1) // block_m * block_m + E * block_m
    if src_of is None:
        return dest, gp.to(torch.int32), P
    if sentinel is None:
        # padding rows gather src[sentinel]: it must name a zero row, or the
        # expert gradients absorb a real token's activations on every
        # padding row
        raise ValueError("aligned_group_layout: sentinel is required with src_of")
    src = torch.full((P,), sentinel, dtype=torch.int64, device=dev)
    src[dest] = src_of.to(torch.int64)
    return dest, gp.to(torch.int32), P, src


def _rows_of(blk_e, act, e, block_m):
    """Row indices of expert e's active blocks."""
    blocks = torch.nonzero((blk_e == e) & (act != 0)).squeeze(1)
    offs = torch.arange(block_m, device=blk_e.device)
    return (blocks[:, None] * block_m + offs[None]).reshape(-1)


def _gmm_plain(lhs, rhs, blk_e, act, block_m):
    """Plain gmm: fp32 products of each expert's active rows, cast to
    lhs.dtype; rows of inactive blocks are 0."""
    M, N = lhs.shape[0], rhs.shape[2]
    out = torch.zeros((M, N), dtype=torch.float32, device=lhs.device)
    for e in range(rhs.shape[0]):
        rows = _rows_of(blk_e, act, e, block_m)
        if rows.numel():
            out[rows] = lhs[rows].float() @ rhs[e].float()
    return out.to(lhs.dtype)


def tgmm_reference(lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor,
                   block_m: int = 128) -> torch.Tensor:
    """The tgmm kernel's plain PyTorch version on any device: drhs[e] =
    lhs_e^T @ dout_e over e's rows in fp32, cast to lhs.dtype, [E, K, N];
    0 for an expert with no rows."""
    E = group_sizes.shape[0]
    blk_e, act = block_experts(group_sizes, lhs.shape[0] // block_m, block_m)
    out = torch.zeros((E, lhs.shape[1], dout.shape[1]), dtype=torch.float32, device=lhs.device)
    for e in range(E):
        rows = _rows_of(blk_e, act, e, block_m)
        if rows.numel():
            out[e] = lhs[rows].float().T @ dout[rows].float()
    return out.to(lhs.dtype)


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                  block_m: int = 128) -> torch.Tensor:
    """The gmm kernel's plain PyTorch version on any device (no autograd)."""
    blk_e, act = block_experts(group_sizes, lhs.shape[0] // block_m, block_m)
    return _gmm_plain(lhs, rhs, blk_e, act, block_m)


def _aligned_rows(x):
    # TMA: unit stride over the last dim, row stride and base pointer
    # multiples of 16 bytes (8 elements), rows that do not overlap
    return (x.stride(1) == 1 and x.stride(0) % 8 == 0 and x.stride(0) >= x.shape[1]
            and x.data_ptr() % 16 == 0)


def _rhs_ok(rhs):
    # the same for rhs [E, K, N] with unit stride over N or over K
    E, K, N = rhs.shape
    se, sk, sn = rhs.stride()
    if sn == 1:
        unit = sk % 8 == 0 and sk >= N and se >= sk * K
    else:
        unit = sk == 1 and sn % 8 == 0 and sn >= K and se >= sn * N
    return unit and se % 8 == 0 and rhs.data_ptr() % 16 == 0


def _check(name, block_m, *tensors):
    if block_m != KERNEL_BLOCK_M:
        raise ValueError(f"{name} kernel takes block_m={KERNEL_BLOCK_M}, got {block_m}")
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise TypeError(f"{name} kernel takes bfloat16 operands, got {[x.dtype for x in tensors]}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"{name}: operands must be on one device")


def launch_gmm(lhs, rhs, blk_e, act, block_m=KERNEL_BLOCK_M):
    """Launch gmm_bf16 of csrc/gmm.cu on the current stream: lhs [M, K], rhs
    [E, K, N] with unit stride over N or over K (other layouts are copied
    first), blk_e/act int32 [M / 128]. Returns out [M, N] bf16."""
    global launches_gmm
    _check("gmm", block_m, lhs, rhs)
    M, K = lhs.shape
    E, K2, N = rhs.shape
    if K2 != K or M % block_m or K % 64 or N % 64:
        raise ValueError(f"gmm kernel takes M % 128 == 0 and K, N multiples of 64, got "
                         f"lhs {tuple(lhs.shape)} rhs {tuple(rhs.shape)}")
    lhs = lhs if _aligned_rows(lhs) else lhs.contiguous()
    rhs = rhs if _rhs_ok(rhs) else rhs.contiguous()
    blk_e = blk_e.to(device=lhs.device, dtype=torch.int32).contiguous()
    act = act.to(device=lhs.device, dtype=torch.int32).contiguous()
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    err = load_library("gmm").gmm_bf16(
        ptr(lhs), ptr(rhs), ptr(blk_e), ptr(act), ptr(out), M, K, N, E,
        lhs.stride(0), *rhs.stride(), stream(lhs),
    )
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    launches_gmm += 1
    return out


def launch_tgmm(lhs, dout, group_sizes, block_m=KERNEL_BLOCK_M):
    """Launch tgmm_bf16 of csrc/gmm.cu on the current stream: lhs [M, K],
    dout [M, N], group_sizes int32 [E] (128-aligned, summing to at most M).
    Returns [E, K, N] bf16, zeros for an expert with no rows. One kernel
    launch; the kernel orders the experts itself, from group_sizes."""
    global launches_tgmm
    _check("tgmm", block_m, lhs, dout)
    M, K = lhs.shape
    N = dout.shape[1]
    if dout.shape[0] != M or M % block_m or K % 64 or N % 64:
        raise ValueError(f"tgmm kernel takes M % 128 == 0 and K, N multiples of 64, got "
                         f"lhs {tuple(lhs.shape)} dout {tuple(dout.shape)}")
    lhs = lhs if _aligned_rows(lhs) else lhs.contiguous()
    dout = dout if _aligned_rows(dout) else dout.contiguous()
    gs = group_sizes.to(device=lhs.device, dtype=torch.int32).contiguous()
    E = gs.shape[0]
    out = torch.empty((E, K, N), dtype=lhs.dtype, device=lhs.device)
    err = load_library("gmm").tgmm_bf16(
        ptr(lhs), ptr(dout), ptr(gs), ptr(out), M, K, N, E,
        lhs.stride(0), dout.stride(0), stream(lhs),
    )
    if err != 0:
        raise RuntimeError(f"tgmm kernel launch failed: CUDA error {err}")
    launches_tgmm += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, blk_e, act, block_m):
        out = on_device(lhs, _gmm_plain, launch_gmm, lhs, rhs, blk_e, act, block_m)
        ctx.save_for_backward(lhs, rhs, group_sizes, blk_e, act)
        ctx.block_m = block_m
        return out

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes, blk_e, act = ctx.saved_tensors
        bm = ctx.block_m
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            # dlhs = gmm(dout, rhs^T): the transposed view, not a copy
            dlhs = on_device(lhs, _gmm_plain, launch_gmm, dout.to(rhs.dtype), rhs.transpose(1, 2),
                              blk_e, act, bm).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = on_device(lhs, tgmm_reference, launch_tgmm, lhs, dout.to(lhs.dtype), group_sizes,
                              bm).to(rhs.dtype)
        return dlhs, drhs, None, None, None, None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        block_m: int = 128, blocks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Grouped matmul over a block_m-aligned expert-sorted row layout:
    lhs [M, K] (M a multiple of block_m), rhs [E, K, N], group_sizes [E]
    block_m-aligned padded counts (on lhs's device). `blocks` is the
    layout's `block_experts` table, for callers that run several gmm on one
    layout; it is built here when not given. Returns [M, N] in lhs.dtype.
    Differentiable in lhs and rhs."""
    if lhs.shape[0] % block_m:
        raise ValueError(f"M={lhs.shape[0]} must be a multiple of block_m={block_m}")
    blk_e, act = blocks if blocks is not None else block_experts(group_sizes, lhs.shape[0] // block_m, block_m)
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, blk_e, act, block_m)
