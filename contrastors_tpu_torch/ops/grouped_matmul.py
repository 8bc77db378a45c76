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
Every other input the Pallas kernels take (fp32, or any K and N; block_m a
multiple of 64) goes to `csrc/gmm_generic.cu` (`gmm_generic`,
`tgmm_generic`: register-blocked fp32-FMA products over shared-memory
tiles, the same block -> expert table and zero rules; gmm in 128-row tiles
where block_m allows, tgmm in 128 x 128 tiles with the experts largest
first, both through two stages whose loads overlap the products), as
`grouped_matmul_route` decides from dtype, shape and strides.

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
from contrastors_tpu_torch.ops.flash_attention import (_DTYPE_CODE, FP32_REL, KERNEL_DTYPES, O_ABS_FRAC, O_REL,
                                                       max_rel_error, output_error_ratio)

# How far a kernel's bf16 result may lie from its plain version's, per
# element: REL * |ref| (both round an fp32 sum to bf16; they may land on
# neighbouring values, one ulp <= 2^-7 |x|) plus ABS_FRAC * max |ref| over
# the call (summation order). The flash forward's rule: `error_ratio` <= 1.
REL, ABS_FRAC, error_ratio = O_REL, O_ABS_FRAC, output_error_ratio
# fp32 (the generic kernels): max |out - ref| <= FP32_REL * max |ref| (`max_rel_error`, imported above)
KERNEL_BLOCK_M = 128  # the Hopper kernels'; the generic ones take any multiple of GENERIC_BLOCK_M
GENERIC_BLOCK_M = 64

# kernel launches made by this process (read and reset by chip_smoke.py)
launches_gmm = 0
launches_tgmm = 0
launches_gmm_generic = 0
launches_tgmm_generic = 0


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


def _hopper_widths(lhs, other, block_m):
    # what csrc/gmm.cu computes, layouts aside: bf16, K and N multiples of 64, 128-row blocks
    return (lhs.dtype == other.dtype == torch.bfloat16 and lhs.shape[1] % 64 == 0 and other.shape[-1] % 64 == 0
            and block_m == KERNEL_BLOCK_M)


def grouped_matmul_route(lhs: torch.Tensor, other: torch.Tensor, block_m: int = KERNEL_BLOCK_M) -> str:
    """The kernel that takes gmm's operands (lhs [M, K], rhs [E, K, N]) or
    tgmm's (lhs [M, K], dout [M, N]) on the card, from their dtype, shape
    and strides alone: "hopper" (csrc/gmm.cu) for bf16 with K and N
    multiples of 64, block_m 128 and TMA-aligned operands (`_aligned_rows`,
    `_rhs_ok`), else "generic" (csrc/gmm_generic.cu). Raises TypeError /
    ValueError for what neither takes: another dtype or mixed dtypes, a
    block_m that is not a multiple of GENERIC_BLOCK_M, M not a multiple of
    block_m, or widths that do not match."""
    if lhs.dtype not in KERNEL_DTYPES or other.dtype != lhs.dtype:
        raise TypeError(f"grouped matmul kernels take float32 or bfloat16 operands of one dtype, got "
                        f"{lhs.dtype} and {other.dtype}")
    M, K = lhs.shape
    if block_m <= 0 or block_m % GENERIC_BLOCK_M or M % block_m:
        raise ValueError(f"grouped matmul kernels take block_m a multiple of {GENERIC_BLOCK_M} and M a multiple "
                         f"of block_m, got block_m={block_m}, M={M}")
    if (other.dim() == 3 and other.shape[1] != K) or (other.dim() == 2 and other.shape[0] != M):
        raise ValueError(f"grouped matmul operands do not match: lhs {tuple(lhs.shape)} and "
                         f"{tuple(other.shape)}")
    aligned = _aligned_rows(lhs) and (_rhs_ok(other) if other.dim() == 3 else _aligned_rows(other))
    return "hopper" if _hopper_widths(lhs, other, block_m) and aligned else "generic"


def _prepared(lhs, other, block_m):
    """lhs and rhs / dout, each copied where it is not TMA-aligned (the
    layout csrc/gmm.cu reads; a copy also gives the generic kernels the unit
    stride over the last dim of lhs and dout they read), and the route of
    what results."""
    if len({lhs.device, other.device}) != 1:
        raise ValueError("grouped matmul operands must be on one device")
    lhs = lhs if _aligned_rows(lhs) else lhs.contiguous()
    other = other if (_rhs_ok(other) if other.dim() == 3 else _aligned_rows(other)) else other.contiguous()
    return lhs, other, grouped_matmul_route(lhs, other, block_m)


def launch_gmm(lhs, rhs, blk_e, act, block_m=KERNEL_BLOCK_M):
    """Launch the gmm kernel the operands route to (`grouped_matmul_route`)
    on the current stream: gmm_bf16 of csrc/gmm.cu (rhs with unit stride
    over N or over K; other layouts are copied first) or gmm_generic of
    csrc/gmm_generic.cu; lhs [M, K], rhs [E, K, N], blk_e/act int32
    [M / block_m]. Returns out [M, N] in lhs's dtype."""
    global launches_gmm, launches_gmm_generic
    if rhs.dim() != 3:
        raise ValueError(f"gmm takes rhs [E, K, N], got {tuple(rhs.shape)}")
    lhs, rhs, route = _prepared(lhs, rhs, block_m)
    M, K = lhs.shape
    E, _, N = rhs.shape
    blk_e = blk_e.to(device=lhs.device, dtype=torch.int32).contiguous()
    act = act.to(device=lhs.device, dtype=torch.int32).contiguous()
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    args = (ptr(lhs), ptr(rhs), ptr(blk_e), ptr(act), ptr(out), M, K, N, E)
    if route == "hopper":
        err = load_library("gmm").gmm_bf16(*args, lhs.stride(0), *rhs.stride(), stream(lhs))
    else:
        err = load_library("gmm_generic").gmm_generic(_DTYPE_CODE[lhs.dtype], *args, block_m, lhs.stride(0),
                                                      *rhs.stride(), stream(lhs))
    if err != 0:
        raise RuntimeError(f"gmm ({route}) kernel launch failed: CUDA error {err}")
    if route == "hopper":
        launches_gmm += 1
    else:
        launches_gmm_generic += 1
    return out


def launch_tgmm(lhs, dout, group_sizes, block_m=KERNEL_BLOCK_M):
    """Launch the tgmm kernel the operands route to (`grouped_matmul_route`)
    on the current stream: tgmm_bf16 of csrc/gmm.cu or tgmm_generic of
    csrc/gmm_generic.cu; lhs [M, K], dout [M, N], group_sizes int32 [E]
    (block_m-aligned, summing to at most M). Returns [E, K, N] in lhs's
    dtype, zeros for an expert with no rows. One kernel launch; the Hopper
    kernel orders the experts itself, from group_sizes."""
    global launches_tgmm, launches_tgmm_generic
    if dout.dim() != 2:
        raise ValueError(f"tgmm takes dout [M, N], got {tuple(dout.shape)}")
    lhs, dout, route = _prepared(lhs, dout, block_m)
    M, K = lhs.shape
    N = dout.shape[1]
    gs = group_sizes.to(device=lhs.device, dtype=torch.int32).contiguous()
    E = gs.shape[0]
    out = torch.empty((E, K, N), dtype=lhs.dtype, device=lhs.device)
    args = (ptr(lhs), ptr(dout), ptr(gs), ptr(out), M, K, N, E, lhs.stride(0), dout.stride(0), stream(lhs))
    if route == "hopper":
        err = load_library("gmm").tgmm_bf16(*args)
    else:
        err = load_library("gmm_generic").tgmm_generic(_DTYPE_CODE[lhs.dtype], *args)
    if err != 0:
        raise RuntimeError(f"tgmm ({route}) kernel launch failed: CUDA error {err}")
    if route == "hopper":
        launches_tgmm += 1
    else:
        launches_tgmm_generic += 1
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
