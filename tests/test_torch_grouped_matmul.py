"""The port's grouped matmul against the JAX package's.

The plain versions (`gmm_reference`, `tgmm_reference`, which the autograd
Function runs on CPU tensors) are held to JAX `_gmm_call` and `_tgmm_call`,
the Pallas kernels in interpret mode as tests/test_grouped_matmul.py runs
them, on a layout with an empty expert and trailing inactive blocks (K and
N multiples of 128): rtol/atol 1e-5 for fp32 operands (fp32 sums in
another order); for bf16 operands the per-element rule that holds the CUDA
kernels to the plain versions on the card (`error_ratio` <= 1: both round
an fp32 sum to bf16). The port's gmm gradients are held to jax.grad of the
JAX gmm (the Pallas custom VJP, interpreted) at 1e-5, and the layout
helpers to JAX's element for element. The fault test shows that the
per-element rule accepts the kernels' tiled bf16 arithmetic and rejects
planted faults (among them the ring's: a stale stage, a row slice dropped
or summed twice).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.ops import grouped_matmul as jgm
from contrastors_tpu_torch.ops import grouped_matmul as tgm

E, BM, K, N = 4, 16, 128, 256
GROUPS = [2 * BM, 0, 3 * BM, BM]  # padded sizes: expert 1 is empty
M = sum(GROUPS) + 2 * BM  # two trailing inactive blocks


def _problem(seed):
    rng = np.random.default_rng(seed)
    lhs = np.zeros((M, K), np.float32)
    lhs[: sum(GROUPS)] = rng.normal(size=(sum(GROUPS), K))
    rhs = rng.normal(size=(E, K, N)).astype(np.float32)
    dout = rng.normal(size=(M, N)).astype(np.float32)
    return lhs, rhs, dout, np.asarray(GROUPS, np.int32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return j, t


def _close(t, j, dtype):
    j = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32)))
    if dtype == "float32":
        torch.testing.assert_close(t.float(), j, rtol=1e-5, atol=1e-5)
    else:
        assert tgm.error_ratio(t, j) <= 1.0


@pytest.mark.parametrize("groups", [[32, 0, 48, 16], [0, 0, 64, 0], [16, 16, 16, 16], [0, 0, 0, 0]])
def test_block_experts_matches_jax(groups):
    gs = np.asarray(groups, np.int32)
    nb = M // BM
    j_blk, j_act = jgm._block_experts(jnp.asarray(gs), nb, BM)
    t_blk, t_act = tgm.block_experts(torch.from_numpy(gs), nb, BM)
    np.testing.assert_array_equal(t_blk.numpy(), np.asarray(j_blk))
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))


@pytest.mark.parametrize("seed,A,skew", [(0, 100, 0.0), (1, 64, 2.0), (2, 257, 4.0)])
def test_aligned_group_layout_matches_jax(seed, A, skew):
    """Skewed assignments (an expert may get none); the sort is stable, so
    dest matches element for element, and src too."""
    rng = np.random.default_rng(seed)
    p = np.exp(skew * rng.normal(size=5))
    flat_e = rng.choice(5, size=A, p=p / p.sum()).astype(np.int32)
    token_of = np.repeat(np.arange(A // 2 + 1, dtype=np.int32), 2)[:A]
    j = jgm.aligned_group_layout(jnp.asarray(flat_e), 5, 8, src_of=jnp.asarray(token_of), sentinel=999)
    t = tgm.aligned_group_layout(torch.from_numpy(flat_e), 5, 8, src_of=torch.from_numpy(token_of),
                                 sentinel=999)
    assert t[2] == j[2]  # P
    for tx, jx in zip((t[0], t[1], t[3]), (j[0], j[1], j[3])):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    dest, gp, P = tgm.aligned_group_layout(torch.from_numpy(flat_e), 5, 8)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(j[0]))
    with pytest.raises(ValueError, match="sentinel"):
        tgm.aligned_group_layout(torch.from_numpy(flat_e), 5, 8, src_of=torch.from_numpy(token_of))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_reference_matches_jax_pallas(dtype):
    lhs, rhs, dout, gs = _problem(0)
    (jl, tl), (jr, tr), (jd, td) = (_both(x, dtype) for x in (lhs, rhs, dout))
    blk, act = jgm._block_experts(jnp.asarray(gs), M // BM, BM)
    j_out = jgm._gmm_call(jl, jr, blk, act, BM, 128)
    t_out = tgm.gmm_reference(tl, tr, torch.from_numpy(gs), BM)
    assert t_out.dtype == tl.dtype
    _close(t_out, j_out, dtype)
    assert bool((t_out[sum(GROUPS):] == 0).all())  # inactive blocks are exactly 0
    # the transposed-rhs view dlhs uses: [E, N, K] through strides
    j_t = jgm._gmm_call(jd, jnp.swapaxes(jr, 1, 2), blk, act, BM, 128)
    t_t = tgm.gmm_reference(td, tr.transpose(1, 2), torch.from_numpy(gs), BM)
    _close(t_t, j_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_reference_matches_jax_pallas(dtype):
    lhs, rhs, dout, gs = _problem(1)
    (jl, tl), (jd, td) = (_both(x, dtype) for x in (lhs, dout))
    blk, act = jgm._block_experts(jnp.asarray(gs), M // BM, BM)
    j_out = jgm._tgmm_call(jl, jd, blk, act, E, BM, 128)
    # JAX zeroes the experts the kernel never visited after the call
    j_out = jnp.where((jnp.asarray(gs) > 0)[:, None, None], j_out, 0.0)
    t_out = tgm.tgmm_reference(tl, td, torch.from_numpy(gs), BM)
    assert t_out.shape == (E, K, N) and t_out.dtype == tl.dtype
    _close(t_out, j_out, dtype)
    assert bool((t_out[1] == 0).all())  # the empty expert


def test_gmm_grads_match_jax(monkeypatch):
    """jax.grad of the JAX gmm (custom VJP: Pallas dlhs and tgmm, both
    interpreted) against autograd of the port's gmm on CPU tensors."""
    monkeypatch.setenv("CONTRASTORS_TPU_GMM_INTERPRET", "1")
    lhs, rhs, dout, gs = _problem(2)
    w = np.random.default_rng(3).normal(size=(M, N)).astype(np.float32)

    def j_loss(a, b):
        return jnp.sum(jgm.gmm(a, b, jnp.asarray(gs), block_m=BM) * w)

    j_dl, j_dr = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl, tr = (torch.from_numpy(x).requires_grad_() for x in (lhs, rhs))
    (tgm.gmm(tl, tr, torch.from_numpy(gs), BM) * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(tl.grad, torch.from_numpy(np.array(j_dl)), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tr.grad, torch.from_numpy(np.array(j_dr)), rtol=1e-5, atol=1e-5)
    assert bool((tr.grad[1] == 0).all()) and bool((tl.grad[sum(GROUPS):] == 0).all())


def test_gmm_takes_a_shared_block_table():
    """gmm given the layout's block_experts table (as MoEMLP passes it to
    its three gmm) equals gmm building the table itself, forward and grads."""
    lhs, rhs, _, gs = _problem(5)
    tg = torch.from_numpy(gs)
    blocks = tgm.block_experts(tg, M // BM, BM)
    results = []
    for kw in ({}, {"blocks": blocks}):
        tl, tr = (torch.from_numpy(x).requires_grad_() for x in (lhs, rhs))
        out = tgm.gmm(tl, tr, tg, BM, **kw)
        (out * out).sum().backward()
        results.append((out.detach(), tl.grad, tr.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gmm_dispatch_and_shape_checks():
    lhs, rhs, _, gs = _problem(4)
    tl, tr, tg = torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(gs)
    before = (tgm.launches_gmm, tgm.launches_tgmm)
    out = tgm.gmm(tl, tr, tg, BM)  # a CPU tensor: the plain version, no launch
    torch.testing.assert_close(out, tgm.gmm_reference(tl, tr, tg, BM), rtol=0, atol=0)
    assert (tgm.launches_gmm, tgm.launches_tgmm) == before
    with pytest.raises(ValueError, match="multiple of block_m"):
        tgm.gmm(tl[:-1], tr, tg, BM)
    with pytest.raises(ValueError, match="run on cuda .* on cpu, got meta"):
        tgm.gmm(tl.to("meta"), tr.to("meta"), tg.to("meta"), BM)


STAGES = 4  # the kernels' ring of 64-deep stages (csrc/gmm.cu kStages, kDepth)


def _tiled_gmm(lhs, rhs, blk_e, act, fault):
    """gmm in the kernel's arithmetic: bf16 operands, fp32 sums of 64-deep
    slices per 128-row block, bf16 out, with an optional fault.
    `stale_ring_stage` multiplies lhs slice j with the rhs slice of the
    stage loaded STAGES steps earlier (a ring stage reused before it was
    refilled)."""
    blk_e, act = blk_e.clone(), act.clone()
    if fault == "blk_e_off_by_one":  # the table read one block late
        blk_e = torch.roll(blk_e, 1)
    if fault == "dropped_last_block":
        act[int(torch.nonzero(act).max())] = 0
    out = torch.zeros(lhs.shape[0], rhs.shape[2])
    for i in range(blk_e.shape[0]):
        if act[i]:
            rows = slice(i * 128, (i + 1) * 128)
            for j, k0 in enumerate(range(0, lhs.shape[1], 64)):
                kb = k0 - 64 * STAGES if fault == "stale_ring_stage" and j >= STAGES else k0
                out[rows] += lhs[rows, k0:k0 + 64].float() @ rhs[blk_e[i], kb:kb + 64].float()
    return out.bfloat16()


def _tiled_tgmm(lhs, dout, group_sizes, fault):
    """tgmm in the kernel's arithmetic: fp32 sums of 64-row slices of each
    expert's rows; `no_reset` carries the sum across expert boundaries;
    `stale_ring_stage` pairs lhs slice j with the dout slice STAGES steps
    earlier; `dropped_row_slice` skips the last slice of the largest
    expert; `row_slice_twice` adds its first slice twice."""
    E = group_sizes.shape[0]
    out = torch.zeros(E, lhs.shape[1], dout.shape[1])
    acc = torch.zeros(lhs.shape[1], dout.shape[1])
    largest = int(torch.argmax(group_sizes))
    start = 0
    for e in range(E):
        if fault != "tgmm_no_reset":
            acc = torch.zeros_like(acc)
        slices = list(range(start, start + int(group_sizes[e]), 64))
        for j, r0 in enumerate(slices):
            if fault == "dropped_row_slice" and e == largest and j == len(slices) - 1:
                continue
            rb = r0 - 64 * STAGES if fault == "stale_ring_stage" and j >= STAGES else r0
            times = 2 if fault == "row_slice_twice" and e == largest and j == 0 else 1
            for _ in range(times):
                acc = acc + lhs[r0:r0 + 64].float().T @ dout[rb:rb + 64].float()
        out[e] = acc
        start += int(group_sizes[e])
    return out.bfloat16()


@pytest.mark.parametrize("fault", ["none", "blk_e_off_by_one", "dropped_last_block", "tgmm_no_reset",
                                   "stale_ring_stage", "dropped_row_slice", "row_slice_twice"])
def test_error_rule_rejects_gmm_faults(fault):
    """The rule that holds gmm and tgmm to their plain versions on the card
    (`error_ratio` <= 1) accepts the tiled bf16 arithmetic and rejects a
    block -> expert table off by one block, a dropped last active block, a
    tgmm that does not reset its sum at an expert boundary, a stale ring
    stage, and a 64-row slice of tgmm's sum dropped or added twice."""
    gen = torch.Generator().manual_seed(0)
    gs = torch.tensor([256, 0, 128, 384], dtype=torch.int32)  # one empty group, one of 128 rows
    Mk, Kk, Nk = 1024, 384, 192  # two trailing inactive blocks; six 64-deep slices
    lhs = torch.randn(Mk, Kk, generator=gen).bfloat16()
    lhs[int(gs.sum()):] = 0
    rhs = torch.randn(4, Kk, Nk, generator=gen).bfloat16()
    dout = torch.randn(Mk, Nk, generator=gen).bfloat16()
    blk_e, act = tgm.block_experts(gs, Mk // 128, 128)
    ratios = [tgm.error_ratio(_tiled_gmm(lhs, rhs, blk_e, act, fault), tgm.gmm_reference(lhs, rhs, gs)),
              tgm.error_ratio(_tiled_tgmm(lhs, dout, gs, fault), tgm.tgmm_reference(lhs, dout, gs))]
    assert (max(ratios) <= 1.0) == (fault == "none"), ratios
