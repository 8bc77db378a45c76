"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances are the module's own: O per element within
O_REL * |ref| + O_ABS_FRAC * max |ref| (`output_error_ratio` <= 1), LSE
within LSE_ATOL (fp32 on both sides); dq, dk, dv per element within
GRAD_REL * |ref| + GRAD_ABS_FRAC[name] * max |ref| (`grad_error_ratio` <= 1);
gmm and tgmm per element within REL * |ref| + ABS_FRAC * max |ref|
(`grouped_matmul.error_ratio` <= 1), with padding rows and empty experts
exactly 0. The fused-rotary variants are held to their plain versions by
the same rules, and with negated sin tables in the backward (the wrong
adjoint) they must fall outside them.
"""

import pytest
import torch

from contrastors_tpu_torch.ops import flash_attention as tfa
from contrastors_tpu_torch.ops import grouped_matmul as tgm
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,window", [
    (2, 200, 200, 4, 4, 64, False, 0),
    (2, 100, 300, 6, 2, 64, True, 0),
    (1, 700, 700, 2, 2, 128, False, 256),
    # one row; partial last tiles of a persistent walk (65, 129), with GQA
    # and at D = 128
    (2, 1, 1, 2, 2, 64, False, 0),
    (3, 65, 65, 4, 4, 64, False, 0),
    (2, 129, 129, 4, 2, 64, False, 0),
    (2, 129, 129, 2, 2, 128, False, 0),
    # B * H = 143 items: not a multiple of the 132 SMs
    (11, 96, 96, 13, 13, 64, False, 0),
    # GQA at the MLM length
    (1, 2048, 2048, 12, 4, 64, False, 0),
])
def test_kernel_matches_plain_version_on_card(cuda, B, S, T, H, Hkv, D, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=cuda).bfloat16() for _ in range(2))
    mask = torch.ones(B, T, dtype=torch.int32, device=cuda)
    mask[-1, T // 2:] = 0
    kw = dict(attention_mask=mask, causal=causal, window=window)
    before = tfa.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, **kw)
    assert tfa.output_error_ratio(out, ref_out) <= 1.0
    assert (lse - ref_lse).abs().max().item() <= tfa.LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,window", [
    (2, 200, 200, 4, 4, 64, False, 0),
    (2, 100, 300, 6, 2, 64, True, 0),
    (1, 700, 700, 2, 2, 128, False, 256),
    # one row; partial last tiles of a persistent walk (65, 129)
    (2, 1, 1, 2, 2, 64, False, 0),
    (3, 65, 65, 4, 4, 64, False, 0),
    (2, 129, 129, 4, 2, 64, False, 0),
    (2, 129, 129, 2, 2, 128, False, 0),
    # B * H = 143 items: not a multiple of the 132 SMs
    (11, 96, 96, 13, 13, 64, False, 0),
    (2, 200, 700, 4, 4, 64, True, 0),
    # GQA at the MLM length
    (1, 2048, 2048, 12, 4, 64, False, 0),
])
def test_backward_kernels_match_plain_version_on_card(cuda, B, S, T, H, Hkv, D, causal, window):
    """Autograd through the wrapper launches dq and dk/dv once each, with a
    strided dO, and matches the plain backward; the fully masked batch row
    gets dq = 0."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=cuda).bfloat16() for _ in range(2))
    mask = torch.ones(B, T, dtype=torch.int32, device=cuda)
    mask[-1, T // 2:] = 0
    if S == T:
        mask[0] = 0
    kw = dict(attention_mask=mask, causal=causal, window=window)
    dout = torch.randn(B, S, H, D + 8, generator=gen, device=cuda).bfloat16()[..., :D]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (tfa.launches_bwd_dq, tfa.launches_bwd_dkv)
    grads = torch.autograd.grad(tfa.flash_attention(*leaves, **kw), leaves, dout)
    torch.cuda.synchronize()
    assert (tfa.launches_bwd_dq, tfa.launches_bwd_dkv) == (before[0] + 1, before[1] + 1)
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)  # the O and LSE the backward saw
    refs = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
        assert tfa.grad_error_ratio(g, r, name) <= 1.0, name
    if S == T:
        assert bool((grads[0][0] == 0).all())


def _rotary_inputs(cuda, B, S, H, Hkv, D, rot_dim, interleaved, packed, seed=2):
    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin

    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=cuda).bfloat16() for _ in range(2))
    cos, sin = rotary_cos_sin(S, rot_dim, base=1000.0, device=cuda)
    kw = dict(rotary_cos=cos, rotary_sin=sin, rotary_interleaved=interleaved)
    if packed:  # three segments per row, positions restarting at each
        bounds = torch.tensor([0, S // 4, S // 2 + 7, S], device=cuda)
        idx = torch.arange(S, device=cuda)
        seg = torch.bucketize(idx, bounds[1:-1], right=True)
        kw["segment_ids"] = (seg + 1).int()[None].expand(B, S).contiguous()
        kw["rotary_position_ids"] = (idx - bounds[seg])[None].expand(B, S).contiguous()
    else:
        mask = torch.ones(B, S, dtype=torch.int32, device=cuda)
        mask[-1, S // 3:] = 0
        kw["attention_mask"] = mask
    dout = torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16()
    return q, k, v, dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,rot_dim,interleaved,packed", [
    (2, 256, 4, 4, 64, 64, False, False),
    (2, 300, 6, 2, 64, 32, True, False),
    (1, 512, 2, 2, 128, 128, False, True),
    (2, 129, 4, 4, 128, 128, False, False),
    (3, 65, 4, 4, 64, 64, True, False),
])
def test_fused_rotary_kernels_match_plain_versions_on_card(cuda, B, S, H, Hkv, D, rot_dim, interleaved,
                                                           packed):
    """The fused-rotary forward, dq and dk/dv kernels (one launch each,
    through autograd) against the fused plain versions; no unfused launch."""
    q, k, v, dout, kw = _rotary_inputs(cuda, B, S, H, Hkv, D, rot_dim, interleaved, packed)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counters = ("launches", "launches_bwd_dq", "launches_bwd_dkv",
                "launches_rot", "launches_bwd_dq_rot", "launches_bwd_dkv_rot")
    before = [getattr(tfa, c) for c in counters]
    out = tfa.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert [getattr(tfa, c) - b for c, b in zip(counters, before)] == [0, 0, 0, 1, 1, 1]
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, **kw)
    assert tfa.output_error_ratio(out, ref_out) <= 1.0
    _, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    assert (lse - ref_lse).abs().max().item() <= tfa.LSE_ATOL
    refs = tfa.flash_attention_backward_reference(q, k, v, out.detach(), lse, dout, **kw)
    for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
        assert tfa.grad_error_ratio(g, r, name) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_forward_kernel_is_deterministic(cuda, fused):
    """Each output row has one owner and sums in a fixed order: two runs on
    the same inputs give the same bits (O, LSE)."""
    q, k, v, _, kw = _rotary_inputs(cuda, 2, 300, 4, 2, 64, 64, False, False, seed=4)
    if not fused:
        kw = dict(attention_mask=kw["attention_mask"])
    first = tfa.flash_attention_fwd(q, k, v, **kw)
    second = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("O", "LSE")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_backward_kernels_are_deterministic(cuda, fused):
    """Each output tile has one owner and sums in a fixed order: two runs on
    the same inputs give the same bits (dq, dk, dv)."""
    q, k, v, dout, kw = _rotary_inputs(cuda, 2, 300, 4, 2, 64, 64, False, False, seed=3)
    if not fused:
        kw = dict(attention_mask=kw["attention_mask"])
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    first = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    second = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_fused_rotary_backward_rejects_the_wrong_adjoint(cuda):
    """The backward kernels given negated sin tables (the inverse rotation and
    the wrong adjoint) fall outside the rule for dq and dk; dv is unaffected
    by the adjoint but not by the recomputed rotation."""
    q, k, v, dout, kw = _rotary_inputs(cuda, 2, 256, 4, 4, 64, 64, False, False)
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    refs = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    bad = dict(kw, rotary_sin=-kw["rotary_sin"])
    grads = tfa.flash_attention_backward(q, k, v, out, lse, dout, **bad)
    for g, r, name in zip(grads[:2], refs[:2], ("dq", "dk")):
        assert tfa.grad_error_ratio(g, r, name) > 1.0, name


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 16, 2, 96, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin

    cos, sin = rotary_cos_sin(16, 24, device=cuda)  # rot_dim 24: not a multiple of 16
    with pytest.raises(ValueError, match="multiple of 16"):
        tfa.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), rotary_cos=cos, rotary_sin=sin)


def _moe_layout(cuda, A, E=8):
    """aligned_group_layout of A skewed assignments: expert 2 gets none,
    expert 5 exactly 128, so one group is empty, one needs no padding, and
    the last blocks are inactive."""
    gen = torch.Generator(device=cuda).manual_seed(A)
    p = torch.rand(E, generator=gen, device=cuda) ** 3 + 0.01
    p[2], p[5] = 0.0, 0.0
    flat_e = torch.multinomial(p, A - 128, replacement=True, generator=gen)
    flat_e = torch.cat([flat_e, torch.full((128,), 5, device=cuda)])
    flat_e = flat_e[torch.randperm(A, generator=gen, device=cuda)]
    src_of = torch.arange(A, device=cuda) // 2
    return tgm.aligned_group_layout(flat_e, E, 128, src_of=src_of, sentinel=A // 2)


def _assignments(cuda, layout, A, E=8):
    """The expert of each assignment for a named layout: all A on one
    expert, every expert exactly 128 rows, or 128 on one expert (a single
    128-row M)."""
    if layout == "one_expert":
        return torch.full((A,), 3, device=cuda)
    if layout == "all_128":
        gen = torch.Generator(device=cuda).manual_seed(A)
        flat_e = torch.arange(E, device=cuda).repeat_interleave(128)
        return flat_e[torch.randperm(E * 128, generator=gen, device=cuda)]
    return torch.full((128,), 6, device=cuda)  # single_block


@pytest.mark.cuda
@pytest.mark.parametrize("layout,K,N", [
    ("skewed", 768, 3072), ("skewed", 3072, 768), ("one_expert", 768, 3072), ("all_128", 768, 3072),
    ("single_block", 768, 3072), ("skewed", 768, 192), ("strided_lhs", 768, 3072),
])
def test_gmm_kernels_match_plain_versions_on_card(cuda, layout, K, N):
    """Autograd through gmm launches gmm once forward, then gmm (dlhs, on
    the transposed view) and tgmm once each; all three agree with the plain
    versions, padding rows of the output and the empty experts' drhs are 0.
    Layouts: skewed routing (an empty expert, one of exactly 128 rows,
    trailing inactive blocks), every assignment on one expert, every expert
    exactly 128 rows, a single 128-row M; N = 192 (a tile past the last 64
    columns); an lhs whose row stride exceeds K."""
    if layout in ("skewed", "strided_lhs"):
        dest, gs, P, src = _moe_layout(cuda, 2048)
        sentinel = 1024
    else:
        flat_e = _assignments(cuda, layout, 1000)
        A = flat_e.shape[0]
        sentinel = A
        _, gs, P, src = tgm.aligned_group_layout(flat_e, 8, 128, src_of=torch.arange(A, device=cuda),
                                                 sentinel=sentinel)
        if layout == "single_block":
            P = 128  # no worst-case padding: M is one block
            src = src[:P]
    gen = torch.Generator(device=cuda).manual_seed(1)
    pad = src == sentinel
    lhs = torch.randn(P, K, generator=gen, device=cuda).bfloat16().masked_fill(pad[:, None], 0)
    rhs = torch.randn(8, K, N, generator=gen, device=cuda).bfloat16()
    dout = torch.randn(P, N, generator=gen, device=cuda).bfloat16()
    if layout == "strided_lhs":  # the same values in rows of K + 64
        base = torch.zeros(P, K + 64, device=cuda).bfloat16()
        base[:, :K] = lhs
        lhs = base[:, :K]
    leaves = [lhs.detach().requires_grad_(), rhs.clone().requires_grad_()]
    before = (tgm.launches_gmm, tgm.launches_tgmm)
    out = tgm.gmm(*leaves, gs)
    dlhs, drhs = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (tgm.launches_gmm, tgm.launches_tgmm) == (before[0] + 2, before[1] + 1)
    assert tgm.error_ratio(out, tgm.gmm_reference(lhs, rhs, gs)) <= 1.0
    assert tgm.error_ratio(dlhs, tgm.gmm_reference(dout, rhs.transpose(1, 2), gs)) <= 1.0
    assert tgm.error_ratio(drhs, tgm.tgmm_reference(lhs, dout, gs)) <= 1.0
    assert bool((out[pad] == 0).all()) and bool((dlhs[int(gs.sum()):] == 0).all())  # inactive blocks
    assert all(bool((drhs[e] == 0).all()) for e in range(8) if int(gs[e]) == 0)


@pytest.mark.cuda
def test_gmm_kernel_refuses_what_it_does_not_take(cuda):
    lhs = torch.randn(256, 96, device=cuda).bfloat16()
    rhs = torch.randn(2, 96, 128, device=cuda).bfloat16()
    gs = torch.tensor([128, 0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 64"):
        tgm.gmm(lhs, rhs, gs)
    with pytest.raises(TypeError, match="bfloat16"):
        tgm.gmm(lhs.float()[:, :64], rhs.float()[:, :64], gs)
