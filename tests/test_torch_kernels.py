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
adjoint) they must fall outside them. The generic kernels (fp32, and bf16
at other head dims and widths) are held to the plain versions in fp32 by
max |out - ref| <= FP32_REL * max |ref| (`max_rel_error`), in bf16 by the
rules above.
"""

import json
import subprocess
import sys
from pathlib import Path

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
    """What no flash kernel takes raises: a head dim that is not a multiple
    of 8, fp16. A head dim above 256 runs on the wide kernels and agrees
    with the plain version; what only the generic kernels take (bf16 at D =
    96, fp32, a rotary dim of 24) runs there and agrees with the plain
    version."""
    q = torch.randn(1, 16, 2, 264, device=cuda).bfloat16()
    before = tfa.launches_wide
    out = tfa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert tfa.launches_wide == before + 1
    assert tfa.output_error_ratio(out, tfa.flash_attention_reference(q, q, q)[0]) <= 1.0
    q = torch.randn(1, 16, 2, 20, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 2, 64, device=cuda).half()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q, q, q)
    from contrastors_tpu_torch.layers.rotary import rotary_cos_sin

    cos, sin = rotary_cos_sin(16, 24, device=cuda)  # rot_dim 24: not a multiple of 16
    for q, kw in ((torch.randn(1, 16, 2, 96, device=cuda).bfloat16(), {}),
                  (torch.randn(1, 16, 2, 64, device=cuda), {}),
                  (torch.randn(1, 16, 2, 64, device=cuda).bfloat16(), dict(rotary_cos=cos, rotary_sin=sin))):
        before = tfa.launches_generic
        out = tfa.flash_attention(q, q, q, **kw)
        torch.cuda.synchronize()
        assert tfa.launches_generic == before + 1
        ref, _ = tfa.flash_attention_reference(q, q, q, **kw)
        if q.dtype == torch.float32:
            assert tfa.max_rel_error(out, ref) <= tfa.FP32_REL
        else:
            assert tfa.output_error_ratio(out, ref) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("fp32", 64), ("fp32", 80), ("fp32", 256), ("bf16", 88), ("bf16", 256)])
@pytest.mark.parametrize("variant", ["pad", "causal", "segments", "gqa", "rotary"])
def test_generic_kernels_match_plain_versions_on_card(cuda, dtype, D, variant):
    """The generic forward, dq and dk/dv (csrc/flash_generic.cu, fp32:
    csrc/flash_tf32.cu) against the plain versions: fp32 (the three in 3xTF32
    on the tensor cores) within FP32_REL * max |ref| (LSE within
    FP32_LSE_ATOL), bf16 (the three on the tensor cores) at the Hopper
    kernels' error model."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    B, S, H = 2, 200, 4
    T = 300 if variant == "causal" else S
    Hkv = 1 if variant == "gqa" else H
    q, dout = (torch.randn(B, S, H, D, generator=gen, device=cuda).to(dt) for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=cuda).to(dt) for _ in range(2))
    kw = dict(causal=variant == "causal")
    if variant in ("pad", "gqa", "rotary"):
        kw["attention_mask"] = (torch.arange(T, device=cuda)[None] < torch.tensor([[T], [77]], device=cuda)).int()
    if variant == "segments":
        kw["segment_ids"] = (torch.arange(S, device=cuda)[None].expand(B, S) // 70 + 1).int() % 3
    if variant == "rotary":
        from contrastors_tpu_torch.layers.rotary import rotary_cos_sin

        kw["rotary_cos"], kw["rotary_sin"] = rotary_cos_sin(S, D // 4 // 2 * 2, device=cuda)
    before = (tfa.launches_generic, tfa.launches_generic_dq, tfa.launches_generic_dkv)
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    grads = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (tfa.launches_generic, tfa.launches_generic_dq, tfa.launches_generic_dkv) == tuple(b + 1 for b in before)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, **kw)
    refs = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    if dt == torch.float32:
        assert tfa.max_rel_error(out, ref) <= tfa.FP32_REL
        assert (lse - ref_lse).abs().max().item() <= tfa.FP32_LSE_ATOL
        for g, r in zip(grads, refs):
            assert tfa.max_rel_error(g, r) <= tfa.FP32_REL
    else:
        assert tfa.output_error_ratio(out, ref) <= 1.0
        assert (lse - ref_lse).abs().max().item() <= tfa.LSE_ATOL
        for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
            assert tfa.grad_error_ratio(g, r, name) <= 1.0, name


def _misaligned(x):
    """x's values in contiguous storage whose base is 2 bytes past a 16-byte
    boundary: no TMA map and no 16-byte copy takes it, so it routes to the
    generic kernels, which stage its rows through registers."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = flat[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


# head dims of the bf16 tensor-core forward and dk/dv: "u" misaligned
# operands (the only way D 64 / 128 reach them without rotary)
TC_HEAD_DIMS = ("64u", 80, 88, 96, "128u", 200, 256)
TC_VARIANTS = ("pad", "causal", "window128", "segments", "gqa", "rotary_halves", "rotary_pairs")


def _tensor_core_case(cuda, dtype, head_dim, variant):
    """q, k, v, dO and the entry points' keyword arguments of one case of
    the tensor-core kernels' tests (B 3, S 200, H 8): a padding mask with an
    empty batch row, causal with S=200 against T=300 (offset 100), window
    128 with a padding mask, three segments then padding, GQA (H 8, Hkv 2),
    rotary as NeoX halves and as GPT-J pairs (rotary dim 8 at D = 128; else
    a quarter of D, rounded to even) or NeoX over the whole head dim
    (rotary_full), or only dO misaligned; a head dim ending in "u" makes
    every operand misaligned."""
    D = int(str(head_dim).rstrip("u"))
    gen = torch.Generator(device=cuda).manual_seed(D + len(variant))
    B, S, H = 3, 200, 8
    T = 300 if variant == "causal" else S
    Hkv = 2 if variant == "gqa" else H
    q, dout = (torch.randn(B, S, H, D, generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=cuda).to(dtype) for _ in range(2))
    if str(head_dim).endswith("u"):
        q, k, v, dout = (_misaligned(x) for x in (q, k, v, dout))
    if variant == "dout_misaligned":
        dout = _misaligned(dout)
    kw = dict(causal=variant == "causal", window=128 if variant == "window128" else 0)
    if variant in ("pad", "window128", "gqa", "rotary_halves", "rotary_pairs", "rotary_full"):
        lens = torch.tensor([T, T // 2 + 3, 0 if variant == "pad" else 17], device=cuda)
        kw["attention_mask"] = (torch.arange(T, device=cuda)[None] < lens[:, None]).int()
    if variant == "segments":
        seg = torch.zeros(B, S, dtype=torch.int32, device=cuda)
        seg[:, :70], seg[:, 70:140], seg[:, 140:180] = 1, 2, 3
        kw["segment_ids"] = seg
    if variant.startswith("rotary"):
        from contrastors_tpu_torch.layers.rotary import rotary_cos_sin

        rot_dim = D if variant == "rotary_full" else 8 if D == 128 else max(2, D // 4 // 2 * 2)
        kw["rotary_cos"], kw["rotary_sin"] = rotary_cos_sin(S, rot_dim, device=cuda)
        kw["rotary_interleaved"] = variant == "rotary_pairs"
    return q, k, v, dout, kw


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,variant", [(d, v) for d in TC_HEAD_DIMS for v in TC_VARIANTS]
                         + [("128", "rotary_halves"), ("128", "rotary_pairs")]
                         + [(d, v) for d in (80, 256) for v in ("dout_misaligned", "out_misaligned")])
def test_bf16_tensor_core_kernels_match_plain_versions_on_card(cuda, head_dim, variant):
    """The bf16 forward, dq and dk/dv on the tensor cores against the plain
    versions at the Hopper kernels' error model (`output_error_ratio`,
    `grad_error_ratio` <= 1, the LSE within LSE_ATOL), routed to the generic
    kernels, and bit-identical on a second run. Variants: a padding mask with
    an empty batch row, causal with S=200 against T=300 (offset 100), window
    128 with a padding mask, three segments then padding, GQA (H 8, Hkv 2),
    rotary as NeoX halves and as GPT-J pairs (rotary dim 8 at D = 128,
    aligned: only the generic kernels take it; else a quarter of D, rounded
    to even), and aligned q, k, v with only the backward's dO, or only its O,
    misaligned (dq then stages every tile through registers)."""
    q, k, v, dout, kw = _tensor_core_case(cuda, torch.bfloat16, head_dim, variant)
    counters = ("launches_generic", "launches_generic_dq", "launches_generic_dkv")
    before = [getattr(tfa, c) for c in counters]
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    again = tfa.flash_attention_fwd(q, k, v, **kw)
    if variant == "out_misaligned":
        out = _misaligned(out)
    grads = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    grads_again = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert [getattr(tfa, c) - b for c, b in zip(counters, before)] == [2, 2, 2]
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, **kw)
    refs = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    assert tfa.output_error_ratio(out, ref) <= 1.0
    assert (lse - ref_lse).abs().max().item() <= tfa.LSE_ATOL
    for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
        assert tfa.grad_error_ratio(g, r, name) <= 1.0, name
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for a, b, name in zip(grads, grads_again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name
    if variant == "pad":
        assert bool((out[-1] == 0).all()) and bool((grads[0][-1] == 0).all())


# head dims of the fp32 tensor-core (3xTF32) kernels: "u" misaligned operands
# (staged through registers instead of copied by cp.async)
TF32_HEAD_DIMS = ("64", "64u", 80, 88, 128, 200, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,variant", [(d, v) for d in TF32_HEAD_DIMS for v in TC_VARIANTS])
def test_fp32_tensor_core_forward_matches_plain_version_on_card(cuda, head_dim, variant):
    """The fp32 forward on the tensor cores in 3xTF32 (csrc/flash_tf32.cu:
    fwd_tf32_kernel), routed to the generic kernels, against the plain
    version: O within FP32_REL * max |ref|, the LSE within FP32_LSE_ATOL, at
    D 64 (aligned and misaligned), 80, 88, 128, 200 and 256 in the variants
    of `_tensor_core_case`; the padding mask's empty batch row has O exactly
    0 and LSE -1e30; a second run is bit-identical."""
    q, k, v, _, kw = _tensor_core_case(cuda, torch.float32, head_dim, variant)
    before = tfa.launches_generic
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    again = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches_generic == before + 2
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, **kw)
    assert tfa.max_rel_error(out, ref) <= tfa.FP32_REL
    assert (lse - ref_lse).abs().max().item() <= tfa.FP32_LSE_ATOL
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if variant == "pad":
        assert bool((out[-1] == 0).all()) and bool((lse[-1] == tfa.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,variant", [(d, v) for d in TF32_HEAD_DIMS for v in TC_VARIANTS]
                         + [(d, v) for d in (80, 256) for v in ("dout_misaligned", "out_misaligned")])
def test_fp32_tensor_core_backward_matches_plain_version_on_card(cuda, head_dim, variant):
    """The fp32 dq and dk/dv on the tensor cores in 3xTF32 (csrc/flash_tf32.cu:
    dq_tf32_kernel, dkv_tf32_kernel), routed to the generic kernels, against
    the plain version: dq, dk and dv within FP32_REL * max |ref|, at D 64
    (aligned and misaligned), 80, 88, 128, 200 and 256 in the variants of
    `_tensor_core_case`, and at D 80 and 256 with only dO, or only O,
    misaligned (their tiles then staged through registers); the padding
    mask's empty batch row has dq, dk and dv exactly 0; a second run is
    bit-identical."""
    q, k, v, dout, kw = _tensor_core_case(cuda, torch.float32, head_dim, variant)
    counters = ("launches_generic_dq", "launches_generic_dkv")
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    if variant == "out_misaligned":
        out = _misaligned(out)
    before = [getattr(tfa, c) for c in counters]
    grads = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    grads_again = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert [getattr(tfa, c) - b for c, b in zip(counters, before)] == [2, 2]
    refs = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
        assert tfa.max_rel_error(g, r) <= tfa.FP32_REL, name
    for a, b, name in zip(grads, grads_again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name
    if variant == "pad":
        assert all(bool((g[-1] == 0).all()) for g in grads)


# the wide kernels (D > 256): every head dim splits its output into column
# slices; the forward streams the products over D in 64-column chunks, the
# dq and dk/dv run in clusters of ceil(D / 128) slice blocks up to D 1024
# (264: slices of 88, a partial 16-column step), and past that reach (1032)
# the dq and dk/dv stream their products over D as the forward does; "512u"
# misaligned operands
WIDE_HEAD_DIMS = (264, 320, 512, 1024, 1032)
WIDE_VARIANTS = TC_VARIANTS + ("rotary_full",)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim,variant", [(t, d, v) for t in ("fp32", "bf16") for d in WIDE_HEAD_DIMS
                                                    for v in WIDE_VARIANTS]
                         + [(t, "512u", v) for t in ("fp32", "bf16") for v in ("pad", "causal", "rotary_halves")])
def test_wide_kernels_match_plain_versions_on_card(cuda, dtype, head_dim, variant):
    """The wide forward, dq and dk/dv (csrc/flash_wide.cu) against the plain
    versions at D 264, 320, 512, 1024 and 1032 in the variants of
    `_tensor_core_case` and NeoX rotary over the whole head dim (whose
    adjoint pairs columns of two slice blocks), and at D 512 on misaligned
    operands: fp32 within FP32_REL * max |ref| (the LSE within
    FP32_LSE_ATOL), bf16 at the Hopper kernels' error model. Every launch
    lands on the wide counters (the rotary adjoint pass once for dq and once
    for dk a backward) and none on the generic ones; a second run is
    bit-identical; the padding mask's empty batch row has O and dq exactly
    0."""
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    q, k, v, dout, kw = _tensor_core_case(cuda, dt, head_dim, variant)
    counters = ("launches_wide", "launches_wide_dq", "launches_wide_dkv", "launches_wide_adjoint",
                "launches_generic", "launches_generic_dq", "launches_generic_dkv")
    before = [getattr(tfa, c) for c in counters]
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    again = tfa.flash_attention_fwd(q, k, v, **kw)
    grads = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    grads_again = tfa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    adjoint = 4 if "rotary_cos" in kw else 0
    assert [getattr(tfa, c) - b for c, b in zip(counters, before)] == [2, 2, 2, adjoint, 0, 0, 0]
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, **kw)
    refs = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    if dt == torch.float32:
        assert tfa.max_rel_error(out, ref) <= tfa.FP32_REL
        assert (lse - ref_lse).abs().max().item() <= tfa.FP32_LSE_ATOL
        for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
            assert tfa.max_rel_error(g, r) <= tfa.FP32_REL, name
    else:
        assert tfa.output_error_ratio(out, ref) <= 1.0
        assert (lse - ref_lse).abs().max().item() <= tfa.LSE_ATOL
        for g, r, name in zip(grads, refs, ("dq", "dk", "dv")):
            assert tfa.grad_error_ratio(g, r, name) <= 1.0, name
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for a, b, name in zip(grads, grads_again, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name
    if variant == "pad":
        assert bool((out[-1] == 0).all()) and bool((grads[0][-1] == 0).all())


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


# gmm forward and its autograd backward through the Hopper route
# (csrc/gmm.cu), in a process that has made no other CUDA call: the
# backward's dlhs is then the first CUDA call of autograd's device thread
_FRESH_PROCESS_GMM = r"""
import json
import sys

sys.path.insert(0, sys.argv[1])
import torch

from contrastors_tpu_torch.ops import grouped_matmul as tgm

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
p = torch.rand(8, generator=gen, device=dev) ** 3 + 0.01
flat_e = torch.multinomial(p, 2048, replacement=True, generator=gen)
_, gs, P, src = tgm.aligned_group_layout(flat_e, 8, 128, src_of=torch.arange(2048, device=dev), sentinel=2048)
pad = src == 2048
lhs = torch.randn(P, 768, generator=gen, device=dev).bfloat16().masked_fill(pad[:, None], 0)
rhs = torch.randn(8, 768, 3072, generator=gen, device=dev).bfloat16()
dout = torch.randn(P, 3072, generator=gen, device=dev).bfloat16()
route = tgm.grouped_matmul_route(lhs, rhs), tgm.grouped_matmul_route(dout, rhs.transpose(1, 2))
leaves = [lhs.detach().requires_grad_(), rhs.detach().requires_grad_()]
out = tgm.gmm(*leaves, gs)
dlhs, drhs = torch.autograd.grad(out, leaves, dout)
torch.cuda.synchronize()
print(json.dumps(dict(
    route=route, launches=[tgm.launches_gmm, tgm.launches_tgmm],
    gmm=tgm.error_ratio(out, tgm.gmm_reference(lhs, rhs, gs)),
    dlhs=tgm.error_ratio(dlhs, tgm.gmm_reference(dout, rhs.transpose(1, 2), gs)),
    tgmm=tgm.error_ratio(drhs, tgm.tgmm_reference(lhs, dout, gs)))))
"""


@pytest.mark.cuda
def test_hopper_gmm_backward_runs_in_a_fresh_process_on_card(cuda):
    """gmm forward and its autograd backward (dlhs on the transposed view,
    and tgmm) through the Hopper kernels in a fresh process that imports only
    the port: the dlhs launch is the first CUDA call on autograd's device
    thread, where no context is current until `hopper_common.cuh:
    bind_context` binds one (without it the tensor-map encode fails, CUDA
    error 1). The process exits 0, launches gmm twice and tgmm once, and
    each result is within the plain version's rule (`error_ratio` <= 1)."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _FRESH_PROCESS_GMM, str(root)], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["route"] == ["hopper", "hopper"] and got["launches"] == [2, 1]
    for name in ("gmm", "dlhs", "tgmm"):
        assert got[name] <= 1.0, name


def _fp32_gmm_layout(cuda, layout, block_m, E=8):
    """(group_sizes, P, padding rows) of a block_m-aligned layout: skewed
    routing of 2048 assignments (expert 2 empty, expert 5 exactly block_m
    rows, trailing inactive blocks), 1000 on one expert, or every expert
    exactly 128 rows."""
    gen = torch.Generator(device=cuda).manual_seed(block_m)
    if layout == "one_expert":
        flat_e = torch.full((1000,), 3, device=cuda)
    elif layout == "all_128":
        flat_e = torch.arange(E, device=cuda).repeat_interleave(128)
        flat_e = flat_e[torch.randperm(E * 128, generator=gen, device=cuda)]
    else:
        p = torch.rand(E, generator=gen, device=cuda) ** 3 + 0.01
        p[2], p[5] = 0.0, 0.0
        flat_e = torch.cat([torch.multinomial(p, 2048 - block_m, replacement=True, generator=gen),
                            torch.full((block_m,), 5, device=cuda)])
        flat_e = flat_e[torch.randperm(2048, generator=gen, device=cuda)]
    A = flat_e.shape[0]
    _, gs, P, src = tgm.aligned_group_layout(flat_e, E, block_m, src_of=torch.arange(A, device=cuda), sentinel=A)
    return gs, P, src == A


@pytest.mark.cuda
@pytest.mark.parametrize("layout,K,N,block_m", [
    ("skewed", 768, 3072, 128), ("skewed", 3072, 768, 128), ("skewed", 200, 360, 128), ("skewed", 768, 192, 128),
    ("skewed", 198, 366, 128), ("one_expert", 768, 3072, 128), ("all_128", 768, 3072, 128),
    ("strided_lhs", 768, 3072, 128), ("misaligned", 200, 360, 128), ("skewed", 768, 3072, 64),
    ("skewed", 200, 360, 64), ("strided_lhs", 200, 360, 64), ("one_expert", 3072, 768, 64),
])
def test_fp32_gmm_kernels_match_plain_versions_on_card(cuda, layout, K, N, block_m):
    """fp32 autograd through the public gmm launches the generic gmm
    (csrc/gmm_generic.cu: gmm_kernel, 128- or 64-row tiles) forward and for
    dlhs (on the rhs.transpose(1, 2) view, or its copy where that view is
    not aligned), and tgmm (tgmm_kernel: 128 x 128 tiles, the experts
    largest first) once; each
    within FP32_REL * max |ref| of its plain version, padding rows of the
    output and dlhs, and an empty expert's drhs, exactly 0; a second run
    bit-identical. Widths: the MoE layer's both ways, K 200 / N 360, N 192
    (a tile past the last 64 columns), K 198 / N 366 (not multiples of 4);
    block_m 128 (128-row tiles) and 64 (64-row tiles); an lhs whose row
    stride exceeds K, and operands 4 bytes past a 16-byte boundary (no
    vector load takes them)."""
    gs, P, pad = _fp32_gmm_layout(cuda, "skewed" if layout in ("strided_lhs", "misaligned") else layout, block_m)
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    lhs = torch.randn(P, K, generator=gen, device=cuda).masked_fill(pad[:, None], 0)
    rhs = torch.randn(8, K, N, generator=gen, device=cuda)
    dout = torch.randn(P, N, generator=gen, device=cuda).masked_fill(pad[:, None], 0)
    if layout == "strided_lhs":  # the same values in rows of K + 64
        base = torch.zeros(P, K + 64, device=cuda)
        base[:, :K] = lhs
        lhs = base[:, :K]
    if layout == "misaligned":
        lhs, rhs, dout = (_misaligned(x) for x in (lhs, rhs, dout))

    def run():
        leaves = [lhs.detach().requires_grad_(), rhs.detach().requires_grad_()]
        out = tgm.gmm(*leaves, gs, block_m=block_m)
        return (out, *torch.autograd.grad(out, leaves, dout))

    before = (tgm.launches_gmm_generic, tgm.launches_tgmm_generic)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert (tgm.launches_gmm_generic - before[0], tgm.launches_tgmm_generic - before[1]) == (4, 2)
    refs = (tgm.gmm_reference(lhs, rhs, gs, block_m), tgm.gmm_reference(dout, rhs.transpose(1, 2), gs, block_m),
            tgm.tgmm_reference(lhs, dout, gs, block_m))
    for g, r, name in zip(got, refs, ("gmm", "dlhs", "tgmm")):
        assert tgm.max_rel_error(g, r) <= tgm.FP32_REL, name
    out, dlhs, drhs = got
    assert bool((out[pad] == 0).all()) and bool((dlhs[int(gs.sum()):] == 0).all())
    assert all(bool((drhs[e] == 0).all()) for e in range(8) if int(gs[e]) == 0)
    for a, b, name in zip(got, again, ("gmm", "dlhs", "tgmm")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_gmm_kernel_refuses_what_it_does_not_take(cuda):
    """What no grouped-matmul kernel takes raises (fp16, mixed dtypes, a
    block_m that is not a multiple of 64); what only the generic kernels take
    (K = 96, fp32) runs there and agrees with the plain version."""
    lhs = torch.randn(256, 96, device=cuda).bfloat16()
    rhs = torch.randn(2, 96, 128, device=cuda).bfloat16()
    gs = torch.tensor([128, 0], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgm.gmm(lhs.half(), rhs.half(), gs)
    with pytest.raises(TypeError, match="one dtype"):
        tgm.gmm(lhs.float(), rhs, gs)
    with pytest.raises(ValueError, match="block_m"):
        tgm.gmm(lhs[:192], rhs, torch.tensor([96, 0], dtype=torch.int32, device=cuda), block_m=96)
    for a, b in ((lhs, rhs), (lhs.float(), rhs.float())):
        before = tgm.launches_gmm_generic
        out = tgm.gmm(a, b, gs)
        torch.cuda.synchronize()
        assert tgm.launches_gmm_generic == before + 1
        ref = tgm.gmm_reference(a, b, gs)
        if a.dtype == torch.float32:
            assert tgm.max_rel_error(out, ref) <= tgm.FP32_REL
        else:
            assert tgm.error_ratio(out, ref) <= 1.0
