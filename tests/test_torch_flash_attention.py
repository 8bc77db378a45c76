"""The port's flash-attention forward against the JAX Pallas forward.

The plain PyTorch version (`flash_attention_reference`, which the wrapper
runs on CPU tensors) is held to JAX `flash_attention` and `_fwd` (the Pallas
kernels in interpret mode) in fp32: O atol 1e-5, base-2 LSE atol 1e-4. The
CUDA kernel itself is held to the plain version in test_torch_kernels.py
(marked `cuda`, skipped without a card) and by chip_smoke.py.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastors_tpu.ops import flash_attention as jfa
from contrastors_tpu_torch.ops import attention_core
from contrastors_tpu_torch.ops import flash_attention as tfa

O_ATOL, LSE_ATOL = 1e-5, 1e-4


def _jax_lse(q, k, v, attention_mask, segment_ids, kv_segment_ids, causal, window, block=128):
    """Base-2 LSE [B, H, S] from the JAX `_fwd` kernel, with the segment
    merge and block padding of the JAX wrapper (`flash_attention.py:841-874`)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    masked = attention_mask is not None or segment_ids is not None
    if segment_ids is not None:
        seg_q = segment_ids.astype(np.int32)
        seg_kv = (kv_segment_ids if kv_segment_ids is not None else segment_ids).astype(np.int32)
        if attention_mask is not None:
            seg_kv = seg_kv * attention_mask.astype(np.int32)
    elif attention_mask is not None:
        seg_kv = attention_mask.astype(np.int32)
        seg_q = np.ones((B, S), np.int32) if S != T else seg_kv
    else:
        seg_q, seg_kv = np.ones((B, S), np.int32), np.ones((B, T), np.int32)
        masked = S % block != 0 or T % block != 0
    S_pad, T_pad = -(-S // block) * block, -(-T // block) * block
    pad = lambda x, n: np.pad(x, [(0, 0), (0, n - x.shape[1])] + [(0, 0)] * (x.ndim - 2))  # noqa: E731
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    _, lse = jfa._fwd(
        tr(pad(q, S_pad)), tr(pad(k, T_pad)), tr(pad(v, T_pad)),
        jnp.asarray(pad(seg_q, S_pad))[:, None], jnp.asarray(pad(seg_kv, T_pad))[:, None],
        None, causal, (T - S) if causal else 0, 1.0 / D**0.5, block, block, masked, window,
    )
    return np.asarray(lse)[:, :, 0, :S]


# the edges of the kernels' persistent walk (chip_smoke.EDGE_CASES) at CPU
# size: one row, partial last tiles with GQA and at D = 128, B * H = 143
# items, GQA at the MLM length; each with a random key length per batch row
EDGES = {
    "s1": dict(S=1),
    "s65": dict(S=65),
    "s129_gqa": dict(S=129, Hkv=2),
    "d128_s129": dict(S=129, D=128),
    "bh143_s96": dict(B=11, S=96, H=13, Hkv=13),
    "gqa_s2048": dict(B=1, S=2048, H=2, Hkv=1),
}


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, S, T, H, Hkv, D = 2, 128, 128, 4, 4, 64
    kw = dict(attention_mask=None, segment_ids=None, kv_segment_ids=None, causal=False, window=0)
    if name in EDGES:
        e = dict(dict(B=B, H=H, Hkv=Hkv, D=D), **EDGES[name])
        B, H, Hkv, D = e["B"], e["H"], e["Hkv"], e["D"]
        S = T = e["S"]
        lengths = rng.integers(1, T + 1, size=B)
        lengths[0] = T
        kw["attention_mask"] = (np.arange(T)[None] < lengths[:, None]).astype(np.int32)
    if name == "unaligned":
        S = T = 200
    if name == "causal_s_ne_t":
        S, T = 64, 192
        kw["causal"] = True
    if name == "gqa":
        Hkv = 2
    if name == "window":
        kw["window"] = 32
    if name in ("padding", "fully_masked_row"):
        lengths = np.array([T, 70])
        kw["attention_mask"] = (np.arange(T)[None] < lengths[:, None]).astype(np.int32)
    if name == "fully_masked_row":
        kw["attention_mask"][1] = 0
    if name == "segments":
        seg = np.zeros((B, S), np.int32)
        seg[0, :50], seg[0, 50:100], seg[1, :] = 1, 2, 1
        kw["segment_ids"] = seg
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    return q, k, v, kw


CASES = ["padding", "segments", "causal_s_ne_t", "window", "gqa", "unaligned", "fully_masked_row", *EDGES]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_jax_pallas_forward(name, monkeypatch):
    monkeypatch.setenv("CONTRASTORS_TPU_FLASH_INTERPRET", "1")
    q, k, v, kw = _case(name)
    j_out = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()},
        block_q=128, block_kv=128,
    ))
    j_lse = _jax_lse(q, k, v, **kw)
    t_kw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    t_out, t_lse = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **t_kw
    )
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, atol=LSE_ATOL, rtol=0)
    # the wrapper on a CPU tensor is the plain version, bit for bit
    w_out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **t_kw)
    assert torch.equal(w_out, t_out)
    if name == "fully_masked_row":
        assert np.all(t_out.numpy()[1] == 0.0)
        assert np.all(t_lse.numpy()[1] == np.float32(tfa.NEG_INF))


def _tiled_forward(q, k, v, seg, fault, tile=tfa.KERNEL_TILE):
    """The kernel's arithmetic in plain torch (bf16 inputs, fp32 online softmax
    over the kernel's kv tiles, pairs across segments at -1e30, p cast to
    bf16), optionally with one fault."""
    c = tfa.LOG2E / q.shape[-1] ** 0.5
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    valid = ((seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, None, :] != 0))
    vt = v.float().transpose(1, 2)
    B, H, S, T = s.shape
    m = torch.full((B, H, S, 1), -1e20)
    l, acc = torch.zeros_like(m), torch.zeros(B, H, S, q.shape[-1])
    for j in range(0, T - tile if fault == "drop_last_tile" else T, tile):
        sj = s[..., j:j + tile]
        mixed = bool((seg[:, j:j + tile] != seg[:, j:j + 1]).any())  # the tile's keys span two segments
        if not (fault == "branch_free_on_mixed_tile" and mixed):
            sj = sj.masked_fill(~valid[..., j:j + tile], tfa.NEG_INF)
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(sj * c - m_new * c)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc if fault == "no_rescale" else acc * corr
        acc = acc + p.bfloat16().float() @ vt[:, :, j:j + tile]
        m = m_new
    return (acc / l).bfloat16().transpose(1, 2)


@pytest.mark.parametrize("fault", ["none", "no_rescale", "drop_last_tile", "branch_free_on_mixed_tile"])
@pytest.mark.parametrize("S", [200, 1024])
def test_kernel_tolerance_rejects_online_softmax_faults(fault, S):
    """The rule that holds the card's kernel to its plain version
    (`output_error_ratio` <= 1) accepts the tiled arithmetic and rejects it
    with the accumulator's rescale left out, the last kv tile dropped, or the
    branch-free (unmasked) softmax taken on a tile whose keys span two
    segments, at |O| ~ sqrt(e / T), far below any fixed absolute tolerance.
    Two segments split the row off a tile boundary (at 0.4 S + 3)."""
    gen = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(1, S, 2, 64, generator=gen).bfloat16() for _ in range(3))
    seg = (torch.arange(S) >= int(0.4 * S) + 3).int()[None] + 1
    ref, _ = tfa.flash_attention_reference(q, k, v, segment_ids=seg)
    ratio = tfa.output_error_ratio(_tiled_forward(q, k, v, seg, fault), ref)
    assert (ratio <= 1.0) == (fault == "none"), ratio


def test_padded_query_rows_are_zero_and_sdpa_agrees_on_valid_rows():
    """With a mask only and S == T, padded query rows output 0 on the flash
    kernel's path (impl="flash_always", and impl="flash" at kv lengths of
    JAX's flash_min_seq and above); the SDPA path lets them attend, and so
    does impl="flash" below that length, as JAX's dispatch runs SDPA there.
    Valid rows agree."""
    q, k, v, kw = _case("padding")
    q, k, v = map(torch.from_numpy, (q, k, v))
    mask = torch.from_numpy(kw["attention_mask"])
    flash = attention_core(q, k, v, impl="flash_always", attention_mask=mask)
    plain = attention_core(q, k, v, impl="sdpa", attention_mask=mask)
    valid = mask.bool()[:, :, None, None]
    torch.testing.assert_close(flash * valid, plain * valid, atol=O_ATOL, rtol=0)
    assert torch.all(flash[1, 70:] == 0) and not torch.all(plain[1, 70:] == 0)
    short = attention_core(q, k, v, impl="flash", attention_mask=mask)  # T = 128 < 512
    torch.testing.assert_close(short, plain, atol=O_ATOL, rtol=0)


def test_flash_wrapper_rejects_fused_rotary_and_backward():
    """Fused rotary runs: on CPU tensors it is the plain version of the
    fused kernels, equal to rotating outside and calling the plain flash:
    bit for bit forward, and within 1e-6 backward in fp32 (the adjoint does
    autograd's operations on the rotation; the three uses of q are summed in
    another order). It rejects packed position_ids with S != T. The backward runs (the plain backward on CPU
    tensors) and gives what `flash_attention_backward_reference` gives, the
    gradient of q summed over its three uses."""
    from contrastors_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin

    cos, sin = rotary_cos_sin(16, 32, device="cpu")
    x = torch.randn(1, 16, 2, 64)
    leaves = [x.clone().requires_grad_() for _ in range(2)]
    fused = tfa.flash_attention(leaves[0], leaves[0], leaves[0], rotary_cos=cos, rotary_sin=sin)
    xr = apply_rotary(leaves[1], cos, sin)
    outside = tfa.flash_attention(xr, apply_rotary(leaves[1], cos, sin), leaves[1])
    assert torch.equal(fused, outside)
    fused.sum().backward()
    outside.sum().backward()
    torch.testing.assert_close(leaves[0].grad, leaves[1].grad, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="rotary_position_ids"):
        tfa.flash_attention(x[:, :8], x, x, rotary_cos=cos, rotary_sin=sin,
                            rotary_position_ids=torch.arange(8)[None])
    q = torch.randn(1, 16, 2, 64, requires_grad=True)
    out = tfa.flash_attention(q, q, q)
    out.sum().backward()
    with torch.no_grad():
        o, lse = tfa.flash_attention_reference(q, q, q)
        dq, dk, dv = tfa.flash_attention_backward_reference(q, q, q, o, lse, torch.ones_like(o))
    torch.testing.assert_close(q.grad, dq + dk + dv, atol=1e-6, rtol=0)


@pytest.mark.parametrize("Hkv,rotary", [(4, False), (2, False), (4, True)])
def test_fully_masked_batch_row_below_512_matches_jax(Hkv, rotary):
    """attention_core(impl="flash") with a mask only at kv < 512, where JAX
    runs SDPA: a batch row with no valid key comes out as mean(v) over all T
    keys (uniform softmax), and its gradients are those of that softmax,
    dq and dk nonzero; output and q/k/v gradients against JAX's
    attention_core in fp32, atol 1e-5 (GQA: Hkv = 2; rotary: NeoX tables
    over the whole head, applied to q and k on both sides)."""
    import jax

    from contrastors_tpu.ops import attention_core as j_attention_core

    rng = np.random.default_rng(7)
    B, S, H, D = 3, 40, 4, 64
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    mask = (np.arange(S)[None] < np.array([S, 23, 0])[:, None]).astype(np.int32)
    rot = {}
    if rotary:
        angles = np.outer(np.arange(S), 1.0 / 10000 ** (np.arange(0, D, 2) / D)).astype(np.float32)
        rot = dict(rotary_cos=np.cos(angles), rotary_sin=np.sin(angles))

    def j_loss(q, k, v):
        out = j_attention_core(q, k, v, impl="flash", attention_mask=jnp.asarray(mask),
                               **{n: jnp.asarray(t) for n, t in rot.items()})
        return (out * do).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention_core(*leaves, impl="flash", attention_mask=torch.from_numpy(mask),
                         **{n: torch.from_numpy(t) for n, t in rot.items()})
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[2].detach().numpy(), np.broadcast_to(
        v[2].mean(0).repeat(H // Hkv, axis=0), (S, H, D)), atol=1e-6, rtol=0)
    for leaf, g in zip(leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=1e-5, rtol=0)
    assert leaves[0].grad[2].abs().max() > 1e-3 and leaves[1].grad[2].abs().max() > 1e-3


def test_sdpa_dropout_needs_a_generator_as_jax_needs_a_rng():
    """sdpa(dropout_p > 0) draws dropout only from a generator, as JAX's sdpa
    only from a dropout_rng: without one it equals JAX's sdpa without a rng
    (no dropout); with one it drops."""
    from contrastors_tpu.ops.sdpa import sdpa as j_sdpa
    from contrastors_tpu_torch.ops.sdpa import sdpa

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 16, 2, 64)).astype(np.float32) for _ in range(3))
    j_out = np.asarray(j_sdpa(q, k, v, dropout_p=0.5))
    out = sdpa(*map(torch.from_numpy, (q, k, v)), dropout_p=0.5)
    np.testing.assert_allclose(out.numpy(), j_out, atol=1e-6, rtol=0)
    dropped = sdpa(*map(torch.from_numpy, (q, k, v)), dropout_p=0.5,
                   dropout_generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(dropped, out, atol=1e-3)
