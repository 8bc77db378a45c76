"""The port's flash-attention backward against the JAX Pallas backward.

The plain PyTorch backward (`flash_attention_backward_reference`, which the
autograd backward runs on CPU tensors) is held to `jax.vjp` of JAX
`flash_attention`, whose `_bwd` runs the Pallas `_bwd_dq_kernel` and
`_bwd_dkv_kernel` in interpret mode, in fp32 on the forward tests' seven
cases: dq, dk, dv atol 1e-4 (fp32 sums over at most 200 rows of O(1)
terms, in another order). The CUDA kernels are held to the plain version
in test_torch_kernels.py (marked `cuda`, skipped without a card) and by
chip_smoke.py, with `grad_error_ratio` <= 1; the last test here shows that
rule accepts the kernels' tiled bf16 arithmetic and rejects three faults.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.ops import flash_attention as jfa
from contrastors_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

GRAD_ATOL = 1e-4
CASES = ["padding", "segments", "causal_s_ne_t", "window", "gqa", "unaligned", "fully_masked_row"]


def _case(name):
    """The inputs of test_torch_flash_attention.py's case `name`, plus dO."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, S, T, H, Hkv, D = 2, 128, 128, 4, 4, 64
    kw = dict(attention_mask=None, segment_ids=None, kv_segment_ids=None, causal=False, window=0)
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
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, do, kw


@pytest.mark.parametrize("name", CASES)
def test_backward_reference_matches_jax_pallas_backward(name, monkeypatch):
    monkeypatch.setenv("CONTRASTORS_TPU_FLASH_INTERPRET", "1")
    q, k, v, do, kw = _case(name)
    j_kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, **j_kw, block_q=128, block_kv=128),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    j_grads = vjp(jnp.asarray(do))

    t_kw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, **t_kw)
    t_grads = tfa.flash_attention_backward_reference(tq, tk, tv, out, lse, tdo, **t_kw)
    for t, j in zip(t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=GRAD_ATOL, rtol=0)

    # autograd through the wrapper on CPU tensors is the plain backward, bit for bit
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    a_grads = torch.autograd.grad(tfa.flash_attention(*leaves, **t_kw), leaves, tdo)
    assert all(torch.equal(a, t) for a, t in zip(a_grads, t_grads))
    if name == "fully_masked_row":
        assert torch.all(t_grads[0][1] == 0)


def _tiled_backward(q, k, v, out, lse, do, fault, tile=64):
    """The backward kernels' arithmetic in plain torch (bf16 inputs, fp32
    products, p and ds rounded to bf16 as tensor-core operands, dk/dv summed
    over 64-row q tiles and dq over 64-wide kv tiles), optionally with one
    fault."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    gq = H // Hkv
    scale = D**-0.5
    kr, vr = (x.repeat_interleave(gq, 2).float() for x in (k, v))
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2)[..., None]
    s = torch.einsum("bshd,bthd->bhst", q.float(), kr)
    p = torch.exp2(s * scale * tfa.LOG2E - lse[..., None])
    dp = torch.einsum("bshd,bthd->bhst", do.float(), vr)
    ds = p * (dp if fault == "no_delta" else dp - delta) * scale
    dsb, pb = ds.bfloat16().float(), p.bfloat16().float()
    dq = torch.zeros(B, S, H, D)
    for j in range(0, T, tile):
        dq += torch.einsum("bhst,bthd->bshd", dsb[..., j:j + tile], kr[:, j:j + tile])
    dk, dv = torch.zeros(B, T, H, D), torch.zeros(B, T, H, D)
    q_end = (S - 1) // tile * tile if fault == "drop_last_q_tile" else S
    for i in range(0, q_end, tile):
        dk += torch.einsum("bhst,bshd->bthd", dsb[:, :, i:i + tile], q.float()[:, i:i + tile])
        dv += torch.einsum("bhst,bshd->bthd", pb[:, :, i:i + tile], do.float()[:, i:i + tile])
    dk, dv = dk.view(B, T, Hkv, gq, D), dv.view(B, T, Hkv, gq, D)
    if fault == "gqa_one_member":
        dk, dv = dk[:, :, :, 0], dv[:, :, :, 0]
    else:
        dk, dv = dk.sum(3), dv.sum(3)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("fault", ["none", "no_delta", "drop_last_q_tile", "gqa_one_member"])
@pytest.mark.parametrize("S", [200, 1024])
def test_grad_tolerance_rejects_backward_faults(fault, S):
    """The rule that holds the card's backward kernels to their plain
    version (`grad_error_ratio` <= 1 for each of dq, dk, dv) accepts the
    tiled bf16 arithmetic and rejects it with delta left out of ds, the last
    q tile dropped from dk/dv, or a GQA group summed over one member."""
    gen = torch.Generator().manual_seed(S)
    B, H, Hkv = (2, 4, 2) if S == 200 else (1, 2, 1)
    q = torch.randn(B, S, H, 64, generator=gen).bfloat16()
    k, v = (torch.randn(B, S, Hkv, 64, generator=gen).bfloat16() for _ in range(2))
    do = torch.randn(B, S, H, 64, generator=gen).bfloat16()
    out, lse = tfa.flash_attention_reference(q, k, v)
    ref = tfa.flash_attention_backward_reference(q, k, v, out, lse, do)
    got = _tiled_backward(q, k, v, out, lse, do, fault)
    ratio = max(tfa.grad_error_ratio(g, r, n) for g, r, n in zip(got, ref, ("dq", "dk", "dv")))
    assert (ratio <= 1.0) == (fault == "none"), ratio
