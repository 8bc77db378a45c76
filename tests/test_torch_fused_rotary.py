"""The port's fused-rotary flash attention against JAX's fused-rotary kernels.

The wrapper with rotary tables (on CPU tensors: the fused kernels' plain
versions, forward and backward) is held to JAX `flash_attention(rotary_cos=
...)`, whose Pallas kernels run in interpret mode, in the cases of
tests/test_flash_attention.py:336-447: NeoX and interleaved, each with and
without causal masking; a partial rotary dim with a padding mask; GQA;
packed rows with segment ids and position_ids (per-batch tables); S not a
multiple of the tile, with and without position_ids; S != T, where both
rotate outside; and position_ids with S != T, which both refuse. fp32: O
atol 2e-5, dq/dk/dv atol 5e-4 (the JAX file's tolerances). In bf16, the
port's dq lies within one bf16 ulp (at the scale of dq, its largest |value|)
of JAX's on every element, and its mean distance is under half of that of
the same gradient cast to bf16 before the adjoint, which also leaves the
one-ulp bound: the adjoint runs on the fp32 accumulator before the one cast.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers.rotary import rotary_cos_sin as j_tables
from contrastors_tpu.ops import flash_attention as jfa
from contrastors_tpu_torch.layers.rotary import expanded_tables, rotate, rotate_adjoint
from contrastors_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

O_ATOL, GRAD_ATOL = 2e-5, 5e-4
CASES = ["neox", "neox_causal", "interleaved", "interleaved_causal", "partial_dim_mask", "gqa",
         "packed_position_ids", "unaligned", "packed_unaligned", "cross_s_ne_t"]


def _case(name, dtype=np.float32):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, S, T, H, Hkv, D, rot = 2, 128, 128, 4, 4, 64, 64
    kw = dict(causal=name.endswith("causal"), rotary_interleaved=name.startswith("interleaved"))
    if name == "partial_dim_mask":
        rot = 32
        kw["attention_mask"] = (np.arange(T)[None] < np.array([T, 70])[:, None]).astype(np.int32)
    if name == "gqa":
        H, Hkv = 8, 2
    if name in ("unaligned", "packed_unaligned"):
        S = T = 200 if name == "unaligned" else 300
    if name == "cross_s_ne_t":
        S, T, kw["causal"] = 64, 192, True
    if name.startswith("packed"):
        seg, pos = np.zeros((B, S), np.int32), np.zeros((B, S), np.int32)
        for b, bounds in enumerate(([0, 50, 90, S - 10], [0, S])):
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                seg[b, lo:hi], pos[b, lo:hi] = i + 1, np.arange(hi - lo)
        kw["segment_ids"], kw["rotary_position_ids"] = seg, pos
    q = rng.normal(size=(B, S, H, D)).astype(dtype)
    k, v = (rng.normal(size=(B, T, Hkv, D)).astype(dtype) for _ in range(2))
    do = rng.normal(size=(B, S, H, D)).astype(dtype)
    cos, sin = (np.array(t) for t in j_tables(max(S, T), rot))
    return q, k, v, do, cos, sin, kw


def _jax(q, k, v, do, cos, sin, kw, jdtype=jnp.float32):
    j_kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, **j_kw, block_q=128, block_kv=128,
                                               rotary_cos=jnp.asarray(cos), rotary_sin=jnp.asarray(sin)),
        *(jnp.asarray(x, jdtype) for x in (q, k, v)),
    )
    grads = vjp(jnp.asarray(do, jdtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port(q, k, v, do, cos, sin, kw, tdtype=torch.float32):
    t_kw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    leaves = [torch.from_numpy(x).to(tdtype).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, **t_kw, rotary_cos=torch.from_numpy(cos),
                              rotary_sin=torch.from_numpy(sin))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdtype))
    return [x.detach().float().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("name", CASES)
def test_fused_rotary_matches_jax(name, monkeypatch):
    monkeypatch.setenv("CONTRASTORS_TPU_FLASH_INTERPRET", "1")
    q, k, v, do, cos, sin, kw = _case(name)
    j_out, *j_grads = _jax(q, k, v, do, cos, sin, kw)
    t_out, *t_grads = _port(q, k, v, do, cos, sin, kw)
    np.testing.assert_allclose(t_out, j_out, atol=O_ATOL, rtol=0)
    for t, j, n in zip(t_grads, j_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t, j, atol=GRAD_ATOL, rtol=0, err_msg=n)


def test_fused_rotary_position_ids_with_s_ne_t_raise():
    q = torch.zeros(1, 128, 2, 64)
    k = torch.zeros(1, 256, 2, 64)
    cos, sin = (torch.from_numpy(np.array(t)) for t in j_tables(256, 64))
    pos = torch.arange(128)[None]
    with pytest.raises(ValueError, match="rotary_position_ids"):
        tfa.flash_attention(q, k, k, rotary_cos=cos, rotary_sin=sin, rotary_position_ids=pos)
    with pytest.raises(ValueError, match="rotary_position_ids"):
        jfa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, k)), rotary_cos=jnp.asarray(cos.numpy()),
                            rotary_sin=jnp.asarray(sin.numpy()), rotary_position_ids=jnp.asarray(pos.numpy()))


def test_bf16_adjoint_runs_before_the_cast(monkeypatch):
    """bf16 q/k/v/dO: the port's dq lies within one bf16 ulp of JAX's, whose
    kernel applies the adjoint to the fp32 accumulator and casts once. The
    same gradient cast to bf16 before the adjoint (then cast again) misses
    JAX's by more than that ulp, and by over twice as much on average. The
    ulp is taken at the largest |dq|: element by element the two frameworks'
    bf16 roundings of ds and p (summed in other orders) already differ by
    more than an ulp of the small elements."""
    monkeypatch.setenv("CONTRASTORS_TPU_FLASH_INTERPRET", "1")
    q, k, v, do, cos, sin, kw = _case("neox")
    _, j_dq, _, _ = _jax(q, k, v, do, cos, sin, kw, jnp.bfloat16)
    _, t_dq, _, _ = _port(q, k, v, do, cos, sin, kw, torch.bfloat16)
    _, e = np.frexp(np.abs(j_dq).max())
    ulp = np.ldexp(1.0, int(e) - 8)  # bf16 keeps 8 significant bits
    assert np.abs(t_dq - j_dq).max() <= ulp

    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    cos_d, sin_d = expanded_tables(torch.from_numpy(cos), torch.from_numpy(sin), 64, False, 128)
    qr, kr = (rotate(x, cos_d, sin_d, 64, False) for x in (tq, tk))
    out, lse = tfa.flash_attention_reference(qr, kr, tv)
    dq_rot = tfa.flash_attention_backward_reference(qr, kr, tv, out, lse, tdo)[0]  # cast to bf16
    cast_first = rotate_adjoint(dq_rot.float(), cos_d, sin_d, 64, False).bfloat16().float().numpy()
    assert np.abs(cast_first - j_dq).max() > ulp
    assert np.abs(t_dq - j_dq).mean() < 0.5 * np.abs(cast_first - j_dq).mean()
