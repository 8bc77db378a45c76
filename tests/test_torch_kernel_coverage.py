"""Every dtype and head dim the Pallas kernels take, on the port's side.

The port routes each flash and grouped-matmul call on the card by dtype,
shape and strides (`flash_route`, `grouped_matmul_route`): bf16 at the
Hopper kernels' shapes to csrc/flash_fwd.cu, flash_bwd.cu and gmm.cu, every
other input JAX takes (fp32; head dims other than 64 and 128; any K and N)
to the generic kernels (csrc/flash_generic.cu, flash_tf32.cu, gmm_generic.cu). Here, on
the CPU, where the wrappers run the kernels' plain versions:

  (i) the two routing functions over a grid of dtype x head dim (or K, N)
      x alignment (above head dim 256: the wide kernels,
      csrc/flash_wide.cu); attention_core(impl="flash") reaches sdpa
      exactly where JAX's `flash_shape_ok` is false, at every head dim;
  (ii) attention_core(impl="flash") against JAX's Pallas kernels in
      interpret mode, forward and q/k/v gradients, fp32 at D = 80, 88, 256,
      320 and 512, with causal + padding, a window, segment ids, GQA and
      partial fused rotary, and at D = 512 NeoX rotary over the whole head
      dim: atol 1e-5 (padded query rows, where attention_core follows JAX's
      sdpa convention below kv 512, are left out of both);
  (iii) the port's gmm and its gradients against JAX's gmm (its ragged_dot
      path: K = 200, N = 360 are not multiples of 128) in fp32, atol 1e-4
      at sums of 200-360 products of unit normals;
  (iv) GPT-NeoX trunks with pythia-1b's head geometry (2 layers of 512, 2
      heads of 256, rotary_pct 0.25) and with its width read as heads of
      512 (2 layers of 1024, 2 heads of 512) through both packages'
      loaders: the last-pooled embeddings and the decoder recipe's clip loss
      gradient (logit scale 50, one hard negative a query) in fp32 against
      JAX's.
The generic kernels themselves are held to these plain versions on the
card by chip_smoke.py (phase 26, `--only coverage`).
"""

import json
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers.rotary import rotary_cos_sin as j_tables
from contrastors_tpu.losses import clip_loss as j_clip_loss
from contrastors_tpu.ops import flash_attention as jfa
from contrastors_tpu.ops import grouped_matmul as jgm
from contrastors_tpu_torch import ops as tops
from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.losses import clip_loss
from contrastors_tpu_torch.models.auto import load_biencoder
from contrastors_tpu_torch.ops import attention_core
from contrastors_tpu_torch.ops import flash_attention as tfa
from contrastors_tpu_torch.ops import grouped_matmul as tgm
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

HEAD_DIMS = [8, 16, 32, 48, 56, 60, 64, 72, 80, 88, 96, 100, 128, 136, 192, 248, 256, 264, 320, 512, 1024]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _qkv(D, dtype, H=4, Hkv=4, aligned=True, S=16):
    """q, k, v [1, S, H(kv), D]; unaligned: views at an odd element offset
    of a larger buffer (the base pointer off 16 bytes)."""
    def one(h):
        if aligned:
            return torch.zeros(1, S, h, D, dtype=dtype)
        return torch.zeros(S * h * D + 1, dtype=dtype)[1:].view(1, S, h, D)
    return one(H), one(Hkv), one(Hkv)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_route_over_dtype_head_dim_and_alignment(dtype, D):
    """bf16 at D in (64, 128) with aligned operands and a rotary dim that is
    a multiple of 16: the Hopper kernels; every other fp32 / bf16 operand
    with D % 8 == 0: the generic kernels up to D = 256, the wide kernels
    above; fp16 and D % 8 != 0 raise. attention_core's flash gate is JAX's
    `flash_shape_ok`."""
    dt = DTYPES[dtype]
    for aligned in (True, False):
        for H, Hkv in ((4, 4), (4, 1)):
            q, k, v = _qkv(D, dt, H, Hkv, aligned)
            assert tfa.flash_shape_ok(q, k) == jfa.flash_shape_ok(q, k) == (D % 8 == 0 and D >= 64)
            if dt == torch.float16:
                with pytest.raises(TypeError, match="float32 or bfloat16"):
                    tfa.flash_route(q, k, v)
                continue
            if D % 8:
                with pytest.raises(ValueError, match="multiple of 8"):
                    tfa.flash_route(q, k, v)
                continue
            hopper = dt == torch.bfloat16 and D in (64, 128) and aligned
            other = "generic" if D <= 256 else "wide"
            assert tfa.flash_route(q, k, v) == ("hopper" if hopper else other)
            assert tfa.flash_route(q, k, v, q, q) == ("hopper" if hopper else other)  # backward: dO, O
            for rot_dim in (16, 24, D):  # a rotary dim that is not a multiple of 16 takes the generic kernels
                if rot_dim <= D:
                    assert tfa.flash_route(q, k, v, rot_dim=rot_dim) == (
                        "hopper" if hopper and rot_dim % 16 == 0 else other)
    q, k, v = _qkv(D, torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_route(q, k.bfloat16(), v)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_attention_core_reaches_sdpa_only_where_jax_does(D, monkeypatch):
    """impl="flash" without dropout: the flash path (the plain version of the
    Hopper, generic or wide kernels here) for every head dim JAX's rule
    takes, 512 and 1024 among them, within 1e-5 of sdpa; the plain sdpa
    exactly where JAX's `flash_shape_ok` is false."""
    calls = []
    orig = tops.sdpa
    monkeypatch.setattr(tops, "sdpa", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    gen = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(2, 12, 4, D, generator=gen) for _ in range(3))
    jax_flash = bool(jfa.flash_shape_ok(q.numpy(), k.numpy()))
    out = attention_core(q, k, v, impl="flash", causal=True)
    assert len(calls) == (0 if jax_flash else 1)
    ref = attention_core(q, k, v, impl="sdpa", causal=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


GMM_WIDTHS = [(64, 128), (128, 64), (200, 360), (768, 3072), (96, 200), (3072, 768)]


@pytest.mark.parametrize("block_m", [128, 64, 256, 96])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grouped_matmul_route_over_dtype_width_and_alignment(dtype, block_m):
    """bf16 with K and N multiples of 64, block_m 128 and aligned operands:
    gmm.cu; every other fp32 / bf16 operand with block_m a multiple of 64:
    the generic kernels; fp16, mixed dtypes and other block sizes raise.
    The same for tgmm's (lhs, dout)."""
    dt = DTYPES[dtype]
    M = 768
    for K, N in GMM_WIDTHS:
        for aligned in (True, False):
            lhs = torch.zeros(M, K, dtype=dt) if aligned else torch.zeros(M * K + 1, dtype=dt)[1:].view(M, K)
            rhs, dout = torch.zeros(4, K, N, dtype=dt), torch.zeros(M, N, dtype=dt)
            rhs_k_major = torch.zeros(4, N, K, dtype=dt).transpose(1, 2)  # the backward's rhs^T view
            for other in (rhs, rhs_k_major, dout):
                if dt == torch.float16:
                    with pytest.raises(TypeError, match="float32 or bfloat16"):
                        tgm.grouped_matmul_route(lhs, other, block_m)
                    continue
                if block_m % 64:
                    with pytest.raises(ValueError, match="block_m"):
                        tgm.grouped_matmul_route(lhs, other, block_m)
                    continue
                hopper = dt == torch.bfloat16 and K % 64 == 0 and N % 64 == 0 and block_m == 128 and aligned
                assert tgm.grouped_matmul_route(lhs, other, block_m) == ("hopper" if hopper else "generic")
    with pytest.raises(TypeError, match="one dtype"):
        tgm.grouped_matmul_route(torch.zeros(128, 64), torch.zeros(2, 64, 64, dtype=torch.bfloat16))


# -- (ii) attention_core(impl="flash") against JAX's Pallas kernels ------------

FLASH_DIMS = [80, 88, 256, 320, 512]
VARIANTS = ["causal_pad", "window", "segments", "gqa_pad", "rotary_pad"]
# every variant at every head dim, and NeoX rotary over the whole head dim at
# 512, where the rotary adjoint pairs columns of two of the wide kernels'
# output slices
FLASH_CASES = [(D, variant) for D in FLASH_DIMS for variant in VARIANTS] + [(512, "rotary_full")]


def _attention_case(D, variant):
    rng = np.random.default_rng(zlib.crc32(f"{variant}{D}".encode()))
    B, S = 2, 128
    H, Hkv = (4, 1) if variant == "gqa_pad" else (2, 2)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    kw = dict(causal=variant == "causal_pad", window=48 if variant == "window" else 0)
    valid = np.ones((B, S), bool)
    if variant.endswith("_pad"):
        lens = np.array([S, 77])
        kw["attention_mask"] = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
        valid = kw["attention_mask"].astype(bool)
    if variant == "segments":
        seg = np.zeros((B, S), np.int32)
        seg[:, :50], seg[:, 50:100], seg[1, 100:120] = 1, 2, 3
        kw["segment_ids"] = seg
        valid = seg > 0
    if variant.startswith("rotary"):
        cos, sin = (np.array(t) for t in j_tables(S, D if variant == "rotary_full" else D // 4 // 2 * 2))
        kw.update(rotary_cos=cos, rotary_sin=sin)
    do = do * valid[:, :, None, None]  # padded query rows: no gradient flows back on either side
    return q, k, v, do, kw, valid


@pytest.fixture(scope="module")
def jax_attention():
    """JAX's flash_attention (the Pallas kernels in interpret mode), output
    and q/k/v gradients for every case, computed once."""
    import os

    before = os.environ.get("CONTRASTORS_TPU_FLASH_INTERPRET")
    os.environ["CONTRASTORS_TPU_FLASH_INTERPRET"] = "1"
    try:
        runs = {}
        for D, variant in FLASH_CASES:
            q, k, v, do, kw, _ = _attention_case(D, variant)
            j_kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
            out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, **j_kw, block_q=128, block_kv=128),
                               *(jnp.asarray(x) for x in (q, k, v)))
            runs[(D, variant)] = [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]
        return runs
    finally:
        if before is None:
            del os.environ["CONTRASTORS_TPU_FLASH_INTERPRET"]
        else:
            os.environ["CONTRASTORS_TPU_FLASH_INTERPRET"] = before


@pytest.mark.parametrize("D,variant", FLASH_CASES)
def test_attention_core_flash_matches_jax_kernels(jax_attention, D, variant):
    q, k, v, do, kw, valid = _attention_case(D, variant)
    j_out, *j_grads = jax_attention[(D, variant)]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention_core(*leaves, impl="flash",
                         **{n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()})
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    rows = valid[:, :, None, None]
    np.testing.assert_allclose(out.detach().numpy() * rows, j_out * rows, atol=1e-5, rtol=0)
    for g, j, name in zip(grads, j_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), j, atol=1e-5, rtol=0, err_msg=name)


# -- (iii) gmm at widths that are not multiples of 128 -----------------------


def test_gmm_and_its_gradients_match_jax_ragged_dot():
    rng = np.random.default_rng(3)
    K, N, E, BM = 200, 360, 4, 128
    gs = np.array([256, 0, 128, 384], np.int32)  # an empty expert; 128 trailing padding rows
    M = int(gs.sum()) + BM
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    lhs[int(gs.sum()):] = 0.0
    rhs = rng.normal(size=(E, K, N)).astype(np.float32)
    w = rng.normal(size=(M, N)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jgm.gmm(a, b, jnp.asarray(gs), block_m=BM), jnp.asarray(lhs), jnp.asarray(rhs))
    j_dlhs, j_drhs = vjp(jnp.asarray(w))
    leaves = [torch.from_numpy(lhs).requires_grad_(), torch.from_numpy(rhs).requires_grad_()]
    t_out = tgm.gmm(*leaves, torch.from_numpy(gs), block_m=BM)
    dlhs, drhs = torch.autograd.grad(t_out, leaves, torch.from_numpy(w))
    for t, j in ((t_out.detach(), out), (dlhs, j_dlhs), (drhs, j_drhs)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)
    assert torch.all(drhs[1] == 0) and torch.all(t_out[int(gs.sum()):] == 0)


# -- (iv) pythia-1b's head geometry through both loaders ------------------------


def _neox_geometry(tmp_path_factory, hidden, heads):
    """A GPT-NeoX checkpoint (HF's GPTNeoXModel init, seed 0) of 2 layers of
    `hidden` in `heads` heads, rotary over a quarter of each head, parallel
    residual; and JAX's and the port's last-pooled BiEncoder of it (JAX on
    sdpa, as its dispatch runs below kv 512; the port on flash), with a
    batch of queries and documents."""
    from safetensors.numpy import save_file
    from transformers import GPTNeoXConfig, GPTNeoXModel

    from contrastors_tpu.config import ModelArgs as JModelArgs
    from contrastors_tpu.models.auto import load_biencoder as j_load_biencoder

    torch.manual_seed(0)
    cfg = GPTNeoXConfig(vocab_size=128, hidden_size=hidden, num_hidden_layers=2, num_attention_heads=heads,
                        intermediate_size=4 * hidden, rotary_pct=0.25, use_parallel_residual=True, hidden_act="gelu",
                        max_position_embeddings=64, attention_dropout=0.0, hidden_dropout=0.0)
    sd = {k: v.numpy() for k, v in GPTNeoXModel(cfg).state_dict().items()}
    path = tmp_path_factory.mktemp(f"neox_{hidden}_{heads}") / "neox"
    path.mkdir()
    hf = cfg.to_dict()
    hf["model_type"] = "gpt_neox"
    (path / "config.json").write_text(json.dumps(hf))
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(path / "model.safetensors"))
    args = dict(model_type="encoder", model_name=str(path), pooling="last", pretrained=True)
    jm, jparams, _ = j_load_biencoder(JModelArgs(**args, attn_impl="sdpa"))
    tm, tcfg = load_biencoder(ModelArgs.from_dict(dict(args, attn_impl="flash")), device="cpu")
    assert tcfg.n_embd // tcfg.n_head == hidden // heads
    rng = np.random.default_rng(5)
    B, L = 3, 20
    batch = {}
    for name, rows in (("q", B), ("d", 2 * B)):  # a hard negative a query: document 2i is query i's positive
        ids = rng.integers(1, 128, size=(rows, L))
        lens = rng.integers(4, L + 1, size=rows)
        lens[0] = L
        batch[name] = (ids, (np.arange(L)[None] < lens[:, None]).astype(np.int64))
    return jm, jparams, tm, batch


@pytest.fixture(scope="module")
def pythia_1b_geometry(tmp_path_factory):
    """pythia-1b's head geometry at 2 layers of 512: 2 heads of 256, rotary
    over 64 of them (the generic kernels' plain versions)."""
    return _neox_geometry(tmp_path_factory, 512, 2)


@pytest.fixture(scope="module")
def pythia_1b_wide_geometry(tmp_path_factory):
    """pythia-1b's width read as heads of 512, at 2 layers of 1024: 2 heads
    of 512, rotary over 128 of them (the wide kernels' plain versions)."""
    return _neox_geometry(tmp_path_factory, 1024, 2)


def _embeddings_match_jax(geometry):
    jm, jparams, tm, batch = geometry
    embed = jax.jit(lambda p, ids, mask: jm.apply(p, input_ids=ids, attention_mask=mask)["embedding"])
    for ids, mask in batch.values():
        j_emb = np.asarray(embed(jparams, jnp.asarray(ids), jnp.asarray(mask)))
        with torch.no_grad():
            t_emb = tm(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"].numpy()
        np.testing.assert_allclose(t_emb, j_emb, atol=5e-5, rtol=1e-4)


def _loss_gradient_matches_jax(geometry):
    jm, jparams, tm, batch = geometry
    (qi, qm), (di, dm) = batch["q"], batch["d"]

    def j_loss(params):
        q = jm.apply(params, input_ids=jnp.asarray(qi), attention_mask=jnp.asarray(qm))["embedding"]
        d = jm.apply(params, input_ids=jnp.asarray(di), attention_mask=jnp.asarray(dm))["embedding"]
        return j_clip_loss(q, d, lambda x: x * 50.0)[0]

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(jparams)
    tm.zero_grad()
    q = tm(torch.from_numpy(qi), torch.from_numpy(qm))["embedding"]
    d = tm(torch.from_numpy(di), torch.from_numpy(dm))["embedding"]
    loss, _ = clip_loss(q, d, lambda x: x * 50.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    want = flax_to_torch(jax.device_get(j_grads))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n in sorted(got):
        g, j = got[n].double(), torch.as_tensor(np.asarray(want[n])).double()
        assert float((g - j).norm()) <= 1e-4 * float(j.norm()) + 1e-7, n


def test_pythia_1b_geometry_embeddings_match_jax(pythia_1b_geometry):
    _embeddings_match_jax(pythia_1b_geometry)


def test_pythia_1b_geometry_loss_gradient_matches_jax(pythia_1b_geometry):
    """The decoder recipe's loss (clip, logit scale 50, the hard negatives of
    configs/train/contrastive_finetune_decoder.yaml) and its gradient for
    every parameter, through the flash path at head dim 256."""
    _loss_gradient_matches_jax(pythia_1b_geometry)


def test_pythia_1b_wide_geometry_embeddings_match_jax(pythia_1b_wide_geometry):
    _embeddings_match_jax(pythia_1b_wide_geometry)


def test_pythia_1b_wide_geometry_loss_gradient_matches_jax(pythia_1b_wide_geometry):
    """The decoder recipe's loss and its gradient for every parameter, as
    above, through the flash path at head dim 512."""
    _loss_gradient_matches_jax(pythia_1b_wide_geometry)
