"""The port's layers against the flax modules, on parameters converted by
`contrastors_tpu_torch.convert.flax_to_torch`. fp32 on the CPU, atol 1e-5
(rotary tables: bit for bit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers import rotary as jrot
from contrastors_tpu.layers.attention import MultiHeadAttention as JMHA
from contrastors_tpu.layers.block import Block as JBlock
from contrastors_tpu.layers.embeddings import BertEmbeddings as JEmb
from contrastors_tpu.layers.mlp import make_mlp as j_make_mlp
from contrastors_tpu.layers.norms import LayerNorm as JLN, RMSNorm as JRMS
from contrastors_tpu.models import presets as jpre
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.layers import rotary as trot
from contrastors_tpu_torch.layers.attention import MultiHeadAttention
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.layers.embeddings import BertEmbeddings
from contrastors_tpu_torch.layers.mlp import make_mlp
from contrastors_tpu_torch.layers.norms import LayerNorm, RMSNorm
from contrastors_tpu_torch.models import presets as tpre

ATOL = 1e-5
SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)


def _load(flax_mod, torch_mod, *jax_args, seed=0, **jax_kw):
    """Init the flax module, randomise its params with numpy, load them into
    the torch module. Returns the params for `flax_mod.apply`."""
    rng = np.random.default_rng(seed)
    variables = flax_mod.init(jax.random.PRNGKey(0), *jax_args, **jax_kw)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.02, size=x.shape)).astype(np.float32),
        variables["params"],
    )
    torch_mod.load_state_dict(flax_to_torch(params), strict=True)
    return {"params": params}


def _close(t, j, mask=None):
    t, j = t.detach().numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(seqlen=64, rotary_dim=64, base=1000.0),
    dict(seqlen=4096, rotary_dim=64, base=1000.0, rotary_scaling_factor=2.0),  # NTK past 2048
    dict(seqlen=128, rotary_dim=32, base=500000.0, rope_scaling=dict(
        factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0, original_max_position_embeddings=64)),
])
def test_rotary_tables_bit_exact(kw):
    jc, js = jrot.rotary_cos_sin(**kw)
    tc, ts = trot.rotary_cos_sin(**kw, device="cpu")
    assert np.array_equal(tc.numpy(), np.asarray(jc)) and np.array_equal(ts.numpy(), np.asarray(js))
    assert trot.ntk_scaled_base(1000.0, 64, 4096, 2048, 2.0) == jrot.ntk_scaled_base(1000.0, 64, 4096, 2048, 2.0)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rot_dim", [64, 32])
@pytest.mark.parametrize("with_pos", [False, True])
def test_apply_rotary(interleaved, rot_dim, with_pos):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 24, 3, 64)).astype(np.float32)
    cos, sin = jrot.rotary_cos_sin(32, rot_dim, base=1000.0)
    pos = rng.integers(0, 32, size=(2, 24)) if with_pos else None
    j = jrot.apply_rotary(jnp.asarray(x), cos, sin, interleaved, None if pos is None else jnp.asarray(pos))
    t = trot.apply_rotary(
        torch.from_numpy(x), torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin)),
        interleaved, None if pos is None else torch.from_numpy(pos),
    )
    _close(t, j)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms(kind):
    x = np.random.default_rng(2).normal(size=(3, 5, 48)).astype(np.float32) * 3 + 1
    jm, tm = (JLN(dim=48, eps=1e-5), LayerNorm(48, eps=1e-5, device="cpu")) if kind == "layernorm" \
        else (JRMS(dim=48, eps=1e-6), RMSNorm(48, eps=1e-6, device="cpu"))
    params = _load(jm, tm, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))
    # bf16 in, bf16 out, fp32 inside
    assert tm(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["swiglu", "gelu", "geglu"])
def test_mlp(act):
    jcfg = jpre.nomic_bert_2048(activation_function=act, mlp_fc1_bias=True, **SMALL)
    tcfg = tpre.nomic_bert_2048(activation_function=act, mlp_fc1_bias=True, **SMALL)
    x = np.random.default_rng(3).normal(size=(2, 7, 128)).astype(np.float32)
    jm, tm = j_make_mlp(jcfg, jnp.float32), make_mlp(tcfg, device="cpu")
    params = _load(jm, tm, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_bert_embeddings_pad_aware_positions_and_token_types():
    jcfg = jpre.bert_base(n_layer=1, n_embd=64, n_head=2, vocab_size=100, n_positions=40)
    tcfg = tpre.bert_base(n_layer=1, n_embd=64, n_head=2, vocab_size=100, n_positions=40)
    ids = np.random.default_rng(4).integers(1, 100, size=(2, 12))
    ids[1, 8:] = 0  # pad_token_id
    types = (np.arange(12)[None] >= 6).astype(np.int64).repeat(2, 0)
    jm, tm = JEmb(config=jcfg), BertEmbeddings(tcfg, device="cpu")
    params = _load(jm, tm, jnp.asarray(ids), token_type_ids=jnp.asarray(types))
    _close(
        tm(torch.from_numpy(ids), token_type_ids=torch.from_numpy(types)),
        jm.apply(params, jnp.asarray(ids), token_type_ids=jnp.asarray(types)),
    )


def _attn_inputs(seed=5, B=2, S=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    mask = np.ones((B, S), np.int64)
    mask[1, 13:] = 0
    return x, mask


@pytest.mark.parametrize("num_heads_kv", [2, 1])
def test_multihead_attention(num_heads_kv):
    """sdpa on both sides: every row agrees. The port's flash path (the
    plain flash version on CPU) agrees on valid rows."""
    jcfg = jpre.nomic_bert_2048(num_heads_kv=num_heads_kv, **SMALL)
    tcfg = tpre.nomic_bert_2048(num_heads_kv=num_heads_kv, **SMALL)
    x, mask = _attn_inputs()
    jm, tm = JMHA(config=jcfg), MultiHeadAttention(tcfg, device="cpu")
    params = _load(jm, tm, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    j = jm.apply(params, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)), j)
    tf = MultiHeadAttention(tpre.nomic_bert_2048(num_heads_kv=num_heads_kv, attn_impl="flash", **SMALL),
                            device="cpu")
    tf.load_state_dict(tm.state_dict())
    _close(tf(torch.from_numpy(x), torch.from_numpy(mask)), j, mask.astype(bool))


@pytest.mark.parametrize("prenorm", [False, True])
def test_block(prenorm):
    jcfg = jpre.nomic_bert_2048(prenorm=prenorm, **SMALL)
    tcfg = tpre.nomic_bert_2048(prenorm=prenorm, **SMALL)
    x, mask = _attn_inputs(seed=6)
    jm, tm = JBlock(config=jcfg), Block(tcfg, device="cpu")
    params = _load(jm, tm, jnp.asarray(x), None, jnp.asarray(mask))
    jh, jres, _ = jm.apply(params, jnp.asarray(x), None, jnp.asarray(mask))
    th, tres, trl = tm(torch.from_numpy(x), None, torch.from_numpy(mask))
    assert trl is None  # a dense block has no router logits
    _close(th, jh)
    if prenorm:
        _close(tres, jres)
    else:
        assert tres is None and jres is None
