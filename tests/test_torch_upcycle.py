"""Dense-to-MoE upcycling in the port against JAX's `moe_interop`.

The same dense numpy tree (a JAX NomicBertModel's init, gated swiglu or a
plain gelu MLP) goes through JAX's `expand_dense_trunk_to_moe` and the
port's: the expanded trees are equal array for array, the freshly drawn
routers included (both draw from numpy's default_rng(0)), for ffn_div 1
and 2 (with 3 routed experts, so ffn_div 2 takes the mean-pooled
remainder), gated and plain, and 0 or 1 shared experts. Then
`load_biencoder` of a dense checkpoint directory into an MoE config, on
both sides: a nomic-layout checkpoint (gated) and an HF BERT one (plain,
as the multilingual recipes load xlm-roberta): the port's state dict equals
JAX's parameters after `convert.flax_to_torch`, every expert of an MoE
layer equals the dense MLP, and the embeddings agree within 1e-4.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.config import ModelArgs as JModelArgs
from contrastors_tpu.export import trunk_config_to_nomic_hf_dict
from contrastors_tpu.models.auto import load_biencoder as j_load_biencoder
from contrastors_tpu.models.hf_interop import flax_to_nomic_state_dict
from contrastors_tpu.models.model_config import TrunkConfig as JTrunkConfig
from contrastors_tpu.models.moe_interop import expand_dense_trunk_to_moe as j_expand
from contrastors_tpu.models.nomic_bert import NomicBertModel as JNomicBert
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models.auto import load_biencoder
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.moe_interop import _replicate_rows, expand_dense_trunk_to_moe

from test_trainer_e2e import make_checkpoint_dir

BASE = dict(n_embd=32, n_layer=4, n_head=2, n_inner=64, vocab_size=128, n_positions=32, pad_token_id=0,
            type_vocab_size=0)
ACTS = {"gated": "swiglu", "plain": "gelu"}
ROUTED = 3


@pytest.fixture(scope="module")
def dense_trees():
    """{gated|plain: the dense trunk's numpy tree}, from JAX's init."""
    ids = jnp.ones((1, 8), jnp.int32)
    out = {}
    for kind, act in ACTS.items():
        params = JNomicBert(config=JTrunkConfig(**BASE, activation_function=act)).init(
            jax.random.PRNGKey(0), ids, ids)["params"]
        out[kind] = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return out


def _moe_kw(kind, ffn_div, shared):
    return dict(BASE, activation_function=ACTS[kind], num_experts=ROUTED + shared, moe_top_k=2,
                moe_every_n_layers=2, ffn_div=ffn_div, num_shared_experts=shared)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("kind", list(ACTS))
@pytest.mark.parametrize("ffn_div", [1, 2])
def test_expanded_tree_equals_jax(dense_trees, ffn_div, kind, shared):
    kw = _moe_kw(kind, ffn_div, shared)
    want = flax_to_torch(j_expand(dense_trees[kind], JTrunkConfig(**kw)))
    got = flax_to_torch(expand_dense_trunk_to_moe(dense_trees[kind], TrunkConfig(**kw)))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    experts = "w_up" if kind == "gated" else "w_in"
    assert {f"layers.{i}.mlp.{experts}" for i in (1, 3)} <= set(got) and "layers.0.mlp.fc2.weight" in got
    assert ("layers.1.mlp.shared_down.weight" in got) == bool(shared)


def test_replicate_rows_pools_the_remainder():
    w = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out = _replicate_rows(w, ffn_dim=4, num_experts=3, n_inner=8)  # 12 rows: one repeat, 4 pooled
    np.testing.assert_array_equal(out[:8], w)
    np.testing.assert_array_equal(out[8:], w.reshape(4, 2, 3).mean(axis=1))


def _nomic_dense_checkpoint(path):
    from safetensors.torch import save_file

    cfg = j_preset(n_layer=4, n_embd=128, n_head=2, n_inner=256, vocab_size=128, attn_impl="sdpa")
    ids = jnp.ones((1, 8), jnp.int32)
    params = JNomicBert(config=cfg).init(jax.random.PRNGKey(3), ids, attention_mask=ids)
    path.mkdir()
    with open(path / "config.json", "w") as f:
        json.dump(trunk_config_to_nomic_hf_dict(cfg), f)
    sd = flax_to_nomic_state_dict(params["params"], cfg)
    save_file({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, str(path / "model.safetensors"))
    return str(path)


@pytest.mark.parametrize("layout", ["nomic", "bert"])
def test_load_biencoder_upcycles_a_dense_checkpoint_as_jax(tmp_path, layout):
    path = _nomic_dense_checkpoint(tmp_path / "nomic") if layout == "nomic" else make_checkpoint_dir(tmp_path)
    args = dict(model_type="encoder", model_name=path, pooling="mean", pretrained=True, attn_impl="sdpa",
                num_experts=4, moe_top_k=2, moe_every_n_layers=2, ffn_div=1)
    jm, jparams, jcfg = j_load_biencoder(JModelArgs(**args))
    tm, tcfg = load_biencoder(ModelArgs.from_dict(args), device="cpu")
    assert tcfg.num_experts == jcfg.num_experts == 4 and tcfg.activation_function == jcfg.activation_function
    want = flax_to_torch(jax.device_get(jparams))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # ffn_div 1: every expert of an MoE layer is the dense MLP, bit for bit
    gated = layout == "nomic"
    for i in range(1, tcfg.n_layer, 2):
        up = got[f"trunk.layers.{i}.mlp.{'w_up' if gated else 'w_in'}"]
        assert all(torch.equal(up[e], up[0]) for e in range(4))
        assert all(torch.equal(got[f"trunk.layers.{i}.mlp.w_down"][e], got[f"trunk.layers.{i}.mlp.w_down"][0])
                   for e in range(4))

    rng = np.random.default_rng(0)
    ids = rng.integers(5, 100, size=(3, 12))
    mask = (np.arange(12)[None] < np.array([12, 9, 5])[:, None]).astype(np.int64)
    j_emb = jm.apply(jparams, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))["embedding"]
    with torch.no_grad():
        t_emb = tm(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"]
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), atol=1e-4, rtol=1e-4)
