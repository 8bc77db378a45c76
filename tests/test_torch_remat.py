"""Activation checkpointing (`remat`) in the port against JAX's `nn.remat`.

A 2-layer nomic-style BiEncoder (rotary, swiglu, D=64) in fp32 with the
same parameters on both sides: the gradients of sum(embedding * w) with
remat equal the port's without it bit for bit (the replay recomputes the
same forward), and equal JAX's BiEncoder(remat=True) within rtol 1e-4 /
atol 1e-6 (fp32 through two different frameworks). With remat each block
runs again in the backward; without it, never. `load_biencoder` sets it
from `gradient_checkpointing`.
"""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.presets import nomic_bert_2048 as j_preset
from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.models import BiEncoder
from contrastors_tpu_torch.models.auto import load_biencoder
from contrastors_tpu_torch.models.presets import nomic_bert_2048 as t_preset
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

SMALL = dict(n_layer=2, n_embd=128, n_head=2, n_inner=256, vocab_size=512)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, size=(3, 20))
    mask = (np.arange(20)[None] < np.array([20, 13, 7])[:, None]).astype(np.int64)
    return ids * mask, mask, rng.standard_normal((3, 128)).astype(np.float32)


def _port_grads(params, remat):
    ids, mask, w = _inputs()
    model = BiEncoder(t_preset(attn_impl="flash", **SMALL), pooling="mean", device="cpu", remat=remat)
    model.load_state_dict(flax_to_torch(params), strict=True)
    calls, forward = [], Block.forward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return forward(self, *args, **kwargs)

    Block.forward = counted
    try:
        emb = model(torch.from_numpy(ids), torch.from_numpy(mask))["embedding"]
        n_forward = len(calls)
        (emb * torch.from_numpy(w)).sum().backward()
    finally:
        Block.forward = forward
    return {n: p.grad.clone() for n, p in model.named_parameters()}, n_forward, len(calls) - n_forward


def test_remat_gradients_match_without_remat_and_jax():
    ids, mask, w = _inputs()
    jm = JBiEncoder(config=j_preset(attn_impl="sdpa", **SMALL), pooling="mean", remat=True)
    params = jm.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))

    def loss(p):
        emb = jm.apply(p, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))["embedding"]
        return (emb * jnp.asarray(w)).sum()

    j_grads = flax_to_torch(jax.device_get(jax.grad(loss)(params)))
    with_remat, fwd_r, replayed = _port_grads(params, remat=True)
    without, fwd_n, replayed_n = _port_grads(params, remat=False)
    assert (fwd_r, replayed, fwd_n, replayed_n) == (2, 2, 2, 0)
    assert set(with_remat) == set(without) == set(j_grads)
    for name in with_remat:
        torch.testing.assert_close(with_remat[name], without[name], rtol=0, atol=0, msg=name)
        torch.testing.assert_close(with_remat[name], j_grads[name], rtol=1e-4, atol=1e-6, msg=name)


@pytest.mark.parametrize("on", [False, True])
def test_load_biencoder_takes_remat_from_gradient_checkpointing(tmp_path, on):
    cfg = dict(model_type="nomic_bert", n_embd=128, n_layer=1, n_head=2, n_inner=256, vocab_size=64,
               activation_function="swiglu", rotary_emb_fraction=1.0)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    args = ModelArgs.from_dict(dict(model_type="encoder", model_name=str(tmp_path), pretrained=False,
                                    gradient_checkpointing=on))
    model, trunk_cfg = load_biencoder(args, device="cpu")
    assert model.trunk.remat is on
    # the config's own activation wins over ModelArgs' default "gelu"
    assert trunk_cfg.activation_function == "swiglu" and hasattr(model.trunk.layers[0].mlp, "fc11")


# a config.json of each family at a small width (D = 64 per head)
FAMILY_CONFIGS = {
    "gpt_neox": dict(model_type="gpt_neox", vocab_size=64, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256, rotary_pct=0.25, use_parallel_residual=True,
                     hidden_act="gelu"),
    "vit": dict(model_type="vit", hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                image_size=32, patch_size=8),
    "modernbert": dict(model_type="modernbert", vocab_size=64, hidden_size=128, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=96, local_attention=8, global_attn_every_n_layers=3,
                       hidden_activation="gelu"),
    "nomic_bert": dict(model_type="nomic_bert", n_embd=128, n_layer=2, n_head=2, n_inner=256, vocab_size=64,
                       activation_function="swiglu", rotary_emb_fraction=1.0, qkv_proj_bias=False,
                       mlp_fc1_bias=False, mlp_fc2_bias=False),
}


@pytest.mark.parametrize("model_type,extra,match", [
    ("gpt_neox", {}, "item 8"),
    ("vit", {}, "item 7"),
    ("modernbert", {}, "item 9"),
    ("nomic_bert", dict(num_experts=4, moe_top_k=2, moe_every_n_layers=2), "item 5"),
    ("timm", {}, "item 7"),
])
def test_load_biencoder_names_the_roadmap_item_of_each_unported_family(tmp_path, model_type, extra, match):
    """Every family the ROADMAP once listed as unported now loads: a GPT-NeoX
    config.json as the causal decoder trunk (ParallelBlocks), ModernBERT as
    the encoder trunk with its window and skipped first prenorm, a dense
    nomic-bert checkpoint into an MoE config upcycled (every expert of an
    MoE layer a copy of the dense MLP), and item 7's HF ViT config.json and
    timm name as vision BiEncoders (MAP pooling by default for a timm
    name)."""
    path = "timm/vit_base_patch16_224"
    if model_type != "timm":
        with open(tmp_path / "config.json", "w") as f:
            json.dump(FAMILY_CONFIGS[model_type], f)
        path = str(tmp_path)
    if match == "item 7":
        args = ModelArgs.from_dict(dict(model_type="encoder", model_name=path, pretrained=False, **extra))
        model, trunk_cfg = load_biencoder(args, device="cpu", trunk_overrides=dict(n_layer=1))
        assert model.trunk_type == "vision" and type(model.trunk).__name__ == "ViTModel"
        assert model.pooling == ("map" if model_type == "timm" else "mean")
        assert trunk_cfg.n_embd == (768 if model_type == "timm" else 64)
        return
    if extra:  # a dense checkpoint of the same config, under the nomic HF names
        dense, _ = load_biencoder(ModelArgs.from_dict(dict(model_type="encoder", model_name=path,
                                                           pretrained=False)), device="cpu", seed=5)
        torch.save({re.sub(r"^layers\.", "encoder.layers.", k): v for k, v in dense.trunk.state_dict().items()},
                   tmp_path / "pytorch_model.bin")
    args = ModelArgs.from_dict(dict(model_type="encoder", model_name=path, pretrained=bool(extra), **extra))
    model, trunk_cfg = load_biencoder(args, device="cpu")
    if model_type == "gpt_neox":
        assert model.trunk_type == "decoder" and trunk_cfg.causal and trunk_cfg.rotary_emb_dim == 16
        assert type(model.trunk.layers[0]).__name__ == "ParallelBlock"
    elif model_type == "modernbert":
        assert model.trunk_type == "encoder" and trunk_cfg.activation_function == "geglu"
        assert model.trunk.layers[0].norm1 is None and model.trunk.layers[1].attn.window == 8
    else:
        sd, dense_sd = model.trunk.state_dict(), dense.trunk.state_dict()
        assert trunk_cfg.num_experts == 4 and torch.equal(sd["layers.0.mlp.fc11.weight"],
                                                          dense_sd["layers.0.mlp.fc11.weight"])
        for e in range(4):
            assert torch.equal(sd["layers.1.mlp.w_up"][e], dense_sd["layers.1.mlp.fc11.weight"].T)
            assert torch.equal(sd["layers.1.mlp.w_gate"][e], dense_sd["layers.1.mlp.fc12.weight"].T)
            assert torch.equal(sd["layers.1.mlp.w_down"][e], dense_sd["layers.1.mlp.fc2.weight"].T)
