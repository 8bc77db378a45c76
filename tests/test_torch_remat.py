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


@pytest.mark.parametrize("model_type,extra,match", [
    ("gpt_neox", {}, "item 8"),
    ("vit", {}, "item 7"),
    ("modernbert", {}, "item 9"),
    ("nomic_bert", dict(num_experts=4, moe_top_k=2, moe_every_n_layers=2), "item 5"),
    ("timm", {}, "item 7"),
])
def test_load_biencoder_names_the_roadmap_item_of_each_unported_family(tmp_path, model_type, extra, match):
    """Decoder, vision (timm included) and ModernBERT checkpoints, and a
    dense checkpoint into an MoE config, raise NotImplementedError."""
    path = "timm/vit_base_patch16_224"
    if model_type != "timm":
        cfg = dict(model_type=model_type, n_embd=128, n_layer=2, n_head=2, n_inner=256, vocab_size=64)
        with open(tmp_path / "config.json", "w") as f:
            json.dump(cfg, f)
        (tmp_path / "pytorch_model.bin").write_bytes(b"")
        path = str(tmp_path)
    args = ModelArgs.from_dict(dict(model_type="encoder", model_name=path, pretrained=True, **extra))
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, {match}"):
        load_biencoder(args, device="cpu")
