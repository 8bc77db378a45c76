"""The port's vision trunk against the JAX package, at tiny sizes (2 layers,
width 64, 4 heads of 16, 32 x 32 images, patch 8), in fp32 on the CPU.

Each preset's HF or timm state dict goes through both remaps (JAX's
`vit_state_dict_to_flax` / `timm_state_dict_to_flax` and the port's
`*_to_torch`), which must give the same tensors as `convert.flax_to_torch`
of JAX's tree; then both ViTModels run the same pixels. Tolerances:
last_hidden_state max abs error <= 1e-4 for every preset (HF ViT, ViT-MAE,
CLIP-vision, DINOv2, the synthetic timm EVA02 state dict, the rope +
register + GAP preset); the 2-D rope table bit for bit, its application
within 1e-6; the position-table resize (up and down) within 1e-5 of
values of order 1 (the two einsums sum in other orders); the MAP
head, a layer-scale + norm_mlp block and the vision BiEncoder within 1e-5.
The port runs attn_impl="flash" where JAX runs "sdpa": on CPU tensors the
port's flash path is the kernels' plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastors_tpu.layers import embeddings as jemb
from contrastors_tpu.layers import rotary as jrot
from contrastors_tpu.layers.attention import MultiHeadAttentionPooling as JMAP
from contrastors_tpu.layers.block import Block as JBlock
from contrastors_tpu.models.biencoder import BiEncoder as JBiEncoder
from contrastors_tpu.models.hf_interop import torch_state_dict_to_numpy
from contrastors_tpu.models.hf_interop_timm import timm_name_to_trunk_config as j_timm_cfg
from contrastors_tpu.models.hf_interop_timm import timm_state_dict_to_flax
from contrastors_tpu.models.hf_interop_vit import vit_config_to_trunk_config as j_vit_cfg
from contrastors_tpu.models.hf_interop_vit import vit_state_dict_to_flax
from contrastors_tpu.models.vit import ViTModel as JViT
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.layers import embeddings as temb
from contrastors_tpu_torch.layers import rotary as trot
from contrastors_tpu_torch.layers.attention import MultiHeadAttentionPooling
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.models import BiEncoder, ViTModel
from contrastors_tpu_torch.models.hf_interop_timm import timm_name_to_trunk_config, timm_state_dict_to_torch
from contrastors_tpu_torch.models.hf_interop_vit import vit_config_to_trunk_config, vit_state_dict_to_torch
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, image_size=32,
            patch_size=8)
TIMM_TINY = dict(n_embd=64, n_layer=2, n_head=4, n_inner=128, img_size=32, patch_size=8, ref_feat_shape=(4, 4))


def _pixels(seed=0, b=2):
    return np.random.default_rng(seed).normal(size=(b, 3, 32, 32)).astype(np.float32)


def _hf(kind):
    """(HF model, its config dict, the remap's model_type) of a tiny HF vision model."""
    import transformers as tf

    torch.manual_seed(0)
    if kind == "vit":
        cfg = tf.ViTConfig(**TINY, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        return tf.ViTModel(cfg, add_pooling_layer=False), cfg.to_dict(), "vit"
    if kind == "vit_mae":
        cfg = tf.ViTMAEConfig(**TINY, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, mask_ratio=0.0)
        return tf.ViTMAEModel(cfg), cfg.to_dict(), "vit_mae"
    if kind == "clip":
        cfg = tf.CLIPVisionConfig(**TINY, hidden_act="quick_gelu", attention_dropout=0.0)
        return tf.CLIPVisionModel(cfg), cfg.to_dict(), "clip_vision_model"
    cfg = tf.Dinov2Config(**TINY, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, layerscale_value=0.5)
    return tf.Dinov2Model(cfg), cfg.to_dict(), "dinov2"


def _eva02_state_dict(seed=0):
    """The synthetic timm EVA02 state dict of tests/test_vit_parity.py, with
    nonzero biases and norm parameters."""
    rng = np.random.default_rng(seed)
    D, F, P = 64, 128, 8

    def r(*shape, s=0.02):
        return (rng.normal(size=shape) * s).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(D, 3, P, P), "patch_embed.proj.bias": r(D),
          "cls_token": r(1, 1, D), "pos_embed": r(1, 17, D)}
    for i in range(2):
        b = f"blocks.{i}"
        sd.update({f"{b}.attn.q_proj.weight": r(D, D, s=0.2), f"{b}.attn.k_proj.weight": r(D, D, s=0.2),
                   f"{b}.attn.v_proj.weight": r(D, D, s=0.2), f"{b}.attn.q_bias": r(D), f"{b}.attn.v_bias": r(D),
                   f"{b}.attn.proj.weight": r(D, D, s=0.1), f"{b}.attn.proj.bias": r(D),
                   f"{b}.mlp.fc1_x.weight": r(F, D, s=0.1), f"{b}.mlp.fc1_x.bias": r(F),
                   f"{b}.mlp.fc1_g.weight": r(F, D, s=0.1), f"{b}.mlp.fc1_g.bias": r(F),
                   f"{b}.mlp.fc2.weight": r(D, F, s=0.1), f"{b}.mlp.fc2.bias": r(D),
                   f"{b}.mlp.norm.weight": 1 + r(F), f"{b}.mlp.norm.bias": r(F)})
        for n in ("norm1", "norm2"):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = 1 + r(D), r(D)
    return sd


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _run_both(jcfg, params, tcfg, px):
    ref = jax.jit(JViT(config=jcfg).apply)(params, jnp.asarray(px))["last_hidden_state"]
    model = ViTModel(tcfg, device="cpu").eval()
    model.load_state_dict(flax_to_torch(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(px))["last_hidden_state"]
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("kind", ["vit", "vit_mae", "clip", "dinov2"])
def test_hf_vision_presets_match_jax(kind):
    """HF ViT, ViT-MAE, CLIP-vision and DINOv2: the remap equals JAX's, and
    last_hidden_state within 1e-4."""
    hf, hf_cfg, model_type = _hf(kind)
    sd = torch_state_dict_to_numpy(hf.state_dict())
    jcfg = j_vit_cfg(hf_cfg, attn_impl="sdpa")
    tcfg = vit_config_to_trunk_config(hf_cfg, attn_impl="flash")
    params = vit_state_dict_to_flax(dict(sd), jcfg, model_type)
    _same_state(vit_state_dict_to_torch(dict(sd), tcfg, model_type), flax_to_torch(params))
    ref, out = _run_both(jcfg, params, tcfg, _pixels(1))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4


def test_timm_eva02_matches_jax():
    """EVA02: split q/k/v with q_bias, v_bias and zeros for k's, fc1_x / fc1_g
    as fc11 / fc12, the post-activation LN, 2-D rope, no final LN."""
    sd = _eva02_state_dict()
    name = "timm/vit_eva02_base_patch16_224.mim_in22k"
    jcfg = j_timm_cfg(name, attn_impl="sdpa", **TIMM_TINY)
    tcfg = timm_name_to_trunk_config(name, attn_impl="flash", **TIMM_TINY)
    assert tcfg.norm_mlp and tcfg.no_last_ln and tcfg.use_rotary_pos_emb
    params = timm_state_dict_to_flax(dict(sd), jcfg)
    torch_sd = timm_state_dict_to_torch(dict(sd), tcfg)
    _same_state(torch_sd, flax_to_torch(params))
    assert torch.equal(torch_sd["layers.0.attn.Wqkv.bias"][64:128], torch.zeros(64))
    ref, out = _run_both(jcfg, params, tcfg, _pixels(2))
    assert out.shape == (2, 17, 64)
    assert np.abs(out - ref).max() <= 1e-4


def test_eva02_preset_sizes_its_mlp_without_rounding():
    cfg = timm_name_to_trunk_config("timm/vit_eva02_base_patch16_224")
    assert cfg.n_inner == int(768 * 8 / 3) == 2048
    model = ViTModel(cfg.replace(n_layer=1), device="cpu")
    assert model.layers[0].mlp.fc11.weight.shape == (2048, 768)
    assert model.layers[0].mlp.norm.weight.shape == (2048,)


def test_rope_register_gap_preset_matches_jax():
    """timm's rope + 1 register preset (no cls token, no position table,
    layer scale, no final LN) with its global average pool (global_pool,
    which the preset leaves to the caller): [B, D] out."""
    name = "vit_base_patch16_rope_reg1_gap_256"
    jcfg = j_timm_cfg(name, attn_impl="sdpa", global_pool="avg", **TIMM_TINY)
    tcfg = timm_name_to_trunk_config(name, attn_impl="flash", global_pool="avg", **TIMM_TINY)
    params = JViT(config=jcfg).init(jax.random.PRNGKey(4), jnp.zeros((1, 3, 32, 32)))
    # layer scale away from its 1e-5 init, so the blocks count
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 3e4 if jax.tree_util.keystr(p).endswith("['ls1']") or
        jax.tree_util.keystr(p).endswith("['ls2']") else x, params)
    ref, out = _run_both(jcfg, params, tcfg, _pixels(3))
    assert out.shape == (2, 64)
    assert np.abs(out - ref).max() <= 1e-4


@pytest.mark.parametrize("dim,shape,ref_shape", [(16, (4, 4), (4, 4)), (64, (14, 14), (14, 14)),
                                                 (64, (16, 16), (14, 14)), (32, (3, 5), None)])
def test_2d_rope_table_is_jax_bit_for_bit(dim, shape, ref_shape):
    ref = np.asarray(jrot.build_2d_rope_cat(dim, shape, ref_feat_shape=ref_shape))
    out = trot.build_2d_rope_cat(dim, shape, ref_feat_shape=ref_shape, device="cpu").numpy()
    assert ref.dtype == out.dtype == np.float32
    assert np.array_equal(ref, out)


@pytest.mark.parametrize("n_prefix", [0, 1, 4])
def test_2d_rope_application_matches_jax(n_prefix):
    rng = np.random.default_rng(n_prefix)
    rope = jrot.build_2d_rope_cat(16, (4, 4))
    x = rng.normal(size=(2, 16 + n_prefix, 4, 16)).astype(np.float32)
    rope_t = torch.from_numpy(np.array(rope))
    ref = jrot.apply_rope_cat_prefixed(jnp.asarray(x), rope, n_prefix)
    out = trot.apply_rope_cat_prefixed(torch.from_numpy(x), rope_t, n_prefix)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # the prefix rows are untouched, and the plain form agrees on the rest
    np.testing.assert_array_equal(out.numpy()[:, :n_prefix], x[:, :n_prefix])
    plain = trot.apply_rope_cat(torch.from_numpy(x[:, n_prefix:]).transpose(1, 2),
                                rope_t).transpose(1, 2)
    np.testing.assert_allclose(out.numpy()[:, n_prefix:], plain.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,dst,has_cls", [(4, 7, True), (7, 4, True), (14, 16, False), (16, 5, False)])
def test_position_table_resize_matches_jax(src, dst, has_cls):
    """JAX's cubic resize (Keys a = -0.5, antialiased when it shrinks), up
    and down, within 1e-5; torch's bicubic is another function (> 1e-3 away)."""
    rng = np.random.default_rng(src * dst)
    table = rng.normal(size=(1, src * src + has_cls, 8)).astype(np.float32)
    target = dst * dst + has_cls
    ref = np.asarray(jemb.interpolate_pos_embed(jnp.asarray(table), target, has_cls=has_cls))
    out = temb.interpolate_pos_embed(torch.from_numpy(table), target, has_cls=has_cls).numpy()
    assert out.shape == ref.shape == (1, target, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    grid = torch.from_numpy(table[:, has_cls:].reshape(1, src, src, 8)).permute(0, 3, 1, 2)
    torch_bicubic = torch.nn.functional.interpolate(grid, size=(dst, dst), mode="bicubic", align_corners=False)
    assert np.abs(torch_bicubic.permute(0, 2, 3, 1).reshape(1, -1, 8).numpy() - out[:, has_cls:]).max() > 1e-3


def test_position_table_resize_inside_the_forward_matches_jax():
    """A 32 x 32 checkpoint fed 48 x 48 images: the learned table resized in
    the forward (and its gradient flows through the resize)."""
    hf, hf_cfg, _ = _hf("vit")
    sd = torch_state_dict_to_numpy(hf.state_dict())
    jcfg, tcfg = j_vit_cfg(hf_cfg, attn_impl="sdpa"), vit_config_to_trunk_config(hf_cfg, attn_impl="flash")
    params = vit_state_dict_to_flax(dict(sd), jcfg, "vit")
    px = np.random.default_rng(5).normal(size=(2, 3, 48, 48)).astype(np.float32)
    ref, out = _run_both(jcfg, params, tcfg, px)
    assert out.shape == (2, 37, 64)
    assert np.abs(out - ref).max() <= 1e-4
    model = ViTModel(tcfg, device="cpu")
    model(torch.from_numpy(px))["last_hidden_state"].sum().backward()
    assert float(model.embeddings.pos_embed.grad.abs().sum()) > 0


def test_sincos_table_matches_jax():
    for dim, grid in ((64, 4), (96, 7)):
        np.testing.assert_array_equal(temb.sincos_2d_pos_embed(dim, grid), jemb.sincos_2d_pos_embed(dim, grid))


def _eva_cfg(jax_side, **over):
    fn = j_timm_cfg if jax_side else timm_name_to_trunk_config
    return fn("vit_eva02_base_patch16_224", attn_impl="sdpa" if jax_side else "flash", **dict(TIMM_TINY, **over))


def test_map_pooling_matches_jax():
    """The MAP head: one latent query through sdpa, then hidden +
    mlp(norm(attn)) at token 0 (its MLP is the trunk's: SwiGLU with norm_mlp)."""
    h = np.random.default_rng(6).normal(size=(3, 17, 64)).astype(np.float32)
    jm = JMAP(config=_eva_cfg(True))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(h))
    ref = jm.apply(params, jnp.asarray(h))
    tm = MultiHeadAttentionPooling(_eva_cfg(False), device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    out = tm(torch.from_numpy(h))
    assert out.shape == (3, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_block_with_layer_scale_and_norm_mlp_matches_jax():
    """A prenorm block with layer scale (ls1 / ls2 away from their init),
    the post-activation LN and the 2-D rope: hidden and residual."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = _eva_cfg(True, layer_scale=True, layer_scale_init=0.3), _eva_cfg(False, layer_scale=True,
                                                                                   layer_scale_init=0.3)
    h = rng.normal(size=(2, 17, 64)).astype(np.float32)
    r = rng.normal(size=(2, 17, 64)).astype(np.float32)
    rope = jrot.build_2d_rope_cat(16, (4, 4))
    jb = JBlock(config=jcfg)
    params = jb.init(jax.random.PRNGKey(2), jnp.asarray(h), jnp.asarray(r), rope=rope)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * jnp.linspace(0.5, 2.0, x.shape[0]) if "ls" in jax.tree_util.keystr(p) else x, params)
    ref_h, ref_r, _ = jb.apply(params, jnp.asarray(h), jnp.asarray(r), rope=rope)
    tb = Block(tcfg, device="cpu")
    tb.load_state_dict(flax_to_torch(params), strict=True)
    out_h, out_r, _ = tb(torch.from_numpy(h), torch.from_numpy(r), rope=torch.from_numpy(np.asarray(rope)))
    np.testing.assert_allclose(out_h.detach().numpy(), np.asarray(ref_h), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_r.detach().numpy(), np.asarray(ref_r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("pooling,projection_dim", [("map", None), ("cls", 32)])
def test_vision_biencoder_matches_jax(pooling, projection_dim):
    """The vision BiEncoder on EVA02: pooling, projection, normalisation;
    and the embedding's gradient w.r.t. every parameter within 1e-4
    relative L2."""
    px = _pixels(8, b=3)
    jm = JBiEncoder(config=_eva_cfg(True), trunk_type="vision", pooling=pooling, projection_dim=projection_dim)
    params = jm.init(jax.random.PRNGKey(3), pixel_values=jnp.asarray(px))
    w = np.random.default_rng(9).normal(size=(3, projection_dim or 64)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, pixel_values=jnp.asarray(px))["embedding"] * w)

    ref, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    tm = BiEncoder(_eva_cfg(False), trunk_type="vision", pooling=pooling, projection_dim=projection_dim,
                   device="cpu")
    tm.load_state_dict(flax_to_torch(params), strict=True)
    emb = tm(pixel_values=torch.from_numpy(px))["embedding"]
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(jm.apply(params, pixel_values=jnp.asarray(px))
                                                                ["embedding"]), atol=1e-5, rtol=0)
    (emb * torch.from_numpy(w)).sum().backward()
    assert abs(float((emb.detach() * torch.from_numpy(w)).sum()) - float(ref)) <= 1e-4
    want = flax_to_torch(jax.device_get(jgrads))
    for name, p in tm.named_parameters():
        rel = float((p.grad - want[name]).norm() / want[name].norm().clamp_min(1e-12))
        assert rel <= 1e-4, (name, rel)


def test_frozen_biencoder_runs_its_trunk_without_gradients():
    """freeze: the trunk gets no gradient (JAX's stop_gradient), the head does."""
    tm = BiEncoder(_eva_cfg(False), trunk_type="vision", pooling="map", freeze=True, device="cpu")
    tm(pixel_values=torch.from_numpy(_pixels(1)))["embedding"].sum().backward()
    assert all(p.grad is None for p in tm.trunk.parameters())
    assert all(p.grad is not None for p in tm.selector.parameters())


def test_drop_path_follows_jax_shifted_schedule_and_replays_under_remat():
    """Block i drops at dpr[i - 1] and dpr[i] (linspace(0, rate, n_layer));
    in training mode the noise is a function of the generator's seed, and
    activation checkpointing replays it bit for bit."""
    cfg = _eva_cfg(False, drop_path_rate=0.3, n_layer=3)
    dpr = np.linspace(0.0, 0.3, 3)
    model = ViTModel(cfg, device="cpu")
    assert [(b.drop_path_rate1, b.drop_path_rate2) for b in model.layers] == [
        (0.0, float(dpr[0])), (float(dpr[0]), float(dpr[1])), (float(dpr[1]), float(dpr[2]))]
    px = torch.from_numpy(_pixels(4, b=8))
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(px)
    outs = {}
    for remat in (False, True):
        m = ViTModel(cfg, device="cpu", remat=remat).train()
        m.load_state_dict(model.state_dict())
        h = m(px, generator=torch.Generator().manual_seed(11))["last_hidden_state"]
        h.square().sum().backward()
        outs[remat] = (h.detach(), [p.grad.clone() for p in m.parameters()])
    assert torch.equal(outs[False][0], outs[True][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[False][1], outs[True][1]))
    other = model(px, generator=torch.Generator().manual_seed(12))["last_hidden_state"]
    assert not torch.equal(other, outs[False][0])
    model.eval()
    assert torch.equal(model(px)["last_hidden_state"], model(px)["last_hidden_state"])
