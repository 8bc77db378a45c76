"""timm checkpoints: named presets and the state-dict remap, counterpart of
`contrastors_tpu/models/hf_interop_timm.py`.

`TIMM_PRESETS` holds the architecture of the four supported timm names
(plain ViT-B/16, DINOv2 with 4 registers, the rope + register + GAP
variant, and EVA02-B/16: 2-D rope, SwiGLU with the post-activation LN, no
final LN), so `pretrained: false` needs no file. The remap takes timm
naming (blocks.N.*, cls_token, pos_embed, patch_embed.proj), EVA's split
q/k/v projections with q_bias and v_bias and no k bias (zeros in Wqkv's k
part) and fc1_x / fc1_g as fc11 / fc12; it builds JAX's nested tree and
hands it to `convert.flax_to_torch`.
"""

from typing import Any, Dict

import numpy as np
import torch

from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models.model_config import TrunkConfig

Array = np.ndarray


def _t(w):
    return np.ascontiguousarray(w.T)


TIMM_PRESETS: Dict[str, Dict[str, Any]] = {
    "vit_base_patch16_224": dict(
        patch_size=16, n_embd=768, n_layer=12, n_head=12, n_inner=3072,
        activation_function="gelu", img_size=224, layer_norm_epsilon=1e-6,
    ),
    "vit_base_patch14_reg4_dinov2": dict(
        patch_size=14, n_embd=768, n_layer=12, n_head=12, n_inner=3072,
        activation_function="gelu", img_size=518, layer_norm_epsilon=1e-6,
        layer_scale=True, layer_scale_init=1e-5, register_tokens=4,
        learned_pos_embedding=True, no_embed_class=True,
    ),
    "vit_base_patch16_rope_reg1_gap_256": dict(
        # 224/(14,14) despite the _256 name — deliberate in the reference
        # ("to use 256, change ref_feat_shape to (16,16)", timm_vit.py:59-62)
        patch_size=16, n_embd=768, n_layer=12, n_head=12, n_inner=3072,
        activation_function="gelu", img_size=224, layer_norm_epsilon=1e-6,
        layer_scale=True, layer_scale_init=1e-5, register_tokens=1,
        no_embed_class=True, no_cls_token=True, use_pos_embed=False,
        use_rotary_pos_emb=True, ref_feat_shape=(14, 14), no_last_ln=True,
    ),
    "vit_eva02_base_patch16_224": dict(
        patch_size=16, n_embd=768, n_layer=12, n_head=12,
        n_inner=int(768 * 8 / 3),  # mlp_ratio 8/3 (swiglu halves the ratio)
        activation_function="swiglu", img_size=224, layer_norm_epsilon=1e-6,
        use_rotary_pos_emb=True, ref_feat_shape=(14, 14), use_pos_embed=True,
        no_last_ln=True, norm_mlp=True,
    ),
}


def normalize_timm_name(name: str) -> str:
    name = name.replace("timm/", "").replace("hf-hub:", "")
    name = name.split("/")[-1]
    return name.split(".")[0]


def timm_name_to_trunk_config(name: str, **overrides) -> TrunkConfig:
    preset = TIMM_PRESETS[normalize_timm_name(name)]
    kw = dict(
        vocab_size=1,
        n_positions=0,
        prenorm=True,
        causal=False,
        resid_pdrop=0.0,
        embd_pdrop=0.0,
        attn_pdrop=0.0,
    )
    kw.update(preset)
    kw.update(overrides)
    return TrunkConfig(**kw)


def _timm_tree(sd: Dict[str, Array], config: TrunkConfig) -> dict:
    """The JAX remap's nested tree (JAX `timm_state_dict_to_flax`)."""
    sd = {k: v for k, v in sd.items() if not k.startswith(("head", "fc_norm"))}
    trunk: dict = {}

    def set_(path, v):
        node = trunk
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    pw = sd.pop("patch_embed.proj.weight")  # conv [D, C, p, p]
    set_("embeddings/proj/kernel", _t(pw.reshape(pw.shape[0], -1)))
    if "patch_embed.proj.bias" in sd:
        set_("embeddings/proj/bias", sd.pop("patch_embed.proj.bias"))
    if "cls_token" in sd:
        set_("embeddings/cls_token", sd.pop("cls_token"))
    if "pos_embed" in sd and config.use_pos_embed:
        set_("embeddings/pos_embed", sd.pop("pos_embed"))
    if "reg_token" in sd:
        set_("embeddings/reg_token", sd.pop("reg_token"))

    for i in range(config.n_layer):
        pre = f"blocks.{i}"
        dst = f"layers_{i}"
        if f"{pre}.attn.qkv.weight" in sd:
            set_(f"{dst}/attn/Wqkv/kernel", _t(sd.pop(f"{pre}.attn.qkv.weight")))
        else:  # EVA split projections
            w = np.concatenate(
                [sd.pop(f"{pre}.attn.{n}.weight") for n in ("q_proj", "k_proj", "v_proj")], axis=0
            )
            set_(f"{dst}/attn/Wqkv/kernel", _t(w))
        if f"{pre}.attn.qkv.bias" in sd:
            set_(f"{dst}/attn/Wqkv/bias", sd.pop(f"{pre}.attn.qkv.bias"))
        elif f"{pre}.attn.q_bias" in sd:
            q_b = sd.pop(f"{pre}.attn.q_bias")
            k_b = sd.pop(f"{pre}.attn.k_bias", np.zeros_like(q_b))
            v_b = sd.pop(f"{pre}.attn.v_bias")
            set_(f"{dst}/attn/Wqkv/bias", np.concatenate([q_b, k_b, v_b]))
        set_(f"{dst}/attn/out_proj/kernel", _t(sd.pop(f"{pre}.attn.proj.weight")))
        if f"{pre}.attn.proj.bias" in sd:
            set_(f"{dst}/attn/out_proj/bias", sd.pop(f"{pre}.attn.proj.bias"))

        for n in ("norm1", "norm2"):
            set_(f"{dst}/{n}/weight", sd.pop(f"{pre}.{n}.weight"))
            if f"{pre}.{n}.bias" in sd:
                set_(f"{dst}/{n}/bias", sd.pop(f"{pre}.{n}.bias"))

        # mlp: plain fc1/fc2, or gated fc1_x (value) / fc1_g (gate), or w1/w2
        if f"{pre}.mlp.fc1.weight" in sd:
            set_(f"{dst}/mlp/fc1/kernel", _t(sd.pop(f"{pre}.mlp.fc1.weight")))
            if f"{pre}.mlp.fc1.bias" in sd:
                set_(f"{dst}/mlp/fc1/bias", sd.pop(f"{pre}.mlp.fc1.bias"))
        elif f"{pre}.mlp.fc1_x.weight" in sd:
            set_(f"{dst}/mlp/fc11/kernel", _t(sd.pop(f"{pre}.mlp.fc1_x.weight")))
            set_(f"{dst}/mlp/fc12/kernel", _t(sd.pop(f"{pre}.mlp.fc1_g.weight")))
            if f"{pre}.mlp.fc1_x.bias" in sd:
                set_(f"{dst}/mlp/fc11/bias", sd.pop(f"{pre}.mlp.fc1_x.bias"))
                set_(f"{dst}/mlp/fc12/bias", sd.pop(f"{pre}.mlp.fc1_g.bias"))
        if f"{pre}.mlp.fc2.weight" in sd:
            set_(f"{dst}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.mlp.fc2.weight")))
            if f"{pre}.mlp.fc2.bias" in sd:
                set_(f"{dst}/mlp/fc2/bias", sd.pop(f"{pre}.mlp.fc2.bias"))
        if f"{pre}.mlp.norm.weight" in sd:  # EVA post-activation LN
            set_(f"{dst}/mlp/norm/weight", sd.pop(f"{pre}.mlp.norm.weight"))
            set_(f"{dst}/mlp/norm/bias", sd.pop(f"{pre}.mlp.norm.bias"))

        for ls_src, ls_dst in ((f"{pre}.ls1.gamma", "ls1"), (f"{pre}.gamma_1", "ls1"),
                               (f"{pre}.ls2.gamma", "ls2"), (f"{pre}.gamma_2", "ls2")):
            if ls_src in sd:
                set_(f"{dst}/{ls_dst}", sd.pop(ls_src))

    if "norm.weight" in sd and not config.no_last_ln:
        set_("ln_f/weight", sd.pop("norm.weight"))
        set_("ln_f/bias", sd.pop("norm.bias"))
    return trunk


def timm_state_dict_to_torch(sd: Dict[str, Array], config: TrunkConfig) -> Dict[str, torch.Tensor]:
    """A timm state dict (numpy) -> the port's ViTModel state dict."""
    return flax_to_torch(_timm_tree(dict(sd), config))
