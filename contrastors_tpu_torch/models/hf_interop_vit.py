"""HF vision checkpoints (ViT, ViT-MAE, DINO / DINOv2, CLIP-vision) -> the
port's ViT, counterpart of `contrastors_tpu/models/hf_interop_vit.py`
(`vit_config_to_trunk_config`, `vit_state_dict_to_flax`), on numpy dicts.

The remap builds JAX's nested tree and hands it to `convert.flax_to_torch`,
so the naming rules live in one place. Conv patch kernels [D, C, p, p]
flatten to the linear patchify layout ((c p1 p2) columns), which
`PatchEmbedding` reads. The inverse, for export, is
`torch_to_hf_vit_state_dict` (JAX `flax_to_hf_vit_state_dict`), on the
port's state dict: transformers' ViTModel names, the conv kernel rebuilt;
it refuses a trunk whose features that layout cannot hold.
"""

import re
from typing import Any, Dict

import numpy as np
import torch

from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models.model_config import TrunkConfig

Array = np.ndarray


def _t(w):
    return np.ascontiguousarray(w.T)


def vit_config_to_trunk_config(hf: Dict[str, Any], **overrides) -> TrunkConfig:
    mt = hf.get("model_type", "vit")
    if mt == "clip":
        hf = hf["vision_config"]
        mt = "clip_vision_model"
    kw = dict(
        vocab_size=1,  # unused
        n_positions=0,
        n_embd=hf["hidden_size"],
        n_layer=hf["num_hidden_layers"],
        n_head=hf["num_attention_heads"],
        n_inner=hf.get("intermediate_size"),
        activation_function=hf.get("hidden_act", "gelu"),
        layer_norm_epsilon=hf.get("layer_norm_eps", 1e-6),
        initializer_range=hf.get("initializer_range", 0.02),
        prenorm=True,
        causal=False,
        img_size=hf.get("image_size", 224),
        patch_size=hf.get("patch_size", 16),
        num_channels=hf.get("num_channels", 3),
        attn_pdrop=0.0,
        resid_pdrop=0.0,
        embd_pdrop=0.0,
    )
    if mt == "clip_vision_model":
        kw.update(prepre_layernorm=True, patch_embed_bias=False)
    if mt == "vit_mae":
        kw.update(sinusoidal_pos_embedding=True)
    if mt == "dinov2":
        # Dinov2Config sizes its MLP by mlp_ratio, not intermediate_size
        kw.update(n_inner=int(hf.get("mlp_ratio", 4) * hf["hidden_size"]))
        kw.update(
            learned_pos_embedding=True,
            layer_scale=True,
            layer_scale_init=hf.get("layerscale_value", 1.0),
        )
        if hf.get("use_swiglu_ffn", False):
            # Dinov2SwiGLUFFN: hidden = round_up(int(h * ratio * 2/3), 8)
            # (transformers modeling_dinov2.py), NOT ratio * h
            swiglu_hidden = int(hf["hidden_size"] * hf.get("mlp_ratio", 4))
            swiglu_hidden = (int(swiglu_hidden * 2 / 3) + 7) // 8 * 8
            kw.update(activation_function="swiglu", n_inner=swiglu_hidden)
    kw.update(overrides)
    return TrunkConfig(**kw)


def _vit_tree(sd: Dict[str, Array], config: TrunkConfig, model_type: str) -> dict:
    """The JAX remap's nested tree (JAX `vit_state_dict_to_flax`)."""
    if model_type == "clip":
        model_type = "clip_vision_model"
        sd = {k: v for k, v in sd.items() if k.startswith("vision_model.")}
    sd = {re.sub(r"^(vit|vision_model|dinov2)\.", "", k): v for k, v in sd.items()}
    sd = {re.sub(r"^encoder\.", "", k): v for k, v in sd.items()}
    sd = {re.sub(r"^layer\.", "layers.", k): v for k, v in sd.items()}
    sd = {re.sub(r"^layers\.(\d+)\.attention\.attention\.", r"layers.\1.attn.", k): v for k, v in sd.items()}
    sd = {re.sub(r"^layers\.(\d+)\.self_attn\.", r"layers.\1.attn.", k): v for k, v in sd.items()}

    trunk: dict = {}

    def set_(path, v):
        node = trunk
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    # --- patch embedding -----------------------------------------------
    if model_type == "clip_vision_model":
        pw = sd.pop("embeddings.patch_embedding.weight")  # conv [D, C, p, p]
        set_("embeddings/proj/kernel", _t(pw.reshape(pw.shape[0], -1)))
        set_("embeddings/cls_token", sd.pop("embeddings.class_embedding").reshape(1, 1, -1))
        set_("embeddings/pos_embed", sd.pop("embeddings.position_embedding.weight")[None])
        sd.pop("embeddings.position_ids", None)
        if "pre_layrnorm.weight" in sd:  # HF's typo'd name
            set_("prepre_layernorm/weight", sd.pop("pre_layrnorm.weight"))
            set_("prepre_layernorm/bias", sd.pop("pre_layrnorm.bias"))
        if "post_layernorm.weight" in sd:
            set_("ln_f/weight", sd.pop("post_layernorm.weight"))
            set_("ln_f/bias", sd.pop("post_layernorm.bias"))
    else:
        pw = sd.pop("embeddings.patch_embeddings.projection.weight")
        set_("embeddings/proj/kernel", _t(pw.reshape(pw.shape[0], -1)))
        if "embeddings.patch_embeddings.projection.bias" in sd:
            set_("embeddings/proj/bias", sd.pop("embeddings.patch_embeddings.projection.bias"))
        if "embeddings.cls_token" in sd:
            set_("embeddings/cls_token", sd.pop("embeddings.cls_token"))
        if "embeddings.position_embeddings" in sd:
            pos = sd.pop("embeddings.position_embeddings")
            if not config.sinusoidal_pos_embedding:  # MAE's table is fixed
                set_("embeddings/pos_embed", pos)
        if "embeddings.register_tokens" in sd:
            set_("embeddings/reg_token", sd.pop("embeddings.register_tokens"))
        if "layernorm.weight" in sd:
            set_("ln_f/weight", sd.pop("layernorm.weight"))
            set_("ln_f/bias", sd.pop("layernorm.bias"))
        sd.pop("embeddings.mask_token", None)
        sd.pop("pooler.dense.weight", None)
        sd.pop("pooler.dense.bias", None)

    # --- blocks ----------------------------------------------------------
    for i in range(config.n_layer):
        pre = f"layers.{i}"
        dst = f"layers_{i}"
        # attention: separate q/k/v (HF ViT/DINOv2) or fused qkv (CLIP)
        if f"{pre}.attn.query.weight" in sd:
            wq = sd.pop(f"{pre}.attn.query.weight")
            wk = sd.pop(f"{pre}.attn.key.weight")
            wv = sd.pop(f"{pre}.attn.value.weight")
            set_(f"{dst}/attn/Wqkv/kernel", _t(np.concatenate([wq, wk, wv], 0)))
            if f"{pre}.attn.query.bias" in sd:
                b = np.concatenate(
                    [sd.pop(f"{pre}.attn.{n}.bias") for n in ("query", "key", "value")]
                )
                set_(f"{dst}/attn/Wqkv/bias", b)
            out_w = sd.pop(f"{pre}.attention.output.dense.weight")
            out_b = sd.pop(f"{pre}.attention.output.dense.bias", None)
        elif f"{pre}.attn.q_proj.weight" in sd:  # CLIP
            wq = sd.pop(f"{pre}.attn.q_proj.weight")
            wk = sd.pop(f"{pre}.attn.k_proj.weight")
            wv = sd.pop(f"{pre}.attn.v_proj.weight")
            set_(f"{dst}/attn/Wqkv/kernel", _t(np.concatenate([wq, wk, wv], 0)))
            b = np.concatenate([sd.pop(f"{pre}.attn.{n}.bias") for n in ("q_proj", "k_proj", "v_proj")])
            set_(f"{dst}/attn/Wqkv/bias", b)
            out_w = sd.pop(f"{pre}.attn.out_proj.weight")
            out_b = sd.pop(f"{pre}.attn.out_proj.bias", None)
        else:
            raise KeyError(f"no attention weights found for layer {i}")
        set_(f"{dst}/attn/out_proj/kernel", _t(out_w))
        if out_b is not None:
            set_(f"{dst}/attn/out_proj/bias", out_b)

        # norms: HF ViT layernorm_before/after; CLIP layer_norm1/2; dinov2 norm1/2
        for hf_names, mine in (
            (("layernorm_before", "layer_norm1", "norm1"), "norm1"),
            (("layernorm_after", "layer_norm2", "norm2"), "norm2"),
        ):
            for n in hf_names:
                if f"{pre}.{n}.weight" in sd:
                    set_(f"{dst}/{mine}/weight", sd.pop(f"{pre}.{n}.weight"))
                    set_(f"{dst}/{mine}/bias", sd.pop(f"{pre}.{n}.bias"))
                    break

        # layer scale (dinov2)
        if f"{pre}.layer_scale1.lambda1" in sd:
            set_(f"{dst}/ls1", sd.pop(f"{pre}.layer_scale1.lambda1"))
            set_(f"{dst}/ls2", sd.pop(f"{pre}.layer_scale2.lambda1"))

        # mlp: intermediate/output (ViT), mlp.fc1/fc2 (CLIP, dinov2),
        # swiglu weights_in/weights_out (dinov2-giant)
        if f"{pre}.intermediate.dense.weight" in sd:
            set_(f"{dst}/mlp/fc1/kernel", _t(sd.pop(f"{pre}.intermediate.dense.weight")))
            set_(f"{dst}/mlp/fc1/bias", sd.pop(f"{pre}.intermediate.dense.bias"))
            set_(f"{dst}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.output.dense.weight")))
            set_(f"{dst}/mlp/fc2/bias", sd.pop(f"{pre}.output.dense.bias"))
        elif f"{pre}.mlp.fc1.weight" in sd:
            set_(f"{dst}/mlp/fc1/kernel", _t(sd.pop(f"{pre}.mlp.fc1.weight")))
            set_(f"{dst}/mlp/fc1/bias", sd.pop(f"{pre}.mlp.fc1.bias"))
            set_(f"{dst}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.mlp.fc2.weight")))
            set_(f"{dst}/mlp/fc2/bias", sd.pop(f"{pre}.mlp.fc2.bias"))
        elif f"{pre}.mlp.weights_in.weight" in sd:
            # HF SwiGLUFFN: x1, x2 = chunk(weights_in(x)); silu(x1) * x2
            # -> x1 (first half) is the gate = fc12, x2 is the value = fc11
            w_in = sd.pop(f"{pre}.mlp.weights_in.weight")  # [2F, D]
            b_in = sd.pop(f"{pre}.mlp.weights_in.bias")
            F_hid = w_in.shape[0] // 2
            set_(f"{dst}/mlp/fc12/kernel", _t(w_in[:F_hid]))
            set_(f"{dst}/mlp/fc12/bias", b_in[:F_hid])
            set_(f"{dst}/mlp/fc11/kernel", _t(w_in[F_hid:]))
            set_(f"{dst}/mlp/fc11/bias", b_in[F_hid:])
            set_(f"{dst}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.mlp.weights_out.weight")))
            set_(f"{dst}/mlp/fc2/bias", sd.pop(f"{pre}.mlp.weights_out.bias"))
        else:
            raise KeyError(f"no MLP weights found for layer {i}")

    return trunk


def vit_state_dict_to_torch(sd: Dict[str, Array], config: TrunkConfig, model_type: str) -> Dict[str, torch.Tensor]:
    """An HF vision state dict (numpy) -> the port's ViTModel state dict."""
    return flax_to_torch(_vit_tree(dict(sd), config, model_type))


def hf_vit_unsupported(config: TrunkConfig) -> list:
    """The features of a ViT trunk that transformers' ViTModel layout cannot
    hold (EVA02's 2-D rope, SwiGLU with its MLP norm, layer scale, ...):
    an export without them would change the model."""
    from contrastors_tpu_torch.layers.activations import is_gated

    checks = dict(rotary=config.use_rotary_pos_emb, gated_mlp=is_gated(config.activation_function),
                  layer_scale=config.layer_scale, register_tokens=config.register_tokens > 0,
                  norm_mlp=config.norm_mlp, no_cls_token=config.no_cls_token,
                  prepre_layernorm=config.prepre_layernorm, global_pool=config.global_pool is not None,
                  no_last_ln=config.no_last_ln, rms_norm=bool(config.use_rms_norm),
                  no_patch_bias=not config.patch_embed_bias)
    return [name for name, on in checks.items() if on]


def torch_to_hf_vit_state_dict(sd, config: TrunkConfig) -> Dict[str, Array]:
    """The port's `ViTModel` state dict -> transformers ViTModel names, fp32
    numpy (JAX `flax_to_hf_vit_state_dict`): the linear patchify weight
    [D, C*p*p] back to the conv kernel [D, C, p, p], q/k/v split. A trunk
    with a feature that layout lacks (`hf_vit_unsupported`) raises."""
    from contrastors_tpu_torch.models.hf_interop import _numpy_state_dict, _take_all

    bad = hf_vit_unsupported(config)
    if bad:
        raise ValueError(f"transformers' ViTModel cannot hold this trunk's {bad}; it cannot be exported as HF ViT")
    sd = _numpy_state_dict(sd)
    out: Dict[str, Array] = {}
    taken = set()

    def put(dst, src):
        out[dst] = sd[src]
        taken.add(src)

    pk = sd["embeddings.proj.weight"]  # [D, C*p*p]
    ps = config.patch_size
    out["embeddings.patch_embeddings.projection.weight"] = pk.reshape(pk.shape[0], config.num_channels, ps, ps)
    taken.add("embeddings.proj.weight")
    if "embeddings.proj.bias" in sd:
        put("embeddings.patch_embeddings.projection.bias", "embeddings.proj.bias")
    if "embeddings.cls_token" in sd:
        put("embeddings.cls_token", "embeddings.cls_token")
    if "embeddings.pos_embed" in sd:
        put("embeddings.position_embeddings", "embeddings.pos_embed")
    for i in range(config.n_layer):
        src, pre = f"layers.{i}", f"encoder.layer.{i}"
        for leaf in ("weight", "bias"):
            key = f"{src}.attn.Wqkv.{leaf}"
            if key in sd:
                d3 = sd[key].shape[0] // 3
                for j, n in enumerate(("query", "key", "value")):
                    out[f"{pre}.attention.attention.{n}.{leaf}"] = sd[key][j * d3:(j + 1) * d3]
                taken.add(key)
            for mod, name in (("attn.out_proj", "attention.output.dense"), ("norm1", "layernorm_before"),
                              ("norm2", "layernorm_after"), ("mlp.fc1", "intermediate.dense"),
                              ("mlp.fc2", "output.dense")):
                if f"{src}.{mod}.{leaf}" in sd:
                    put(f"{pre}.{name}.{leaf}", f"{src}.{mod}.{leaf}")
    if "ln_f.weight" in sd:
        put("layernorm.weight", "ln_f.weight")
        put("layernorm.bias", "ln_f.bias")
    _take_all(sd, taken, "HF ViT")
    return out
