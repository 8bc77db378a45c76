"""Model factory: ModelArgs -> BiEncoder, for every family of the JAX
package.

Counterpart of `contrastors_tpu/models/auto.py:load_biencoder`. `model_name`
(or `checkpoint`) is a local directory holding an HF config.json, and with
`pretrained: true` a model.safetensors (safetensors is imported only then)
or a pytorch_model.bin. The same overrides as JAX's are applied to the
trunk config; `pretrained: false` gives the port's seeded random init
(`init_weights`). The family is sniffed from config.json as JAX sniffs it:
BERT-family and ModernBERT checkpoints load into the encoder trunk
(`hf_interop`), gpt_neox / llama / open_lm / clip_text_model into the
causal decoder (`hf_interop_decoder`), and HF vision checkpoints (vit,
vit_mae, clip, clip_vision_model, dinov2) through `hf_interop_vit`. A timm
name (`timm/vit_eva02_base_patch16_224` and the other `TIMM_PRESETS`)
resolves to its preset without any file, and with `pretrained: true` reads
timm-named weights from a local directory of that name. A dense encoder
checkpoint loaded into an MoE config is upcycled (`moe_interop`): each MoE
layer's experts start as copies of its dense MLP, with a fresh router.
"""

import json
import os
import types
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models import hf_interop_decoder as dec
from contrastors_tpu_torch.models.biencoder import BiEncoder
from contrastors_tpu_torch.models.hf_interop import (
    bert_config_to_trunk_config,
    bert_tree,
    modernbert_config_to_trunk_config,
    modernbert_trunk_tree,
)
from contrastors_tpu_torch.models.hf_interop_timm import (
    TIMM_PRESETS,
    normalize_timm_name,
    timm_name_to_trunk_config,
    timm_state_dict_to_torch,
)
from contrastors_tpu_torch.models.hf_interop_vit import vit_config_to_trunk_config, vit_state_dict_to_torch
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.moe_interop import expand_dense_trunk_to_moe
from contrastors_tpu_torch.models.nomic_bert import init_weights

DECODER_TYPES = ("gpt_neox", "llama", "gpt2", "open_lm", "openlm", "clip_text_model")
VISION_TYPES = ("vit", "vit_mae", "clip", "clip_vision_model", "dinov2")


def _load_hf_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _load_state_dict(path: str) -> Optional[Dict[str, np.ndarray]]:
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        return {k: v.astype(np.float32) for k, v in load_file(st_path).items()}
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    return None


def sniff_family(model_type: str, model_name: str) -> str:
    """encoder | decoder | vision, by JAX's rule (`auto.py:sniff_family`)."""
    name = (model_name or "").lower()
    if model_type in ("bert", "nomic_bert", "roberta", "xlm-roberta", "modernbert"):
        return "encoder"
    if model_type in DECODER_TYPES:
        return "decoder"
    if model_type in VISION_TYPES or "vit" in name or "eva02" in name:
        return "vision"
    return "encoder"


def _encoder_weights(tree_fn):
    """An encoder checkpoint's weights: its Flax-layout tree, upcycled on
    the numpy tree when the config has experts (JAX's step), then carried
    to the port's names."""
    def weights(sd, cfg, hf):
        tree = tree_fn(sd, cfg)
        if cfg.num_experts > 0:
            tree = expand_dense_trunk_to_moe(tree, cfg)
        return flax_to_torch(tree)
    return weights


class FamilyLoader(NamedTuple):
    """How one kind of config.json loads: config.json (and the overrides)
    -> TrunkConfig; (numpy state dict, TrunkConfig, config.json) -> the
    trunk's state dict; and whether the converter fixes the activation
    itself, so that ModelArgs' must not replace it."""
    config: Callable[..., TrunkConfig]
    weights: Callable[[Dict[str, np.ndarray], TrunkConfig, Dict[str, Any]], Dict[str, torch.Tensor]]
    own_activation: bool = False


# by model_type, else by family ("bert" for every other encoder), as JAX's
# `trunk_config_from_hf_dict` and `load_biencoder` dispatch
LOADERS = {
    "vision": FamilyLoader(vit_config_to_trunk_config,
                           lambda sd, cfg, hf: vit_state_dict_to_torch(sd, cfg, hf.get("model_type", "vit"))),
    "decoder": FamilyLoader(dec.decoder_config_to_trunk_config,
                            lambda sd, cfg, hf: dec.decoder_state_dict_to_torch(sd, cfg, hf["model_type"])),
    # a plain MLP could not hold open_lm's fc11 / fc12
    "open_lm": FamilyLoader(dec.open_lm_config_to_trunk_config,
                            lambda sd, cfg, _: dec.open_lm_state_dict_to_torch(sd, cfg), own_activation=True),
    "clip_text_model": FamilyLoader(dec.clip_text_config_to_trunk_config,
                                    lambda sd, cfg, _: dec.clip_text_state_dict_to_torch(sd, cfg),
                                    own_activation=True),
    "modernbert": FamilyLoader(modernbert_config_to_trunk_config, _encoder_weights(modernbert_trunk_tree)),
    "bert": FamilyLoader(lambda hf, **o: bert_config_to_trunk_config(types.SimpleNamespace(**hf), **o),
                         _encoder_weights(bert_tree)),
}


def family_loader(hf: Dict[str, Any]) -> Tuple[str, FamilyLoader]:
    """(family, loader) of a config.json."""
    model_type = hf.get("model_type", "bert")
    family = sniff_family(model_type, hf.get("_name_or_path", ""))
    key = "open_lm" if model_type == "openlm" else model_type
    if family == "vision" or key not in LOADERS:
        key = {"encoder": "bert"}.get(family, family)
    return family, LOADERS[key]


def resolve_trunk_config(model_args: ModelArgs, trunk_overrides: Optional[Dict[str, Any]] = None):
    """(family, loader, config.json, TrunkConfig) of a local checkpoint
    directory, with JAX's overrides applied, before any module is built."""
    path = model_args.checkpoint or model_args.model_name
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError(
            f"model path {path!r} not found locally. Pass a directory containing an HF "
            "config.json (and model weights for pretrained=true)."
        )
    hf_cfg = _load_hf_config(path)
    family, loader = family_loader(hf_cfg)

    overrides = dict(trunk_overrides or {})
    overrides.setdefault("attn_impl", model_args.attn_impl)
    if model_args.num_experts:
        overrides.update(
            num_experts=model_args.num_experts,
            moe_top_k=model_args.moe_top_k,
            moe_every_n_layers=model_args.moe_every_n_layers,
            ffn_div=model_args.ffn_div,
            moe_normalize_expert_weights=model_args.moe_normalize_expert_weights,
            expert_choice_router=model_args.expert_choice_router,
            num_shared_experts=model_args.num_shared_experts,
            # "auto" outside a trainer is one device: dropless
            moe_impl="dropless" if model_args.moe_impl == "auto" else model_args.moe_impl,
        )
    if model_args.pad_vocab_to_multiple_of:
        overrides["pad_vocab_size_multiple"] = model_args.pad_vocab_to_multiple_of
    # ModelArgs.activation_function applies when config.json names no
    # activation. JAX checks only hidden_act / hidden_activation, so the
    # ModelArgs default "gelu" replaces the "activation_function" of a
    # GPT2-style config such as nomic-bert-2048's swiglu (ROADMAP Queue 3).
    # As in JAX, it never applies to open_lm and the CLIP text tower, whose
    # converters fix the activation (`FamilyLoader.own_activation`)
    if model_args.activation_function and not loader.own_activation and not any(
            k in hf_cfg for k in ("hidden_act", "hidden_activation", "activation_function")):
        overrides.setdefault("activation_function", model_args.activation_function)
    return family, loader, hf_cfg, loader.config(hf_cfg, **overrides)


def load_biencoder(
    model_args: ModelArgs,
    dtype=torch.float32,
    device="cuda",
    seed: int = 0,
    trunk_overrides: Optional[Dict[str, Any]] = None,
) -> Tuple[BiEncoder, TrunkConfig]:
    """Returns (module, trunk_config). The module's parameters are fp32 on
    `device` with compute in `dtype`; pretrained weights come from the
    checkpoint, the rest (and every weight with pretrained=false) from
    `init_weights(seed)`."""
    path = model_args.checkpoint or model_args.model_name
    if path is not None and normalize_timm_name(path) in TIMM_PRESETS:
        return _load_timm_biencoder(model_args, path, dtype, device, seed, trunk_overrides)
    family, loader, hf_cfg, cfg = resolve_trunk_config(model_args, trunk_overrides)

    module = BiEncoder(
        cfg,
        trunk_type=family,
        pooling=model_args.pooling or "mean",
        projection_dim=model_args.projection_dim,
        hamming=model_args.hamming,
        freeze=model_args.freeze,
        dtype=dtype,
        device=device,
        remat=model_args.gradient_checkpointing,
    )
    init_weights(module, seed)
    if model_args.pretrained:
        sd = _load_state_dict(path)
        if sd is None:
            raise FileNotFoundError(f"pretrained=true but no weights found in {path}")
        _load_trunk(module, loader.weights(sd, cfg, hf_cfg))
    return module, cfg


def _load_trunk(module: BiEncoder, trunk_sd: Dict[str, torch.Tensor]):
    """Load remapped trunk weights into module.trunk; pooling heads and
    projections keep their init (a partial load). A checkpoint tensor with
    no home, or of the wrong shape, means the config does not match the
    checkpoint."""
    trunk = {"trunk." + k: v for k, v in trunk_sd.items()}
    own = module.state_dict()
    dropped = [k for k in trunk if k not in own]
    if dropped:
        raise ValueError(f"{len(dropped)} remapped checkpoint tensors have no matching module "
                         f"parameter (first few: {dropped[:8]}); the model config does not match "
                         "this checkpoint")
    for k, v in trunk.items():
        if own[k].shape != v.shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} vs {tuple(v.shape)}")
    module.load_state_dict(trunk, strict=False)


def _load_timm_biencoder(model_args: ModelArgs, path: str, dtype, device, seed: int,
                         trunk_overrides: Optional[Dict[str, Any]]) -> Tuple[BiEncoder, TrunkConfig]:
    """A timm name: its preset (MAP pooling by default), and with
    pretrained=true the timm-named weights of a local directory `path`."""
    overrides = dict(trunk_overrides or {})
    overrides.setdefault("attn_impl", model_args.attn_impl)
    if model_args.patch_dropout:
        overrides["patch_dropout"] = model_args.patch_dropout
    cfg = timm_name_to_trunk_config(path, **overrides)
    module = BiEncoder(
        cfg,
        trunk_type="vision",
        pooling=model_args.pooling or "map",
        projection_dim=model_args.projection_dim,
        freeze=model_args.freeze,
        dtype=dtype,
        device=device,
        remat=model_args.gradient_checkpointing,
    )
    init_weights(module, seed)
    if model_args.pretrained:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"pretrained timm weights expected in local dir {path!r} "
                                    "(model.safetensors / pytorch_model.bin with timm naming)")
        sd = _load_state_dict(path)
        if sd is None:
            raise FileNotFoundError(f"no weights found in {path}")
        _load_trunk(module, timm_state_dict_to_torch(sd, cfg))
    return module, cfg
