"""Model factory: ModelArgs -> BiEncoder, for the encoder and vision
families.

Counterpart of `contrastors_tpu/models/auto.py:load_biencoder`. `model_name`
(or `checkpoint`) is a local directory holding an HF config.json, and with
`pretrained: true` a model.safetensors (safetensors is imported only then)
or a pytorch_model.bin. The same overrides as JAX's are applied to the
trunk config; `pretrained: false` gives the port's seeded random init
(`init_weights`). A timm name (`timm/vit_eva02_base_patch16_224` and the
other `TIMM_PRESETS`) resolves to its preset without any file, and with
`pretrained: true` reads timm-named weights from a local directory of that
name. HF vision checkpoints (vit, vit_mae, clip, clip_vision_model,
dinov2) load through `hf_interop_vit`. Decoder and ModernBERT checkpoints,
and a dense checkpoint loaded into an MoE config, raise
NotImplementedError naming their ROADMAP item.
"""

import json
import os
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from contrastors_tpu_torch.config import ModelArgs
from contrastors_tpu_torch.models.biencoder import BiEncoder
from contrastors_tpu_torch.models.hf_interop import bert_config_to_trunk_config, bert_state_dict_to_torch
from contrastors_tpu_torch.models.hf_interop_timm import (
    TIMM_PRESETS,
    normalize_timm_name,
    timm_name_to_trunk_config,
    timm_state_dict_to_torch,
)
from contrastors_tpu_torch.models.hf_interop_vit import vit_config_to_trunk_config, vit_state_dict_to_torch
from contrastors_tpu_torch.models.model_config import TrunkConfig
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


def _refuse_family(model_type: str, family: str):
    """NotImplementedError for a model family the port has no trunk for."""
    if family == "decoder":
        raise NotImplementedError(f"decoder checkpoints ({model_type}) are not ported yet (ROADMAP Queue 1, item 8)")
    if model_type == "modernbert":
        raise NotImplementedError("ModernBERT checkpoints are not ported yet (ROADMAP Queue 1, item 9: the "
                                  "HF loaders)")


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
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError(
            f"model path {path!r} not found locally. Pass a directory containing an HF "
            "config.json (and model weights for pretrained=true)."
        )
    hf_cfg = _load_hf_config(path)
    model_type = hf_cfg.get("model_type", "bert")
    family = sniff_family(model_type, hf_cfg.get("_name_or_path", ""))
    _refuse_family(model_type, family)

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
    # GPT2-style config such as nomic-bert-2048's swiglu (ROADMAP Queue 3)
    if model_args.activation_function and not any(
            k in hf_cfg for k in ("hidden_act", "hidden_activation", "activation_function")):
        overrides.setdefault("activation_function", model_args.activation_function)
    if family == "vision":
        cfg = vit_config_to_trunk_config(hf_cfg, **overrides)
    else:
        cfg = bert_config_to_trunk_config(types.SimpleNamespace(**hf_cfg), **overrides)

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
        if cfg.num_experts > 0:
            raise NotImplementedError("loading a dense checkpoint into an MoE config (upcycling) is not ported "
                                      "yet (ROADMAP Queue 1, item 5)")
        sd = _load_state_dict(path)
        if sd is None:
            raise FileNotFoundError(f"pretrained=true but no weights found in {path}")
        if family == "vision":
            _load_trunk(module, vit_state_dict_to_torch(sd, cfg, hf_cfg.get("model_type", "vit")))
        else:
            _load_trunk(module, bert_state_dict_to_torch(sd, cfg))
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
