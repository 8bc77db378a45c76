"""Checkpoint export: the port's trained model -> a Hugging Face directory.

Counterpart of `contrastors_tpu/export.py`. A BiEncoder's trunk becomes
  * model_type "bert" for a vanilla absolute-position trunk, loadable by
    `transformers.BertModel.from_pretrained`;
  * a trust_remote_code package for a rotary / gated-MLP / RMSNorm /
    prenorm trunk (nomic-bert-2048, ModernBERT): model_type "nomic_bert",
    config.json with an auto_map, and the self-contained modeling file
    `modeling_nomic_bert.py`, which this package ships as data
    (`assets/modeling_nomic_bert.py.in`, never imported here: it imports
    transformers), loadable by `AutoModel.from_pretrained(dir,
    trust_remote_code=True)`;
  * model_type "vit" for a ViT trunk that transformers' ViTModel can hold.
Weights go to model.safetensors, as JAX writes them, or with
weights_format="bin" to pytorch_model.bin (torch.save); a missing
`safetensors` package raises and names that option. The state dicts come
from `models/hf_interop.py` and `models/hf_interop_vit.py`.

  python -m contrastors_tpu_torch.export --ckpt_path ckpts/run/step_N \\
      --output export_dir [--vision] [--orig_vocab_size N] \\
      [--weights_format safetensors|bin] [--device cuda]

reads the trainer's checkpoint (`trainers/base.py:save_state`: state.pt and
trunk_config.json in the step directory).
"""

import argparse
import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from contrastors_tpu_torch.models.hf_interop import torch_to_bert_state_dict, torch_to_nomic_state_dict
from contrastors_tpu_torch.models.model_config import TrunkConfig

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "modeling_nomic_bert.py.in")
WEIGHTS_FORMATS = ("safetensors", "bin")


def trunk_config_to_hf_bert_dict(cfg: TrunkConfig, orig_vocab_size: Optional[int] = None) -> dict:
    """Inverse of `bert_config_to_trunk_config`."""
    return {
        "architectures": ["BertModel"],
        "model_type": "bert",
        "vocab_size": orig_vocab_size or cfg.vocab_size,
        "hidden_size": cfg.n_embd,
        "num_hidden_layers": cfg.n_layer,
        "num_attention_heads": cfg.n_head,
        "intermediate_size": cfg.n_inner,
        "hidden_act": cfg.activation_function,
        "hidden_dropout_prob": cfg.resid_pdrop,
        "attention_probs_dropout_prob": cfg.attn_pdrop,
        "max_position_embeddings": cfg.n_positions,
        "type_vocab_size": cfg.type_vocab_size,
        "initializer_range": cfg.initializer_range,
        "layer_norm_eps": cfg.layer_norm_epsilon,
        "pad_token_id": cfg.pad_token_id,
        "position_embedding_type": "absolute",
        # nomic extensions, read by the trust_remote_code model
        "rotary_emb_fraction": cfg.rotary_emb_fraction,
        "rotary_emb_base": cfg.rotary_emb_base,
        "use_rms_norm": cfg.use_rms_norm,
        "qkv_proj_bias": cfg.qkv_proj_bias,
        "mlp_fc1_bias": cfg.mlp_fc1_bias,
        "mlp_fc2_bias": cfg.mlp_fc2_bias,
    }


def _needs_nomic_export(cfg: TrunkConfig) -> bool:
    """A vanilla BertModel ignores the rotary / gated-MLP / RMSNorm keys, so
    such a trunk exported as model_type "bert" would give other embeddings:
    it needs the trust_remote_code package."""
    from contrastors_tpu_torch.layers.activations import is_gated

    return cfg.rotary_emb_fraction > 0 or is_gated(cfg.activation_function) or bool(cfg.use_rms_norm)


def trunk_config_to_nomic_hf_dict(cfg: TrunkConfig, orig_vocab_size: Optional[int] = None) -> dict:
    return {
        "architectures": ["NomicBertModel"],
        "model_type": "nomic_bert",
        "auto_map": {
            "AutoConfig": "modeling_nomic_bert.NomicBertConfig",
            "AutoModel": "modeling_nomic_bert.NomicBertModel",
            "AutoModelForMaskedLM": "modeling_nomic_bert.NomicBertForMaskedLM",
        },
        "vocab_size": orig_vocab_size or cfg.vocab_size,
        "hidden_size": cfg.n_embd,
        "num_hidden_layers": cfg.n_layer,
        "num_attention_heads": cfg.n_head,
        "intermediate_size": cfg.n_inner,
        "hidden_act": cfg.activation_function,
        "hidden_dropout_prob": cfg.resid_pdrop,
        "attention_probs_dropout_prob": cfg.attn_pdrop,
        "max_position_embeddings": cfg.n_positions,
        "type_vocab_size": cfg.type_vocab_size,
        "initializer_range": cfg.initializer_range,
        "layer_norm_eps": cfg.layer_norm_epsilon,
        "pad_token_id": cfg.pad_token_id,
        "rotary_emb_fraction": cfg.rotary_emb_fraction,
        "rotary_emb_base": cfg.rotary_emb_base,
        "rotary_emb_interleaved": cfg.rotary_emb_interleaved,
        "max_trained_positions": cfg.max_trained_positions,
        "qkv_proj_bias": cfg.qkv_proj_bias,
        "mlp_fc1_bias": cfg.mlp_fc1_bias,
        "mlp_fc2_bias": cfg.mlp_fc2_bias,
        "use_rms_norm": bool(cfg.use_rms_norm),
        "norm_bias": bool(cfg.norm_bias),
        "prenorm": bool(cfg.prenorm),
        "skip_first_prenorm": bool(cfg.skip_first_prenorm),
        "sliding_window": cfg.sliding_window,
        "global_attn_every_n_layers": cfg.global_attn_every_n_layers,
        "local_rope_theta": cfg.local_rotary_emb_base,
    }


def trunk_config_to_hf_vit_dict(cfg: TrunkConfig) -> dict:
    return {
        "architectures": ["ViTModel"],
        "model_type": "vit",
        "hidden_size": cfg.n_embd,
        "num_hidden_layers": cfg.n_layer,
        "num_attention_heads": cfg.n_head,
        "intermediate_size": cfg.n_inner,
        "hidden_act": cfg.activation_function,
        "image_size": cfg.img_size,
        "patch_size": cfg.patch_size,
        "num_channels": cfg.num_channels,
        "layer_norm_eps": cfg.layer_norm_epsilon,
        "hidden_dropout_prob": cfg.resid_pdrop,
        "attention_probs_dropout_prob": cfg.attn_pdrop,
        "qkv_bias": cfg.qkv_proj_bias,
    }


def write_weights(sd: Dict[str, np.ndarray], output_dir: str, weights_format: str = "safetensors") -> str:
    """fp32 contiguous weights to model.safetensors or pytorch_model.bin;
    returns the file's path."""
    if weights_format not in WEIGHTS_FORMATS:
        raise ValueError(f"weights_format {weights_format!r}: one of {WEIGHTS_FORMATS}")
    sd = {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()}
    if weights_format == "bin":
        path = os.path.join(output_dir, "pytorch_model.bin")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        return path
    try:
        from safetensors.numpy import save_file
    except ImportError as e:
        raise ImportError("writing model.safetensors needs the `safetensors` package; pass "
                          "weights_format='bin' (--weights_format bin) to write pytorch_model.bin") from e
    path = os.path.join(output_dir, "model.safetensors")
    save_file(sd, path)
    return path


def _write_config(output_dir: str, config: dict):
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


def export_nomic_bert_trunk(trunk_sd, cfg: TrunkConfig, output_dir: str, orig_vocab_size: Optional[int] = None,
                            weights_format: str = "safetensors") -> str:
    """A runnable trust_remote_code package for the rotary / gated / prenorm
    trunks: config.json (model_type nomic_bert, auto_map), the modeling
    file, and the flash-named weights, the word table cut back to
    orig_vocab_size when that is smaller than the padded vocab."""
    sd = torch_to_nomic_state_dict(trunk_sd, cfg)
    if orig_vocab_size and orig_vocab_size < cfg.vocab_size:
        sd["embeddings.word_embeddings.weight"] = sd["embeddings.word_embeddings.weight"][:orig_vocab_size]
    _write_config(output_dir, trunk_config_to_nomic_hf_dict(cfg, orig_vocab_size))
    shutil.copyfile(ASSET, os.path.join(output_dir, "modeling_nomic_bert.py"))
    write_weights(sd, output_dir, weights_format)
    return output_dir


def export_bert_trunk(trunk_sd, cfg: TrunkConfig, output_dir: str, orig_vocab_size: Optional[int] = None,
                      strip_bert_prefix: bool = True, weights_format: str = "safetensors") -> str:
    """trunk_sd: the state dict of the port's NomicBertModel (a BiEncoder's
    `trunk`). Writes config.json and the weights; a trunk a vanilla
    BertModel cannot represent goes to the trust_remote_code package."""
    if _needs_nomic_export(cfg):
        return export_nomic_bert_trunk(trunk_sd, cfg, output_dir, orig_vocab_size, weights_format)
    sd = torch_to_bert_state_dict(trunk_sd, cfg)
    if orig_vocab_size and orig_vocab_size < cfg.vocab_size:
        # un-pad the vocab
        sd["bert.embeddings.word_embeddings.weight"] = sd["bert.embeddings.word_embeddings.weight"][:orig_vocab_size]
    if strip_bert_prefix:
        sd = {k.removeprefix("bert."): v for k, v in sd.items()}
    _write_config(output_dir, trunk_config_to_hf_bert_dict(cfg, orig_vocab_size))
    write_weights(sd, output_dir, weights_format)
    return output_dir


def export_vit_trunk(trunk_sd, cfg: TrunkConfig, output_dir: str, weights_format: str = "safetensors") -> str:
    """The port's ViTModel state dict -> an HF ViTModel directory. A trunk
    whose features transformers' ViT lacks (EVA02's rope and SwiGLU, ...)
    raises (`hf_interop_vit.hf_vit_unsupported`)."""
    from contrastors_tpu_torch.models.hf_interop_vit import torch_to_hf_vit_state_dict

    sd = torch_to_hf_vit_state_dict(trunk_sd, cfg)
    _write_config(output_dir, trunk_config_to_hf_vit_dict(cfg))
    write_weights(sd, output_dir, weights_format)
    return output_dir


def tower_state_dict(model_sd: Dict[str, torch.Tensor], vision: bool = False) -> Dict[str, torch.Tensor]:
    """The trunk's part of a trainer's model state dict: the trainer's
    "model.", a DualEncoder's "vision." tower with vision, then a
    BiEncoder's "trunk." or an MLM / GLUE model's "bert."."""
    for prefix, wanted in (("model.", True), ("vision.", vision), ("trunk.", True), ("bert.", True)):
        if wanted and any(k.startswith(prefix) for k in model_sd):
            model_sd = {k[len(prefix):]: v for k, v in model_sd.items() if k.startswith(prefix)}
    return model_sd


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="export a trainer checkpoint as an HF directory")
    parser.add_argument("--ckpt_path", required=True, help="a step directory the trainer wrote")
    parser.add_argument("--output", required=True)
    parser.add_argument("--config_json", default=None,
                        help="TrunkConfig json (default: trunk_config.json in --ckpt_path)")
    parser.add_argument("--vision", action="store_true")
    parser.add_argument("--orig_vocab_size", type=int, default=None)
    parser.add_argument("--weights_format", default="safetensors", choices=WEIGHTS_FORMATS)
    parser.add_argument("--device", default="cuda", help="where the checkpoint is loaded: cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    from contrastors_tpu_torch._device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    config_json = args.config_json or os.path.join(args.ckpt_path, "trunk_config.json")
    if not os.path.exists(config_json):
        raise SystemExit(f"{config_json} not found: pass --config_json (the trainer writes trunk_config.json)")
    with open(config_json) as f:
        cfg = TrunkConfig.from_json(f.read())
    state = torch.load(os.path.join(args.ckpt_path, "state.pt"), map_location=device, weights_only=True)
    tower = tower_state_dict(state["model"], args.vision)
    if args.vision:
        export_vit_trunk(tower, cfg, args.output, args.weights_format)
    else:
        export_bert_trunk(tower, cfg, args.output, args.orig_vocab_size, weights_format=args.weights_format)
    print(f"exported to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
