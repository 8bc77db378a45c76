"""HF decoder checkpoints (GPT-NeoX / Pythia, Llama, open_lm, the CLIP text
tower) -> the port's `DecoderModel`.

Counterpart of `contrastors_tpu/models/hf_interop_decoder.py`, on numpy
dicts: each `*_trunk_tree` builds the same nested tree (flax names, [in,
out] kernels) as JAX's `*_state_dict_to_flax`, and each
`*_state_dict_to_torch` hands it to `convert.flax_to_torch`. What the remaps
keep:
  - GPT-NeoX packs its fused qkv rows per head, (heads, 3, head_dim), and
    they are reordered to q | k | v, (3, heads, head_dim);
  - Llama concatenates q, k and v (GQA-aware), with swiglu fc11 = up and
    fc12 = gate, RMSNorm, rope_theta and a final norm without a bias;
  - open_lm: swiglu sized 8/3 and rounded to 256, the fused in_proj, its
    w12 split into fc12 (the gate, first half) and fc11, and the rotary
    over the head index when `rotary_old` is set;
  - the CLIP text tower is a causal decoder with learned positions.
"""

import re
from typing import Any, Dict

import numpy as np
import torch

from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models.hf_interop import _t, set_path
from contrastors_tpu_torch.models.model_config import TrunkConfig

Array = np.ndarray


def decoder_config_to_trunk_config(hf: Dict[str, Any], **overrides) -> TrunkConfig:
    mt = hf.get("model_type", "gpt_neox")
    if mt == "gpt_neox":
        kw = dict(
            vocab_size=hf["vocab_size"],
            n_positions=0,
            n_embd=hf["hidden_size"],
            n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"],
            n_inner=hf["intermediate_size"],
            activation_function=hf.get("hidden_act", "gelu"),
            layer_norm_epsilon=hf.get("layer_norm_eps", 1e-5),
            initializer_range=hf.get("initializer_range", 0.02),
            prenorm=True,
            parallel_block=hf.get("use_parallel_residual", True),
            rotary_emb_fraction=hf.get("rotary_pct", 0.25),
            rotary_emb_base=hf.get("rotary_emb_base", hf.get("rope_theta", 10_000)),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            use_rms_norm=False,
            causal=True,
            resid_pdrop=0.0,
            embd_pdrop=0.0,
            attn_pdrop=0.0,
        )
    elif mt == "llama":
        kw = dict(
            vocab_size=hf["vocab_size"],
            n_positions=0,
            n_embd=hf["hidden_size"],
            n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"],
            num_heads_kv=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            n_inner=hf["intermediate_size"],
            activation_function="swiglu",
            layer_norm_epsilon=hf.get("rms_norm_eps", 1e-5),
            initializer_range=hf.get("initializer_range", 0.02),
            prenorm=True,
            parallel_block=False,
            rotary_emb_fraction=1.0,
            rotary_emb_base=hf.get("rope_theta", 10_000),
            rope_scaling=hf.get("rope_scaling"),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            qkv_proj_bias=hf.get("attention_bias", False),
            mlp_fc1_bias=hf.get("mlp_bias", False),
            mlp_fc2_bias=hf.get("mlp_bias", False),
            ln_f_bias=False,
            use_rms_norm=True,
            causal=True,
            resid_pdrop=0.0,
            embd_pdrop=0.0,
            attn_pdrop=0.0,
        )
    else:
        raise ValueError(f"unsupported decoder model_type {mt!r}")
    kw.update(overrides)
    return TrunkConfig(**kw)


def decoder_trunk_tree(sd: Dict[str, Array], config: TrunkConfig, model_type: str) -> dict:
    sd = {re.sub(r"^(gpt_neox|model)\.", "", k): v for k, v in sd.items()}
    trunk: dict = {}
    H, Hkv, D = config.n_head, config.num_heads_kv, config.head_dim

    if model_type == "gpt_neox":
        emb = sd.pop("embed_in.weight")
    else:
        emb = sd.pop("embed_tokens.weight")
    if config.vocab_size > emb.shape[0]:
        emb = np.pad(emb, ((0, config.vocab_size - emb.shape[0]), (0, 0)))
    set_path(trunk, "embed_tokens/embedding", emb)

    for i in range(config.n_layer):
        if model_type == "gpt_neox":
            pre = f"layers.{i}"
            w = sd.pop(f"{pre}.attention.query_key_value.weight")  # [(h 3 d), D]
            w = w.reshape(H, 3, D, -1).transpose(1, 0, 2, 3).reshape(3 * H * D, -1)
            set_path(trunk, f"layers_{i}/attn/Wqkv/kernel", _t(w))
            if f"{pre}.attention.query_key_value.bias" in sd:
                b = sd.pop(f"{pre}.attention.query_key_value.bias")
                b = b.reshape(H, 3, D).transpose(1, 0, 2).reshape(-1)
                set_path(trunk, f"layers_{i}/attn/Wqkv/bias", b)
            set_path(trunk, f"layers_{i}/attn/out_proj/kernel", _t(sd.pop(f"{pre}.attention.dense.weight")))
            if f"{pre}.attention.dense.bias" in sd:
                set_path(trunk, f"layers_{i}/attn/out_proj/bias", sd.pop(f"{pre}.attention.dense.bias"))
            set_path(trunk, f"layers_{i}/norm1/weight", sd.pop(f"{pre}.input_layernorm.weight"))
            set_path(trunk, f"layers_{i}/norm1/bias", sd.pop(f"{pre}.input_layernorm.bias"))
            set_path(trunk, f"layers_{i}/norm2/weight", sd.pop(f"{pre}.post_attention_layernorm.weight"))
            set_path(trunk, f"layers_{i}/norm2/bias", sd.pop(f"{pre}.post_attention_layernorm.bias"))
            set_path(trunk, f"layers_{i}/mlp/fc1/kernel", _t(sd.pop(f"{pre}.mlp.dense_h_to_4h.weight")))
            set_path(trunk, f"layers_{i}/mlp/fc1/bias", sd.pop(f"{pre}.mlp.dense_h_to_4h.bias"))
            set_path(trunk, f"layers_{i}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.mlp.dense_4h_to_h.weight")))
            set_path(trunk, f"layers_{i}/mlp/fc2/bias", sd.pop(f"{pre}.mlp.dense_4h_to_h.bias"))
        elif model_type == "llama":
            pre = f"layers.{i}"
            q = sd.pop(f"{pre}.self_attn.q_proj.weight")
            k = sd.pop(f"{pre}.self_attn.k_proj.weight")
            v = sd.pop(f"{pre}.self_attn.v_proj.weight")
            set_path(trunk, f"layers_{i}/attn/Wqkv/kernel", _t(np.concatenate([q, k, v], axis=0)))
            if f"{pre}.self_attn.q_proj.bias" in sd:
                bq = sd.pop(f"{pre}.self_attn.q_proj.bias")
                bk = sd.pop(f"{pre}.self_attn.k_proj.bias")
                bv = sd.pop(f"{pre}.self_attn.v_proj.bias")
                set_path(trunk, f"layers_{i}/attn/Wqkv/bias", np.concatenate([bq, bk, bv]))
            set_path(trunk, f"layers_{i}/attn/out_proj/kernel", _t(sd.pop(f"{pre}.self_attn.o_proj.weight")))
            set_path(trunk, f"layers_{i}/norm1/weight", sd.pop(f"{pre}.input_layernorm.weight"))
            set_path(trunk, f"layers_{i}/norm2/weight", sd.pop(f"{pre}.post_attention_layernorm.weight"))
            set_path(trunk, f"layers_{i}/mlp/fc11/kernel", _t(sd.pop(f"{pre}.mlp.up_proj.weight")))
            set_path(trunk, f"layers_{i}/mlp/fc12/kernel", _t(sd.pop(f"{pre}.mlp.gate_proj.weight")))
            set_path(trunk, f"layers_{i}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.mlp.down_proj.weight")))
        else:
            raise ValueError(model_type)

    if model_type == "gpt_neox":
        set_path(trunk, "ln_f/weight", sd.pop("final_layer_norm.weight"))
        set_path(trunk, "ln_f/bias", sd.pop("final_layer_norm.bias"))
    else:
        set_path(trunk, "ln_f/weight", sd.pop("norm.weight"))
    return trunk


def _round256(x: int) -> int:
    return 256 * ((x + 255) // 256)


def open_lm_config_to_trunk_config(hf: Dict[str, Any], **overrides) -> TrunkConfig:
    """open_lm checkpoints: swiglu with 8/3 sizing rounded to 256, the fused
    in_proj qkv, no biases, and the rotary over the head index when
    rotary_old is set."""
    kw = dict(
        vocab_size=hf["vocab_size"],
        n_positions=0,
        n_embd=hf["hidden_dim"],
        n_layer=hf["n_layers"],
        n_head=hf["n_heads"],
        n_inner=_round256(int(2 * 4 * hf["hidden_dim"] / 3)),
        activation_function="swiglu",
        layer_norm_epsilon=1e-5,
        prenorm=True,
        rotary_emb_fraction=1.0,
        rotary_emb_base=10_000,
        rotary_head_dim=hf.get("rotary_old", False),
        tie_word_embeddings=hf.get("weight_tying", False),
        qkv_proj_bias=hf.get("qkv_proj_bias", False),
        mlp_fc1_bias=False,
        mlp_fc2_bias=False,
        ln_f_bias=hf.get("ln_f_bias", True),
        causal=True,
        resid_pdrop=0.0,
        embd_pdrop=0.0,
        attn_pdrop=0.0,
    )
    kw.update(overrides)
    return TrunkConfig(**kw)


def open_lm_trunk_tree(sd: Dict[str, Array], config: TrunkConfig) -> dict:
    sd = {re.sub(r"^model\.", "", k): v for k, v in sd.items() if "inv_freq" not in k}
    trunk: dict = {}
    emb = sd.pop("tok_embeddings.weight")
    if config.vocab_size > emb.shape[0]:
        emb = np.pad(emb, ((0, config.vocab_size - emb.shape[0]), (0, 0)))
    set_path(trunk, "embed_tokens/embedding", emb)
    sd.pop("output.weight", None)  # the LM head is not part of the trunk

    F_hid = config.n_inner
    for i in range(config.n_layer):
        pre = f"layers.{i}"
        set_path(trunk, f"layers_{i}/attn/Wqkv/kernel", _t(sd.pop(f"{pre}.attention.in_proj.weight")))
        set_path(trunk, f"layers_{i}/attn/out_proj/kernel", _t(sd.pop(f"{pre}.attention.out_proj.weight")))
        set_path(trunk, f"layers_{i}/norm1/weight", sd.pop(f"{pre}.attention_norm.weight"))
        if f"{pre}.attention_norm.bias" in sd:
            set_path(trunk, f"layers_{i}/norm1/bias", sd.pop(f"{pre}.attention_norm.bias"))
        set_path(trunk, f"layers_{i}/norm2/weight", sd.pop(f"{pre}.ffn_norm.weight"))
        if f"{pre}.ffn_norm.bias" in sd:
            set_path(trunk, f"layers_{i}/norm2/bias", sd.pop(f"{pre}.ffn_norm.bias"))
        # the fused w12 splits into (w1 = gate, w2 = value)
        w12 = sd.pop(f"{pre}.feed_forward.w12.weight")
        w1, w2 = w12[:F_hid], w12[F_hid:]
        set_path(trunk, f"layers_{i}/mlp/fc12/kernel", _t(w1))  # gate
        set_path(trunk, f"layers_{i}/mlp/fc11/kernel", _t(w2))  # value
        set_path(trunk, f"layers_{i}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.feed_forward.w3.weight")))
    set_path(trunk, "ln_f/weight", sd.pop("norm.weight"))
    if "norm.bias" in sd:
        set_path(trunk, "ln_f/bias", sd.pop("norm.bias"))
    return trunk


def clip_text_config_to_trunk_config(hf: Dict[str, Any], **overrides) -> TrunkConfig:
    """CLIP text tower as a causal decoder with learned absolute positions
    (JAX `clip_text_config_to_trunk_config`)."""
    tc = hf.get("text_config", hf)
    kw = dict(
        vocab_size=tc["vocab_size"],
        n_positions=tc["max_position_embeddings"],
        n_embd=tc["hidden_size"],
        n_layer=tc["num_hidden_layers"],
        n_head=tc["num_attention_heads"],
        n_inner=tc["intermediate_size"],
        activation_function=tc.get("hidden_act", "quick_gelu"),
        layer_norm_epsilon=tc.get("layer_norm_eps", 1e-5),
        initializer_range=tc.get("initializer_range", 0.02),
        prenorm=True,
        rotary_emb_fraction=0.0,
        causal=True,
        pad_token_id=None,  # CLIP positions are arange, never pad-aware
        resid_pdrop=0.0,
        embd_pdrop=0.0,
        attn_pdrop=0.0,
    )
    kw.update(overrides)
    return TrunkConfig(**kw)


def clip_text_trunk_tree(sd: Dict[str, Array], config: TrunkConfig) -> dict:
    sd = {re.sub(r"^text_model\.", "", k): v for k, v in sd.items() if k.startswith("text_model.")} or dict(sd)
    sd = {re.sub(r"^encoder\.", "", k): v for k, v in sd.items()}
    sd.pop("embeddings.position_ids", None)
    trunk: dict = {}
    set_path(trunk, "embeddings/word_embeddings/embedding", sd.pop("embeddings.token_embedding.weight"))
    set_path(trunk, "embeddings/position_embeddings/embedding", sd.pop("embeddings.position_embedding.weight"))
    for i in range(config.n_layer):
        pre = f"layers.{i}"
        wq = sd.pop(f"{pre}.self_attn.q_proj.weight")
        wk = sd.pop(f"{pre}.self_attn.k_proj.weight")
        wv = sd.pop(f"{pre}.self_attn.v_proj.weight")
        set_path(trunk, f"layers_{i}/attn/Wqkv/kernel", _t(np.concatenate([wq, wk, wv], 0)))
        b = np.concatenate([sd.pop(f"{pre}.self_attn.{n}.bias") for n in ("q_proj", "k_proj", "v_proj")])
        set_path(trunk, f"layers_{i}/attn/Wqkv/bias", b)
        set_path(trunk, f"layers_{i}/attn/out_proj/kernel", _t(sd.pop(f"{pre}.self_attn.out_proj.weight")))
        set_path(trunk, f"layers_{i}/attn/out_proj/bias", sd.pop(f"{pre}.self_attn.out_proj.bias"))
        set_path(trunk, f"layers_{i}/norm1/weight", sd.pop(f"{pre}.layer_norm1.weight"))
        set_path(trunk, f"layers_{i}/norm1/bias", sd.pop(f"{pre}.layer_norm1.bias"))
        set_path(trunk, f"layers_{i}/norm2/weight", sd.pop(f"{pre}.layer_norm2.weight"))
        set_path(trunk, f"layers_{i}/norm2/bias", sd.pop(f"{pre}.layer_norm2.bias"))
        set_path(trunk, f"layers_{i}/mlp/fc1/kernel", _t(sd.pop(f"{pre}.mlp.fc1.weight")))
        set_path(trunk, f"layers_{i}/mlp/fc1/bias", sd.pop(f"{pre}.mlp.fc1.bias"))
        set_path(trunk, f"layers_{i}/mlp/fc2/kernel", _t(sd.pop(f"{pre}.mlp.fc2.weight")))
        set_path(trunk, f"layers_{i}/mlp/fc2/bias", sd.pop(f"{pre}.mlp.fc2.bias"))
    set_path(trunk, "ln_f/weight", sd.pop("final_layer_norm.weight"))
    set_path(trunk, "ln_f/bias", sd.pop("final_layer_norm.bias"))
    return trunk


def decoder_state_dict_to_torch(sd: Dict[str, Array], config: TrunkConfig, model_type: str) -> Dict[str, torch.Tensor]:
    """The state dict of `DecoderModel`, fp32, from a gpt_neox or llama checkpoint."""
    return flax_to_torch(decoder_trunk_tree(sd, config, model_type))


def open_lm_state_dict_to_torch(sd: Dict[str, Array], config: TrunkConfig) -> Dict[str, torch.Tensor]:
    """The state dict of `DecoderModel`, fp32, from an open_lm checkpoint."""
    return flax_to_torch(open_lm_trunk_tree(sd, config))


def clip_text_state_dict_to_torch(sd: Dict[str, Array], config: TrunkConfig) -> Dict[str, torch.Tensor]:
    """The state dict of `DecoderModel`, fp32, from a CLIP (text) checkpoint."""
    return flax_to_torch(clip_text_trunk_tree(sd, config))
