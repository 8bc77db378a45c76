"""HF BERT-family checkpoint -> the port's modules.

Counterpart of the BERT part of `contrastors_tpu/models/hf_interop.py`
(`bert_config_to_trunk_config`, `normalize_bert_keys`,
`bert_state_dict_to_flax`), on numpy dicts. Both source layouts are taken:
vanilla HF BERT / RoBERTa (q/k/v split, intermediate/output naming) and
the nomic-bert flash layout (fused Wqkv, fc11/fc12). Heads: the MLM head,
and the classification head with its pooler (JAX `:155-240`). The remap builds the
same nested tree as JAX's and hands it to `convert.flax_to_torch`, so the
naming rules live in one place. The ViT and timm converters are
`hf_interop_vit.py` and `hf_interop_timm.py`, the decoder ones
`hf_interop_decoder.py`. ModernBERT (JAX `:307-373`): its config maps onto
the prenorm trunk with the skipped first prenorm, local / global attention
and GeGLU, and its `Wi` packs [input, gate] rows: fc12 (the activated
branch) takes the first half, fc11 the second. Layer 0 has no attn_norm, so
its tree has no norm1.
"""

import re
from typing import Dict, Optional

import numpy as np
import torch

from contrastors_tpu_torch.convert import flax_to_torch
from contrastors_tpu_torch.models.model_config import TrunkConfig

Array = np.ndarray


def _t(w: Array) -> Array:
    return np.ascontiguousarray(w.T)


def set_path(tree: dict, path: str, value: Array):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def bert_config_to_trunk_config(hf_config, **overrides) -> TrunkConfig:
    """transformers BertConfig / XLM-R config / NomicBertConfig (GPT2-style
    names), or any object with those attributes -> TrunkConfig."""
    g = lambda *names, default=None: next(  # noqa: E731
        (getattr(hf_config, n) for n in names if getattr(hf_config, n, None) is not None), default
    )
    kw = dict(
        vocab_size=g("vocab_size"),
        n_positions=g("max_position_embeddings", "n_positions", default=0),
        n_embd=g("hidden_size", "n_embd"),
        n_layer=g("num_hidden_layers", "n_layer"),
        n_head=g("num_attention_heads", "n_head"),
        n_inner=g("intermediate_size", "n_inner"),
        activation_function=g("hidden_act", "activation_function", default="gelu"),
        resid_pdrop=g("hidden_dropout_prob", "resid_pdrop", default=0.0),
        embd_pdrop=g("hidden_dropout_prob", "embd_pdrop", default=0.0),
        attn_pdrop=g("attention_probs_dropout_prob", "attn_pdrop", default=0.0),
        layer_norm_epsilon=g("layer_norm_eps", "layer_norm_epsilon", default=1e-12),
        initializer_range=g("initializer_range", default=0.02),
        prenorm=False,
        causal=False,
        rotary_emb_fraction=g("rotary_emb_fraction", default=0.0),
        rotary_emb_base=g("rotary_emb_base", default=10_000),
        rotary_emb_interleaved=bool(g("rotary_emb_interleaved", default=False)),
        qkv_proj_bias=bool(g("qkv_proj_bias", default=True)),
        mlp_fc1_bias=bool(g("mlp_fc1_bias", default=True)),
        mlp_fc2_bias=bool(g("mlp_fc2_bias", default=True)),
        use_rms_norm=bool(g("use_rms_norm", default=False)),
        type_vocab_size=g("type_vocab_size", default=0),
        pad_token_id=g("pad_token_id", default=None),
        pad_vocab_size_multiple=g("pad_vocab_to_multiple_of", "pad_vocab_size_multiple", default=1),
        max_trained_positions=g("max_trained_positions", default=2048),
        rotary_scaling_factor=g("rotary_scaling_factor", default=None),
        # an explicit false in config.json wins over the TrunkConfig default
        dense_seq_output=bool(g("dense_seq_output", default=True)),
    )
    kw.update(overrides)
    return TrunkConfig(**kw)


_RENAMES = (
    (r"^embeddings\.LayerNorm\.", "emb_ln."),
    (r"^encoder\.layers\.(\d+)\.attention\.output\.LayerNorm\.(weight|bias)", r"encoder.layers.\1.norm1.\2"),
    (r"^encoder\.layers\.(\d+)\.output\.LayerNorm\.(weight|bias)", r"encoder.layers.\1.norm2.\2"),
    (r"^encoder\.layers\.(\d+)\.intermediate\.dense\.(weight|bias)", r"encoder.layers.\1.mlp.fc1.\2"),
    (r"^encoder\.layers\.(\d+)\.output\.dense\.(weight|bias)", r"encoder.layers.\1.mlp.fc2.\2"),
    (r"^encoder\.layers\.(\d+)\.attention\.output\.dense\.(weight|bias)", r"encoder.layers.\1.attn.out_proj.\2"),
    (r"^cls\.predictions\.transform\.LayerNorm\.", "cls.predictions.transform.layer_norm."),
    (r"^cls\.predictions\.bias$", "cls.predictions.decoder.bias"),
    (r"^lm_head\.bias$", "cls.predictions.decoder.bias"),
    (r"^lm_head\.dense\.", "cls.predictions.transform.dense."),
    (r"^lm_head\.layer_norm\.", "cls.predictions.transform.layer_norm."),
    (r"^lm_head\.decoder\.weight$", "cls.predictions.decoder.weight"),
)


def normalize_bert_keys(sd: Dict[str, Array]) -> Dict[str, Array]:
    """Canonicalise prefixes and layouts to the flash naming: no
    bert./roberta. prefix, norm1/norm2, mlp.fc1/fc2, attn.out_proj and
    q/k/v fused into attn.Wqkv (q | k | v rows)."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^roberta\.", "", k)
        k = re.sub(r"^bert\.", "", k)
        k = re.sub(r"LayerNorm\.gamma$", "LayerNorm.weight", k)
        k = re.sub(r"LayerNorm\.beta$", "LayerNorm.bias", k)
        k = re.sub(r"^encoder\.layer\.", "encoder.layers.", k)
        for pattern, repl in _RENAMES:
            k = re.sub(pattern, repl, k)
        out[k] = v
    sd = out

    layer_ids = sorted(
        {int(m.group(1)) for k in sd if (m := re.match(r"encoder\.layers\.(\d+)\.attention\.self\.query\.weight", k))}
    )
    for i in layer_ids:
        pre = f"encoder.layers.{i}.attention.self"
        wq, wk, wv = (sd.pop(f"{pre}.{n}.weight") for n in ("query", "key", "value"))
        sd[f"encoder.layers.{i}.attn.Wqkv.weight"] = np.concatenate([wq, wk, wv], axis=0)
        if f"{pre}.query.bias" in sd:
            bq, bk, bv = (sd.pop(f"{pre}.{n}.bias") for n in ("query", "key", "value"))
            sd[f"encoder.layers.{i}.attn.Wqkv.bias"] = np.concatenate([bq, bk, bv], axis=0)

    for k in ("cls.seq_relationship.weight", "cls.seq_relationship.bias", "embeddings.position_ids"):
        sd.pop(k, None)
    return sd


def bert_tree(sd: Dict[str, Array], config: TrunkConfig, head: Optional[str] = None,
              add_pooling_layer: bool = False) -> dict:
    """The flax-shaped numpy tree of `bert_state_dict_to_flax` (flax names,
    [in, out] kernels), for a step that works on the tree (upcycling) before
    `flax_to_torch`."""
    sd = dict(normalize_bert_keys(sd))

    w = sd["embeddings.word_embeddings.weight"]
    if config.vocab_size > w.shape[0]:
        pad = config.vocab_size - w.shape[0]
        sd["embeddings.word_embeddings.weight"] = np.pad(w, ((0, pad), (0, 0)))
        if "cls.predictions.decoder.weight" in sd:
            sd["cls.predictions.decoder.weight"] = np.pad(sd["cls.predictions.decoder.weight"], ((0, pad), (0, 0)))
        if "cls.predictions.decoder.bias" in sd:
            sd["cls.predictions.decoder.bias"] = np.pad(
                sd["cls.predictions.decoder.bias"], (0, pad), constant_values=-100.0)

    trunk: dict = {}
    set_path(trunk, "embeddings/word_embeddings/embedding", sd.pop("embeddings.word_embeddings.weight"))
    if "embeddings.position_embeddings.weight" in sd:
        pos = sd.pop("embeddings.position_embeddings.weight")
        if config.rotary_emb_fraction <= 0:
            set_path(trunk, "embeddings/position_embeddings/embedding", pos)
    if "embeddings.token_type_embeddings.weight" in sd:
        set_path(trunk, "embeddings/token_type_embeddings/embedding",
                 sd.pop("embeddings.token_type_embeddings.weight"))
    set_path(trunk, "emb_ln/weight", sd.pop("emb_ln.weight"))
    set_path(trunk, "emb_ln/bias", sd.pop("emb_ln.bias"))

    for i in range(config.n_layer):
        src, dst = f"encoder.layers.{i}", f"layers_{i}"
        for mod in ("attn/Wqkv", "attn/out_proj", "mlp/fc1", "mlp/fc2", "mlp/fc11", "mlp/fc12"):
            wk = f"{src}.{mod.replace('/', '.')}.weight"
            if wk in sd:
                set_path(trunk, f"{dst}/{mod}/kernel", _t(sd.pop(wk)))
                bk = f"{src}.{mod.replace('/', '.')}.bias"
                if bk in sd:
                    set_path(trunk, f"{dst}/{mod}/bias", sd.pop(bk))
        for norm in ("norm1", "norm2"):
            set_path(trunk, f"{dst}/{norm}/weight", sd.pop(f"{src}.{norm}.weight"))
            if f"{src}.{norm}.bias" in sd:
                set_path(trunk, f"{dst}/{norm}/bias", sd.pop(f"{src}.{norm}.bias"))

    if add_pooling_layer and "pooler.dense.weight" in sd:
        set_path(trunk, "pooler_dense/kernel", _t(sd.pop("pooler.dense.weight")))
        set_path(trunk, "pooler_dense/bias", sd.pop("pooler.dense.bias"))

    if head is None:
        return trunk
    if head not in ("pretraining", "classification"):
        raise ValueError(f"head {head!r}: None, 'pretraining' or 'classification'")
    params: dict = {"bert": trunk}
    if head == "classification":
        # an absent classifier (a trunk or MLM checkpoint) keeps its init
        if "classifier.weight" in sd:
            set_path(params, "classifier/kernel", _t(sd.pop("classifier.weight")))
            set_path(params, "classifier/bias", sd.pop("classifier.bias"))
        return params
    # head weights may be absent (trunk-only checkpoints): they keep their init
    if "cls.predictions.transform.dense.weight" in sd:
        set_path(params, "transform_dense/kernel", _t(sd.pop("cls.predictions.transform.dense.weight")))
        set_path(params, "transform_dense/bias", sd.pop("cls.predictions.transform.dense.bias"))
        set_path(params, "transform_layer_norm/weight", sd.pop("cls.predictions.transform.layer_norm.weight"))
        set_path(params, "transform_layer_norm/bias", sd.pop("cls.predictions.transform.layer_norm.bias"))
    if "cls.predictions.decoder.bias" in sd:
        params["decoder_bias"] = sd.pop("cls.predictions.decoder.bias")
    return params


def bert_state_dict_to_torch(
    sd: Dict[str, Array], config: TrunkConfig, head: Optional[str] = None, add_pooling_layer: bool = False
) -> Dict[str, torch.Tensor]:
    """The state dict of `NomicBertModel` (head=None), of
    `NomicBertForPreTraining` (head="pretraining", trunk under "bert.") or of
    `NomicBertForSequenceClassification` (head="classification" with
    add_pooling_layer: the pooler under "bert.pooler_dense", the
    "classifier"), fp32, from an HF BERT-family checkpoint's numpy state
    dict. The word table is zero-padded to config.vocab_size (the MLM
    decoder bias with -100), and learned position embeddings are dropped
    for a rotary trunk. Head weights absent from the checkpoint are absent
    from the result, for the caller's init to keep."""
    return flax_to_torch(bert_tree(sd, config, head, add_pooling_layer))


def modernbert_config_to_trunk_config(hf: Dict, **overrides) -> TrunkConfig:
    """answerdotai/ModernBERT-* config.json (a dict) -> TrunkConfig."""
    kw = dict(
        vocab_size=hf["vocab_size"],
        n_positions=0,  # rotary
        n_embd=hf["hidden_size"],
        n_layer=hf["num_hidden_layers"],
        n_head=hf["num_attention_heads"],
        n_inner=hf["intermediate_size"],
        activation_function="geglu",  # act(input) * gate, exact gelu
        layer_norm_epsilon=hf.get("norm_eps", 1e-5),
        norm_bias=bool(hf.get("norm_bias", False)),
        prenorm=True,
        skip_first_prenorm=True,  # layer 0's attn_norm is Identity
        causal=False,
        rotary_emb_fraction=1.0,
        rotary_emb_base=hf.get("global_rope_theta", 160_000.0),
        local_rotary_emb_base=hf.get("local_rope_theta", 10_000.0),
        sliding_window=hf.get("local_attention", 128),
        global_attn_every_n_layers=hf.get("global_attn_every_n_layers", 3),
        qkv_proj_bias=bool(hf.get("attention_bias", False)),
        mlp_fc1_bias=bool(hf.get("mlp_bias", False)),
        mlp_fc2_bias=bool(hf.get("mlp_bias", False)),
        type_vocab_size=0,
        pad_token_id=hf.get("pad_token_id", 0),
        embd_pdrop=hf.get("embedding_dropout", 0.0),
        resid_pdrop=hf.get("mlp_dropout", 0.0),
        attn_pdrop=hf.get("attention_dropout", 0.0),
        max_trained_positions=hf.get("max_position_embeddings", 8192),
    )
    kw.update(overrides)
    return TrunkConfig(**kw)


def modernbert_trunk_tree(sd: Dict[str, Array], config: TrunkConfig) -> dict:
    """The trunk's numpy tree of an HF ModernBertModel state dict (JAX
    `modernbert_state_dict_to_flax`)."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    trunk: dict = {}
    w = sd["embeddings.tok_embeddings.weight"]
    if config.vocab_size > w.shape[0]:
        w = np.pad(w, ((0, config.vocab_size - w.shape[0]), (0, 0)))
    set_path(trunk, "embeddings/word_embeddings/embedding", w)
    set_path(trunk, "emb_ln/weight", sd["embeddings.norm.weight"])
    if "embeddings.norm.bias" in sd:
        set_path(trunk, "emb_ln/bias", sd["embeddings.norm.bias"])
    for i in range(config.n_layer):
        src, dst = f"layers.{i}", f"layers_{i}"
        set_path(trunk, f"{dst}/attn/Wqkv/kernel", _t(sd[f"{src}.attn.Wqkv.weight"]))
        set_path(trunk, f"{dst}/attn/out_proj/kernel", _t(sd[f"{src}.attn.Wo.weight"]))
        if f"{src}.attn_norm.weight" in sd:  # absent at layer 0 (Identity)
            set_path(trunk, f"{dst}/norm1/weight", sd[f"{src}.attn_norm.weight"])
            if f"{src}.attn_norm.bias" in sd:
                set_path(trunk, f"{dst}/norm1/bias", sd[f"{src}.attn_norm.bias"])
        set_path(trunk, f"{dst}/norm2/weight", sd[f"{src}.mlp_norm.weight"])
        if f"{src}.mlp_norm.bias" in sd:
            set_path(trunk, f"{dst}/norm2/bias", sd[f"{src}.mlp_norm.bias"])
        wi = sd[f"{src}.mlp.Wi.weight"]  # [2F, D]: [input; gate]
        f_hid = wi.shape[0] // 2
        set_path(trunk, f"{dst}/mlp/fc12/kernel", _t(wi[:f_hid]))  # the activated "input"
        set_path(trunk, f"{dst}/mlp/fc11/kernel", _t(wi[f_hid:]))  # the linear "gate"
        set_path(trunk, f"{dst}/mlp/fc2/kernel", _t(sd[f"{src}.mlp.Wo.weight"]))
    set_path(trunk, "final_norm/weight", sd["final_norm.weight"])
    if "final_norm.bias" in sd:
        set_path(trunk, "final_norm/bias", sd["final_norm.bias"])
    return trunk


def modernbert_state_dict_to_torch(sd: Dict[str, Array], config: TrunkConfig) -> Dict[str, torch.Tensor]:
    """The state dict of `NomicBertModel`, fp32, from an HF ModernBertModel
    checkpoint's numpy state dict."""
    return flax_to_torch(modernbert_trunk_tree(sd, config))
