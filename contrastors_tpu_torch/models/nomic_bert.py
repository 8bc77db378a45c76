"""NomicBERT encoder trunk and MLM head, counterpart of
`contrastors_tpu/models/nomic_bert.py` (`NomicBertModel`,
`NomicBertForPreTraining`, `masked_cross_entropy`).

Postnorm blocks, the embedding LayerNorm, optional rotary (nomic-bert-2048;
rotated inside the flash kernels with `fused_rotary`), ModernBERT-style
local/global alternation and prenorm trunks. Padding is handled by
static-shape masks, as on the JAX side. The classification head waits for a
later slice. MoE layers (every `moe_every_n_layers`-th, from layer 1) run
the dropless MoEMLP; the output carries their masked router logits, in
layer order, under "router_logits" (an empty list for a dense trunk).
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.activations import ACT2FN
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.layers.embeddings import BertEmbeddings
from contrastors_tpu_torch.layers.norms import LayerNorm, make_norm
from contrastors_tpu_torch.models.model_config import TrunkConfig


# trunk features of other model families (EVA/ViT layer scale and post-MLP
# norm, the open_lm head-index rotary, GPT-J parallel blocks): their slices
# port them
UNPORTED_FEATURES = ("layer_scale", "norm_mlp", "rotary_head_dim", "parallel_block")


def _layer_is_moe(config: TrunkConfig, i: int) -> bool:
    # moe when i % every_n == 1 (the upstream placement rule)
    if config.num_experts <= 0:
        return False
    if config.moe_every_n_layers == 1:
        # i % 1 == 1 never holds, so every_n=1 (the default) would silently
        # build a fully dense model; fail loudly instead
        raise ValueError(
            "num_experts > 0 with moe_every_n_layers == 1 places MoE on NO "
            "layers (the placement rule is i % every_n == 1); set moe_every_n_layers >= 2"
        )
    if config.moe_every_n_layers > 0:
        return i % config.moe_every_n_layers == 1
    return False


def init_weights(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Random weights from a seeded CPU torch.Generator, copied to the
    module's device: Linear/Embedding weights, MoE routers and expert
    tensors ~ N(0, std), biases (the MoE output bias and the MLM
    decoder_bias too) 0, norm weights 1, the kinds of the JAX initialisers.
    The same seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.zero_()
            elif "norm" in name or "emb_ln" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return module


class NomicBertModel(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        unported = [f for f in UNPORTED_FEATURES if getattr(config, f)]
        if unported:
            raise NotImplementedError(f"config features not ported yet (see ROADMAP): {unported}")
        self.config, self.dtype = config, dtype
        self.embeddings = BertEmbeddings(config, dtype=dtype, device=device)
        self.emb_ln = LayerNorm(
            config.n_embd, eps=config.layer_norm_epsilon, use_bias=config.norm_bias, device=device
        )
        every_n = config.global_attn_every_n_layers
        layers = []
        for i in range(config.n_layer):
            is_global = every_n <= 0 or i % every_n == 0
            layers.append(Block(
                config,
                dtype=dtype,
                moe=_layer_is_moe(config, i),
                attn_window=0 if is_global else config.sliding_window,
                rotary_base_override=None if is_global else config.local_rotary_emb_base,
                norm1_identity=config.prenorm and config.skip_first_prenorm and i == 0,
                device=device,
            ))
        self.layers = nn.ModuleList(layers)
        self.final_norm = make_norm(config, device=device) if config.prenorm else None

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        if self.training and max(
            cfg.embd_pdrop, cfg.resid_pdrop, cfg.attn_pdrop, cfg.drop_path_rate,
            cfg.moe_resid_pdrop or 0.0,
        ) > 0.0:
            raise NotImplementedError("training with dropout is not ported yet (ROADMAP, Queue 1)")
        hidden = self.emb_ln(self.embeddings(input_ids, position_ids, token_type_ids))
        residual, router_logits = None, []
        for block in self.layers:
            hidden, residual, rl = block(hidden, residual, attention_mask, segment_ids, position_ids)
            if rl is not None:
                router_logits.append(rl)
        if self.final_norm is not None:
            # the final add-norm closes the shifted-prenorm carry
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden.dtype
            h = hidden.to(resid_dtype)
            residual = h if residual is None else residual + h
            hidden = self.final_norm(residual).to(self.dtype)
        return {"last_hidden_state": hidden, "router_logits": router_logits}


class NomicBertForPreTraining(nn.Module):
    """MLM head with the decoder tied to the word embeddings (JAX
    `NomicBertForPreTraining`). Two loss paths:
      - default: label-masked CE over all positions (-100 ignored);
      - dense_seq_output: `masked_positions` [B, k] per-row indices into the
        sequence (host-collated to a static per-row k with -100-labelled
        filler slots, `trainers/mlm.py:masked_positions_static`) and `labels`
        as the matching [B, k] matrix; the vocab projection then runs on
        B*k rows instead of B*S.
    The head is dense -> act (silu for swiglu) -> norm, then the tied
    decoder, the fp32 word-embedding table cast to the compute dtype (a
    plain torch.matmul), plus an fp32 `decoder_bias`."""

    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.bert = NomicBertModel(config, dtype=dtype, device=device)
        self.transform_dense = Dense(config.n_embd, config.n_embd, bias=config.mlp_fc1_bias,
                                     dtype=dtype, device=device)
        self.transform_layer_norm = make_norm(config, device=device)
        self.decoder = None
        if not config.tie_word_embeddings:
            self.decoder = Dense(config.n_embd, config.vocab_size, bias=False, dtype=dtype, device=device)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size, device=device))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        masked_positions: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        hidden = self.bert(input_ids, attention_mask=attention_mask, position_ids=position_ids,
                           token_type_ids=token_type_ids)["last_hidden_state"]
        if masked_positions is not None:
            # dense_seq_output: project only the masked rows, gathered per batch row
            idx = masked_positions.to(device=hidden.device, dtype=torch.int64)
            hidden = torch.gather(hidden, 1, idx[:, :, None].expand(-1, -1, hidden.shape[-1]))
        act = torch.nn.functional.silu if cfg.activation_function == "swiglu" else ACT2FN[cfg.activation_function]
        h = self.transform_layer_norm(act(self.transform_dense(hidden)))
        if self.decoder is None:
            table = self.bert.embeddings.word_embeddings.weight
            logits = torch.matmul(h, table.to(self.dtype).t())
        else:
            logits = self.decoder(h)
        logits = logits + self.decoder_bias.to(logits.dtype)
        out: Dict[str, Any] = {"prediction_logits": logits}
        if labels is not None:
            out["loss"] = masked_cross_entropy(logits, labels)
        return out


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0 (HF ignore_index=-100), in fp32."""
    flat = logits.reshape(-1, logits.shape[-1]).float()
    flat_labels = labels.reshape(-1).to(flat.device)
    valid = flat_labels >= 0
    safe = torch.where(valid, flat_labels, 0).to(torch.int64)
    gold = flat.gather(-1, safe[:, None])[:, 0]
    nll = (torch.logsumexp(flat, dim=-1) - gold) * valid.float()
    return nll.sum() / valid.float().sum().clamp_min(1.0)
