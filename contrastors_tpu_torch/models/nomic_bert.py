"""NomicBERT encoder trunk, counterpart of
`contrastors_tpu/models/nomic_bert.py:NomicBertModel`.

Postnorm blocks, the embedding LayerNorm, optional rotary (nomic-bert-2048),
ModernBERT-style local/global alternation and prenorm trunks. Padding is
handled by static-shape masks, as on the JAX side. The MLM and
classification heads wait for a later slice. MoE layers (every
`moe_every_n_layers`-th, from layer 1) run the dropless MoEMLP; the output
carries their masked router logits, in layer order, under "router_logits"
(an empty list for a dense trunk).
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.block import Block
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
    tensors ~ N(0, std), biases (the MoE output bias too) 0, norm weights
    1, the kinds of the JAX initialisers. The same seed gives the same
    weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
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
