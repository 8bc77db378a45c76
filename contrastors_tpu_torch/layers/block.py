"""Transformer block, counterpart of `contrastors_tpu/layers/block.py:Block`.

Postnorm (BERT) and the shifted prenorm layout: a prenorm Block receives
the un-added output of the previous block plus the running residual, adds
and normalises first, and returns its own un-added output; the model closes
the carry after the last block. The residual stream is kept in fp32 when
`residual_in_fp32`. In training mode, residual dropout (`resid_pdrop`, or
`moe_resid_pdrop` in a MoE block) and drop-path (`drop_path_rate1/2`, which
`NomicBertModel` leaves at 0 as JAX's does) run where JAX's do, each site
with its own generator under the block's `dropout_seed` (`ops/dropout.py`),
in JAX's order: prenorm dropout1, drop-path1, attention, dropout2,
drop-path2; postnorm attention, dropout1, drop-path1, MLP, dropout2,
drop-path2. A MoE block
(`moe` and num_experts > 0) runs the dropless `MoEMLP` in place of the MLP
and returns its masked router logits; a dense block returns None for them.
The parallel block waits for a later slice.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.attention import MultiHeadAttention
from contrastors_tpu_torch.layers.mlp import make_mlp
from contrastors_tpu_torch.layers.moe import MoEMLP
from contrastors_tpu_torch.layers.norms import make_norm
from contrastors_tpu_torch.ops.dropout import active, drop_path, dropout, site_generator


class Block(nn.Module):
    def __init__(self, config, dtype=torch.float32, moe: bool = False, attn_window: int = 0,
                 rotary_base_override: Optional[float] = None, norm1_identity: bool = False,
                 drop_path_rate1: float = 0.0, drop_path_rate2: float = 0.0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.moe = moe and config.num_experts > 0
        self.drop_path_rate1, self.drop_path_rate2 = drop_path_rate1, drop_path_rate2
        self.attn = MultiHeadAttention(
            config, dtype=dtype, window=attn_window,
            rotary_base_override=rotary_base_override, device=device,
        )
        self.mlp = (MoEMLP(config, dtype=dtype, device=device) if self.moe
                    else make_mlp(config, dtype=dtype, device=device))
        self.norm1 = None if norm1_identity else make_norm(config, device=device)
        self.norm2 = make_norm(config, device=device)

    @property
    def resid_pdrop(self) -> float:
        """The residual dropout: moe_resid_pdrop in a MoE block when set."""
        cfg = self.config
        return cfg.moe_resid_pdrop if self.moe and cfg.moe_resid_pdrop is not None else cfg.resid_pdrop

    def _norm1(self, x):
        return x if self.norm1 is None else self.norm1(x)

    def _mlp(self, x, attention_mask):
        """(output, router logits or None)."""
        if self.moe:
            return self.mlp(x, attention_mask)
        return self.mlp(x), None

    def forward(
        self,
        hidden_states: torch.Tensor,
        residual: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        dropout_seed: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(hidden_states, residual, router_logits). dropout_seed (a host
        int) seeds the block's dropout sites; training mode with a dropout
        on needs it."""
        cfg = self.config
        dev, train = hidden_states.device, self.training

        def gen(site, p):  # built only where a draw happens
            return site_generator(dropout_seed, site, device=dev) if active(p, train) else None

        def drop(x, site, rate_path):
            x = dropout(x, self.resid_pdrop, gen(site, self.resid_pdrop), train)
            return drop_path(x, rate_path, gen(site + 1, rate_path), train)

        attn_kw = dict(attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids,
                       dropout_generator=gen(2, cfg.attn_pdrop))
        if cfg.prenorm:
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden_states.dtype
            h = drop(hidden_states, 0, self.drop_path_rate1).to(resid_dtype)
            residual = h if residual is None else residual + h
            hidden_states = self.attn(self._norm1(residual).to(self.dtype), **attn_kw)
            residual = residual + drop(hidden_states, 3, self.drop_path_rate2).to(resid_dtype)
            hidden_states, router_logits = self._mlp(self.norm2(residual).to(self.dtype), attention_mask)
            return hidden_states, residual, router_logits
        if residual is not None:
            raise ValueError("postnorm blocks carry no external residual")
        attn_out = self.attn(hidden_states, **attn_kw)
        hidden_states = self._norm1(drop(attn_out, 0, self.drop_path_rate1) + hidden_states)
        mlp_out, router_logits = self._mlp(hidden_states, attention_mask)
        return self.norm2(drop(mlp_out, 3, self.drop_path_rate2) + hidden_states), None, router_logits
