"""Transformer block, counterpart of `contrastors_tpu/layers/block.py:Block`.

Postnorm (BERT) and the shifted prenorm layout: a prenorm Block receives
the un-added output of the previous block plus the running residual, adds
and normalises first, and returns its own un-added output; the model closes
the carry after the last block. The residual stream is kept in fp32 when
`residual_in_fp32`. Dropout and drop-path are not ported yet: they are
identities here, and `NomicBertModel` refuses training mode with any of
them on (every configuration in the repo sets them to 0). A MoE block
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


class Block(nn.Module):
    def __init__(self, config, dtype=torch.float32, moe: bool = False, attn_window: int = 0,
                 rotary_base_override: Optional[float] = None, norm1_identity: bool = False,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.moe = moe and config.num_experts > 0
        self.attn = MultiHeadAttention(
            config, dtype=dtype, window=attn_window,
            rotary_base_override=rotary_base_override, device=device,
        )
        self.mlp = (MoEMLP(config, dtype=dtype, device=device) if self.moe
                    else make_mlp(config, dtype=dtype, device=device))
        self.norm1 = None if norm1_identity else make_norm(config, device=device)
        self.norm2 = make_norm(config, device=device)

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
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(hidden_states, residual, router_logits)."""
        cfg = self.config
        attn_kw = dict(attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids)
        if cfg.prenorm:
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden_states.dtype
            h = hidden_states.to(resid_dtype)
            residual = h if residual is None else residual + h
            hidden_states = self.attn(self._norm1(residual).to(self.dtype), **attn_kw)
            residual = residual + hidden_states.to(resid_dtype)
            hidden_states, router_logits = self._mlp(self.norm2(residual).to(self.dtype), attention_mask)
            return hidden_states, residual, router_logits
        if residual is not None:
            raise ValueError("postnorm blocks carry no external residual")
        hidden_states = self._norm1(self.attn(hidden_states, **attn_kw) + hidden_states)
        mlp_out, router_logits = self._mlp(hidden_states, attention_mask)
        return self.norm2(mlp_out + hidden_states), None, router_logits
