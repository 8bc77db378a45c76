"""Transformer block, counterpart of `contrastors_tpu/layers/block.py:Block`.

Postnorm (BERT) and the shifted prenorm layout: a prenorm Block receives
the un-added output of the previous block plus the running residual, adds
and normalises first, and returns its own un-added output; the model closes
the carry after the last block. The residual stream is kept in fp32 when
`residual_in_fp32`. Dropout and drop-path are not ported yet: they are
identities here, and `NomicBertModel` refuses training mode with any of
them on (every configuration in the repo sets them to 0). MoE blocks and
the parallel block wait for later slices.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.attention import MultiHeadAttention
from contrastors_tpu_torch.layers.mlp import make_mlp
from contrastors_tpu_torch.layers.norms import make_norm


class Block(nn.Module):
    def __init__(self, config, dtype=torch.float32, moe: bool = False, attn_window: int = 0,
                 rotary_base_override: Optional[float] = None, norm1_identity: bool = False,
                 device="cuda"):
        super().__init__()
        if moe and config.num_experts > 0:
            raise NotImplementedError("MoE blocks are not ported yet (ROADMAP, Queue 1: MoE)")
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.attn = MultiHeadAttention(
            config, dtype=dtype, window=attn_window,
            rotary_base_override=rotary_base_override, device=device,
        )
        self.mlp = make_mlp(config, dtype=dtype, device=device)
        self.norm1 = None if norm1_identity else make_norm(config, device=device)
        self.norm2 = make_norm(config, device=device)

    def _norm1(self, x):
        return x if self.norm1 is None else self.norm1(x)

    def forward(
        self,
        hidden_states: torch.Tensor,
        residual: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        attn_kw = dict(attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids)
        if cfg.prenorm:
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden_states.dtype
            h = hidden_states.to(resid_dtype)
            residual = h if residual is None else residual + h
            hidden_states = self.attn(self._norm1(residual).to(self.dtype), **attn_kw)
            residual = residual + hidden_states.to(resid_dtype)
            hidden_states = self.mlp(self.norm2(residual).to(self.dtype))
            return hidden_states, residual
        if residual is not None:
            raise ValueError("postnorm blocks carry no external residual")
        hidden_states = self._norm1(self.attn(hidden_states, **attn_kw) + hidden_states)
        hidden_states = self.norm2(self.mlp(hidden_states) + hidden_states)
        return hidden_states, None
