"""Multi-head self-attention, counterpart of
`contrastors_tpu/layers/attention.py:MultiHeadAttention`.

One fused Wqkv projection whose output features are ordered q | k | v, as
on the JAX side. q/k/v are views of that output (row stride 3*H*D), which
the flash kernel takes as they are. Rotary is applied outside attention by
default (`fused_rotary=False`, as in JAX); with `fused_rotary=True` the
tables go to `attention_core`, whose flash path rotates q/k inside the
kernels and whose SDPA path rotates outside. The pooling heads wait for a
later slice.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.layers.rotary import apply_rotary, rotary_cos_sin
from contrastors_tpu_torch.ops import attention_core


class MultiHeadAttention(nn.Module):
    def __init__(self, config, dtype=torch.float32, window: int = 0,
                 rotary_base_override: Optional[float] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.window, self.rotary_base_override = config, window, rotary_base_override
        H, Hkv, D = config.n_head, config.num_heads_kv, config.head_dim
        kw = dict(dtype=dtype, device=device)
        self.Wqkv = Dense(config.n_embd, D * (H + 2 * Hkv), bias=config.qkv_proj_bias, **kw)
        self.out_proj = Dense(H * D, config.n_embd, bias=config.qkv_proj_bias, **kw)
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _rotary_tables(self, length: int, device: torch.device):
        key = (length, str(device))
        if key not in self._tables:
            cfg = self.config
            self._tables[key] = rotary_cos_sin(
                length,
                cfg.rotary_emb_dim,
                base=self.rotary_base_override or cfg.rotary_emb_base,
                rope_scaling=cfg.rope_scaling,
                rotary_scaling_factor=cfg.rotary_scaling_factor,
                max_trained_positions=cfg.max_trained_positions,
                device=device,
            )
        return self._tables[key]

    def forward(
        self,
        hidden_states: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        B, S, _ = hidden_states.shape
        H, Hkv, D = cfg.n_head, cfg.num_heads_kv, cfg.head_dim
        qkv = self.Wqkv(hidden_states)
        q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
        q, k, v = q.view(B, S, H, D), k.view(B, S, Hkv, D), v.view(B, S, Hkv, D)

        rotary_kw = {}
        if cfg.rotary_emb_dim > 0:
            # DynamicNTK scaling engages only past the trained context
            cos, sin = self._rotary_tables(S, q.device)
            if cfg.fused_rotary:
                rotary_kw = dict(rotary_cos=cos, rotary_sin=sin,
                                 rotary_interleaved=cfg.rotary_emb_interleaved,
                                 rotary_position_ids=position_ids)
            else:
                q = apply_rotary(q, cos, sin, cfg.rotary_emb_interleaved, position_ids)
                k = apply_rotary(k, cos, sin, cfg.rotary_emb_interleaved, position_ids)

        out = attention_core(
            q,
            k,
            v,
            impl=cfg.attn_impl,
            attention_mask=attention_mask,
            segment_ids=segment_ids,
            causal=cfg.causal,
            window=self.window,
            softmax_scale=1.0 / (D**0.5),
            **rotary_kw,
        )
        return self.out_proj(out.reshape(B, S, H * D))
