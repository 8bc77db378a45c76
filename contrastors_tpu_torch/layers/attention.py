"""Multi-head self-attention and latent-query attention pooling,
counterpart of `contrastors_tpu/layers/attention.py` (`MultiHeadAttention`,
`AttentionPooling`, `MultiHeadAttentionPooling`).

One fused Wqkv projection whose output features are ordered q | k | v, as
on the JAX side. q/k/v are views of that output (row stride 3*H*D), which
the flash kernel takes as they are. Rotary is applied outside attention by
default (`fused_rotary=False`, as in JAX); with `fused_rotary=True` the
tables go to `attention_core`, whose flash path rotates q/k inside the
kernels and whose SDPA path rotates outside. In training mode with
attn_pdrop > 0 the attention dropout is drawn from `dropout_generator`
(JAX's "dropout" rng), which `attention_core` sends to the plain `sdpa`,
as JAX's sends it to its XLA sdpa. A ViT passes its 2-D rope table
(`rope`): q and k are rotated outside attention with the first
max(register_tokens, 1) tokens left as they are (even with no cls token,
JAX's quirk), and attention runs unmasked through `attention_core`. With
`rotary_head_dim` (open_lm's `rotary_old`) the table is H rows long and q
and k are rotated over the head index instead of the position, as in JAX.

The MAP head (`MultiHeadAttentionPooling`) is one learned latent query
cross-attending over the sequence through the plain `sdpa` on purpose (one
query row, as JAX's `impl="sdpa"`), then hidden + mlp(norm(attn)) taken at
token 0.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.layers.mlp import make_mlp
from contrastors_tpu_torch.layers.norms import make_norm
from contrastors_tpu_torch.layers.rotary import apply_rope_cat_prefixed, apply_rotary, rotary_cos_sin
from contrastors_tpu_torch.ops import attention_core
from contrastors_tpu_torch.ops.dropout import active, need_generator


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
        rope: Optional[torch.Tensor] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.config
        dropout_p = cfg.attn_pdrop if active(cfg.attn_pdrop, self.training) else 0.0
        if dropout_p:
            need_generator(dropout_generator, dropout_p, "attention dropout")
        B, S, _ = hidden_states.shape
        H, Hkv, D = cfg.n_head, cfg.num_heads_kv, cfg.head_dim
        qkv = self.Wqkv(hidden_states)
        q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
        q, k, v = q.view(B, S, H, D), k.view(B, S, Hkv, D), v.view(B, S, Hkv, D)

        rotary_kw = {}
        if cfg.rotary_emb_dim > 0:
            # DynamicNTK scaling engages only past the trained context
            cos, sin = self._rotary_tables(H if cfg.rotary_head_dim else S, q.device)
            if cfg.rotary_head_dim:
                # open_lm's quirk: the head index is the rotary position
                q = apply_rotary(q.transpose(1, 2), cos, sin, cfg.rotary_emb_interleaved).transpose(1, 2)
                k = apply_rotary(k.transpose(1, 2), cos, sin, cfg.rotary_emb_interleaved).transpose(1, 2)
            elif cfg.fused_rotary:
                rotary_kw = dict(rotary_cos=cos, rotary_sin=sin,
                                 rotary_interleaved=cfg.rotary_emb_interleaved,
                                 rotary_position_ids=position_ids)
            else:
                q = apply_rotary(q, cos, sin, cfg.rotary_emb_interleaved, position_ids)
                k = apply_rotary(k, cos, sin, cfg.rotary_emb_interleaved, position_ids)
        elif rope is not None:
            n_prefix = max(cfg.register_tokens, 1)
            q = apply_rope_cat_prefixed(q, rope, n_prefix)
            k = apply_rope_cat_prefixed(k, rope, n_prefix)

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
            dropout_p=dropout_p,
            dropout_generator=dropout_generator if dropout_p else None,
            **rotary_kw,
        )
        return self.out_proj(out.reshape(B, S, H * D))


class AttentionPooling(nn.Module):
    """One learned latent query (`latent` [1, 1, n_embd]) attending over
    kv_states through the plain sdpa."""

    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        H, Hkv, D = config.n_head, config.num_heads_kv, config.head_dim
        kw = dict(dtype=dtype, device=device)
        self.latent = nn.Parameter(torch.randn(1, 1, config.n_embd, device=device) * config.n_embd**-0.5)
        self.Wq = Dense(config.n_embd, config.n_embd, bias=config.qkv_proj_bias, **kw)
        self.Wkv = Dense(config.n_embd, 2 * Hkv * D, bias=config.qkv_proj_bias, **kw)
        self.out_proj = Dense(H * D, config.n_embd, bias=config.qkv_proj_bias, **kw)

    def forward(self, kv_states: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        B = kv_states.shape[0]
        H, Hkv, D = cfg.n_head, cfg.num_heads_kv, cfg.head_dim
        q = self.Wq(self.latent.to(self.Wq.compute_dtype).expand(B, 1, cfg.n_embd))
        k, v = self.Wkv(kv_states).chunk(2, dim=-1)
        out = attention_core(q.reshape(B, 1, H, D), k.reshape(B, -1, Hkv, D), v.reshape(B, -1, Hkv, D),
                             impl="sdpa", attention_mask=attention_mask, causal=False,
                             softmax_scale=1.0 / (D**0.5))
        return self.out_proj(out.reshape(B, 1, H * D))


class MultiHeadAttentionPooling(nn.Module):
    """big_vision's MAP head: `attn` (AttentionPooling), `norm1`, `mlp`;
    returns (hidden + mlp(norm1(attn(hidden))))[:, 0], the broadcast add of
    JAX's and the shipped HF model's."""

    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.attn = AttentionPooling(config, dtype=dtype, device=device)
        self.norm1 = make_norm(config, device=device)
        self.mlp = make_mlp(config, dtype=dtype, device=device)

    def forward(self, hidden_states: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mlp_out = self.mlp(self.norm1(self.attn(hidden_states, attention_mask)))
        return (hidden_states + mlp_out)[:, 0]
