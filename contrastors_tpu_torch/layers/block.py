"""Transformer blocks, counterpart of `contrastors_tpu/layers/block.py`
(`Block`, `ParallelBlock`).

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
drop-path2. With `layer_scale` (EVA, DINOv2) the attention and MLP outputs
are scaled by `ls1` / `ls2` ([n_embd], initialised to layer_scale_init)
before their residual add (prenorm only, as in JAX). `rope`, the 2-D ViT table, goes to the attention
(`layers/attention.py`). A MoE block
(`moe` and num_experts > 0) runs `MoEMLP` in place of the MLP, routing
`moe_groups` blocks of rows on their own, and returns its masked router
logits; a dense block returns None for them.

`ParallelBlock` (GPT-J / GPT-NeoX) carries two un-added streams, the
previous block's attention and MLP outputs, plus the residual: it adds both
(each through its residual dropout, sites 0 and 3) to the residual, then
runs attention on norm1(residual) and the MLP on norm2(residual), or on the
same normed input with `parallel_block_tied_norm`, and returns both outputs
un-added.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.attention import MultiHeadAttention
from contrastors_tpu_torch.layers.mlp import make_mlp
from contrastors_tpu_torch.layers.moe import MoEMLP
from contrastors_tpu_torch.layers.norms import make_norm
from contrastors_tpu_torch.ops.dropout import Seed, active, drop_path, dropout, site_generator


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
        self.ls1 = self.ls2 = None
        if config.layer_scale:
            self.ls1 = nn.Parameter(torch.full((config.n_embd,), float(config.layer_scale_init), device=device))
            self.ls2 = nn.Parameter(torch.full((config.n_embd,), float(config.layer_scale_init), device=device))

    @property
    def resid_pdrop(self) -> float:
        """The residual dropout: moe_resid_pdrop in a MoE block when set."""
        cfg = self.config
        return cfg.moe_resid_pdrop if self.moe and cfg.moe_resid_pdrop is not None else cfg.resid_pdrop

    def _norm1(self, x):
        return x if self.norm1 is None else self.norm1(x)

    def _mlp(self, x, attention_mask, moe_groups):
        """(output, router logits or None)."""
        if self.moe:
            return self.mlp(x, attention_mask, moe_groups)
        return self.mlp(x), None

    def forward(
        self,
        hidden_states: torch.Tensor,
        residual: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        dropout_seed: Optional[Seed] = None,
        rope: Optional[torch.Tensor] = None,
        moe_groups: int = 1,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(hidden_states, residual, router_logits). dropout_seed (a host
        int, or a tuple of them for row groups, `ops/dropout.py`) seeds the
        block's dropout sites; training mode with a dropout on needs it.
        rope: the 2-D ViT rope table, or None. moe_groups: the MoE layer's
        routing groups."""
        cfg = self.config
        dev, train = hidden_states.device, self.training

        def gen(site, p):  # built only where a draw happens
            return site_generator(dropout_seed, site, device=dev) if active(p, train) else None

        def drop(x, site, rate_path):
            x = dropout(x, self.resid_pdrop, gen(site, self.resid_pdrop), train)
            return drop_path(x, rate_path, gen(site + 1, rate_path), train)

        attn_kw = dict(attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids,
                       rope=rope, dropout_generator=gen(2, cfg.attn_pdrop))
        if cfg.prenorm:
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden_states.dtype
            h = drop(hidden_states, 0, self.drop_path_rate1).to(resid_dtype)
            residual = h if residual is None else residual + h
            hidden_states = _scaled(self.attn(self._norm1(residual).to(self.dtype), **attn_kw), self.ls1)
            residual = residual + drop(hidden_states, 3, self.drop_path_rate2).to(resid_dtype)
            hidden_states, router_logits = self._mlp(self.norm2(residual).to(self.dtype), attention_mask, moe_groups)
            return _scaled(hidden_states, self.ls2), residual, router_logits
        if residual is not None:
            raise ValueError("postnorm blocks carry no external residual")
        attn_out = self.attn(hidden_states, **attn_kw)
        hidden_states = self._norm1(drop(attn_out, 0, self.drop_path_rate1) + hidden_states)
        mlp_out, router_logits = self._mlp(hidden_states, attention_mask, moe_groups)
        return self.norm2(drop(mlp_out, 3, self.drop_path_rate2) + hidden_states), None, router_logits


class ParallelBlock(nn.Module):
    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.dtype = config, dtype
        self.attn = MultiHeadAttention(config, dtype=dtype, device=device)
        self.mlp = make_mlp(config, dtype=dtype, device=device)
        self.norm1 = make_norm(config, device=device)
        self.norm2 = None if config.parallel_block_tied_norm else make_norm(config, device=device)

    def forward(
        self,
        hidden_states1: torch.Tensor,
        hidden_states2: Optional[torch.Tensor],
        residual: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        dropout_seed: Optional[Seed] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(attention output, MLP output, residual). hidden_states2 is None
        before the first block."""
        cfg = self.config
        dev, train = hidden_states1.device, self.training

        def gen(site, p):
            return site_generator(dropout_seed, site, device=dev) if active(p, train) else None

        resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden_states1.dtype
        new = dropout(hidden_states1, cfg.resid_pdrop, gen(0, cfg.resid_pdrop), train).to(resid_dtype)
        if hidden_states2 is not None:
            new = new + dropout(hidden_states2, cfg.resid_pdrop, gen(3, cfg.resid_pdrop), train).to(resid_dtype)
        residual = new if residual is None else residual + new
        hidden1 = self.norm1(residual).to(self.dtype)
        hidden2 = hidden1 if self.norm2 is None else self.norm2(residual).to(self.dtype)
        attn_out = self.attn(hidden1, attention_mask=attention_mask, segment_ids=segment_ids,
                             position_ids=position_ids, dropout_generator=gen(2, cfg.attn_pdrop))
        return attn_out, self.mlp(hidden2), residual


def _scaled(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    return x if scale is None else x * scale.to(x.dtype)
