"""Causal decoder trunk (GPT-NeoX / Pythia, Llama, open_lm, the CLIP text
tower), counterpart of `contrastors_tpu/models/decoder.py:DecoderModel`.

Token embeddings (`embed_tokens`), or `BertEmbeddings` (`embeddings`) when
the config has learned absolute positions and no rotary (CLIP text); a
stack of shifted-prenorm `Block`s, or of `ParallelBlock`s with
`parallel_block` (GPT-NeoX's parallel residual); causal attention through
`attention_core`, which sends every length to the flash kernels' causal
band on the card. The final dropout-add-norm closes the carry: the last
block's output (both streams of a parallel block, through `drop_f` and
`drop_f2`) is added to the residual and normed by `ln_f`, an RMSNorm or a
LayerNorm with a bias only when `ln_f_bias`.

Dropout runs where JAX's does, in training mode: in each block (per-site
generators under the block's seed, `layers/block.py`) and at the final add
(`drop_f`, `drop_f2`). `generator` seeds them all (`ops/dropout.py`); a
trunk with a dropout on refuses training mode without one. With `remat`
each block runs under `torch.utils.checkpoint`, its seed fixed on the host
before the call, so that the replay draws the same noise.
"""

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.block import Block, ParallelBlock
from contrastors_tpu_torch.layers.dense import Embed
from contrastors_tpu_torch.layers.embeddings import BertEmbeddings
from contrastors_tpu_torch.layers.norms import LayerNorm, RMSNorm
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.ops.dropout import active, dropout, fold_seed, noise_seed, site_generator

# dropout sites under a forward's seed
SITE_BLOCK, SITE_FINAL, SITE_FINAL2 = 1, 2, 3


class DecoderModel(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda", remat: bool = False):
        super().__init__()
        if not config.causal:
            raise ValueError("DecoderModel needs causal=True")
        device = resolve_device(device)
        self.config, self.dtype, self.remat = config, dtype, remat
        self.embeddings = self.embed_tokens = None
        if config.n_positions > 0 and config.rotary_emb_fraction <= 0:
            self.embeddings = BertEmbeddings(config, dtype=dtype, device=device)
        else:
            self.embed_tokens = Embed(config.vocab_size, config.n_embd, dtype=dtype, device=device)
        block_cls = ParallelBlock if config.parallel_block else Block
        self.layers = nn.ModuleList(block_cls(config, dtype=dtype, device=device) for _ in range(config.n_layer))
        if not config.prenorm:
            self.ln_f = None
        elif config.use_rms_norm:
            self.ln_f = RMSNorm(config.n_embd, eps=config.layer_norm_epsilon, device=device)
        else:
            self.ln_f = LayerNorm(config.n_embd, eps=config.layer_norm_epsilon, use_bias=config.ln_f_bias,
                                  device=device)

    def uses_dropout(self) -> bool:
        """True when a forward in the current mode draws noise."""
        cfg = self.config
        return self.training and max(cfg.resid_pdrop, cfg.attn_pdrop) > 0.0

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        cfg = self.config
        seed = noise_seed(generator) if self.uses_dropout() else None
        dev, train = input_ids.device, self.training
        if self.embeddings is not None:
            hidden = self.embeddings(input_ids, position_ids)
        else:
            hidden = self.embed_tokens(input_ids)

        hidden2 = residual = None
        for i, block in enumerate(self.layers):
            block_seed = None if seed is None else fold_seed(seed, SITE_BLOCK, i)
            if cfg.parallel_block:
                args = (hidden, hidden2, residual, attention_mask, segment_ids, position_ids, block_seed)
            else:
                args = (hidden, residual, attention_mask, segment_ids, position_ids, block_seed)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(block, *args, use_reentrant=False)
            else:
                out = block(*args)
            if cfg.parallel_block:
                hidden, hidden2, residual = out
            else:
                hidden, residual, _ = out

        if self.ln_f is not None:
            resid_dtype = torch.float32 if cfg.residual_in_fp32 else hidden.dtype
            drop = active(cfg.resid_pdrop, train)
            if drop:
                hidden = dropout(hidden, cfg.resid_pdrop, site_generator(seed, SITE_FINAL, device=dev))
            new = hidden.to(resid_dtype)
            if hidden2 is not None:
                if drop:
                    hidden2 = dropout(hidden2, cfg.resid_pdrop, site_generator(seed, SITE_FINAL2, device=dev))
                new = new + hidden2.to(resid_dtype)
            residual = new if residual is None else residual + new
            hidden = self.ln_f(residual).to(self.dtype)
        return {"last_hidden_state": hidden, "router_logits": []}
