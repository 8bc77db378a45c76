"""Vision transformer trunk (CLIP, HF ViT, ViT-MAE, DINOv2, timm, EVA02),
counterpart of `contrastors_tpu/models/vit.py:ViTModel`.

The patch embedding, an optional `prepre_layernorm` (CLIP's ln_pre), prenorm
blocks in the shifted layout with the 2-D rope table handed to every block,
and JAX's final stage: the final add then `ln_f` (no `global_pool`), or the
final add, the mean over the patch tokens with global_pool="avg", then
`ln_f` where there is one; EVA02 (`no_last_ln`) has none.

Stochastic depth follows JAX's shifted schedule: with dpr =
linspace(0, drop_path_rate, n_layer), block i drops its carried-in output
at dpr[i - 1] (0 for block 0) and its attention output at dpr[i]. In
training mode every draw (patch dropout, each block's sites, the final
residual dropout) comes from a generator derived on the host from the
forward's `generator` and the site (`ops/dropout.py`), a block's seed fixed
outside its checkpointed call, so the `remat` replay draws the same noise.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.block import Block
from contrastors_tpu_torch.layers.embeddings import PatchEmbedding
from contrastors_tpu_torch.layers.norms import make_norm
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.ops.dropout import active, dropout, fold_seed, noise_seed, site_generator

# dropout sites under a forward's seed (ops/dropout.py:fold_seed paths)
SITE_PATCH, SITE_BLOCK, SITE_FINAL = range(3)


class ViTModel(nn.Module):
    def __init__(self, config: TrunkConfig, dtype=torch.float32, device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        if not config.prenorm:
            raise ValueError("the ViT trunk is prenorm (its final add closes the shifted-prenorm carry)")
        self.config, self.dtype, self.remat = config, dtype, remat
        self.embeddings = PatchEmbedding(config, dtype=dtype, device=device)
        self.prepre_layernorm = make_norm(config, device=device) if config.prepre_layernorm else None
        dpr = np.linspace(0.0, config.drop_path_rate, config.n_layer)
        self.layers = nn.ModuleList([
            Block(config, dtype=dtype, drop_path_rate1=float(dpr[i - 1]) if i > 0 else 0.0,
                  drop_path_rate2=float(dpr[i]), device=device)
            for i in range(config.n_layer)
        ])
        self.ln_f = make_norm(config, device=device) if not config.no_last_ln else None

    def uses_dropout(self) -> bool:
        """True when a forward in the current mode draws noise."""
        cfg = self.config
        return self.training and max(cfg.resid_pdrop, cfg.attn_pdrop, cfg.drop_path_rate, cfg.patch_dropout) > 0.0

    def forward(self, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        cfg = self.config
        train = self.training
        seed = noise_seed(generator) if self.uses_dropout() else None
        dev = pixel_values.device
        patch_gen = site_generator(seed, SITE_PATCH, device=dev) if active(cfg.patch_dropout, train) else None
        hidden, rope = self.embeddings(pixel_values, patch_gen)
        if self.prepre_layernorm is not None:
            hidden = self.prepre_layernorm(hidden).to(self.dtype)

        residual = None
        for i, block in enumerate(self.layers):
            block_seed = None if seed is None else fold_seed(seed, SITE_BLOCK, i)
            args = (hidden, residual, None, None, None, block_seed, rope)
            if self.remat and torch.is_grad_enabled():
                hidden, residual, _ = checkpoint(block, *args, use_reentrant=False)
            else:
                hidden, residual, _ = block(*args)

        if active(cfg.resid_pdrop, train):
            hidden = dropout(hidden, cfg.resid_pdrop, site_generator(seed, SITE_FINAL, device=dev))
        hidden = hidden.to(residual.dtype) + residual
        if self.ln_f is not None and cfg.global_pool is None:
            return {"last_hidden_state": self.ln_f(hidden).to(self.dtype)}
        hidden = hidden.to(self.dtype)
        if cfg.global_pool == "avg":
            num_prefix = (0 if cfg.no_cls_token else 1) + cfg.register_tokens
            hidden = hidden[:, num_prefix:].mean(dim=1)
        if self.ln_f is not None:
            hidden = self.ln_f(hidden).to(self.dtype)
        return {"last_hidden_state": hidden}
