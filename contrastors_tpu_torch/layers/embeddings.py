"""Token embeddings, counterpart of `contrastors_tpu/layers/embeddings.py`
(`BertEmbeddings`, `pad_aware_position_ids`). Rotary models carry no
absolute positions. The patch embedding waits for the vision slice."""

from typing import Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.dense import Embed


def pad_aware_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """XLM-R/fairseq convention: positions count non-pad tokens from
    pad_token_id + 1."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class BertEmbeddings(nn.Module):
    def __init__(self, config, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.word_embeddings = Embed(config.vocab_size, config.n_embd, **kw)
        self.use_abs_pos = config.n_positions > 0 and config.rotary_emb_fraction <= 0
        self.position_embeddings = (
            Embed(config.n_positions, config.n_embd, **kw) if self.use_abs_pos else None
        )
        self.token_type_embeddings = (
            Embed(config.type_vocab_size, config.n_embd, **kw)
            if config.type_vocab_size > 0 else None
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        embeddings = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                if cfg.pad_token_id is not None and cfg.pad_token_id > 0:
                    position_ids = pad_aware_position_ids(input_ids, cfg.pad_token_id)
                else:
                    position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
            embeddings = embeddings + self.position_embeddings(position_ids)
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            embeddings = embeddings + self.token_type_embeddings(token_type_ids)
        return embeddings
