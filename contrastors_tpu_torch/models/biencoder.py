"""BiEncoder: single-tower embedder with pooling heads, counterpart of
`contrastors_tpu/models/biencoder.py` for the encoder, decoder and vision
trunks.

Mean / cls / last / MAP / none pooling, the hamming LayerNorm, the projection,
normalisation with the clamp inside the sqrt, and binarisation keep the JAX
semantics. The output carries the MoE layers' masked router logits under
"router_logits" (None for a dense trunk), for the router load-balance
loss. `LogitScale` is the contrastive loss's exp-parameterised
temperature. `remat` recomputes each trunk block's activations in the
backward (activation checkpointing, `NomicBertModel`). `generator` seeds the
trunk's dropout in training mode (JAX's "dropout" rng).

trunk_type="vision" runs `ViTModel` on `pixel_values` with no mask;
pooling="map" adds the MAP head (`selector`, JAX's name). With `freeze`
the trunk runs under `torch.no_grad()`, where JAX stops the gradient at
its last_hidden_state: the pooling head, hamming LayerNorm and projection
after it still take gradients. trunk_type="decoder" runs the causal
`DecoderModel` (no token types), usually with "last" pooling: the final
valid token of each row. Packed mode raises until its slice is ported.
"""

import contextlib
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.layers.attention import MultiHeadAttentionPooling
from contrastors_tpu_torch.layers.dense import Dense
from contrastors_tpu_torch.layers.norms import LayerNorm
from contrastors_tpu_torch.models.decoder import DecoderModel
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.models.nomic_bert import NomicBertModel
from contrastors_tpu_torch.models.vit import ViTModel

POOLINGS = ("mean", "last", "cls", "map", "none")
TRUNKS = {"encoder": NomicBertModel, "decoder": DecoderModel, "vision": ViTModel}
TRUNK_TYPES = tuple(TRUNKS)


def mean_pool(hidden: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked mean over the sequence, in fp32, cast back to hidden.dtype."""
    if attention_mask is None:
        return hidden.mean(dim=1)
    m = attention_mask[:, :, None].float()
    s = (hidden.float() * m).sum(dim=1)
    d = m.sum(dim=1).clamp_min(1.0)
    return (s / d).to(hidden.dtype)


def last_token_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Embedding of the final valid token of each row."""
    last = attention_mask.sum(dim=-1).long() - 1
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def cls_pool(hidden: torch.Tensor, attention_mask=None) -> torch.Tensor:
    return hidden[:, 0]


class LogitScale(nn.Module):
    """x * exp(s), s an fp32 scalar initialised to log(logit_scale_init)
    (`contrastors_tpu/models/biencoder.py:LogitScale`). With
    trainable=False, s is detached, standing for JAX's stop_gradient: it
    gets no gradient and AdamW leaves it unchanged."""

    def __init__(self, logit_scale_init: float = 1 / 0.07, trainable: bool = True, device="cuda"):
        super().__init__()
        self.trainable = trainable
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(logit_scale_init), dtype=torch.float32, device=resolve_device(device))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.logit_scale if self.trainable else self.logit_scale.detach()
        return x * torch.exp(s)


class BiEncoder(nn.Module):
    def __init__(
        self,
        config: TrunkConfig,
        trunk_type: str = "encoder",
        pooling: str = "mean",
        projection_dim: Optional[int] = None,
        hamming: bool = False,
        freeze: bool = False,
        dtype=torch.float32,
        device="cuda",
        remat: bool = False,
    ):
        super().__init__()
        device = resolve_device(device)
        if trunk_type not in TRUNK_TYPES:
            raise ValueError(f"trunk_type={trunk_type!r}: the port has {TRUNK_TYPES}")
        if pooling not in POOLINGS:
            raise ValueError(f"pooling {pooling!r}: the port has {POOLINGS}")
        self.config, self.trunk_type, self.pooling, self.freeze, self.dtype = (
            config, trunk_type, pooling, freeze, dtype)
        self.trunk = TRUNKS[trunk_type](config, dtype=dtype, device=device, remat=remat)
        self.selector = (MultiHeadAttentionPooling(config, dtype=dtype, device=device)
                         if pooling == "map" else None)
        self.hamming = (
            LayerNorm(config.n_embd, eps=1e-5, elementwise_affine=False, device=device)
            if hamming else None
        )
        self.proj = (
            Dense(config.n_embd, projection_dim, dtype=dtype, device=device)
            if projection_dim else None
        )

    def uses_dropout(self) -> bool:
        """True when a forward in the current mode draws noise."""
        return self.trunk.uses_dropout()

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        max_segments: Optional[int] = None,
        normalize: bool = True,
        binarize: bool = False,
        generator: Optional[torch.Generator] = None,
        pixel_values: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        if segment_ids is not None and max_segments is not None:
            if self.trunk_type == "vision":
                raise ValueError("packed mode does not apply to vision trunks")
            raise NotImplementedError("packed mode is not ported yet (ROADMAP, Queue 1: packed path)")
        with torch.no_grad() if self.freeze else contextlib.nullcontext():
            if self.trunk_type == "vision":
                trunk_out = self.trunk(pixel_values, generator=generator)
                attention_mask = None
            elif self.trunk_type == "decoder":
                trunk_out = self.trunk(input_ids, attention_mask=attention_mask, position_ids=position_ids,
                                       segment_ids=segment_ids, generator=generator)
            else:
                trunk_out = self.trunk(
                    input_ids,
                    attention_mask=attention_mask,
                    position_ids=position_ids,
                    token_type_ids=token_type_ids,
                    segment_ids=segment_ids,
                    generator=generator,
                )
        hidden = trunk_out["last_hidden_state"]

        if self.pooling == "mean":
            embedding = mean_pool(hidden, attention_mask)
        elif self.pooling == "last":
            embedding = last_token_pool(hidden, attention_mask)
        elif self.pooling == "cls":
            embedding = cls_pool(hidden)
        elif self.pooling == "map":
            embedding = self.selector(hidden, attention_mask)
        else:
            embedding = hidden
        if self.hamming is not None:
            embedding = self.hamming(embedding)
        if self.proj is not None:
            embedding = self.proj(embedding)

        if binarize:
            embedding = (embedding > 0).float()
        elif normalize:
            # clamp INSIDE the sqrt, as on the JAX side (finite gradient at 0)
            e32 = embedding.float()
            norm = torch.sqrt((e32 * e32).sum(dim=-1, keepdim=True).clamp_min(1e-24))
            embedding = (e32 / norm).to(embedding.dtype)
        return {"embedding": embedding, "router_logits": trunk_out.get("router_logits") or None}
