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
trunk's dropout in training mode (JAX's "dropout" rng). `moe_groups` splits
the rows into that many blocks that the encoder trunk's MoE layers route
on their own (grad cache's pass-1 chunks; the other trunks have no MoE).

trunk_type="vision" runs `ViTModel` on `pixel_values` with no mask;
pooling="map" adds the MAP head (`selector`, JAX's name). With `freeze`
the trunk runs under `torch.no_grad()`, where JAX stops the gradient at
its last_hidden_state: the pooling head, hamming LayerNorm and projection
after it still take gradients. trunk_type="decoder" runs the causal
`DecoderModel` (no token types), usually with "last" pooling: the final
valid token of each row.

Packed mode (`data/packing.py`'s rows): pass `segment_ids`,
`position_ids`, `max_segments` and `pair_index` (and `last_token_index`
for "last" pooling). The attention mask is then segment_ids > 0, attention
stays within segments (the flash kernels' segment ids; the decoder's causal
band inside them), positions restart at each segment, and pooling is per
segment: "mean" through `segment_mean_pool`, "last" by gathering each
sequence's last token, 0 for a slot that holds no token. The result is one
embedding per original sequence, or with pair_index=None the raw
[rows * max_segments, D] slot matrix (grad cache chunks over rows and
gathers the pairs at the loss). Vision trunks and other poolings refuse
packed rows, as JAX's do.
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


def _slot_onehot(segment_ids: torch.Tensor, max_segments: int) -> torch.Tensor:
    """[R, L, K] fp32: token l of row r belongs to segment k + 1."""
    slots = torch.arange(1, max_segments + 1, device=segment_ids.device)
    return (segment_ids[:, :, None] == slots).float()


def segment_mean_pool(hidden: torch.Tensor, segment_ids: torch.Tensor, max_segments: int,
                      pair_index: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-segment masked mean over packed rows, in fp32, cast back to
    hidden.dtype: hidden [R, L, D], segment_ids [R, L] in 0..max_segments (0
    = pad), pair_index [B] flat (row * max_segments + seg - 1) indices, or
    None for the raw [R * max_segments, D] slot matrix (an empty slot's
    mean is 0)."""
    onehot = _slot_onehot(segment_ids, max_segments)
    sums = torch.bmm(onehot.transpose(1, 2), hidden.float())  # [R, K, D]
    counts = onehot.sum(dim=1).clamp_min(1.0)[..., None]
    means = (sums / counts).reshape(-1, hidden.shape[-1])
    if pair_index is not None:
        means = means[pair_index.long()]
    return means.to(hidden.dtype)


def segment_last_pool(hidden: torch.Tensor, segment_ids: torch.Tensor, max_segments: int,
                      pair_index: Optional[torch.Tensor], last_token_index: torch.Tensor) -> torch.Tensor:
    """Each sequence's last token (flat `last_token_index` into [R * L]);
    a sequence that packing truncated to 0 tokens owns no position, so its
    embedding is 0."""
    embedding = hidden.reshape(-1, hidden.shape[-1])[last_token_index.long()]
    counts = _slot_onehot(segment_ids, max_segments).sum(dim=1).reshape(-1)  # tokens per slot
    sel = counts if pair_index is None else counts[pair_index.long()]
    return embedding * (sel > 0).to(embedding.dtype)[:, None]


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
        pair_index: Optional[torch.Tensor] = None,
        last_token_index: Optional[torch.Tensor] = None,
        moe_groups: int = 1,
    ) -> Dict[str, Any]:
        packed = segment_ids is not None and max_segments is not None
        if packed:
            if self.trunk_type == "vision":
                raise ValueError("packed mode does not apply to vision trunks")
            if self.pooling not in ("mean", "last"):
                raise ValueError("packed mode supports mean or last pooling only")
            if self.pooling == "last" and last_token_index is None:
                raise ValueError("packed 'last' pooling needs last_token_index")
            if attention_mask is None:
                # MoE routing and the router aux see row padding as invalid
                attention_mask = (segment_ids > 0).to(torch.int32)
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
                    moe_groups=moe_groups,
                )
        hidden = trunk_out["last_hidden_state"]

        if packed and self.pooling == "mean":
            embedding = segment_mean_pool(hidden, segment_ids, max_segments, pair_index)
        elif packed:
            embedding = segment_last_pool(hidden, segment_ids, max_segments, pair_index, last_token_index)
        elif self.pooling == "mean":
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
