"""DualEncoder: the CLIP / LiT two-tower model, counterpart of
`contrastors_tpu/models/dual_encoder.py`.

A text `BiEncoder` (frozen with `freeze_text`: its trunk runs without
gradients), a vision `BiEncoder` and a `LogitScale`; the forward computes
the symmetric CLIP loss itself, or takes precomputed text embeddings in
place of the text tower. Module names (`text`, `vision`, `logit_scale`) are
JAX's, so `convert.flax_to_torch` maps the dual tree one to one.
In training mode the towers' dropout draws from generators derived from the
forward's `generator` per tower (`ops/dropout.py`), as flax derives its
rngs per module. The gathered (data-parallel) form of the loss waits for
ROADMAP Queue 1, item 3.
"""

from typing import Any, Dict, Optional

import torch
from torch import nn

from contrastors_tpu_torch._device import resolve_device
from contrastors_tpu_torch.losses import clip_loss_symmetric
from contrastors_tpu_torch.models.biencoder import BiEncoder, LogitScale
from contrastors_tpu_torch.models.model_config import TrunkConfig
from contrastors_tpu_torch.ops.dropout import noise_seed, site_generator

TOWER_TEXT, TOWER_VISION = range(2)


class DualEncoder(nn.Module):
    def __init__(
        self,
        text_config: TrunkConfig,
        vision_config: TrunkConfig,
        text_pooling: str = "mean",
        vision_pooling: str = "map",
        text_trunk_type: str = "encoder",
        freeze_text: bool = True,
        text_hamming: bool = False,
        logit_scale_init: float = 1 / 0.07,
        trainable_logit_scale: bool = True,
        dtype=torch.float32,
        device="cuda",
        remat: bool = False,
    ):
        super().__init__()
        device = resolve_device(device)
        self.text = BiEncoder(text_config, trunk_type=text_trunk_type, pooling=text_pooling, hamming=text_hamming,
                              freeze=freeze_text, dtype=dtype, device=device, remat=remat)
        self.vision = BiEncoder(vision_config, trunk_type="vision", pooling=vision_pooling, dtype=dtype,
                                device=device, remat=remat)
        self.logit_scale = LogitScale(logit_scale_init, trainable=trainable_logit_scale, device=device)

    def uses_dropout(self) -> bool:
        """True when a forward in the current mode draws noise."""
        return self.text.uses_dropout() or self.vision.uses_dropout()

    @staticmethod
    def _tower_generator(generator: Optional[torch.Generator], tower: int) -> Optional[torch.Generator]:
        return site_generator(noise_seed(generator), tower, device="cpu")

    def encode_text(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                    normalize: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.text(input_ids, attention_mask, normalize=normalize,
                         generator=self._tower_generator(generator, TOWER_TEXT))["embedding"]

    def encode_image(self, pixel_values: torch.Tensor, normalize: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.vision(pixel_values=pixel_values, normalize=normalize,
                           generator=self._tower_generator(generator, TOWER_VISION))["embedding"]

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        pixel_values: Optional[torch.Tensor] = None,
        text_embeddings: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        if text_embeddings is None:
            text_embeddings = self.encode_text(input_ids, attention_mask, generator=generator)
        image_embeddings = self.encode_image(pixel_values, generator=generator)
        loss = clip_loss_symmetric(image_embeddings, text_embeddings, self.logit_scale)
        return {"loss": loss, "text_embedding": text_embeddings, "image_embedding": image_embeddings}
