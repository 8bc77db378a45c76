"""Trainer registry, counterpart of `contrastors_tpu/trainers/__init__.py`:
model_type -> trainer class. The port has the contrastive text trainer, the
MLM, multilingual MLM and GLUE trainers and the image-text trainer (clip,
locked_text); the distill trainer raises NotImplementedError naming its
ROADMAP item."""

from contrastors_tpu_torch.trainers.glue import GlueTrainer
from contrastors_tpu_torch.trainers.image_text import ImageTextTrainer
from contrastors_tpu_torch.trainers.mlm import MLMTrainer
from contrastors_tpu_torch.trainers.mmlm import MMLMTrainer
from contrastors_tpu_torch.trainers.text_text import TextTextTrainer

# model_type -> the ROADMAP item that ports its trainer
UNPORTED = {
    "distill": "Queue 1, item 9 (distill)",
}


def _unported(model_type: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"model_type {model_type!r}: its trainer is not ported yet "
                                  f"(ROADMAP {UNPORTED[model_type]})")

    return build


TRAINER_REGISTRY = {"encoder": TextTextTrainer, "mlm": MLMTrainer, "mmlm": MMLMTrainer, "glue": GlueTrainer,
                    "clip": ImageTextTrainer, "locked_text": ImageTextTrainer,
                    **{name: _unported(name) for name in UNPORTED}}
