"""Trainer registry, counterpart of `contrastors_tpu/trainers/__init__.py`:
model_type -> trainer class. The port has the contrastive text trainer and
the MLM, multilingual MLM and GLUE trainers; every other model_type raises
NotImplementedError naming its ROADMAP item."""

from contrastors_tpu_torch.trainers.glue import GlueTrainer
from contrastors_tpu_torch.trainers.mlm import MLMTrainer
from contrastors_tpu_torch.trainers.mmlm import MMLMTrainer
from contrastors_tpu_torch.trainers.text_text import TextTextTrainer

# model_type -> the ROADMAP item that ports its trainer
UNPORTED = {
    "clip": "Queue 1, item 7 (vision / LiT)",
    "locked_text": "Queue 1, item 7 (vision / LiT)",
    "distill": "Queue 1, item 9 (distill)",
}


def _unported(model_type: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"model_type {model_type!r}: its trainer is not ported yet "
                                  f"(ROADMAP {UNPORTED[model_type]})")

    return build


TRAINER_REGISTRY = {"encoder": TextTextTrainer, "mlm": MLMTrainer, "mmlm": MMLMTrainer, "glue": GlueTrainer,
                    **{name: _unported(name) for name in UNPORTED}}
