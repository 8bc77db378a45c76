"""Trainer registry, counterpart of `contrastors_tpu/trainers/__init__.py`:
model_type -> trainer class. The port has every trainer of the JAX
package: the contrastive text trainer, the MLM, multilingual MLM and GLUE
trainers, the image-text trainer (clip, locked_text) and the distill
trainer."""

from contrastors_tpu_torch.trainers.distill import DistillTrainer
from contrastors_tpu_torch.trainers.glue import GlueTrainer
from contrastors_tpu_torch.trainers.image_text import ImageTextTrainer
from contrastors_tpu_torch.trainers.mlm import MLMTrainer
from contrastors_tpu_torch.trainers.mmlm import MMLMTrainer
from contrastors_tpu_torch.trainers.text_text import TextTextTrainer

TRAINER_REGISTRY = {"encoder": TextTextTrainer, "mlm": MLMTrainer, "mmlm": MMLMTrainer, "glue": GlueTrainer,
                    "clip": ImageTextTrainer, "locked_text": ImageTextTrainer, "distill": DistillTrainer}
