"""Teacher -> student embedding distillation (model_type: distill), in
PyTorch.

Counterpart of `contrastors_tpu/trainers/distill.py:DistillTrainer`, a
`TextTextTrainer`:
  - the teacher is `tower_model_args` through `load_biencoder`, frozen
    (no parameter takes a gradient, and the optimizer never sees it), in
    eval mode; its embeddings are computed under `torch.no_grad()`,
    unnormalised, as JAX's `stop_gradient(apply(..., normalize=False))`;
  - the student is `model_args` with `n_positions = seq_len`, and with
    `distill_init_pretrained` its trunk starts from the teacher's
    (`losses_distill.init_student_from_teacher`, student layer i from
    teacher layer i * (n_teacher // n_student));
  - the logit scale is a `LogitScale` that does not train (no loss mode
    reads it);
  - one AdamW update a loop step, no gradient accumulation: the step
    encodes both student towers (each with its generator under the step's
    seed, for dropout), both teacher towers, takes `distill_loss` in
    `train_args.distill_loss_fn` mode, and reports the mode's terms and
    `grad_norm` beside the loss.
Data-parallel, the loss is JAX's on the global batch: every rank gathers
the four embedding matrices (the student's differentiably) and computes the
whole loss; the step backpropagates it divided by the world size, so the
summed gradients are its gradients. Under the tensor and expert axes the
teacher is broadcast and split like the student (`placed_modules`).
"""

from typing import Callable, Dict

import torch

from contrastors_tpu_torch.losses_distill import distill_loss, init_student_from_teacher
from contrastors_tpu_torch.models.biencoder import LogitScale
from contrastors_tpu_torch.ops.dropout import noise_seed, site_generator
from contrastors_tpu_torch.parallel.collectives import all_gather_rows
from contrastors_tpu_torch.trainers.base import make_standard_train_step
from contrastors_tpu_torch.trainers.text_text import TextTextTrainer

Batch = Dict[str, torch.Tensor]


class DistillTrainer(TextTextTrainer):
    def _uses_grad_accumulation(self) -> bool:
        return False  # the step updates every loop step

    def get_model(self) -> torch.nn.ModuleDict:
        from contrastors_tpu_torch.models.auto import load_biencoder

        margs = self.config.model_args
        teacher_args = self.config.tower_model_args
        if teacher_args is None:
            raise ValueError("distill needs tower_model_args (the teacher)")
        self.teacher, _ = load_biencoder(teacher_args, dtype=self.dtype, device=self.device, seed=self.seed)
        self.teacher.eval().requires_grad_(False)

        overrides = {"n_positions": margs.seq_len} if margs.seq_len else {}
        self.biencoder, self.trunk_config = load_biencoder(margs, dtype=self.dtype, device=self.device,
                                                           seed=self.seed + 1, trunk_overrides=overrides)
        if margs.distill_init_pretrained:
            n_teacher, n_student = len(self.teacher.trunk.layers), len(self.biencoder.trunk.layers)
            stride = max(n_teacher // max(n_student, 1), 1)
            self.biencoder.trunk.load_state_dict(init_student_from_teacher(
                self.biencoder.trunk.state_dict(), self.teacher.trunk.state_dict(), layer_stride=stride))
        self.logit_scale = LogitScale(margs.logit_scale, trainable=False, device=self.device)
        return torch.nn.ModuleDict({"model": self.biencoder, "logit_scale": self.logit_scale})

    def placed_modules(self) -> Dict[str, torch.nn.Module]:
        # the teacher runs in the step: broadcast and split like the student
        return {"model": self.model, "teacher": self.teacher}

    def make_train_step(self) -> Callable[[Batch, torch.Generator], Dict[str, torch.Tensor]]:
        ta = self.config.train_args
        student, teacher = self.biencoder, self.teacher
        mode, temperature = ta.distill_loss_fn, ta.distill_temperature

        def loss_fn(batch: Batch, generator: torch.Generator):
            seed = noise_seed(generator)
            towers = [(batch[f"{col}_input_ids"], batch[f"{col}_attention_mask"]) for col in ("query", "document")]
            # one generator per student tower, as JAX splits its rng into rq, rd
            sq, sd = (student(ids, mask, generator=site_generator(seed, i, device=ids.device))["embedding"]
                      for i, (ids, mask) in enumerate(towers))
            with torch.no_grad():
                tq, td = (teacher(ids, mask, normalize=False)["embedding"] for ids, mask in towers)
            sq, sd, tq, td = (all_gather_rows(x, self.group) for x in (sq, sd, tq, td))
            losses = distill_loss(mode, sq, sd, tq, td, temperature=temperature)
            loss = losses.pop("loss")
            return loss, {k: v.detach() for k, v in losses.items()}

        return make_standard_train_step(loss_fn, self.optimizer, self.scheduler, group=self.group)
