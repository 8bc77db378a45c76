"""The standard train step with gradient accumulation, in PyTorch.

Counterpart of `BaseTrainer.make_standard_train_step`
(`contrastors_tpu/trainers/base.py:208-267`): one forward and backward per
micro-batch; with gradient_accumulation_steps = N the gradients of N
micro-batches are summed (in the fp32 parameters' .grad, in micro-batch
order, as JAX adds its gradient trees) and the optimizer applies their mean
on the N-th. `grad_norm` is the global norm of that mean before the clip,
reported on the update's micro-step only, as in JAX. The trainer loop,
checkpoints and logging of `BaseTrainer` wait for a later slice (ROADMAP,
Queue 1).
"""

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from contrastors_tpu_torch.utils.optim import AdamW

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_standard_train_step(
    loss_fn: LossFn,
    optimizer: AdamW,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    gradient_accumulation_steps: int = 1,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns step(batch) -> metrics, which updates the parameters of
    `optimizer` in place every gradient_accumulation_steps calls. loss_fn
    (batch) -> (loss, metrics); the step's metrics are those plus "loss" and,
    on an update, "grad_norm". Its phases are the profiler ranges
    "train_step/forward", "train_step/backward" and "train_step/optimizer"."""
    ga = max(1, int(gradient_accumulation_steps or 1))
    params = [p for group in optimizer.param_groups for p in group["params"]]
    micro = 0

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        nonlocal micro
        if micro % ga == 0:
            optimizer.zero_grad(set_to_none=True)
        with record_function("train_step/forward"):
            loss, metrics = loss_fn(batch)
        with record_function("train_step/backward"):
            loss.backward()  # adds this micro-batch's gradients into .grad
        micro += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        if micro % ga == 0:
            with record_function("train_step/optimizer"):
                if ga > 1:
                    torch._foreach_div_([p.grad for p in params if p.grad is not None], float(ga))
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
            metrics["grad_norm"] = optimizer.grad_norm
        return metrics

    return step
