"""Optimizer and learning-rate schedules.

Counterpart of `contrastors_tpu/utils/optim.py` (`decay_mask`,
`make_schedule`, `make_optimizer`).

`make_optimizer` is `torch.optim.AdamW` with two parameter groups (weight
decay on and off, `decay_mask`) and a global-norm clip written as optax's
`clip_by_global_norm` writes it: every gradient is multiplied by
min(max / norm, 1), which is (g / norm) * max when the global norm is at
least max, without a branch on the device's value (optax's jnp.where);
torch's `clip_grad_norm_` would add 1e-6 to the norm. The optimizer keeps
that pre-clip norm of its last step in `grad_norm`. The step then equals optax's
`chain(clip_by_global_norm, adamw(mask=decay_mask))`: torch's AdamW
multiplies the parameter by (1 - lr * wd) before the Adam step, which is
optax's decay term lr * wd * p taken on the pre-update parameter, and both
put eps outside the square root, p -= lr * m_hat / (sqrt(v_hat) + eps).
Frozen parameters (`frozen_mask` False) get requires_grad=False and stay
out of both groups, where optax's multi_transform zeroes their updates.

`make_schedule` returns the learning rate of each step, as an optax schedule
does; `lr_scheduler` plugs it into `torch.optim.lr_scheduler.LambdaLR`.
Optax counts the first update as step 0 and LambdaLR starts at 0, so
calling `scheduler.step()` after each `optimizer.step()` gives both the
same learning rate at every update.
"""

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from contrastors_tpu_torch.parallel.collectives import all_reduce_sum, average_replica_grads

NamedParams = Iterable[Tuple[str, torch.nn.Parameter]]


def decay_mask(named_params: NamedParams) -> Dict[str, bool]:
    """True where weight decay applies: not for a name containing
    logit_scale, not for a bias, not for a parameter of squeezed rank < 2
    (norm scales and other vectors)."""
    mask = {}
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        mask[name] = not (
            "logit_scale" in name or leaf == "bias" or sum(d > 1 for d in p.shape) < 2
        )
    return mask


def _linear(init: float, end: float, steps: int, count: float) -> float:
    # optax.linear_schedule (polynomial_schedule, power 1)
    count = min(max(count, 0.0), steps)
    return (init - end) * (1.0 - count / steps) + end


def make_schedule(
    schedule_type: str,
    learning_rate: float,
    total_steps: int,
    warmup_steps: int = 0,
    cooldown_steps: Optional[int] = None,
) -> Callable[[int], float]:
    """linear / cosine / constant / constant_with_warmup / inverse_sqrt after a
    linear warmup that starts at learning_rate / warmup_steps (not 0), with
    an optional linear cooldown to 0 over the last cooldown_steps."""
    w = max(warmup_steps, 1)
    rest = max(total_steps - warmup_steps, 1)
    if schedule_type == "linear":
        main = lambda s: _linear(learning_rate, 0.0, rest, s)  # noqa: E731
    elif schedule_type == "cosine":
        main = lambda s: learning_rate * 0.5 * (1 + math.cos(math.pi * min(s, rest) / rest))  # noqa: E731
    elif schedule_type in ("constant", "constant_with_warmup"):
        main = lambda s: learning_rate  # noqa: E731
    elif schedule_type == "inverse_sqrt":
        # HF inverse_sqrt: lr * sqrt(warmup) / sqrt(step)
        main = lambda s: learning_rate * math.sqrt(w / max(s + warmup_steps, 1))  # noqa: E731
    else:
        raise ValueError(f"unknown schedule_type {schedule_type!r}")

    def sched(step: int) -> float:
        if step < warmup_steps:
            return _linear(learning_rate / w, learning_rate, w, step)
        return main(step - warmup_steps)

    if not cooldown_steps:
        return sched

    def with_cooldown(step: int) -> float:
        base = sched(min(step, total_steps))
        frac = min(max((step - (total_steps - cooldown_steps)) / cooldown_steps, 0.0), 1.0)
        return base * (1.0 - frac)

    return with_cooldown


def lr_scheduler(optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]) -> torch.optim.lr_scheduler.LambdaLR:
    """LambdaLR whose learning rate at step s is schedule(s) in every group
    (each group's base lr must be the schedule's peak learning_rate)."""
    base = optimizer.param_groups[0]["lr"]
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / base)


def global_norm(grads: Iterable[torch.Tensor], split_groups: Optional[Sequence[Tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32 (optax.global_norm).

    Under the tensor and expert axes a rank holds only its shard of a split
    parameter: `split_groups[i]` names the process groups over which
    grads[i] is split (() for a whole one). Each parameter counts once: the
    sums of squares of the split gradients are summed over the groups that
    split them (one all-reduce per kind of split), the whole ones' are
    taken as they are (every peer holds the same), and only then the square
    root."""
    grads = list(grads)
    if not grads:
        return torch.zeros(())
    buckets: Dict[Tuple[int, ...], Tuple[Tuple, List[torch.Tensor]]] = {}
    for g, groups in zip(grads, split_groups or [()] * len(grads)):
        buckets.setdefault(tuple(id(x) for x in groups), (tuple(groups), []))[1].append(g.float().square().sum())
    parts = []
    for groups, sq in buckets.values():
        s = torch.stack(sq).sum()
        for group in groups:
            s = all_reduce_sum(s, group)
        parts.append(s)
    return torch.sqrt(torch.stack(parts).sum())


def split_groups_of(params: Iterable[torch.Tensor]) -> List[Tuple]:
    """The groups that split each parameter (`parallel/sharding.py` sets
    `split_groups` on the parameters it slices; () for a whole one)."""
    return [getattr(p, "split_groups", ()) for p in params]


class AdamW(torch.optim.AdamW):
    """torch.optim.AdamW preceded by optax's global-norm clip. `grad_norm`
    holds the global norm of the gradients of the last step, before the
    clip. On a mesh with model axes the gradients of parameters held whole
    on several peers are first averaged over them
    (`parallel/collectives.py:average_replica_grads`)."""

    def __init__(self, params, max_grad_norm: Optional[float] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.max_grad_norm = max_grad_norm
        self.grad_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"] if p.grad is not None]
        average_replica_grads(params)
        grads = [p.grad for p in params]
        self.grad_norm = global_norm(grads, split_groups_of(params))
        if self.max_grad_norm is not None and self.max_grad_norm > 0 and grads:
            torch._foreach_mul_(grads, (self.max_grad_norm / self.grad_norm).clamp(max=1.0))
        return super().step(closure)


def make_optimizer(
    named_params: NamedParams,
    learning_rate: float,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = None,
    frozen_mask: Optional[Dict[str, bool]] = None,
) -> AdamW:
    """AdamW with the decay partition of `decay_mask`, optional clipping by
    global norm, and a frozen mask (True = trainable) that sets
    requires_grad=False on the rest."""
    named_params = list(named_params)
    if frozen_mask is not None:
        for name, p in named_params:
            if not frozen_mask.get(name, True):
                p.requires_grad_(False)
    mask = decay_mask(named_params)
    live = [(n, p) for n, p in named_params if p.requires_grad]
    groups = [
        {"params": [p for n, p in live if mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in live if not mask[n]], "weight_decay": 0.0},
    ]
    return AdamW([g for g in groups if g["params"]], max_grad_norm=max_grad_norm,
                 lr=learning_rate, betas=(beta1, beta2), eps=eps)
