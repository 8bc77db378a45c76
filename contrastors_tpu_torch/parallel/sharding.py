"""Optimizer-state sharding over the data axis (ZeRO-2 style).

Counterpart of `contrastors_tpu/parallel/sharding.py:shard_optimizer_state`
(reference: DeepSpeed stage 2, configs/deepspeed/ds_config.json). A leaf
with at least `min_size` elements and a leading dim divisible by the data
axis keeps its Adam moments on one rank per block of rows: rank r owns rows
[r * n / W, (r + 1) * n / W). Every rank still holds the whole parameter and
its whole (all-reduced) gradient; the update of a sharded leaf runs on the
owner's rows only, and the updated rows of every sharded leaf are
all-gathered together, one flat buffer per dtype. Elementwise AdamW
on a block of rows gives those rows' values of the whole-tensor update, and
the clip's global norm is taken over the whole gradients in the replicated
order, so the parameters equal the replicated run's exactly.

JAX's `tp_param_spec` and `param_shardings` (the tensor and expert axes) are
not ported (ROADMAP Queue 1, item 5).
"""

from typing import Dict, List

import torch
import torch.distributed as dist

from contrastors_tpu_torch.parallel.mesh import Mesh
from contrastors_tpu_torch.utils.optim import AdamW, global_norm


def shardable(p: torch.Tensor, data: int, min_size: int) -> bool:
    return p.ndim >= 1 and p.numel() >= min_size and p.shape[0] % data == 0


class ShardedAdamW(AdamW):
    """`AdamW` (the global-norm clip, then torch's AdamW) whose moments of
    large leaves live on their owner rank. `full_params` are the model's
    parameters in the replicated optimizer's order; `sharded` says which of
    them the optimizer sees as this rank's block of rows."""

    def __init__(self, optimizer: AdamW, mesh: Mesh, min_size: int = 2**16):
        self.mesh = mesh
        self.full_params: List[torch.Tensor] = []
        self.sharded: List[bool] = []
        self._views: List[torch.Tensor] = []
        groups = []
        for g in optimizer.param_groups:
            params = []
            for p in g["params"]:
                split = shardable(p, mesh.data, min_size)
                view = p.detach().chunk(mesh.data)[mesh.rank] if split else p
                self.full_params.append(p)
                self.sharded.append(split)
                self._views.append(view)
                params.append(view)
            groups.append({**{k: v for k, v in g.items() if k != "params"}, "params": params})
        defaults = optimizer.defaults
        super().__init__(groups, max_grad_norm=optimizer.max_grad_norm, lr=defaults["lr"],
                         betas=defaults["betas"], eps=defaults["eps"], weight_decay=defaults["weight_decay"])

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none)
        for p in self.full_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for p in self.full_params if p.grad is not None]
        self.grad_norm = global_norm(grads)
        if self.max_grad_norm is not None and self.max_grad_norm > 0 and grads:
            torch._foreach_mul_(grads, (self.max_grad_norm / self.grad_norm).clamp(max=1.0))
        for p, view, split in zip(self.full_params, self._views, self.sharded):
            if split:
                view.grad = None if p.grad is None else p.grad.chunk(self.mesh.data)[self.mesh.rank]
        out = torch.optim.AdamW.step(self, closure)
        self.gather_updated_rows()
        return out

    @torch.no_grad()
    def gather_updated_rows(self):
        """Every rank's updated rows of the sharded leaves into every rank's
        parameters: one all-gather of a flat buffer per dtype (every rank's
        buffer holds the same leaves, as every rank holds the same
        gradients)."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p, split in zip(self.full_params, self.sharded):
            if split and p.grad is not None:
                by_dtype.setdefault(p.dtype, []).append(p)
        data, rank = self.mesh.data, self.mesh.rank
        for params in by_dtype.values():
            own = torch.cat([p.detach().chunk(data)[rank].reshape(-1) for p in params])
            parts = [torch.empty_like(own) for _ in range(data)]
            dist.all_gather(parts, own)
            sizes = [p.numel() // data for p in params]
            for r, flat in enumerate(parts):
                if r != rank:
                    rows = [p.detach().chunk(data)[r] for p in params]
                    torch._foreach_copy_(rows, [v.view_as(t) for v, t in zip(flat.split(sizes), rows)])


def shard_optimizer_state(optimizer: AdamW, mesh: Mesh, min_size: int = 2**16) -> AdamW:
    """The optimizer with its large leaves' moments sharded over the data
    axis; the optimizer itself for one rank. Call before the first step
    (the moments start empty)."""
    if mesh.data <= 1:
        return optimizer
    return ShardedAdamW(optimizer, mesh, min_size)


def optimizer_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The whole parameters an optimizer updates (a sharded one's
    `full_params`)."""
    full = getattr(optimizer, "full_params", None)
    if full is not None:
        return list(full)
    return [p for g in optimizer.param_groups for p in g["params"]]
