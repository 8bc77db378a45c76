"""The collectives of the data-parallel step, on `torch.distributed`.

`all_gather_rows` is JAX's `jax.lax.all_gather(x, axis, axis=0, tiled=True)`
as a `torch.autograd.Function`: the forward concatenates every rank's rows
in rank order, and the backward is the transpose, the sum of the incoming
gradient over ranks, of which this rank keeps its own rows. It is written
from the list form of `all_gather` and from `all_reduce`, which both NCCL
and gloo run on CUDA and CPU tensors (gloo has no `reduce_scatter`). It is
not `torch.distributed.nn.all_gather`, whose backward is the thing the
tests pin down.

`group` is a process group (`Mesh.group`), or None for a lone process: then
every function here is the identity.
"""

from typing import Dict, Iterable, List, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.rows = group, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.rows
        return grad[lo:lo + ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along dim 0 in rank order,
    differentiably; x itself for a lone process."""
    if group is None:
        return x
    return _AllGatherRows.apply(x, group)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], group) -> None:
    """Sum every parameter's .grad over the ranks in place, with one
    all-reduce over a flat buffer per dtype. Parameters without a gradient
    are left out, so every rank must hold gradients for the same ones."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    seen = set()
    for p in params:
        if p.grad is not None and id(p) not in seen:
            seen.add(id(p))
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor], group, summed: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Scalar device metrics reduced over the ranks in one all-reduce:
    averaged, as a rank's loss and metrics are estimates whose mean over
    the ranks is the global value, except the keys in `summed` (grad
    cache's, which are JAX's psums). Non-tensor entries pass."""
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return metrics
    vec = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(vec, group=group)
    world = dist.get_world_size(group)
    out = dict(metrics)
    for i, k in enumerate(keys):
        out[k] = vec[i] if k in summed else vec[i] / world
    return out


@torch.no_grad()
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of x over the ranks (no gradient); x for one process."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x
