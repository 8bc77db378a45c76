"""The collectives of the data-parallel step, on `torch.distributed`.

`all_gather_rows` is JAX's `jax.lax.all_gather(x, axis, axis=0, tiled=True)`
as a `torch.autograd.Function`: the forward concatenates every rank's rows
in rank order, and the backward is the transpose, the sum of the incoming
gradient over ranks, of which this rank keeps its own rows. It is written
from the list form of `all_gather` and from `all_reduce`, which both NCCL
and gloo run on CUDA and CPU tensors (gloo has no `reduce_scatter`). It is
not `torch.distributed.nn.all_gather`, whose backward is the thing the
tests pin down.

Megatron's two functions for the tensor and expert axes (Shoeybi et al.
2019, its `f` and `g`) are `torch.autograd.Function`s over a model group
(`Mesh.tensor_group`, `Mesh.expert_group`), written from `all_reduce` too:
  - `copy_to_group`: the identity forward and an all-reduce backward, where
    replicated compute enters a split region (the input of a column split,
    the tokens and combine weights of the local experts): each peer's
    gradient there is its part of the whole;
  - `reduce_from_group`: an all-reduce forward and the identity backward,
    where a split region leaves (the output of a row split, the local
    experts' partial sums).
`gather_from_group` and `scatter_to_group` take a split last dim whole and
back, for a replicated step inside a split region (EVA02's LayerNorm over
the hidden width). Each takes one group or a tuple of groups (each in
turn: the sum over a tuple is the sum over all their ranks).

`group` is a process group (`Mesh.group`), or None for a lone process or an
axis of size 1: then every function here is the identity.
"""

import math
from typing import Dict, Iterable, List, Sequence, Tuple

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
def average_replica_grads(params: Iterable[torch.Tensor]) -> None:
    """Average each parameter's .grad over the groups in its
    `replica_groups` (the model axes that hold it whole:
    `parallel/sharding.py:shard_module` sets them), in place, one flat
    buffer per kind of parameter and dtype. Those peers compute the same
    gradient from the same rows, but a backward that adds with atomics (an
    embedding's, a scatter-add's) can round it differently on each; the
    average keeps the replicas equal after the update. A parameter without
    replica groups is left as it is."""
    kinds: Dict[Tuple, Tuple[Tuple, List[torch.Tensor]]] = {}
    seen = set()
    for p in params:
        groups = getattr(p, "replica_groups", ())
        if p.grad is None or not groups or id(p) in seen:
            continue
        seen.add(id(p))
        kinds.setdefault((tuple(id(g) for g in groups), p.grad.dtype), (groups, []))[1].append(p.grad)
    for groups, grads in kinds.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for g in groups:
            dist.all_reduce(flat, group=g)
        flat /= float(math.prod(dist.get_world_size(g) for g in groups))
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


def _groups(group) -> Tuple:
    """The groups of a group or a tuple of groups, without the Nones."""
    return tuple(g for g in (group if isinstance(group, tuple) else (group,)) if g is not None)


def _all_reduce_copy(x: torch.Tensor, groups: Tuple) -> torch.Tensor:
    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, groups: Tuple) -> torch.Tensor:
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_reduce_copy(grad, ctx.groups), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, groups: Tuple) -> torch.Tensor:
        return _all_reduce_copy(x, groups)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over the group(s) (Megatron's `f`)."""
    groups = _groups(group)
    return _CopyToGroup.apply(x, groups) if groups else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group(s), whose gradient passes as it is
    (Megatron's `g`)."""
    groups = _groups(group)
    return _ReduceFromGroup.apply(x, groups) if groups else x


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.width = group, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        lo = dist.get_rank(ctx.group) * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


class _ScatterLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        width = x.shape[-1] // dist.get_world_size(group)
        lo = dist.get_rank(group) * width
        return x[..., lo:lo + width].contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _GatherLastDim.apply(grad, ctx.group), None


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Every peer's x concatenated along the last dim in group order (the
    whole of a split width, the same on every peer); the backward keeps this
    peer's columns of the (equal) incoming gradients."""
    return x if group is None else _GatherLastDim.apply(x, group)


def scatter_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """This peer's columns of a whole (replicated) x; the backward gathers
    the peers' gradients back to the whole width."""
    return x if group is None else _ScatterLastDim.apply(x, group)
