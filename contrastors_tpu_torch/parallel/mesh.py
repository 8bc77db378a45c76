"""The device layout of a run (data x expert x tensor), and batch placement.

Counterpart of `contrastors_tpu/parallel/mesh.py`. JAX builds a
`jax.sharding.Mesh` over the devices of one process, shaped
(data, expert, tensor), and lets GSPMD (or `shard_map`) split the global
batch over "data" and the parameters over "expert" and "tensor"
(`parallel/sharding.py`). The port runs one process per GPU instead, as the
reference does (`torchrun`, one rank a card), so the mesh is a small record
of the process group: the global ranks are laid out as JAX lays out its
devices (`np.asarray(devices).reshape(data, expert, tensor)`: tensor is the
fastest-varying coordinate), and each axis has a process group, built by
`torch.distributed.new_group` in the same order on every rank:

  - the data group: the ranks that share this rank's (expert, tensor)
    coordinate. They hold different rows of the global batch; gradients and
    metrics are summed over it. With no expert or tensor axis it is the
    default group.
  - the expert group: the ranks that share (data, tensor). They hold the
    same rows and different experts of every MoE layer.
  - the tensor group: the ranks that share (data, expert). They hold the
    same rows and different heads and hidden columns of every split layer
    (Megatron's column and row splits).

An axis of size 1 has no group (None), and every collective over None is
the identity. JAX's `shard_map` has no counterpart: a rank's code is
already the per-device body, and the collectives GSPMD would insert are
explicit calls (`parallel/collectives.py`).
"""

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from contrastors_tpu_torch.utils import dist as dist_utils


@dataclass(frozen=True)
class AxisPart:
    """This rank's part of a split axis: the axis' group, its size and this
    rank's index on it."""

    group: Any
    size: int
    rank: int


@dataclass(frozen=True)
class Mesh:
    """data, expert, tensor: the axes' sizes. rank: this process's
    coordinate on the data axis (which rows of a global batch it reads);
    expert_rank, tensor_rank: its coordinates on the other two;
    global_rank: its rank in the process group. data_group, expert_group,
    tensor_group: the axes' process groups (module docstring)."""

    data: int = 1
    expert: int = 1
    tensor: int = 1
    rank: int = 0
    expert_rank: int = 0
    tensor_rank: int = 0
    global_rank: int = 0
    data_group: Optional[Any] = None
    expert_group: Optional[Any] = None
    tensor_group: Optional[Any] = None

    @property
    def group(self) -> Optional[Any]:
        """The data axis' group: the losses', grad cache's and the gradient
        all-reduce's `group`."""
        return self.data_group

    @property
    def layout(self) -> Tuple[int, int, int]:
        return (self.data, self.expert, self.tensor)

    @property
    def leads_data_rank(self) -> bool:
        """True for the one rank of each data coordinate that writes what
        belongs to the rows (the data cursor): (expert, tensor) = (0, 0)."""
        return self.expert_rank == 0 and self.tensor_rank == 0

    @property
    def data_part(self) -> Optional[AxisPart]:
        return AxisPart(self.data_group, self.data, self.rank) if self.data > 1 else None

    @property
    def tensor_part(self) -> Optional[AxisPart]:
        return AxisPart(self.tensor_group, self.tensor, self.tensor_rank) if self.tensor > 1 else None

    @property
    def expert_part(self) -> Optional[AxisPart]:
        return AxisPart(self.expert_group, self.expert, self.expert_rank) if self.expert > 1 else None


def _layout_error(data: int, expert: int, tensor: int, world: int) -> ValueError:
    if expert == 1 and tensor == 1:
        return ValueError(
            f"parallel_args.data={data} but the process group has {world} rank(s): the port runs one "
            f"process per device of the data axis (launch with torchrun --nproc-per-node={data})")
    need = f"{data * expert * tensor}" if data != -1 else f"a multiple of {expert * tensor}"
    return ValueError(
        f"parallel_args (data, expert, tensor) = ({data}, {expert}, {tensor}) needs {need} rank(s) but the "
        f"process group has {world}: the port runs one process per device of the mesh (launch with "
        f"torchrun --nproc-per-node=data*expert*tensor)")


def make_mesh(data: int = -1, tensor: int = 1, expert: int = 1) -> Mesh:
    """The mesh of this process group: data * expert * tensor must equal
    the world size; data = -1 means world / (expert * tensor)."""
    world = dist_utils.world()
    if tensor < 1 or expert < 1 or world % (tensor * expert):
        raise _layout_error(data, expert, tensor, world)
    if data == -1:
        data = world // (tensor * expert)
    if data * expert * tensor != world:
        raise _layout_error(data, expert, tensor, world)
    g = dist_utils.rank()
    d, e, t = g // (expert * tensor), (g // tensor) % expert, g % tensor
    if not dist_utils.is_initialized():
        return Mesh(data=data, expert=expert, tensor=tensor)
    if expert == 1 and tensor == 1:
        return Mesh(data=data, rank=d, global_rank=g, data_group=dist.group.WORLD)

    def rank_of(dd, ee, tt):
        return (dd * expert + ee) * tensor + tt

    def groups(size, members) -> Optional[Any]:
        """One group per fixed coordinate of the other two axes, created in
        the same order on every rank; this rank's, or None for size 1."""
        if size == 1:
            return None
        mine = None
        for ranks in members:
            pg = dist.new_group(ranks)
            if g in ranks:
                mine = pg
        return mine

    data_group = groups(data, [[rank_of(dd, ee, tt) for dd in range(data)]
                               for ee in range(expert) for tt in range(tensor)])
    expert_group = groups(expert, [[rank_of(dd, ee, tt) for ee in range(expert)]
                                   for dd in range(data) for tt in range(tensor)])
    tensor_group = groups(tensor, [[rank_of(dd, ee, tt) for tt in range(tensor)]
                                   for dd in range(data) for ee in range(expert)])
    return Mesh(data=data, expert=expert, tensor=tensor, rank=d, expert_rank=e, tensor_rank=t,
                global_rank=g, data_group=data_group, expert_group=expert_group, tensor_group=tensor_group)


def data_axis_size(mesh: Mesh) -> int:
    return mesh.data


def divisor_chunk(chunk: int, rows: int) -> int:
    """Largest chunk size <= chunk that divides rows (grad-cache chunking is
    execution-only, so clamping to the local rows is always exact)."""
    c = max(1, min(int(chunk), int(rows)))
    while rows % c:
        c -= 1
    return c


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of n rows (by its data
    coordinate: its expert and tensor peers read the same rows)."""
    if n % mesh.data:
        raise ValueError(f"a global batch of {n} rows does not divide over {mesh.data} ranks")
    per = n // mesh.data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: Mesh, device, is_global: bool = False) -> Dict[str, torch.Tensor]:
    """A host batch on this rank's device. A rank's own batch (what the
    loaders yield on each rank) goes as it is; with is_global the batch is
    the global one and this rank takes its rows."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        if is_global:
            t = t[local_rows(t.shape[0], mesh)]
        out[k] = t.to(device, non_blocking=True)
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of the whole module broadcast from global
    rank 0 over the world, in place, one flat buffer per dtype (a no-op for
    one process). Call it before `parallel/sharding.py:shard_module`."""
    if dist_utils.world() > 1:
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t.data)
        for tensors in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src=0)
            torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]),
                                                                       tensors)])
    return module


@torch.no_grad()
def fingerprint(tensors: Iterable[torch.Tensor]) -> float:
    """A float64 checksum of tensors, position-weighted, to compare replicas
    across ranks."""
    return float(sum((i + 1) * float(t.detach().double().sum()) for i, t in enumerate(tensors)))
