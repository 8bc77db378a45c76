"""The data-parallel layout of a run, and batch placement.

Counterpart of `contrastors_tpu/parallel/mesh.py`. JAX builds a
`jax.sharding.Mesh` over the devices of one process and lets GSPMD (or
`shard_map`) split a global batch over its "data" axis. The port runs one
process per GPU instead, as the reference does (`torchrun`, one rank a
card), so the mesh is a small record of the process group: the data axis
is the world size and each rank holds its own rows. JAX's `shard_map` has
no counterpart: a rank's code is already the per-device body, and the
collectives it would insert are explicit calls (`parallel/collectives.py`).

The tensor and expert axes are not ported (ROADMAP Queue 1, item 5): a mesh
that asks for them raises NotImplementedError.
"""

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from contrastors_tpu_torch.utils import dist as dist_utils

UNPORTED_AXES = "ROADMAP Queue 1, item 5"


@dataclass(frozen=True)
class Mesh:
    """data: ranks on the data axis (the world size); rank: this process's
    index on it. expert and tensor are 1 (the only sizes the port runs)."""

    data: int = 1
    expert: int = 1
    tensor: int = 1
    rank: int = 0

    @property
    def group(self) -> Optional[Any]:
        """The process group of the data axis (the default group), or None
        for a lone process: the losses' and grad cache's `group`."""
        return dist.group.WORLD if dist_utils.is_initialized() else None


def make_mesh(data: int = -1, tensor: int = 1, expert: int = 1) -> Mesh:
    """The mesh of this process group: data = -1 means the world size, and
    any other data must equal it."""
    if tensor != 1 or expert != 1:
        raise NotImplementedError(
            f"parallel_args tensor={tensor} expert={expert}: the port has the data axis only; tensor and "
            f"expert parallelism are not ported ({UNPORTED_AXES})")
    world = dist_utils.world()
    if data == -1:
        data = world
    if data != world:
        raise ValueError(
            f"parallel_args.data={data} but the process group has {world} rank(s): the port runs one "
            f"process per device of the data axis (launch with torchrun --nproc-per-node={data})")
    return Mesh(data=data, rank=dist_utils.rank())


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
    """This rank's rows of a global batch of n rows."""
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
    """Every parameter and buffer of module broadcast from rank 0, in place
    (a no-op for one rank)."""
    if mesh.data > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


@torch.no_grad()
def fingerprint(tensors: Iterable[torch.Tensor]) -> float:
    """A float64 checksum of tensors, position-weighted, to compare replicas
    across ranks."""
    return float(sum((i + 1) * float(t.detach().double().sum()) for i, t in enumerate(tensors)))
