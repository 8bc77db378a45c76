"""Multi-process utilities: one process per GPU through `torch.distributed`.

Counterpart of `contrastors_tpu/utils/dist.py`. JAX runs one process per
host and spreads the data axis over that host's devices inside it; the port
follows the reference's launch instead (`torchrun --nproc-per-node=N`, one
process per card, reference train.py:114-118), so every collective here is
a `torch.distributed` call on the default process group.

`maybe_initialize_distributed` reads torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or takes an explicit
`init_method` (a `file://` store in the tests). It sets the rank's card as
the current device before anything builds or launches a kernel (the kernel
wrappers launch on the current stream of the tensor's device). The backend
is NCCL for the card and gloo for the CPU; gloo on the card only when the
caller names it (argument or CONTRASTORS_DIST_BACKEND), as two ranks that
share one card must: NCCL refuses two ranks on one device. A backend that
fails to come up raises; nothing switches to another quietly.
"""

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKEND_ENV = "CONTRASTORS_DIST_BACKEND"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def maybe_initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank_: Optional[int] = None,
    world_size: Optional[int] = None,
    device=None,
) -> bool:
    """Join the process group when this process is one rank of several:
    torchrun's RANK and WORLD_SIZE are set, or `init_method` is given (then
    with `rank_` and `world_size`). Returns True when the group is up (also
    when it already was), False for a lone process, which stays as it is.

    `device` is the rank's device: default `cuda:LOCAL_RANK` when a card is
    present, else the CPU. A CUDA device becomes the current device here,
    before any kernel is built or launched. `backend` defaults to
    $CONTRASTORS_DIST_BACKEND, else "nccl" on a card and "gloo" on the CPU.
    """
    if is_initialized():
        return True
    env_rank, env_world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if init_method is None and (env_rank is None or env_world is None):
        return False
    r = int(env_rank) if rank_ is None else int(rank_)
    w = int(env_world) if world_size is None else int(world_size)
    if device is None:
        device = f"cuda:{local_rank() if env_rank is not None else r}" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or os.environ.get(BACKEND_ENV) or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; pass backend='gloo' for the CPU")
    kwargs = {"backend": backend, "rank": r, "world_size": w}
    if init_method is not None:
        kwargs["init_method"] = init_method
    dist.init_process_group(**kwargs)
    return True


def destroy():
    """Leave the process group (a no-op for a lone process)."""
    if is_initialized():
        dist.destroy_process_group()


def barrier():
    if world() > 1:
        dist.barrier()


def gather_objects(value) -> list:
    """Every rank's value (picklable), in rank order; [value] alone."""
    if world() == 1:
        return [value]
    out = [None] * world()
    dist.all_gather_object(out, value)
    return out


def rank0_print(*args, **kwargs):
    """print on rank 0 only."""
    if rank() == 0:
        print(*args, **kwargs)


def _reduce_host(metrics: Dict[str, float], op) -> Dict[str, float]:
    """Reduce the scalar entries of metrics across ranks with op (a numpy
    reduction over the gathered [world, n] matrix), in float32 as JAX's
    `process_allgather` of a float32 vector; other entries stay as they
    are. Every rank must hold the same scalar keys."""
    if world() == 1 or not metrics:
        return metrics
    keys = sorted(k for k, v in metrics.items() if isinstance(v, (int, float, np.floating)))
    if not keys:
        return metrics
    local = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float32)
    if dist.get_backend() == "nccl":
        local = local.cuda()
    parts = [torch.empty_like(local) for _ in range(world())]
    dist.all_gather(parts, local)
    gathered = torch.stack(parts).cpu().numpy()
    out = dict(metrics)
    for k, v in zip(keys, op(gathered, axis=0)):
        out[k] = float(v)
    return out


def process_allmean(metrics: Dict[str, float]) -> Dict[str, float]:
    """The mean of scalar host metrics across ranks (reference
    base.py:485-498); a no-op for one process."""
    return _reduce_host(metrics, np.mean)


def process_allmin(metrics: Dict[str, float]) -> Dict[str, float]:
    """The minimum of scalar host metrics across ranks, for gates where one
    bad rank must flip the global decision."""
    return _reduce_host(metrics, np.min)
