"""One rank of the port's data-parallel CPU tests, and their launcher.

    python tests/torch_dist_worker.py <cases module> <rank> <world> <workdir>

joins a gloo process group through a `file://` store in <workdir> (no TCP
port to collide under pytest-xdist), imports <cases module> from tests/,
runs every function of its CASES in order as fn(rank, world, workdir) and
saves each result as <workdir>/<case>.rank<r>.pt. It imports no JAX: the
ranks are what a torchrun rank would be. `launch` starts the ranks in the
background and `collect` waits for them and loads their results.
"""

import importlib
import os
import subprocess
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def launch(cases_module: str, workdir: str, world: int = 2) -> List[subprocess.Popen]:
    """Start `world` ranks running cases_module's CASES; logs in workdir."""
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), cases_module, str(rank),
                                       str(world), workdir], stdout=log, stderr=subprocess.STDOUT, env=env))
        log.close()
    return procs


def collect(procs: List[subprocess.Popen], workdir: str, timeout: float = 300) -> Dict[str, list]:
    """Wait for every rank (killing all at the timeout) and return {case:
    [rank 0's result, rank 1's, ...]}; a failed rank raises with its log."""
    import torch

    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for rank in range(len(procs)):
        with open(os.path.join(workdir, f"rank{rank}.log")) as f:
            logs.append(f.read())
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n----\n".join(logs))
    out: Dict[str, list] = {}
    for name in sorted(os.listdir(workdir)):
        if name.endswith(".pt") and ".rank" in name:
            case, rank = name[:-3].rsplit(".rank", 1)
            out.setdefault(case, [None] * len(procs))[int(rank)] = torch.load(
                os.path.join(workdir, name), weights_only=False)
    return out


def main(argv):
    cases_module, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path[:0] = [ROOT, HERE]
    import torch

    torch.set_num_threads(2)
    from contrastors_tpu_torch.utils.dist import destroy, maybe_initialize_distributed

    maybe_initialize_distributed(backend="gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                                 rank_=rank, world_size=world, device="cpu")
    try:
        cases = importlib.import_module(cases_module)
        for name, fn in cases.CASES.items():
            torch.save(fn(rank, world, workdir), os.path.join(workdir, f"{name}.rank{rank}.pt"))
    finally:
        destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
