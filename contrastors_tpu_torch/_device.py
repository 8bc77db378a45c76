"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is
present; they never drift to the CPU quietly. Callers that want the CPU
(the parity tests) pass ``device="cpu"``. A kernel wrapper picks its path
by the tensor it is given (`on_device`): the plain version on a CPU tensor,
the kernel on a CUDA tensor, and nothing else.
"""

from typing import Union

import torch

DeviceLike = Union[str, torch.device]
# the CLIs' --dtype names
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: DeviceLike) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "contrastors_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def on_device(x, cpu_fn, cuda_fn, *args):
    """cpu_fn(*args) for a CPU tensor x, cuda_fn(*args) for a CUDA one;
    any other device raises."""
    if x.device.type == "cpu":
        return cpu_fn(*args)
    if x.device.type == "cuda":
        return cuda_fn(*args)
    raise ValueError(f"the port's kernels run on cuda and their plain versions on cpu, got {x.device}")
