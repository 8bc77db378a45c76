"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source `csrc/<name>.cu` compiles, at first use, into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged source is reused. The build directory
(`contrastors_tpu_torch/_build/`) is listed in .gitignore. Only the
sources in this package are compiled; nvcc is taken from $CUDA_HOME/bin,
then /usr/local/cuda/bin, then $PATH. A build holds an exclusive lock on
`_build/<name>.lock` (`fcntl.flock`, released when its process ends), so
ranks that start together on one checkout compile each library once: the
others wait, then load what the first one wrote.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills of each kernel, in build_logs
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ROTARY = [_P, _P, _L, _I, _I]  # the flash kernels' fused-rotary arguments
# C signature of each library's entry points: name -> (argtypes, restype)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_fwd": {
        # q, k, v, o, lse, seg_q, seg_kv, B, S, T, H, Hkv, D,
        # q/k/v strides (batch, seq, head) x 3, causal, causal_offset,
        # window, c = softmax_scale * log2(e), rotary (cos, sin, batch
        # stride, rot_dim / 2, interleaved; NULL cos = no rotary), stream
        "flash_fwd_bf16": (
            [_P] * 7 + [_I] * 6 + [_L] * 9 + [_I] * 3 + [ctypes.c_float] + _ROTARY + [_P],
            _I,
        ),
    },
    "flash_bwd": {
        # q, k, v, dout, o, lse, delta (written), dq, seg_q, seg_kv, B, S,
        # T, H, Hkv, D, q/k/v/o/dout strides (batch, seq, head) x 5, causal,
        # causal_offset, window, c = softmax_scale * log2(e),
        # softmax_scale, rotary, stream
        "flash_bwd_dq_bf16": (
            [_P] * 10 + [_I] * 6 + [_L] * 15 + [_I] * 3 + [ctypes.c_float] * 2 + _ROTARY + [_P],
            _I,
        ),
        # q, k, v, dout, lse, delta (read), dk, dv, seg_q, seg_kv, B, S, T,
        # H, Hkv, D, q/k/v/dout strides x 4, and the rest as above
        "flash_bwd_dkv_bf16": (
            [_P] * 10 + [_I] * 6 + [_L] * 12 + [_I] * 3 + [ctypes.c_float] * 2 + _ROTARY + [_P],
            _I,
        ),
    },
    "gmm": {
        # lhs, rhs, blk_e, act, out, M, K, N, E, lhs row stride,
        # rhs strides (expert, k, n), stream
        "gmm_bf16": ([_P] * 5 + [_I] * 4 + [_L] * 4 + [_P], _I),
        # lhs, dout, group_sizes, out, M, K, N, E, lhs and dout row strides, stream
        "tgmm_bf16": ([_P] * 4 + [_I] * 4 + [_L] * 2 + [_P], _I),
    },
}
# every library, in the order chip_smoke.py builds them (all at once)
LIBRARIES = tuple(SIGNATURES)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # nvcc wall time of builds in this process
build_logs: Dict[str, str] = {}  # nvcc's messages (ptxas resource usage) of those builds


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources(name: str) -> Sequence[Path]:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for these sources exists
    (or another process builds it meanwhile: then wait for it)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the process that held the lock
            return out
        return _compile(name, out)


def _compile(name: str, out: Path) -> Path:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def ptr(x) -> ctypes.c_void_p:
    """A tensor's data pointer for a C argument; NULL for None."""
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def stream(x) -> ctypes.c_void_p:
    """The current CUDA stream of x's device, for a C argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, with its C signatures set."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib
