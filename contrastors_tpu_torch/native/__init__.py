"""ctypes bindings for the C++ data plane (`dataplane.cpp`), counterpart of
`contrastors_tpu/native/__init__.py`.

The port keeps its own copy of the source. It compiles at first use with
g++ into `contrastors_tpu_torch/_build/dataplane-<hash>.so` (gitignored; the
name carries a hash of the source and flags, so an edit rebuilds), under an
exclusive lock on `_build/dataplane.lock` so that ranks starting together
build it once, and into a temporary file renamed into place. Without a
toolchain (or zlib) the build fails once, says so on stderr, and every
function here returns None: the callers (`data/indexing.py`,
`data/text.py`) then take the pure-Python gzip path, with the same results.
This is host code; nothing here touches the card.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

SRC = Path(__file__).resolve().parent / "dataplane.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")

_lib = None  # None: not tried yet; False: the build failed
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"dataplane-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "dataplane.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():  # built by the process that held the lock
                return out
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp, *LIBS], check=True, capture_output=True)
            except BaseException:
                os.unlink(tmp)
                raise
            os.replace(tmp, out)
            return out
    except (subprocess.CalledProcessError, OSError) as e:
        detail = e.stderr.decode(errors="replace").strip() if isinstance(e, subprocess.CalledProcessError) else e
        print(f"[native] dataplane build failed ({detail}); using the pure-Python gzip path", file=sys.stderr)
        return None


def get_lib():
    """The loaded library, or None where it does not build."""
    global _lib
    with _lock:
        if _lib is None:
            so = _build()
            _lib = False if so is None else _bind(ctypes.CDLL(str(so)))
        return _lib or None


def _bind(lib):
    i64, p_i64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    lib.dp_index_file.restype = i64
    lib.dp_index_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(p_i64)]
    lib.dp_free.argtypes = [ctypes.c_void_p]
    lib.dp_index_many.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, i64, ctypes.POINTER(p_i64), p_i64]
    lib.dp_open.restype = ctypes.c_void_p
    lib.dp_open.argtypes = [ctypes.c_char_p]
    lib.dp_close.argtypes = [ctypes.c_void_p]
    lib.dp_tell.restype = i64
    lib.dp_tell.argtypes = [ctypes.c_void_p]
    lib.dp_read_range.restype = i64
    lib.dp_read_range.argtypes = [ctypes.c_void_p, i64, i64, ctypes.c_char_p]
    return lib


def index_file(path: str) -> Optional[Dict[str, List[int]]]:
    """Newline offsets of a gzip JSONL shard in the loader's format ({row:
    [start, end]} in the decompressed stream), or None when the library is
    unavailable or the shard does not inflate."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int64)()
    n = lib.dp_index_file(path.encode(), ctypes.byref(out))
    if n < 0:
        return None
    offsets = {str(i): [out[2 * i], out[2 * i + 1]] for i in range(n)}
    lib.dp_free(out)
    return offsets


def index_many(paths: List[str], n_threads: int = 8) -> Optional[List[Optional[Dict[str, List[int]]]]]:
    """`index_file` of every path on n_threads threads; a shard that does
    not inflate (a corrupt gzip) gives None in its place."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    results = (ctypes.POINTER(ctypes.c_int64) * n)()
    counts = (ctypes.c_int64 * n)()
    lib.dp_index_many(c_paths, n, n_threads, results, counts)
    out = []
    for i in range(n):
        if counts[i] < 0:
            out.append(None)
            continue
        arr = results[i]
        out.append({str(r): [arr[2 * r], arr[2 * r + 1]] for r in range(counts[i])})
        lib.dp_free(arr)
    return out


class NativeGzipStream:
    """Forward-seekable decompressed view over a local gzip shard: tell,
    seek (a rewind reopens; a forward skip happens in the next read), read
    and close, as the loader uses a `gzip.open` file."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native dataplane unavailable")
        self._lib, self._path = lib, path
        self._pending: Optional[int] = None
        self._h = lib.dp_open(path.encode())
        if not self._h:
            raise OSError(f"dp_open failed for {path}")

    def tell(self) -> int:
        return self._lib.dp_tell(self._h)

    def seek(self, pos: int):
        if pos < self.tell():  # rewind = reopen
            self._lib.dp_close(self._h)
            self._h = self._lib.dp_open(self._path.encode())
            if not self._h:
                # an OSError, which the loader's ShardReadError handling
                # takes; a NULL handle in dp_read_range would crash
                raise OSError(f"dp_open failed reopening {self._path}")
        self._pending = pos

    def read(self, n: int) -> bytes:
        start = self.tell() if self._pending is None else self._pending
        buf = ctypes.create_string_buffer(n)
        got = self._lib.dp_read_range(self._h, start, n, buf)
        self._pending = None
        if got < 0:
            raise OSError(f"dp_read_range failed for {self._path} at {start}")
        return buf.raw[:got]

    def close(self):
        if self._h:
            self._lib.dp_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
