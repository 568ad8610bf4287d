"""Build and bind the port's CUDA kernels.

Every `dss_tpu_torch/csrc/*.cu` is compiled for `sm_90a` at first use,
one `nvcc` per source, all started together, and the objects are linked
into one shared library in `build/torch_kernels/` beside the package.
The library is named by the digest of all sources (`*.cu` and `*.cuh`)
and flags, so an edited source builds anew.  Each
kernel has a plain C entry (no PyTorch headers, so the build takes
seconds) that launches on the stream it is given and returns
`cudaGetLastError()`; `function()` binds one with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()


def sources() -> list:
    """The `.cu` files that make up the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels cannot be built"
        )
    return cand


def build() -> Path:
    """Compile csrc/*.cu into one shared library (once per digest) and
    return its path.  One nvcc per source runs at once, so the build
    takes as long as the slowest source; the link writes a temporary
    name that is then renamed, so a process building concurrently never
    loads a half-written file."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # .cu and .cuh
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"libdss_torch_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    nvcc = _nvcc()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
        for src, obj in zip(srcs, objs)
    ]
    failed = [str(src) for src, p in zip(srcs, procs) if p.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)], check=True)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry `name` of the library (built and loaded at first
    use), with its argument types set and an int return."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
