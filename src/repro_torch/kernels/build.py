"""Build the port's CUDA kernels from ``csrc/`` at first use.

``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of the
source text and the flags: an unchanged source loads the library already
built, an edited one builds anew.  A library is written under a temporary
name and renamed into place, so processes building at the same time never
load a partial file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "Built", "build", "load",
           "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class Built(NamedTuple):
    path: Path
    log: str        # the compiler's output; empty when nothing was built
    seconds: float  # compile time; 0 when the library was already built


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's usual place; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on the PATH)")


def build(name: str, force: bool = False) -> Built:
    """Compile ``csrc/<name>.cu`` unless its library is already built
    (``force`` compiles it all the same).  Raises with the compiler's
    output when the source does not compile."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise KeyError(f"no kernel source csrc/{name}.cu")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if lib.exists() and not force:
        return Built(lib, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return Built(lib, proc.stdout, seconds)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built first if
    needed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name).path))
        return _LIBS[name]
