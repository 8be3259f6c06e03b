"""Build the port's CUDA kernels from ``csrc/`` at first use.

``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of the
source text, the headers of ``csrc/`` it may include and the flags: an
unchanged source loads the library already built, an edited one builds
anew.  A library is written under a temporary name and renamed into
place, so processes building at the same time never load a partial file.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
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
from typing import Dict, NamedTuple, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "DTYPE_CODE",
           "SMEM_PER_BLOCK_OPTIN", "Built", "build", "build_all", "load",
           "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every kernel source of the port, one library each
SOURCES = ("paged_attention", "flash_attention", "decode_attention",
           "rmsnorm", "gla")
# the dtype argument of every kernel's C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the shared memory one block may opt in to on sm_90 (227 KB)
SMEM_PER_BLOCK_OPTIN = 232_448

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


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise KeyError(f"no kernel source csrc/{name}.cu")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES, force: bool = False
              ) -> Dict[str, Built]:
    """Compile ``csrc/<name>.cu`` for each name whose library is not built
    yet (``force`` compiles them all), one ``nvcc`` per source, all started
    together.  Raises with the compiler's output when a source does not
    compile; the others still finish first."""
    libs = {name: _library(name) for name in names}
    out: Dict[str, Built] = {}
    todo = {}
    for name, lib in libs.items():
        if lib.exists() and not force:
            out[name] = Built(lib, "", 0.0)
        else:
            todo[name] = lib
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(tmp.with_suffix(".log"), "w+")  # a pipe could fill up
        procs[name] = (tmp, log, time.perf_counter(), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT, text=True))
    ended: Dict[str, float] = {}
    while len(ended) < len(procs):  # each build's own wall time
        for name, (_, _, t0, proc) in procs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter() - t0
        time.sleep(0.02)
    failed = []
    for name, (tmp, log, _, proc) in procs.items():
        log.seek(0)
        text = log.read()
        log.close()
        os.unlink(log.name)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, todo[name])
        out[name] = Built(todo[name], text, ended[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def build(name: str, force: bool = False) -> Built:
    """Compile ``csrc/<name>.cu`` unless its library is already built
    (``force`` compiles it all the same).  Raises with the compiler's
    output when the source does not compile."""
    return build_all([name], force=force)[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, built first if
    needed, with the C functions every library has (``csrc/common.cuh``)
    bound."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name).path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_max_smem_per_block.argtypes = [ctypes.c_int]
            lib.repro_max_smem_per_block.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]
