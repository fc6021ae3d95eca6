"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at
the repository root (git-ignored), named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("gate_mlp", "paged_decode")

_LIBS: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Plain integer count of a wrapper's kernel launches: the wrapper adds
    one where it launches its kernel and nowhere else, so a run can show
    that the main path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: nvcc output} for the
    ones compiled now (``-Xptxas -v``: registers, shared memory, spills)."""
    procs = {n: _start(n) for n in names}
    return {n: _finish(n, p) for n, p in procs.items() if p is not None}


def _declare(lib: ctypes.CDLL, name: str) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "gate_mlp":
        lib.gate_mlp_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.gate_mlp_f32.restype = i
    elif name == "paged_decode":
        lib.paged_decode.argtypes = [p, p, p, p, p, i, p, p, p, p, i,
                                     p, i, i, i, i, p]
        lib.paged_decode.restype = i


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _declare(lib, name)
        _LIBS[name] = lib
    return lib


def timed_build_all() -> float:
    """Build every kernel and return the wall seconds it took."""
    t0 = time.perf_counter()
    build_all()
    for n in KERNELS:
        load(n)
    return time.perf_counter() - t0
