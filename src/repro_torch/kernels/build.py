"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at
the repository root (git-ignored), named by a hash of the source, the
local headers it includes and the flags, so an edited source or header
rebuilds the kernels that include it and an unchanged one is reused; each
library's nvcc output lies beside it under the same name (:func:`log_path`).
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("gate_mlp", "paged_decode", "vertical_slash", "gated_flash",
           "rglru_scan", "gate_mlp_bwd", "gated_flash_bwd",
           "rglru_scan_bwd")
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

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


def refuse_grad(kernel: str, tensors: Iterable, note: str = "") -> None:
    """Raises if autograd would want a gradient through a forward-only
    kernel: its output, a fresh tensor the kernel filled, would carry no
    graph, and the gradient would silently be missing. ``note`` names
    what is missing."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel is forward-only and an input "
            f"requires grad; run under torch.no_grad(){note}")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources(name: str) -> List[Path]:
    """``name``.cu and the headers of ``csrc`` it includes with
    ``#include "..."``, directly or through another header."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo += [CSRC / inc.decode()
                     for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return found


def _lib_path(name: str) -> Path:
    src = b"".join(path.read_bytes() for path in sources(name))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The nvcc output (``-Xptxas -v``: registers, shared memory, spills)
    of the build of ``name`` that matches its present sources and flags,
    kept beside the library under the same digest."""
    return _lib_path(name).with_suffix(".log")


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
    log_path(name).write_text(log)
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: nvcc output} for the
    ones compiled now (``-Xptxas -v``: registers, shared memory, spills)."""
    procs = {n: _start(n) for n in names}
    return {n: _finish(n, p) for n, p in procs.items() if p is not None}


def _declare(lib: ctypes.CDLL, name: str) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "gate_mlp":
        lib.gate_mlp_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.gate_mlp_f32.restype = i
    elif name == "gate_mlp_bwd":
        lib.gate_mlp_bwd_f32.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.gate_mlp_bwd_f32.restype = i
        lib.gate_mlp_bwd_chunks.argtypes = [i] * 5
        lib.gate_mlp_bwd_chunks.restype = i
        lib.gate_mlp_bwd_scratch_floats.argtypes = [i, i, i, i]
        lib.gate_mlp_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.gate_mlp_bwd_smem_bytes.argtypes = [i, i]
        lib.gate_mlp_bwd_smem_bytes.restype = ctypes.c_longlong
    elif name == "paged_decode":
        lib.paged_decode.argtypes = [p, p, p, p, p, i, p, i, i,
                                     p, p, p, p, i,
                                     p, p, p, i, i, i, i, i, i, i, p]
        lib.paged_decode.restype = i
        lib.paged_decode_selected.argtypes = [p, p, p, p, p, i, p, p, i,
                                              p, p, p, p, i,
                                              p, p, p, i, i, i, i, i, i, i,
                                              p]
        lib.paged_decode_selected.restype = i
    elif name == "vertical_slash":
        lib.vertical_slash.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                       i, i, p]
        lib.vertical_slash.restype = i
    elif name == "gated_flash":
        lib.gated_flash.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, p]
        lib.gated_flash.restype = i
        lib.gated_flash_window.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.gated_flash_window.restype = i
    elif name == "gated_flash_bwd":
        lib.gated_flash_bwd.argtypes = [p] * 13 + [i] * 5 + [f, p]
        lib.gated_flash_bwd.restype = i
        lib.gated_flash_bwd_smem_bytes.argtypes = [i, i]
        lib.gated_flash_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.gated_flash_bwd_splits.argtypes = [i, i]
        lib.gated_flash_bwd_splits.restype = i
        lib.gated_flash_bwd_scratch_floats.argtypes = [i, i, i, i]
        lib.gated_flash_bwd_scratch_floats.restype = ctypes.c_longlong
    elif name == "rglru_scan":
        lib.rglru_scan_f32.argtypes = [p, p, p, i, i, i, p, p]
        lib.rglru_scan_f32.restype = i
        lib.rglru_scan_scratch_words.argtypes = [i, i, i]
        lib.rglru_scan_scratch_words.restype = ctypes.c_longlong
    elif name == "rglru_scan_bwd":
        lib.rglru_scan_bwd_f32.argtypes = [p, p, p, p, p, i, i, i, p, p]
        lib.rglru_scan_bwd_f32.restype = i
        lib.rglru_scan_bwd_scratch_words.argtypes = [i, i, i]
        lib.rglru_scan_bwd_scratch_words.restype = ctypes.c_longlong


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
