"""Device and dtype resolution shared by the port's entry points.

Every entry point (the Engine, ``make_backend``, ``init_model``, the
weight converter, ``launch/serve.py``) runs on ``cuda`` unless its caller
asks for the CPU. Without a GPU, a default (or explicit ``cuda``) request
raises instead of quietly running somewhere else.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA request on a machine without a GPU
    raises :class:`RuntimeError`; pass ``device="cpu"`` to run the plain
    PyTorch path on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' (or --device cpu) to "
            "run the plain PyTorch path on the host")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", ...) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on ``device``. On CUDA the copy
    goes through pinned memory without blocking, so it queues behind the
    work already in flight instead of waiting for it (a pageable copy
    synchronizes the stream, which would defeat dispatch-ahead)."""
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
