"""Carry the reference package's weights into the port.

:func:`params_from_numpy` takes the JAX parameter tree as numpy arrays —
either the nested tree (``jax.tree.map(np.asarray, params)``) or the flat
``/``-keyed npz that ``repro/training/checkpoint.py`` writes (a path or
the loaded mapping) — and returns the port's tree of tensors on
``device``. The layouts match path for path, so no leaf is transposed.
"""
from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves_with_path, tree_map


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def params_from_numpy(tree_or_flat_npz, cfg: ModelConfig,
                      device: DeviceLike = None) -> dict:
    """Reference parameters (nested numpy tree, flat ``/``-keyed mapping,
    or a path to the npz) -> the port's parameter tree on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    src = tree_or_flat_npz
    if isinstance(src, (str, os.PathLike)):
        path = os.fspath(src)
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            src = {k: z[k] for k in z.files}
    if isinstance(src, Mapping) and any("/" in k for k in src):
        src = _unflatten(src)
    params = tree_map(lambda a: _to_tensor(a, dev), src)
    _check(params, cfg)
    return params


def _check(params: dict, cfg: ModelConfig) -> None:
    for top in ("embed", "blocks", "ln_f"):
        if top not in params:
            raise ValueError(f"parameter tree has no {top!r} subtree")
    tok = params["embed"]["tok"]
    if tuple(tok.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed/tok is {tuple(tok.shape)}, config wants "
                         f"{(cfg.vocab_size, cfg.d_model)}")
    for path, leaf in tree_leaves_with_path(params["blocks"]):
        if leaf.shape[0] != cfg.n_repeats:
            raise ValueError(f"blocks/{'/'.join(map(str, path))} has leading "
                             f"axis {leaf.shape[0]}, config has "
                             f"{cfg.n_repeats} repeats")
