"""npz checkpoints of parameter, gate and optimizer trees (port of
``repro/training/checkpoint.py``).

The file format is the reference's: one flat npz whose keys are the
``/``-joined paths of the leaves (:func:`repro_torch.convert.flat_numpy`),
plus ``<path>.meta.json`` when there is metadata, so a gates file written
by either package restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.convert import flat_numpy, flat_paths
from repro_torch.device import DeviceLike
from repro_torch.tree import tree_map


def save(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat_numpy(tree))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)


def restore(path: str, like: Any, device: DeviceLike = None) -> Any:
    """The saved leaves in the structure of ``like`` (dicts, tuples,
    lists and NamedTuples of tensors), each in its leaf's dtype, on
    ``device`` (default: where that leaf of ``like`` lies)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        leaves = iter([torch.as_tensor(data[key]).to(
                           device=device if device is not None else t.device,
                           dtype=t.dtype)
                       for key, t in flat_paths(like)])
    return tree_map(lambda _: next(leaves), like)


def load_meta(path: str) -> Dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
