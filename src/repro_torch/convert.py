"""Carry weights between the reference package and the port.

:func:`params_from_numpy` takes the JAX parameter tree as numpy arrays —
either the nested tree (``jax.tree.map(np.asarray, params)``) or the flat
``/``-keyed npz that ``repro/training/checkpoint.py`` writes (a path or
the loaded mapping) — and returns the port's tree of tensors on
``device``. The layouts match path for path, so no leaf is transposed:
the encoder (``enc/blocks``, ``enc/ln_f``), the cross attention
(``xattn``, ``ln_x``), LayerNorm biases and the xLSTM cells (``cell``)
included.
:func:`flat_numpy` goes the other way: any tree of the port to the flat
``/``-keyed numpy mapping that file format holds.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

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


def flat_paths(tree: Any):
    """(``/``-joined path, leaf) of every leaf, NamedTuples keyed by index:
    the reference checkpoint's flattening."""
    for path, leaf in tree_leaves_with_path(tree, fields=False):
        yield "/".join(map(str, path)), leaf


def flat_numpy(tree: Any) -> Dict[str, np.ndarray]:
    """A tree of tensors -> ``{"a/b/0/c": array}`` (:func:`flat_paths`)."""
    return {key: leaf.detach().cpu().numpy()
            for key, leaf in flat_paths(tree)}


def _unflatten(flat: Mapping[str, Any]) -> dict:
    """``/``-keyed leaves -> nested dicts. The stem, a tuple in the
    reference's tree, is flattened as ``stem/0/...``, ``stem/1/...``; it
    comes back as a tuple in block order."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    if isinstance(tree.get("stem"), dict):
        tree["stem"] = tuple(tree["stem"][k]
                             for k in sorted(tree["stem"], key=int))
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
    if cfg.is_encdec:
        enc = params.get("enc", {})
        if "blocks" not in enc or "ln_f" not in enc:
            raise ValueError("an encoder-decoder's tree needs enc/blocks and "
                             "enc/ln_f")
        for path, leaf in tree_leaves_with_path(enc["blocks"]):
            if leaf.shape[0] != cfg.n_enc_repeats:
                raise ValueError(
                    f"enc/blocks/{'/'.join(map(str, path))} has leading "
                    f"axis {leaf.shape[0]}, config has {cfg.n_enc_repeats} "
                    "encoder repeats")
    stem = params.get("stem", ())
    if len(stem) != len(cfg.stem_pattern):
        raise ValueError(f"parameter tree has {len(stem)} stem blocks, "
                         f"config has stem {cfg.stem_pattern}")
    for i, (bt, block) in enumerate(zip(cfg.stem_pattern, stem)):
        mixer = "rec" if bt == "rglru" else "attn"
        if mixer not in block:
            raise ValueError(f"stem/{i} has no {mixer!r} subtree, config "
                             f"says a {bt!r} block")
        scale = block["ln1"]["scale"]
        if tuple(scale.shape) != (cfg.d_model,):
            raise ValueError(f"stem/{i}/ln1/scale is {tuple(scale.shape)}, "
                             f"config wants ({cfg.d_model},) (stem blocks "
                             "are not stacked)")
