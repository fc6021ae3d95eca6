"""Parameter tree and init of the decoder (port of the ``"attn"``-block half
of ``repro/models/transformer.py``).

The tree mirrors the reference's, so weights carry across by path
(:mod:`repro_torch.convert`): ``{"embed": {"tok"}, "blocks": {"b0": ...},
"ln_f": {"scale"}}`` with every block leaf stacked on a leading
``n_repeats`` axis.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


def _norm(cfg: ModelConfig, p, x):
    """The reference's norm choice for the ported archs: RMSNorm."""
    return L.rmsnorm(p, x)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.stem_pattern or cfg.is_encdec or cfg.mrope
            or cfg.arch_type == "audio"
            or any(bt != "attn" for bt in cfg.block_pattern)):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch ports RMSNorm 'attn' blocks only "
            f"(pattern {cfg.block_pattern}, stem {cfg.stem_pattern})")


def init_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One ``"attn"`` block: GQA self-attention (with the write gate) and
    a SwiGLU FFN, each behind an RMSNorm."""
    dt = torch_dtype(cfg.param_dtype)
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": A.init_attention(gen, cfg, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dt, device),
        "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: DeviceLike = None) -> Params:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``cuda``). The generator must live on that device. The draws differ
    from the reference's ``jax.random`` init; to compare the two
    packages, carry the reference's weights over with
    :func:`repro_torch.convert.params_from_numpy`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    params: Params = {"embed": L.init_embedding(generator, cfg, dev)}
    layers = [{f"b{i}": init_block(generator, cfg, dev)
               for i, _ in enumerate(cfg.block_pattern)}
              for _ in range(cfg.n_repeats)]
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *layers)
    params["ln_f"] = L.init_rmsnorm(cfg.d_model, dt, dev)
    return params


def layer_params(params: Params, cfg: ModelConfig) -> List[Params]:
    """Per-layer views of the stacked block tree: ``[r]`` -> {"b0": ...}
    (one ``unbind`` per leaf, not one index op per leaf and layer)."""
    cols = [x.unbind(0) for x in tree_leaves(params["blocks"])]
    out = []
    for r in range(cfg.n_repeats):
        it = iter([c[r] for c in cols])
        out.append(tree_map(lambda _x, it=it: next(it), params["blocks"]))
    return out
