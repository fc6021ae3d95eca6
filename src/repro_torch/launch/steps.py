"""The steps of one card as (fn, example args) per step kind (port of
``repro/launch/steps.py`` without its shardings).

Used by :mod:`repro_torch.launch.dryrun`, which runs a bundle once on the
``meta`` device (or on the card) under the work counter. On one card the
mesh-derived knobs resolve as on a 1 x 1 mesh: ``moe_groups`` is 1. The
reference's sharding half (``_with_act_sharding``, ``_named``,
``_replicated_tree``, ``_input_shardings`` and every ``rules.*`` call)
waits for the sharded bundles (ROADMAP Queue 1 item 8b; the serving
half of the mesh is ``serving/sharded.py``), and so does its decode
bundle's ``replicate_params``. ``scan_unroll`` is an XLA compile hint with
no eager counterpart (ROADMAP item 6c). The reference's prefill knobs
``block_chunk`` and ``q_chunk`` bound its dense einsum's scores; the
port's prefill runs kernels that tile themselves and takes neither.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import specs as S
from repro_torch.models import inference as I
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.training import trainer as TR
from repro_torch.training.optimizer import cosine_schedule


class StepBundle(NamedTuple):
    fn: Callable            # fn(*args) runs the step
    args: Tuple             # params, caches or train state, and inputs
    knobs: Dict[str, Any]


# ==========================================================================
# execution knobs per (arch, shape)
# ==========================================================================
def exec_knobs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """The reference's knobs on a 1 x 1 mesh: remat for a train step, and
    there ``q_chunk`` 512 (the teacher's dense attention in query chunks)
    from 2,048 tokens; one routing group."""
    s = shape.seq_len
    k: Dict[str, Any] = {"q_chunk": None, "moe_groups": 1, "remat": False}
    seq_for_attn = cfg.dec_max_len if cfg.arch_type == "audio" else s
    if shape.kind == "train":
        k["remat"] = True
        if seq_for_attn >= 2048:
            k["q_chunk"] = 512
    return k


def param_structs(cfg: ModelConfig, device="meta"):
    """``init_model`` on ``device``: shapes only on ``meta``; on a real
    device the weights drawn from seed 0."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    return T.init_model(cfg, gen.manual_seed(0), dev)


# ==========================================================================
# train step
# ==========================================================================
def make_train_bundle(cfg: ModelConfig, shape: InputShape, knobs, *,
                      params, device) -> StepBundle:
    inputs = S.train_inputs(cfg, shape, device)
    lr = cosine_schedule(1e-3, 7500)

    def _vlm_fix(params, batch):
        batch = dict(batch)
        if cfg.arch_type == "vlm":
            embeds, pos3 = R.build_vlm_embeds(
                params, cfg, batch.pop("tokens"), batch.pop("patch_embeds"),
                S.VLM_GRID)
            batch["embeds"] = embeds
            batch["positions"] = pos3
        return batch

    if cfg.wgkv.enabled and cfg.wgkv_applicable():
        # the paper's training: gate-only distillation, frozen backbone
        state = TR.init_train_state(params)

        def fn(state, params, batch):
            batch = _vlm_fix(params, batch)
            return TR.train_step(
                state, params, cfg, batch, lr=lr,
                moe_groups=knobs["moe_groups"], q_chunk=knobs["q_chunk"],
                remat=knobs["remat"])

        return StepBundle(fn, (state, params, inputs), knobs)

    # WG-KV-inapplicable arch (xlstm): standard full-parameter LM training
    state = TR.init_lm_train_state(params)

    def fn(state, batch):
        batch = _vlm_fix(state.params, batch)
        return TR.lm_train_step(
            state, cfg, batch, lr=lr, moe_groups=knobs["moe_groups"],
            q_chunk=knobs["q_chunk"], remat=knobs["remat"])

    return StepBundle(fn, (state, inputs), knobs)


# ==========================================================================
# prefill step
# ==========================================================================
def make_prefill_bundle(cfg: ModelConfig, shape: InputShape, knobs, *,
                        use_wgkv: bool, params, device) -> StepBundle:
    inputs = S.prefill_inputs(cfg, shape, device)

    @torch.no_grad()
    def fn(params, batch):
        batch = dict(batch)
        kw: Dict[str, Any] = {}
        if cfg.arch_type == "vlm":
            batch.pop("positions", None)  # rebuilt as 3D M-RoPE ids below
            embeds, pos3 = R.build_vlm_embeds(
                params, cfg, batch.pop("tokens"), batch.pop("patch_embeds"),
                S.VLM_GRID)
            kw["embeds"] = embeds
            kw["positions"] = pos3
        out, caches = I.prefill(
            params, cfg, batch.pop("tokens", None), use_wgkv=use_wgkv,
            budget=cfg.wgkv.global_budget(shape.seq_len),
            max_len=shape.seq_len + 64, moe_groups=knobs["moe_groups"],
            **batch, **kw)
        return out.logits, out.mean_admission, caches

    return StepBundle(fn, (params, inputs), knobs)


# ==========================================================================
# decode (serve) step
# ==========================================================================
def make_decode_bundle(cfg: ModelConfig, shape: InputShape, knobs, *,
                       use_wgkv: bool, params, device,
                       caches=None) -> StepBundle:
    if caches is None:
        caches = S.decode_cache_structs(cfg, shape, use_wgkv=use_wgkv,
                                        device=device)
    inputs = S.decode_inputs(cfg, shape, device)

    @torch.no_grad()
    def fn(params, caches, batch):
        logits, new_caches, _ = I.decode_step(
            params, cfg, batch["token"], caches,
            moe_groups=knobs["moe_groups"])
        return logits, new_caches

    return StepBundle(fn, (params, caches, inputs), knobs)


def make_bundle(cfg: ModelConfig, shape: InputShape, *, use_wgkv: bool,
                device="meta", params=None, caches=None,
                knob_overrides: Optional[Dict[str, Any]] = None
                ) -> StepBundle:
    """The step of ``shape.kind`` with its example args on ``device``
    (``params``: weights already on it, else :func:`param_structs`;
    ``caches``: a decode step's caches on it, such as a prefill step's,
    else ``specs.decode_cache_structs``' empty ones); ``knob_overrides``
    replace :func:`exec_knobs`' values."""
    knobs = exec_knobs(cfg, shape)
    knobs.update(knob_overrides or {})
    if params is None:
        params = param_structs(cfg, device)
    if shape.kind == "train":
        return make_train_bundle(cfg, shape, knobs, params=params,
                                 device=device)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, knobs, use_wgkv=use_wgkv,
                                   params=params, device=device)
    return make_decode_bundle(cfg, shape, knobs, use_wgkv=use_wgkv,
                              params=params, device=device, caches=caches)
