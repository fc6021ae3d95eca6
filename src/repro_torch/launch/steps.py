"""The steps as (fn, example args) per step kind, on one card or as one
rank of a ``data x model`` mesh (port of ``repro/launch/steps.py``).

Used by :mod:`repro_torch.launch.dryrun`, which runs a bundle once on the
``meta`` device (or on the card) under the work counter.

**One card** (``mesh=None``): the mesh-derived knobs resolve as on a
1 x 1 mesh (``moe_groups`` 1), and the bundle has no shardings.

**A mesh** (``mesh=``: a :class:`repro_torch.launch.mesh.Mesh` this
process is a rank of, or just its shape, ``{"data": d, "model": m}``
with an optional "pod", for the specs alone; ``coords``: the rank's
place, default the Mesh's own or all 0): the reference's sharded half,
through the same three builders (:class:`_Place` holds what differs).
``in_shardings`` holds the reference's spec of every argument leaf
(``PartitionSpec`` entries as tuples): the train state replicated, the
params FSDP for training and prefill (``rules.param_shardings``) and, for
decode, replicated over "data" when the model-sharded weights fit
(``rules.replicate_params``, the reference's ``param_count() * 2 /
model_ways <= 4 GiB``), the caches by ``rules.cache_shardings``
(``rules.seq_shard`` when the batch is narrower than the batch axes:
long_500k's context-parallel decode), the inputs by ``rules.tokens_spec``. ``args`` are the rank's
local blocks of them (``rules.local_params``, whose placement differs
from the spec only where ``rules`` says: the gate sliced by kv heads,
some "model" splits held whole), and ``fn`` runs the rank's step under
``sharding.comm.active``: multi-controller SPMD, every collective
explicit. On a mesh ``caches`` are the rank's blocks already (a sharded
prefill's, or ``rules.local_caches`` of a whole tree); a seq-sharded
decode reads the dual caches' global keys or the dense buffers (the
baseline, ``use_wgkv=False``) by block. Inputs are split as the
reference's ``_input_shardings`` splits them: by batch rows, M-RoPE
``positions`` [3, B, S] on dim 1. The mesh takes the archs
``rules.check_mesh_arch`` admits (GQA attention with M-RoPE or cross
attention, MoE, RG-LRU, encoder and xLSTM blocks: every registered
arch); each rank builds the whole weights and keeps its blocks (building
them already sharded is ROADMAP Queue 1 item 8b.6). A WG-KV-inapplicable
arch trains every parameter (``trainer.lm_train_step``): the state's
AdamW moments are shaped like the rank's blocks. ``knobs["moe_groups"]`` is
the reference's count over the whole batch; ``models/moe.py`` turns it
into the rank's own groups (the rows' share) or, when it is not a
multiple of the rows' ways, routes a group gathered over "data". The
reference's ``_with_act_sharding`` is a layout hint to XLA with no eager
counterpart.

``scan_unroll`` is an XLA compile hint with no eager counterpart (ROADMAP
item 6c). The reference's prefill knobs ``block_chunk`` and ``q_chunk``
bound its dense einsum's scores; the port's prefill runs kernels that
tile themselves and takes neither.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_BLOCKS, InputShape, ModelConfig
from repro_torch.launch import specs as S
from repro_torch.models import inference as I
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.sharding import comm, rules
from repro_torch.training import trainer as TR
from repro_torch.training.optimizer import cosine_schedule
from repro_torch.tree import tree_map


class StepBundle(NamedTuple):
    fn: Callable            # fn(*args) runs the step
    args: Tuple             # params, caches or train state, and inputs
    knobs: Dict[str, Any]
    # on a mesh: the reference's spec of every argument leaf (tuples of
    # PartitionSpec entries), in the structure of ``args``
    in_shardings: Optional[Tuple] = None


# ==========================================================================
# execution knobs per (arch, shape)
# ==========================================================================
def exec_knobs(cfg: ModelConfig, shape: InputShape,
               mesh=None) -> Dict[str, Any]:
    """The reference's knobs: remat for a train step, and there
    ``q_chunk`` 512 (the teacher's dense attention in query chunks) from
    2,048 tokens; the routing groups of a MoE arch from the mesh's batch
    axes (1 on one card)."""
    s = shape.seq_len
    k: Dict[str, Any] = {"q_chunk": None, "moe_groups": 1, "remat": False}
    seq_for_attn = cfg.dec_max_len if cfg.arch_type == "audio" else s
    if shape.kind == "train":
        k["remat"] = True
        if seq_for_attn >= 2048:
            k["q_chunk"] = 512
    if cfg.moe is not None and mesh is not None:
        tokens = shape.global_batch * (seq_for_attn
                                       if shape.kind != "decode" else 1)
        for cand in (rules._axsize(mesh, rules.batch_axes(mesh)),
                     rules.mesh_shape(mesh).get("data", 1), 1):
            if tokens % cand == 0 and shape.global_batch % cand == 0:
                k["moe_groups"] = cand
                break
    return k


def param_structs(cfg: ModelConfig, device="meta"):
    """``init_model`` on ``device``: shapes only on ``meta``; on a real
    device the weights drawn from seed 0."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    return T.init_model(cfg, gen.manual_seed(0), dev)


# ==========================================================================
# where a bundle runs: one card, or one rank of a mesh
# ==========================================================================
def _replicated_tree(tree):
    return tree_map(lambda _: (), tree)


def _input_shardings(inputs: Dict[str, Any], mesh,  # torchlint: sharded-path
                     batch: int) -> Dict[str, Any]:
    out = {}
    for k, v in inputs.items():
        if k == "positions":          # [3, B, S]
            out[k] = rules._spec((None, rules.pick(
                batch, mesh, rules.batch_axes(mesh)), None))
        else:
            out[k] = rules.tokens_spec(mesh, batch, v.ndim - 1)
    return out


def _run_on(mesh, plan, fn, **ctx) -> Callable:
    """``fn`` run under ``comm.active`` (a spec-only mesh, a shape with
    no process groups, cannot run a step)."""
    def run(*args):
        if isinstance(mesh, dict):
            raise RuntimeError("a bundle built on a mesh shape has specs "
                               "and local blocks but no process groups to "
                               "run on: pass a launch.mesh.Mesh")
        with comm.active(mesh, plan, **ctx):
            return fn(*args)
    return run


class _Place(NamedTuple):
    """A bundle's place. On one card (``mesh`` None) the whole config and
    weights, and the step as it is. On a mesh the rank's config
    (``rules.local_config``), its weight blocks and their specs, and what
    its step runs under (``comm.active``'s FSDP placement and rows)."""
    cfg: ModelConfig
    params: Any
    mesh: Any = None
    coords: Optional[Dict[str, int]] = None
    plan: Any = None
    param_specs: Any = None
    ctx: Optional[Dict[str, Any]] = None

    def inputs(self, inputs: Dict[str, Any],  # torchlint: sharded-path
               batch: int) -> Tuple[Dict[str, Any], Any]:
        """(the rank's blocks of ``inputs``, their specs); on one card
        (``inputs``, None)."""
        if self.mesh is None:
            return inputs, None
        specs = _input_shardings(inputs, self.mesh, batch)
        return {k: rules.local_shard(v, specs[k], self.coords, self.mesh)
                for k, v in inputs.items()}, specs

    def bundle(self, fn: Callable, args: Tuple, knobs, specs: Tuple,
               **ctx) -> StepBundle:
        """The bundle of ``fn``: on a mesh run under ``comm.active`` (with
        ``ctx`` beside the place's own) and with ``specs`` as its
        ``in_shardings``."""
        if self.mesh is None:
            return StepBundle(fn, args, knobs)
        return StepBundle(_run_on(self.mesh, self.plan, fn, **self.ctx,
                                  **ctx), args, knobs, specs)


def _place(cfg: ModelConfig, shape: InputShape,  # torchlint: sharded-path
           params, mesh, coords, *, replicate: bool = False) -> _Place:
    """Where the step of ``shape`` runs: one card for ``mesh`` None, else
    the rank at ``coords`` (default the Mesh's own, or all 0) with its
    weights held by ``rules.local_params`` (FSDP unless ``replicate``)."""
    if mesh is None:
        return _Place(cfg, params)
    rules.check_mesh_arch(cfg)
    coords = dict(coords if coords is not None else
                  getattr(mesh, "coords", {a: 0 for a in
                                           rules.mesh_shape(mesh)}))
    plan = rules.tp_plan(cfg, mesh, coords.get("model", 0))
    return _Place(
        rules.local_config(cfg, plan),
        rules.local_params(params, cfg, mesh, coords,
                           replicate_fsdp=replicate),
        mesh, coords, plan,
        rules.param_shardings(params, mesh, cfg, replicate_fsdp=replicate),
        {"fsdp": {} if replicate else rules.fsdp_placement(params, cfg,
                                                           mesh),
         "rows": rules.tokens_spec(mesh, shape.global_batch, 0)[0]})


# ==========================================================================
# train step
# ==========================================================================
def make_train_bundle(cfg: ModelConfig, shape: InputShape, knobs, *,
                      params, device, mesh=None, coords=None) -> StepBundle:
    on = _place(cfg, shape, params, mesh, coords)
    inputs, in_sh = on.inputs(S.train_inputs(cfg, shape, device),
                              shape.global_batch)
    lr = cosine_schedule(1e-3, 7500)

    def _vlm_fix(params, batch):
        # the VLM stream, from the rank's rows (the table assembled on an
        # FSDP mesh by ``build_vlm_embeds``)
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
        state = TR.init_train_state(on.params)

        def fn(state, params, batch):
            batch = _vlm_fix(params, batch)
            return TR.train_step(
                state, params, on.cfg, batch, lr=lr,
                moe_groups=knobs["moe_groups"], q_chunk=knobs["q_chunk"],
                remat=knobs["remat"])

        return on.bundle(fn, (state, on.params, inputs), knobs,
                         (_replicated_tree(state), on.param_specs, in_sh))

    # WG-KV-inapplicable arch (xlstm): standard full-parameter LM training
    # (on a mesh every rank updates its blocks)
    state = TR.init_lm_train_state(on.params)

    def fn(state, batch):
        batch = _vlm_fix(state.params, batch)
        return TR.lm_train_step(
            state, on.cfg, batch, lr=lr, moe_groups=knobs["moe_groups"],
            q_chunk=knobs["q_chunk"], remat=knobs["remat"])

    ps = on.param_specs
    return on.bundle(fn, (state, inputs), knobs,
                     (TR.LMTrainState(ps, TR.AdamWState((), ps, ps)), in_sh))


# ==========================================================================
# prefill step
# ==========================================================================
def make_prefill_bundle(cfg: ModelConfig, shape: InputShape, knobs, *,
                        use_wgkv: bool, params, device, mesh=None,
                        coords=None) -> StepBundle:
    on = _place(cfg, shape, params, mesh, coords)
    inputs, in_sh = on.inputs(S.prefill_inputs(cfg, shape, device),
                              shape.global_batch)

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
            params, on.cfg, batch.pop("tokens", None), use_wgkv=use_wgkv,
            budget=cfg.wgkv.global_budget(shape.seq_len),
            max_len=shape.seq_len + 64, moe_groups=knobs["moe_groups"],
            **batch, **kw)
        return out.logits, out.mean_admission, caches

    return on.bundle(fn, (on.params, inputs), knobs, (on.param_specs, in_sh))


# ==========================================================================
# decode (serve) step
# ==========================================================================
def make_decode_bundle(cfg: ModelConfig, shape: InputShape, knobs, *,
                       use_wgkv: bool, params, device, caches=None,
                       mesh=None, coords=None) -> StepBundle:
    replicate = seq_shard = False
    if mesh is not None:
        replicate = knobs.setdefault("replicate_params",
                                     rules.replicate_params(cfg, mesh))
        seq_shard = rules.seq_shard(mesh, shape.global_batch)
    on = _place(cfg, shape, params, mesh, coords, replicate=replicate)
    if caches is None:
        caches = S.decode_cache_structs(cfg, shape, use_wgkv=use_wgkv,
                                        device=device)
        if mesh is not None:
            caches = rules.local_caches(caches, cfg, mesh, on.coords,
                                        seq_shard=seq_shard)
    inputs, in_sh = on.inputs(S.decode_inputs(cfg, shape, device),
                              shape.global_batch)
    c_sh, seq = None, None
    if mesh is not None:
        c_sh = rules.cache_shardings(
            S.decode_cache_structs(cfg, shape, use_wgkv=use_wgkv), mesh,
            cfg, seq_shard=seq_shard)
    if seq_shard and cfg.has_attention_cache:
        # (a recurrent state has no token axis to split: every data rank
        # steps the row's whole state)
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: a decode batch narrower than the batch axes "
                "would split the cross memory's token axis too; the "
                "reference skips the one shape that has it (long_500k)")
        seq = _seq_entry(cfg, c_sh)

    @torch.no_grad()
    def fn(params, caches, batch):
        logits, new_caches, _ = I.decode_step(
            params, on.cfg, batch["token"], caches,
            moe_groups=knobs["moe_groups"])
        return logits, new_caches

    return on.bundle(fn, (on.params, caches, inputs), knobs,
                     (on.param_specs, c_sh, in_sh), seq=seq)


def _seq_entry(cfg: ModelConfig, c_sh):
    """The spec entry of a seq-sharded decode cache's token axis: the
    global keys' (a dual cache's ``gk``) or the dense buffer's (``k``)
    of the first attention block."""
    first = next(i for i, bt in enumerate(cfg.block_pattern)
                 if bt in ATTN_BLOCKS)
    spec = c_sh["blocks"][f"b{first}"]
    return (spec.gk if hasattr(spec, "gk") else spec.k)[3]


def make_bundle(cfg: ModelConfig, shape: InputShape, *, use_wgkv: bool,
                device="meta", params=None, caches=None,
                knob_overrides: Optional[Dict[str, Any]] = None,
                mesh=None, coords=None) -> StepBundle:
    """The step of ``shape.kind`` with its example args on ``device``
    (``params``: the whole weights already on it, else
    :func:`param_structs`; ``caches``: a decode step's caches on it, such
    as a prefill step's, else ``specs.decode_cache_structs``' empty ones);
    ``knob_overrides`` replace :func:`exec_knobs`' values. With ``mesh``
    (and ``coords``) the rank's step of the sharded bundle (the module's
    note)."""
    knobs = exec_knobs(cfg, shape, mesh)
    knobs.update(knob_overrides or {})
    if params is None:
        params = param_structs(cfg, device)
    where = {"params": params, "device": device, "mesh": mesh,
             "coords": coords}
    if shape.kind == "train":
        return make_train_bundle(cfg, shape, knobs, **where)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, knobs, use_wgkv=use_wgkv,
                                   **where)
    return make_decode_bundle(cfg, shape, knobs, use_wgkv=use_wgkv,
                              caches=caches, **where)
