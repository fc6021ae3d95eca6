"""The collective bytes of the port's sharded step bundles, counted from
the shapes alone.

The port's one source of the collective term is the work counter
(``roofline.counter.WorkCounter``): every collective of
``sharding/comm.py`` reports its bytes there, on the card and in the
``fake``-group meta dry run alike. This module is the tests' second,
independent count of what ``comm`` should issue per layer and pass, which
the meta run and the gloo ranks are held to.
"""
from typing import Dict, Tuple

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import axes_key
from repro_torch.launch.steps import exec_knobs, param_structs
from repro_torch.roofline.counter import collective_bytes
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_leaves_with_path


def mesh_collective_bytes(cfg: ModelConfig, shape: InputShape, mesh, *,
                          use_wgkv: bool = True,
                          backend: str = "nccl") -> Dict[str, int]:
    """Bytes one rank at coords 0 moves per collective axis (the keys of
    ``launch.mesh.axes_key``) in the step of ``launch.steps.make_bundle``
    on ``mesh`` (a shape mapping), in ring accounting, derived from the
    shapes alone: what ``sharding/comm.py`` calls per layer and pass.
    ``backend``: "nccl" assembles blocks with all-gathers, "gloo" with
    all-reduces of the whole buffer. The mesh archs only (dense GQA
    attention; WG-KV for the train step).

    * every pass of the model over a layer: under "gather_q" the q heads
      gathered over "model"; the attention's and the FFN's row-parallel
      partials summed over "model" when the plan splits them; under FSDP
      the layer's blocked leaves gathered over their axes;
    * a train step makes three passes (the teacher, the student and, with
      remat, its recompute, which stops before the FFN's sum: torch's
      checkpoint recomputes only up to the last tensor the backward
      needs), and its backward sums over "model" the
      gradients of the column-parallel inputs (x of ``w_q``, and under
      "gather_q" the whole k, v and gates the read consumes; not where
      nothing before them needs a gradient: layer 0's x, k and v), then
      the loss terms and the gate gradients over the batch rows' axes;
    * the embedding is gathered once per pass that embeds (and the tied
      unembedding again), the prefill's mean admission summed once, and a
      seq-sharded decode combines each layer's read over "data" (its
      log-sum-exp max and the weighted sum)."""
    mesh = R.mesh_shape(mesh)
    out: Dict[str, int] = {}

    def add(axes, kind, nbytes, times=1):
        key = axes_key(mesh, axes)
        n = R._axsize(mesh, tuple(key.split("+")) if key != "world"
                      else tuple(mesh))
        if n > 1 and times:
            out[key] = out.get(key, 0) + times * collective_bytes(
                kind, int(nbytes), n)

    def gather(axes, nbytes, times=1):
        if backend == "gloo":
            add(axes, "all_reduce", nbytes, times)
        else:
            add(axes, "all_gather", nbytes, times)

    act = torch_dtype(cfg.dtype).itemsize
    par = torch_dtype(cfg.param_dtype).itemsize
    plan = R.tp_plan(cfg, mesh)
    lcfg = R.local_config(cfg, plan)
    n_layers = cfg.n_repeats * len(cfg.block_pattern)
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    rows = R.tokens_spec(mesh, b, 0)[0]
    row_axes = R._axes_of(rows)
    b_loc = b // R._axsize(mesh, row_axes or None)
    knobs = exec_knobs(cfg, shape, mesh)
    decode = shape.kind == "decode"
    tokens = b_loc * (1 if decode else s)
    replicate = decode and R.replicate_params(cfg, mesh)
    # per pass over one layer
    per_layer: Dict[str, int] = {}

    def layer_pass(times, ffn_times=None):
        if plan.attn == "gather_q":
            gather("model", tokens * cfg.n_heads * cfg.head_dim * act,
                   times)
        if plan.attn != "whole":
            add("model", "all_reduce", tokens * d * act, times)
        if plan.ffn:
            add("model", "all_reduce", tokens * d * act,
                times if ffn_times is None else ffn_times)
        for axes, nbytes in per_layer.items():
            gather(tuple(axes.split("+")), nbytes, times)

    params = param_structs(cfg, "meta")
    fsdp = {} if replicate else R.fsdp_placement(params, cfg, mesh)
    leaves = {"/".join(str(k) for k in p): x
              for p, x in tree_leaves_with_path(params)}
    embed_gathers: Dict[str, Tuple[str, int]] = {}
    for path, spec in fsdp.items():
        leaf = leaves[path]
        model_only = tuple(e if e == "model" else None for e in spec)
        whole = R.shard_shape(tuple(leaf.shape), model_only, mesh)
        numel = 1
        for v in whole:
            numel *= v
        axes = [a for e in spec for a in R._axes_of(e) if a != "model"]
        key = axes_key(mesh, tuple(axes))
        if path.startswith("blocks/"):
            per = numel // leaf.shape[0] * par
            per_layer[key] = per_layer.get(key, 0) + per
        else:
            embed_gathers[path] = (key, numel * par)

    def embed_pass(unembed: bool):
        for path, (key, nbytes) in embed_gathers.items():
            name = path.split("/")[-1]
            if name == "tok" or (unembed and name == "unembed"):
                gather(tuple(key.split("+")), nbytes)
        if unembed and "embed/tok" in embed_gathers and \
                "embed/unembed" not in leaves:
            key, nbytes = embed_gathers["embed/tok"]
            gather(tuple(key.split("+")), nbytes)

    if shape.kind == "train":
        # the recompute stops at the last tensor the backward needs, the
        # FFN's hidden: its row-parallel sum does not run again
        passes = 3 if knobs["remat"] else 2
        layer_pass(passes * n_layers, 2 * n_layers)
        embed_pass(False)
        embed_pass(False)
        later = n_layers - 1
        if plan.attn != "whole":
            add("model", "all_reduce", tokens * d * act, later)
        if plan.attn == "gather_q":
            kv = b_loc * cfg.n_kv_heads * s * cfg.head_dim * act
            add("model", "all_reduce", kv, 2 * later)
            add("model", "all_reduce", b_loc * cfg.n_kv_heads * s * 4,
                n_layers)
        if plan.ffn:
            add("model", "all_reduce", tokens * d * act, n_layers)
        heads = row_axes + (("model",) if plan.attn == "split" else ())
        add(row_axes, "all_reduce", 2 * 4)
        add(heads, "all_reduce", 5 * 4)
        for path, leaf in leaves.items():
            if "gate" in path.split("/"):
                spec = R.param_placement(tuple(path.split("/")),
                                         tuple(leaf.shape), mesh, cfg)
                loc = R.shard_shape(tuple(leaf.shape), spec, mesh)
                numel = 1
                for v in loc:
                    numel *= v
                add(row_axes, "all_reduce", numel * par)
        return out
    layer_pass(n_layers)
    embed_pass(True)
    if shape.kind == "prefill":
        heads = row_axes + (("model",) if plan.attn == "split" else ())
        add(heads, "all_reduce", 4)
        return out
    if R.seq_shard(mesh, b):
        c = cfg.wgkv.global_budget(s)
        seq = R.pick(c, mesh, "data")
        hq = lcfg.n_heads
        add(seq, "all_reduce", b * hq * 4, n_layers)
        add(seq, "all_reduce", b * hq * (cfg.head_dim + 1) * 4, n_layers)
    return out
