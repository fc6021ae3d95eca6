"""The collective bytes of the port's sharded step bundles, counted from
the shapes alone.

The port's one source of the collective term is the work counter
(``roofline.counter.WorkCounter``): every collective of
``sharding/comm.py`` reports its bytes there, on the card and in the
``fake``-group meta dry run alike. This module is the tests' second,
independent count of what ``comm`` should issue per layer and pass, which
the meta run and the gloo ranks are held to.
"""
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ATTN_BLOCKS, InputShape, ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import axes_key
from repro_torch.launch.steps import exec_knobs, param_structs
from repro_torch.roofline.counter import collective_bytes
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_leaves_with_path


def mesh_collective_bytes(cfg: ModelConfig, shape: InputShape, mesh, *,
                          use_wgkv: bool = True, backend: str = "nccl",
                          moe_groups: Optional[int] = None
                          ) -> Dict[str, int]:
    """Bytes one rank at coords 0 moves per collective axis (the keys of
    ``launch.mesh.axes_key``) in the step of ``launch.steps.make_bundle``
    on ``mesh`` (a shape mapping), in ring accounting, derived from the
    shapes alone: what ``sharding/comm.py`` calls per layer and pass.
    ``backend``: "nccl" assembles blocks with all-gathers, "gloo" with
    all-reduces of the whole buffer. ``moe_groups``: the bundle's
    routing groups when a knob override sets them (default
    ``exec_knobs``'). Every mesh arch (GQA attention, MoE, RG-LRU,
    cross attention, encoder and xLSTM blocks); the train step is the
    gate distillation where WG-KV applies, else the full-parameter LM
    step.

    * every pass of the model over a layer: under "gather_q" the q heads
      gathered over "model"; the attention's, the dense FFN's, the MoE
      block's and the RG-LRU block's row-parallel partials summed over
      "model" when the plan splits them; an MoE block's rows gathered over
      the rows' axes when its routing group spans them, else its
      load-balance loss and drop fraction averaged over them (when they
      split the rows); under FSDP the layer's blocked leaves gathered over
      their axes;
    * a train step makes three passes over a repeated layer that has a
      gate or follows one (the teacher, the student and, with remat, its
      recompute, which stops at the
      last tensor the backward needs: short of the dense FFN's and the
      MoE combine's sums and of the MoE averages) and two over any other
      layer, and its backward sums over "model" the gradients of the
      column-parallel inputs where they need one (past the first
      attention layer: x of ``w_q``, under "gather_q" the whole k and v,
      the RG-LRU block's x, a dense FFN's x in an RG-LRU block; in every
      attention layer: the gates under "gather_q", the FFN's and the MoE
      block's x), then the loss terms and the gate gradients over the
      batch rows' axes;
    * an xLSTM block split by head gathers, per pass, the mLSTM's conv
      output and up-projection over "model" and sums its ``out_norm``
      sum of squares and ``w_down`` partials, and gathers the sLSTM's
      cell outputs and sums its MLP's partials; the full-parameter train
      step makes one forward pass and a remat recompute, and its
      backward sums each split block's input gradient over "model",
      reduce-scatters the mLSTM's gathered channels and sums its norm's
      gradient, sums the MLP input's, hands each FSDP gather's gradient
      back as a reduce-scatter over the rows' axes (an all-reduce on
      ``gloo``), then adds the loss over the rows' axes and every other
      leaf's gradient over the rows' axes its FSDP gather did not sum;
    * an encoder-decoder's encoder runs once per forward pass (twice in
      a train step, never in decode), its blocks' attention and FFN
      seams and FSDP gathers as a layer's; an ``attn_cross`` block adds
      its cross attention's seams to its self-attention's, and in the
      backward the sum of its x's gradient in every layer;
    * the embedding is gathered once per pass that embeds (once in a
      VLM's train step, whose stream is embedded before both passes;
      and the tied unembedding again), the prefill's mean admission summed once, and a
      seq-sharded decode combines each attention layer's read over
      "data" (its log-sum-exp max and the weighted sum)."""
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
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    dm = R.mlstm_width(cfg)
    rows = R.tokens_spec(mesh, b, 0)[0]
    row_axes = R._axes_of(rows)
    row_n = R._axsize(mesh, row_axes or None)
    b_loc = b // row_n
    knobs = exec_knobs(cfg, shape, mesh)
    if moe_groups is not None:
        knobs["moe_groups"] = moe_groups
    decode = shape.kind == "decode"
    # an encoder-decoder's decoder runs its ``dec_max_len`` prompt, its
    # encoder ``s // enc_seq_divisor`` frames
    enc_tokens = b_loc * s // cfg.enc_seq_divisor if cfg.is_encdec else 0
    if cfg.is_encdec:
        s = cfg.dec_max_len
    tokens = b_loc * (1 if decode else s)
    moe_local = knobs["moe_groups"] % row_n == 0
    replicate = decode and R.replicate_params(cfg, mesh)

    params = param_structs(cfg, "meta")
    fsdp = {} if replicate else R.fsdp_placement(params, cfg, mesh)
    leaves = {"/".join(str(k) for k in p): x
              for p, x in tree_leaves_with_path(params)}
    block_gathers: Dict[str, Dict[str, int]] = {}
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
        parts = path.split("/")
        if parts[0] == "enc":
            block = "/".join(parts[:3])           # enc/blocks/bI
            g = block_gathers.setdefault(block, {})
            g[key] = g.get(key, 0) + numel * par // leaf.shape[0]
        elif parts[0] in ("blocks", "stem"):
            block = "/".join(parts[:2])
            per = numel * par // (leaf.shape[0] if parts[0] == "blocks"
                                  else 1)
            g = block_gathers.setdefault(block, {})
            g[key] = g.get(key, 0) + per
        else:
            embed_gathers[path] = (key, numel * par)
    # (block type, its FSDP gathers, repeated (rematerialized), a gate
    # before it) of every layer in order
    layers = []
    seen_attn = False
    for j, bt in enumerate(cfg.stem_pattern):
        layers.append((bt, block_gathers.get(f"stem/{j}", {}), False,
                       seen_attn))
        seen_attn |= bt in ATTN_BLOCKS
    for _ in range(cfg.n_repeats):
        for i, bt in enumerate(cfg.block_pattern):
            layers.append((bt, block_gathers.get(f"blocks/b{i}", {}), True,
                           seen_attn))
            seen_attn |= bt in ATTN_BLOCKS
    n_attn = sum(1 for bt, *_ in layers if bt in ATTN_BLOCKS)
    enc_layers = [(bt, block_gathers.get(f"enc/blocks/b{i}", {}))
                  for _ in range(cfg.n_enc_repeats)
                  for i, bt in enumerate(cfg.enc_block_pattern)]

    def attention(n_tok):
        """One attention's seams over ``n_tok`` tokens: the gathered q
        heads and the summed ``w_o`` partials."""
        if plan.attn == "gather_q":
            gather("model", n_tok * cfg.n_heads * cfg.head_dim * act)
        if plan.attn != "whole":
            add("model", "all_reduce", n_tok * d * act)

    def encode():
        """The encoder's pass (no remat, no gradient): each block's
        attention and FFN over the frames, and its FSDP gathers."""
        for _, gathers in enc_layers:
            attention(enc_tokens)
            if plan.ffn:
                add("model", "all_reduce", enc_tokens * d * act)
            for axes, nbytes in gathers.items():
                gather(tuple(axes.split("+")), nbytes)

    def layer_pass(bt, gathers, recompute=False):
        """One forward pass over a layer (``recompute``: a remat
        recompute, which stops short of the last sums; an
        ``attn_cross`` block's cross attention feeds its FFN's norm, so
        its sum is recomputed)."""
        if bt in ATTN_BLOCKS:
            attention(tokens)
            if bt == "attn_cross":
                attention(tokens)
        if bt == "rglru" and plan.rec:
            add("model", "all_reduce", tokens * d * act)
        if bt == "mlstm" and plan.xlstm:
            # the conv output and up-projection gathered, out_norm's sum
            # of squares and (short of a recompute) w_down's partials
            gather("model", 2 * tokens * dm * act)
            add("model", "all_reduce", tokens * 4)
            if not recompute:
                add("model", "all_reduce", tokens * d * act)
        if bt == "slstm" and plan.xlstm:
            # the cell outputs (f32) gathered after the token loop, and
            # (short of a recompute) the MLP's partials
            gather("model", tokens * d * 4)
            if not recompute:
                add("model", "all_reduce", tokens * d * act)
        if bt == "attn_moe":
            if not moe_local:
                gather(row_axes, tokens * row_n * d * act)
            if not recompute:
                if plan.moe != "whole":
                    add("model", "all_reduce", tokens * d * act)
                if moe_local and row_n > 1:
                    add(row_axes, "all_reduce", 2 * 4)
        elif plan.ffn and not recompute:
            add("model", "all_reduce", tokens * d * act)
        for axes, nbytes in gathers.items():
            gather(tuple(axes.split("+")), nbytes)

    def embed_pass(unembed: bool):
        for path, (key, nbytes) in embed_gathers.items():
            name = path.split("/")[-1]
            if name == "tok" or (unembed and name == "unembed"):
                gather(tuple(key.split("+")), nbytes)
        if unembed and "embed/tok" in embed_gathers and \
                "embed/unembed" not in leaves:
            key, nbytes = embed_gathers["embed/tok"]
            gather(tuple(key.split("+")), nbytes)

    def scatter(axes, nbytes):
        """The backward of an FSDP gather of ``nbytes`` over ``axes``: a
        reduce-scatter when the rows split over all of them (nccl), else
        the gradient summed over the rows' share of them and sliced."""
        axes = tuple(axes.split("+"))
        summed = tuple(a for a in axes if a in row_axes)
        if backend != "gloo" and summed == axes:
            add(axes, "reduce_scatter", nbytes)
        elif summed:
            add(summed, "all_reduce", nbytes)

    if shape.kind == "train" and not cfg.wgkv_applicable():
        # full-parameter LM training (the xLSTM): the forward, each
        # repeated layer's remat recompute, then the backward's seams,
        # the FSDP gradients' reduce-scatters, the loss's sums and the
        # other leaves' gradients summed over the rows' axes
        for bt, gathers, repeated, _ in layers:
            layer_pass(bt, gathers)
            if repeated and knobs["remat"]:
                layer_pass(bt, gathers, recompute=True)
        embed_pass(True)
        for bt, gathers, _, _ in layers:
            if bt in ("mlstm", "slstm") and plan.xlstm:
                add("model", "all_reduce", tokens * d * act)
            if bt == "mlstm" and plan.xlstm:
                if backend == "gloo":
                    add("model", "all_reduce", 2 * tokens * dm * act)
                else:
                    add("model", "reduce_scatter", 2 * tokens * dm * act)
                add("model", "all_reduce", tokens * 4)
            if bt == "slstm" and plan.xlstm:
                add("model", "all_reduce", tokens * d * act)
            for axes, nbytes in gathers.items():
                scatter(axes, nbytes)
        for path, (key, nbytes) in embed_gathers.items():
            scatter(key, nbytes)
            if path == "embed/tok" and "embed/unembed" not in leaves:
                scatter(key, nbytes)
        add(row_axes, "all_reduce", 2 * 4)
        for path, leaf in leaves.items():
            done = {a for e in fsdp.get(path, ()) for a in R._axes_of(e)}
            left = tuple(a for a in row_axes if a not in done)
            if left:
                spec = R.param_placement(tuple(path.split("/")),
                                         tuple(leaf.shape), mesh, cfg,
                                         replicate_fsdp=False)
                loc = R.shard_shape(tuple(leaf.shape), spec, mesh)
                numel = 1
                for v in loc:
                    numel *= v
                add(left, "all_reduce", numel * par)
        return out
    if shape.kind == "train":
        encode()                                          # the teacher's
        encode()                                          # the student's
        for bt, gathers, repeated, grad_in in layers:
            layer_pass(bt, gathers)                       # the teacher
            layer_pass(bt, gathers)                       # the student
            # the backward recomputes a rematerialized layer it passes
            # through: one with a gate, or past one
            if repeated and knobs["remat"] and (grad_in
                                                or bt in ATTN_BLOCKS):
                layer_pass(bt, gathers, recompute=True)
        # a VLM stream is embedded once, before both passes
        embed_pass(False)
        if cfg.arch_type != "vlm":
            embed_pass(False)
        kv = b_loc * cfg.n_kv_heads * s * cfg.head_dim * act
        for bt, _, _, grad_in in layers:
            if bt in ATTN_BLOCKS:
                if plan.attn != "whole" and grad_in:
                    add("model", "all_reduce", tokens * d * act)
                # the cross attention's x carries the gated
                # self-attention's gradient in every layer
                if bt == "attn_cross" and plan.attn != "whole":
                    add("model", "all_reduce", tokens * d * act)
                if plan.attn == "gather_q":
                    if grad_in:
                        add("model", "all_reduce", kv, 2)
                    add("model", "all_reduce", b_loc * cfg.n_kv_heads * s
                        * 4)
            if bt == "rglru" and plan.rec and grad_in:
                add("model", "all_reduce", tokens * d * act)
            if bt == "attn_moe":
                if plan.moe != "whole":
                    # x and the routing weights of the rank's experts
                    routed = tokens * (1 if moe_local else row_n)
                    add("model", "all_reduce", routed * d * act)
                    add("model", "all_reduce", routed * cfg.moe.top_k * 4)
            elif plan.ffn and (bt in ATTN_BLOCKS or grad_in):
                add("model", "all_reduce", tokens * d * act)
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
    if shape.kind == "prefill":
        encode()
    for bt, gathers, _, _ in layers:
        layer_pass(bt, gathers)
    embed_pass(True)
    if shape.kind == "prefill":
        heads = row_axes + (("model",) if plan.attn == "split" else ())
        add(heads, "all_reduce", 4)
        return out
    if R.seq_shard(mesh, b):
        c = cfg.wgkv.global_budget(s)
        seq = R.pick(c, mesh, "data")
        hq = lcfg.n_heads
        add(seq, "all_reduce", b * hq * 4, n_attn)
        add(seq, "all_reduce", b * hq * (cfg.head_dim + 1) * 4, n_attn)
    return out
