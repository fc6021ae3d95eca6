"""The port's one-card dry run (``repro_torch.launch.{specs,steps,dryrun}``)
against the reference's structs, and its counts across devices.

- Argument bytes at full width, with no allocation (the ``meta`` device):
  the parameter tree of every arch and the decode caches of every arch
  with a cache, WG-KV on and off, against the reference's
  ``param_structs`` and ``cache_tree_bytes(decode_cache_structs(...))``.
- The input structs' shapes and dtypes against the reference's.
- Device invariance: FLOPs by rate class, bytes, each kernel's launches
  and work, and the peak equal as integers between the CPU (the plain
  versions) and ``meta`` on reduced configs. The train step is left out
  here: on the CPU autograd differentiates the plain versions, where the
  card runs the backward kernels; ``chip_smoke.py`` holds its meta count
  to the card's.
- A full-width meta dry run of qwen3-0.6b's prefill, decode step and
  train step launches each kernel as the card's phases do.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.launch import specs as RS
from repro.launch import steps as RST
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config, get_shape
from repro_torch.configs.base import InputShape
from repro_torch.device import torch_dtype
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch import steps as ST
from repro_torch.models import attention as TA
from repro_torch.models import inference as I
from repro_torch.roofline import analysis as A
from repro_torch.roofline.counter import WorkCounter

torch.set_num_threads(2)


def _struct_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


# ==========================================================================
# argument bytes and input structs against the reference
# ==========================================================================
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_bytes_equal_the_reference(arch):
    ours = D.tree_bytes(ST.param_structs(get_config(arch)))
    assert ours == _struct_bytes(RST.param_structs(ref_get_config(arch)))


def _dense_rounding(cfg, shape, use_wgkv) -> int:
    """Bytes the port's dense buffers add by rounding each capacity up to
    a 16-token page (ROADMAP's deliberate differences)."""
    if use_wgkv:
        return 0
    dense = sum(b in ("attn", "attn_moe", "attn_cross")
                for b in cfg.block_pattern) * cfg.n_repeats + sum(
        b in ("attn", "attn_moe", "attn_cross") for b in cfg.stem_pattern)
    extra = TA.dense_len(shape.seq_len) - shape.seq_len
    isz = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return dense * 2 * shape.global_batch * cfg.n_kv_heads * extra \
        * cfg.head_dim * isz


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("use_wgkv", [True, False])
def test_cache_bytes_equal_the_reference(arch, use_wgkv):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name in ("decode_32k", "long_500k"):
        ours = S.cache_tree_bytes(S.decode_cache_structs(
            cfg, get_shape(name), use_wgkv=use_wgkv))
        ref = RS.cache_tree_bytes(RS.decode_cache_structs(
            ref_cfg, ref_get_shape(name), use_wgkv=use_wgkv))
        assert ours == ref + _dense_rounding(cfg, get_shape(name), use_wgkv)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_structs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for kind, ours_fn, ref_fn in (("train", S.train_inputs, RS.train_inputs),
                                  ("prefill", S.prefill_inputs,
                                   RS.prefill_inputs),
                                  ("decode", S.decode_inputs,
                                   RS.decode_inputs)):
        name = {"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}[kind]
        ours = ours_fn(cfg, get_shape(name))
        ref = ref_fn(ref_cfg, ref_get_shape(name))
        assert sorted(ours) == sorted(ref)
        for k, v in ours.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (kind, k)
            assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), (kind, k)


# ==========================================================================
# device invariance on reduced configs
# ==========================================================================
def _count(cfg, shape, device, *, use_wgkv, opts=None):
    """The step of ``shape`` on ``device`` under the counter (with
    ``opts``, a decode step with those decode options)."""
    bundle = ST.make_bundle(cfg, shape, use_wgkv=use_wgkv, device=device)
    with torch.no_grad(), WorkCounter() as wc:
        if opts is None:
            bundle.fn(*bundle.args)
        else:
            params, caches, inputs = bundle.args
            I.decode_step(params, cfg, inputs["token"], caches, opts=opts)
    return wc.record()


CASES = [
    ("qwen3-0.6b", InputShape("p", 256, 1, "prefill"), True, None),
    ("qwen3-0.6b", InputShape("p", 256, 1, "prefill"), False, None),
    ("qwen3-0.6b", InputShape("d", 512, 2, "decode"), True, None),
    ("qwen3-0.6b", InputShape("d", 512, 2, "decode"), False, None),
    ("qwen3-0.6b", InputShape("d", 512, 2, "decode"), True, "quest:2"),
    ("recurrentgemma-9b", InputShape("p", 128, 1, "prefill"), True, None),
    ("granite-moe-3b-a800m", InputShape("d", 256, 2, "decode"), True, None),
    ("whisper-medium", InputShape("p", 128, 1, "prefill"), True, None),
]


@pytest.mark.parametrize("arch,shape,use_wgkv,selection", CASES)
def test_counts_equal_on_cpu_and_meta(arch, shape, use_wgkv, selection):
    cfg = get_reduced_config(arch).replace(dtype="float32")
    opts = (I.DecodeOptions(selection_policy=selection) if selection
            else None)
    cpu = _count(cfg, shape, "cpu", use_wgkv=use_wgkv, opts=opts)
    meta = _count(cfg, shape, "meta", use_wgkv=use_wgkv, opts=opts)
    assert cpu["kernels"], "the step launched no kernel"
    if selection:
        assert "paged_decode_selected" in meta["kernels"]
    for key in ("flops", "bytes", "kernels", "peak_made_bytes"):
        assert cpu[key] == meta[key], key
    assert cpu["aten"] == meta["aten"]


def test_decode_after_prefill_counts_equal_on_cpu_and_meta():
    """A decode step on the caches a prefill step returned (``caches=``,
    as chip_smoke's roofline phase times one): the counts on the CPU and
    on meta equal as integers, and equal the count on the empty structs
    of the same shape, since the count reads shapes only."""
    cfg = get_reduced_config("qwen3-0.6b").replace(dtype="float32")
    pre = InputShape("p", 256, 1, "prefill")
    dec = InputShape("d", 256, 1, "decode")
    recs = {}
    for device in ("cpu", "meta"):
        bundle = ST.make_bundle(cfg, pre, use_wgkv=True, device=device)
        caches = bundle.fn(*bundle.args)[2]
        if device == "cpu":
            assert int(caches["t"][0]) == 256
        recs[device] = D.run_dryrun("qwen3-0.6b", dec, cfg_override=cfg,
                                    device=device, params=bundle.args[0],
                                    caches=caches)
    cpu, meta = recs["cpu"], recs["meta"]
    for key in ("flops", "bytes", "kernels"):
        assert cpu["cost"][key] == meta["cost"][key], key
    assert cpu["memory"]["caches_bytes"] == meta["memory"]["caches_bytes"]
    empty = D.run_dryrun("qwen3-0.6b", dec, cfg_override=cfg)
    assert meta["cost"] == empty["cost"]
    assert meta["memory"] == empty["memory"]
    assert set(meta["cost"]["kernels"]) == {"gate_mlp", "paged_decode"}


# ==========================================================================
# full width on meta: the launches of the card's phases
# ==========================================================================
def test_full_width_qwen3_launches_on_meta():
    """Prefill-long's prefill (1 x 4,096), one of its decode steps and the
    train phase's step (2 x 2,048; ``launch.train`` runs without remat or
    query chunks) launch what the card's phases launch; with the
    reference's train knobs (remat) the forward kernels run again in the
    backward."""
    want = {"prefill": {"gate_mlp": 28, "vertical_slash": 28},
            "decode": {"gate_mlp": 28, "paged_decode": 28},
            "train": {"gate_mlp": 28, "gate_mlp_bwd": 28, "gated_flash": 28,
                      "gated_flash_bwd": 28}}
    shapes = {"prefill": InputShape("prefill_4k", 4096, 1, "prefill"),
              "decode": InputShape("decode_4k", 4096, 1, "decode"),
              "train": InputShape("train_2k", 2048, 2, "train")}
    for kind, shape in shapes.items():
        rec = D.run_dryrun("qwen3-0.6b", shape, knob_overrides={
            "remat": False, "q_chunk": None})
        got = {k: v["launches"] for k, v in rec["cost"]["kernels"].items()}
        assert got == want[kind], kind
        assert rec["memory"]["fits_one_h100"]
        json.dumps(rec)   # a record is plain JSON
    rec = D.run_dryrun("qwen3-0.6b", shapes["train"])
    assert rec["knobs"]["remat"] and rec["knobs"]["q_chunk"] == 512
    got = {k: v["launches"] for k, v in rec["cost"]["kernels"].items()}
    assert got == {"gate_mlp": 56, "gate_mlp_bwd": 28, "gated_flash": 56,
                   "gated_flash_bwd": 28}


def test_dryrun_cli_writes_a_record(tmp_path):
    out = tmp_path / "dryrun.json"
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                   "--out", str(out)]) == 0
    assert D.main(["--arch", "whisper-medium", "--shape", "long_500k",
                   "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"]) for r in recs] == [
        ("qwen3-0.6b", "decode_32k"), ("whisper-medium", "long_500k")]
    assert recs[0]["memory"]["caches_bytes"] > 0 and recs[1]["skipped"]


def test_slstm_loop_added_from_the_reference_formula():
    """On meta xlstm's sLSTM loop does not run and the dry run adds its
    recurrent products from ``slstm_hidden_flops``, as the reference
    does: on the CPU, where the loop runs op by op, the counted FLOPs are
    the same. The train step runs on meta too and adds the same term."""
    cfg = get_reduced_config("xlstm-350m").replace(dtype="float32")
    shape = InputShape("p", 24, 1, "prefill")
    hidden = int(A.slstm_hidden_flops(cfg, shape, 1))
    assert hidden > 0
    rec = D.run_dryrun("xlstm-350m", shape, cfg_override=cfg)
    assert rec["slstm_hidden_flops"] == hidden
    cpu = _count(cfg, shape, "cpu", use_wgkv=False)
    meta = _count(cfg, shape, "meta", use_wgkv=False)
    assert rec["cost"]["flops"] == cpu["flops"]
    assert cpu["flops"]["f32"] == meta["flops"]["f32"] + hidden
    assert cpu["bytes"] > meta["bytes"]   # the loop's bytes: not counted
    train = InputShape("t", 24, 1, "train")
    knobs = {"remat": False, "q_chunk": None}
    bundle = ST.make_bundle(cfg, train, use_wgkv=False, knob_overrides=knobs)
    with WorkCounter() as wc:
        bundle.fn(*bundle.args)
    rec = D.run_dryrun("xlstm-350m", train, cfg_override=cfg,
                       knob_overrides=knobs)
    assert rec["slstm_hidden_flops"] == hidden
    assert rec["cost"]["flops"]["f32"] == \
        wc.record()["flops"]["f32"] + hidden
