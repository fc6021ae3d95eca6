"""The port's roofline (``src/repro_torch/roofline``) against the
reference's formulas, the kernels' work functions against the records'
bounds and the plain versions' masks, and the work counter's rules.

Everything here runs on the CPU or the ``meta`` device; the counts on
the card are held to the meta counts by ``chip_smoke.py``'s roofline
phase.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.roofline import analysis as RA
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_reduced_config
from repro_torch.kernels import gate_mlp as GM
from repro_torch.kernels import gated_flash as GF
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import vertical_slash as VS
from repro_torch.roofline import analysis as A
from repro_torch.roofline import work as W
from repro_torch.roofline.counter import WorkCounter

torch.set_num_threads(2)


# ==========================================================================
# the formulas
# ==========================================================================
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_and_slstm_flops_equal_the_reference(arch):
    from repro.configs import get_shape as ref_get_shape
    for name, shape in SHAPES.items():
        ref_cfg, ref_shape = ref_get_config(arch), ref_get_shape(name)
        assert A.model_flops(get_config(arch), shape) == \
            RA.model_flops(ref_cfg, ref_shape)
        for devices in (1, 256):
            assert A.slstm_hidden_flops(get_config(arch), shape, devices) == \
                RA.slstm_hidden_flops(ref_cfg, ref_shape, devices)


def test_roofline_terms_pick_the_larger_term():
    t = A.roofline_terms({"f32": int(67e12), "3xtf32": 0, "bf16": 0},
                         int(3.35e12) // 2)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == 0 and t["bottleneck"] == "compute"
    t = A.roofline_terms({"bf16": int(989e12)}, int(3.35e12) * 2,
                         collective_bytes=int(450e9) * 3)
    assert t["bottleneck"] == "collective"


# ==========================================================================
# the work functions against the kernel table's bounds (PERF.md §6)
# ==========================================================================
def _bound_ms(w):
    b = A.bound_s({w.rate: w.flops}, w.bytes)
    return b["bound_s"] * 1e3, b["bound_by"]


@pytest.mark.parametrize("work,ms,by", [
    # gate_mlp x[16, 4096, 256], qwen3's 8 heads, M 64: the 3xTF32 path
    (W.gate_mlp(16, 4096, 256, 64, 8, GM.plan(16, 4096, 8)), "0.0203",
     "bytes"),
    # the causal gated_flash at S 4096 (16 / 8 heads of hd 128, f32)
    (W.gated_flash(16, 4096, 128, 2), "0.4166", "operations"),
    # the backward kernels at the train shape (2 x 2048, 32 / 16 heads)
    (W.gated_flash_bwd(32, 2048, 128, 2), "0.5209", "operations"),
    (W.gate_mlp_bwd(16, 2048, 256, 64, 8), "0.0204", "bytes"),
    # the scan and its backward at [1, 4096, 4096]
    (W.rglru_scan(1, 4096, 4096), "0.0601", "bytes"),
    (W.rglru_scan_bwd(1, 4096, 4096), "0.1002", "bytes"),
])
def test_work_reproduces_the_kernel_table_bounds(work, ms, by):
    got, got_by = _bound_ms(work)
    assert f"{got:.4f}" == ms and got_by == by


def test_gate_rate_follows_the_kernel_plan():
    assert W.gate_mlp(16, 1, 256, 64, 8, GM.plan(16, 1, 8)).rate == "f32"
    assert W.gate_mlp(8, 4096, 256, 64, 8, GM.plan(8, 4096, 8)).rate \
        == "3xtf32"


def test_vertical_slash_exact_pairs_match_the_plain_mask(monkeypatch):
    """The exact form counts the pairs the plain version leaves unmasked:
    numpy-drawn global positions, some unused slots (INT32_MAX)."""
    rng = np.random.default_rng(0)
    nk, group, s, c, w, hd = 2, 3, 96, 12, 16, 8
    gpos = rng.integers(0, s, (nk, c)).astype(np.int32)
    gpos[0, -3:] = np.iinfo(np.int32).max
    qi = np.arange(s)[:, None]
    local = ((qi >= qi.T) & (qi - qi.T < w)).sum()
    vis = (gpos[:, None, :].astype(np.int64) <= (qi[None] - w)).sum()
    exact = W.vertical_slash(nk * group, s, hd, group, c, w,
                             global_pairs=int(vis))
    assert exact.flops == 4 * hd * group * (nk * local + vis)
    # the plain version's logits: the same pairs are the unmasked ones
    t = torch.zeros((nk * group, s, hd))
    kv = torch.zeros((nk, s, hd))
    g = torch.zeros((nk, c, hd))
    captured = {}
    real_cat = torch.cat

    def cat(ts, dim=0):   # the plain version joins its two logit blocks
        captured["logits"] = real_cat(ts, dim=dim)
        return captured["logits"]
    monkeypatch.setattr(torch, "cat", cat)
    VS.vertical_slash_plain(t, kv, kv, g, g, torch.from_numpy(gpos),
                            w_local=w, group=group)
    monkeypatch.undo()
    unmasked = int((captured["logits"] > VS.NEG_INF / 2).sum())
    assert exact.flops == 4 * hd * unmasked
    # shapes only: every slot a global at 0, seen by every query past W
    assert W.vertical_slash(nk * group, s, hd, group, c, w).flops == \
        4 * hd * group * (nk * local + nk * c * (s - w))


def test_paged_decode_exact_tokens_match_the_plain_mask():
    """Valid tokens from numpy-drawn lengths: the exact form's FLOPs are
    4 hd per unmasked (query row, token) of the plain read."""
    assert W.PAGE == PD.PAGE
    rng = np.random.default_rng(1)
    nkv, group, hd, mp1, mp2 = 3, 2, 16, 4, 2
    lengths1 = rng.integers(0, mp1 * 16 + 1, nkv).astype(np.int32)
    lengths2 = rng.integers(0, mp2 * 16 + 1, nkv).astype(np.int32)
    n = nkv * group
    q = torch.zeros((n, hd))
    pool = torch.zeros((nkv * (mp1 + mp2), 16, hd))
    t1 = torch.arange(nkv * mp1, dtype=torch.int32).reshape(nkv, mp1)
    t2 = (nkv * mp1 + torch.arange(nkv * mp2, dtype=torch.int32)
          ).reshape(nkv, mp2)
    l1, l2 = torch.from_numpy(lengths1), torch.from_numpy(lengths2)
    tokens = int(lengths1.sum() + lengths2.sum())
    exact = W.paged_decode(n, hd, group, mp1, mp2, tokens=tokens)
    unmasked = 0
    for tbl, lens in ((t1, l1), (t2, l2)):
        logits, _ = PD._segment(q, pool, pool, tbl.repeat_interleave(
            group, 0), lens.repeat_interleave(group, 0))
        unmasked += int((logits > PD.NEG_INF / 2).sum())
    assert exact.flops == 4 * hd * unmasked
    assert exact.bytes == (2 * n * hd * 4 + 2 * tokens * hd * 4
                           + 4 * (nkv * (mp1 + 1) + nkv * (mp2 + 1)))
    full = W.paged_decode(n, hd, group, mp1, mp2)
    assert full.flops == 4 * hd * group * nkv * (mp1 + mp2) * 16
    # from a start offset: at most ``span`` tokens of segment 1 a stream
    assert W.paged_decode(n, hd, 1, mp1, span=20).flops == \
        4 * hd * n * 20
    sel = W.paged_decode_selected(n, hd, group, 2, mp2)
    assert sel.flops == 4 * hd * group * nkv * (2 + mp2) * 16


# ==========================================================================
# the counter
# ==========================================================================
def test_counter_rules_views_inplace_matmul_and_peak():
    a = torch.ones((8, 16), device="meta")
    b = torch.ones((16, 4), device="meta")
    with WorkCounter() as wc:
        v = a.t().reshape(128)          # a view, then a copy
        c = a @ b                       # mm: 2 * 8 * 16 * 4 FLOPs
        c.add_(1.0)                     # in place: reads nothing else
        del v
        d = torch.empty((1000,), device="meta")  # an allocation: 0 bytes
        d.zero_()
    rec = wc.record()
    assert rec["flops"] == {"f32": 2 * 8 * 16 * 4, "3xtf32": 0, "bf16": 0}
    assert "aten.t" not in rec["aten"]          # views count nothing
    assert "aten._unsafe_view" not in rec["aten"]   # nor unannotated ones
    assert rec["aten"]["aten.clone"]["bytes"] == 2 * 4 * 128
    assert rec["aten"]["aten.mm"]["bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert rec["aten"]["aten.add_"]["bytes"] == 4 * 8 * 4
    assert rec["aten"]["aten.zero_"]["bytes"] == 4 * 1000
    assert "aten.empty" not in rec["aten"]
    assert rec["bytes"] == sum(v["bytes"] for v in rec["aten"].values())
    # peak: the 512-byte copy is freed before the 4,000-byte allocation
    assert rec["peak_made_bytes"] == 4 * 8 * 4 + 4 * 1000


def test_counter_counts_a_wrapper_as_its_work_on_every_device():
    """On the CPU the plain version runs, on meta nothing does; either
    way the counter counts the kernel's work once and none of the plain
    version's ops."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 24, 16), dtype=np.float32))
    w1 = torch.from_numpy(rng.standard_normal((2, 16, 8), dtype=np.float32))
    b1, w2, b2 = torch.zeros((2, 8)), torch.zeros((2, 8, 1)), torch.zeros(
        (2, 1))
    recs = {}
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (x, w1, b1, w2, b2)]
        with WorkCounter() as wc:
            g = GM.gate_mlp(*args)
        assert g.shape == (4, 24) and g.dtype == torch.float32
        recs[dev] = wc.record()
    assert recs["cpu"] == recs["meta"]
    want = W.gate_mlp(4, 24, 16, 8, 2, GM.plan(4, 24, 2))
    assert recs["cpu"]["kernels"] == {"gate_mlp": {
        "launches": 1, "flops": want.flops, "bytes": want.bytes,
        "rate": want.rate}}
    assert recs["cpu"]["aten"] == {}


def test_meta_branches_run_no_plain_version(monkeypatch):
    """Every wrapper on meta returns its outputs' shapes and dtypes and
    runs no plain version (each plain version is made to raise)."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on meta")
    for mod, name in ((GM, "gate_mlp_plain"), (GF, "gated_flash_plain"),
                      (GF, "gated_flash_window_plain"),
                      (VS, "vertical_slash_plain"),
                      (PD, "paged_decode_plain"),
                      (PD, "paged_decode_selected_plain"),
                      (RS, "rglru_scan_plain")):
        monkeypatch.setattr(mod, name, boom)
    m = dict(device="meta")
    x, w1 = torch.empty((4, 5, 16), **m), torch.empty((2, 16, 8), **m)
    b1, w2, b2 = (torch.empty((2, 8), **m), torch.empty((2, 8, 1), **m),
                  torch.empty((2, 1), **m))
    assert GM.gate_mlp(x, w1, b1, w2, b2).shape == (4, 5)
    grads = GM.gate_mlp_bwd(x, w1, b1, w2, b2, torch.empty((4, 5), **m),
                            torch.empty((4, 5), **m))
    assert [t.shape for t in grads] == [t.shape for t in (x, w1, b1, w2, b2)]
    q = torch.empty((6, 32, 8), dtype=torch.bfloat16, **m)
    kv = torch.empty((3, 32, 8), dtype=torch.bfloat16, **m)
    g = torch.empty((3, 32), **m)
    out = GF.gated_flash(q, kv, kv, g, w_local=8, group=2)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert GF.gated_flash_window(q, kv, kv, window=8, group=2).shape == \
        q.shape
    kg = torch.empty((3, 4, 8), dtype=torch.bfloat16, **m)
    gpos = torch.empty((3, 4), dtype=torch.int32, **m)
    assert VS.vertical_slash(q, kv, kv, kg, kg, gpos, w_local=8,
                             group=2).shape == q.shape
    qd = torch.empty((6, 8), **m)
    pool = torch.empty((10, 16, 8), **m)
    tbl = torch.empty((3, 2), dtype=torch.int32, **m)
    lens = torch.empty((3,), dtype=torch.int32, **m)
    assert PD.paged_decode(qd, pool, pool, tbl, lens, group=2).shape == \
        qd.shape
    assert PD.paged_decode(qd, pool, pool, tbl, lens, group=2,
                           starts=lens, span=8).shape == qd.shape
    assert PD.paged_decode_selected(qd, pool, pool, tbl, lens, tbl, lens,
                                    (pool, pool, tbl, lens),
                                    group=2).shape == qd.shape
    a = torch.empty((1, 7, 4), **m)
    assert RS.rglru_scan(a, a).shape == a.shape
    assert [t.shape for t in RS.rglru_scan_bwd(a, a, a)] == [a.shape] * 2


def test_meta_grad_goes_through_the_autograd_functions():
    """On meta with grad, the forward and backward kernels report as on
    CUDA: one launch each of the forward and of its backward kernel."""
    m = dict(device="meta")
    q = torch.empty((4, 16, 8), **m).requires_grad_()
    kv = torch.empty((2, 16, 8), **m).requires_grad_()
    g = torch.empty((2, 16), **m).requires_grad_()
    a = torch.empty((1, 9, 4), **m).requires_grad_()
    with WorkCounter() as wc:
        out = GF.gated_flash(q, kv, kv, g, w_local=4, group=2)
        h = RS.rglru_scan(a, a)
        (out.sum() + h.sum()).backward()
    k = wc.record()["kernels"]
    assert {n: v["launches"] for n, v in k.items()} == {
        "gated_flash": 1, "gated_flash_bwd": 1, "rglru_scan": 1,
        "rglru_scan_bwd": 1}
    assert k["gated_flash"]["bytes"] == W.gated_flash(
        4, 16, 8, 2, with_lse=True).bytes


def test_rg_prefill_on_meta_runs_no_plain_scan(monkeypatch):
    from repro_torch.models import inference as I
    from repro_torch.models.transformer import init_model

    def boom(*a, **k):
        raise AssertionError("the plain scan ran on meta")
    monkeypatch.setattr(RS, "rglru_scan_plain", boom)
    cfg = get_reduced_config("recurrentgemma-9b")
    params = init_model(cfg, torch.Generator(), "meta")
    toks = torch.zeros((1, 128), dtype=torch.int32, device="meta")
    with torch.no_grad(), WorkCounter() as wc:
        out, _ = I.prefill(params, cfg, toks)
    assert out.logits.device.type == "meta"
    n_rg = (sum(b == "rglru" for b in cfg.stem_pattern)
            + cfg.n_repeats * sum(b == "rglru" for b in cfg.block_pattern))
    assert wc.record()["kernels"]["rglru_scan"]["launches"] == n_rg


def test_sweep_and_report(tmp_path, capsys):
    """``run_all`` records a pair with its terms and a pair
    ``shape_applicable`` skips; ``report`` prints both tables."""
    import json

    from repro_torch.roofline import report, run_all
    out = tmp_path / "roofline.json"
    for arch, shape in (("xlstm-350m", "decode_32k"),
                        ("whisper-medium", "long_500k")):
        assert run_all.main(["--arch", arch, "--shape", shape,
                             "--out", str(out)]) == 0
    ok, skipped = json.loads(out.read_text())
    assert ok["bottleneck"] in ("compute", "memory") and skipped["skipped"]
    assert ok["model_flops"] == A.model_flops(get_config("xlstm-350m"),
                                              SHAPES["decode_32k"])
    assert ok["useful_ratio"] == ok["model_flops"] / sum(
        ok["cost"]["flops"].values())
    capsys.readouterr()
    report.main(["--roofline", str(out), "--dryrun",
                 str(tmp_path / "none.json")])
    text = capsys.readouterr().out
    assert "## Dry run" in text and "## Roofline" in text
    assert "| xlstm-350m | decode_32k | False | ok |" in text
    assert "| whisper-medium | long_500k | - | SKIP" in text
