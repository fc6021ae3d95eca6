"""repro_torch.analysis: the port's lint passes, baseline and CLI (the
run-time sentinels are held in tests/test_torch_legacy_loop.py).

Mirrors tests/test_analysis.py:

  * pass-level fixtures: for each TL code a true-positive snippet, an
    annotated (suppressed) variant and a clean variant, run in-process
    through ``ModuleContext.parse`` + ``run_passes``;
  * baseline + CLI: the fingerprint round trip (line drift tolerant,
    count capped) and the exit codes (0 clean / 1 new findings / 2 bad
    arguments, baseline or syntax);
  * the port's tree lints clean against its committed baseline, and each
    seeded regression in a scratch copy flips the CLI to exit 1 with its
    code.

The reference's own lint over all of ``src/`` (the port included) is
held by tests/test_analysis.py.
"""
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis.contracts import parse_annotations, tick_path
from repro_torch.analysis.findings import load_baseline, write_baseline
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.passes import ModuleContext, run_passes

REPO = Path(__file__).resolve().parent.parent
BASELINE = "src/repro_torch/analysis/baseline.json"


def findings_for(snippet, path="pkg/mod.py", select=None):
    ctx = ModuleContext.parse(path, textwrap.dedent(snippet))
    return run_passes(ctx, select)


def codes(findings):
    return sorted(f.code for f in findings)


# ==========================================================================
# TL000 — annotation hygiene
# ==========================================================================
def test_tl000_malformed_annotations():
    fs = findings_for(
        """
        x = 1  # torchlint: allow-sync
        y = 2  # torchlint: frobnicate
        z = 3  # torchlint: allow-sync()
        """, select=["TL000"])
    assert codes(fs) == ["TL000"] * 3
    assert any("require a reason" in f.message for f in fs)
    assert any("unknown directive" in f.message for f in fs)


def test_tl000_docstring_mentions_are_not_annotations():
    fs = findings_for(
        '''
        def f():
            """Use ``# torchlint: allow-sync`` with a reason."""
            return 1
        ''')
    assert fs == []


def test_reference_directives_are_not_the_ports():
    """The reference's prefix and marker mean nothing here: a
    ``# jaxlint:`` tick marker or suppression, or a ``hot_path``
    decorator, neither marks nor silences anything."""
    fs = findings_for(
        """
        def tick(x):  # jaxlint: hot-path
            return x.item()

        @hot_path
        def tock(x):
            return x.item()

        def tack(x):  # torchlint: tick-path
            return x.item()  # jaxlint: allow-sync(not ours)
        """, select=["TL001"])
    assert [f.line for f in fs] == [10]


# ==========================================================================
# TL001 — host sync in the tick path
# ==========================================================================
TL001_TP = """
import numpy as np
import torch

def tick(self, step):  # torchlint: tick-path
    a = step.tokens.item()
    b = step.tokens.tolist()
    c = step.tokens.cpu()
    d = step.tokens.numpy()
    torch.cuda.synchronize()
    e = float(torch.sum(step.tokens))
    live = torch.zeros(3) + step.tokens
    f = np.asarray(live)
    g = _host(step.tokens)
    if torch.any(live > 0):
        pass
    while live.sum() > 0:
        live = live - 1
    assert torch.all(live == 0)
    return a, b, c, d, e, f, g
"""


def test_tl001_flags_every_sync_construct():
    fs = findings_for(TL001_TP, select=["TL001"])
    assert codes(fs) == ["TL001"] * 11
    msgs = " | ".join(f.message for f in fs)
    for what in (".item()", ".tolist()", ".cpu()", ".numpy()",
                 "torch.cuda.synchronize()", "float() of a tensor value",
                 "np.asarray of a tensor value", "_host()",
                 "Python if on a tensor value",
                 "Python while on a tensor value",
                 "Python assert on a tensor value"):
        assert what in msgs, what


def test_tl001_decorator_marks_tick():
    fs = findings_for(
        """
        from repro_torch.analysis import tick_path

        @tick_path
        def tick(x):
            return x.item()

        class E:
            @tick_path
            def step(self, x):
                return x.cpu()
        """, select=["TL001"])
    assert codes(fs) == ["TL001", "TL001"]


def test_tl001_allow_sync_suppresses():
    fs = findings_for(
        """
        # torchlint: tick-path
        def collect(step):
            # torchlint: allow-sync(the designated sync point)
            got = _host(step.tokens)
            n = step.tokens.item()  # torchlint: allow-sync(one scalar)
            return got, n
        """, select=["TL001"])
    assert fs == []


def test_tl001_clean_host_math_and_cold_functions():
    fs = findings_for(
        """
        import numpy as np
        import torch

        def tick(self, toks, takes):  # torchlint: tick-path
            n = np.zeros((3,))
            f = float(n.sum())                  # host array: no sync
            s = int(sum(takes))                 # host list
            if self.caches is None:             # not a tensor value
                pass
            x = torch.zeros(3)
            if x.shape[0] > 2 and len(x) and x is not None:
                pass                            # metadata only
            host = _pulled()
            return f + s + int(host[0]) + float(torch.finfo(x.dtype).eps)

        def cold(x):                            # not in the tick
            return x.item()
        """, select=["TL001"])
    assert fs == []


def test_tl001_taint_follows_host_pulls():
    fs = findings_for(
        """
        import torch

        def collect(step):  # torchlint: tick-path
            nxt = torch.argmax(step.logits, -1)
            # torchlint: allow-sync(the pull)
            nxt = _host(nxt)
            return int(nxt[0])                  # host copy: fine
        """, select=["TL001"])
    assert fs == []


# ==========================================================================
# TL003 — cache state escaping the masked scan body
# ==========================================================================
TL003_CLEAN = """
import torch

# torchlint: masked-scan-body
def extend(params, tokens, lengths, caches):
    total = torch.zeros(3)
    for j in range(tokens.shape[1]):
        active = j < lengths
        logits, new, st = decode_step(params, tokens[:, j], caches)
        caches = tree_map_with_path(keep, new, caches)
        last = torch.where(active[:, None], logits, total)
        total = total + torch.where(active, st["adm"], total)
    return last, caches, total
"""


def test_tl003_masked_select_is_clean():
    assert findings_for(TL003_CLEAN, select=["TL003"]) == []


def test_tl003_raw_cache_escape_flagged():
    fs = findings_for(TL003_CLEAN.replace(
        "caches = tree_map_with_path(keep, new, caches)", "caches = new"),
        select=["TL003"])
    assert codes(fs) == ["TL003"]
    assert "['caches']" in fs[0].message


def test_tl003_in_place_write_needs_mask():
    tp = findings_for(
        """
        def body(params, caches):  # torchlint: masked-scan-body
            caches.k[0] = params
            caches.t.add_(1)
            return None
        """, select=["TL003"])
    assert codes(tp) == ["TL003", "TL003"]
    ok = findings_for(
        """
        import torch

        def body(params, caches, active):  # torchlint: masked-scan-body
            caches.k[0] = torch.where(active, params, caches.k[0])
            return None
        """, select=["TL003"])
    assert ok == []


def test_tl003_suppression():
    fs = findings_for(
        """
        def body(params, caches):  # torchlint: masked-scan-body
            caches.k[0] = params  # torchlint: allow-unmasked-write(one row)
            new = step(caches)
            # torchlint: allow-unmasked-write(every row is active here)
            return new
        """, select=["TL003"])
    assert fs == []


# ==========================================================================
# annotation parser, marker, baseline round trip
# ==========================================================================
def test_parse_annotations_surface():
    ann = parse_annotations(textwrap.dedent(
        """
        # torchlint: tick-path
        def f():
            x = 1  # torchlint: allow-sync(reason text)
            return x
        """))
    assert ann.scope_marker("tick-path", 3)          # marker above the def
    assert ann.suppressed("TL001", 4)                # on the line
    assert ann.suppressed("TL001", 5)                # the line below
    assert not ann.suppressed("TL003", 4)            # another code


def test_tick_path_decorator_is_transparent():
    @tick_path
    def f(x):
        return x + 1

    assert f.__torchlint_tick_path__ is True
    assert f(1) == 2


def test_engine_tick_methods_carry_the_marker():
    from repro_torch.serving.engine import Engine
    for name in ("memory_snapshot", "_extend_ragged", "step_batch",
                 "_fused", "collect", "_adopt_prefix"):
        assert getattr(getattr(Engine, name), "__torchlint_tick_path__",
                       False), name


def test_baseline_round_trip_and_count_cap(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("def tick(x):  # torchlint: tick-path\n"
                   "    a = x.item()\n    b = x.tolist()\n")
    found = lint_paths([str(mod)], select=["TL001"])
    assert len(found) == 2
    bl = tmp_path / "baseline.json"
    write_baseline(found, bl, reason="seed")
    new, accepted = load_baseline(bl).split(found)
    assert new == [] and len(accepted) == 2
    # (code, path, text) fingerprints: line drift stays accepted, a SECOND
    # occurrence of the same text overflows the count and fails
    mod.write_text("# moved\ndef tick(x):  # torchlint: tick-path\n"
                   "    a = x.item()\n    b = x.tolist()\n"
                   "    a = x.item()\n")
    drifted = lint_paths([str(mod)], select=["TL001"])
    assert len(drifted) == 3
    new, accepted = load_baseline(bl).split(drifted)
    assert len(accepted) == 2 and len(new) == 1
    assert new[0].text == "a = x.item()"


def test_baseline_version_check(tmp_path):
    bad = tmp_path / "b.json"
    bad.write_text('{"version": 99, "findings": []}')
    with pytest.raises(ValueError, match="version"):
        load_baseline(bad)


# ==========================================================================
# CLI exit codes
# ==========================================================================
def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("def tick(x):  # torchlint: tick-path\n"
                     "    return x + 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("def tick(x):  # torchlint: tick-path\n"
                     "    return x.item()\n")
    assert lint_main([str(clean)]) == 0
    assert "clean" in capsys.readouterr().out
    assert lint_main([str(dirty)]) == 1
    out = capsys.readouterr().out
    assert "TL001" in out and "1 new finding(s)" in out
    bl = tmp_path / "bl.json"
    assert lint_main([str(dirty), "--write-baseline", str(bl),
                      "--reason", "known"]) == 0
    capsys.readouterr()
    assert lint_main([str(dirty), "--baseline", str(bl)]) == 0
    assert "accepted by baseline" in capsys.readouterr().out
    # exit 2: unknown code (the reference's JL codes too), missing path,
    # unreadable baseline, syntax error
    assert lint_main([str(clean), "--select", "TL999"]) == 2
    assert lint_main([str(clean), "--select", "JL001"]) == 2
    assert lint_main([str(tmp_path / "nope.py")]) == 2
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    assert lint_main([str(dirty), "--baseline", str(broken)]) == 2
    bad_py = tmp_path / "bad.py"
    bad_py.write_text("def (:\n")
    assert lint_main([str(bad_py)]) == 2
    capsys.readouterr()


# ==========================================================================
# the port's tree, and seeded regressions in a scratch copy
# ==========================================================================
def run_lint_cli(cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "src/repro_torch",
         "--baseline", BASELINE],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=120)


@pytest.fixture(scope="module")
def scratch_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchlint_tree")
    shutil.copytree(REPO / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_port_tree_lints_clean_with_committed_baseline():
    r = run_lint_cli(REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout


_ANCHOR = '        self.stats["fused_slot_rows"] += float(self.slots)'
SEEDED = [
    ("TL000", "src/repro_torch/serving/engine.py",
     "        # torchlint: allow-sync(collect is the tick's one sync point)",
     "        # torchlint: allow-sync"),
    ("TL001", "src/repro_torch/serving/engine.py", _ANCHOR,
     _ANCHOR + "\n        _dbg = float(torch.sum(self._tok_dev))"),
    ("TL001", "src/repro_torch/serving/engine.py", _ANCHOR,
     _ANCHOR + "\n        if torch.any(self._tok_dev > 0):\n"
               "            self.stats[\"steps\"] += 0"),
    ("TL003", "src/repro_torch/models/inference.py",
     "        caches = tree_map_with_path(keep, new, caches)",
     "        caches = tree_map_with_path(keep, new, caches)\n"
     "        caches = new"),
]


@pytest.mark.parametrize("code,rel,old,new", SEEDED,
                         ids=["TL000", "TL001-float", "TL001-branch",
                              "TL003"])
def test_seeded_regression_fails_lint(scratch_tree, code, rel, old, new):
    target = scratch_tree / rel
    original = target.read_text()
    assert original.count(old) == 1, f"mutation anchor changed in {rel}"
    try:
        target.write_text(original.replace(old, new, 1))
        r = run_lint_cli(scratch_tree)
        assert r.returncode == 1, r.stdout + r.stderr
        assert code in r.stdout, r.stdout
    finally:
        target.write_text(original)
    r = run_lint_cli(scratch_tree)
    assert r.returncode == 0, r.stdout + r.stderr
