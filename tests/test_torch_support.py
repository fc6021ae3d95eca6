"""Shared set-up for the port's parity tests, plus the port's own
infrastructure tests: weight conversion, CUDA-by-default entry points and
import hygiene (the port never imports JAX or the reference package).

The helpers build the port's config from the reference's, draw gate
weights with numpy so that scores spread across tau (the random init's
``b2 = 1.0`` admits nearly everything and would test only one branch), and
hand the same numpy weights to both packages.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro.models import transformer as T
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import WGKVConfig as TWGKVConfig
from repro_torch.convert import params_from_numpy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def port_cfg(jcfg):
    """The port's ModelConfig with every field of the reference's."""
    fields = dataclasses.asdict(jcfg)
    fields["wgkv"] = TWGKVConfig(**fields["wgkv"])
    if fields.get("moe") is not None:
        raise ValueError("MoE configs are not ported")
    return TModelConfig(**fields)


def spread_gate(params_np, cfg, seed: int):
    """Replace every layer's gate weights with numpy draws whose scores
    spread across tau (both admit and reject branches taken)."""
    rng = np.random.default_rng(seed)
    gate = params_np["blocks"]["b0"]["attn"]["gate"]
    r, h, f, m = gate["w1"].shape
    gate["w1"] = (rng.standard_normal((r, h, f, m)) / np.sqrt(f)
                  ).astype(np.float32)
    gate["b1"] = (0.1 * rng.standard_normal((r, h, m))).astype(np.float32)
    gate["w2"] = (3.0 * rng.standard_normal((r, h, m, 1)) / np.sqrt(m)
                  ).astype(np.float32)
    gate["b2"] = (-1.5 + 0.3 * rng.standard_normal((r, h, 1))
                  ).astype(np.float32)
    return params_np


def parity_setup(*, seed: int = 0, **wgkv_kw):
    """(jax cfg, jax params, port cfg, port params on the CPU), one set of
    weights: the reference's init with numpy-drawn gate weights."""
    jcfg = make_cfg("qwen3-0.6b", **wgkv_kw)
    params_np = jax.tree.map(np.asarray,
                             T.init_model(jax.random.PRNGKey(seed), jcfg))
    params_np = spread_gate(params_np, jcfg, seed + 100)
    jparams = jax.tree.map(jnp.asarray, params_np)
    tcfg = port_cfg(jcfg)
    return jcfg, jparams, tcfg, params_from_numpy(params_np, tcfg, "cpu")


# ==========================================================================
# weight conversion
# ==========================================================================
def test_params_from_numpy_nested_flat_and_npz(tmp_path):
    from repro.training.checkpoint import save
    from repro_torch.tree import tree_leaves_with_path

    jcfg = make_cfg("qwen3-0.6b")
    tcfg = port_cfg(jcfg)
    params = T.init_model(jax.random.PRNGKey(3), jcfg)
    nested = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    path = str(tmp_path / "ckpt.npz")
    save(path, params)
    from_file = params_from_numpy(path, tcfg, "cpu")
    with np.load(path) as z:
        from_flat = params_from_numpy({k: z[k] for k in z.files}, tcfg, "cpu")
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = list(tree_leaves_with_path(nested))
    assert len(got) == len(want)
    for tree in (from_file, from_flat):
        other = dict(tree_leaves_with_path(tree))
        for p, leaf in got:
            assert leaf.dtype == torch.float32
            assert torch.equal(leaf, other[p]), p
    flat_ref = {jax.tree_util.keystr(p): np.asarray(v) for p, v in want.items()}
    for p, leaf in got:
        key = "".join(f"['{k}']" for k in p)
        np.testing.assert_array_equal(leaf.numpy(), flat_ref[key])


def test_params_from_numpy_rejects_wrong_depth():
    jcfg = make_cfg("qwen3-0.6b")
    tcfg = port_cfg(jcfg).replace(n_repeats=3)
    params = jax.tree.map(np.asarray, T.init_model(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="repeats"):
        params_from_numpy(params, tcfg, "cpu")


# ==========================================================================
# entry points run on CUDA unless the caller asks for the CPU
# ==========================================================================
def test_entry_points_need_cuda_without_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.engine import Engine

    tcfg = port_cfg(make_cfg("qwen3-0.6b"))
    params = init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("wgkv", params, tcfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(jax.tree.map(
            np.asarray, T.init_model(jax.random.PRNGKey(0), make_cfg())), tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--requests", "1"])
    # and the explicit CPU request works
    Engine(params, tcfg, slots=1, capacity=64, device="cpu")


@pytest.mark.parametrize("flag", [
    ["--backend", "dense"], ["--selection", "quest:2"], ["--quest-pages", "2"],
    ["--evict-budget", "32"], ["--prefix-cache"], ["--mesh", "1x1"],
])
def test_serve_rejects_unported_flags(flag, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as ex:
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                    *flag])
    assert ex.value.code == 2
    assert "not ported" in capsys.readouterr().err


# ==========================================================================
# import hygiene: the port stands alone
# ==========================================================================
def test_port_imports_no_jax_and_no_reference_package():
    code = r"""
import ast, importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
tree = ast.parse(open(sys.argv[1]).read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(mods))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run([sys.executable, "-c", code, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip()) >= 20
