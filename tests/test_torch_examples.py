"""The reference's four examples on the port (``repro_torch.examples``),
each through its ``main([... "--device", "cpu"])`` at a reduced size,
with what each one's output must show; and the dual-cache read at a
global budget off the page grid, which ``serve_longcontext``'s config
(budget 0.4 x 512 = 204 tokens) needs.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced_config as j_reduced_config
from repro.core import dual_cache as JDC
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch.core import dual_cache as TDC
from repro_torch.examples import (composability, quickstart,
                                  serve_longcontext, train_gate)
from repro_torch.kernels import ops as tops
from repro_torch.training import checkpoint as TCK
from test_torch_kernels import _dual_cache

torch.set_num_threads(2)


def test_quickstart_counts_the_reference_gate_params(capsys):
    res = quickstart.main(["--device", "cpu"])
    jcfg = j_reduced_config("qwen3-0.6b").replace(dtype="float32")
    like = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jcfg))
    assert res["gate_params"] == JR.gate_params_tree(like) > 0
    assert res["params"] == JR.count_params_tree(like)
    assert 0.0 < res["mean_admission"] <= 1.0
    out = capsys.readouterr().out
    assert "after 16 decode steps" in out and "OK" in out


def test_composability_prints_its_four_configurations(capsys):
    res = composability.main(["--device", "cpu"])
    assert list(res) == list(composability.CONFIGS)
    out = capsys.readouterr().out.splitlines()
    assert [ln.split("|")[0].strip() for ln in out] == list(
        composability.CONFIGS)
    # SnapKV holds the global cache at its bound of 64 tokens per head
    assert res["admission only"]["evictions"] == 0
    assert res["all three"]["gmean"] <= 64.0
    assert all(np.isfinite(r["logit_max"]) for r in res.values())


def test_serve_longcontext_drains_the_pool(capsys):
    res = serve_longcontext.main(["--device", "cpu"])
    assert res["pool_pages"] == 0
    assert res["verify_paged"] is not None and res["verify_paged"] < 2e-3
    assert sorted(len(o) for o in res["outputs"].values()) == [24] * 4
    assert "stream rid=" in capsys.readouterr().out


def test_train_gate_small_writes_the_gates(tmp_path):
    out = tmp_path / "gates.npz"
    res = train_gate.main(["--device", "cpu", "--small", "--pretrain-steps",
                           "2", "--gate-steps", "2", "--out", str(out)])
    assert len(res["history"]) == 2
    gates = TCK.restore(str(out), {k: v for k, v in
                                   train_gate.TR.get_gates(res["params"]).items()})
    for k, v in train_gate.TR.get_gates(res["params"]).items():
        torch.testing.assert_close(gates[k], v, rtol=0, atol=0)


def test_train_gate_default_out_is_in_the_temp_dir(tmp_path, monkeypatch):
    """Without ``--out`` the gates go to ``wgkv_gates.npz`` in the temp
    dir (``TMPDIR``'s), not to a fixed path two checkouts would share."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    train_gate.main(["--device", "cpu", "--small", "--pretrain-steps", "1",
                     "--gate-steps", "2"])
    assert (tmp_path / "wgkv_gates.npz").exists()


def test_dual_cache_read_at_an_unaligned_budget():
    """C = 20 (not a multiple of 16 pages): the read equals the
    reference's concat softmax over ``cache_kv_for_attention`` and,
    bitwise, the port's read of the same cache padded to 32 slots by
    hand."""
    rng = np.random.default_rng(3)
    b, h, g, c, w, hd = 2, 2, 2, 20, 32, 16
    leaves = _dual_cache(rng, b, h, c, w, hd, [[20, 3], [0, 17]], [40, 7])
    q = rng.standard_normal((b, h * g, hd)).astype(np.float32)
    tcache = TDC.DualCache(**{k: torch.from_numpy(v) for k, v in
                              leaves.items()})
    got = tops.dual_cache_attention(torch.from_numpy(q), tcache)
    padded = tcache._replace(
        gk=torch.nn.functional.pad(tcache.gk, (0, 0, 0, 12)),
        gv=torch.nn.functional.pad(tcache.gv, (0, 0, 0, 12)))
    assert torch.equal(got, tops.dual_cache_attention(torch.from_numpy(q),
                                                      padded))
    jk, jv, jvalid = JDC.cache_kv_for_attention(JDC.DualCache(
        **{k: jnp.asarray(v) for k, v in leaves.items()}))
    qg = q.reshape(b, h, g, hd)
    lg = np.einsum("bhgd,bhkd->bhgk", qg, np.asarray(jk)) * hd ** -0.5
    lg = np.where(np.asarray(jvalid)[:, :, None], lg, -1e30)
    wts = np.exp(lg - lg.max(-1, keepdims=True))
    wts /= wts.sum(-1, keepdims=True)
    want = np.einsum("bhgk,bhkd->bhgd", wts, np.asarray(jv)).reshape(q.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
