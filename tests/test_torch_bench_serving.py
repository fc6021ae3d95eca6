"""The port's serving A/B bench (``repro_torch.benchmarks.bench_serving``)
end to end on the CPU: ``run(smoke=True)`` for ``wgkv`` and ``dense`` on
the committed substrate. Inside it every replay asserts its streams
byte-identical (async against sync, ``quest:<all pages>`` against
selection off, the prefix store against cold prefill); this file reads
the record it writes. Its trace is the port's own (numpy), so no number
is compared with the reference's ``BENCH_serving.json``.
"""
import json

import torch

from repro_torch.benchmarks import bench_serving as PB

torch.set_num_threads(2)


def test_smoke_run_writes_a_schema_5_record(tmp_path):
    path = tmp_path / "BENCH_serving_torch.json"
    rows = PB.run(backends=("wgkv", "dense"), smoke=True, device="cpu",
                  json_path=str(path))
    rec = json.loads(path.read_text())
    assert rec["schema_version"] == PB.BENCH_SCHEMA_VERSION == 5
    assert rec["device"] == "cpu (plain PyTorch)"
    tr = rec["trace"]
    assert (tr["requests"], tr["prompt_len"], tr["max_new"], tr["smoke"],
            tr["mesh"]) == (4, 48, 4, True, None)
    assert tr["arrival_ticks"] == [r["arrival_tick"] for r in PB.record_trace(
        4, 256, prompt_len=48, max_new=4, seed=1)]
    wg, dense = rec["backends"]["wgkv"], rec["backends"]["dense"]
    for b in (wg, dense):
        assert b["requests"] == 4 and b["decode_steps"] > 0
        assert b["prefix"]["hit_rate"] > 0
    assert dense["mean_admission"] == 1.0 and wg["mean_admission"] < 1.0
    assert wg["kv_tokens_peak"] < dense["kv_tokens_peak"]
    sel = wg["selection"]
    assert sel["parity_k"] == PB.CAPACITY // 16 and "quest:4" in sel["per_k"]
    assert "selection" not in dense
    assert rec["ab"]["wgkv"]["kv_memory_frac_of_dense"] < 1.0
    assert rows[-1] == ("serving/json", 0.0, str(path))
    assert PB.check_slo(rec, rec, 0.0) == []
