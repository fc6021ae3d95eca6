"""Serve a long-context batch through the continuous-batching orchestrator
(port of ``examples/serve_longcontext.py``): dual cache + paged physical
memory + chunked prefill + token streaming.

    PYTHONPATH=src python -m repro_torch.examples.serve_longcontext [--device cpu]

serving
-------
The orchestrator wraps the JetStream-style engine backend
(prefill/insert/dispatch-collect) with a request queue, a batched
chunked-prefill scheduler (every in-flight prefill advances in one
ragged call per tick), per-request token streams, and latency
telemetry::

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.orchestrator import Orchestrator, SchedulerConfig

    eng = Engine(params, cfg, slots=3, capacity=512)
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=64),
                        max_pending=32)           # queue backpressure
    rid = orch.submit(prompt, max_new=24,
                      on_token=lambda rid, tok, last: ...)  # streaming
    orch.run()                                    # tick until drained
    orch.tokens(rid)                              # full decoded output
    orch.telemetry.report()                       # TTFT/TPOT/throughput/
                                                  # admission/pool-util
"""
import argparse

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import WGKVConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine
from repro_torch.serving.orchestrator import Orchestrator, SchedulerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_longcontext")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced_config("phi4-mini-3.8b").replace(
        dtype="float32",
        wgkv=WGKVConfig(enabled=True, w_local=32, tau=0.1, gate_hidden=32,
                        global_budget_frac=0.4, sink=4))
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    eng = Engine(params, cfg, slots=3, capacity=512, pool_pages=8192,
                 temperature=0.0, device=dev)
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=64))

    gen = torch.Generator().manual_seed(7)  # prompts are host data
    for plen in (320, 196, 96, 256):  # ragged prompts
        prompt = torch.randint(0, cfg.vocab_size - 8, (plen,),
                               generator=gen).tolist()
        stream_cb = (lambda r, tok, last:
                     print(f"  stream rid={r} tok={tok}"
                           + (" <eor>" if last else ""))) if plen == 96 else None
        rid = orch.submit(prompt, max_new=24, on_token=stream_cb)
        print(f"queued request {rid}: prompt_len={plen}")

    step = 0
    verified = None
    while not orch.queue.all_done() and step < 400:
        orch.tick()
        step += 1
        if step % 8 == 0:
            live = sum(eng.live)
            print(f"tick {step:3d}: live={live} "
                  f"pool_pages={eng.pool.pages_in_use} "
                  f"pool_util={eng.pool.utilization():.2f}")
        if verified is None and any(eng.live):
            verified = eng.verify_paged()  # check while caches are resident

    print("\nresults:")
    outputs = {}
    for rid, r in orch.queue.requests.items():
        outputs[rid] = list(r.out)
        print(f"  req {rid}: generated {len(r.out)} tokens, "
              f"first 8 = {r.out[:8]}")
    print("\ntelemetry:")
    print(orch.telemetry.report())
    print(f"\npaged-vs-logical verification (live batch): {verified:.2e}")
    print(f"pool pages still allocated (should be 0): {eng.pool.pages_in_use}")
    return {"outputs": outputs, "verify_paged": verified,
            "pool_pages": eng.pool.pages_in_use, "ticks": step}


if __name__ == "__main__":
    main()
