"""Composability demo (paper §5.4; port of ``examples/composability.py``):
Admission + Selection + Eviction in one decode loop — WG-KV pre-filters
writes, Quest focuses reads, SnapKV prunes obsolete history under a hard
memory bound.

    PYTHONPATH=src python -m repro_torch.examples.composability [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import WGKVConfig
from repro_torch.device import resolve_device
from repro_torch.models import inference as I
from repro_torch.models import transformer as T

CONFIGS = {
    "admission only": I.DecodeOptions(),
    "admission + Quest(select 2 pages)": I.DecodeOptions(quest_pages=2),
    "admission + SnapKV(bound 64/head)": I.DecodeOptions(evict_hard_budget=64,
                                                         w_obs=32),
    "all three": I.DecodeOptions(quest_pages=2, evict_hard_budget=64,
                                 w_obs=32),
}


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.composability")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced_config("qwen3-0.6b").replace(
        dtype="float32",
        wgkv=WGKVConfig(enabled=True, w_local=32, tau=0.1, gate_hidden=32,
                        global_budget_frac=0.5, sink=4))
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                         device=dev)
    results = {}
    for name, opts in CONFIGS.items():
        _, caches = I.prefill(params, cfg, toks[:, :256], budget=128,
                              opts=opts)
        tok = toks[:, 255]
        trig = 0.0
        for _ in range(64):
            logits, caches, st = I.decode_step(params, cfg, tok, caches,
                                               opts=opts)
            tok = logits.argmax(-1)
            trig += float(st["evict_triggers"])
        dc = caches["blocks"]["b0"]
        gmean = float(dc.gcnt.float().mean())
        print(f"{name:38s} | mean global entries/head: {gmean:6.1f} | "
              f"evictions: {trig:4.0f} | last logitmax: "
              f"{float(logits.max()):.2f}")
        results[name] = {"gmean": gmean, "evictions": trig,
                         "logit_max": float(logits.max())}
    return results


if __name__ == "__main__":
    main()
