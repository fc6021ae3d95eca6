"""Quickstart: WG-KV in 60 seconds (port of ``examples/quickstart.py``).

Builds a reduced qwen3-0.6b, runs a vertical-slash prefill + dual-cache
decode, and prints what the admission policy kept.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import inference as I
from repro_torch.models import registry as R
from repro_torch.models import transformer as T


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced_config("qwen3-0.6b").replace(dtype="float32")
    print(f"arch={cfg.name}  layers={cfg.n_layers}  d={cfg.d_model}  "
          f"W_local={cfg.wgkv.w_local}  tau={cfg.wgkv.tau}")

    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_model(cfg, gen, dev)
    n_backbone = R.count_params_tree(params)
    n_gate = R.gate_params_tree(params)
    print(f"params={n_backbone:,} (write-gate MLPs: {n_gate:,} = "
          f"{n_gate / n_backbone:.2%} — the paper's ~0.4% overhead claim)")

    # ---- prefill 1024 tokens through budgeted vertical-slash attention --
    S, BUDGET = 1024, 128
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device=dev)
    out, caches = I.prefill(params, cfg, toks, budget=BUDGET)
    dc = caches["blocks"]["b0"]  # first super-block's dual cache (stacked)
    print(f"\nprefill {S} tokens with global budget {BUDGET}:")
    print(f"  mean admission rate g>=tau : {float(out.mean_admission):.3f}")
    print(f"  global-cache fill per head : {dc.gcnt[0, 0].tolist()}")
    print(f"  local ring size            : {dc.lk.shape[3]} tokens")
    full = S * cfg.n_kv_heads
    kept = int(dc.gcnt[0].sum()) + cfg.wgkv.w_local * cfg.n_kv_heads
    print(f"  resident KV fraction       : {kept / full:.2%} of full cache")

    # ---- decode 16 tokens through the dual cache (lazy promotion) -------
    tok = toks[:, -1]
    for _ in range(16):
        logits, caches, _ = I.decode_step(params, cfg, tok, caches)
        tok = logits.argmax(-1)
    dc2 = caches["blocks"]["b0"]
    print("\nafter 16 decode steps (lazy promotion active):")
    print(f"  global-cache fill per head : {dc2.gcnt[0, 0].tolist()}")
    print(f"  ring pointer               : {int(dc2.ptr[0][0])}")
    print(f"  last sampled token         : {int(tok[0])}")
    print("\nOK — see repro_torch.examples.train_gate to LEARN the admission "
          "policy.")
    return {"params": n_backbone, "gate_params": n_gate,
            "mean_admission": float(out.mean_admission),
            "gcnt": dc2.gcnt.cpu(), "last_token": int(tok[0])}


if __name__ == "__main__":
    main()
