"""End-to-end driver (port of ``examples/train_gate.py``): pre-train a
~100M-class model on synthetic long-context data, then run the paper's
recipe — freeze the backbone and distill a Write-Gate admission policy —
for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_gate            # ~100M
    PYTHONPATH=src python -m repro_torch.examples.train_gate --small    # ~20M

The pre-training steps differentiate every parameter with torch autograd
(``training/trainer.py::lm_train_step``: the next-token loss, AdamW from
``training/optimizer.py``); the distillation is
``repro_torch.launch.train.run_training``.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import WGKVConfig
from repro_torch.data.synthetic import DistillStream
from repro_torch.device import resolve_device
from repro_torch.launch.train import run_training
from repro_torch.models import transformer as T
from repro_torch.models.registry import count_params_analytic
from repro_torch.training import trainer as TR
from repro_torch.training.optimizer import cosine_schedule


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_gate")
    ap.add_argument("--small", action="store_true",
                    help="~20M params / seq 256")
    ap.add_argument("--pretrain-steps", type=int, default=None)
    ap.add_argument("--gate-steps", type=int, default=300)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "wgkv_gates.npz"),
                    help="where the distilled gates are written (default: "
                         "wgkv_gates.npz in the temp dir, /tmp unless "
                         "TMPDIR says otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.small:
        cfg = get_reduced_config("smollm-360m").replace(
            dtype="float32", d_model=256, n_repeats=2,
            wgkv=WGKVConfig(enabled=True, w_local=32, gate_hidden=32, sink=4))
        seq, batch, pre_steps = 256, 4, args.pretrain_steps or 150
    else:
        # ~100M-class: smollm-360m at half depth
        cfg = get_reduced_config("smollm-360m").replace(
            dtype="float32", d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, n_repeats=6, vocab_size=8192,
            wgkv=WGKVConfig(enabled=True, w_local=64, gate_hidden=64, sink=4))
        seq, batch, pre_steps = 512, 4, args.pretrain_steps or 200
    print(f"model: {count_params_analytic(cfg) / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, seq {seq}")

    # ---- phase 1: pre-train the backbone (teacher) -----------------------
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = TR.init_lm_train_state(params)
    lr = cosine_schedule(3e-3, pre_steps)
    stream = DistillStream(1, batch, seq, cfg.vocab_size, device=dev)
    t0 = time.time()
    for i, b in zip(range(pre_steps), stream):
        state, m = TR.lm_train_step(state, cfg, {"tokens": b["tokens"]}, lr=lr)
        if i % 25 == 0:
            print(f"[pretrain] step {i:4d} lm_loss={float(m['lm_loss']):.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    # ---- phase 2: the paper — freeze backbone, distill the write gate ----
    print("\n[gate distillation] backbone FROZEN; training Write-Gate MLPs only")
    params, _, hist = run_training(
        cfg, steps=args.gate_steps, batch=batch, seq=seq, lam=args.lam,
        params=state.params, out=args.out, device=dev)
    final = hist[-1]
    print(f"\nfinal: distill={final['distill']:.4f} "
          f"admission_rate={final['admission_rate@0.1']:.3f} "
          f"(cache ~{final['admission_rate@0.1'] * 100:.0f}% + local window)")
    print(f"gates saved to {args.out}")
    return {"cfg": cfg, "params": params, "history": hist}


if __name__ == "__main__":
    main()
