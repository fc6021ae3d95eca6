"""Gate-distillation training entry point of the port (port of
``repro/launch/train.py``; the paper's training recipe).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-0.6b --reduced --device cpu --steps 25 --batch 2 \\
        --seq 96 --lam 0.3 --out /tmp/gates.npz
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-0.6b --steps 4 --batch 2 --seq 2048 --log-every 1

The flags are the reference's, plus ``--device`` (default ``cuda``; the
CPU only when asked) and ``--log-every``. The backbone is random, drawn
from ``--seed`` with a ``torch.Generator`` (the repository holds no
pretrained base), and the run is float32, as the reference forces. On
CUDA the student's write-gated attention and gate run through the
``gated_flash`` and ``gate_mlp`` kernels and their backward kernels; an
arch whose training path reaches a kernel without a backward (the
hybrid's ``rglru_scan``) raises on CUDA. The gates file is the
reference's format (``training/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced_config
from repro_torch.data.synthetic import DistillStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint
from repro_torch.training import trainer as TR
from repro_torch.training.optimizer import cosine_schedule


def run_training(cfg, *, steps: int, batch: int, seq: int, lam: float,
                 peak_lr: float = 1e-3, seed: int = 0, log_every: int = 10,
                 out: Optional[str] = None, params=None, verbose: bool = True,
                 device: DeviceLike = None):
    """Trains the gates of ``params`` (default: a random backbone from
    ``seed``) for ``steps`` steps on :class:`DistillStream` batches.
    Returns (params with the trained gates, final TrainState, history):
    one record per logged step with its metrics, ``step``, the wall
    seconds since the start (``wall_s``) and of the step (``step_s``),
    and on CUDA the peak of allocated memory so far (``peak_mem_gib``)."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                              dev)
    state = TR.init_train_state(params)
    lr = cosine_schedule(peak_lr, steps)
    step_fn = TR.make_train_step(cfg, lr=lr, lam=lam)
    stream = DistillStream(seed + 1, batch, seq, cfg.vocab_size, device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    t0 = time.perf_counter()
    for i, batch_data in zip(range(steps), stream):
        ts = time.perf_counter()
        state, m = step_fn(state, params, batch=batch_data)
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in m.items()}   # waits for the step
            now = time.perf_counter()
            rec.update(step=i, wall_s=round(now - t0, 3),
                       step_s=round(now - ts, 3))
            if cuda:
                rec["peak_mem_gib"] = round(
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
            history.append(rec)
            if verbose:
                mem = (f" peak {rec['peak_mem_gib']} GiB" if cuda else "")
                print(f"step {i:5d} loss={rec['loss']:.4f} "
                      f"distill={rec['distill']:.4f} "
                      f"admission={rec['admission_rate@0.1']:.3f} "
                      f"({rec['step_s']}s, {rec['wall_s']}s{mem})",
                      flush=True)
    params = TR.set_gates(params, state.gates)
    if out:
        checkpoint.save(out, state.gates,
                        meta={"arch": cfg.name, "lam": lam, "steps": steps,
                              "history": history})
    return params, state, history


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lam", type=float, default=0.08)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(dtype="float32")
    if not (cfg.wgkv.enabled and cfg.wgkv_applicable()):
        raise SystemExit(f"{args.arch}: WG-KV inapplicable (no KV cache); "
                         "see DESIGN.md §4")
    params, state, history = run_training(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lam=args.lam,
        peak_lr=args.lr, seed=args.seed, out=args.out, device=args.device,
        log_every=args.log_every)
    print(json.dumps(history[-1], indent=1))
    return {"cfg": cfg, "params": params, "state": state, "history": history}


if __name__ == "__main__":
    main()
