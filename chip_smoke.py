#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; exits non-zero, and
prints no result, without them. Phases, any failure fatal:

  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — the kernels from ``src/repro_torch/csrc`` (nine entry
                points in eight sources: the six forward kernels, two of
                them with a second mode, and the backward kernels of
                ``gate_mlp``, ``gated_flash`` and ``rglru_scan``), one nvcc
                per source, all started together.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, at the main paths' shapes (qwen3-0.6b's and
                recurrentgemma-9b's, and a larger or smaller one), f32 and
                bf16 for the attention kernels; the forward kernels also at
                the odd GQA groups of the dense archs (15 / 5 at hd 64, 24 /
                8 and 40 / 10 at hd 128: their serve and offline decode,
                gate, S 4096 prefill and tau probe shapes), with times
                (CUDA events, and the device time of the same calls
                replayed from a CUDA graph; for ``paged_decode`` also each
                of its two kernels' time under torch.profiler), the plain
                version's time, a library yardstick where one exists, and
                the card's bound at the rate of the kernel's arithmetic;
                ``paged_decode_selected`` also bitwise against
                ``paged_decode`` at the identity ids, and two calls of
                ``paged_decode``, ``vertical_slash``, ``gated_flash``,
                ``gate_mlp`` and ``rglru_scan`` bitwise equal.
  4. serve-cli  — ``repro_torch.launch.serve`` at full qwen3-0.6b width,
                its startup tau probe (a gated forward) included.
  5. serve-long — ``ServeSession`` at full width (depth cut to
                ``SERVE_REPEATS`` 4 layers) with 384-token prompts, so
                tokens leave the 256-token ring and lazy promotion runs;
                launch counters prove the decode kernels carried it.
  6. prefill-long  — ``inference.prefill`` (budgeted vertical-slash, paper
                §4.2) of a 4096-token prompt at full width, budget 1024,
                then 16 greedy ``decode_step``s from its dual caches.
  7. decode-select — from prefill-long's caches (C = 1024), 16 greedy
                ``decode_step``s with Quest selection: ``quest:64`` (every
                page) bitwise equal to selection off, ``quest:8`` through
                ``paged_decode_selected`` only, and mask mode
                (``quest_pages=8``) within 5e-5 of ``quest:8``.
  8. forward-gated — ``transformer.forward(mode="gated")`` at full width
                over 2048 tokens (the write-gated training forward).
  9. serve-compose — ``ServeSession`` at full width (depth cut to 14
                layers) with ``quest:2`` decode selection and SnapKV
                eviction (budget 96): both run, and the paged pool stays
                within 2e-3 after an eviction.
 10. substrate — the trained bench substrate
                (``checkpoints/bench_model_lam0.15.npz``): one numpy
                prompt through prefill + 16 greedy decode steps on the card
                (kernels) and on the CPU (plain path), once plain and once
                with ``quest:2`` and eviction; tokens and integer cache
                state must be identical, logits within 1e-4.
 11. rg-serve — ``repro_torch.launch.serve --arch recurrentgemma-9b`` at
                full width (38 layers: a 2-block RG-LRU stem and 12 x
                (RG-LRU, RG-LRU, local attention), d_model 4096, f32), 2
                requests of 64 tokens, 8 new tokens, the tau probe.
 12. rg-prefill — ``inference.prefill`` of a 4096-token prompt through the
                full-width hybrid (budget 1024, ring 2048): 26
                ``rglru_scan`` and 12 ``vertical_slash`` launches; then 16
                greedy decode steps. Then rg-prefill-dense: the dense
                baseline of the same prompt, ``prefill(use_wgkv=False)``
                and 16 steps: 12 ``gated_flash_window`` (the hard window,
                W 2048) and 26 ``rglru_scan`` a prefill, 12 x 16
                ``paged_decode_starts`` (the read from a start offset),
                and no other kernel; its wall and decode per step beside
                WG-KV's.
 13. rg-forward — ``transformer.forward(mode="gated")`` of the hybrid over
                4096 tokens: 26 ``rglru_scan`` and 12 ``gated_flash``.
 14. rg-substrate — the reduced hybrid with its 2-block stem (S 128,
                window 32) through prefill + 8 greedy steps on the card and
                on the CPU: identical tokens and integer cache state,
                logits and recurrent states within 1e-4; then the same for
                its dense baseline (``use_wgkv=False``: the windowed
                prefill and decode read).

The baselines and the prefix store (run after phase 10, before the
recurrentgemma phases):

  prefill-dense — ``inference.prefill(use_wgkv=False)`` of prefill-long's
                4,096-token prompt at full width and depth (28
                ``gated_flash`` launches at W = S, g = 1) and 16 greedy
                dense decode steps (28 one-segment ``paged_decode`` each),
                beside prefill-long's WG-KV numbers.
  serve-ab    — ``ServeSession`` at full width, depth cut to
                ``SERVE_REPEATS`` (4) of 28 layers: 2 x 384-token
                prompts, 16 new tokens, through
                ``wgkv`` and ``dense``, and one of them through
                ``streaming_llm`` and ``duo``; TTFT, TPOT, tokens/s, the
                KV-token peak and KV bytes per backend. ``dense`` runs
                ``paged_decode`` only, the static backends never the gate;
                the paged backends' pools verify.
  prefix      — a multi-turn replay (depth cut to 4 layers): 2
                conversations x 2 turns through the prefix store for
                ``wgkv`` and ``dense``; hit streams equal cold streams, hits
                happen, a hit row's pool verifies, and every page is
                reclaimed once the store is cleared.
  substrate-ab — the trained substrate served by ``dense``,
                ``streaming_llm`` and ``duo`` on the card and on the CPU:
                identical streams, KV tokens per tick and integer cache
                state.
  sentinels   — a serve-cli-sized mix (reduced qwen3-0.6b, 4 slots, five
                prompts, chunk 64, dispatch-ahead 1), as served (with the
                work counter active: its counted launches equal the
                counters') and with ``quest:2``, under
                ``analysis.CompileSentinel`` and
                ``analysis.SyncSentinel``, whose dispatch window runs
                under ``torch.cuda.set_sync_debug_mode("error")``: no
                sync in dispatch, every step-shape budget held; and an
                implicit sync planted in the window must raise.
  legacy-loop — ``Engine.add_request`` / ``run`` (the fixed-slot loop)
                with the trained substrate on the card and on the CPU:
                equal streams and step-shape counts.
  mesh        — sharded serving (``serving/sharded.py``) of full-width
                qwen3-0.6b (14 of 28 layers): the flat port,
                a 1 x 1 mesh over NCCL (a world of one, under both
                sentinels) and a 1 x 2 mesh whose two ranks share the
                card over gloo (heads split: tokens equal the flat
                run's, integer cache state equal to its head slice,
                floats within 1e-4, a ``gate_mlp`` and a
                ``paged_decode`` a layer and position step on each rank,
                the counted collective bytes equal the prediction); each
                run's wall and the ranks per card.
  mesh-steps  — the sharded step bundles (``launch/steps.py`` with a
                mesh) of full-width qwen3-0.6b (28 layers, f32): one
                train step at 2 x 1,024 (remat; FSDP over "data"; 2 x
                256 on 2 x 1), one prefill (1 x 4,096, budget 1,024; 2 x 512 on
                2 x 1) and 16 greedy decode steps on its caches, on a 1
                x 1 NCCL mesh and 1 x 2 and 2 x 1 gloo meshes on the
                one card,
                each rank held to the flat bundles (loss 1e-5 relative,
                new gates, logits 1e-4, tokens and integer cache leaves
                equal), its launches to the counts from the shapes, its
                collective bytes by axis to a fake-group meta run's
                (which overlaps the gloo ranks), and rank 0's counts to
                it whole; at 2 x 1 also one decode step with the global
                cache split over "data" (``paged_decode``'s lse, combined
                over the ranks) against the flat step; the 16 x 16 dry
                run's rank-0 record of train_4k printed.
  mesh-archs  — the MoE and hybrid archs on the mesh, full width, f32,
                depth cut (printed), gates admitting about 16 % of
                tokens: granite-moe-3b-a800m (8 of 32 layers) served
                flat, on a 1 x 1 NCCL mesh under both sentinels and on a
                1 x 2 gloo mesh (20 of 40 experts a rank), and its
                prefill of 1 x 2,048 (budget 512) and 8 decode steps
                through the bundles; recurrentgemma-9b (stem + 1
                repeat) a prefill of 1 x 2,048 and 8 decode steps with
                its RG-LRU channels split (``rglru_scan`` on 2,048
                channels a rank; its 1 x 2 train step was cut for time);
                qwen3-moe-235b-a22b (1 of 94 repeats, 64 experts
                a rank) a prefill of 1 x 1,024 and 4 decode steps; each
                1 x 2 rank held to the flat run with mesh-steps' holds
                (logits within 1e-4 of their scale); granite's prefill
                again with the init's gates, the budget binding (512 of
                2,048), flat and on the 1 x 2 ranks: layer 0's scores
                within 1e-6 and its choices equal but for near-ties
                (1e-6 of the budget's edge), each deeper layer's up to
                the first that differs within twice its score gap; the
                rank's ``x @ w_k`` against the flat columns, bitwise,
                printed; the 16 x 16 dry
                run's rank-0 records of qwen3-moe-235b-a22b at train_4k
                and decode_32k printed beside the card's process bytes.
  mesh-xlstm  — xlstm-350m on the mesh at full width (d 1,024, 4 heads),
                f32, depth cut to 2 of 12 repeats (printed): the
                full-parameter train step at 2 x 256 (remat; from AdamW
                step 749, at the schedule's peak rate; its gradients
                read from AdamW's moments), a prefill of 1 x 512 and 8
                greedy decode steps, flat, on a 1 x 1 NCCL mesh, a 1 x 2
                gloo mesh (2 heads a rank: the mLSTM and the sLSTM split
                by head, the sLSTM's MLP by its width) and a 2 x 1 gloo
                mesh (rows and FSDP over "data"); each rank held to the
                flat run (loss 1e-5 relative; each leaf's gradient, the
                logits and each state leaf within 1e-4 of their own
                scale, the mLSTM gate biases' floored at 1e-2 of the
                largest gradient; each leaf's new value within 1e-4 of
                AdamW's step on the rank's block with its moments;
                tokens equal) and its collective bytes
                to the fake-group meta run's; in the 2 x 1 world also
                granite-moe-3b-a800m's ``moe_ffn`` at full width on 2 x
                64 rows in one routing group gathered over "data", its
                gradients (x, the router, the experts) against the flat
                ones; the 16 x 16 dry run's rank-0 records of xlstm-350m
                printed beside the card's process bytes.

Gate-distillation training (run after substrate-ab):

  train       — ``repro_torch.launch.train --arch qwen3-0.6b --steps 4
                --batch 2 --seq 2048`` at full width and depth (28
                layers, f32, a seeded random backbone): per step wall
                time, loss, distill, admission and peak memory; 28
                launches per step of each of ``gated_flash``,
                ``gated_flash_bwd``, ``gate_mlp`` and ``gate_mlp_bwd``;
                the backbone bitwise unchanged, the gates moved.
  train-substrate — three ``train_step``s of the trained substrate on the
                card and on the CPU from the same numpy tokens: losses and
                aux within 1e-4 relative, the first step's gate gradients
                within 1e-4 of each tensor's largest magnitude.

Training the hybrid, and the dense archs smollm-360m, phi4-mini-3.8b and
phi3-medium-14b (run after rg-substrate):

  rg-train    — ``repro_torch.launch.train --arch recurrentgemma-9b
                --steps 3 --batch 1 --seq 4096`` at full width and depth
                (38 layers, f32; S past the 2,048 window, so distill is
                not 0): per step wall time, loss and peak memory (under 80
                GB); per step 12 launches each of ``gated_flash`` (hd 256),
                ``gated_flash_bwd``, ``gate_mlp`` (F 512) and
                ``gate_mlp_bwd``, 52 of ``rglru_scan`` (student and
                teacher) and 22 of ``rglru_scan_bwd`` (the RG-LRU layers
                after the first gate; the four before it get no gradient);
                one more step under torch.profiler.
  rg-train-substrate — three ``train_step``s of the reduced hybrid (a
                2-block stem and two repeats, so RG-LRU blocks follow a
                gate) on the card and on the CPU from the same numpy
                tokens: losses and aux within 1e-4 relative, the first
                step's gate gradients within 1e-4 of each tensor's max,
                ``remat=True`` bitwise on the card.
  dense-arch  — for each of the three dense archs at full width (f32,
                seeded random weights; G 3 at hd 64 and 128, G 4, the
                untied head of phi3-medium-14b, 54.6 GiB): ``launch.serve``
                (depth cut to ``SERVE_REPEATS`` 4 layers; 2 x 64-token
                prompts, 8 new, 2 slots, capacity 512, the tau probe; the
                pool within 2e-3), ``inference.prefill`` of
                4,096 tokens at budget 1,024 and 16 greedy steps, then the
                reduced config (smollm-360m's G 3 at hd 80) on card and
                CPU: the gated forward and the greedy streams, integer
                cache state exact, logits within 1e-4.
  smollm-train — ``repro_torch.launch.train --arch smollm-360m --steps 2
                --batch 2 --seq 2048``: ``gated_flash_bwd`` at G 3.

The MoE archs (``attn_moe`` blocks: the write-gated attention and a
Mixture-of-Experts FFN; run after smollm-train, one model at a time):

  moe-reduced — granite-moe-3b-a800m's and qwen3-moe-235b-a22b's reduced
                configs (4 experts, top 2) through ``dense_reduced`` on
                card and CPU: tokens and integer cache state equal, logits
                and the forward within 1e-4; every routing's top-k
                boundary clears 1e-6 and twice the card's largest
                probability difference from the CPU; a second card run
                bitwise the first.
  moe-serve   — ``launch.serve --arch granite-moe-3b-a800m`` at full
                width (depth cut to 8 of 32 layers; d_model 1536, 24 / 8
                heads of hd 64, 40 experts of d_ff 512, top 8): 4 x 64
                tokens, 8 new, 2 slots, the tau probe and
                ``verify_paged``; TTFT, TPOT and launches.
  moe-prefill — at full depth (32 layers, 12.3 GiB in f32): prefill of
                4,096 tokens at budget 1,024 + 16 greedy
                steps, and a warm repeat of the prefill.
  moe-forward — its gated forward over 2,048 tokens; then one layer's MoE
                FFN over 4,096 tokens twice, bitwise equal.
  moe-train   — ``launch.train --arch granite-moe-3b-a800m --steps 2
                --batch 2 --seq 2048``: step time, peak memory, 32
                launches per step of each of ``gated_flash``,
                ``gated_flash_bwd``, ``gate_mlp`` and ``gate_mlp_bwd``.
  qwen3moe-d4 — qwen3-moe-235b-a22b at full width with its depth cut from
                94 repeats to 4 (``cfg.replace(n_repeats=4)``; d_model
                4096, 64 / 4 heads of hd 128: a GQA group of 16, 128
                experts of d_ff 1536, untied vocab 151,936; 41.7 GiB in
                f32): ``launch.serve`` of 2 x 64 tokens, prefill of 4,096
                tokens at budget 1,024 + 16 steps, one layer's MoE FFN
                twice, bitwise; peak memory of each.

The xLSTM, encoder-decoder and VLM archs (run after qwen3moe-d4, one
model at a time):

  new-archs-reduced — xlstm-350m's, whisper-medium's and qwen2-vl-7b's
                reduced configs (f32, gates clustered clear of tau) on
                card and CPU: prefill (xlstm 128 tokens; whisper a
                32-token prompt over 64 frames, its cross memory budgeted
                to 16 of 32; qwen2-vl a 4 x 4 grid's patches and text
                through ``build_vlm_embeds``, M-RoPE) + 8 greedy steps:
                tokens, integer cache leaves and every selection's indices
                equal, logits within 1e-4.
  xlstm       — xlstm-350m at full width, depth cut to 4 of 24 blocks
                (d_model 1,024): prefill of 2,048 tokens (chunkwise
                mLSTM) + 16 steps, a teacher forward over 2,048 tokens,
                one layer of each block type timed alone, one
                ``lm_train_step`` at 1 x 1,024; no kernel launches.
  whisper     — whisper-medium at full width and depth (24 + 24 layers,
                2.8 GiB): ``whisper_frame_embeds`` of 3,000 frames (1,500
                encoder positions), a 384-token prompt at budget 96 (each
                cross memory keeps 96 of 1,500 keys) + 16 steps, the gated
                forward, 2 ``train_step``s at 2 x 384 with ``enc_embeds``.
  qwen2vl     — qwen2-vl-7b at full width and depth (28 layers, 28 / 4
                heads of hd 128, 28.4 GiB): ``launch.serve`` (depth cut
                to 4 layers; text, 2 x 64 tokens, 8 new), prefill of 4,096
                tokens at budget 1,024 +
                16 steps, and the gated forward of a 2,048-slot stream
                whose first 1,024 slots are a 32 x 32 grid's patches,
                roped by M-RoPE.

The roofline (after forward-gated, and after rg-forward for the hybrid):
prefill-long's prefill (qwen3-0.6b, 1 x 4,096 tokens drawn from seed 0,
budget 1,024), one of its decode steps (on the caches that prefill
returned: t 4,096, the global cache at its budget), the train phase's
step (2 x 2,048; no
remat, no query chunks, as ``launch.train``) and rg-prefill's prefill
(recurrentgemma-9b, 1 x 4,096), each as a dry-run bundle
(``repro_torch.launch.dryrun``) run on the meta device and on the card
under the work counter (``repro_torch.roofline.counter``): the two counts
equal as integers (FLOPs by rate class, bytes, each kernel's launches,
FLOPs and bytes), the card's launches equal to the launch counters' and
to the path's (28 ``gate_mlp`` and 28 ``vertical_slash``; 28 ``gate_mlp``
and 28 ``paged_decode``; 28 each of ``gated_flash``, ``gated_flash_bwd``,
``gate_mlp``, ``gate_mlp_bwd``; 12 ``gate_mlp``, 12 ``vertical_slash``, 26
``rglru_scan``). Each prints its compute and memory terms and the bound
from this run's data (``vertical_slash``'s visible globals and
``paged_decode``'s valid tokens recorded in the timed run; the bound from
shapes alone, which counts every slot valid, beside it), the
bundle's wall and device time (torch.profiler) over the bound, the model
FLOPs over the wall at 67 and 989 TFLOP/s, the predicted peak beside
``torch.cuda.max_memory_allocated()`` and the card's total memory, and the
counted split by kernel and by aten class. The sentinels phase serves
its mix with the counter active (sync debug mode "error" must see no
sync; the counted launches equal the counters').
Phase 3's bounds come from the same work functions
(``repro_torch.roofline.work``) with the exact counts each case holds.

The figures (after the qwen3 roofline): fig8 — Fig. 8's method
(``repro_torch.benchmarks.bench_fig8_efficiency.measure``) on
prefill-long's full-width model at S 1,024, 2,048 and 4,096, budget S /
4: the WG-KV prefill and decode step against the dense ones (each timed
row's launches per call one per layer of exactly its kernels:
``gate_mlp`` + ``vertical_slash``, ``gate_mlp`` + ``paged_decode``,
``gated_flash`` (causal), ``paged_decode``) and both caches' bytes,
each of these kernels held against its plain version at these shapes in
phase 3 (``figure_cases``); then figures —
``repro_torch.benchmarks.run`` over every module on the card (no
``_error`` row; the serving record into a temp dir), fig7's rows and fig13's per-head admission on the
card equal to the CPU's on host-drawn batches, and the four examples
(``repro_torch.examples``; serve_longcontext's pool drains and verifies
within 2e-3). The kernels line gives each kernel's ``launches_figures``.

Phase 3 also holds the dense baseline's windowed modes against their
plain versions, f32 and bf16: ``gated_flash``'s hard window at
recurrentgemma-9b's prefill (16 / 1 at hd 256, S 4096, W 2048) and a
qwen3 shape (16 / 8 at hd 128, S 2048, W 256), W = S bitwise the causal
form; ``paged_decode`` from a start offset at the hybrid's dense decode
(G 16 at hd 256, t 4,104 in a 4,160-token buffer, W 2048) and three
ragged rows whose starts are not page-aligned, starts of 0 over the
buffer bitwise the read without starts; each mode also rebuilt with its
fault of ``MODE_FAULTS`` planted (window ignored, start ignored), which
must read above 5e-5.

Phase 3 also holds the four forward kernels at qwen2-vl-7b's G 7 (28 / 4
at hd 128) and whisper-medium's 16 / 16 at hd 64 (W 64, S 384, C 96), the
gate over whisper's 1,500 cross keys, and the two backward kernels at its
train shape (2 x 384, F 128), each with a planted fault
(``new_arch_cases``).

Phase 3 holds ``paged_decode`` (C 128 and C 1024, W 256), the gate
(decode and a 4,096-token prefill), ``vertical_slash`` (S 4096) and
``gated_flash`` (S 32 and 2048) at both MoE archs' heads (24 / 8 at hd
64, 64 / 4 at hd 128), and rebuilds each with a fault of ``FWD_FAULTS``
planted (a query row reading the wrong head, a CTA the wrong kv stream,
the gate the wrong head's weights) that must read above 5e-5.

Phase 3 also holds the three backward kernels against their plain
versions and against autograd of the forward's plain version (1e-4 of
each gradient's largest magnitude), at the train phases' shapes
(recurrentgemma-9b's hd 256 and F 512 and the scan at [1, 4096, 4096]
included) and the substrate's, two calls bitwise equal, and each fault of
``BWD_FAULTS`` planted alone in a rebuild that must read above that
limit. It also holds the dense read (one ``paged_decode`` segment over a
contiguous buffer) and the causal ``gated_flash`` at those paths' shapes
against their plain versions, and ``paged_decode``, ``gate_mlp``,
``vertical_slash`` and ``gated_flash`` at the dense archs' groups of 3
and 4.

Each full-width model (32 GiB for recurrentgemma-9b in f32, 54.6 GiB for
phi3-medium-14b, 41.7 GiB for qwen3-moe-235b-a22b at 4 repeats, 28.4 GiB
for qwen2-vl-7b) is freed before the next is built. The full-width
weights are random (seeded);
the point is that the port runs end to end on the card through its
kernels and agrees with itself: the paged physical pool matches the
logical cache (< 2e-3), every request
completes, every logit is finite, and on trained weights the card and the
CPU agree. The launch counts of each main path are set to 0 just before
it and read just after. Any failed check raises, and the script exits
non-zero. The last two lines are the ``kernels`` JSON and the ``ok`` JSON.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

INT32_MAX = 2 ** 31 - 1
# max abs error of an attention kernel against its plain version: both
# compute in f32 in different orders; in bf16 both round the output, so
# they may differ by an ulp of an output (2**-9 under 0.5). A pair of
# elements swapped or dropped in the bf16 load reads far above 1e-2
# (tests/test_torch_cuda.py plants both).
TOL = {"float32": 5e-5, "bfloat16": 1e-2}
# the depth of serve-long's model and of the other archs' serve paths
# (smollm-360m, phi4-mini-3.8b, phi3-medium-14b, granite-moe-3b-a800m,
# qwen2-vl-7b; full width): the serving tick is host-bound, a Python step
# per layer and position, so their full depth cost minutes of the
# script's time limit for no other check. Their prefill, forward and
# train paths keep their full depth.
SERVE_REPEATS = 4
# the dense archs' heads: (q heads, kv heads, head_dim)
DENSE_HEADS = {"smollm-360m": (15, 5, 64), "phi4-mini-3.8b": (24, 8, 128),
               "phi3-medium-14b": (40, 10, 128)}
# the MoE archs' heads: granite's G 3 at hd 64, qwen3-moe's G 16 at hd 128
MOE_HEADS = {"granite-moe-3b-a800m": (24, 8, 64),
             "qwen3-moe-235b-a22b": (64, 4, 128)}
# qwen2-vl-7b's G 7 at hd 128 (128 % 7 != 0: vertical_slash's unfolded
# path) and whisper-medium's decoder, 16 / 16 heads of hd 64 with a 64-token
# ring, its 384-token prompt at budget 96 and 1,500 encoder keys
NEW_HEADS = {"qwen2-vl-7b": (28, 4, 128), "whisper-medium": (16, 16, 64)}
WHISPER_S, WHISPER_W, WHISPER_C, WHISPER_ENC = 384, 64, 96, 1500


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int) -> float | None:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's dispatch of each call (Python, checks, the
    launch itself) is not in the time that ``cuda_ms`` reads. None, with
    the reason printed, if the calls cannot be captured."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(stop) / (5 * iters)
    except RuntimeError as exc:  # capture refused: report, do not fail
        print(f"graph_ms: capture failed: {str(exc)[:200]}")
        return None


def kernel_us(fn, iters: int = 20) -> dict:
    """Device microseconds per call of each CUDA kernel ``fn`` launches
    (torch.profiler over ``iters`` calls), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + e.device_time_total / iters
    return out


def bound(work, rate: str | None = None):
    """(ms, "bytes" or "operations"): the least time the card takes for a
    kernel call's work (``repro_torch.roofline.work``): the larger of its
    bytes over the HBM rate and its FLOPs over the peak of its rate class
    (or of ``rate``; the H100's rates are ``roofline.analysis``')."""
    from repro_torch.roofline.analysis import HBM_BYTES_PER_S, RATES
    t_bytes = work.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.flops / RATES[rate or work.rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_label(work) -> str:
    from repro_torch.roofline.analysis import RATE_LABELS
    return RATE_LABELS[work.rate]


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def gate_case(rows: int, s: int, seed: int, h: int = 8, f: int = 256,
              runs: list | None = None):
    """The write gate over ``rows`` (batch x kv heads) of ``s`` tokens with
    ``f`` = 2 x head_dim features: qwen3-0.6b's h 8, f 256 by default,
    recurrentgemma-9b's h 1, f 512. ``runs``: gets (the kernel's call on
    these inputs, the plain version's output), for a planted fault."""
    import torch
    from repro_torch.kernels.gate_mlp import gate_mlp, gate_mlp_plain, plan
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = 64

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = rn(rows, s, f)
    w1, b1 = rn(h, f, m, scale=f ** -0.5), rn(h, m, scale=0.1)
    w2, b2 = rn(h, m, 1, scale=m ** -0.5), rn(h, 1)
    args = (x, w1, b1, w2, b2)
    got = gate_mlp(*args)
    again = gate_mlp(*args)
    want = gate_mlp_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()),
          f"gate_mlp [{rows},{s},{f}]: non-finite output")
    check(err <= 1e-5, f"gate_mlp [{rows},{s},{f}] err {err:.3e} > 1e-5")
    check(torch.equal(got, again), f"gate_mlp [{rows},{s},{f}]: two calls "
          "differ")
    if runs is not None:
        runs.append((lambda: gate_mlp(*args), want))
    iters = 200 if s == 1 else 20
    ms = cuda_ms(lambda: gate_mlp(*args), iters)
    # at S 1 the events time is the host's dispatch; the device time is
    # the same calls replayed from a CUDA graph
    device_ms = graph_ms(lambda: gate_mlp(*args), 50 if s == 1 else iters)
    plain_ms = cuda_ms(lambda: gate_mlp_plain(*args), iters)
    # the bound at the rate of the kernel's arithmetic: the decode path
    # (tile 0) multiplies in f32 on the CUDA cores, the tensor-core path
    # in 3xTF32; and at the CUDA cores' rate, the bound of the first kernel
    tile = plan(rows, s, h)
    work = W.gate_mlp(rows, s, f, m, h, tile)
    b_ms, b_by = bound(work)
    cc_ms, _ = bound(work, "f32")
    return {"shape": f"x[{rows},{s},{f}] H={h} M={m}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_rate": rate_label(work),
            "bound_ms_cuda_cores": cc_ms, "library_ms": None,
            "device_ms": device_ms, "tile": tile, "two_calls_bitwise": True}


def dual_cache_case(slots: int, c: int, w: int, dtype, seed: int,
                    hkv: int = 8, grp: int = 2, hd: int = 128,
                    runs: list | None = None):
    """Two segments (global C, ring W) of a random dual cache with ragged
    gcnt (0, partial page, full, ...) and rows before and after the ring
    wraps, read by the kernel and by its plain version. qwen3-0.6b's heads
    by default (8 kv heads, group 2, hd 128); recurrentgemma-9b's are 1 kv
    head, group 16, hd 256; the dense archs' 5 / 3 at hd 64, 8 / 3 and
    10 / 4 at hd 128."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=dtype,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    pattern = torch.tensor([0, 7, c, c // 2 + 3, 1, c - 1, 16, 33],
                           dtype=torch.int32, device="cuda")
    pattern = pattern.repeat(-(-hkv // 8))  # phi3-medium-14b's 10 kv heads
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([(w // 2 + 37 * i) if i % 2 == 0 else (w + 101 * i)
                      for i in range(slots)], dtype=torch.int32, device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    qf, first, second, grp = ops.dual_cache_segments(q, cache)
    got = paged_decode(qf, *first, second=second, group=grp)
    want = paged_decode_plain(qf, *first, second=second, group=grp)
    again = paged_decode(qf, *first, second=second, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["float32" if dtype == torch.float32 else "bfloat16"]
    check(err <= tol, f"paged_decode {dtype} slots={slots} C={c} W={w} "
          f"err {err:.3e} > {tol}")
    check(torch.equal(got, again), f"paged_decode {dtype} slots={slots} "
          f"C={c} W={w}: two calls differ")
    if runs is not None:
        runs.append((lambda: paged_decode(qf, *first, second=second,
                                          group=grp), want))
    ms = cuda_ms(lambda: paged_decode(qf, *first, second=second, group=grp),
                 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(qf, *first, second=second,
                                                  group=grp), 50)
    # library yardstick: SDPA over the pre-concatenated [global | ring]
    # K/V with a validity mask (times the attention call only)
    k = torch.cat([cache.gk, cache.lk], dim=2)
    v = torch.cat([cache.gv, cache.lv], dim=2)
    pos = torch.arange(c + w, device="cuda")
    valid = torch.where(pos[None, None] < c, pos[None, None] < gcnt[..., None],
                        (pos[None, None] - c) < torch.clamp(t, max=w)[:, None, None])
    qg = q.reshape(slots, hkv, grp, hd)
    mask = valid[:, :, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, k, v, attn_mask=mask), 200)
    device_ms = graph_ms(lambda: paged_decode(qf, *first, second=second,
                                              group=grp), 50)
    split_us = kernel_us(lambda: paged_decode(qf, *first, second=second,
                                              group=grp))
    library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qg, k, v, attn_mask=mask), 50)
    # the bound: each valid K/V token read once per kv stream, q and the
    # output once, page tables and lengths once
    toks = int(gcnt.sum()) + int(torch.clamp(t, max=w).sum()) * hkv
    isz = torch.tensor([], dtype=dtype).element_size()
    b_ms, b_by = bound(W.paged_decode(qf.shape[0], hd, grp, first[2].shape[1],
                                      second[2].shape[1], isz=isz,
                                      tokens=toks))
    plan = split_plan_of(qf, first, second, grp)
    return {"shape": f"N={slots * hkv * grp} hd={hd} C={c} W={w} {dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "split_plan": plan, "kernel_us": split_us}


def dense_case(slots: int, max_len: int, t: list, dtype, seed: int,
               hkv: int = 8, grp: int = 2, hd: int = 128):
    """The dense baseline's decode read (``ops.dense_cache_attention``):
    ONE ``paged_decode`` segment over a contiguous dense buffer of
    ``max_len`` (rounded up to a page), each row ``t`` long; qwen3-0.6b's
    heads. The library's: SDPA over the same buffer with a length
    mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.models.attention import init_dense_cache
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_dense_cache(slots, hkv, hd, max_len, dtype, "cuda")
    s_max = cache.k.shape[2]

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    tt = torch.tensor(t, dtype=torch.int32, device="cuda")
    cache = cache._replace(k=rn(slots, hkv, s_max, hd),
                           v=rn(slots, hkv, s_max, hd), t=tt)
    q = rn(slots, hkv * grp, hd)
    qf, seg, grp = ops.dense_cache_segment(q, cache)
    got = paged_decode(qf, *seg, group=grp)
    want = paged_decode_plain(qf, *seg, group=grp)
    again = paged_decode(qf, *seg, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["float32" if dtype == torch.float32 else "bfloat16"]
    check(err <= tol, f"dense read {dtype} S_max={s_max} t={t} err "
          f"{err:.3e} > {tol}")
    check(torch.equal(got, again), f"dense read {dtype}: two calls differ")
    ms = cuda_ms(lambda: paged_decode(qf, *seg, group=grp), 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(qf, *seg, group=grp), 20)
    device_ms = graph_ms(lambda: paged_decode(qf, *seg, group=grp), 50)
    qg = q.reshape(slots, hkv, grp, hd)
    mask = (torch.arange(s_max, device="cuda")[None, None, None]
            < tt[:, None, None, None])
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, cache.k, cache.v, attn_mask=mask), 200)
    toks = sum(t) * hkv
    isz = torch.tensor([], dtype=dtype).element_size()
    b_ms, b_by = bound(W.paged_decode(qf.shape[0], hd, grp, seg[2].shape[1],
                                      isz=isz, tokens=toks))
    return {"shape": f"N={slots * hkv * grp} hd={hd} S_max={s_max} t={t} "
                     f"{dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_ms": device_ms,
            "split_plan": split_plan_of(qf, seg, None, grp)}


def selected_case(slots: int, c: int, w: int, k: int, dtype, seed: int,
                  hkv: int = 8, grp: int = 2, hd: int = 128):
    """The dual-cache read with Quest selection: a random dual cache with
    ragged gcnt, its page metadata rebuilt, and the top-K page ids of a
    random query (``selection.topk_page_ids``, the decode path's scorer);
    the global segment read through the ids, the ring whole. Also checks
    that the identity ids with K covering every page give exactly
    ``paged_decode``'s output. qwen3-0.6b's heads by default; the bench
    substrate's are 2 kv heads, group 2, hd 32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import selection as SEL
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_selected,
                                                  paged_decode_selected_plain)
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    page = 16
    p_all = c // page
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=dtype,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    pattern = torch.tensor([c, 7, c // 2 + 3, 0, c - 1, 16, 33, 5 * page],
                           dtype=torch.int32, device="cuda")
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([w + 101 * i for i in range(slots)], dtype=torch.int32,
                     device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    valid = torch.arange(c, device="cuda")[None, None] < gcnt[..., None]
    meta = SEL.build_page_meta(cache.gk, valid)
    meta = SEL.PageMeta(meta.kmin, meta.kmax,
                        SEL.page_valid_from_count(gcnt, p_all))
    ids, n_sel = SEL.topk_page_ids(q, meta, k)
    qf, first, second, grp = ops.dual_cache_segments(q, cache)
    sel = ids.reshape(slots * hkv, k).contiguous()
    nsf = n_sel.reshape(-1).contiguous()
    got = paged_decode_selected(qf, *first, sel, nsf, second=second,
                                group=grp)
    want = paged_decode_selected_plain(qf, *first, sel, nsf, second=second,
                                       group=grp)
    # the identity ids at K = every page, as topk_page_ids gives them
    all_ids, n_all = SEL.topk_page_ids(q, meta, p_all)
    sel_all = all_ids.reshape(slots * hkv, p_all).contiguous()
    n_allf = n_all.reshape(-1).contiguous()
    ident = paged_decode_selected(qf, *first, sel_all, n_allf, second=second,
                                  group=grp)
    full = paged_decode(qf, *first, second=second, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["float32" if dtype == torch.float32 else "bfloat16"]
    tag = f"paged_decode_selected {dtype} slots={slots} C={c} W={w} K={k}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite")
    check(err <= tol, f"{tag} err {err:.3e} > {tol}")
    check(torch.equal(ident, full), f"{tag}: identity ids differ from "
          f"paged_decode by {float((ident - full).abs().max()):.3e}")
    ms = cuda_ms(lambda: paged_decode_selected(qf, *first, sel, nsf,
                                               second=second, group=grp), 200)
    full_ms = cuda_ms(lambda: paged_decode(qf, *first, second=second,
                                           group=grp), 200)
    plain_ms = cuda_ms(lambda: paged_decode_selected_plain(
        qf, *first, sel, nsf, second=second, group=grp), 50)
    # library yardstick: SDPA over the K gathered pages and the ring, with
    # the validity mask (the gather is outside the timed call)
    gk, gv, gvalid = SEL.gather_pages(cache.gk, cache.gv, gcnt, ids)
    gvalid = gvalid & (
        torch.arange(k, device="cuda").repeat_interleave(page)[None, None]
        < n_sel[..., None])
    kk = torch.cat([gk, cache.lk], dim=2)
    vv = torch.cat([gv, cache.lv], dim=2)
    lvalid = (torch.arange(w, device="cuda")[None, None]
              < torch.clamp(t, max=w)[:, None, None]).expand(slots, hkv, w)
    mask = torch.cat([gvalid, lvalid], dim=2)[:, :, None, :]
    qg = q.reshape(slots, hkv, grp, hd)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, kk, vv, attn_mask=mask), 200)
    device_ms = graph_ms(lambda: paged_decode_selected(
        qf, *first, sel, nsf, second=second, group=grp), 50)
    library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qg, kk, vv, attn_mask=mask), 50)
    # the bound: the valid tokens of the selected pages and of the ring,
    # K and V once per kv stream; q, the output, the ids, their counts,
    # the table entries they select and the lengths once
    toks = int(gvalid.sum()) + int(lvalid.sum())
    n = qf.shape[0]
    b_ms, b_by = bound(W.paged_decode_selected(
        n, hd, grp, k, second[2].shape[1], isz=q.element_size(),
        tokens=toks))
    return {"shape": f"N={n} hd={hd} C={c} ({p_all} pages) K={k} W={w} "
                     f"{dtype}",
            "max_abs_err": err, "ms": ms, "full_read_ms": full_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms, "tokens_read": toks,
            "identity_bitwise": True}


def vertical_slash_case(dtype: str, seed: int, hkv: int = 8, hd: int = 128,
                        w: int = 256, hq: int = 16,
                        runs: list | None = None, s: int = 4096,
                        c: int = 1024):
    """The prefill path's shape: B = 1, S = 4096, C 1024 globals chosen by
    ``select_global`` from random gates (sinks, then the highest; unused
    slots at INT32_MAX). qwen3-0.6b's 16 q on 8 kv heads, hd 128, W 256 by
    default; recurrentgemma-9b's 16 on 1 kv head, hd 256, W 2048; the
    dense archs' odd groups (smollm-360m 15 / 5 at hd 64, phi4-mini-3.8b 24
    / 8 and phi3-medium-14b 40 / 10 at hd 128); ``s`` and ``c``: another
    prompt length and budget (whisper-medium's S 384, C 96)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.admission import select_global
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.vertical_slash import (vertical_slash,
                                                    vertical_slash_plain)
    from repro_torch.roofline import work as W
    grp = hq // hkv
    dt = torch_dtype(dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q, k, v = rn(hq, s, hd), rn(hkv, s, hd), rn(hkv, s, hd)
    gates = torch.rand((1, hkv, s), generator=gen, device="cuda")
    sel = select_global(gates, budget=c, tau=0.1, sink=16,
                        exclude_from=s - w)
    idx = sel.idx[0].long()                                    # [hkv, C]
    rows = torch.arange(hkv, device="cuda")[:, None]
    kg, vg = k[rows, idx].contiguous(), v[rows, idx].contiguous()
    gpos = torch.where(sel.valid[0], sel.idx[0],
                       torch.full_like(sel.idx[0], INT32_MAX)).contiguous()
    args = (q, k, v, kg, vg, gpos)
    got = vertical_slash(*args, w_local=w, group=grp)
    again = vertical_slash(*args, w_local=w, group=grp)
    want = vertical_slash_plain(*args, w_local=w, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tag = f"vertical_slash {hq}/{hkv} hd={hd} {dtype}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite "
          "output")
    check(err <= TOL[dtype], f"{tag} err {err:.3e} > {TOL[dtype]}")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    if runs is not None:
        runs.append((lambda: vertical_slash(*args, w_local=w, group=grp),
                     want))
    ms = cuda_ms(lambda: vertical_slash(*args, w_local=w, group=grp), 10)
    device_ms = graph_ms(lambda: vertical_slash(*args, w_local=w,
                                                group=grp), 10)
    plain_ms = cuda_ms(lambda: vertical_slash_plain(*args, w_local=w,
                                                    group=grp), 3, warmup=1)
    # library yardstick: one SDPA call over [K ‖ Kg] with the same boolean
    # visibility (K/V repeated over the group and the mask built outside
    # the timed call)
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    local = (qi >= kj) & (qi - kj < w)                         # [S, S]
    vis = gpos[:, None, :].long() <= (qi[None] - w)            # [hkv, S, C]
    mask = torch.cat([local[None].expand(hkv, s, s), vis], dim=-1)
    mask = mask.repeat_interleave(grp, dim=0)[None]
    kk = torch.cat([k, kg], dim=1).repeat_interleave(grp, dim=0)[None]
    vv = torch.cat([v, vg], dim=1).repeat_interleave(grp, dim=0)[None]
    q4 = q[None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask), 5, warmup=1)
    del mask, kk, vv
    # the bound: every visible (query, key) pair once (the globals each
    # query past their window sees, from this call's positions)
    gp = gpos.long()
    glob_keys = int(torch.where(gp < INT32_MAX,
                                torch.clamp(s - (gp + w), min=0),
                                torch.zeros_like(gp)).sum())
    work = W.vertical_slash(hq, s, hd, grp, kg.shape[1], w,
                            q.element_size(), global_pairs=glob_keys)
    visible = work.flops // (4 * hd)
    # the bound at the rate of the kernel's arithmetic (as gated_flash's),
    # and for f32 also at the CUDA cores' rate
    b_ms, b_by = bound(work)
    cc_ms, _ = bound(work, "f32")
    return {"shape": f"q[{hq},{s},{hd}] kv[{hkv},{s},{hd}] C={c} W={w} "
                     f"group={grp} {dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_rate": rate_label(work),
            "bound_ms_cuda_cores": cc_ms if dtype == "float32" else None,
            "library_ms": library_ms, "device_ms": device_ms,
            "two_calls_bitwise": True, "visible_pairs": visible,
            "global_valid": int(sel.count.sum())}


def gated_flash_case(s: int, dtype: str, seed: int, hkv: int = 8,
                     hd: int = 128, w: int = 256, causal: bool = False,
                     hq: int = 16, runs: list | None = None):
    """The gated forward's shape: the forward phase's S = 2048 or the tau
    probe's S = 32, with qwen3-0.6b's 16 q on 8 kv heads, hd 128, W 256 by
    default; recurrentgemma-9b's 16 on 1 kv head, hd 256, W 2048 at S =
    4096; the dense archs' odd groups (15 / 5 at hd 64, 24 / 8 and 40 / 10
    at hd 128). ``causal``: the dense baseline's prefill form
    (``ops.causal_attention``): g = 1 and W = S, held against the same
    plain version, with one causal SDPA call as the library's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.gated_flash import gated_flash, gated_flash_plain
    from repro_torch.roofline import work as W
    eps = 1e-6
    grp = hq // hkv
    dt = torch_dtype(dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q, k, v = rn(hq, s, hd), rn(hkv, s, hd), rn(hkv, s, hd)
    g = torch.rand((hkv, s), generator=gen, device="cuda")
    if causal:
        g, w = torch.ones_like(g), s
    args = (q, k, v, g)
    got = gated_flash(*args, w_local=w, eps=eps, group=grp)
    again = gated_flash(*args, w_local=w, eps=eps, group=grp)
    want = gated_flash_plain(*args, w_local=w, eps=eps, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tag = f"gated_flash {hq}/{hkv} hd={hd} S={s} {dtype}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite "
          "output")
    check(err <= TOL[dtype], f"{tag} err {err:.3e} > {TOL[dtype]}")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    if runs is not None:
        runs.append((lambda: gated_flash(*args, w_local=w, eps=eps,
                                         group=grp), want))
    iters = 200 if s <= 64 else (10 if s <= 2048 else 4)
    ms = cuda_ms(lambda: gated_flash(*args, w_local=w, eps=eps, group=grp),
                 iters)
    plain_ms = cuda_ms(lambda: gated_flash_plain(*args, w_local=w, eps=eps,
                                                 group=grp),
                       max(iters // 4, 3), warmup=1)
    # library yardstick: one SDPA call with the additive float bias
    # (0 in the window, log(g + eps) outside, -1e30 above the diagonal)
    # (the causal form: SDPA's own is_causal, no bias tensor)
    bias = None
    if not causal:
        qi = torch.arange(s, device="cuda")[:, None]
        kj = torch.arange(s, device="cuda")[None, :]
        below, in_win = qi >= kj, (qi >= kj) & (qi - kj < w)
        logg = torch.log(g + eps)[:, None, :]                  # [hkv, 1, S]
        bias = torch.where(below, torch.where(in_win, torch.zeros_like(logg),
                                              logg),
                           torch.full_like(logg, -1e30))
        bias = bias.repeat_interleave(grp, dim=0)[None].to(dt)
    kk = k.repeat_interleave(grp, dim=0)[None]
    vv = v.repeat_interleave(grp, dim=0)[None]
    q4 = q[None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=bias, is_causal=causal), iters, warmup=1)
    device_ms = graph_ms(lambda: gated_flash(*args, w_local=w, eps=eps,
                                             group=grp),
                         50 if s <= 64 else iters)
    library_device_ms = None
    if s <= 64:  # the probe: launch-bound, so also the library's
        library_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=bias), 50)
    del bias, kk, vv
    work = W.gated_flash(hq, s, hd, grp, q.element_size())
    # the bound at the rate of the kernel's arithmetic, and for f32 also at
    # the CUDA cores' rate, the bound earlier versions were held to
    b_ms, b_by = bound(work)
    cc_ms, _ = bound(work, "f32")
    return {"shape": f"q[{hq},{s},{hd}] kv[{hkv},{s},{hd}] W={w} "
                     f"group={grp} {dtype}" + (" g=1" if causal else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_rate": rate_label(work),
            "bound_ms_cuda_cores": cc_ms if dtype == "float32" else None,
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms,
            "two_calls_bitwise": True}


def window_flash_case(s: int, dtype: str, seed: int, hkv: int, hd: int,
                      hq: int, w: int, runs: list | None = None):
    """``gated_flash``'s hard-window mode (the dense baseline's windowed
    prefill, ``ops.windowed_causal_attention``) against its plain version
    (the reference's windowed mask): within TOL, two calls bitwise, and
    at W = S bitwise equal to the causal form (``gated_flash`` with g = 1,
    W = S). Timed with events and a graph replay beside its plain
    version and one SDPA call with a boolean window mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.gated_flash import (gated_flash,
                                                 gated_flash_window,
                                                 gated_flash_window_plain)
    from repro_torch.roofline import work as W
    grp = hq // hkv
    dt = torch_dtype(dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q, k, v = rn(hq, s, hd), rn(hkv, s, hd), rn(hkv, s, hd)

    def call(win=w):
        return gated_flash_window(q, k, v, window=win, group=grp)
    got, again = call(), call()
    want = gated_flash_window_plain(q, k, v, window=w, group=grp)
    causal = gated_flash(q, k, v, torch.ones((hkv, s), device="cuda"),
                         w_local=s, group=grp)
    full = call(s)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tag = f"gated_flash window {hq}/{hkv} hd={hd} S={s} W={w} {dtype}"
    check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite")
    check(err <= TOL[dtype], f"{tag} err {err:.3e} > {TOL[dtype]}")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    check(torch.equal(full, causal), f"{tag}: W = S differs from the "
          "causal form")
    if runs is not None:
        runs.append((call, want))
    iters = 10 if s <= 2048 else 4
    ms = cuda_ms(call, iters)
    plain_ms = cuda_ms(lambda: gated_flash_window_plain(
        q, k, v, window=w, group=grp), max(iters // 4, 3), warmup=1)
    device_ms = graph_ms(call, iters)
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    mask = (qi >= kj) & (qi - kj < w)
    kk = k.repeat_interleave(grp, dim=0)[None]
    vv = v.repeat_interleave(grp, dim=0)[None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], kk, vv, attn_mask=mask), iters, warmup=1)
    del kk, vv, mask
    work = W.gated_flash_window(hq, s, hd, grp, w, q.element_size())
    b_ms, b_by = bound(work)
    return {"shape": f"q[{hq},{s},{hd}] kv[{hkv},{s},{hd}] W={w} "
                     f"group={grp} {dtype} hard window",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_rate": rate_label(work), "library_ms": library_ms,
            "library": "SDPA, boolean window mask", "device_ms": device_ms,
            "two_calls_bitwise": True, "w_eq_s_bitwise_causal": True}


def start_decode_case(slots: int, max_len: int, t: list, w: int, dtype,
                      seed: int, hkv: int = 1, grp: int = 16, hd: int = 256,
                      runs: list | None = None):
    """``paged_decode`` from a start offset (the dense baseline's windowed
    decode read, ``ops.dense_cache_attention(window=)``): each row reads
    [t - W, t) of a dense buffer of ``max_len``, against its plain
    version; two calls bitwise; starts of 0 with a span over the whole
    buffer bitwise equal to the read without starts. Timed beside SDPA
    over the buffer with a boolean window mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import (paged_decode,
                                                  paged_decode_plain)
    from repro_torch.models.attention import init_dense_cache
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_dense_cache(slots, hkv, hd, max_len, dtype, "cuda")
    s_max = cache.k.shape[2]

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    tt = torch.tensor(t, dtype=torch.int32, device="cuda")
    cache = cache._replace(k=rn(slots, hkv, s_max, hd),
                           v=rn(slots, hkv, s_max, hd), t=tt)
    q = rn(slots, hkv * grp, hd)
    qf, seg, grp = ops.dense_cache_segment(q, cache)
    starts = ops.dense_window_starts(tt, hkv, w)

    def call():
        return paged_decode(qf, *seg, group=grp, starts=starts, span=w)
    got, again = call(), call()
    want = paged_decode_plain(qf, *seg, group=grp, starts=starts, span=w)
    zero = torch.zeros_like(starts)
    whole = paged_decode(qf, *seg, group=grp, starts=zero, span=s_max)
    old = paged_decode(qf, *seg, group=grp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    name = "float32" if dtype == torch.float32 else "bfloat16"
    tag = f"paged_decode starts {dtype} S_max={s_max} t={t} W={w}"
    check(err <= TOL[name], f"{tag} err {err:.3e} > {TOL[name]}")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    check(torch.equal(whole, old), f"{tag}: starts 0 over the buffer "
          "differs from the read without starts")
    if runs is not None:
        runs.append((call, want))
    ms = cuda_ms(call, 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(
        qf, *seg, group=grp, starts=starts, span=w), 20)
    device_ms = graph_ms(call, 50)
    qg = q.reshape(slots, hkv, grp, hd)
    pos = torch.arange(s_max, device="cuda")[None, None, None]
    tq = tt[:, None, None, None]
    mask = (pos < tq) & (pos >= tq - w)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, cache.k, cache.v, attn_mask=mask), 200)
    toks = sum(min(x, w) for x in t) * hkv
    isz = torch.tensor([], dtype=dtype).element_size()
    b_ms, b_by = bound(W.paged_decode(qf.shape[0], hd, grp, seg[2].shape[1],
                                      isz=isz, tokens=toks, span=w))
    return {"shape": f"N={slots * hkv * grp} hd={hd} S_max={s_max} t={t} "
                     f"W={w} starts={starts.tolist()} {dtype}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library": "SDPA, boolean window mask", "device_ms": device_ms,
            "split_plan": split_plan_of(qf, seg, None, grp, span=w),
            "two_calls_bitwise": True, "starts0_bitwise_plain_read": True}


def split_plan_of(qf, first, second, group: int,
                  span: int | None = None) -> dict:
    """The split plan ``paged_decode`` launched with, for the record."""
    from repro_torch.kernels.paged_decode import walk_plan
    plan = walk_plan(qf, first[2], second, group=group, span=span)
    return {"pages_per_split": plan.pages_per_split,
            "splits": plan.n_splits, "heads_per_cta": plan.heads,
            "ctas": qf.shape[0] // group * plan.n_splits
            * -(-group // plan.heads)}


def rglru_case(b: int, s: int, d: int, with_h0: bool, seed: int):
    """The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t`` on
    ``a = sigmoid(normal)``, ``b = normal``: recurrentgemma-9b's prefill
    shape [1, 4096, 4096] (one prompt, dr = d_model), or a ragged one with
    a carried-in state (folded into ``b[:, 0]`` by the model's
    ``rglru_scan``, then the kernel)."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.models import rglru as RG
    from repro_torch.roofline import work as W
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device="cuda"))
    bb = torch.randn((b, s, d), generator=gen, device="cuda")
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    if with_h0:
        got = RG.rglru_scan(a, bb, h0)
        folded = bb.clone()
        folded[:, 0] = folded[:, 0] + a[:, 0] * h0
        want = rglru_scan_plain(a, folded)
    else:
        got = rglru_scan(a, bb)
        want = rglru_scan_plain(a, bb)
    again = RG.rglru_scan(a, bb, h0) if with_h0 else rglru_scan(a, bb)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tag = f"rglru_scan [{b},{s},{d}]" + (" h0" if with_h0 else "")
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    check(err <= 5e-5, f"{tag} err {err:.3e} > 5e-5")
    check(torch.equal(got, again), f"{tag}: two calls differ")
    ms = cuda_ms(lambda: rglru_scan(a, bb), 20)
    device_ms = graph_ms(lambda: rglru_scan(a, bb), 20)
    plain_ms = cuda_ms(lambda: rglru_scan_plain(a, bb), 2, warmup=1)
    b_ms, b_by = bound(W.rglru_scan(b, s, d))
    return {"shape": f"a,b[{b},{s},{d}] f32" + (" h0" if with_h0 else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": device_ms, "two_calls_bitwise": True}


# the backward kernels' limit: max |kernel - reference| <= 1e-4 x max |ref|
# of each gradient tensor, against the plain backward on the same inputs
# and against torch.autograd of the forward's plain version (elementwise
# limits would trip on dg's 1 / (g + eps) near g = 0)
BWD_REL = 1e-4

# faults planted in copies of the backward sources, each alone in its own
# copy: dg summed inside the window too (in every block that runs the
# per-pair mask, where the diagonal's in-window pairs are; every hd); the
# hd-256 kernels' dP without the other half of hd (the pair exchange);
# dy without its (1 - g) factor; and the RG-LRU scan's hand-off between
# chunks lost. Each must read above BWD_REL
BWD_FAULTS = {
    "gated_flash_bwd": ("if (pr.outside) dgp[h] += pr.ds;",
                        "dgp[h] += pr.ds;"),
    "gated_flash_bwd_hd256": (
        "p[nt][e] += other[((NT + nt) * 4 + e) * 32 + lane];",
        "p[nt][e] *= 2.f;"),
    "gate_mlp_bwd": ("dy[h2] = dgv * gv * (1.f - gv);", "dy[h2] = dgv * gv;"),
    "rglru_scan_bwd": ("carry = __uint_as_float((unsigned)v);",
                       "carry = 0.f * __uint_as_float((unsigned)v);"),
}
# faults planted in copies of the forward sources, each alone, at the MoE
# archs' GQA shapes: each query row of a paged_decode CTA reading its
# first head's query; the prefill attention kernels reading the next kv
# stream's K/V; the gate taking the next head's weights (decode path and
# tensor-core path). Each must read above the f32 limit TOL["float32"]
FWD_FAULTS = {
    "paged_decode": ("q_s[e] = to_f(q[row0 * hd + e]);",
                     "q_s[e] = to_f(q[row0 * hd + e % hd]);"),
    "vertical_slash": ("const int nk = n0 / G;",
                       "const int nk = (n0 / G + 1) % (gridDim.x * F / G);"),
    "gated_flash": ("const int nk = n0 / G;",
                    "const int nk = (n0 / G + 1) % (gridDim.x * F / G);"),
    "gate_mlp_decode": ("W1 = w1 + (size_t)h * F * M;\n  const int f0",
                        "W1 = w1 + (size_t)((h + 1) % H) * F * M;\n"
                        "  const int f0"),
    "gate_mlp_mma": ("const int h = r % H;", "const int h = (r + 1) % H;"),
    # at G 1 (whisper-medium's 16 / 16) a row is its CTA's first head, so
    # the first fault reads right there: the CTA reads the next kv
    # stream's query instead
    "paged_decode_stream": (
        "q_s[e] = to_f(q[row0 * hd + e]);",
        "q_s[e] = to_f(q[((row0 + pl.group) % ((size_t)gridDim.x * "
        "pl.group)) * hd + e]);"),
}
# faults planted in the dense baseline's windowed modes, each alone: the
# hard window ignored in the mask (the keys of a partly visible tile
# below the window are read), and the start offset ignored (the walk
# reads from token 0). Each must read above TOL["float32"]
MODE_FAULTS = {
    "gated_flash_window": ("return (j > i || i - j >= W) ? NEG_INF : s;",
                           "return j > i ? NEG_INF : s;"),
    "paged_decode_starts": ("const int first = max(s.starts[kv], 0);",
                            "const int first = 0 * s.starts[kv];"),
}
FAULTS = {**BWD_FAULTS, **FWD_FAULTS, **MODE_FAULTS}
# the source of a fault whose name is not its source's
FAULT_SOURCES = {"gated_flash_bwd_hd256": "gated_flash_bwd",
                 "gate_mlp_decode": "gate_mlp", "gate_mlp_mma": "gate_mlp",
                 "paged_decode_stream": "paged_decode",
                 "gated_flash_window": "gated_flash",
                 "paged_decode_starts": "paged_decode"}


def _entry_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel entry: the first
    length-prefixed identifier that ends in ``_kernel`` (digits allowed,
    as in ``bwd_kv256_kernel``), then its integer or bool arguments."""
    import re
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start:start + int(m.group(1))]
        if ident.endswith("_kernel") and re.fullmatch(r"\w+", ident):
            t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start + len(ident):])
            args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
            return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_info(name: str) -> dict:
    """Registers, spills and static shared memory of each kernel entry of
    source ``name``, from the build log (nvcc -Xptxas -v) of the library
    that ``build.load`` loads, by entry (``name<template arguments>``)."""
    import re
    from repro_torch.kernels import build
    out, cur = {}, None
    for line in build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _entry_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                out[cur][key] = int(m.group(1))
    return out


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


class Planted:
    """The faults ``names`` (default: all of ``BWD_FAULTS``; any of
    ``FAULTS``), each planted
    alone in its own copy of the sources in a temporary directory and
    built there while the block runs (one nvcc per fault, all at once).
    The build module points at the first fault's copy; ``use(name)``
    points it at another's. ``tests/test_torch_cuda.py`` plants its faults
    through this too."""

    def __init__(self, names=tuple(BWD_FAULTS)):
        self.names = list(names)

    def _point(self, name):
        self.build.CSRC, self.build.BUILD_DIR, self.build._LIBS = \
            self.dirs[name]

    def __enter__(self):
        import shutil
        import tempfile
        from repro_torch.kernels import build
        self.build, self.saved = build, (build.CSRC, build.BUILD_DIR,
                                         build._LIBS)
        self.tmp = Path(tempfile.mkdtemp(prefix="planted-"))
        self.dirs, procs = {}, {}
        for name in self.names:
            src = FAULT_SOURCES.get(name, name)
            old, new = FAULTS[name]
            csrc = self.tmp / name / "csrc"
            shutil.copytree(self.saved[0], csrc)
            path = csrc / f"{src}.cu"
            text = path.read_text()
            check(text.count(old) == 1, f"planted fault: {old!r} not found "
                  f"once in {src}.cu")
            path.write_text(text.replace(old, new))
            self.dirs[name] = (csrc, self.tmp / name / "build", {})
            self._point(name)
            procs[name] = build._start(src)
        for name, proc in procs.items():
            self._point(name)
            build._finish(FAULT_SOURCES.get(name, name), proc)
        self._point(self.names[0])
        return self

    def use(self, name):
        """Point the build module at fault ``name``'s copy."""
        self._point(name)

    def __exit__(self, *exc):
        import shutil
        self.build.CSRC, self.build.BUILD_DIR, self.build._LIBS = self.saved
        shutil.rmtree(self.tmp, ignore_errors=True)
        return False


def gate_bwd_case(rows: int, s: int, seed: int, h: int = 8, f: int = 256,
                  m: int = 64):
    """The write gate's backward at a training shape: qwen3-0.6b's x [B x
    8, 2048, 256] (M 64) by default, the substrate's x [B x 2, 128, 64]
    (M 32). Returns the record and a function that runs the kernel on the
    same inputs (for the planted fault)."""
    import torch
    from repro_torch.kernels.gate_mlp import (gate_mlp_bwd,
                                              gate_mlp_bwd_plain,
                                              gate_mlp_plain)
    from repro_torch.roofline import work as W
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x = rn(rows, s, f)
    w1, b1 = rn(h, f, m, scale=f ** -0.5), rn(h, m, scale=0.1)
    w2, b2 = rn(h, m, 1, scale=m ** -0.5), rn(h, 1)
    dg = rn(rows, s)
    args = (x, w1, b1, w2, b2)
    ins = [t.clone().requires_grad_() for t in args]
    g_auto = gate_mlp_plain(*ins)
    auto = torch.autograd.grad(g_auto, ins, dg)
    g = g_auto.detach()
    run = lambda: gate_mlp_bwd(*args, g, dg)  # noqa: E731
    got, again = run(), run()
    want = gate_mlp_bwd_plain(*args, g, dg)
    torch.cuda.synchronize()
    tag = f"gate_mlp_bwd x[{rows},{s},{f}] M={m}"
    names = ("dx", "dw1", "db1", "dw2", "db2")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    errs_auto = {n: rel_err(a, b) for n, a, b in zip(names, got, auto)}
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{tag}: non-finite gradient")
    check(max(errs.values()) <= BWD_REL and max(errs_auto.values()) <= BWD_REL,
          f"{tag}: errors {errs} / autograd {errs_auto} > {BWD_REL} x max")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: two calls differ")
    ms = cuda_ms(run, 20)
    device_ms = graph_ms(run, 20)
    plain_ms = cuda_ms(lambda: gate_mlp_bwd_plain(*args, g, dg), 5, warmup=1)
    # the bound at the card's f32 product rate (3xTF32); beside it the
    # bound at the CUDA cores' rate
    work = W.gate_mlp_bwd(rows, s, f, m, h)
    b_ms, b_by = bound(work)
    cc_ms, _ = bound(work, "f32")
    rec = {"shape": f"x[{rows},{s},{f}] H={h} M={m}",
           "max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
           "max_rel_err": errs, "max_rel_err_autograd": errs_auto,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_rate": rate_label(work),
           "bound_ms_cuda_cores": cc_ms,
           "library_ms": None, "device_ms": device_ms,
           "two_calls_bitwise": True}
    return rec, (run, want)


def flash_bwd_case(nq: int, s: int, seed: int, nk: int, hd: int = 128,
                   w: int = 256):
    """The write-gated attention's backward at a training shape: qwen3's
    B = 2 (Nq 32 on Nk 16), S 2048, hd 128, W 256 by default, the
    substrate's (S 128, hd 32, group 2, W 16). The forward kernel gives o
    and lse (lse also held to the plain version's); the backward kernel
    is held to the plain backward on those and to autograd of the plain
    forward. Library yardstick: SDPA's backward alone with the additive
    bias as a constant (dq, dk, dv only, so a lower yardstick), and SDPA
    forward + backward beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gated_flash as GF
    from repro_torch.roofline import work as W
    grp, eps = nq // nk, 1e-6
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q, k, v, do = rn(nq, s, hd), rn(nk, s, hd), rn(nk, s, hd), rn(nq, s, hd)
    g = torch.rand((nk, s), generator=gen, device="cuda")
    g[0, :8] = 1e-7   # gates near 0: large dg
    kw = {"w_local": w, "eps": eps, "group": grp}
    o, lse = GF._forward_cuda(q, k, v, g, w, eps, grp, True)
    o_plain, lse_plain = GF.gated_flash_plain(q, k, v, g, with_lse=True, **kw)
    ins = [t.clone().requires_grad_() for t in (q, k, v, g)]
    auto = torch.autograd.grad(GF.gated_flash_plain(*ins, **kw), ins, do)
    run = lambda: GF.gated_flash_bwd(q, k, v, g, o, lse, do, **kw)  # noqa
    got, again = run(), run()
    want = GF.gated_flash_bwd_plain(q, k, v, g, o, lse, do, **kw)
    torch.cuda.synchronize()
    tag = f"gated_flash_bwd q[{nq},{s},{hd}] W={w}"
    lse_err = float((lse - lse_plain).abs().max())
    check(float((o - o_plain).abs().max()) <= TOL["float32"]
          and lse_err <= TOL["float32"],
          f"{tag}: forward with lse off by {lse_err:.3e}")
    names = ("dq", "dk", "dv", "dg")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    errs_auto = {n: rel_err(a, b) for n, a, b in zip(names, got, auto)}
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{tag}: non-finite gradient")
    check(max(errs.values()) <= BWD_REL and max(errs_auto.values()) <= BWD_REL,
          f"{tag}: errors {errs} / autograd {errs_auto} > {BWD_REL} x max")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: two calls differ")
    iters = 10 if s >= 2048 else 50
    ms = cuda_ms(run, iters)
    device_ms = graph_ms(run, iters)
    plain_ms = cuda_ms(lambda: GF.gated_flash_bwd_plain(q, k, v, g, o, lse,
                                                        do, **kw),
                       3, warmup=1)
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    logg = torch.log(g + eps)[:, None, :]
    bias = torch.where(qi >= kj, torch.where(qi - kj < w,
                                             torch.zeros_like(logg), logg),
                       torch.full_like(logg, -1e30))
    bias = bias.repeat_interleave(grp, dim=0)[None]
    q4 = q[None].clone().requires_grad_()
    k4 = k.repeat_interleave(grp, dim=0)[None].requires_grad_()
    v4 = v.repeat_interleave(grp, dim=0)[None].requires_grad_()

    def library():
        out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)
        torch.autograd.grad(out, (q4, k4, v4), do[None])
    library_fwd_bwd_ms = cuda_ms(library, max(iters // 2, 3), warmup=1)
    # the same function as the kernel: SDPA's backward alone, its forward
    # run once outside the timed calls
    out4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do[None], retain_graph=True),
        max(iters // 2, 3), warmup=1)
    del bias, q4, k4, v4, out4
    # the bound at the card's f32 product rate (3xTF32); beside it the
    # bound at the CUDA cores' rate
    work = W.gated_flash_bwd(nq, s, hd, grp)
    b_ms, b_by = bound(work)
    cc_ms, _ = bound(work, "f32")
    rec = {"shape": f"q[{nq},{s},{hd}] kv[{nk},{s},{hd}] W={w} group={grp} "
                    "f32",
           "max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
           "max_rel_err": errs, "max_rel_err_autograd": errs_auto,
           "lse_max_abs_err": lse_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_rate": rate_label(work),
           "bound_ms_cuda_cores": cc_ms, "library_ms": library_ms,
           "library": "SDPA backward alone (forward once, outside the "
                      "timed calls), additive bias, dq/dk/dv (no dg)",
           "library_fwd_bwd_ms": library_fwd_bwd_ms,
           "device_ms": device_ms, "two_calls_bitwise": True}
    return rec, (run, want)


def rglru_bwd_case(b: int, s: int, d: int, with_h0: bool, seed: int):
    """The RG-LRU scan's backward at recurrentgemma-9b's training shape [1,
    4096, 4096] (one sequence, dr = d_model), or a ragged one with a
    carried-in state, on a in (0.9, 0.999) (the model's range, so that what
    a chunk hands the next is not negligible) and normal b and dy. The
    kernel is held to the plain backward on the forward kernel's h and,
    through the model's scan (its autograd Function; the state folded into
    b[:, 0]), to autograd of the plain loop; two calls bitwise equal.
    Returns the record and a function that runs the kernel on the same
    inputs (for the planted fault)."""
    import torch
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.models import rglru as RG
    from repro_torch.roofline import work as W
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.9 + 0.099 * torch.rand((b, s, d), generator=gen, device="cuda")
    x = torch.randn((b, s, d), generator=gen, device="cuda")
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    dy = torch.randn((b, s, d), generator=gen, device="cuda")
    xf = x.clone()
    if with_h0:
        xf[:, 0] = xf[:, 0] + a[:, 0] * h0
    h = RS.rglru_scan(a, xf)
    run = lambda: RS.rglru_scan_bwd(a, h, dy)  # noqa: E731
    got, again = run(), run()
    want = RS.rglru_scan_bwd_plain(a, h, dy)
    names = ("da", "db") + (("dh0",) if with_h0 else ())
    ins = [t.clone().requires_grad_() for t in (a, x, h0)[:len(names)]]
    model = torch.autograd.grad(RG.rglru_scan(*ins[:2], ins[2] if with_h0
                                              else None), ins, dy)
    pins = [t.clone().requires_grad_() for t in (a, x, h0)[:len(names)]]
    pb = pins[1]
    if with_h0:
        pb = pb.clone()
        pb[:, 0] = pb[:, 0] + pins[0][:, 0] * pins[2]
    auto = torch.autograd.grad(RS.rglru_scan_plain(pins[0], pb), pins, dy)
    torch.cuda.synchronize()
    tag = f"rglru_scan_bwd [{b},{s},{d}]" + (" h0" if with_h0 else "")
    errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
    errs_auto = {n: rel_err(g, w) for n, g, w in zip(names, model, auto)}
    check(all(bool(torch.isfinite(t).all()) for t in got + model),
          f"{tag}: non-finite gradient")
    check(max(errs.values()) <= BWD_REL and max(errs_auto.values()) <= BWD_REL,
          f"{tag}: errors {errs} / autograd {errs_auto} > {BWD_REL} x max")
    check(all(torch.equal(g, w) for g, w in zip(got, again)),
          f"{tag}: two calls differ")
    ms = cuda_ms(run, 20)
    device_ms = graph_ms(run, 20)
    plain_ms = cuda_ms(lambda: RS.rglru_scan_bwd_plain(a, h, dy), 2, warmup=1)
    b_ms, b_by = bound(W.rglru_scan_bwd(b, s, d))
    rec = {"shape": f"a,h,dy[{b},{s},{d}] f32" + (" h0" if with_h0 else ""),
           "max_abs_err": max(float((g - w).abs().max())
                              for g, w in zip(got, want)),
           "max_rel_err": errs, "max_rel_err_autograd": errs_auto,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "device_ms": device_ms,
           "two_calls_bitwise": True}
    return rec, (run, want)


def new_arch_cases():
    """Phase 3's cases at this slice's heads (``NEW_HEADS``), f32, at the
    shapes the new archs' phases give each kernel. qwen2-vl-7b: serve's
    dual cache (2 slots, C 128, W 256) and the offline decode's (C 1024),
    the gate at serve and over a 4,096-token prefill, prefill's
    vertical_slash (S 4096, C 1024, W 256), gated_flash at the tau
    probe's S 32 and the VLM forward's S 2048. whisper-medium: the decode's
    dual cache (C 96, W 64), the gate at decode, over the 384 self keys and
    over the 1,500 cross keys (a ragged last tile), vertical_slash (S 384,
    C 96, W 64), gated_flash over the forward's 16 heads and the train
    batch's 2 x 16, and the backward kernels at the train shape (2 x 384,
    F 128, M 64). Returns ((tag, record) pairs, (fault, run) pairs: each
    forward fault at the first case it shows on, the backward faults on
    the train shape)."""
    import torch
    cases, runs = [], []

    def add(tag, fault, fn, **kw):
        sink = [] if fault else None
        cases.append((tag, fn(**kw, runs=sink) if fault else fn(**kw)))
        runs.extend((fault, r) for r in sink or ())
    hq, hkv, hd = NEW_HEADS["qwen2-vl-7b"]
    grp, t = hq // hkv, "qwen2-vl-7b"
    add(f"paged_decode {t}", "paged_decode", dual_cache_case, slots=2,
        c=128, w=256, dtype=torch.float32, seed=120, hkv=hkv, grp=grp, hd=hd)
    add(f"paged_decode {t}", None, dual_cache_case, slots=1, c=1024, w=256,
        dtype=torch.float32, seed=121, hkv=hkv, grp=grp, hd=hd)
    add(f"gate_mlp {t}", "gate_mlp_decode", gate_case, rows=2 * hkv, s=1,
        seed=122, h=hkv, f=2 * hd)
    add(f"gate_mlp {t}", "gate_mlp_mma", gate_case, rows=hkv, s=4096,
        seed=123, h=hkv, f=2 * hd)
    add(f"vertical_slash {t}", "vertical_slash", vertical_slash_case,
        dtype="float32", seed=124, hkv=hkv, hd=hd, hq=hq)
    add(f"gated_flash {t}", "gated_flash", gated_flash_case, s=32,
        dtype="float32", seed=125, hkv=hkv, hd=hd, hq=hq)
    add(f"gated_flash {t}", None, gated_flash_case, s=2048,
        dtype="float32", seed=126, hkv=hkv, hd=hd, hq=hq)
    hq, hkv, hd = NEW_HEADS["whisper-medium"]
    t, w, s, c = "whisper-medium", WHISPER_W, WHISPER_S, WHISPER_C
    add(f"paged_decode {t}", "paged_decode_stream", dual_cache_case,
        slots=1, c=c, w=w, dtype=torch.float32, seed=130, hkv=hkv, grp=1,
        hd=hd)
    add(f"gate_mlp {t}", "gate_mlp_decode", gate_case, rows=hkv, s=1,
        seed=131, h=hkv, f=2 * hd)
    add(f"gate_mlp {t}", None, gate_case, rows=hkv, s=s, seed=132, h=hkv,
        f=2 * hd)
    add(f"gate_mlp {t}", "gate_mlp_mma", gate_case, rows=hkv,
        s=WHISPER_ENC, seed=133, h=hkv, f=2 * hd)
    add(f"vertical_slash {t}", "vertical_slash", vertical_slash_case,
        dtype="float32", seed=134, hkv=hkv, hd=hd, hq=hq, w=w, s=s, c=c)
    add(f"gated_flash {t}", "gated_flash", gated_flash_case, s=s,
        dtype="float32", seed=135, hkv=hkv, hd=hd, hq=hq, w=w)
    add(f"gated_flash {t}", None, gated_flash_case, s=s, dtype="float32",
        seed=136, hkv=2 * hkv, hd=hd, hq=2 * hq, w=w)
    rec, run = gate_bwd_case(rows=2 * hkv, s=s, seed=137, h=hkv, f=2 * hd)
    cases.append((f"gate_mlp_bwd {t}", rec))
    runs.append(("gate_mlp_bwd", run))
    rec, run = flash_bwd_case(2 * hq, s, seed=138, nk=2 * hkv, hd=hd, w=w)
    cases.append((f"gated_flash_bwd {t}", rec))
    runs.append(("gated_flash_bwd", run))
    return cases, runs


def figure_cases():
    """Phase 3's cases at the shapes the figures give each kernel, f32.
    Fig. 8 at full-width qwen3-0.6b (16 / 8 heads of hd 128, W 256) for S
    1,024 and 2,048 at budget C = S / 4 (S 4,096's are the cases above):
    the gate over the prompt and at the one-slot decode, vertical_slash,
    the dense prefill's causal gated_flash, the WG-KV decode's dual cache
    and the dense decode's buffer (S + 8 slots rounded up to a page, S + 1
    tokens read); fig. 8's kernel row (gated_flash over 4 / 2 heads of hd
    64, S 1,024, W 64); the bench substrate's selected read (2 kv heads,
    group 2, hd 32, W 16) at the serving bench's shape (4 slots, C 192,
    K 4) and at fig. 9's (one row, C 64, K 2). Returns (tag, record)
    pairs, tagged ``<kernel> fig8`` or ``<kernel> bench``."""
    import torch
    f32 = torch.float32
    cases = []
    for i, s in enumerate((1024, 2048)):
        sd, c = 140 + 10 * i, s // 4
        cases += [
            ("gate_mlp fig8", gate_case(rows=8, s=s, seed=sd)),
            ("vertical_slash fig8", vertical_slash_case(
                "float32", seed=sd + 1, s=s, c=c)),
            ("gated_flash fig8", gated_flash_case(s, "float32", seed=sd + 2,
                                                  causal=True)),
            ("paged_decode fig8", dual_cache_case(1, c, 256, f32,
                                                  seed=sd + 3)),
            ("paged_decode fig8", dense_case(1, s + 8, [s + 1], f32,
                                             seed=sd + 4))]
    cases += [
        ("gate_mlp fig8", gate_case(rows=8, s=1, seed=160)),
        ("gated_flash fig8", gated_flash_case(1024, "float32", seed=161,
                                              hkv=2, hd=64, w=64, hq=4)),
        ("paged_decode_selected bench", selected_case(
            4, 192, 16, 4, f32, seed=162, hkv=2, grp=2, hd=32)),
        ("paged_decode_selected bench", selected_case(
            1, 64, 16, 2, f32, seed=163, hkv=2, grp=2, hd=32))]
    return cases


def mesh_cases():
    """Phase 3's cases at the shapes one rank of the mesh phase's 1 x 2
    mesh gives each kernel (f32): qwen3-0.6b's heads split in two, 8 q
    heads over 4 kv heads of hd 128 (the split plan depends on the head
    count), 2 slots, W 256; the dual cache at the mesh phase's capacity
    (C 64 of 256) and at the serving shape's C 128, the gate at decode (F
    256), and the selected read at C 128, K 2. Returns (tag, record)
    pairs, tagged ``<kernel> mesh``."""
    import torch
    f32 = torch.float32
    return [
        ("paged_decode mesh", dual_cache_case(2, 64, 256, f32, seed=170,
                                              hkv=4, grp=2, hd=128)),
        ("paged_decode mesh", dual_cache_case(2, 128, 256, f32, seed=171,
                                              hkv=4, grp=2, hd=128)),
        ("gate_mlp mesh", gate_case(rows=2 * 4, s=1, seed=172, h=4)),
        ("paged_decode_selected mesh", selected_case(
            2, 128, 256, 2, f32, seed=173, hkv=4, grp=2, hd=128))]


def lse_case(seed: int, slots: int = 2, c: int = 1024, w: int = 256,
             hkv: int = 4, grp: int = 2, hd: int = 128):
    """``paged_decode`` with its log-sum-exp at one rank's shapes of the
    context-parallel decode: qwen3-0.6b's heads split in two (8 q on 4 kv
    heads), a global cache of C split in two blocks over "data", each
    read as its rank reads it (block 1 without the ring; kv heads whose
    gcnt stays in block 0 leave block 1 empty: lse -inf, out 0). Each
    block's out and lse held to the plain version's, and the two blocks
    combined by their lse (``comm.combine_lse``'s formula) held to the
    plain read of the whole cache."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=f32,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    pattern = torch.tensor([0, 7, c, c // 2 + 3, 1, c // 2, 16, c - 1],
                           dtype=torch.int32, device="cuda")
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([w + 101 * i for i in range(slots)], dtype=torch.int32,
                     device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    whole = ops.dual_cache_attention(q, cache)
    cb = c // 2
    err, parts, empty = 0.0, [], 0
    for i in range(2):
        blk = cache._replace(gk=cache.gk[:, :, i * cb:(i + 1) * cb].contiguous(),
                             gv=cache.gv[:, :, i * cb:(i + 1) * cb].contiguous())
        qf, first, second, gg = ops.dual_cache_segments(q, blk, (i, 2))
        got, lse = paged_decode(qf, *first, second=second, group=gg, lse=True)
        want, wlse = paged_decode_plain(qf, *first, second=second, group=gg,
                                        lse=True)
        again, _ = paged_decode(qf, *first, second=second, group=gg, lse=True)
        torch.cuda.synchronize()
        dead = torch.isinf(wlse)
        check(torch.equal(torch.isinf(lse), dead), f"lse block {i}: the "
              "empty reads differ from the plain version's")
        check(bool((got[dead] == 0).all()), f"lse block {i}: an empty read "
              "is not 0")
        check(torch.equal(got, again), f"lse block {i}: two calls differ")
        empty += int(dead.sum())
        err = max(err, float((got - want).abs().max()),
                  float((lse[~dead] - wlse[~dead]).abs().max()))
        parts.append((got, lse))
        if i == 1:
            run = (qf, first, second, gg)
    check(empty > 0, "lse: no empty block read")
    m = torch.maximum(parts[0][1], parts[1][1])
    ms_ = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wts = [torch.where(torch.isfinite(l), torch.exp(l - ms_),
                       torch.zeros_like(l)) for _, l in parts]
    comb = sum(w_[:, None] * o for (o, _), w_ in zip(parts, wts)) \
        / torch.clamp(sum(wts), min=1e-30)[:, None]
    comb_err = float((comb - whole.reshape(comb.shape)).abs().max())
    check(err <= TOL["float32"] and comb_err <= TOL["float32"],
          f"paged_decode lse: err {err:.3e}, combined {comb_err:.3e} > "
          f"{TOL['float32']}")
    qf, first, second, gg = run
    ms = cuda_ms(lambda: paged_decode(qf, *first, second=second, group=gg,
                                      lse=True), 200)
    plain_ms = cuda_ms(lambda: paged_decode_plain(
        qf, *first, second=second, group=gg, lse=True), 50)
    # library yardstick: SDPA over the block with a validity mask (the
    # group's heads as SDPA's queries)
    kb, vb = cache.gk[:, :, cb:], cache.gv[:, :, cb:]
    pos = torch.arange(cb, device="cuda")
    mask = (pos[None, None] < (gcnt - cb).clamp(0, cb)[..., None])[:, :, None]
    qg = q.reshape(slots, hkv, grp, hd)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, kb, vb, attn_mask=mask), 200)
    toks = int((gcnt - cb).clamp(0, cb).sum())
    b_ms, b_by = bound(W.paged_decode(qf.shape[0], hd, gg, first[2].shape[1],
                                      second[2].shape[1], tokens=toks,
                                      lse=True))
    return {"shape": f"N={slots * hkv * grp} hd={hd} C={c} block 1 of 2 "
            f"(C {cb}, no ring) W={w} float32 lse",
            "max_abs_err": err, "combined_err": comb_err,
            "empty_reads": empty, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def mesh_step_cases():
    """Phase 3's cases at one rank's shapes of the mesh-steps phase's 1 x
    2 mesh (f32; qwen3-0.6b's heads split in two: 8 q on 4 kv heads, hd
    128, W 256): the train step's ``gated_flash`` and its backward (2 x
    1,024 tokens: Nq 16, Nk 8 rows), the gate and its backward at H 4,
    the prefill's ``vertical_slash`` (q [8, 4096, 128], C 1,024), and
    ``paged_decode`` with its lse on one block of a 2-way split. Returns
    (tag, record) pairs tagged ``<kernel> mesh-steps``."""
    fb, _ = flash_bwd_case(16, 1024, seed=180, nk=8)
    gb, _ = gate_bwd_case(rows=2 * 4, s=1024, seed=181, h=4)
    return [
        ("gated_flash mesh-steps", gated_flash_case(
            1024, "float32", seed=182, hkv=4, hq=8)),
        ("gated_flash_bwd mesh-steps", fb),
        ("gate_mlp mesh-steps", gate_case(rows=2 * 4, s=1024, seed=183,
                                          h=4)),
        ("gate_mlp_bwd mesh-steps", gb),
        ("vertical_slash mesh-steps", vertical_slash_case(
            "float32", seed=184, hkv=4, hq=8)),
        ("paged_decode mesh-steps", lse_case(seed=185))]


def mesh_arch_cases():
    """Phase 3's cases at one rank's shapes of the mesh-archs phase's 1 x
    2 mesh (f32): recurrentgemma-9b's RG-LRU scan and its backward on
    half its channels ([1, 4096, 2048]: a 4,096-token prefill's and train
    step's), its train step at 1 x 2,048 (every q head on its one kv head
    under "gather_q": ``gated_flash``'s backward at hd 256, W 2,048, and
    the gate's at F 512); granite-moe-3b-a800m on half its kv heads (12 q
    on 4 kv of hd 64; the gate at H 4, F 128) at decode (2 slots, C 64 of
    the serve's capacity 256, W 256) and over its 2,048-token prefill (C
    512). Returns (tag, record) pairs tagged ``<kernel> mesh-archs``."""
    import torch
    rb, _ = rglru_bwd_case(1, 4096, 2048, False, seed=191)
    fb, _ = flash_bwd_case(16, 2048, seed=194, nk=1, hd=256, w=2048)
    gb, _ = gate_bwd_case(rows=1, s=2048, seed=195, h=1, f=512)
    return [
        ("rglru_scan mesh-archs", rglru_case(1, 4096, 2048, False,
                                             seed=190)),
        ("rglru_scan_bwd mesh-archs", rb),
        ("gated_flash_bwd mesh-archs", fb),
        ("gate_mlp_bwd mesh-archs", gb),
        ("gate_mlp mesh-archs", gate_case(rows=2 * 4, s=1, seed=192, h=4,
                                          f=128)),
        ("gate_mlp mesh-archs", gate_case(rows=4, s=2048, seed=193, h=4,
                                          f=128)),
        ("paged_decode mesh-archs", dual_cache_case(
            2, 64, 256, torch.float32, seed=196, hkv=4, grp=3, hd=64)),
        ("vertical_slash mesh-archs", vertical_slash_case(
            "float32", seed=197, hkv=4, hd=64, hq=12, s=2048, c=512)),
        ("gated_flash mesh-archs", gated_flash_case(
            2048, "float32", seed=198, hkv=1, hd=256, w=2048))]


def planted_faults(cases) -> dict:
    """Each fault of ``FAULTS`` planted alone in a rebuild of its kernel
    (all built at once), run on the inputs of its cases (fault name, (run,
    want)): a backward fault's error against the plain backward must read
    above BWD_REL, relative to each gradient's max; a forward fault's max
    abs error against the plain forward above TOL["float32"] (the sound
    kernels read below those limits above)."""
    import torch
    out = {}
    with Planted(sorted({name for name, _ in cases})) as planted:
        for name, (run, want) in cases:
            planted.use(name)
            got = run()
            torch.cuda.synchronize()
            if name in BWD_FAULTS:
                err = max(rel_err(a, b) for a, b in zip(got, want))
                limit = BWD_REL
            else:
                err = float((got.float() - want.float()).abs().max())
                err = err if err == err else float("inf")  # NaN: far off
                limit = TOL["float32"]
            check(err > limit, f"planted fault {name}: error {err:.3e} "
                  f"<= {limit}: the limit would not see it")
            out.setdefault(name, []).append(err)
    return out


# --------------------------------------------------------------------------
# phases 4-14: the main paths
# --------------------------------------------------------------------------
class Wrapped:
    """Counts and times calls of ``owner.name`` while the block runs (a
    module function such as ``inference.decode_step``, one call per
    position step, or an engine method such as the paged mirror)."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.inner = getattr(owner, name)
        self.count, self.seconds = 0, 0.0

    def __enter__(self):
        def wrapped(*a, **kw):
            self.count += 1
            t0 = time.perf_counter()
            try:
                return self.inner(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)
        return False


def position_counter():
    from repro_torch.models import inference as I
    return Wrapped(I, "decode_step")


def reset_counts():
    from repro_torch.benchmarks.common import kernel_counters
    for c in kernel_counters():
        c.reset()


def read_counts():
    from repro_torch.benchmarks.common import kernel_counters
    return {c.name: c.count for c in kernel_counters()}


def serve_cli(n_layers: int):
    import torch
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with position_counter() as pc:
        res = serve.main(["--arch", "qwen3-0.6b", "--requests", "4",
                          "--max-new", "16", "--quiet-stream"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = res["outputs"]
    check(len(outs) == 4 and all(len(o) == 16 for o in outs),
          f"serve-cli: not every request returned 16 tokens: "
          f"{[len(o) for o in outs]}")
    check(res["paged_dev"] < 2e-3,
          f"serve-cli: paged-vs-logical deviation {res['paged_dev']:.3e}")
    # the startup tau probe is one gated forward: one gate_mlp and one
    # gated_flash launch per layer, before any position step
    check(counts["gate_mlp"] == n_layers * (pc.count + 1),
          f"serve-cli: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} x ({pc.count} positions + 1 probe)")
    check(counts["gated_flash"] == n_layers,
          f"serve-cli: gated_flash launches {counts['gated_flash']} != "
          f"{n_layers} (the tau probe)")
    check(counts["paged_decode"] >= n_layers * pc.count,
          f"serve-cli: paged_decode launches {counts['paged_decode']}")
    print(f"serve-cli: ok wall={wall:.3f}s positions={pc.count} "
          f"launches={counts} paged_dev={res['paged_dev']:.3e}")
    return counts


def profile_ticks(sess, n: int):
    """Device busy share over ``n`` serving ticks under torch.profiler
    (CUDA kernel self time summed by name, against the window's wall
    time; the profiler's own host cost inflates the wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sess.tick()
        sess.orchestrator.drain()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0.0)
              or getattr(e, "self_cuda_time_total", 0.0))
        ms, calls = per_kernel.get(e.key, (0.0, 0))
        per_kernel[e.key] = (ms + us / 1e3, calls + e.count)
    busy = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"ticks": n, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "top_kernels_ms_calls": [[k[:60], ms, calls]
                                     for k, (ms, calls) in top]}


def serve_long(card: str):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession

    slots, cap, prompt_len, max_new = 2, 512, 384, 16
    cfg = get_config("qwen3-0.6b").replace(dtype="float32",
                                           n_repeats=SERVE_REPEATS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_model(cfg, gen, "cuda")
    pool_pages = pool_pages_for(cfg, slots, cap)
    eng = make_backend("wgkv", params, cfg, slots=slots, capacity=cap,
                       pool_pages=pool_pages, device="cuda")
    sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                   dispatch_ahead=1))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size - 8, prompt_len).tolist()
               for _ in range(4)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    gmax, dev, verified = 0, None, 0
    with position_counter() as pc, \
            Wrapped(eng, "_mirror_prefill") as mp, \
            Wrapped(eng, "_mirror_decode") as md:
        handles = [sess.submit(p, max_new=max_new) for p in prompts]
        for _ in range(100_000):
            if not sess.tick():
                break
            if dev is None and any(h.state == "decode" for h in handles):
                # settle the mirror and check the physical pool while live
                sess.orchestrator.drain()
                node = eng.caches["blocks"]["b0"]
                live = [s for s in range(slots) if eng.live[s]]
                per_layer = node.gcnt[:, live].sum(dim=(1, 2))
                gmax = int(node.gcnt[:, live].max())
                layer = int(per_layer.argmax())
                dev = eng.verify_paged(layer_repeat=layer)
                verified += 1
        sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summ = sess.telemetry.summary()
    # outside the measured window: two more long requests, and a profile
    # of decode-only ticks once both decode at long context
    extra = [sess.submit(p, max_new=8) for p in prompts[:2]]
    while not all(h.state == "decode" for h in extra):
        check(sess.tick(), "serve-long: profile requests stalled")
    prof = profile_ticks(sess, 4)
    sess.run()
    sess.close()
    n_layers = cfg.n_layers
    check(all(h.state == "done" and len(h.tokens()) == max_new
              for h in handles),
          f"serve-long: requests incomplete: "
          f"{[(h.state, len(h.tokens())) for h in handles]}")
    check(gmax > 0, "serve-long: no layer admitted a token to the global "
          "cache (lazy promotion did not run)")
    check(dev is not None and dev < 2e-3,
          f"serve-long: paged-vs-logical deviation {dev}")
    check(counts["gate_mlp"] > 0 and counts["paged_decode"] > 0,
          f"serve-long: a kernel never launched: {counts}")
    check(counts["gate_mlp"] == n_layers * pc.count,
          f"serve-long: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} x {pc.count} positions")
    check(counts["paged_decode"] == n_layers * pc.count + verified,
          f"serve-long: paged_decode launches {counts['paged_decode']} != "
          f"{n_layers} x {pc.count} positions + {verified} verify")
    per_pos = {k: (v - (verified if k == "paged_decode" else 0)) / pc.count
               for k, v in counts.items()}
    stats = {
        "card": card, "requests": len(handles), "prompt_len": prompt_len,
        "max_new": max_new, "slots": slots, "capacity": cap,
        "pool_pages": pool_pages, "wall_s": wall,
        "ttft_mean_s": summ["ttft_mean_s"], "ttft_p50_s": summ["ttft_p50_s"],
        "tpot_mean_s": summ["tpot_mean_s"], "tpot_p50_s": summ["tpot_p50_s"],
        "tokens_per_s": summ["tokens_per_s"],
        "mean_admission": summ["mean_admission"],
        "gcnt_max": gmax, "paged_dev": dev, "positions": pc.count,
        "launches": counts, "launches_per_position": per_pos,
        "mirror_prefill_s": mp.seconds, "mirror_prefill_calls": mp.count,
        "mirror_decode_s": md.seconds, "mirror_decode_calls": md.count,
        "collect_time_s": summ["counters"].get("collect_time_s"),
        "dispatch_time_s": summ["counters"].get("dispatch_time_s"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profile": prof,
    }
    print("serve-long: " + json.dumps(stats))
    return counts


def full_model(seed: int):
    """Full-width qwen3-0.6b (f32) with random weights drawn on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("qwen3-0.6b").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_model(cfg, gen, "cuda")


def greedy_decode(params, cfg, logits, caches, steps: int, opts=None):
    """``steps`` greedy decode steps from a prefill's caches; returns the
    tokens fed, every step's logits, the final caches and each step's
    stats."""
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models.transformer import layer_params
    layers = layer_params(params, cfg)
    opts = opts or I.DecodeOptions()
    toks, all_logits, stats = [], [logits], []
    for _ in range(steps):
        tok = logits.argmax(-1)
        toks.append(tok)
        logits, caches, st = I.decode_step(params, cfg, tok, caches,
                                           opts=opts, layers=layers)
        all_logits.append(logits)
        stats.append(st)
    return torch.stack(toks, 1), torch.stack(all_logits, 1), caches, stats


def prefill_decode(cfg, params, seed: int, tag: str):
    """``inference.prefill`` of a 4096-token prompt (budget 1024, tokens
    from ``seed``) through a dense ``("attn",)`` model, then 16 greedy
    decode steps from its caches: one ``vertical_slash`` per layer, one
    ``gate_mlp`` per layer and position, one ``paged_decode`` per layer
    and decode step. Returns the stats and what decode-select starts
    from: the prefill's logits and caches (left untouched by the
    functional decode), the decode's tokens and logits."""
    import numpy as np
    import torch
    from repro_torch.models import inference as I
    s, budget, steps, n_layers = 4096, 1024, 16, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, budget=budget)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks_off, logits, dec_caches, _ = greedy_decode(
            params, cfg, out.logits, caches, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    node = dec_caches["blocks"]["b0"]
    gcnt = node.gcnt
    check(counts["vertical_slash"] == n_layers,
          f"{tag}: vertical_slash launches "
          f"{counts['vertical_slash']} != {n_layers}")
    check(counts["gate_mlp"] == n_layers * (1 + steps),
          f"{tag}: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_layers} + {n_layers} x {steps}")
    check(counts["paged_decode"] == n_layers * steps,
          f"{tag}: paged_decode launches {counts['paged_decode']} "
          f"!= {n_layers} x {steps}")
    check(int(dec_caches["t"][0]) == s + steps
          and bool((node.t == s + steps).all()),
          f"{tag}: t {dec_caches['t'].tolist()} != {s + steps}")
    check(node.gk.shape[-2] == budget and int(gcnt.min()) > 0
          and int(gcnt.max()) <= budget,
          f"{tag}: gcnt in [{int(gcnt.min())}, {int(gcnt.max())}], "
          f"want (0, {budget}]")
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    stats = {"prompt_len": s, "budget": budget, "decode_steps": steps,
             "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "mean_admission": float(out.mean_admission),
             "gcnt_min": int(gcnt.min()), "gcnt_max": int(gcnt.max()),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    # the same prefill again, after the counts were read: the phase times
    # one cold call, so a one-off stall there shows as a gap to this one
    with torch.no_grad():
        t0 = time.perf_counter()
        again = I.prefill(params, cfg, toks, budget=budget)
        torch.cuda.synchronize()
        stats["prefill_ms_repeat"] = (time.perf_counter() - t0) * 1e3
    del again
    return stats, {"prefill_logits": out.logits, "caches": caches,
                   "tokens": toks_off, "logits": logits}


def prefill_long(cfg, params):
    """``prefill_decode`` of qwen3-0.6b. Returns the launch counts, ms and
    what decode-select starts from."""
    stats, base = prefill_decode(cfg, params, 12, "prefill-long")
    print("prefill-long: " + json.dumps(stats))
    return dict(base, counts=stats["launches"],
                prefill_ms=stats["prefill_ms"],
                decode_ms_per_step=stats["decode_ms_per_step"])


def decode_select(cfg, params, base):
    """From prefill-long's caches (C = 1024, 64 pages), 16 greedy decode
    steps with Quest selection: ``quest:64`` (every page) bitwise equal to
    prefill-long's selection-off run; ``quest:8`` read by
    ``paged_decode_selected`` alone, 8 pages per (kv head, layer);
    mask mode ``quest_pages=8`` within 5e-5 of ``quest:8``."""
    import torch
    from repro_torch.models import inference as I
    steps, n_layers = 16, cfg.n_layers

    def run(opts):
        torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            t0 = time.perf_counter()
            toks, logits, _, st = greedy_decode(
                params, cfg, base["prefill_logits"], base["caches"], steps,
                opts)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        return toks, logits, st, read_counts(), ms

    toks_all, logits_all, _, c_all, _ = run(
        I.DecodeOptions(selection_policy="quest:64"))
    check(torch.equal(toks_all, base["tokens"]),
          "decode-select: quest:64 tokens differ from selection off")
    check(torch.equal(logits_all, base["logits"]),
          "decode-select: quest:64 logits differ from selection off by "
          f"{float((logits_all - base['logits']).abs().max()):.3e}")
    check(c_all["paged_decode_selected"] == n_layers * steps
          and c_all["paged_decode"] == 0,
          f"decode-select: quest:64 launches {c_all}")
    toks8, logits8, st8, c8, ms8 = run(
        I.DecodeOptions(selection_policy="quest:8"))
    per_step = [float(st["selected_pages_rows"][0]) for st in st8]
    check(all(v == 8.0 * n_layers for v in per_step),
          f"decode-select: selected_pages_rows {per_step} != "
          f"8 x {n_layers} per step")
    check(c8["paged_decode_selected"] == n_layers * steps
          and c8["paged_decode"] == 0,
          f"decode-select: quest:8 launches {c8} (want "
          f"paged_decode_selected {n_layers} x {steps}, paged_decode 0)")
    check(bool(torch.isfinite(logits8).all()),
          "decode-select: non-finite logits")
    toks_m, logits_m, st_m, c_m, ms_m = run(I.DecodeOptions(quest_pages=8))
    err = float((logits_m - logits8).abs().max())
    check(err <= 5e-5, f"decode-select: mask mode logits differ from "
          f"quest:8 by {err:.3e} > 5e-5")
    check(torch.equal(toks_m, toks8), "decode-select: mask mode tokens "
          "differ from quest:8")
    check(c_m["paged_decode_selected"] == n_layers * steps
          and c_m["paged_decode"] == 0,
          f"decode-select: mask mode launches {c_m}")
    stats = {"decode_steps": steps,
             "decode_ms_per_step_off": base["decode_ms_per_step"],
             "decode_ms_per_step_quest8": ms8,
             "decode_ms_per_step_mask8": ms_m,
             "quest8_vs_off_max_logit_diff": float(
                 (logits8 - base["logits"]).abs().max()),
             "quest8_tokens_equal_off": bool(torch.equal(toks8,
                                                         base["tokens"])),
             "mask_vs_quest8_max_logit_err": err,
             "launches_quest64": c_all, "launches_quest8": c8,
             "launches_mask8": c_m}
    print("decode-select: " + json.dumps(stats))
    return c8


def serve_compose(card: str):
    """``ServeSession`` at full width (8 layers) composing the three
    primitives:
    learned admission, ``quest:2`` decode selection and SnapKV eviction
    (hard budget 96 global tokens per head). Prompts of 384 tokens leave
    the 256-token ring, so promotion fills the global cache past the
    budget and eviction fires; decode-only ticks run the selection
    variant. The pool is verified after a decode step's eviction was
    mirrored."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.models import inference as I
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.obs import Tracer
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession

    slots, cap, prompt_len, max_new, budget = 2, 512, 384, 16, 96
    # full width, depth cut to 8 of 28 layers: eviction adds about 100
    # host-dispatched ops per layer and position, and the phase's time
    # scales with depth (28 layers: 96 s on one H100; 14: 39-49 s)
    cfg = get_config("qwen3-0.6b").replace(dtype="float32", n_repeats=8)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_model(cfg, gen, "cuda")
    eng = make_backend("wgkv", params, cfg, slots=slots, capacity=cap,
                       pool_pages=pool_pages_for(cfg, slots, cap),
                       opts=I.DecodeOptions(evict_hard_budget=budget),
                       selection="quest:2", device="cuda")
    tracer = Tracer(capacity=1 << 16)
    sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                   dispatch_ahead=1),
                        tracer=tracer)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size - 8, prompt_len).tolist()
               for _ in range(2)]
    resyncs = []
    inner = eng._mirror_decode

    def mirror(before, after, *, rows=None, evicted_rows=None):
        if evicted_rows is not None and rows \
                and any(bool(evicted_rows[r]) for r in rows):
            resyncs.append(len(resyncs))
        return inner(before, after, rows=rows, evicted_rows=evicted_rows)
    eng._mirror_decode = mirror
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dev = None
    with position_counter() as pc:
        handles = [sess.submit(p, max_new=max_new) for p in prompts]
        for _ in range(100_000):
            if not sess.tick():
                break
            if dev is None and resyncs and any(eng.live):
                sess.orchestrator.drain()
                dev = eng.verify_paged(layer_repeat=cfg.n_layers - 1)
        sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    summ = sess.telemetry.summary()
    sess.close()
    spans = {sp.name for sp in tracer.spans}
    check(all(h.state == "done" and len(h.tokens()) == max_new
              for h in handles),
          f"serve-compose: requests incomplete: "
          f"{[(h.state, len(h.tokens())) for h in handles]}")
    check(eng.stats["evict_triggers"] > 0, "serve-compose: eviction never "
          "triggered")
    check(eng.stats["selected_pages"] > 0, "serve-compose: no page selected")
    check("selection" in spans, f"serve-compose: no selection span in "
          f"{sorted(spans)}")
    check(bool(resyncs), "serve-compose: no post-eviction mirror re-sync")
    check(dev is not None and dev < 2e-3,
          f"serve-compose: paged-vs-logical deviation {dev}")
    check(counts["paged_decode_selected"] > 0 and counts["paged_decode"] > 0
          and counts["gate_mlp"] == cfg.n_layers * pc.count,
          f"serve-compose: launches {counts} over {pc.count} positions")
    stats = {"card": card, "requests": len(handles),
             "prompt_len": prompt_len, "max_new": max_new, "slots": slots,
             "capacity": cap, "evict_hard_budget": budget,
             "selection": "quest:2", "wall_s": wall, "positions": pc.count,
             "ttft_mean_s": summ["ttft_mean_s"],
             "tpot_mean_s": summ["tpot_mean_s"],
             "tokens_per_s": summ["tokens_per_s"],
             "evict_triggers": eng.stats["evict_triggers"],
             "selected_pages": eng.stats["selected_pages"],
             "selection_time_s": eng.stats["selection_time_s"],
             "evict_resync_steps": len(resyncs), "paged_dev": dev,
             "launches": counts}
    print("serve-compose: " + json.dumps(stats))
    return counts


def forward_gated(cfg, params, tag: str = "forward-gated"):
    """The write-gated full-sequence forward over 2048 tokens. Returns its
    stats (``launches``: the counts)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    s, n_layers = 2048, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        res = T.forward(params, cfg, toks, mode="gated", with_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    shape = tuple(res.gates.shape)
    check(counts["gated_flash"] == n_layers,
          f"{tag}: gated_flash launches {counts['gated_flash']} != "
          f"{n_layers}")
    check(counts["gate_mlp"] == n_layers,
          f"{tag}: gate_mlp launches {counts['gate_mlp']} != {n_layers}")
    check(shape == (n_layers, 1, cfg.n_kv_heads, s), f"{tag}: gates {shape}")
    check(bool(torch.isfinite(res.hidden).all()
               and ((res.gates > 0) & (res.gates < 1)).all()),
          f"{tag}: non-finite hidden or gates outside (0, 1)")
    stats = {"seq": s, "forward_ms": wall * 1e3, "gates": list(shape),
             "admitted_frac": float((res.gates >= cfg.wgkv.tau).float()
                                    .mean()),
             "lb_loss": float(res.lb_loss),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print(f"{tag}: " + json.dumps(stats))
    return stats


SUBSTRATE = ROOT / "checkpoints" / "bench_model_lam0.15.npz"


def substrate_cfg():
    """The trained substrate's config:
    ``benchmarks/common.py::bench_cfg(lam=0.15)``, field for field."""
    from repro_torch.configs.base import ModelConfig, WGKVConfig
    return ModelConfig(
        name="bench-tiny", arch_type="dense", d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        block_pattern=("attn",), n_repeats=2, rope_theta=10000.0,
        dtype="float32", wgkv=WGKVConfig(
            enabled=True, w_local=16, tau=0.1, gate_hidden=32,
            global_budget_frac=1.0, sink=2, lam=0.15))


def substrate():
    """The trained bench substrate through prefill + 16 greedy decode steps
    on the card (kernels) and on the CPU (plain path): identical tokens and
    integer cache state, logits within 1e-4. Run twice: as served by
    default, then with ``quest:2`` decode selection and SnapKV eviction
    (hard budget 64, below the 83-103 global tokens the prompt leaves in
    the first layer's heads, so eviction fires)."""
    import numpy as np
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import selection as SEL
    from repro_torch.kernels import ops
    from repro_torch.models import inference as I
    path = SUBSTRATE
    check(path.exists(), f"substrate: {path} missing")
    cfg = substrate_cfg()
    # prompt seed 20: every gate score of this prompt, in prefill and in
    # the 16 decode steps, stays >= 1e-3 from tau (checked below)
    prompt = np.random.default_rng(20).integers(0, cfg.vocab_size, (1, 128))
    steps, tau, k_sel = 16, cfg.wgkv.tau, 2
    composed = I.DecodeOptions(selection_policy=f"quest:{k_sel}",
                               evict_hard_budget=64)

    def run(device: str, opts):
        params = params_from_numpy(path, cfg, device)
        with torch.no_grad():
            out, caches = I.prefill(params, cfg,
                                    torch.as_tensor(prompt, device=device),
                                    opts=opts)
            toks, logits, caches, st = greedy_decode(
                params, cfg, out.logits, caches, steps, opts)
        trig = sum(float(x["evict_trigger_rows"].sum()) for x in st)
        return out, toks.cpu(), logits.cpu(), caches, trig

    def compare(tag, opts, cpu, want_counts):
        torch.cuda.synchronize()
        reset_counts()
        gpu = run("cuda", opts)
        torch.cuda.synchronize()
        counts = read_counts()
        cpu_out, cpu_toks, cpu_logits, cpu_caches, cpu_trig = cpu
        gpu_out, gpu_toks, gpu_logits, gpu_caches, gpu_trig = gpu
        check(all(counts[k] == v for k, v in want_counts.items()),
              f"substrate{tag}: the card run missed its kernels: {counts}")
        check(torch.equal(gpu_toks, cpu_toks),
              f"substrate{tag}: greedy tokens differ: {gpu_toks.tolist()} "
              f"vs {cpu_toks.tolist()}")
        err = float((gpu_logits - cpu_logits).abs().max())
        check(err <= 1e-4, f"substrate{tag}: logits differ by {err:.3e} > "
              "1e-4")
        check(torch.equal(gpu_caches["t"].cpu(), cpu_caches["t"]),
              f"substrate{tag}: t differs")
        gnode, cnode = gpu_caches["blocks"]["b0"], cpu_caches["blocks"]["b0"]
        for name in ("t", "ptr", "lpos", "gpos", "gcnt", "overflow"):
            check(torch.equal(getattr(gnode, name).cpu(),
                              getattr(cnode, name)),
                  f"substrate{tag}: cache {name} differs between card and "
                  "CPU")
        check(gpu_trig == cpu_trig, f"substrate{tag}: eviction triggers "
              f"{gpu_trig} (CPU {cpu_trig})")
        adm = float(gpu_out.mean_admission)
        check(abs(adm - float(cpu_out.mean_admission)) <= 1e-6
              and 0 < adm < 1,
              f"substrate{tag}: mean_admission {adm} (CPU "
              f"{float(cpu_out.mean_admission)})")
        return {"mean_admission": adm, "max_logit_err": err,
                "tokens": gpu_toks[0].tolist(),
                "gcnt": gnode.gcnt[:, 0].tolist(), "evict_triggers": gpu_trig,
                "launches": counts}

    scores, gaps = [], []
    inner_gate, inner_topk = ops.write_gate, SEL.topk_page_ids

    def recording(*a, **kw):
        g = inner_gate(*a, **kw)
        scores.append(g)
        return g

    def topk_gap(q, meta, k):
        # gap between the K-th and (K+1)-th page upper bound (inf where
        # fewer than K+1 pages hold tokens): a near-tie could flip the pick
        srt = torch.sort(SEL.page_upper_bound(q, meta), dim=-1,
                         descending=True).values
        gap = srt[..., k - 1] - srt[..., k]
        gaps.append(float(torch.where(torch.isfinite(srt[..., k]), gap,
                                      torch.full_like(gap, float("inf")))
                          .min()))
        return inner_topk(q, meta, k)
    ops.write_gate, SEL.topk_page_ids = recording, topk_gap
    try:
        cpu_plain = run("cpu", I.DecodeOptions())
        n_plain = len(scores)
        cpu_comp = run("cpu", composed)
    finally:
        ops.write_gate, SEL.topk_page_ids = inner_gate, inner_topk
    margin = min(float((g - tau).abs().min()) for g in scores[:n_plain])
    check(margin >= 1e-3, f"substrate: gate margin {margin:.2e} < 1e-3 "
          "(pick another prompt seed)")
    # the composed run decodes other tokens, so it sees other gate scores;
    # card and CPU gates agree to about 1e-6 (logits to 1e-5), so a margin
    # of 1e-4 still cannot flip an admission
    margin_comp = min(float((g - tau).abs().min())
                      for g in scores[n_plain:])
    check(margin_comp >= 1e-4, f"substrate: composed-run gate margin "
          f"{margin_comp:.2e} < 1e-4")
    check(cpu_comp[4] > 0, "substrate: eviction never triggered")
    n = cfg.n_layers
    plain = compare("", I.DecodeOptions(), cpu_plain,
                    {"vertical_slash": n, "paged_decode": n * steps,
                     "paged_decode_selected": 0})
    comp = compare(" (quest:2 + eviction)", composed, cpu_comp,
                   {"vertical_slash": n, "paged_decode": 0,
                    "paged_decode_selected": n * steps})
    stats = {"prompt_len": prompt.shape[1], "decode_steps": steps,
             "tau_margin": margin, **plain,
             "composed": {"selection": composed.selection_policy,
                          "evict_hard_budget": composed.evict_hard_budget,
                          "tau_margin": margin_comp,
                          "min_topk_ub_gap": min(gaps), **comp}}
    print("substrate: " + json.dumps(stats))
    return comp["launches"]


def _serve_until_decoding(sess, eng, handles, verify: bool):
    """Tick ``sess`` to the end; once every handle decodes, settle the
    mirror and, on a paged backend with ``verify``, check the physical
    pool (``verify_paged``, one ``paged_decode`` launch). Returns the
    deviation (None when not checked)."""
    dev = None
    for _ in range(100_000):
        if not sess.tick():
            break
        if verify and dev is None and all(h.state == "decode"
                                          for h in handles):
            sess.orchestrator.drain()
            dev = eng.verify_paged()
    sess.run()
    return dev


def sentinels_phase(card: str):
    """A serve-cli-sized mix on the card under both run-time sentinels:
    reduced qwen3-0.6b (f32, random weights), 4 slots, chunked prefill
    (chunk 64) of prompts past the 256-token ring and short ones, decode
    ticks, dispatch-ahead 1; once as served, under the work counter
    (its counted launches must equal the launch counters'), and once with
    ``quest:2`` decode selection. ``SyncSentinel`` runs the dispatch
    window under ``torch.cuda.set_sync_debug_mode("error")``: a sync
    inside dispatch, or between dispatch and collect outside the
    sanctioned methods, raises. ``CompileSentinel`` holds the step shapes
    to ``Engine.COMPILE_SHAPE_BUDGETS``."""
    import numpy as np
    import torch
    from repro_torch.analysis import CompileSentinel, SyncSentinel
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  SchedulerConfig)
    cfg = get_reduced_config("qwen3-0.6b").replace(dtype="float32")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(9),
                        "cuda")
    from repro_torch.roofline.counter import WorkCounter
    rng = np.random.default_rng(40)
    lens, max_new = (300, 290, 40, 120, 17), 8
    out = {}
    # the served mix, under the work counter, then with quest:2: the
    # counter reads shapes only, so the sync debug mode "error" still sees
    # no sync in dispatch
    for selection, tag in ((None, "full"), ("quest:2", "quest:2")):
        eng = make_backend("wgkv", params, cfg, slots=4, capacity=512,
                           pool_pages=1024, selection=selection,
                           device="cuda")
        orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                       dispatch_ahead=1))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        wc = WorkCounter() if tag == "full" else None
        with CompileSentinel(eng) as cs, SyncSentinel(eng) as ss, \
                wc or contextlib.nullcontext():
            rids = [orch.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                                max_new=max_new) for n in lens]
            orch.run()
            shapes = cs.check()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(ss.cuda, "sentinels: the engine is not on the card")
        toks = [orch.tokens(r) for r in rids]
        check(all(len(t) == max_new for t in toks),
              f"sentinels {tag}: not every request returned {max_new} "
              f"tokens: {[len(t) for t in toks]}")
        check(shapes["fused_step"] == (1 if selection else 2)
              and shapes["extend_batch"] == 0
              and shapes.get("fused_step_sel", 0) == (1 if selection else 0),
              f"sentinels {tag}: step shapes {shapes}")
        check(ss.syncs_in_collect > 0, f"sentinels {tag}: collect pulled "
              "nothing")
        if selection:
            check(counts["paged_decode_selected"] > 0,
                  f"sentinels {tag}: no selected read ({counts})")
        out[tag] = {"compiled_shape_counts": shapes,
                    "syncs_in_collect": ss.syncs_in_collect,
                    "sync_debug_mode": "error", "wall_s": wall,
                    "work_counter": wc is not None, "launches": counts}
        if wc is not None:
            counted = {k: v["launches"]
                       for k, v in wc.record()["kernels"].items()}
            check(counted == {k: v for k, v in counts.items() if v},
                  f"sentinels {tag}: counted launches {counted} != the "
                  f"launch counters' {counts}")
            out[tag]["counted_launches"] = counted
    # the sentinel is not a no-op on the card: a sync that no patched
    # call shows (a tensor's truth value) raises inside the window
    eng = make_backend("wgkv", params, cfg, slots=4, capacity=512,
                       mirror_paged=False, device="cuda")
    task = eng.start_prefill(list(range(2, 40)))
    task.slot = 0
    tripped = None
    with SyncSentinel(eng):
        step = eng.step_batch([task], 64)
        try:
            bool((step.tokens >= 0).all())
        except RuntimeError as exc:
            tripped = str(exc).splitlines()[0][:120]
        eng.collect(step)
    check(tripped is not None, "sentinels: an implicit sync in the "
          "dispatch window did not raise")
    out["implicit_sync_raised"] = tripped
    print("sentinels: " + json.dumps(out), flush=True)
    return {k: v["launches"] for k, v in out.items() if k in ("full",
                                                             "quest:2")}


def legacy_loop_phase():
    """The reference's fixed-slot loop, ``Engine.add_request`` / ``run``,
    on the card and on the CPU with the trained substrate: 2 slots, three
    prompts (the third waits for a slot), 8 new tokens each. The token
    streams and the step-shape counts must be equal."""
    import numpy as np
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.backend import make_backend
    cfg = substrate_cfg()
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (70, 33, 48)]

    def run(device):
        eng = make_backend("wgkv", params_from_numpy(SUBSTRATE, cfg, device),
                           cfg, slots=2, capacity=128, pool_pages=512,
                           device=device)
        for p in prompts:
            eng.add_request(p, max_new=8)
        eng.run(max_steps=64)
        return ([eng.requests[r].out for r in range(len(prompts))],
                eng.compiled_shape_counts(), eng.verify_paged())
    cpu_toks, cpu_shapes, _ = run("cpu")
    torch.cuda.synchronize()
    reset_counts()
    gpu_toks, gpu_shapes, dev = run("cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    check(gpu_toks == cpu_toks, f"legacy-loop: streams differ: {gpu_toks} "
          f"vs {cpu_toks}")
    check(all(len(t) == 8 for t in gpu_toks), "legacy-loop: short streams")
    check(gpu_shapes == cpu_shapes, f"legacy-loop: step shapes "
          f"{gpu_shapes} vs {cpu_shapes}")
    check(counts["paged_decode"] > 0 and counts["gate_mlp"] > 0,
          f"legacy-loop: the card run missed its kernels: {counts}")
    stats = {"tokens": gpu_toks, "compiled_shape_counts": gpu_shapes,
             "verify_paged": dev, "launches": counts}
    print("legacy-loop: " + json.dumps(stats), flush=True)
    return counts


MESH_SLOTS, MESH_CAP, MESH_NEW, MESH_LENS = 2, 256, 6, (24, 32, 40)


def mesh_drive(eng, sentinels: bool):
    """The mesh phase's three prompts through ``eng`` (chunk 16,
    dispatch-ahead 1): (tokens, positions stepped, launches, wall,
    step shapes or None)."""
    import numpy as np
    import torch
    from repro_torch.analysis import CompileSentinel, SyncSentinel
    from repro_torch.serving.orchestrator import (Orchestrator,
                                                  SchedulerConfig)
    rng = np.random.default_rng(47)
    vocab = eng.cfg.vocab_size
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=16,
                                                   dispatch_ahead=1))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with position_counter() as pc, CompileSentinel(eng) as cs, \
            (SyncSentinel(eng) if sentinels else contextlib.nullcontext()):
        rids = [orch.submit(rng.integers(0, vocab - 8, n).tolist(),
                            max_new=MESH_NEW) for n in MESH_LENS]
        orch.run()
        shapes = cs.check()
    torch.cuda.synchronize()
    return ([orch.tokens(r) for r in rids], pc.count, read_counts(),
            time.perf_counter() - t0, shapes)


# the mesh phase's depth: 14 of qwen3-0.6b's 28 layers (its gloo ranks'
# serve stages every layer's sums through the host)
MESH_LAYERS = 14


def mesh_model(device):
    """Full-width qwen3-0.6b cut to :data:`MESH_LAYERS` layers, f32,
    weights drawn on ``device`` from seed 46 (every rank draws the
    same)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("qwen3-0.6b").replace(dtype="float32",
                                           n_repeats=MESH_LAYERS)
    gen = torch.Generator(device=device).manual_seed(46)
    return cfg, init_model(cfg, gen, device)


def host_leaves(tree) -> dict:
    from repro_torch.tree import tree_leaves_with_path
    return {tuple(str(k) for k in p): x.cpu().numpy()
            for p, x in tree_leaves_with_path(tree)}


def mesh_rank(mesh):
    """One rank of the mesh phase's 1 x 2 run: its shard of the model,
    the drive (no ``SyncSentinel``: gloo stages CUDA tensors through the
    host), and what the parent checks."""
    import torch
    from repro_torch.roofline.counter import WorkCounter
    from repro_torch.serving.backend import make_backend
    cfg, params = mesh_model(mesh.device)
    eng = make_backend("wgkv", params, cfg, slots=MESH_SLOTS,
                       capacity=MESH_CAP, mirror_paged=False, mesh=mesh,
                       device="cuda")
    del params
    torch.cuda.empty_cache()
    # the work counter is the one tally of the collectives' bytes (aten
    # ops not counted: the drive's wall stays the drive's)
    with WorkCounter(aten=False) as wc:
        toks, positions, counts, wall, shapes = mesh_drive(eng,
                                                           sentinels=False)
    from repro_torch.launch.specs import cache_tree_bytes
    return {"tokens": toks, "positions": positions, "launches": counts,
            "wall_s": wall, "shapes": shapes,
            "cache_bytes": cache_tree_bytes(eng.caches),
            "fused_steps": int(eng.stats["fused_steps"]),
            "collective_bytes": wc.record()["collective_bytes_by_axis"],
            "kv_heads": eng.plan.kv_heads,
            "caches": host_leaves(eng.caches)}


def mesh_phase(card: str):
    """Sharded serving on the card, full-width qwen3-0.6b (14 of 28 layers,
    f32, seeded weights), three prompts of 24-40 tokens, 6 new tokens each, 2
    slots, dispatch-ahead 1:

    (a) the flat port on ``cuda``, the yardstick;
    (b) a 1 x 1 mesh over NCCL (a world of one, the production backend's
        path): tokens equal (a)'s, under both sentinels (sync debug mode
        "error" in the dispatch window);
    (c) a 1 x 2 mesh whose two ranks share the card over gloo: tokens
        equal (a)'s, each rank's integer cache state equals its head
        slice of (a)'s and its floats are within 1e-4, each rank
        launches a ``gate_mlp`` and a ``paged_decode`` a layer and
        position step, and the collective bytes each rank counts equal
        the prediction: per layer and position step 2 sums of [2, 1,024]
        f32 over "model" (ring
        all-reduce over 2: 2 x bytes x 1/2), and per fused step one
        [5, 2] f32 sum of the sampled tokens and stats. ``SyncSentinel``
        is exempt there: gloo stages CUDA tensors through the host.
    Times on the one-card gloo mesh measure host staging, not NVLink."""
    import numpy as np
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.launch.specs import cache_tree_bytes
    from repro_torch.serving.backend import make_backend
    cfg, params = mesh_model("cuda")
    n = cfg.n_layers
    out, counts_by = {}, {}
    # (a) flat
    eng = make_backend("wgkv", params, cfg, slots=MESH_SLOTS,
                       capacity=MESH_CAP, mirror_paged=False, device="cuda")
    toks, positions, counts, wall, shapes = mesh_drive(eng, sentinels=True)
    flat_caches = host_leaves(eng.caches)
    flat_bytes = cache_tree_bytes(eng.caches)
    check(all(len(t) == MESH_NEW for t in toks), f"mesh flat: {toks}")
    check(counts["gate_mlp"] == n * positions
          and counts["paged_decode"] == n * positions,
          f"mesh flat: {counts} for {positions} positions")
    out["flat"] = {"tokens": toks, "positions": positions, "wall_s": wall,
                   "shapes": shapes, "cache_bytes": flat_bytes}
    counts_by["flat"] = counts
    del eng
    free_cuda()
    # (b) a 1 x 1 mesh over NCCL, in this process
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = M.init_mesh((1, 1), backend="nccl", device="cuda")
        eng = make_backend("wgkv", params, cfg, slots=MESH_SLOTS,
                           capacity=MESH_CAP, mirror_paged=False, mesh=mesh,
                           device="cuda")
        check(eng.capabilities().sharded, "mesh 1x1: not sharded")
        toks1, pos1, counts1, wall1, shapes1 = mesh_drive(eng,
                                                          sentinels=True)
        del eng
    finally:
        dist.destroy_process_group()
    check(toks1 == toks, f"mesh 1x1: tokens {toks1} != flat {toks}")
    check(counts1 == counts, f"mesh 1x1: launches {counts1} != {counts}")
    out["1x1 nccl"] = {"positions": pos1, "wall_s": wall1,
                       "shapes": shapes1, "sync_debug_mode": "error"}
    counts_by["1x1 nccl"] = counts1
    del params
    free_cuda()
    # (c) 1 x 2 over gloo, both ranks on this card
    t0 = time.perf_counter()
    ranks = M.spawn(mesh_rank, (1, 2), backend="gloo", device="cuda",
                    timeout_s=600)
    spawn_wall = time.perf_counter() - t0
    d = cfg.d_model
    for r, res in sorted(ranks.items()):
        tag = f"1x2 gloo rank {r}"
        check(res["tokens"] == toks, f"{tag}: tokens {res['tokens']} != "
              f"flat {toks}")
        p = res["positions"]
        check(res["launches"]["gate_mlp"] == n * p
              and res["launches"]["paged_decode"] == n * p,
              f"{tag}: {res['launches']} for {p} positions")
        want = {"model": p * 2 * n * 2 * (MESH_SLOTS * d * 4) // 2,
                "world": res["fused_steps"] * 2 * (5 * MESH_SLOTS * 4) // 2}
        check(res["collective_bytes"] == want,
              f"{tag}: collective bytes {res['collective_bytes']} != "
              f"predicted {want}")
        h0, nh = res["kv_heads"]
        worst, ints = 0.0, 0
        for path, mine in res["caches"].items():
            full = flat_caches[path]
            ax = 1 if "blocks" in path else 0
            if mine.ndim > ax + 1 and mine.shape[ax + 1] != full.shape[ax + 1]:
                full = np.take(full, range(h0, h0 + nh), axis=ax + 1)
            check(mine.shape == full.shape, f"{tag}: {path} {mine.shape} "
                  f"vs {full.shape}")
            if np.issubdtype(full.dtype, np.integer):
                check(np.array_equal(mine, full), f"{tag}: {path} differs")
                ints += 1
            else:
                worst = max(worst, float(np.abs(mine - full).max()))
        check(worst <= 1e-4, f"{tag}: cache floats differ by {worst}")
        # the per-head leaves halve; t, ptr and lpos are every rank's
        share = res["cache_bytes"] / flat_bytes
        check(0.5 <= share < 0.51, f"{tag}: cache bytes {res['cache_bytes']}"
              f" of the flat run's {flat_bytes}")
        out[tag] = {"positions": p, "wall_s": res["wall_s"],
                    "shapes": res["shapes"],
                    "collective_bytes": res["collective_bytes"],
                    "collective_bytes_predicted": want,
                    "collective_bytes_per_position_step":
                        res["collective_bytes"]["model"] / p,
                    "nvlink_us_per_position_step_at_450GB_s":
                        res["collective_bytes"]["model"] / p / 450e9 * 1e6,
                    "cache_int_leaves_equal": ints,
                    "cache_float_max_abs_err": worst,
                    "cache_bytes": res["cache_bytes"],
                    "cache_bytes_share_of_flat": share,
                    "sync_sentinel": "exempt: gloo stages CUDA tensors "
                                     "through the host"}
        counts_by[tag] = res["launches"]
    out["1x2 gloo"] = {"spawn_wall_s": spawn_wall, "ranks_per_card": 2,
                       "note": "two ranks share one card over gloo: its "
                               "times measure host staging, not NVLink"}
    print("mesh: " + json.dumps({"card": card, "layers": n,
                                 "slots": MESH_SLOTS, "capacity": MESH_CAP,
                                 "prompt_lens": MESH_LENS,
                                 "max_new": MESH_NEW, "runs": out}),
          flush=True)
    return counts_by


def serve_ab(card: str):
    """The serving A/B at full width (depth cut to ``SERVE_REPEATS`` of
    28 layers): the same 2 x 384-token prompts and 16 new tokens
    through ``ServeSession`` over ``wgkv`` then ``dense``, then one of
    them through ``streaming_llm`` and ``duo``. Per backend: TTFT, TPOT,
    tokens/s, the KV-token peak and resident KV bytes (logical, and the
    device buffers of the batched tree plus the pool's pages). ``dense``
    must run only ``paged_decode`` (never the gate), the static
    backends never the gate; the paged backends' pools verify."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.launch.specs import cache_tree_bytes
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession

    slots, cap, prompt_len, max_new = 2, 512, 384, 16
    cfg = get_config("qwen3-0.6b").replace(dtype="float32",
                                           n_repeats=SERVE_REPEATS)
    gen = torch.Generator(device="cuda").manual_seed(15)
    params = init_model(cfg, gen, "cuda")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size - 8, prompt_len).tolist()
               for _ in range(2)]
    n = cfg.n_layers
    out, counts_by = {}, {}
    for name, n_req in (("wgkv", 2), ("dense", 2), ("streaming_llm", 1),
                        ("duo", 1)):
        eng = make_backend(name, params, cfg, slots=slots, capacity=cap,
                           pool_pages=pool_pages_for(cfg, slots, cap),
                           device="cuda")
        paged = eng.capabilities().paged
        sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=64,
                                                       dispatch_ahead=1))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with position_counter() as pc:
            handles = [sess.submit(p, max_new=max_new)
                       for p in prompts[:n_req]]
            dev = _serve_until_decoding(sess, eng, handles, paged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        summ = sess.telemetry.summary()
        buf_bytes = cache_tree_bytes(eng.caches)
        pool_bytes = (summ["pool_pages_peak"] or 0) * 16 * cfg.head_dim * 2 * 4
        sess.close()
        check(all(h.state == "done" and len(h.tokens()) == max_new
                  for h in handles),
              f"serve-ab {name}: requests incomplete: "
              f"{[(h.state, len(h.tokens())) for h in handles]}")
        verified = 1 if dev is not None else 0
        check(counts["paged_decode"] == n * pc.count + verified,
              f"serve-ab {name}: paged_decode launches "
              f"{counts['paged_decode']} != {n} x {pc.count} positions + "
              f"{verified} verify")
        gate_want = n * pc.count if name == "wgkv" else 0
        check(counts["gate_mlp"] == gate_want,
              f"serve-ab {name}: gate_mlp launches {counts['gate_mlp']} != "
              f"{gate_want}")
        check(counts["gated_flash"] == 0 and counts["vertical_slash"] == 0,
              f"serve-ab {name}: unexpected prefill kernels {counts}")
        if paged:
            check(dev is not None and dev < 2e-3,
                  f"serve-ab {name}: paged-vs-logical deviation {dev}")
        out[name] = {
            "requests": n_req, "wall_s": wall, "positions": pc.count,
            "ttft_mean_s": summ["ttft_mean_s"],
            "tpot_mean_s": summ["tpot_mean_s"],
            "tokens_per_s": summ["tokens_per_s"],
            "mean_admission": summ["mean_admission"],
            "kv_tokens_peak": summ["kv_tokens_peak"],
            "kv_bytes_peak": summ["kv_bytes_peak"],
            "cache_buffer_bytes": buf_bytes, "pool_bytes_peak": pool_bytes,
            "pool_pages_peak": summ["pool_pages_peak"], "paged_dev": dev,
            "launches": counts}
        counts_by[name] = counts
        del eng, sess
        free_cuda()
    ratio = out["wgkv"]["kv_tokens_peak"] / out["dense"]["kv_tokens_peak"]
    check(out["dense"]["mean_admission"] == 1.0,
          f"serve-ab: dense admission {out['dense']['mean_admission']}")
    stats = {"card": card, "layers": n, "slots": slots, "capacity": cap,
             "prompt_len": prompt_len, "max_new": max_new,
             "backends": out, "kv_tokens_peak_wgkv_over_dense": ratio,
             "note": "random gates admit nearly every token, so this "
                     "memory ratio says nothing about the paper's claim"}
    print("serve-ab: " + json.dumps(stats), flush=True)
    return counts_by


def prefill_dense(cfg, params, long_stats):
    """``inference.prefill(use_wgkv=False)`` of prefill-long's 4096-token
    prompt at full width and depth (causal attention through
    ``gated_flash`` at W = S, a dense cache of 4160 slots per layer), then
    16 greedy dense ``decode_step``s (one-segment ``paged_decode``)."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import cache_tree_bytes
    from repro_torch.models import inference as I
    s, steps, n = 4096, 16, cfg.n_layers
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, use_wgkv=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, logits, dec, _ = greedy_decode(params, cfg, out.logits, caches,
                                          steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    node = dec["blocks"]["b0"]
    check(counts["gated_flash"] == n,
          f"prefill-dense: gated_flash launches {counts['gated_flash']} != "
          f"{n}")
    check(counts["paged_decode"] == n * steps,
          f"prefill-dense: paged_decode launches {counts['paged_decode']} "
          f"!= {n} x {steps}")
    check(counts["gate_mlp"] == 0 and counts["vertical_slash"] == 0,
          f"prefill-dense: WG-KV kernels ran: {counts}")
    check(tuple(node.k.shape) == (n, 1, cfg.n_kv_heads, 4160, cfg.head_dim)
          and bool((node.t == s + steps).all()),
          f"prefill-dense: cache {tuple(node.k.shape)} t "
          f"{node.t.unique().tolist()}")
    check(bool(torch.isfinite(logits).all()), "prefill-dense: non-finite "
          "logits")
    stats = {"prompt_len": s, "decode_steps": steps,
             "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "wgkv_prefill_ms": long_stats["prefill_ms"],
             "wgkv_decode_ms_per_step": long_stats["decode_ms_per_step"],
             "dense_cache_gib": cache_tree_bytes(caches["blocks"]) / 2 ** 30,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print("prefill-dense: " + json.dumps(stats), flush=True)
    return counts


def prefix_phase(card: str):
    """A multi-turn replay at full width (depth cut to 4 of 28 layers):
    2 conversations x 2 turns, chunk 64, a first prompt of 264 tokens
    (past the 256-token ring, so the global segment holds tokens), each
    turn adding the 16-token reply and 48 user tokens (one chunk), so
    turn 2 resumes from the stored 256-token prefix. For ``wgkv`` and
    ``dense``: cold (no store) and through the store; hit streams equal
    cold streams, the hit rate is above 0, a hit row's pool verifies
    mid-decode (wgkv), and every page is reclaimed after the store is
    cleared."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pool_pages_for
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession
    from repro_torch.serving.prefix_cache import PrefixCache

    slots, cap, chunk, plen, mnew, user = 2, 512, 64, 264, 16, 48
    cfg = get_config("qwen3-0.6b").replace(dtype="float32", n_repeats=4)
    gen = torch.Generator(device="cuda").manual_seed(16)
    params = init_model(cfg, gen, "cuda")
    n = cfg.n_layers

    def turns(eng, pc, verify):
        rng = np.random.default_rng(16)
        prompts = [rng.integers(0, cfg.vocab_size - 8, plen).tolist()
                   for _ in range(2)]
        streams, devs = [], []
        for turn in range(2):
            sess = ServeSession(eng, sched=SchedulerConfig(
                chunk_tokens=chunk, dispatch_ahead=1), prefix_cache=pc)
            hs = [sess.submit(p, max_new=mnew) for p in prompts]
            # turn 2's rows resume from stored prefixes: verify them
            dev = _serve_until_decoding(sess, eng, hs, verify and turn == 1)
            if dev is not None:
                check(all(r.prefix_hit for r in sess.telemetry.records),
                      "prefix: a turn-2 request missed the store")
                devs.append(dev)
            sess.close()
            outs = [h.tokens() for h in hs]
            streams.append(outs)
            prompts = [p + o + rng.integers(0, cfg.vocab_size - 8,
                                            user).tolist()
                       for p, o in zip(prompts, outs)]
        return streams, devs

    out, counts_by = {}, {}
    for name in ("wgkv", "dense"):
        # the pool holds the slots and the store's entries (up to 4)
        eng = make_backend(name, params, cfg, slots=slots, capacity=cap,
                           pool_pages=pool_pages_for(cfg, slots + 4, cap),
                           device="cuda")
        paged = eng.capabilities().paged
        cold, _ = turns(eng, None, False)
        pc = PrefixCache(quantum=chunk, free_fn=eng.release_prefix)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with position_counter() as pcnt:
            warm, devs = turns(eng, pc, paged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        hit_rate = pc.hits / max(pc.hits + pc.misses, 1)
        check(warm == cold, f"prefix {name}: hit streams differ from cold")
        check(pc.hits > 0 and hit_rate > 0, f"prefix {name}: no hit "
              f"({pc.hits} hits, {pc.misses} misses)")
        verified = len(devs)
        if paged:
            check(verified > 0 and max(devs) < 2e-3,
                  f"prefix {name}: hit-row pool deviation {devs}")
        check(counts["paged_decode"] == n * pcnt.count + verified,
              f"prefix {name}: paged_decode launches "
              f"{counts['paged_decode']} != {n} x {pcnt.count} + {verified}")
        check(counts["gate_mlp"] == (n * pcnt.count if name == "wgkv"
                                     else 0),
              f"prefix {name}: gate_mlp launches {counts['gate_mlp']}")
        stats = {"hits": pc.hits, "misses": pc.misses, "hit_rate": hit_rate,
                 "inserts": pc.inserts, "store_bytes": pc.bytes_used,
                 "positions_warm": pcnt.count, "wall_warm_s": wall,
                 "paged_dev_hit_rows": devs, "launches": counts}
        pc.clear()
        check(len(pc) == 0 and pc.bytes_used == 0,
              f"prefix {name}: the store kept entries after clear")
        if paged:
            check(eng.pool.pages_in_use == 0,
                  f"prefix {name}: {eng.pool.pages_in_use} pool pages left "
                  "after the store was cleared")
        out[name] = stats
        counts_by[name] = counts
    print("prefix: " + json.dumps({"card": card, "layers": n,
                                   "chunk": chunk, "backends": out}),
          flush=True)
    return counts_by


def substrate_ab():
    """The trained substrate served by ``dense``, ``streaming_llm`` and
    ``duo`` on the card (kernels) and on the CPU (plain path): two numpy
    prompts (128 and 60 tokens, past the 16-token ring), 8 new tokens,
    chunk 32. Greedy streams, resident KV tokens tick by tick and every
    integer cache leaf must be identical."""
    import numpy as np
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.backend import make_backend
    from repro_torch.serving.orchestrator import SchedulerConfig, ServeSession
    from repro_torch.tree import tree_leaves_with_path
    path = SUBSTRATE
    cfg = substrate_cfg()
    prompts = [np.random.default_rng(20).integers(0, 256, 128).tolist(),
               np.random.default_rng(21).integers(0, 256, 60).tolist()]

    def run(name, device):
        params = params_from_numpy(path, cfg, device)
        eng = make_backend(name, params, cfg, slots=2, capacity=192,
                           pool_pages=512, device=device)
        sess = ServeSession(eng, sched=SchedulerConfig(chunk_tokens=32))
        hs = [sess.submit(p, max_new=8) for p in prompts]
        kv = []
        with position_counter() as pc:
            while sess.tick():
                sess.orchestrator.drain()
                kv.append(eng.memory_snapshot()["kv_tokens"])
            sess.run()
        sess.close()
        ints = {p: x.cpu() for p, x in tree_leaves_with_path(eng.caches)
                if not x.is_floating_point()}
        return [h.tokens() for h in hs], kv, ints, pc.count

    out, counts_by = {}, {}
    for name in ("dense", "streaming_llm", "duo"):
        cpu = run(name, "cpu")
        torch.cuda.synchronize()
        reset_counts()
        gpu = run(name, "cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        n = cfg.n_layers
        check(gpu[0] == cpu[0], f"substrate-ab {name}: streams differ: "
              f"{gpu[0]} vs {cpu[0]}")
        check(gpu[1] == cpu[1], f"substrate-ab {name}: KV tokens per tick "
              "differ")
        check(gpu[2].keys() == cpu[2].keys() and all(
            torch.equal(gpu[2][k], cpu[2][k]) for k in cpu[2]),
            f"substrate-ab {name}: integer cache state differs")
        check(counts["paged_decode"] == n * gpu[3]
              and counts["gate_mlp"] == 0 and counts["gated_flash"] == 0,
              f"substrate-ab {name}: launches {counts} over {gpu[3]} "
              "positions")
        out[name] = {"tokens": gpu[0], "kv_tokens_peak": max(gpu[1]),
                     "int_leaves": len(cpu[2]), "positions": gpu[3],
                     "launches": counts}
        counts_by[name] = counts
    print("substrate-ab: " + json.dumps(out), flush=True)
    return counts_by


def train_card_vs_cpu(tag: str, cfg, cpu_params, token_seed: int,
                      min_margin: float):
    """Three ``train_step``s of ``cpu_params`` (a CPU tree, copied to the
    card) from the same numpy tokens (3 batches of 2 x 128) on the card
    (kernels) and on the CPU (plain path): every step's loss and aux
    within 1e-4 relative, distill not 0, and the gate gradients of the
    first within 1e-4 of the largest magnitude of each CPU gradient; on
    the card, ``remat=True`` gives those gradients bit for bit, and the
    kernels launch as ``train_launches`` says for four gradient
    evaluations. Every gate score must sit ``min_margin`` from tau, so
    the admission rate cannot flip between the devices."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training import trainer as TR
    from repro_torch.tree import tree_map
    rng = np.random.default_rng(token_seed)
    toks = [rng.integers(0, cfg.vocab_size - 8, (2, 128)).astype(np.int32)
            for _ in range(3)]

    def run(device):
        params = tree_map(lambda x: x.to(device), cpu_params)
        batches = [{"tokens": torch.as_tensor(t, device=device)}
                   for t in toks]
        state = TR.init_train_state(params)
        _, _, grads = TR.loss_and_grads(state.gates, params, cfg, batches[0],
                                        lam=cfg.wgkv.lam)
        metrics = []
        for b in batches:
            state, m = TR.train_step(state, params, cfg, b, lr=1e-3)
            metrics.append({k: float(v) for k, v in m.items()})
        return {k: v.cpu() for k, v in grads.items()}, metrics, params, \
            batches[0]

    scores = []
    inner = ops.write_gate

    def recording(*a, **kw):
        g = inner(*a, **kw)
        scores.append(g.detach())
        return g
    ops.write_gate = recording
    try:
        cpu_grads, cpu_metrics, _, _ = run("cpu")
    finally:
        ops.write_gate = inner
    margin = min(float((g - cfg.wgkv.tau).abs().min()) for g in scores)
    check(margin >= min_margin, f"{tag}: gate margin {margin:.2e} < "
          f"{min_margin}")
    torch.cuda.synchronize()
    reset_counts()
    gpu_grads, gpu_metrics, params, batch = run("cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    # remat: each block's forward, lse included, runs again inside the
    # backward; the kernels are deterministic, so the gradients must be
    # the same bits (outside the counted run)
    _, _, remat_grads = TR.loss_and_grads(TR.get_gates(params), params, cfg,
                                          batch, lam=cfg.wgkv.lam, remat=True)
    check(all(torch.equal(remat_grads[k].cpu(), gpu_grads[k])
              for k in gpu_grads), f"{tag}: remat=True changed the gate "
          "gradients")
    want = {k: 4 * v for k, v in train_launches(cfg).items()}
    check(counts == want, f"{tag}: launches {counts} != {want} (four "
          "gradient evaluations)")
    loss_err = 0.0
    for i, (gm, cm) in enumerate(zip(gpu_metrics, cpu_metrics)):
        check(set(gm) == set(cm), f"{tag}: metric keys {set(gm)}")
        for k in cm:
            err = abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)
            loss_err = max(loss_err, err)
            check(err <= 1e-4, f"{tag}: step {i} {k} {gm[k]} vs CPU {cm[k]} "
                  f"(relative {err:.2e} > 1e-4)")
    check(all(m["distill"] > 0 for m in cpu_metrics),
          f"{tag}: distill 0 {cpu_metrics}")
    grad_err = {k: rel_err(gpu_grads[k], cpu_grads[k]) for k in cpu_grads}
    check(max(grad_err.values()) <= 1e-4,
          f"{tag}: gate gradients differ {grad_err}")
    stats = {"layers": cfg.n_layers, "tau_margin": margin,
             "max_rel_metric_err": loss_err, "grad_rel_err": grad_err,
             "remat_grads_bitwise": True,
             "losses": [m["loss"] for m in gpu_metrics],
             "cpu_losses": [m["loss"] for m in cpu_metrics],
             "launches": counts}
    print(f"{tag}: " + json.dumps(stats), flush=True)
    return counts


def train_substrate():
    """``train_card_vs_cpu`` on the trained bench substrate. The tokens
    (seed 72) keep every gate score >= 1e-4 from tau."""
    from repro_torch.convert import params_from_numpy
    cfg = substrate_cfg()
    return train_card_vs_cpu("train-substrate", cfg,
                             params_from_numpy(SUBSTRATE, cfg, "cpu"), 72,
                             1e-4)


def device_kernel_ms(fn) -> tuple:
    """(device busy ms, the top kernels [name, ms, calls]) of one call of
    ``fn`` under torch.profiler: CUDA kernel self time summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    del out
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0.0)
              or getattr(e, "self_cuda_time_total", 0.0))
        ms, calls = per_kernel.get(e.key, (0.0, 0))
        per_kernel[e.key] = (ms + us / 1e3, calls + e.count)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return (sum(ms for ms, _ in per_kernel.values()),
            [[k[:60], ms, calls] for k, (ms, calls) in top])


class ExactWork:
    """While active, records the data-dependent counts of the
    ``paged_decode`` (no start offset) and ``vertical_slash`` calls the
    model makes through ``kernels.ops``: each read's valid tokens, each
    prefill's visible global keys. After a sync, :meth:`works` sums each
    kernel's exact work (``roofline.work`` given those counts) and
    calls."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.calls = ops, []
        self.inner = pd, vs = ops.paged_decode, ops.vertical_slash

        def paged(q, k_pool, v_pool, page_table, lengths, second=None,
                  **kw):
            if kw.get("starts") is None:
                self.calls.append(("paged_decode", tuple(q.shape),
                                   q.element_size(), kw.get("group", 1),
                                   page_table.shape[1], lengths, second))
            return pd(q, k_pool, v_pool, page_table, lengths, second, **kw)

        def vslash(q, k, v, kg, vg, gpos, *, w_local, group=1):
            self.calls.append(("vertical_slash", tuple(q.shape),
                               q.element_size(), group, kg.shape[1], gpos,
                               w_local))
            return vs(q, k, v, kg, vg, gpos, w_local=w_local, group=group)
        ops.paged_decode, ops.vertical_slash = paged, vslash
        return self

    def __exit__(self, *exc):
        self.ops.paged_decode, self.ops.vertical_slash = self.inner
        return False

    def works(self) -> dict:
        """{kernel: [calls, flops, bytes]} of this run's data."""
        import torch
        from repro_torch.roofline import work as W
        out = {}
        for name, shape, isz, grp, c, data, extra in self.calls:
            if name == "paged_decode":
                toks = int(torch.clamp(data, max=c * W.PAGE).sum())
                c2 = 0
                if extra is not None:
                    c2 = extra[2].shape[1]
                    toks += int(torch.clamp(extra[3], max=c2 * W.PAGE).sum())
                w = W.paged_decode(*shape, grp, c, c2, isz=isz, tokens=toks)
            else:
                gp = data.long()
                glob = int(torch.where(
                    gp < INT32_MAX, torch.clamp(shape[1] - (gp + extra),
                                                min=0),
                    torch.zeros_like(gp)).sum())
                w = W.vertical_slash(*shape, grp, c, extra, isz,
                                     global_pairs=glob)
            rec = out.setdefault(name, [0, 0, 0])
            rec[0] += 1
            rec[1] += w.flops
            rec[2] += w.bytes
        self.calls = []
        return out


def exact_cost(cost: dict, exact: dict) -> dict:
    """``cost`` (a counter's record) with each kernel in ``exact`` (of
    :meth:`ExactWork.works`, one entry per counted launch) counted from
    this run's data instead of its shapes."""
    flops, nbytes = dict(cost["flops"]), cost["bytes"]
    kernels = {k: dict(v) for k, v in cost["kernels"].items()}
    for name, (calls, f, b) in exact.items():
        k = kernels[name]
        check(calls == k["launches"], f"roofline: {calls} exact {name} "
              f"calls recorded for {k['launches']} launches")
        flops[k["rate"]] += f - k["flops"]
        nbytes += b - k["bytes"]
        k["flops"], k["bytes"] = f, b
    return {**cost, "flops": flops, "bytes": nbytes, "kernels": kernels}


def counted_split(cost: dict) -> dict:
    """The counted work split by kernel (each kernel's bound, ms) and by
    aten class: the matmuls (ops with a FLOP formula) by FLOPs and bytes,
    every other op by bytes."""
    from repro_torch.roofline.analysis import HBM_BYTES_PER_S, bound_s
    kernels = {k: {"launches": v["launches"],
                   "bound_ms": bound_s({v["rate"]: v["flops"]},
                                       v["bytes"])["bound_s"] * 1e3}
               for k, v in cost["kernels"].items()}
    mm = {k: v for k, v in cost["aten"].items() if v["flops"]}
    other = {k: v for k, v in cost["aten"].items() if not v["flops"]}
    mm_flops = {c: f - sum(v["flops"] for v in cost["kernels"].values()
                           if v["rate"] == c)
                for c, f in cost["flops"].items()}
    mm_bytes = sum(v["bytes"] for v in mm.values())
    other_bytes = sum(v["bytes"] for v in other.values())
    top_other = sorted(other.items(), key=lambda kv: -kv[1]["bytes"])[:6]
    return {"kernels": kernels,
            "aten_matmul": {"calls": sum(v["calls"] for v in mm.values()),
                            "flops": mm_flops, "bytes": mm_bytes,
                            "bound_ms": bound_s(mm_flops, mm_bytes)["bound_s"]
                            * 1e3},
            "aten_other": {"calls": sum(v["calls"] for v in other.values()),
                           "bytes": other_bytes,
                           "bound_ms": other_bytes / HBM_BYTES_PER_S * 1e3,
                           "top_by_bytes": [[k, v["calls"], v["bytes"]]
                                            for k, v in top_other]}}


def roofline_path(card: str, tag: str, arch: str, cfg, params, shape,
                  expect: dict, knob_overrides: dict | None = None,
                  caches: tuple | None = None) -> tuple:
    """One main path's step as a dry-run bundle (``launch.dryrun``): run
    on the meta device and on the card under the work counter, the two
    counts equal as integers (FLOPs by rate class, bytes, each kernel's
    launches, FLOPs and bytes), the card's launches equal to the launch
    counters' deltas and to ``expect``; then the same bundle timed on the
    card (wall, with each data-dependent kernel's exact work recorded,
    and device time under torch.profiler) beside its bound (from this
    run's data; the shapes-only bound beside it), the model-FLOP share
    and the predicted peak beside the measured. ``caches``: a decode
    step's (meta, card) caches, such as a prefill step's. Returns the
    record and the timed run's output."""
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.steps import make_bundle
    from repro_torch.roofline import analysis as A
    kw = dict(cfg_override=cfg, knob_overrides=knob_overrides)
    meta = D.run_dryrun(arch, shape, caches=caches and caches[0], **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = D.run_dryrun(arch, shape, device="cuda", params=params,
                       caches=caches and caches[1], **kw)
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    mc, cc = meta["cost"], got["cost"]
    diff = {k: (mc["aten"].get(k), cc["aten"].get(k))
            for k in set(mc["aten"]) | set(cc["aten"])
            if mc["aten"].get(k) != cc["aten"].get(k)}
    check(mc["flops"] == cc["flops"] and mc["bytes"] == cc["bytes"]
          and mc["kernels"] == cc["kernels"],
          f"roofline {tag}: meta and card counts differ: flops "
          f"{mc['flops']} / {cc['flops']}, bytes {mc['bytes']} / "
          f"{cc['bytes']}, kernels {mc['kernels']} / {cc['kernels']}, "
          f"aten ops that differ {str(diff)[:1500]}")
    launches = {k: v["launches"] for k, v in cc["kernels"].items()}
    check(launches == counts, f"roofline {tag}: counted launches "
          f"{launches} != the launch counters' {counts}")
    check(launches == expect, f"roofline {tag}: launches {launches} != "
          f"{expect}")
    bundle = make_bundle(cfg, shape, use_wgkv=meta["wgkv"], device="cuda",
                         params=params, caches=caches and caches[1],
                         knob_overrides=knob_overrides)
    torch.cuda.synchronize()
    with ExactWork() as ex:
        t0 = time.perf_counter()
        out = bundle.fn(*bundle.args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ec = exact_cost(cc, ex.works())
    device_ms, top = device_kernel_ms(lambda: bundle.fn(*bundle.args))
    del bundle
    shape_terms = A.roofline_terms(cc["flops"], cc["bytes"])
    terms = A.roofline_terms(ec["flops"], ec["bytes"])
    bound_s = max(terms["compute_s"], terms["memory_s"])
    mf = A.model_flops(cfg, shape)
    rec = {"card": card, "arch": arch,
           "shape": [shape.global_batch, shape.seq_len, shape.kind],
           "knobs": meta["knobs"], "flops": ec["flops"],
           "bytes": ec["bytes"], "launches": launches,
           "compute_ms": terms["compute_s"] * 1e3,
           "memory_ms": terms["memory_s"] * 1e3, "bound_ms": bound_s * 1e3,
           "bound_by": ("operations" if terms["compute_s"]
                        > terms["memory_s"] else "bytes"),
           "bound_ms_shapes": max(shape_terms["compute_s"],
                                  shape_terms["memory_s"]) * 1e3,
           "counted_flops": cc["flops"], "counted_bytes": cc["bytes"],
           "wall_ms": wall_s * 1e3, "device_ms": device_ms,
           "wall_over_bound": wall_s / bound_s,
           "device_over_bound": device_ms / 1e3 / bound_s,
           "model_flops": mf,
           "model_flop_share_at_67T": mf / (wall_s * A.F32_FLOPS),
           "model_flop_share_at_989T": mf / (wall_s * A.BF16_FLOPS),
           "predicted_peak_bytes": got["memory"]["peak_bytes"],
           "predicted_peak_bytes_meta": meta["memory"]["peak_bytes"],
           "measured_peak_bytes": peak,
           "total_memory_bytes":
               torch.cuda.get_device_properties(0).total_memory,
           "fits_one_h100": meta["memory"]["fits_one_h100"],
           "meta_run_s": meta["run_s"], "card_counted_run_s": got["run_s"],
           "split": counted_split(ec), "top_device_kernels_ms": top}
    print(f"roofline {tag} ({card}): " + json.dumps(rec), flush=True)
    return rec, out


def free_cuda():
    """Release what the previous phase left cached on the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def rg_serve(card: str):
    """``repro_torch.launch.serve --arch recurrentgemma-9b`` at full width:
    2 requests of 64 tokens, 8 new tokens, 2 slots, capacity 512, the
    startup tau probe (a gated forward through the hybrid) included. The
    CLI builds its own model and drops it when it returns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("recurrentgemma-9b")
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with position_counter() as pc:
        res = serve.main(["--arch", "recurrentgemma-9b", "--requests", "2",
                          "--prompt-len", "64", "--max-new", "8",
                          "--slots", "2", "--capacity", "512",
                          "--quiet-stream"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs = res["outputs"]
    summ = res["summary"]
    check(len(outs) == 2 and all(len(o) == 8 for o in outs),
          f"rg-serve: not every request returned 8 tokens: "
          f"{[len(o) for o in outs]}")
    check(res["paged_dev"] < 2e-3,
          f"rg-serve: paged-vs-logical deviation {res['paged_dev']:.3e}")
    # the probe: one gated forward (gate_mlp and gated_flash once per
    # attention layer, rglru_scan once per recurrent layer); then one
    # gate_mlp and one paged_decode per attention layer and position
    check(counts["rglru_scan"] == n_rec,
          f"rg-serve: rglru_scan launches {counts['rglru_scan']} != "
          f"{n_rec} (the tau probe)")
    check(counts["gated_flash"] == n_attn,
          f"rg-serve: gated_flash launches {counts['gated_flash']} != "
          f"{n_attn} (the tau probe)")
    check(counts["gate_mlp"] == n_attn * (pc.count + 1),
          f"rg-serve: gate_mlp launches {counts['gate_mlp']} != {n_attn} x "
          f"({pc.count} positions + 1 probe)")
    check(counts["paged_decode"] >= n_attn * pc.count,
          f"rg-serve: paged_decode launches {counts['paged_decode']}")
    stats = {"card": card, "requests": 2, "prompt_len": 64, "max_new": 8,
             "slots": 2, "capacity": 512, "wall_s": wall,
             "positions": pc.count, "ttft_mean_s": summ["ttft_mean_s"],
             "ttft_p50_s": summ["ttft_p50_s"],
             "tpot_mean_s": summ["tpot_mean_s"],
             "tpot_p50_s": summ["tpot_p50_s"],
             "tokens_per_s": summ["tokens_per_s"],
             "mean_admission": summ["mean_admission"],
             "paged_dev": res["paged_dev"],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print("rg-serve: " + json.dumps(stats), flush=True)
    return counts


def rg_model(seed: int):
    """Full-width recurrentgemma-9b (38 layers, d_model 4096, f32) with
    random weights drawn on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("recurrentgemma-9b").replace(dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_model(cfg, gen, "cuda")


def rg_prefill(cfg, params):
    """``inference.prefill`` of one 4096-token prompt through the hybrid
    (budget 1024, the local-attention ring 2048), then 16 greedy
    ``decode_step``s; then the dense baseline on the same prompt
    (``prefill(use_wgkv=False)`` + 16 steps, :func:`rg_prefill_dense`)."""
    import numpy as np
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models import rglru as RG
    s, budget, steps = 4096, 1024, 16
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    toks = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, budget=budget)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_counts = read_counts()
        _, logits, dec_caches, _ = greedy_decode(params, cfg, out.logits,
                                                 caches, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    check(prefill_counts["rglru_scan"] == n_rec,
          f"rg-prefill: rglru_scan launches {prefill_counts['rglru_scan']} "
          f"!= {n_rec}")
    check(prefill_counts["vertical_slash"] == n_attn,
          f"rg-prefill: vertical_slash launches "
          f"{prefill_counts['vertical_slash']} != {n_attn}")
    check(counts["rglru_scan"] == n_rec,
          f"rg-prefill: decode launched rglru_scan ({counts})")
    check(counts["gate_mlp"] == n_attn * (1 + steps),
          f"rg-prefill: gate_mlp launches {counts['gate_mlp']} != "
          f"{n_attn} + {n_attn} x {steps}")
    check(counts["paged_decode"] == n_attn * steps,
          f"rg-prefill: paged_decode launches {counts['paged_decode']} != "
          f"{n_attn} x {steps}")
    node = dec_caches["blocks"]["b2"]
    gcnt = node.gcnt
    check(node.w_local == cfg.sliding_window and node.budget == budget,
          f"rg-prefill: ring {node.w_local}, budget {node.budget}")
    check(int(dec_caches["t"][0]) == s + steps
          and bool((node.t == s + steps).all()),
          f"rg-prefill: t {dec_caches['t'].tolist()} != {s + steps}")
    check(0 < int(gcnt.min()) and int(gcnt.max()) <= budget,
          f"rg-prefill: gcnt in [{int(gcnt.min())}, {int(gcnt.max())}]")
    states = list(dec_caches.get("stem", ())) + [
        dec_caches["blocks"][f"b{i}"]
        for i, bt in enumerate(cfg.block_pattern) if bt == "rglru"]
    check(all(isinstance(st, RG.RGLRUState) and bool(torch.isfinite(st.h)
                                                     .all())
              for st in states), "rg-prefill: a recurrent state is not "
          "finite")
    check(bool(torch.isfinite(logits).all()), "rg-prefill: non-finite "
          "logits")
    stats = {"prompt_len": s, "budget": budget, "ring": node.w_local,
             "decode_steps": steps, "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "mean_admission": float(out.mean_admission),
             "gcnt_min": int(gcnt.min()), "gcnt_max": int(gcnt.max()),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches_prefill": prefill_counts, "launches": counts}
    print("rg-prefill: " + json.dumps(stats), flush=True)
    dense = rg_prefill_dense(cfg, params, toks, stats)
    return prefill_counts, counts, dense


def rg_prefill_dense(cfg, params, toks, wgkv_stats):
    """The hybrid's dense baseline, the one the paper's speed-ups are read
    against: ``prefill(use_wgkv=False)`` of rg-prefill's prompt, then 16
    greedy steps. Each local-attention layer prefills through
    ``gated_flash``'s hard window (W 2048) and decodes through
    ``paged_decode`` from a start offset; no gate, no vertical_slash, no
    plain attention. Printed beside WG-KV's wall and decode per step."""
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models.attention import DenseCache
    s, steps = toks.shape[1], 16
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, use_wgkv=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_counts = read_counts()
        _, logits, dec_caches, _ = greedy_decode(params, cfg, out.logits,
                                                 caches, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts = read_counts()
    want_prefill = {"gated_flash_window": n_attn, "rglru_scan": n_rec}
    want = {**want_prefill, "paged_decode_starts": n_attn * steps}
    for tag, got, exp in (("prefill", prefill_counts, want_prefill),
                          ("prefill + decode", counts, want)):
        check(all(got[k] == exp.get(k, 0) for k in got),
              f"rg-prefill-dense: {tag} launches {got}, want {exp} and no "
              "other kernel")
    node = dec_caches["blocks"]["b2"]
    check(isinstance(node, DenseCache) and bool((node.t == s + steps).all()),
          f"rg-prefill-dense: cache {type(node).__name__} t != {s + steps}")
    check(bool(torch.isfinite(logits).all()), "rg-prefill-dense: non-finite "
          "logits")
    stats = {"prompt_len": s, "window": cfg.sliding_window,
             "decode_steps": steps, "prefill_ms": (t1 - t0) * 1e3,
             "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
             "wgkv_prefill_ms": wgkv_stats["prefill_ms"],
             "wgkv_decode_ms_per_step": wgkv_stats["decode_ms_per_step"],
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches_prefill": prefill_counts, "launches": counts}
    print("rg-prefill-dense: " + json.dumps(stats), flush=True)
    return counts


def rg_forward(cfg, params):
    """The write-gated forward of the hybrid over 4096 tokens: the window
    is 2048, so half of the keys are gated."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    s = 4096
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    toks = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab_size - 8, (1, s)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        res = T.forward(params, cfg, toks, mode="gated", with_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    shape = tuple(res.gates.shape)
    check(counts["rglru_scan"] == n_rec,
          f"rg-forward: rglru_scan launches {counts['rglru_scan']} != {n_rec}")
    check(counts["gated_flash"] == n_attn,
          f"rg-forward: gated_flash launches {counts['gated_flash']} != "
          f"{n_attn}")
    check(counts["gate_mlp"] == n_attn,
          f"rg-forward: gate_mlp launches {counts['gate_mlp']} != {n_attn}")
    check(shape == (n_attn, 1, cfg.n_kv_heads, s), f"rg-forward: gates "
          f"{shape}")
    check(bool(torch.isfinite(res.hidden).all()
               and ((res.gates > 0) & (res.gates < 1)).all()),
          "rg-forward: non-finite hidden or gates outside (0, 1)")
    stats = {"seq": s, "window": cfg.sliding_window,
             "forward_ms": wall * 1e3, "gates": list(shape),
             "admitted_frac": float((res.gates >= cfg.wgkv.tau).float()
                                    .mean()),
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": counts}
    print("rg-forward: " + json.dumps(stats), flush=True)
    return counts


def rg_substrate():
    """The reduced hybrid (2-block RG-LRU stem, then RG-LRU, RG-LRU,
    local attention with a 32-token window; seeded random weights, the
    gate set to admit about half the tokens with scores far from tau)
    through prefill of a 128-token prompt and 8 greedy decode steps on
    the card (kernels) and on the CPU (plain path): identical tokens and
    integer cache state, logits and recurrent states within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import inference as I
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = get_reduced_config("recurrentgemma-9b").replace(
        dtype="float32", stem_pattern=("rglru", "rglru"), sliding_window=32)
    cpu_params = T.init_model(cfg, torch.Generator().manual_seed(4), "cpu")
    # hidden unit 0 reads gate feature 0: g = sigmoid(200 gelu(x0) - 4)
    for i, bt in enumerate(cfg.block_pattern):
        if bt == "local_attn":
            gate = cpu_params["blocks"][f"b{i}"]["attn"]["gate"]
            for k in ("w1", "b1", "w2"):
                gate[k].zero_()
            gate["w1"][:, :, 0, 0] = 1.0
            gate["w2"][:, :, 0, 0] = 200.0
            gate["b2"].fill_(-4.0)
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, (1, 128))
    steps, tau = 8, cfg.wgkv.tau

    def run(device, params, use_wgkv=None):
        with torch.no_grad():
            out, caches = I.prefill(params, cfg,
                                    torch.as_tensor(prompt, device=device),
                                    use_wgkv=use_wgkv)
            toks, logits, caches, _ = greedy_decode(params, cfg, out.logits,
                                                    caches, steps)
        return out, toks.cpu(), logits.cpu(), caches

    scores = []
    inner = ops.write_gate

    def recording(*a, **kw):
        g = inner(*a, **kw)
        scores.append(g)
        return g
    ops.write_gate = recording
    try:
        cpu_out, cpu_toks, cpu_logits, cpu_caches = run("cpu", cpu_params)
    finally:
        ops.write_gate = inner
    margin = min(float((g - tau).abs().min()) for g in scores)
    check(margin >= 1e-3, f"rg-substrate: gate margin {margin:.2e} < 1e-3")
    gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
    torch.cuda.synchronize()
    reset_counts()
    gpu_out, gpu_toks, gpu_logits, gpu_caches = run("cuda", gpu_params)
    torch.cuda.synchronize()
    counts = read_counts()
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    want = {"rglru_scan": n_rec, "vertical_slash": n_attn,
            "gate_mlp": n_attn * (1 + steps),
            "paged_decode": n_attn * steps}
    check(all(counts[k] == v for k, v in want.items()),
          f"rg-substrate: the card run missed its kernels: {counts}")
    top2 = torch.topk(cpu_logits, 2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    check(torch.equal(gpu_toks, cpu_toks),
          f"rg-substrate: greedy tokens differ: {gpu_toks.tolist()} vs "
          f"{cpu_toks.tolist()}")
    err = float((gpu_logits - cpu_logits).abs().max())
    check(err <= 1e-4, f"rg-substrate: logits differ by {err:.3e} > 1e-4")
    ints = {"t", "ptr", "lpos", "gpos", "gcnt", "overflow"}
    h_err = 0.0
    gpu_leaves = dict(tree_leaves_with_path(gpu_caches))
    for path, want_leaf in tree_leaves_with_path(cpu_caches):
        got = gpu_leaves[path].cpu()
        if path[-1] in ints:
            check(torch.equal(got, want_leaf), f"rg-substrate: cache "
                  f"{'/'.join(map(str, path))} differs between card and CPU")
        elif path[-1] == "h":
            h_err = max(h_err, float((got - want_leaf).abs().max()))
    check(h_err <= 1e-4, f"rg-substrate: recurrent state h differs by "
          f"{h_err:.3e} > 1e-4")
    adm = float(gpu_out.mean_admission)
    check(abs(adm - float(cpu_out.mean_admission)) <= 1e-6,
          f"rg-substrate: mean_admission {adm} (CPU "
          f"{float(cpu_out.mean_admission)})")
    gcnt = gpu_caches["blocks"]["b2"].gcnt
    # the dense baseline on the same model and prompt: the windowed
    # prefill and decode read (W 32, below the 128-token prompt)
    cpu_d = run("cpu", cpu_params, use_wgkv=False)
    torch.cuda.synchronize()
    reset_counts()
    gpu_d = run("cuda", gpu_params, use_wgkv=False)
    torch.cuda.synchronize()
    dense_counts = read_counts()
    want_d = {"rglru_scan": n_rec, "gated_flash_window": n_attn,
              "paged_decode_starts": n_attn * steps}
    check(all(dense_counts[k] == want_d.get(k, 0) for k in dense_counts),
          f"rg-substrate dense: launches {dense_counts}, want {want_d}")
    check(torch.equal(gpu_d[1], cpu_d[1]), f"rg-substrate dense: greedy "
          f"tokens differ: {gpu_d[1].tolist()} vs {cpu_d[1].tolist()}")
    d_err = float((gpu_d[2] - cpu_d[2]).abs().max())
    check(d_err <= 1e-4, f"rg-substrate dense: logits differ by "
          f"{d_err:.3e} > 1e-4")
    d_leaves = dict(tree_leaves_with_path(gpu_d[3]))
    d_h = 0.0
    for path, want_leaf in tree_leaves_with_path(cpu_d[3]):
        got = d_leaves[path].cpu()
        if want_leaf.dtype == torch.int32:
            check(torch.equal(got, want_leaf), f"rg-substrate dense: cache "
                  f"{'/'.join(map(str, path))} differs between card and CPU")
        elif path[-1] == "h":
            d_h = max(d_h, float((got - want_leaf).abs().max()))
    check(d_h <= 1e-4, f"rg-substrate dense: recurrent state h differs by "
          f"{d_h:.3e} > 1e-4")
    stats = {"prompt_len": prompt.shape[1], "decode_steps": steps,
             "window": cfg.sliding_window, "layers": cfg.n_layers,
             "tau_margin": margin, "mean_admission": adm,
             "max_logit_err": err, "max_h_err": h_err,
             "min_top2_logit_gap": gap, "tokens": gpu_toks[0].tolist(),
             "gcnt": gcnt[:, 0].tolist(), "launches": counts,
             "dense": {"max_logit_err": d_err, "max_h_err": d_h,
                       "tokens": gpu_d[1][0].tolist(),
                       "launches": dense_counts}}
    print("rg-substrate: " + json.dumps(stats), flush=True)
    return counts, dense_counts


def grad_rglru_blocks(cfg) -> int:
    """RG-LRU layers at or after the first attention layer: the only ones
    a gate's gradient runs back through (the blocks before it see no input
    that requires grad), so each launches ``rglru_scan_bwd`` once per
    gradient evaluation."""
    order = list(cfg.stem_pattern) + list(cfg.block_pattern) * cfg.n_repeats
    first = next(i for i, bt in enumerate(order)
                 if bt in ("attn", "attn_moe", "local_attn"))
    return sum(bt == "rglru" for bt in order[first:])


def train_launches(cfg) -> dict:
    """Kernel launches of one gradient evaluation of gate distillation:
    every attention layer's ``gated_flash``, ``gated_flash_bwd``,
    ``gate_mlp`` and ``gate_mlp_bwd`` once, every RG-LRU layer's
    ``rglru_scan`` twice (student and teacher) and, from the first
    attention layer on, its ``rglru_scan_bwd`` once; nothing else."""
    n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
    n_rec = cfg.n_layers - n_attn
    return {"gated_flash": n_attn, "gated_flash_bwd": n_attn,
            "gate_mlp": n_attn, "gate_mlp_bwd": n_attn,
            "rglru_scan": 2 * n_rec,
            "rglru_scan_bwd": grad_rglru_blocks(cfg),
            "paged_decode": 0, "paged_decode_selected": 0,
            "vertical_slash": 0, "gated_flash_window": 0,
            "paged_decode_starts": 0}


def cluster_gates(cfg, params, seed: int) -> None:
    """Every gate's weights (an attention block's, and an ``attn_cross``
    block's cross-memory gate too) drawn with numpy so that the
    scores cluster per (repeat, head) clear of tau: head h of repeat r
    admits (scores near sigmoid(0.5)) when r + h is even and rejects (near
    sigmoid(-5)) otherwise. In place, on the CPU tensors of ``params``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    for i, bt in enumerate(cfg.block_pattern):
        block = params["blocks"][f"b{i}"]
        for mixer in ("attn", "xattn"):
            if "gate" not in block.get(mixer, {}):
                continue
            gate = block[mixer]["gate"]
            r, h, f, m = gate["w1"].shape
            admit = (np.arange(r)[:, None] + np.arange(h)[None]) % 2 == 0
            new = {"w1": rng.standard_normal((r, h, f, m)) / np.sqrt(f),
                   "b1": 0.1 * rng.standard_normal((r, h, m)),
                   "w2": 0.5 * rng.standard_normal((r, h, m, 1))
                   / np.sqrt(m),
                   "b2": np.where(admit, 0.5, -5.0)[..., None]}
            for k, v in new.items():
                gate[k].copy_(torch.from_numpy(v.astype(np.float32)))


def train_arch(card: str, arch: str, steps: int, batch: int, seq: int,
               tag: str, check_backbone: bool = False):
    """``repro_torch.launch.train --arch <arch>`` at full width and depth
    (f32, a seeded random backbone): per step wall time, loss, distill and
    peak memory (under 80 GB). Per step every attention layer launches
    ``gated_flash``, ``gated_flash_bwd``, ``gate_mlp`` and
    ``gate_mlp_bwd`` once, every RG-LRU layer ``rglru_scan`` twice (student
    and teacher) and, from the first attention layer on,
    ``rglru_scan_bwd`` once; nothing else of the port's. With
    ``check_backbone`` every gate leaf moved and every other leaf comes
    back bitwise as initialised (a second model is drawn to compare).
    Then one more step under torch.profiler (device time by kernel
    name)."""
    import math

    import numpy as np
    import torch
    from repro_torch.convert import flat_paths
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    from repro_torch.training import trainer as TR
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = train.main(["--arch", arch, "--steps", str(steps), "--batch",
                      str(batch), "--seq", str(seq), "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    cfg, hist = res["cfg"], res["history"]
    want = {k: v * steps for k, v in train_launches(cfg).items()}
    check(counts == want, f"{tag}: launches {counts} != {want}")
    check(len(hist) == steps and all(
        math.isfinite(h[k]) for h in hist for k in ("loss", "distill"))
        and all(h["distill"] > 0 for h in hist), f"{tag}: history {hist}")
    peak = max(h["peak_mem_gib"] for h in hist)
    check(peak * 2 ** 30 < 80e9, f"{tag}: peak memory {peak} GiB")
    if check_backbone:
        fresh = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
        trained = dict(flat_paths(res["params"]))
        moved = 0
        for key, leaf in flat_paths(fresh):
            if "gate" in key.split("/"):
                moved += int(not torch.equal(trained[key], leaf))
            else:
                check(torch.equal(trained[key], leaf),
                      f"{tag}: backbone leaf {key} changed")
        check(moved == len(TR.get_gates(fresh)), f"{tag}: only {moved} of "
              f"{len(TR.get_gates(fresh))} gate leaves moved")
        del fresh, trained
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size - 8, (batch, seq)), device="cuda")
    step = TR.make_train_step(cfg, lr=1e-3, lam=0.08)
    t1 = time.perf_counter()
    by_kernel = kernel_us(lambda: step(res["state"], res["params"],
                                       batch={"tokens": toks}), iters=1)
    prof_wall = time.perf_counter() - t1
    del res
    free_cuda()
    stats = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
             "seq": seq, "window": cfg.sliding_window
             if "local_attn" in cfg.block_pattern else cfg.wgkv.w_local,
             "steps": [{k: h.get(k) for k in ("step", "step_s", "loss",
                                              "distill", "admission_rate@0.1",
                                              "mean_gate", "peak_mem_gib")}
                       for h in hist],
             "wall_s": wall, "peak_mem_gib": peak, "launches": counts,
             "launches_per_step": {k: v / steps for k, v in counts.items()},
             "profiled_step": {
                 "device_ms": sum(by_kernel.values()) / 1e3,
                 "wall_s_two_steps": prof_wall,
                 "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
                     by_kernel.items(), key=lambda kv: -kv[1])[:14]}},
             "card": card}
    print(f"{tag}: " + json.dumps(stats), flush=True)
    return counts, stats


def rg_train_substrate():
    """``train_card_vs_cpu`` on the reduced hybrid (64-token window) with a
    2-block RG-LRU stem and two repeats, so that RG-LRU blocks follow a
    gate and the scan's backward runs: seeded random weights, the gates
    clustered clear of tau (>= 1e-3), 2 x 128 tokens past the window."""
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    cfg = get_reduced_config("recurrentgemma-9b").replace(
        dtype="float32", stem_pattern=("rglru", "rglru"), n_repeats=2)
    params = T.init_model(cfg, torch.Generator().manual_seed(6), "cpu")
    cluster_gates(cfg, params, 106)
    return train_card_vs_cpu("rg-train-substrate", cfg, params, 73, 1e-3)


def dense_serve(arch: str, card: str, requests: int = 2,
                repeats: int | None = None):
    """``repro_torch.launch.serve --arch <arch>`` at full width:
    ``requests`` requests of 64 tokens, 8 new tokens, 2 slots, capacity
    512, the startup tau probe included (one ``gated_flash`` and
    ``gate_mlp`` per layer), then one ``gate_mlp`` and one
    ``paged_decode`` per layer and position. ``repeats``: the depth cut
    to that many repeats (the CLI's config lookup answers the cut
    config)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    if repeats is not None:
        cfg = cfg.replace(n_repeats=repeats)
    n = cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lookup = serve.get_config
    serve.get_config = lambda name: cfg if name == arch else lookup(name)
    try:
        with position_counter() as pc:
            res = serve.main(["--arch", arch, "--requests", str(requests),
                              "--prompt-len", "64", "--max-new", "8",
                              "--slots", "2", "--capacity", "512",
                              "--quiet-stream"])
    finally:
        serve.get_config = lookup
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    outs, summ = res["outputs"], res["summary"]
    check(len(outs) == requests and all(len(o) == 8 for o in outs),
          f"{arch} serve: not every request returned 8 tokens: "
          f"{[len(o) for o in outs]}")
    check(res["paged_dev"] < 2e-3,
          f"{arch} serve: paged-vs-logical deviation {res['paged_dev']:.3e}")
    check(counts["gated_flash"] == n and counts["gate_mlp"] == n * (
        pc.count + 1) and counts["paged_decode"] >= n * pc.count,
        f"{arch} serve: launches {counts} over {pc.count} positions, "
        f"{n} layers")
    return {"layers": n, "wall_s": wall, "positions": pc.count,
            "ttft_mean_s": summ["ttft_mean_s"],
            "tpot_mean_s": summ["tpot_mean_s"],
            "tokens_per_s": summ["tokens_per_s"],
            "mean_admission": summ["mean_admission"],
            "paged_dev": res["paged_dev"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts}


def dense_prefill(arch: str, seed: int):
    """``prefill_decode`` through the full-width model (f32, random weights
    drawn on the card), which is freed after it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch).replace(dtype="float32")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    stats, _ = prefill_decode(cfg, params, seed, f"{arch} prefill")
    stats["weights_gib"] = sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)) / 2 ** 30
    del params
    free_cuda()
    return stats


def dense_reduced(arch: str):
    """The reduced config (f32, a 32-token ring, seeded random weights, the
    gates clustered clear of tau) on the card (kernels) and on the CPU
    (plain path): the gated forward of a 96-token numpy prompt (hidden and
    gates within 1e-4), then prefill of a 128-token prompt and 8 greedy
    decode steps: identical tokens and integer cache state, logits within
    1e-4. An MoE config's routing is recorded on both: every top-k
    boundary clears 1e-6 and twice the card's largest probability
    difference from the CPU, so no expert can flip between them; and a
    second card run is bitwise the first."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import inference as I
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path, tree_map
    cfg = get_reduced_config(arch).replace(dtype="float32")
    cfg = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, w_local=32))
    cpu_params = T.init_model(cfg, torch.Generator().manual_seed(7), "cpu")
    cluster_gates(cfg, cpu_params, 107)
    rng = np.random.default_rng(22)
    fwd_toks = rng.integers(0, cfg.vocab_size, (2, 96))
    prompt = rng.integers(0, cfg.vocab_size, (1, 128))
    steps = 8

    def run(device, params):
        with torch.no_grad():
            fwd = T.forward(params, cfg, torch.as_tensor(fwd_toks,
                                                         device=device),
                            mode="gated", with_logits=False)
            out, caches = I.prefill(params, cfg,
                                    torch.as_tensor(prompt, device=device))
            toks, logits, caches, _ = greedy_decode(params, cfg, out.logits,
                                                    caches, steps)
        return fwd, out, toks.cpu(), logits.cpu(), caches

    scores = []
    inner = ops.write_gate
    probs = {"cpu": [], "cuda": []}
    inner_route = MoE.route

    def recording(*a, **kw):
        g = inner(*a, **kw)
        scores.append(g)
        return g

    def recording_route(*a, **kw):
        r = inner_route(*a, **kw)
        probs[r.probs.device.type].append(r.probs.detach().cpu())
        return r
    ops.write_gate, MoE.route = recording, recording_route
    try:
        cpu = run("cpu", cpu_params)
        ops.write_gate = inner
        gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_counts()
        gpu = run("cuda", gpu_params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        ops.write_gate, MoE.route = inner, inner_route
    margin = min(float((g - cfg.wgkv.tau).abs().min()) for g in scores)
    check(margin >= 1e-3, f"{arch} reduced: gate margin {margin:.2e}")
    route = None
    if cfg.moe is not None:
        check(len(probs["cpu"]) == len(probs["cuda"]) > 0
              and all(a.shape == b.shape
                      for a, b in zip(probs["cpu"], probs["cuda"])),
              f"{arch} reduced: the card and the CPU routed differently")
        r_margin = min(MoE.routing_margin(p, cfg.moe.top_k)
                       for p in probs["cpu"])
        delta = max(float((a - b).abs().max())
                    for a, b in zip(probs["cpu"], probs["cuda"]))
        check(r_margin >= 1e-6 and r_margin > 2 * delta,
              f"{arch} reduced: routing margin {r_margin:.2e} against a "
              f"card-CPU probability difference of {delta:.2e}")
        again = run("cuda", gpu_params)
        torch.cuda.synchronize()
        check(torch.equal(again[0].hidden, gpu[0].hidden)
              and torch.equal(again[3], gpu[3])
              and torch.equal(again[2], gpu[2]),
              f"{arch} reduced: two card runs differ")
        route = {"routings": len(probs["cpu"]), "margin": r_margin,
                 "card_cpu_prob_max_diff": delta, "two_runs_bitwise": True}
    n = cfg.n_layers
    want = {"gated_flash": n, "vertical_slash": n,
            "gate_mlp": n * (2 + steps), "paged_decode": n * steps}
    check(all(counts[k] == v for k, v in want.items()),
          f"{arch} reduced: the card run missed its kernels: {counts}")
    fwd_err = max(float((gpu[0].hidden.cpu() - cpu[0].hidden).abs().max()),
                  float((gpu[0].gates.cpu() - cpu[0].gates).abs().max()))
    check(fwd_err <= 1e-4, f"{arch} reduced: gated forward differs by "
          f"{fwd_err:.3e} > 1e-4")
    check(torch.equal(gpu[2], cpu[2]), f"{arch} reduced: greedy tokens "
          f"differ: {gpu[2].tolist()} vs {cpu[2].tolist()}")
    err = float((gpu[3] - cpu[3]).abs().max())
    check(err <= 1e-4, f"{arch} reduced: logits differ by {err:.3e} > 1e-4")
    ints = {"t", "ptr", "lpos", "gpos", "gcnt", "overflow"}
    gpu_leaves = dict(tree_leaves_with_path(gpu[4]))
    for path, want_leaf in tree_leaves_with_path(cpu[4]):
        if path[-1] in ints:
            check(torch.equal(gpu_leaves[path].cpu(), want_leaf),
                  f"{arch} reduced: cache {'/'.join(map(str, path))} "
                  "differs between card and CPU")
    adm = float(gpu[1].mean_admission)
    check(abs(adm - float(cpu[1].mean_admission)) <= 1e-6,
          f"{arch} reduced: mean_admission {adm} (CPU "
          f"{float(cpu[1].mean_admission)})")
    return {"heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "tau_margin": margin, "forward_max_err": fwd_err,
            "max_logit_err": err, "mean_admission": adm,
            "tokens": gpu[2][0].tolist(),
            "gcnt": gpu[4]["blocks"]["b0"].gcnt[:, 0].tolist(),
            "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "routing": route, "launches": counts}


def dense_arch(arch: str, card: str, seed: int):
    """One plain ``("attn",)`` decoder at full width: serve (at
    ``SERVE_REPEATS`` layers), prefill 4096 tokens and decode 16 (full
    depth), then its reduced config on card and CPU."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    stats = {"arch": arch, "layers": cfg.n_layers,
             "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
             "tie_embeddings": cfg.tie_embeddings, "card": card}
    stats["serve"] = dense_serve(arch, card, repeats=SERVE_REPEATS)
    free_cuda()
    stats["prefill"] = dense_prefill(arch, seed)
    stats["reduced"] = dense_reduced(arch)
    print(f"dense-arch {arch}: " + json.dumps(stats), flush=True)
    return {k: stats[k]["launches"] for k in ("serve", "prefill", "reduced")}


def moe_ffn_twice(cfg, params, seed: int, tag: str):
    """Layer 0's MoE FFN over a [1, 4096, D] normal input drawn on the
    card, called twice: the outputs are finite and bitwise equal (the
    combine adds each token's entries in a fixed order, no atomics).
    Returns the drop fraction, the load-balance loss and the call's time
    (CUDA events)."""
    import torch
    from repro_torch.models import moe as MoE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 4096, cfg.d_model), generator=gen, device="cuda")
    p = {k: v[0] for k, v in params["blocks"]["b0"]["moe"].items()}
    with torch.no_grad():
        y, aux = MoE.moe_ffn(p, cfg, x)
        again, _ = MoE.moe_ffn(p, cfg, x)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite MoE output")
        check(torch.equal(y, again), f"{tag}: two MoE calls differ")
        ms = cuda_ms(lambda: MoE.moe_ffn(p, cfg, x), 5, warmup=1)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    return {"tokens": 4096, "experts": e, "top_k": k,
            "capacity": MoE.capacity(4096, e, k, cfg.moe.capacity_factor),
            "drop_frac": float(aux["router_drop_frac"]),
            "lb_loss": float(aux["lb_loss"]), "ms": ms,
            "two_calls_bitwise": True}


def moe_model(arch: str, seed: int, repeats: int | None = None):
    """A full-width config (f32; ``repeats``: its depth cut) and random
    weights drawn on the card, with the peak memory of the draw (the MoE
    archs', and this slice's xLSTM, whisper and VLM)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch).replace(dtype="float32")
    if repeats is not None:
        cfg = cfg.replace(n_repeats=repeats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    torch.cuda.synchronize()
    init = {"init_s": time.perf_counter() - t0,
            "weights_gib": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)) / 2 ** 30,
            "init_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    return cfg, params, init


def moe_granite(card: str, seed: int):
    """granite-moe-3b-a800m at full width (32 ``attn_moe`` layers,
    d_model 1536, 24 / 8 heads of hd 64, 40 experts of d_ff 512, top 8;
    f32, random weights): moe-serve (``launch.serve`` at ``SERVE_REPEATS``
    layers, 4 x 64 tokens, 8 new, 2 slots, the tau probe and
    ``verify_paged``), moe-prefill (4,096
    tokens at budget 1,024 + 16 greedy steps, and a warm repeat),
    moe-forward (the gated forward over 2,048 tokens) and one layer's MoE
    FFN twice, bitwise. Returns each path's launch counts."""
    arch = "granite-moe-3b-a800m"
    stats = {"arch": arch, "card": card}
    stats["serve"] = dense_serve(arch, card, requests=4,
                                 repeats=SERVE_REPEATS)
    print("moe-serve: " + json.dumps(stats["serve"]), flush=True)
    free_cuda()
    cfg, params, stats["init"] = moe_model(arch, seed)
    stats["prefill"], _ = prefill_decode(cfg, params, seed, "moe-prefill")
    print("moe-prefill: " + json.dumps(stats["prefill"]), flush=True)
    free_cuda()
    stats["forward"] = forward_gated(cfg, params, tag="moe-forward")
    free_cuda()
    stats["moe_ffn"] = moe_ffn_twice(cfg, params, seed, "moe-ffn")
    del params
    free_cuda()
    print(f"moe {arch}: " + json.dumps({k: stats[k] for k in (
        "init", "moe_ffn")}), flush=True)
    return {k: stats[k]["launches"] for k in ("serve", "prefill", "forward")}


def qwen3moe_d4(card: str, seed: int):
    """qwen3-moe-235b-a22b at full width with its depth cut from 94
    repeats to 4 (d_model 4096, 64 / 4 heads of hd 128 with qk-norm, 128
    experts of d_ff 1536, top 8, untied vocab 151,936; 41.7 GiB of f32
    weights): ``launch.serve`` of 2 x 64 tokens, prefill of 4,096 tokens
    at budget 1,024 + 16 greedy steps, and one layer's MoE FFN twice,
    bitwise. Peak memory of each."""
    arch = "qwen3-moe-235b-a22b"
    stats = {"arch": arch, "repeats": 4, "card": card}
    stats["serve"] = dense_serve(arch, card, requests=2, repeats=4)
    free_cuda()
    cfg, params, stats["init"] = moe_model(arch, seed, repeats=4)
    stats["prefill"], _ = prefill_decode(cfg, params, seed,
                                         "qwen3moe-d4 prefill")
    free_cuda()
    stats["moe_ffn"] = moe_ffn_twice(cfg, params, seed, "qwen3moe-d4 ffn")
    del params
    free_cuda()
    print("qwen3moe-d4: " + json.dumps(stats), flush=True)
    return {k: stats[k]["launches"] for k in ("serve", "prefill")}


def moe_reduced():
    """Both MoE archs' reduced configs (4 experts, top 2) on card and CPU
    (``dense_reduced``): tokens and integer state equal, logits within
    1e-4, the routing margin, two card runs bitwise."""
    out = {}
    for arch in MOE_HEADS:
        stats = dense_reduced(arch)
        print(f"moe-reduced {arch}: " + json.dumps(stats), flush=True)
        out[arch] = stats["launches"]
    return out


# --------------------------------------------------------------------------
# xlstm-350m, whisper-medium and qwen2-vl-7b
# --------------------------------------------------------------------------
def _new_reduced_cfg(arch: str):
    """A reduced config of this slice's archs in f32 with a 32-token ring
    (whisper's and qwen2-vl's prefills must be multiples of the ring)."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(arch).replace(dtype="float32")
    if cfg.wgkv.enabled:
        cfg = cfg.replace(wgkv=dataclasses.replace(cfg.wgkv, w_local=32))
    return cfg


def _reduced_inputs(arch: str, cfg, params, device):
    """The prefill's inputs, built on ``device`` from numpy: xlstm 128
    tokens; whisper a 32-token prompt over 64 frames (32 encoder
    positions: its budget of 16 keeps half of them); qwen2-vl a 128-slot
    stream whose first 16 are the patches of a 4 x 4 grid, with its
    M-RoPE ids (``build_vlm_embeds``)."""
    import numpy as np
    import torch
    from repro_torch.models import registry as REG
    rng = np.random.default_rng(24)
    s = 32 if arch == "whisper-medium" else 128
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, s)),
                           device=device)
    if arch == "whisper-medium":
        frames = 0.1 * rng.standard_normal((1, 32, cfg.d_model))
        return {"tokens": toks, "enc_embeds": torch.as_tensor(
            frames, dtype=torch.float32, device=device)}
    if arch == "qwen2-vl-7b":
        patches = torch.as_tensor(0.02 * rng.standard_normal(
            (1, 16, cfg.d_model)), dtype=torch.float32, device=device)
        emb, pos = REG.build_vlm_embeds(params, cfg, toks, patches, (4, 4))
        return {"embeds": emb, "positions": pos}
    return {"tokens": toks}


def new_archs_reduced():
    """The three reduced configs (f32, seeded random weights, every gate
    clustered clear of tau) on the card (kernels) and on the CPU (plain
    path): prefill (xlstm 128 tokens; whisper a 32-token prompt over 64
    frames with its cross memory budgeted to 16 of 32; qwen2-vl a
    128-slot stream of a 4 x 4 grid's patches and text, M-RoPE) and 8
    greedy decode steps. Tokens, every integer cache leaf and every
    selection's indices (the budgeted prefill's and the cross memory's)
    identical, logits within 1e-4; and the launch counts of each: none for
    xlstm (no kernel on its path)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import inference as I
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path, tree_map
    out = {}
    for k, arch in enumerate(("xlstm-350m", "whisper-medium",
                              "qwen2-vl-7b")):
        cfg = _new_reduced_cfg(arch)
        cpu_params = T.init_model(cfg, torch.Generator().manual_seed(40 + k),
                                  "cpu")
        cluster_gates(cfg, cpu_params, 140 + k)
        scores, sels = [], {"cpu": [], "cuda": []}
        inner_gate, inner_sel = ops.write_gate, A.select_global

        def rec_gate(*a, **kw):
            g = inner_gate(*a, **kw)
            scores.append(g.detach().cpu())
            return g

        def rec_sel(*a, **kw):
            sel = inner_sel(*a, **kw)
            sels[sel.idx.device.type].append(sel.idx.cpu())
            return sel

        def run(device, params):
            with torch.no_grad():
                po, caches = I.prefill(params, cfg, **_reduced_inputs(
                    arch, cfg, params, device))
                toks, logits, caches, _ = greedy_decode(
                    params, cfg, po.logits, caches, 8)
            return toks.cpu(), logits.cpu(), caches

        ops.write_gate, A.select_global = rec_gate, rec_sel
        try:
            cpu = run("cpu", cpu_params)
            gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            gpu = run("cuda", gpu_params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        finally:
            ops.write_gate, A.select_global = inner_gate, inner_sel
        tag = f"new-archs-reduced {arch}"
        n_attn = cfg.n_repeats * cfg.attn_blocks_per_pattern
        n_gate = n_attn * (2 if arch == "whisper-medium" else 1)
        want = {"vertical_slash": n_attn, "gate_mlp": n_gate + 8 * n_attn,
                "paged_decode": 8 * n_attn}
        check(all(counts[key] == v for key, v in want.items())
              and sum(counts.values()) == sum(want.values())
              if cfg.wgkv.enabled else not any(counts.values()),
              f"{tag}: launches {counts}")
        margin = min((float((g - cfg.wgkv.tau).abs().min()) for g in scores),
                     default=None)
        check(margin is None or margin >= 1e-3,
              f"{tag}: gate margin {margin}")
        check(len(sels["cpu"]) == len(sels["cuda"]) and all(
            torch.equal(a, b) for a, b in zip(sels["cpu"], sels["cuda"])),
            f"{tag}: the card and the CPU selected different indices")
        check(torch.equal(gpu[0], cpu[0]), f"{tag}: tokens {gpu[0].tolist()}"
              f" vs {cpu[0].tolist()}")
        err = float((gpu[1] - cpu[1]).abs().max())
        check(err <= 1e-4, f"{tag}: logits differ by {err:.3e} > 1e-4")
        gpu_leaves = dict(tree_leaves_with_path(gpu[2]))
        n_int = 0
        for path, leaf in tree_leaves_with_path(cpu[2]):
            if not leaf.is_floating_point():
                n_int += 1
                check(torch.equal(gpu_leaves[path].cpu(), leaf),
                      f"{tag}: cache {'/'.join(map(str, path))} differs")
        stats = {"tokens": gpu[0][0].tolist(), "max_logit_err": err,
                 "tau_margin": margin, "selections": len(sels["cuda"]),
                 "int_leaves": n_int, "wall_s": wall, "launches": counts}
        print(f"{tag}: " + json.dumps(stats), flush=True)
        out[arch] = counts
        del gpu_params
        free_cuda()
    return out


def xlstm_phase(card: str):
    """xlstm-350m at full width, depth cut to 4 of its 24 blocks (2 x
    (mLSTM, sLSTM), d_model 1,024, f32; the sLSTM's Python step a token
    makes the phase's time scale with depth; mesh-xlstm runs the arch
    again): prefill of 2,048 tokens (the
    chunkwise mLSTM, four chunks of 512; the sLSTM one Python step per
    token) + 16 greedy decode steps, a teacher forward over 2,048 tokens,
    and one ``lm_train_step`` at 1 x 1,024 (every leaf trains, AdamW).
    No kernel of the port is on its path: every count stays 0."""
    import numpy as np
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as XL
    from repro_torch.models.transformer import layer_params
    from repro_torch.training import trainer as TR
    cfg, params, init = moe_model("xlstm-350m", 80, repeats=2)
    stats = {"arch": cfg.name, "layers": cfg.n_layers, "card": card,
             "init": init}
    rng = np.random.default_rng(81)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size - 8, (1, 2048)),
                           device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, logits, caches, _ = greedy_decode(params, cfg, out.logits,
                                             caches, 16)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fwd = T.forward(params, cfg, toks, with_logits=False)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    counts = read_counts()
    check(not any(counts.values()), f"xlstm: launches {counts}")
    check(bool(torch.isfinite(logits).all()
               and torch.isfinite(fwd.hidden).all()),
          "xlstm: non-finite logits or hidden")
    check(int(caches["t"][0]) == 2048 + 16, f"xlstm: t {caches['t']}")
    stats.update(prefill_ms=(t1 - t0) * 1e3,
                 decode_ms_per_step=(t2 - t1) * 1e3 / 16,
                 forward_ms=(t3 - t2) * 1e3,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del out, caches, fwd
    free_cuda()
    # each block type's share: one layer alone over the 2,048 tokens
    x = torch.randn((1, 2048, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(82))
    layer = layer_params(params, cfg)[0]
    with torch.no_grad():
        stats["slstm_block_ms_s2048"] = cuda_ms(
            lambda: XL.slstm_block(layer["b1"]["cell"], cfg, x), 1,
            warmup=1)
        stats["mlstm_block_ms_s2048"] = cuda_ms(
            lambda: XL.mlstm_auto(layer["b0"]["cell"], cfg, x), 3, warmup=1)
    del x, layer
    state = TR.init_lm_train_state(params)
    batch = {"tokens": toks[:, :1024]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(1):
        t0 = time.perf_counter()
        state, m = TR.lm_train_step(state, cfg, batch, lr=1e-4)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"xlstm train: losses {losses}")
    check(not any(read_counts().values()), "xlstm train: a kernel launched")
    stats["train"] = {"batch": 1, "seq": 1024, "step_s": step_s,
                      "losses": losses, "peak_mem_gib":
                          torch.cuda.max_memory_allocated() / 2 ** 30}
    stats["launches"] = counts
    del state, params
    free_cuda()
    print("xlstm: " + json.dumps(stats), flush=True)
    return counts


def whisper_phase(card: str):
    """whisper-medium at full width and depth (24 encoder + 24 decoder
    layers, d_model 1,024, 16 / 16 heads of hd 64, f32, 2.8 GiB):
    ``whisper_frame_embeds`` for 3,000 frames (1,500 encoder positions),
    prefill of a 384-token decoder prompt (past the 64-token ring, under
    ``dec_max_len`` 448) at budget 96, so each cross memory keeps 96 of
    the 1,500 encoder keys its gate scores, then 16 greedy decode steps;
    the gated forward over the prompt; and 2 gate-distillation
    ``train_step``s at 2 x 384 with ``enc_embeds`` in the batch. Launch
    counts of each path."""
    import numpy as np
    import torch
    from repro_torch.models import inference as I
    from repro_torch.models import registry as REG
    from repro_torch.models import transformer as T
    from repro_torch.training import trainer as TR
    cfg, params, init = moe_model("whisper-medium", 90)
    n = cfg.n_layers
    stats = {"arch": cfg.name, "layers": [cfg.n_enc_layers, n],
             "card": card, "init": init}
    gen = torch.Generator(device="cuda").manual_seed(91)
    frames = REG.whisper_frame_embeds(gen, cfg, 1, 2 * WHISPER_ENC)
    check(tuple(frames.shape) == (1, WHISPER_ENC, cfg.d_model),
          f"whisper: frames {tuple(frames.shape)}")
    rng = np.random.default_rng(92)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size - 8,
                                        (1, WHISPER_S)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out, caches = I.prefill(params, cfg, toks, enc_embeds=frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pf_counts = read_counts()
        reset_counts()
        _, logits, caches, _ = greedy_decode(params, cfg, out.logits,
                                             caches, 16)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    dec_counts = read_counts()
    node = caches["blocks"]["b0"]
    check(pf_counts["vertical_slash"] == n and pf_counts["gate_mlp"] == 2 * n,
          f"whisper prefill: launches {pf_counts}")
    check(dec_counts["gate_mlp"] == 16 * n
          and dec_counts["paged_decode"] == 16 * n,
          f"whisper decode: launches {dec_counts}")
    check(tuple(node["cross"].k.shape[-2:]) == (WHISPER_C, 64)
          and node["self"].gk.shape[-2] == WHISPER_C,
          f"whisper: cross memory {tuple(node['cross'].k.shape)}")
    check(bool(torch.isfinite(logits).all()), "whisper: non-finite logits")
    cross_kept = node["cross"].valid.float().sum(-1)
    stats["serve_path"] = {
        "prompt": WHISPER_S, "budget": WHISPER_C, "decode_steps": 16,
        "prefill_ms": (t1 - t0) * 1e3,
        "decode_ms_per_step": (t2 - t1) * 1e3 / 16,
        "mean_admission": float(out.mean_admission),
        "cross_kept_min": float(cross_kept.min()),
        "cross_kept_max": float(cross_kept.max()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches_prefill": pf_counts, "launches_decode": dec_counts}
    del out, caches
    free_cuda()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        fwd = T.forward(params, cfg, toks, mode="gated", enc_embeds=frames,
                        with_logits=False)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_counts = read_counts()
    check(fwd_counts["gated_flash"] == n and fwd_counts["gate_mlp"] == n,
          f"whisper forward: launches {fwd_counts}")
    check(tuple(fwd.gates.shape) == (n, 1, cfg.n_kv_heads, WHISPER_S)
          and bool(torch.isfinite(fwd.hidden).all()),
          "whisper forward: gates or hidden")
    stats["forward"] = {"forward_ms": fwd_ms, "launches": fwd_counts}
    del fwd
    cluster_gates(cfg, params, 93)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size - 8, (2, WHISPER_S)), device="cuda"),
        "enc_embeds": REG.whisper_frame_embeds(gen, cfg, 2, 2 * WHISPER_ENC)}
    state = TR.init_train_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, m = TR.train_step(state, params, cfg, batch, lr=1e-3)
        torch.cuda.synchronize()
        hist.append({"step_s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in m.items()}})
    tr_counts = read_counts()
    want = {"gated_flash": 2 * n, "gated_flash_bwd": 2 * n,
            "gate_mlp": 2 * n, "gate_mlp_bwd": 2 * n}
    check(all(tr_counts[k] == v for k, v in want.items())
          and sum(tr_counts.values()) == sum(want.values()),
          f"whisper train: launches {tr_counts} != {want}")
    check(all(np.isfinite(h["loss"]) and h["distill"] > 0 for h in hist),
          f"whisper train: {hist}")
    stats["train"] = {"batch": 2, "seq": WHISPER_S, "steps": hist,
                      "peak_mem_gib":
                          torch.cuda.max_memory_allocated() / 2 ** 30,
                      "launches": tr_counts}
    del state, params
    free_cuda()
    print("whisper: " + json.dumps(stats), flush=True)
    return {"prefill": pf_counts, "decode": dec_counts,
            "forward": fwd_counts, "train": tr_counts}


def qwen2vl_phase(card: str):
    """qwen2-vl-7b at full width and depth (28 layers, d_model 3,584, 28 /
    4 heads of hd 128: G 7; untied vocab 152,064; f32, 28.4 GiB):
    ``launch.serve`` at ``SERVE_REPEATS`` layers (text only, as the
    reference serves it: 2 x 64
    tokens, 8 new, the tau probe, the pool verified), prefill of 4,096
    tokens at budget 1,024 + 16 greedy steps, and the gated forward of a
    2,048-slot stream whose first 1,024 slots are the patch embeddings of
    a 32 x 32 grid (``build_vlm_embeds``), roped by its M-RoPE ids."""
    import torch
    from repro_torch.models import registry as REG
    from repro_torch.models import transformer as T
    arch = "qwen2-vl-7b"
    stats = {"arch": arch, "card": card}
    stats["serve"] = dense_serve(arch, card, repeats=SERVE_REPEATS)
    print("qwen2vl-serve: " + json.dumps(stats["serve"]), flush=True)
    free_cuda()
    cfg, params, stats["init"] = moe_model(arch, 100)
    n = cfg.n_layers
    stats["prefill"], _ = prefill_decode(cfg, params, 101, "qwen2vl-prefill")
    print("qwen2vl-prefill: " + json.dumps(stats["prefill"]), flush=True)
    free_cuda()
    gen = torch.Generator(device="cuda").manual_seed(102)
    toks = torch.randint(0, cfg.vocab_size - 8, (1, 2048), generator=gen,
                         device="cuda")
    patches = 0.02 * torch.randn((1, 1024, cfg.d_model), generator=gen,
                                 device="cuda")
    emb, pos = REG.build_vlm_embeds(params, cfg, toks, patches, (32, 32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        res = T.forward(params, cfg, embeds=emb, positions=pos, mode="gated",
                        with_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["gated_flash"] == n and counts["gate_mlp"] == n
          and sum(counts.values()) == 2 * n,
          f"qwen2vl-forward: launches {counts}")
    check(tuple(res.gates.shape) == (n, 1, cfg.n_kv_heads, 2048)
          and bool(torch.isfinite(res.hidden).all()),
          "qwen2vl-forward: gates or hidden")
    stats["forward"] = {
        "seq": 2048, "patches": 1024, "grid": [32, 32],
        "forward_ms": wall * 1e3,
        "admitted_frac_image": float((res.gates[..., :1024]
                                      >= cfg.wgkv.tau).float().mean()),
        "admitted_frac_text": float((res.gates[..., 1024:]
                                     >= cfg.wgkv.tau).float().mean()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts}
    del res, emb, params
    free_cuda()
    print("qwen2vl: " + json.dumps({k: stats[k] for k in (
        "init", "forward")}), flush=True)
    return {k: stats[k]["launches"] for k in ("serve", "prefill", "forward")}


def fig8_full(card: str, cfg, params):
    """Fig. 8's method (``repro_torch.benchmarks.bench_fig8_efficiency.
    measure``) at full-width qwen3-0.6b: S 1,024, 2,048 and 4,096 at
    budget S / 4, the WG-KV prefill and decode step against the dense
    ones, and both caches' bytes. Each timed entry carries its launches
    per call, which must be one of each of its kernels a layer and
    nothing else: ``gate_mlp`` and ``vertical_slash`` in the WG-KV
    prefill, ``gate_mlp`` and ``paged_decode`` in its decode step,
    ``gated_flash`` (the causal form) in the dense prefill and
    ``paged_decode`` in its decode step. Phase 3's ``fig8`` cases hold
    each of these kernels against its plain version at these shapes."""
    from repro_torch.benchmarks.bench_fig8_efficiency import measure, rows_of
    n = cfg.n_layers
    want = {"prefill_wgkv": {"gate_mlp": n, "vertical_slash": n},
            "decode_wgkv": {"gate_mlp": n, "paged_decode": n},
            "prefill_full": {"gated_flash": n},
            "decode_full": {"paged_decode": n}}
    out = {}
    for m in measure(cfg, params, (1024, 2048, 4096)):
        for name, us, derived in rows_of(m):
            print(f"fig8 {name},{us:.1f},{derived} ({card})", flush=True)
        s = m["s"]
        for kind, launches in want.items():
            got = m[kind]["launches"]
            check(got == launches,
                  f"fig8: {kind}_s{s} launched {got}, want {launches}")
            out[f"{kind}_s{s}"] = dict(m[kind], ms=m[kind]["us"] / 1e3)
        check(m["bytes"]["wgkv"] < m["bytes"]["full"],
              f"fig8: S {s}: WG-KV's cache is not the smaller one")
        out[f"cache_bytes_s{s}"] = m["bytes"]
        out[f"mean_admission_s{s}"] = m["mean_admission"]
    return out


def _tau_margin(cfg, params, toks, taus) -> float:
    """The least distance of a gate score from any of ``taus`` in the
    gated forward of ``toks`` (on the CPU): how near a flip the card's
    comparison with the CPU stands."""
    import torch
    from repro_torch.models import transformer as T
    with torch.no_grad():
        g = T.forward(params, cfg, torch.as_tensor(toks), mode="gated").gates
    return min(float((g - t).abs().min()) for t in taus)


def figures_phase(card: str):
    """The paper's figure benchmarks and the four examples on the card:

    * ``repro_torch.benchmarks.run`` over every module (serving at its
      smoke trace, as ``MODULE_KWARGS`` asks, its record into a temp
      dir), on ``cuda``: no ``_error`` row, the card line first;
    * fig7's rows and fig13's per-head admission computed on the card
      equal to the same functions on the CPU, on batches drawn on the
      host (the least distance of a gate from a tau the figures
      threshold at is printed beside them);
    * the four examples (``train_gate --small`` with 4 + 4 steps, its
      gates into a temp dir): serve_longcontext's pool drains to 0 pages
      and its paged read stays within 2e-3.

    Returns the launch counts over the phase; every kernel of these
    paths must have launched."""
    import io
    import tempfile

    import numpy as np
    import torch
    from repro_torch.benchmarks import bench_fig7_memory_accuracy as F7
    from repro_torch.benchmarks import bench_fig13_patterns as F13
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import needle_batch, trained_model
    from repro_torch.examples import (composability, quickstart,
                                      serve_longcontext, train_gate)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(buf):
        rc = bench_run.main(["--serving-json",
                             str(Path(tmp) / "BENCH_serving_torch.json")])
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"figures: {ln}")
    errors = [ln for ln in lines if "/_error," in ln]
    check(rc == 0 and not errors, f"figures: benchmarks.run: {errors[:3]}")
    check(lines[0] == card, f"figures: runner's device line {lines[0]!r}")
    walls = {ln.split("/")[0]: float(ln.split(",")[1]) / 1e6
             for ln in lines if "/_wall_s," in ln}
    check(set(walls) == set(bench_run.MODULES),
          f"figures: modules run {sorted(walls)}")
    stats = {"card": card, "runner_s": time.perf_counter() - t0,
             "module_s": walls}
    # card against CPU on the same host-drawn batches
    t1 = time.perf_counter()
    batches = {777: needle_batch(777, 32, "cpu"),
               778: needle_batch(778, 16, "cpu"),
               5: needle_batch(5, 8, "cpu")}
    f7_card, f7_cpu = (F7.run(d, batches=batches) for d in ("cuda", "cpu"))
    toks = F13.task_tokens("cpu")
    f13_card, f13_cpu = (F13.run(d, tokens=toks) for d in ("cuda", "cpu"))
    sizes_card, sizes_cpu = ([F13._per_head_sizes(*trained_model(device=d),
                                                  t) for t in toks]
                             for d in ("cuda", "cpu"))
    cfg, params = trained_model(device="cpu")
    margin = {
        "fig7_acc": _tau_margin(cfg, params, batches[777]["tokens"],
                                (0.02, 0.1, 0.3, 0.6, 0.9)),
        "fig7_size": _tau_margin(cfg, params, batches[778]["tokens"],
                                 (0.02, 0.1, 0.3, 0.6, 0.9)),
        "fig13": min(_tau_margin(cfg, params, t, (cfg.wgkv.tau,))
                     for t in toks)}
    stats.update(tau_margin=margin, fig7=[r[2] for r in f7_card],
                 fig13=[r[2] for r in f13_card],
                 card_vs_cpu_s=time.perf_counter() - t1)
    check(f7_card == f7_cpu,
          f"figures: fig7 card {f7_card} != CPU {f7_cpu} "
          f"(gates' least distance from a tau {margin})")
    check(all(np.array_equal(a, b) for a, b in zip(sizes_card, sizes_cpu))
          and f13_card == f13_cpu,
          f"figures: fig13 card != CPU (least distance {margin})")
    # the four examples
    ex = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod, argv in (
                ("quickstart", quickstart, []),
                ("composability", composability, []),
                ("serve_longcontext", serve_longcontext, []),
                ("train_gate", train_gate, [
                    "--small", "--pretrain-steps", "4", "--gate-steps", "4",
                    "--out", str(Path(tmp) / "wgkv_gates.npz")])):
            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = mod.main(argv)
            torch.cuda.synchronize()
            ex[name] = {"s": time.perf_counter() - t1,
                        "last_lines": buf.getvalue().splitlines()[-2:]}
            if name == "serve_longcontext":
                check(res["pool_pages"] == 0
                      and res["verify_paged"] is not None
                      and res["verify_paged"] < 2e-3,
                      f"figures: serve_longcontext pool {res['pool_pages']}"
                      f" pages, paged deviation {res['verify_paged']}")
                ex[name].update(verify_paged=res["verify_paged"],
                                ticks=res["ticks"])
            if name == "train_gate":
                check(all(np.isfinite(h["loss"]) for h in res["history"]),
                      "figures: train_gate loss not finite")
                check((Path(tmp) / "wgkv_gates.npz").exists(),
                      "figures: train_gate wrote no gates")
    counts = read_counts()
    stats.update(examples=ex, launches=counts,
                 wall_s=time.perf_counter() - t0)
    print("figures: " + json.dumps(stats), flush=True)
    for name in ("gate_mlp", "paged_decode", "paged_decode_selected",
                 "vertical_slash", "gated_flash", "gate_mlp_bwd",
                 "gated_flash_bwd"):
        check(counts[name] > 0, f"figures: {name} never launched: {counts}")
    return counts


# --------------------------------------------------------------------------
# mesh-steps: the sharded step bundles (train with FSDP, prefill, decode,
# context-parallel decode) against the flat bundles of the same shapes
# --------------------------------------------------------------------------
MS_DECODE_STEPS = 16
MS_TRAIN = ("train_1k", 1024, 2, "train")
# the 2 x 1 mesh's train step: FSDP's gathers and their backward over
# "data" and the gate gradients summed over the rows, at a shorter
# sequence (gloo's zero-filled sums of the gathers set its time)
MS_TRAIN_DATA = ("train_256", 256, 2, "train")
MS_PREFILL = {(1, 1): ("prefill_4k", 4096, 1, "prefill"),
              (1, 2): ("prefill_4k", 4096, 1, "prefill"),
              (2, 1): ("prefill_512", 512, 2, "prefill")}
MS_TRAIN_LAUNCHES = {"gate_mlp": 56, "gated_flash": 56, "gate_mlp_bwd": 28,
                     "gated_flash_bwd": 28}   # remat: forward twice
MS_PREFILL_LAUNCHES = {"gate_mlp": 28, "vertical_slash": 28}
MS_DECODE_LAUNCHES = {"gate_mlp": 28, "paged_decode": 28}


def ms_shape(spec):
    from repro_torch.configs.base import InputShape
    return InputShape(*spec)


def ms_model(device):
    """Full-width qwen3-0.6b, f32, weights drawn on ``device`` from seed
    0 (every rank draws the same)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("qwen3-0.6b").replace(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_model(cfg, gen, device)


def ms_counts(wc) -> dict:
    rec = wc.record()
    return {"flops": rec["flops"], "bytes": rec["bytes"],
            "kernels": {k: v["launches"] for k, v in rec["kernels"].items()},
            "collectives": dict(rec["collective_bytes_by_axis"])}


def ms_ints(tree) -> dict:
    """{path: numpy} of a cache tree's integer leaves."""
    import torch
    from repro_torch.tree import tree_leaves_with_path
    return {tuple(str(k) for k in p): x.cpu().numpy()
            for p, x in tree_leaves_with_path(tree)
            if not torch.is_floating_point(x)}


def ms_step(fn, *args, aten: bool = True):
    """``fn(*args)`` under the work counter, with the launch counters'
    deltas and the wall: (out, counts, launches, wall s). ``aten=False``:
    the kernels and collectives only (no per-op dispatch mode, which
    slows a loop of thousands of small ops such as the sLSTM's)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.roofline.counter import WorkCounter
    torch.cuda.synchronize()
    reset_counts()
    # the identity page tables are cached per process: a count that
    # starts from none does not depend on what ran before (as the dry
    # run's)
    ops._identity_tables.cache_clear()
    t0 = time.perf_counter()
    with WorkCounter(aten=aten) as wc:
        out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, ms_counts(wc), {k: v for k, v in read_counts().items()
                                if v}, wall


def ms_args(bundle, mesh, batch=None):
    """The bundle's args, its inputs replaced by ``batch`` (whole tensors;
    on a mesh the rank's blocks under the bundle's input specs) when
    given."""
    from repro_torch.sharding import rules
    if batch is None:
        return bundle.args
    if mesh is not None:
        specs = bundle.in_shardings[-1]
        batch = {k: rules.local_shard(v, specs[k], mesh.coords, mesh)
                 for k, v in batch.items()}
    return bundle.args[:-1] + (batch,)


def ms_run(mesh, cfg, params, prefill_spec, seq: bool = False,
           train: bool = True, train_spec=MS_TRAIN,
           decode_steps: int = MS_DECODE_STEPS, feed=None) -> dict:
    """One train step (``train``, of ``train_spec``), one prefill and
    ``decode_steps`` greedy decode steps on its caches through
    ``make_bundle`` (``mesh=None``: the flat bundles), on the card, each
    step's first call under the work counter (the other decode steps
    timed without it); with ``seq`` also one decode step of the flat 1 x
    4,096 prefill's row with its global cache split over "data".
    ``feed``: {"train", "prefill"} whole inputs in place of the bundles'
    own (:func:`ms_args`)."""
    import torch
    from repro_torch.launch.steps import make_bundle
    from repro_torch.models import inference as I
    from repro_torch.sharding import rules
    res = {}
    feed = feed or {}
    if train:
        tr = make_bundle(cfg, ms_shape(train_spec), use_wgkv=True,
                         device="cuda", params=params, mesh=mesh)
        (state, aux), cnt, lc, wall = ms_step(
            tr.fn, *ms_args(tr, mesh, feed.get("train")))
        res["train"] = {"loss": float(aux["loss"]), "counts": cnt,
                        "launches": lc, "wall_s": wall,
                        "gates": {k: v.cpu().numpy()
                                  for k, v in state.gates.items()}}
        del tr, state
    pre = make_bundle(cfg, ms_shape(prefill_spec), use_wgkv=True,
                      device="cuda", params=params, mesh=mesh)
    (logits, adm, caches), cnt, lc, wall = ms_step(
        pre.fn, *ms_args(pre, mesh, feed.get("prefill")))
    res["prefill"] = {"logits": logits.cpu().numpy(), "adm": float(adm),
                      "counts": cnt, "launches": lc, "wall_s": wall,
                      "ints": ms_ints(caches)}
    del pre
    name, s, b, _ = prefill_spec
    dec = make_bundle(cfg, ms_shape(("decode_" + name, s, b, "decode")),
                      use_wgkv=True, device="cuda", params=params,
                      caches=caches, mesh=mesh)
    token = logits.argmax(-1).to(torch.int32)
    (logits, caches), cnt, lc, _ = ms_step(dec.fn, dec.args[0], caches,
                                           {"token": token})
    res["decode_counts"], res["decode_launches"] = cnt, lc
    token = logits.argmax(-1).to(torch.int32)
    steps = [(logits.cpu().numpy(), token.cpu().numpy())]
    t0 = time.perf_counter()
    for _ in range(decode_steps - 1):
        logits, caches = dec.fn(dec.args[0], caches, {"token": token})
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.cpu().numpy(), token.cpu().numpy()))
    res["decode"] = {"steps": steps, "ints": ms_ints(caches),
                     "ms_per_step": (time.perf_counter() - t0) * 1e3
                     / (decode_steps - 1)}
    del dec, caches
    if seq:
        with torch.no_grad():
            out, flat = I.prefill(params, cfg, ms_tokens(cfg, 1, 4096),
                                  use_wgkv=True,
                                  budget=cfg.wgkv.global_budget(4096),
                                  max_len=4096 + 64)
        caches = rules.local_caches(flat, cfg, mesh, mesh.coords,
                                    seq_shard=True)
        del flat
        sd = make_bundle(cfg, ms_shape(("decode_seq", 4096, 1, "decode")),
                         use_wgkv=True, device="cuda", params=params,
                         caches=caches, mesh=mesh)
        token = out.logits.argmax(-1).to(torch.int32)
        (logits, _), cnt, lc, wall = ms_step(sd.fn, sd.args[0], caches,
                                             {"token": token})
        res["seq"] = {"logits": logits.cpu().numpy(), "counts": cnt,
                      "launches": lc, "wall_s": wall,
                      "block": int(caches["blocks"]["b0"].gk.shape[3]),
                      "gcnt_max": int(caches["blocks"]["b0"].gcnt.max())}
    return res


def ms_tokens(cfg, b: int, s: int):
    """The prefill bundle's tokens (``launch.specs``: seed 0 on the CPU)."""
    from repro_torch.launch import specs as S
    return S.prefill_inputs(cfg, ms_shape(("p", s, b, "prefill")),
                            "cuda")["tokens"]


def mesh_steps_rank(mesh):
    """One rank of a mesh-steps world: its shard of the model and
    :func:`ms_run`."""
    import torch
    cfg, params = ms_model(mesh.device)
    t0 = time.perf_counter()
    shape = (mesh.shape["data"], mesh.shape["model"])
    # no train step on 1 x 2: the split plan's train step runs in
    # mesh-encdec (whisper's and qwen2-vl's heads split in two)
    res = ms_run(mesh, cfg, params, MS_PREFILL[shape],
                 seq=shape == (2, 1), train=shape != (1, 2),
                 train_spec=MS_TRAIN_DATA)
    res["wall_s"] = time.perf_counter() - t0
    res["coords"] = mesh.coords
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


def ms_meta(cfg, shape, backend, seq: bool, prefill_spec=None,
            train_spec=MS_TRAIN) -> dict:
    """Rank (0, 0)'s counts of the same bundles on ``meta`` over a fake
    process group that stands for ``backend`` (each from no cached page
    table, as :func:`ms_step`'s); ``prefill_spec`` default
    ``MS_PREFILL[shape]``, no train step for ``train_spec`` None."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch.steps import make_bundle
    from repro_torch.models import inference as I
    from repro_torch.roofline.counter import WorkCounter
    from repro_torch.sharding import rules
    out = {}
    prefill_spec = prefill_spec or MS_PREFILL[shape]
    with M.fake_mesh(shape, backend=backend) as mesh:
        for tag, spec in (("train", train_spec), ("prefill", prefill_spec)):
            if spec is None:
                continue
            b = make_bundle(cfg, ms_shape(spec), use_wgkv=True, mesh=mesh)
            ops._identity_tables.cache_clear()
            with WorkCounter() as wc:
                res = b.fn(*b.args)
            out[tag] = ms_counts(wc)
        name, s, bb, _ = prefill_spec
        d = make_bundle(cfg, ms_shape(("decode_" + name, s, bb, "decode")),
                        use_wgkv=True, caches=res[2], mesh=mesh)
        ops._identity_tables.cache_clear()
        with WorkCounter() as wc:
            d.fn(*d.args)
        out["decode"] = ms_counts(wc)
        if seq:
            b = make_bundle(cfg, ms_shape(("p", 4096, 1, "prefill")),
                            use_wgkv=True)
            flat = I.prefill(b.args[0], cfg, b.args[1]["tokens"],
                             use_wgkv=True,
                             budget=cfg.wgkv.global_budget(4096),
                             max_len=4096 + 64)[1]
            caches = rules.local_caches(flat, cfg, mesh, mesh.coords,
                                        seq_shard=True)
            d = make_bundle(cfg, ms_shape(("decode_seq", 4096, 1, "decode")),
                            use_wgkv=True, caches=caches, mesh=mesh)
            ops._identity_tables.cache_clear()
            with WorkCounter() as wc:
                d.fn(*d.args)
            out["seq"] = ms_counts(wc)
    return out


def ms_check(tag, cfg, shape, res, flat, meta, rank0: bool,
             launches=None, scaled: bool = False) -> dict:
    """Holds one rank's run to the flat run of the same shapes, its
    launches to ``launches`` (``{"train", "prefill", "decode"}``; default
    the counts from qwen3-0.6b's shapes), its collective bytes by axis to
    rank (0, 0)'s in the fake-group meta run (the dry run's counter: in
    ring accounting every rank moves what rank (0, 0) moves) and, for
    rank (0, 0), all its counts to the meta run's. A run without a train
    step skips its holds. ``scaled``: the logits within 1e-4 of the flat
    logits' largest magnitude (at least 1), where the MoE experts' sums
    in another order reach further than 1e-4 absolute. Returns its
    summary."""
    import numpy as np
    import torch
    from repro_torch.sharding import rules
    launches = launches or {"train": MS_TRAIN_LAUNCHES,
                            "prefill": MS_PREFILL_LAUNCHES,
                            "decode": MS_DECODE_LAUNCHES}
    mesh = {"data": shape[0], "model": shape[1]}
    coords = res["coords"]
    rel = gate_err = None
    if "train" in res:
        f_tr, m_tr = flat["train"], res["train"]
        rel = abs(m_tr["loss"] - f_tr["loss"]) / abs(f_tr["loss"])
        check(rel <= 1e-5, f"{tag}: loss {m_tr['loss']} vs flat "
              f"{f_tr['loss']} ({rel:.2e} relative)")
        gate_err = 0.0
        for key, want in f_tr["gates"].items():
            spec = rules.param_placement(tuple(key.split("/")), want.shape,
                                         mesh, cfg, replicate_fsdp=False)
            blk = rules.local_shard(torch.from_numpy(want), spec, coords,
                                    mesh).numpy()
            gate_err = max(gate_err,
                           float(np.abs(m_tr["gates"][key] - blk).max()))
        check(gate_err <= 1e-4, f"{tag}: new gates differ by {gate_err:.3e}")
        check(res["train"]["launches"] == launches["train"],
              f"{tag}: train launches {res['train']['launches']}")
    rows = rules.block(flat["prefill"]["logits"].shape[0],
                       rules.tokens_spec(mesh, flat["prefill"]["logits"]
                                         .shape[0], 0)[0], coords, mesh)
    lg_err = float(np.abs(res["prefill"]["logits"]
                          - flat["prefill"]["logits"][rows]).max())
    for (lg, tok), (flg, ftok) in zip(res["decode"]["steps"],
                                      flat["decode"]["steps"]):
        check(np.array_equal(tok, ftok[rows]), f"{tag}: greedy tokens "
              f"{tok} != flat {ftok[rows]}")
        lg_err = max(lg_err, float(np.abs(lg - flg[rows]).max()))
    lg_scale = 1.0
    if scaled:
        lg_scale = max(1.0, float(np.abs(flat["prefill"]["logits"]).max()),
                       *(float(np.abs(flg).max())
                         for flg, _ in flat["decode"]["steps"]))
    check(lg_err <= 1e-4 * lg_scale, f"{tag}: logits differ by "
          f"{lg_err:.3e} (scale {lg_scale:.3g})")
    for part in ("prefill", "decode"):
        for path, want in flat[part]["ints"].items():
            spec = rules.cache_placement(path, want.shape, mesh, cfg)
            blk = rules.local_shard(torch.from_numpy(want), spec, coords,
                                    mesh).numpy()
            check(np.array_equal(res[part]["ints"][path], blk),
                  f"{tag}: {part} cache leaf {'/'.join(path)} differs")
    check(res["prefill"]["launches"] == launches["prefill"],
          f"{tag}: prefill launches {res['prefill']['launches']}")
    check(res["decode_launches"] == launches["decode"],
          f"{tag}: decode launches {res['decode_launches']}")
    kinds = [("prefill", res["prefill"]["counts"]),
             ("decode", res["decode_counts"])]
    if "train" in res:
        kinds.insert(0, ("train", res["train"]["counts"]))
    if "seq" in res:
        kinds.append(("seq", res["seq"]["counts"]))
    coll = {}
    for kind, cnt in kinds:
        want = meta[kind]["collectives"]
        check(cnt["collectives"] == want, f"{tag}: {kind} collective bytes "
              f"{cnt['collectives']} != the meta run's {want}")
        coll[kind] = cnt["collectives"]
        if rank0:
            check(cnt == meta[kind], f"{tag}: {kind} counts on the card "
                  f"{cnt} != the fake-group meta run's {meta[kind]}")
    out = {"train_wall_s": res.get("train", {}).get("wall_s"),
           "prefill_wall_s": res["prefill"]["wall_s"],
           "decode_ms_per_step": res["decode"]["ms_per_step"],
           "loss_rel_err": rel, "gate_err": gate_err, "logit_err": lg_err,
           "logit_scale": lg_scale,
           "collective_bytes": coll}
    if "seq" in res:
        f1 = flat["seq_logits"]
        err = float(np.abs(res["seq"]["logits"] - f1).max())
        check(err <= 1e-4, f"{tag}: seq-sharded decode logits differ by "
              f"{err:.3e}")
        check(res["seq"]["launches"] == MS_DECODE_LAUNCHES,
              f"{tag}: seq decode launches {res['seq']['launches']}")
        out.update(seq_logit_err=err, seq_block=res["seq"]["block"],
                   seq_gcnt_max=res["seq"]["gcnt_max"],
                   seq_wall_s=res["seq"]["wall_s"])
    return out


def ms_host_runs(cfg) -> tuple:
    """The phase's runs on ``meta`` (host work alone): the 16 x 16 dry
    run's rank-0 record of train_4k, and rank (0, 0)'s counts of the
    phase's bundles on each of its meshes (:func:`ms_meta`)."""
    from repro_torch.launch import dryrun as D
    rec = D.run_dryrun("qwen3-0.6b", "train_4k", mesh="single")
    return rec, {(1, 1): ms_meta(cfg, (1, 1), "nccl", False),
                 (1, 2): ms_meta(cfg, (1, 2), "gloo", False,
                                 train_spec=None),
                 (2, 1): ms_meta(cfg, (2, 1), "gloo", True,
                                 train_spec=MS_TRAIN_DATA)}


def mesh_steps_phase(card: str):
    """The sharded step bundles at full-width qwen3-0.6b (28 layers, f32,
    seed-0 weights): one train step at 2 x 1,024 (remat, FSDP over
    "data"; 2 x 256 on 2 x 1; none on 1 x 2, whose split plan mesh-encdec
    trains), one prefill (1 x 4,096 at budget 1,024; 2 x 512 on 2 x 1)
    and 16 greedy decode steps on its caches, on a 1 x 1 NCCL mesh (in
    this process), a 1 x 2 gloo mesh (heads 8 / 4 a rank) and a 2 x 1
    gloo mesh (a row a rank: FSDP's gathers over "data" and
    their backward, the gate gradients summed over the rows; and one
    decode step of the flat 1 x 4,096 prefill's row, its global cache
    split over "data"), each
    held to the flat bundles of the same shapes and to the fake-group meta
    run (ms_check), and the 16 x 16 dry run's rank-0 record of train_4k
    printed. The meta runs, host work in this process, overlap the gloo
    ranks, which run in their own processes. Returns each run's launches
    (its train step, prefill and first decode step)."""
    import socket
    from concurrent.futures import ThreadPoolExecutor
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    cfg, params = ms_model("cuda")
    t0 = time.perf_counter()
    flat = {MS_PREFILL[(1, 2)]: ms_run(None, cfg, params, MS_PREFILL[(1, 2)])}
    flat[MS_PREFILL[(2, 1)]] = ms_run(None, cfg, params, MS_PREFILL[(2, 1)],
                                      train_spec=MS_TRAIN_DATA)
    # the seq-sharded decode (2 x 1) reads the 1 x 4,096 prefill's cache:
    # its flat first decode step is the yardstick
    flat[MS_PREFILL[(2, 1)]]["seq_logits"] = \
        flat[MS_PREFILL[(1, 2)]]["decode"]["steps"][0][0]
    flat_wall = time.perf_counter() - t0
    def launches(res):
        """The run's launches: its train step, prefill and first decode
        step (and the seq-sharded step) added."""
        tot = {}
        for lc in (res.get("train", {}).get("launches", {}),
                   res["prefill"]["launches"],
                   res["decode_launches"],
                   res.get("seq", {}).get("launches", {})):
            for k, v in lc.items():
                tot[k] = tot.get(k, 0) + v
        return tot
    out = {"flat_wall_s": flat_wall, "flat": {
        "train_wall_s": flat[MS_PREFILL[(1, 2)]]["train"]["wall_s"],
        "train_256_wall_s": flat[MS_PREFILL[(2, 1)]]["train"]["wall_s"],
        **{f"{spec[0]} {k}": flat[spec][part][key]
           for spec in (MS_PREFILL[(1, 2)], MS_PREFILL[(2, 1)])
           for k, part, key in (("prefill_wall_s", "prefill", "wall_s"),
                                ("decode_ms_per_step", "decode",
                                 "ms_per_step"))}}}
    counts = {"flat": launches(flat[MS_PREFILL[(1, 2)]])}
    # 1 x 1 over NCCL, in this process
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = M.init_mesh((1, 1), backend="nccl", device="cuda")
        one = ms_run(mesh, cfg, params, MS_PREFILL[(1, 1)])
        one["coords"] = mesh.coords
    finally:
        dist.destroy_process_group()
    one_wall = time.perf_counter() - t0
    del params
    free_cuda()
    ranks, walls = {}, {}
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(ms_host_runs, cfg)
        for shape in ((1, 2), (2, 1)):
            t0 = time.perf_counter()
            ranks[shape] = M.spawn(mesh_steps_rank, shape, backend="gloo",
                                   device="cuda", timeout_s=600)
            walls[shape] = time.perf_counter() - t0
        rec, meta = host.result()
    print("mesh-steps dryrun 16x16 train_4k rank 0: " + json.dumps({
        k: rec[k] for k in ("knobs", "memory", "collectives", "compute_s",
                            "memory_s", "collective_s", "bottleneck")}
        | {"flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes"],
           "launches": {k: v["launches"]
                        for k, v in rec["cost"]["kernels"].items()}}),
        flush=True)
    out["1x1 nccl"] = ms_check("mesh-steps 1x1", cfg, (1, 1), one,
                               flat[MS_PREFILL[(1, 1)]], meta[(1, 1)], True)
    out["1x1 nccl"]["wall_s"] = one_wall
    counts["1x1 nccl"] = launches(one)
    for shape in ((1, 2), (2, 1)):
        tag = f"{shape[0]}x{shape[1]} gloo"
        out[tag] = {"wall_s": walls[shape]}
        for r, res in sorted(ranks[shape].items()):
            out[tag][f"rank {r}"] = ms_check(
                f"mesh-steps {tag} rank {r}", cfg, shape, res,
                flat[MS_PREFILL[shape]], meta[shape], r == 0)
            out[tag][f"rank {r}"].update(wall_s=res["wall_s"],
                                         peak_bytes=res["peak_bytes"])
        counts[tag] = launches(ranks[shape][0])
    print("mesh-steps: " + json.dumps(out), flush=True)
    return counts


# --------------------------------------------------------------------------
# mesh-archs: the MoE and hybrid archs on the mesh (expert-parallel MoE,
# channel-parallel RG-LRU), served and stepped against the flat port
# --------------------------------------------------------------------------
# arch -> (repeats kept, weight seed, train spec or None, prefill spec,
# decode steps); every run of an arch (flat and mesh) at that depth.
# recurrentgemma-9b keeps one repeat (its 2-block RG-LRU stem, then
# RG-LRU, RG-LRU, local attention). Its 1 x 2 train step (the split
# plan's gate training, ``rglru_scan_bwd`` on half the channels), which
# needed a second repeat for an RG-LRU block past the first gate, was cut
# for the script's time: mesh-xlstm trains the split plan (every
# parameter) instead, and phase 3 holds the backward scan at a rank's
# channels
MA_RUNS = {
    "granite-moe-3b-a800m": (8, 80, None, ("prefill_2k", 2048, 1, "prefill"),
                             8),
    "recurrentgemma-9b": (1, 81, None, ("prefill_2k", 2048, 1, "prefill"),
                          8),
    "qwen3-moe-235b-a22b": (1, 82, None, ("prefill_1k", 1024, 1, "prefill"),
                            4),
}


def ma_model(arch: str, device):
    """``arch`` at full width, f32, cut to ``MA_RUNS``' repeats (the
    stem kept), weights drawn on ``device`` from its seed (every rank
    draws the same), the gates admitting fewer tokens than the budget
    holds (:func:`sparse_gates`), so that every choice is exact and the
    runs can be held token for token. With the init's gates, which admit
    almost every token, the top-budget choice among near-equal scores
    turns on the last bits of ``x @ w_k``: :func:`ma_binding` runs that
    case and :func:`ma_tie_check` holds it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    repeats, seed = MA_RUNS[arch][:2]
    cfg = get_config(arch).replace(dtype="float32", n_repeats=repeats)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_model(cfg, gen, device)
    return cfg, params, sparse_gates(cfg, params)


def sparse_gates(cfg, params) -> dict:
    """Every attention block's gate set to admit the tokens whose
    RMS-normalised key has its first coordinate (gate feature 0, about N(0,
    1)) above 1, about 16 % of them, with scores far from tau: hidden unit
    0 reads that feature less 1, the others are off, and ``g =
    sigmoid(200 gelu(x0 - 1) - 4)`` (below sigmoid(-4) = 0.018 for x0 <
    1). The cross attention's gates (whisper's) too. In place; returns
    the init's self-attention gates ({block: {leaf: copy}})."""
    import torch
    init = {}
    for i, bt in enumerate(cfg.block_pattern):
        if "attn" not in bt:
            continue
        node = params["blocks"][f"b{i}"]
        init[f"b{i}"] = {k: v.clone() for k, v in node["attn"]["gate"].items()}
        for mixer in ("attn", "xattn"):
            if mixer not in node:
                continue
            gate = node[mixer]["gate"]
            with torch.no_grad():
                for k in ("w1", "b1", "w2"):
                    gate[k].zero_()
                gate["w1"][:, :, 0, 0] = 1.0
                gate["b1"][:, :, 0] = -1.0
                gate["w2"][:, :, 0, 0] = 200.0
                gate["b2"].fill_(-4.0)
    return init


# the binding-budget run: granite-moe-3b-a800m's prefill (1 x 2,048,
# budget 512, the phase's 8 layers) with the init's gates put back; they
# admit almost every token, so the budget binds at every layer. Layer 0
# reads the embeddings, the same bits flat and on a 1 x 2 rank: there the
# gate scores must agree within MA_TIE_EPS and the top-budget choices
# may differ only where a flat score lies within MA_TIE_EPS of the lowest
# one chosen. Deeper layers read inputs that the sums in another order
# have moved (by the layer's score gap d_L): up to the first choice that
# differs, a flipped position must lie within 2 d_L of that edge, as a
# top-budget choice under scores that differ by at most d_L allows. The
# same holds for each MoE layer's expert choice (a token's top-k may
# change only where two of its top k + 1 router probabilities lie within
# twice the layer's probability gap). Past the first choice that differs
# the inputs differ by whole tokens and are only read
MA_BINDING = "granite-moe-3b-a800m"
MA_TIE_EPS = 1e-6


def ma_binding(mesh, cfg, params, gates, spec=None, feed=None) -> dict:
    """A prefill of ``spec`` (default :data:`MA_BINDING`'s ``MA_RUNS``
    spec; ``feed``: its whole inputs in place of the bundle's own)
    through the bundles on ``mesh`` (None: flat), its attention gates
    first set back to ``gates`` (in place), with layer 0's input and
    ``k_pre`` (``x @ w_k``) and every layer's gate scores, top-budget
    choice, router probabilities and experts captured (numpy). Flat, also
    layer 0's gate scores of each 1 x 2 rank's kv heads computed from the
    flat keys (``g_split``: the gate at a rank's shapes alone)."""
    import torch
    from repro_torch.launch.steps import make_bundle
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MoE
    for blk, leaves in gates.items():
        with torch.no_grad():
            for k, v in leaves.items():
                params["blocks"][blk]["attn"]["gate"][k].copy_(v)
    spec = spec or MA_RUNS[MA_BINDING][3]
    pre = make_bundle(cfg, ms_shape(spec), use_wgkv=True, device="cuda",
                      params=params, mesh=mesh)
    got = {"layers": []}
    inner, proj, route = A.attn_prefill_budgeted, A.project_qkv, MoE.route

    def project_qkv(*args, **kw):
        out = proj(*args, **kw)
        if "x" in got:
            return out
        got["x"], got["k"] = args[2].cpu().numpy(), out[1].cpu().numpy()
        if mesh is None:
            half = cfg.n_kv_heads // 2
            got["g_split"] = torch.cat([A.compute_gates(
                {"gate": {k: v[h:h + half]
                          for k, v in args[0]["gate"].items()}},
                out[1][:, h:h + half], out[2][:, h:h + half])
                for h in (0, half)], dim=1).cpu().numpy()
        return out

    def budgeted(*args, **kw):
        A.project_qkv = project_qkv
        try:
            r = inner(*args, **kw)
        finally:
            A.project_qkv = proj
        got["layers"].append({"g": r.g.cpu().numpy(),
                              "idx": r.sel.idx.cpu().numpy(),
                              "valid": r.sel.valid.cpu().numpy()})
        got["budget"] = kw["budget"]
        return r

    def routed(*args, **kw):
        r = route(*args, **kw)
        got["layers"][-1].update(probs=r.probs.cpu().numpy(),
                                 top=r.top_idx.cpu().numpy())
        return r
    A.attn_prefill_budgeted, MoE.route = budgeted, routed
    try:
        logits, _, _ = pre.fn(*ms_args(pre, mesh, feed))
    finally:
        A.attn_prefill_budgeted, MoE.route = inner, route
    got["logits"] = logits.cpu().numpy()
    got["tau"], got["sink"] = cfg.wgkv.tau, cfg.wgkv.sink
    got["exclude_from"] = spec[1] - cfg.wgkv.w_local
    del pre
    return got


def ma_tie_check(tag, flat, rank, kv_heads) -> dict:
    """Holds a rank's :func:`ma_binding` to the flat one's (the rules
    above :data:`MA_BINDING`): layer 0's input bitwise equal, its gate
    scores within :data:`MA_TIE_EPS`, the budget binding at every layer,
    and each kv head's choice and each token's experts equal but for
    near-ties (within :data:`MA_TIE_EPS` of the lowest flat score chosen
    at layer 0, 2 d_L at a deeper layer; experts within twice the
    layer's probability gap), up to the first choice that differs; sinks
    aside. Returns the readings: the elements of the rank's layer-0
    ``x @ w_k`` that differ from the flat one's columns and by how much,
    the gate's own share of the score gap, each layer's gaps, flips and
    their distance from a tie, the first choice that differs, and the
    logits' difference (not held: a flipped choice moves them)."""
    import numpy as np
    h0, nh = kv_heads
    hs = slice(h0, h0 + nh)
    check(np.array_equal(rank["x"], flat["x"]),
          f"{tag}: the attention input differs from the flat run's")
    kf = flat["k"][:, hs]
    out = {"k_pre_differing": int((rank["k"] != kf).sum()),
           "k_pre_elements": int(kf.size),
           "k_pre_max_abs_diff": float(np.abs(rank["k"] - kf).max()),
           "gate_at_rank_heads_max_abs_diff": float(np.abs(
               flat["g_split"][:, hs]
               - flat["layers"][0]["g"][:, hs]).max()),
           "gate_from_rank_k_max_abs_diff": float(np.abs(
               rank["layers"][0]["g"] - flat["g_split"][:, hs]).max()),
           "budget": flat["budget"], "layers": []}
    check(len(rank["layers"]) == len(flat["layers"]),
          f"{tag}: {len(rank['layers'])} budgeted layers, flat "
          f"{len(flat['layers'])}")
    first_flip = None
    for i, (fl, rl) in enumerate(zip(flat["layers"], rank["layers"])):
        gf, gr = fl["g"][:, hs], rl["g"]
        gap = float(np.abs(gr - gf).max())
        pos = np.arange(gf.shape[-1])
        eligible = int(((gf >= flat["tau"]) & (pos >= flat["sink"])
                        & (pos < flat["exclude_from"])).sum(-1).min())
        check(eligible > flat["budget"], f"{tag}: layer {i}'s budget "
              f"{flat['budget']} does not bind ({eligible} eligible)")
        if i == 0:
            check(gap <= MA_TIE_EPS, f"{tag}: layer 0's gate scores differ "
                  f"by {gap:.3e}")
        flips, worst = 0, 0.0
        for b in range(gf.shape[0]):
            for h in range(nh):
                mine = set(rl["idx"][b, h][rl["valid"][b, h]].tolist())
                want = set(fl["idx"][b, h0 + h][fl["valid"][b, h0 + h]]
                           .tolist())
                if mine == want:
                    continue
                edge = min(float(gf[b, h, t]) for t in want
                           if t >= flat["sink"])
                for t in mine ^ want:
                    worst = max(worst, abs(float(gf[b, h, t]) - edge))
                flips += len(mine ^ want)
        if first_flip is None:
            lim = MA_TIE_EPS if i == 0 else 2 * gap
            check(worst <= lim, f"{tag}: layer {i}'s choices differ "
                  f"{worst:.3e} from the budget's edge, past {lim:.3e}")
            if flips:
                first_flip = f"layer {i} global tokens"
        row = {"score_gap": gap, "eligible_min": eligible,
               "flipped": flips, "flipped_max_from_edge": worst}
        if "probs" in fl:
            pf = fl["probs"]
            pgap = float(np.abs(rl["probs"] - pf).max())
            moved = (rl["top"] != fl["top"]).any(-1)
            top = -np.sort(-pf, axis=-1)[..., :fl["top"].shape[-1] + 1]
            near = (top[..., :-1] - top[..., 1:]).min(-1)
            tie = float(near[moved].max()) if moved.any() else 0.0
            if first_flip is None:
                check(tie <= 2 * pgap, f"{tag}: layer {i} routes tokens "
                      f"{tie:.3e} from a tie, past {2 * pgap:.3e}")
                if moved.any():
                    first_flip = f"layer {i} experts"
            row.update(prob_gap=pgap, rerouted=int(moved.sum()),
                       rerouted_max_from_tie=tie)
        out["layers"].append(row)
    out.update(first_flipped_layer=first_flip,
               logit_max_abs_diff=float(np.abs(rank["logits"]
                                               - flat["logits"]).max()))
    return out


def ma_launches(res) -> dict:
    """{"train", "prefill", "decode"}: a run's kernel launches by step."""
    out = {"prefill": res["prefill"]["launches"],
           "decode": res["decode_launches"]}
    if "train" in res:
        out["train"] = res["train"]["launches"]
    return out


def ma_steps(mesh, arch: str, cfg, params) -> dict:
    """:func:`ms_run` of ``arch``'s ``MA_RUNS`` steps on ``mesh`` (None:
    the flat bundles)."""
    _, _, train, prefill, steps = MA_RUNS[arch]
    return ms_run(mesh, cfg, params, prefill, train=train is not None,
                  train_spec=train, decode_steps=steps)


def ma_serve(eng, sentinels: bool) -> dict:
    """The mesh phase's drive (:func:`mesh_drive`) of ``eng`` and its
    integer cache leaves."""
    toks, positions, counts, wall, shapes = mesh_drive(eng, sentinels)
    return {"tokens": toks, "positions": positions, "launches": counts,
            "wall_s": wall, "shapes": shapes, "ints": ms_ints(eng.caches)}


def mesh_archs_rank(mesh, arch: str):
    """One rank of a 1 x 2 gloo world: its shard of ``arch`` (the whole
    model drawn first: building params already sharded is ROADMAP item
    8b.6), granite's serve drive, and the arch's steps."""
    import torch
    from repro_torch.serving.backend import make_backend
    cfg, params, init_gates = ma_model(arch, mesh.device)
    t0 = time.perf_counter()
    out = {}
    if arch == "granite-moe-3b-a800m":
        eng = make_backend("wgkv", params, cfg, slots=MESH_SLOTS,
                           capacity=MESH_CAP, mirror_paged=False, mesh=mesh,
                           device="cuda")
        out["serve"] = ma_serve(eng, sentinels=False)
        out["experts"] = eng.plan.experts
        out["kv_heads"] = eng.plan.kv_heads
        del eng
    out.update(ma_steps(mesh, arch, cfg, params))
    if arch == MA_BINDING:
        out["binding"] = ma_binding(mesh, cfg, params, init_gates)
    out["coords"] = mesh.coords
    out["wall_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def ma_host_runs(cfgs) -> tuple:
    """The phase's runs on ``meta`` (host work alone): the 16 x 16 dry
    run's rank-0 records of qwen3-moe-235b-a22b at train_4k and
    decode_32k (every layer), and rank (0, 0)'s counts of each arch's
    bundles on the 1 x 2 mesh (:func:`ms_meta`)."""
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    recs = {name: D.run_dryrun("qwen3-moe-235b-a22b", name, mesh="single")
            for name in ("train_4k", "decode_32k")}
    recs["host_s"] = time.perf_counter() - t0
    meta = {}
    for arch, cfg in cfgs.items():
        _, _, train, prefill, _ = MA_RUNS[arch]
        meta[arch] = ms_meta(cfg, (1, 2), "gloo", False,
                             prefill_spec=prefill, train_spec=train)
    return recs, meta


def mesh_archs_phase(card: str):
    """The MoE and hybrid archs on a ``data x model`` mesh, full width,
    f32, depth cut (``MA_RUNS``; printed): granite-moe-3b-a800m at 8 of 32
    layers served flat, on a 1 x 1 NCCL mesh (both sentinels) and on a 1
    x 2 gloo mesh (20 of 40 experts and 4 of 8 kv heads a rank), and its
    prefill of 1 x 2,048 (budget 512) and 8 decode steps through the
    bundles; recurrentgemma-9b (its 2-block stem and one repeat) a
    prefill of 1 x 2,048 and 8 decode steps, its RG-LRU channels split
    (2,048 a rank: ``rglru_scan`` on sharded channels);
    qwen3-moe-235b-a22b at one of 94
    repeats (64 of 128 experts a rank) a prefill of 1 x 1,024 and 4
    decode steps; granite's binding-budget prefill (:data:`MA_BINDING`)
    flat and on each rank (:func:`ma_tie_check`). Each mesh run is held
    to the flat run of the same depth with mesh-steps' holds (:func:`ms_check`: tokens and integer cache
    leaves equal, gates within 1e-4, logits within 1e-4 of their scale,
    the loss 1e-5 relative,
    launches equal to the flat run's, collective bytes and rank 0's
    counts equal to the fake-group meta run's), and the 16 x 16 dry
    run's rank-0 records of qwen3-moe-235b-a22b at train_4k and
    decode_32k are printed beside the card's process bytes. Returns each
    run's launches."""
    import socket
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.roofline import analysis as RA
    from repro_torch.serving.backend import make_backend
    cfgs = {arch: get_config(arch).replace(dtype="float32",
                                           n_repeats=MA_RUNS[arch][0])
            for arch in MA_RUNS}
    print("mesh-archs depth: " + json.dumps({
        a: {"n_layers": c.n_layers, "of": get_config(a).n_layers,
            "stem": list(c.stem_pattern), "repeats": c.n_repeats}
        for a, c in cfgs.items()}), flush=True)
    out, counts = {}, {}

    def tally(tag, res):
        tot = {}
        for lc in ma_launches(res).values():
            for k, v in lc.items():
                tot[k] = tot.get(k, 0) + v
        if "serve" in res:
            for k, v in res["serve"]["launches"].items():
                tot[k] = tot.get(k, 0) + v
        counts[tag] = tot

    # the flat runs first, one model on the card at a time: the meta runs
    # (a fake process group, the counter) must not overlap a counted run
    # or the NCCL group of this process
    flat = {}
    for arch in MA_RUNS:
        cfg, params, init_gates = ma_model(arch, "cuda")
        t0 = time.perf_counter()
        res = {}
        if arch == "granite-moe-3b-a800m":
            eng = make_backend("wgkv", params, cfg, slots=MESH_SLOTS,
                               capacity=MESH_CAP, mirror_paged=False,
                               device="cuda")
            res["serve"] = ma_serve(eng, sentinels=True)
            del eng
            # a 1 x 1 mesh over NCCL, in this process, both sentinels
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            dist.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                world_size=1)
            try:
                mesh = M.init_mesh((1, 1), backend="nccl", device="cuda")
                eng = make_backend("wgkv", params, cfg, slots=MESH_SLOTS,
                                   capacity=MESH_CAP, mirror_paged=False,
                                   mesh=mesh, device="cuda")
                one = ma_serve(eng, sentinels=True)
                del eng
            finally:
                dist.destroy_process_group()
            check(one["tokens"] == res["serve"]["tokens"],
                  f"mesh-archs granite 1x1: tokens {one['tokens']} != "
                  f"flat {res['serve']['tokens']}")
            check(one["launches"] == res["serve"]["launches"],
                  f"mesh-archs granite 1x1: launches {one['launches']}")
            out[f"{arch} serve 1x1 nccl"] = {
                "wall_s": one["wall_s"], "shapes": one["shapes"],
                "sync_debug_mode": "error"}
            counts[f"{arch} serve 1x1 nccl"] = one["launches"]
        res.update(ma_steps(None, arch, cfg, params))
        if arch == MA_BINDING:
            res["binding"] = ma_binding(None, cfg, params, init_gates)
        flat[arch] = res
        tally(f"{arch} flat", res)
        out[f"{arch} flat"] = {
            "wall_s": time.perf_counter() - t0,
            "train_wall_s": res.get("train", {}).get("wall_s"),
            "prefill_wall_s": res["prefill"]["wall_s"],
            "decode_ms_per_step": res["decode"]["ms_per_step"]}
        del params
        free_cuda()
    # the gloo ranks, in their own processes, overlap the meta runs
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(ma_host_runs, cfgs)
        for arch in MA_RUNS:
            t0 = time.perf_counter()
            flat[arch]["ranks"] = M.spawn(mesh_archs_rank, (1, 2),
                                          args=(arch,), backend="gloo",
                                          device="cuda", timeout_s=600)
            out[f"{arch} 1x2 gloo"] = {"wall_s": time.perf_counter() - t0}
        recs, meta = host.result()
    out["dryrun_host_s"] = recs.pop("host_s")
    for arch, res in flat.items():
        cfg = cfgs[arch]
        tag = f"{arch} 1x2 gloo"
        for r, rr in sorted(res["ranks"].items()):
            summary = ms_check(f"mesh-archs {arch} 1x2 rank {r}", cfg, (1, 2),
                               rr, res, meta[arch], r == 0,
                               launches=ma_launches(res), scaled=True)
            summary.update(wall_s=rr["wall_s"], peak_bytes=rr["peak_bytes"])
            if "serve" in rr:
                check(rr["serve"]["tokens"] == res["serve"]["tokens"],
                      f"{tag} rank {r}: served tokens "
                      f"{rr['serve']['tokens']} != flat "
                      f"{res['serve']['tokens']}")
                check(rr["serve"]["launches"] == res["serve"]["launches"],
                      f"{tag} rank {r}: serve launches "
                      f"{rr['serve']['launches']}")
                h0, nh = rr["kv_heads"]
                for path, want in res["serve"]["ints"].items():
                    mine = rr["serve"]["ints"][path]
                    ax = 1 if "blocks" in path else 0
                    if mine.ndim > ax + 1 and \
                            mine.shape[ax + 1] != want.shape[ax + 1]:
                        want = np.take(want, range(h0, h0 + nh), axis=ax + 1)
                    check(np.array_equal(mine, want),
                          f"{tag} rank {r}: served cache {path} differs")
                summary.update(serve_wall_s=rr["serve"]["wall_s"],
                               experts=rr["experts"],
                               serve_positions=rr["serve"]["positions"])
            if "binding" in rr:
                summary["binding"] = ma_tie_check(
                    f"{tag} rank {r} binding", res["binding"],
                    rr["binding"], rr["kv_heads"])
            out[tag][f"rank {r}"] = summary
        tally(tag, res["ranks"][0])
    rg = counts["recurrentgemma-9b 1x2 gloo"]
    check(rg.get("rglru_scan", 0) > 0,
          f"mesh-archs: the RG-LRU scan did not run on sharded channels: "
          f"{rg}")
    for name, rec in recs.items():
        print(f"mesh-archs dryrun 16x16 qwen3-moe-235b-a22b {name} rank 0: "
              + json.dumps({k: rec[k] for k in (
                  "knobs", "memory", "collectives", "compute_s", "memory_s",
                  "collective_s", "bottleneck")}
                  | {"flops": rec["cost"]["flops"],
                     "bytes": rec["cost"]["bytes"],
                     "peak_over_h100_process_bytes":
                         rec["memory"]["peak_bytes"] / RA.H100_PROCESS_BYTES,
                     "launches": {k: v["launches"] for k, v in
                                  rec["cost"]["kernels"].items()}}),
              flush=True)
    print("mesh-archs: " + json.dumps({"card": card, "runs": out}),
          flush=True)
    return counts


# --------------------------------------------------------------------------
# mesh-encdec: the seq-sharded reads' kernel cases, whisper-medium and
# qwen2-vl-7b on the mesh, and the seq-sharded dense and Quest reads
# --------------------------------------------------------------------------
def _lse_join(parts):
    """Reads of disjoint key sets [(out, lse)] joined by their log-sum-exp
    (``comm.combine_lse``'s formula, in f32)."""
    import torch
    m = torch.maximum(parts[0][1], parts[1][1])
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    wts = [torch.where(torch.isfinite(l), torch.exp(l - m),
                       torch.zeros_like(l)) for _, l in parts]
    return sum(w[:, None] * o.float() for (o, _), w in zip(parts, wts)) \
        / torch.clamp(sum(wts), min=1e-30)[:, None]


def _lse_blocks(tag, dtype, reads):
    """Each block's read (``reads``: (kernel call, plain call) per block,
    each returning (out, lse)) against its plain version: out within the
    dtype's limit, lse within 5e-5, the same rows empty (lse -inf, out
    0), two calls bitwise. Returns (the kernel's parts, out error, lse
    error, empty reads)."""
    import torch
    parts, err, lse_err, empty = [], 0.0, 0.0, 0
    for i, (kernel, plain) in enumerate(reads):
        got, lse = kernel()
        again, _ = kernel()
        want, wlse = plain()
        torch.cuda.synchronize()
        dead = torch.isinf(wlse)
        check(torch.equal(torch.isinf(lse), dead), f"{tag} block {i}: the "
              "empty reads differ from the plain version's")
        check(bool((got[dead] == 0).all()), f"{tag} block {i}: an empty "
              "read is not 0")
        check(torch.equal(got, again), f"{tag} block {i}: two calls differ")
        empty += int(dead.sum())
        err = max(err, float((got.float() - want.float()).abs().max()))
        if bool((~dead).any()):
            lse_err = max(lse_err, float((lse[~dead] - wlse[~dead])
                                         .abs().max()))
        parts.append((got, lse))
    check(err <= TOL[str(dtype).split(".")[-1]] and lse_err <= 5e-5,
          f"{tag}: out err {err:.3e}, lse err {lse_err:.3e}")
    return parts, err, lse_err, empty


def sel_lse_case(dtype, seed: int, slots: int = 2, c: int = 1024,
                 w: int = 256, hkv: int = 8, grp: int = 2, hd: int = 128,
                 k: int = 8):
    """``paged_decode_selected`` with its log-sum-exp at the seq-sharded
    Quest read's shapes (mesh-encdec's 2 x 1 run: qwen3-0.6b's 16 q on 8
    kv heads whole on each rank, C 1,024 of 64 pages split in two blocks
    over "data", K 8): K ids chosen over the whole cache's valid pages,
    each block reading those it holds (``ops.block_page_ids``; block 1
    without the ring). Kv heads whose gcnt stays in block 0 select
    nothing in block 1: lse -inf, out 0. Each block held to the plain
    version (:func:`_lse_blocks`), and the two joined by lse held to the
    kernel's selected read of the whole cache (f32 5e-5, bf16 1e-2)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dual_cache import init_dual_cache
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import (paged_decode_selected,
                                                  paged_decode_selected_plain)
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = init_dual_cache(slots, hkv, hd, w_local=w, budget=c, dtype=dtype,
                            device="cuda")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    pattern = torch.tensor([0, 7, c, c // 2 + 3, 1, c // 2, 16, c - 1],
                           dtype=torch.int32, device="cuda")
    gcnt = torch.stack([pattern.roll(i)[:hkv] for i in range(slots)])
    t = torch.tensor([w + 101 * i for i in range(slots)], dtype=torch.int32,
                     device="cuda")
    cache = cache._replace(gk=rn(slots, hkv, c, hd), gv=rn(slots, hkv, c, hd),
                           lk=rn(slots, hkv, w, hd), lv=rn(slots, hkv, w, hd),
                           gcnt=gcnt, t=t)
    q = rn(slots, hkv * grp, hd)
    pages = c // 16
    live = torch.arange(pages, device="cuda") < ((gcnt + 15) // 16)[..., None]
    score = torch.where(live, torch.rand((slots, hkv, pages), generator=g,
                                        device="cuda"),
                        torch.full((), -float("inf"), device="cuda"))
    top = torch.topk(score, k, dim=-1)
    ids = torch.sort(top.indices, dim=-1).values.to(torch.int32)
    n_sel = torch.isfinite(top.values).sum(-1).to(torch.int32)
    whole = ops.dual_cache_selected_attention(q, cache, ids, n_sel)
    cb = c // 2
    reads, args = [], []
    for i in range(2):
        blk = cache._replace(
            gk=cache.gk[:, :, i * cb:(i + 1) * cb].contiguous(),
            gv=cache.gv[:, :, i * cb:(i + 1) * cb].contiguous())
        qf, first, second, gg = ops.dual_cache_segments(q, blk, (i, 2))
        loc, cnt = ops.block_page_ids(ids, n_sel, (i, 2), cb // 16)
        a = (qf, *first, loc.reshape(-1, loc.shape[-1]).contiguous(),
             cnt.reshape(-1).contiguous())
        args.append((a, second, gg, blk, loc, cnt))
        reads.append((
            lambda a=a, s=second, gg=gg: paged_decode_selected(
                *a, second=s, group=gg, lse=True),
            lambda a=a, s=second, gg=gg: paged_decode_selected_plain(
                *a, second=s, group=gg, lse=True)))
    tag = f"paged_decode_selected lse {dtype}"
    parts, err, lse_err, empty = _lse_blocks(tag, dtype, reads)
    check(empty > 0, f"{tag}: no empty block read")
    comb = _lse_join(parts)
    comb_err = float((comb - whole.reshape(comb.shape).float()).abs().max())
    check(comb_err <= TOL[str(dtype).split(".")[-1]],
          f"{tag}: the joined blocks differ from the whole read by "
          f"{comb_err:.3e}")
    a, second, gg, blk, loc, cnt = args[1]
    ms = cuda_ms(lambda: paged_decode_selected(*a, second=second, group=gg,
                                               lse=True), 200)
    device_ms = graph_ms(lambda: paged_decode_selected(
        *a, second=second, group=gg, lse=True), 50)
    plain_ms = cuda_ms(lambda: paged_decode_selected_plain(
        *a, second=second, group=gg, lse=True), 50)
    # the selected valid tokens block 1 reads, and SDPA over its keys
    # under that mask: the library yardstick
    glen = (gcnt - cb).clamp(0, cb)
    pos = torch.arange(cb, device="cuda")
    chosen = torch.zeros((slots, hkv, cb // 16), dtype=torch.bool,
                         device="cuda")
    chosen.scatter_(-1, loc.long(), torch.arange(
        loc.shape[-1], device="cuda") < cnt[..., None])
    mask = chosen.repeat_interleave(16, -1) & (pos < glen[..., None])
    toks = int(mask.sum())
    qg = q.reshape(slots, hkv, grp, hd)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, blk.gk, blk.gv, attn_mask=mask[:, :, None]), 200)
    b_ms, b_by = bound(W.paged_decode_selected(
        a[0].shape[0], hd, gg, a[5].shape[1], second[2].shape[1],
        isz=q.element_size(), tokens=toks, lse=True))
    return {"shape": f"N={slots * hkv * grp} hd={hd} C={c} K={k}: block 1 "
            f"of 2 (C {cb}, no ring) W={w} {dtype} lse",
            "max_abs_err": err, "lse_err": lse_err, "combined_err": comb_err,
            "empty_reads": empty, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def dense_lse_case(dtype, seed: int, window=None, hkv: int = 8,
                   grp: int = 2, hd: int = 128, s_max: int = 4160,
                   t: int = 4100):
    """``paged_decode`` with its log-sum-exp over two blocks of a dense
    buffer split over "data" (mesh-encdec's seq-sharded dense read), each
    read as ``ops.dense_cache_attention(block=)`` reads it (its length and
    window start clipped to the block): with ``window`` the windowed read
    from a start offset (recurrentgemma-9b's local attention: 16 q on 1
    kv head of hd 256, W 2,048, t 3,000 in 4,160 slots, so [952, 3,000)
    straddles the edge at 2,080), without it qwen3-0.6b's global read (16
    q on 8 kv heads, t 4,100). Each block held to the plain version
    (:func:`_lse_blocks`) and to the ops call bitwise, the two joined by
    lse held to the kernel's read of the whole buffer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
    from repro_torch.models.attention import DenseCache
    from repro_torch.roofline import work as W
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    k, v = rn(1, hkv, s_max, hd), rn(1, hkv, s_max, hd)
    tt = torch.tensor([t], dtype=torch.int32, device="cuda")
    q = rn(1, hkv * grp, hd)
    whole = ops.dense_cache_attention(q, DenseCache(k, v, tt), window=window)
    cb = s_max // 2
    reads, args = [], []
    for i in range(2):
        blk = DenseCache(k[:, :, i * cb:(i + 1) * cb].contiguous(),
                         v[:, :, i * cb:(i + 1) * cb].contiguous(), tt)
        end = torch.clamp(tt - i * cb, 0, cb).to(torch.int32)
        qf, seg, gg = ops.dense_cache_segment(q, blk._replace(t=end))
        kw = {}
        if window is not None:
            st = torch.clamp(torch.clamp(tt - window, min=0) - i * cb, 0, cb)
            kw = {"starts": st.to(torch.int32).repeat_interleave(hkv)
                  .contiguous(), "span": window}
        via_ops = ops.dense_cache_attention(q, blk, window=window,
                                            block=(i, 2))
        mine = paged_decode(qf, *seg, group=gg, lse=True, **kw)
        check(torch.equal(via_ops[0].reshape(mine[0].shape), mine[0]),
              f"dense lse block {i}: the ops read is not the kernel call's")
        args.append((qf, seg, gg, kw, blk, end))
        reads.append((
            lambda qf=qf, seg=seg, gg=gg, kw=kw: paged_decode(
                qf, *seg, group=gg, lse=True, **kw),
            lambda qf=qf, seg=seg, gg=gg, kw=kw: paged_decode_plain(
                qf, *seg, group=gg, lse=True, **kw)))
    tag = f"paged_decode{'_starts' if window else ''} dense lse {dtype}"
    parts, err, lse_err, empty = _lse_blocks(tag, dtype, reads)
    comb = _lse_join(parts)
    comb_err = float((comb - whole.reshape(comb.shape).float()).abs().max())
    check(comb_err <= TOL[str(dtype).split(".")[-1]],
          f"{tag}: the joined blocks differ from the whole read by "
          f"{comb_err:.3e}")
    qf, seg, gg, kw, blk, end = args[1]
    ms = cuda_ms(lambda: paged_decode(qf, *seg, group=gg, lse=True, **kw),
                 200)
    device_ms = graph_ms(lambda: paged_decode(qf, *seg, group=gg, lse=True,
                                              **kw), 50)
    plain_ms = cuda_ms(lambda: paged_decode_plain(qf, *seg, group=gg,
                                                  lse=True, **kw), 50)
    pos = torch.arange(cb, device="cuda")
    lo = int(kw["starts"][0]) if kw else 0
    mask = (pos >= lo) & (pos < int(end[0]))
    qg = q.reshape(1, hkv, grp, hd)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, blk.k, blk.v, attn_mask=mask[None]), 200)
    b_ms, b_by = bound(W.paged_decode(
        qf.shape[0], hd, gg, seg[2].shape[1], isz=q.element_size(),
        tokens=hkv * int(mask.sum()), span=window, lse=True))
    what = f"W={window} t={t}" if window else f"t={t}"
    return {"shape": f"N={hkv * grp} hd={hd} {s_max} slots, {what}: block "
            f"1 of 2 ({cb} slots) {dtype} lse",
            "max_abs_err": err, "lse_err": lse_err, "combined_err": comb_err,
            "empty_reads": empty, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def me_cases():
    """Phase 3's cases of the seq-sharded reads (mesh-encdec), f32 and
    bf16: the Quest-selected read and the windowed dense read with their
    lse over two blocks, and the global dense read's f32. Returns
    (f32 cases, bf16 cases), (tag, record) pairs tagged ``<kernel>
    mesh-encdec``."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    rg = dict(window=2048, hkv=1, grp=16, hd=256, t=3000)
    return ([("paged_decode_selected mesh-encdec", sel_lse_case(f32, 200)),
             ("paged_decode_starts mesh-encdec",
              dense_lse_case(f32, 201, **rg)),
             ("paged_decode mesh-encdec", dense_lse_case(f32, 202))],
            [("paged_decode_selected mesh-encdec", sel_lse_case(bf16, 203)),
             ("paged_decode_starts mesh-encdec",
              dense_lse_case(bf16, 204, **rg))])


# arch -> (repeats kept, weight seed, train spec, prefill spec, decode
# steps); flat, 1 x 1 NCCL and 1 x 2 gloo runs of an arch at that depth.
# whisper-medium keeps 4 of its 24 encoder and 24 decoder repeats, its
# steps the 448-token decoder prompt over 512 (train) and 1,500 (prefill:
# 30 s of audio) encoder positions; qwen2-vl-7b 4 of its 28 layers
# (about 8 GiB of f32 weights, 4.4 of them the embedding tables), its
# stream the 32 x 32 grid's 1,024 patches and 1,024 text tokens
ME_RUNS = {
    "whisper-medium": (4, 85, ("train_w1k", 1024, 1, "train"),
                       ("prefill_w3k", 3000, 1, "prefill"), 8),
    "qwen2-vl-7b": (4, 86, ("train_2k", 2048, 1, "train"),
                    ("prefill_2k", 2048, 1, "prefill"), 8),
}
# the VLM's prefill again with the init's gates (the budget, 512 of
# 2,048, binds at every layer), flat and on each 1 x 2 rank, held by
# ``ma_tie_check``
ME_BINDING = "qwen2-vl-7b"
# the seq-sharded reads on a 2 x 1 gloo mesh: qwen3-0.6b at 4 of 28
# layers (the dense buffer's global read; Quest gather mode at K 8 of the
# WG-KV cache's 64 pages) and recurrentgemma-9b's stem and one repeat
# (its local attention's windowed dense read), each a 1 x 4,096 prefill
# and 4 decode steps
ME_SEQ_S = 4096
ME_SEQ_STEPS = 4
ME_SEQ_RUNS = {"qwen3-0.6b": (4, 87), "recurrentgemma-9b": (1, 88)}
ME_QUEST = "quest:8"


def me_model(arch: str, device):
    """``arch`` at full width, f32, cut to ``ME_RUNS``' repeats (whisper's
    encoder too), weights drawn on ``device`` from its seed (every rank
    draws the same), the gates (the cross attention's too) admitting
    about 16 % of tokens (:func:`sparse_gates`); returns (cfg, params,
    the init's self-attention gates)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    repeats, seed = ME_RUNS[arch][:2]
    kw = {"n_enc_repeats": repeats} if arch == "whisper-medium" else {}
    cfg = get_config(arch).replace(dtype="float32", n_repeats=repeats, **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_model(cfg, gen, device)
    return cfg, params, sparse_gates(cfg, params)


def me_feed(cfg, arch: str) -> dict:
    """The whole inputs of the train and prefill bundles: the bundles'
    own (tokens from seed 0), with whisper's frames
    (``whisper_frame_embeds``) or the VLM's patches drawn on the card from
    seed 89 in place of their zeros."""
    import torch
    from repro_torch.launch import specs as S
    from repro_torch.models import registry as REG
    gen = torch.Generator(device="cuda").manual_seed(89)
    out = {}
    for kind, spec in (("train", ME_RUNS[arch][2]),
                       ("prefill", ME_RUNS[arch][3])):
        shape = ms_shape(spec)
        make = S.train_inputs if kind == "train" else S.prefill_inputs
        batch = make(cfg, shape, "cuda")
        if cfg.is_encdec:
            batch["enc_embeds"] = REG.whisper_frame_embeds(
                gen, cfg, shape.global_batch, shape.seq_len)
        else:
            batch["patch_embeds"] = 0.02 * torch.randn(
                tuple(batch["patch_embeds"].shape), generator=gen,
                device="cuda")
        out[kind] = batch
    return out


def me_steps(mesh, arch: str, cfg, params) -> dict:
    """:func:`ms_run` of ``arch``'s ``ME_RUNS`` steps on ``mesh`` (None:
    the flat bundles), on :func:`me_feed`'s inputs."""
    _, _, train, prefill, steps = ME_RUNS[arch]
    return ms_run(mesh, cfg, params, prefill, train_spec=train,
                  decode_steps=steps, feed=me_feed(cfg, arch))


def me_seq_model(arch: str, device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    repeats, seed = ME_SEQ_RUNS[arch]
    cfg = get_config(arch).replace(dtype="float32", n_repeats=repeats)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, init_model(cfg, gen, device)


def me_seq_read(mesh, cfg, params, quest: bool) -> dict:
    """One row's 1 x ``ME_SEQ_S`` prefill (the dense baseline's, or with
    ``quest`` WG-KV's at budget 1,024), its cache split over "data" on
    ``mesh`` (None: flat), then ``ME_SEQ_STEPS`` greedy decode steps: the
    dense decode bundle, or Quest gather mode (``ME_QUEST``) through the
    rank's model code under ``comm.active(seq=)``, as the bundle runs it,
    with the options the bundle does not take. The first step under the
    work counter."""
    import torch
    from repro_torch.launch.steps import make_bundle
    from repro_torch.models import inference as I
    from repro_torch.sharding import comm, rules
    toks = ms_tokens(cfg, 1, ME_SEQ_S)
    with torch.no_grad():
        out, caches = I.prefill(
            params, cfg, toks, use_wgkv=quest,
            budget=cfg.wgkv.global_budget(ME_SEQ_S), max_len=ME_SEQ_S + 64)
    if mesh is not None:
        caches = rules.local_caches(caches, cfg, mesh, mesh.coords,
                                    seq_shard=True)
    if quest:
        opts = I.DecodeOptions(selection_policy=ME_QUEST)
        plan = lcfg = lparams = None
        if mesh is not None:
            plan = rules.tp_plan(cfg, mesh, mesh.coords["model"])
            lcfg = rules.local_config(cfg, plan)
            lparams = rules.local_params(params, cfg, mesh, mesh.coords)

        def step(tok, caches):
            with torch.no_grad(), comm.active(mesh, plan, seq="data"):
                logits, caches, _ = I.decode_step(
                    lparams if mesh is not None else params,
                    lcfg if mesh is not None else cfg, tok, caches,
                    opts=opts)
            return logits, caches
    else:
        dec = make_bundle(cfg, ms_shape(("decode_seq", ME_SEQ_S, 1,
                                         "decode")), use_wgkv=False,
                          device="cuda", params=params, caches=caches,
                          mesh=mesh)

        def step(tok, caches):
            return dec.fn(dec.args[0], caches, {"token": tok})
    token = out.logits.argmax(-1).to(torch.int32)
    (logits, caches), cnt, lc, wall = ms_step(step, token, caches)
    token = logits.argmax(-1).to(torch.int32)
    steps = [(logits.cpu().numpy(), token.cpu().numpy())]
    t0 = time.perf_counter()
    for _ in range(ME_SEQ_STEPS - 1):
        logits, caches = step(token, caches)
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.cpu().numpy(), token.cpu().numpy()))
    node = next(c for c in (caches["blocks"][f"b{i}"] for i in range(
        len(cfg.block_pattern))) if hasattr(c, "k") or hasattr(c, "gk"))
    return {"steps": steps, "counts": cnt, "launches": lc,
            "first_wall_s": wall,
            "ms_per_step": (time.perf_counter() - t0) * 1e3
            / (ME_SEQ_STEPS - 1),
            "block": int((node.gk if quest else node.k).shape[3])}


def me_seq_runs(mesh) -> dict:
    """The seq-sharded reads (``ME_SEQ_RUNS``) on ``mesh`` (None: flat):
    qwen3-0.6b's dense and Quest reads, recurrentgemma-9b's windowed
    dense read; one model on the card at a time."""
    out = {}
    for arch in ME_SEQ_RUNS:
        cfg, params = me_seq_model(arch, "cuda")
        out[f"{arch} dense"] = me_seq_read(mesh, cfg, params, quest=False)
        if arch == "qwen3-0.6b":
            out[f"{arch} quest"] = me_seq_read(mesh, cfg, params, quest=True)
        del params
        free_cuda()
    return out


def mesh_encdec_rank(mesh, runs: str):
    """One rank of a mesh-encdec world: ``runs`` "archs" (1 x 2: its shard
    of each ``ME_RUNS`` arch, the whole model drawn first, its steps, and
    the VLM's binding prefill) or "seq" (2 x 1: :func:`me_seq_runs`)."""
    import torch
    from repro_torch.sharding import rules
    t0 = time.perf_counter()
    out = {"coords": mesh.coords}
    if runs == "seq":
        out.update(me_seq_runs(mesh))
    else:
        for arch in ME_RUNS:
            cfg, params, init_gates = me_model(arch, mesh.device)
            res = me_steps(mesh, arch, cfg, params)
            res["coords"] = mesh.coords
            res["kv_heads"] = rules.tp_plan(cfg, mesh,
                                            mesh.coords["model"]).kv_heads
            if arch == ME_BINDING:
                res["binding"] = ma_binding(
                    mesh, cfg, params, init_gates, spec=ME_RUNS[arch][3],
                    feed=me_feed(cfg, arch)["prefill"])
            out[arch] = res
            del params
            free_cuda()
    out["wall_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def me_host_runs(cfgs) -> dict:
    """Rank (0, 0)'s counts of each arch's bundles on the 1 x 2 mesh and
    on a 1 x 1 NCCL mesh (:func:`ms_meta`), on ``meta``: host work
    alone."""
    out = {}
    for arch, cfg in cfgs.items():
        _, _, train, prefill, _ = ME_RUNS[arch]
        for shape, backend in (((1, 1), "nccl"), ((1, 2), "gloo")):
            out[(arch, shape)] = ms_meta(cfg, shape, backend, False,
                                         prefill_spec=prefill,
                                         train_spec=train)
    return out


def me_seq_check(tag, cfg, res, flat, launches) -> dict:
    """A rank's seq-sharded read held to the flat one: tokens equal,
    logits within 1e-4 of their scale, the first step's launches equal
    to ``launches`` and its "data" bytes to the count from the shapes
    (each attention layer's combine: the lse max and the weighted sum of
    [hd + 1] f32 over the row's q heads, a 2-rank ring all-reduce moving
    each buffer's bytes once)."""
    import numpy as np
    err, scale = 0.0, 1.0
    for (lg, tok), (flg, ftok) in zip(res["steps"], flat["steps"]):
        check(np.array_equal(tok, ftok), f"{tag}: tokens {tok} != flat "
              f"{ftok}")
        err = max(err, float(np.abs(lg - flg).max()))
        scale = max(scale, float(np.abs(flg).max()))
    check(err <= 1e-4 * scale, f"{tag}: logits differ by {err:.3e} (scale "
          f"{scale:.3g})")
    check(res["launches"] == launches, f"{tag}: launches "
          f"{res['launches']} != {launches}")
    n_attn = sum(1 for bt in tuple(cfg.stem_pattern) + tuple(
        cfg.block_pattern) * cfg.n_repeats if "attn" in bt)
    want = {"data": n_attn * cfg.n_heads * (4 + (cfg.head_dim + 1) * 4)}
    check(res["counts"]["collectives"] == want, f"{tag}: collective bytes "
          f"{res['counts']['collectives']} != {want}")
    return {"logit_err": err, "logit_scale": scale, "block": res["block"],
            "first_step_wall_s": res["first_wall_s"],
            "ms_per_step": res["ms_per_step"], "flat_ms_per_step":
            flat["ms_per_step"], "collective_bytes": want}


def mesh_encdec_phase(card: str):
    """whisper-medium and qwen2-vl-7b on a ``data x model`` mesh, full
    width, f32, depth cut (``ME_RUNS``; printed), their gates admitting
    about 16 % of tokens: one train step (whisper's encoder frames in the
    batch; the VLM's stream of patches and text with M-RoPE ids), one
    prefill and 8 decode steps (whisper's cross memory built on each
    rank's heads), flat, on a 1 x 1 NCCL mesh (in this process) and on a
    1 x 2 gloo mesh (whisper's 16 / 16 heads and the VLM's 28 / 4 split
    in two, the GELU MLP's d_ff too), each mesh run held to the flat run
    with mesh-steps' holds (:func:`ms_check`: tokens and integer cache
    leaves, the cross memory's ``valid`` included, equal; logits within
    1e-4 of their scale; the loss 1e-5 relative; launches equal to the
    flat run's; collective bytes and rank 0's counts equal to the
    fake-group meta run's); the VLM's binding prefill (the init's gates)
    flat and on each rank held by :func:`ma_tie_check`. Then the
    seq-sharded reads (``ME_SEQ_RUNS``) flat and on a 2 x 1 gloo mesh
    (:func:`me_seq_check`). Returns each run's launches."""
    import socket
    from concurrent.futures import ThreadPoolExecutor
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    cfgs = {}
    for arch, (r, *_) in ME_RUNS.items():
        kw = {"n_enc_repeats": r} if arch == "whisper-medium" else {}
        cfgs[arch] = get_config(arch).replace(dtype="float32", n_repeats=r,
                                              **kw)
    print("mesh-encdec depth: " + json.dumps({
        a: {"n_layers": c.n_layers, "of": get_config(a).n_layers,
            "enc_layers": c.n_enc_layers,
            "enc_of": get_config(a).n_enc_layers}
        for a, c in cfgs.items()}), flush=True)
    out, counts, flat = {}, {}, {}

    def tally(tag, res):
        tot = {}
        for lc in ma_launches(res).values():
            for k, v in lc.items():
                tot[k] = tot.get(k, 0) + v
        counts[tag] = tot

    for arch in ME_RUNS:
        cfg, params, init_gates = me_model(arch, "cuda")
        t0 = time.perf_counter()
        res = me_steps(None, arch, cfg, params)
        out[f"{arch} flat"] = {"wall_s": time.perf_counter() - t0,
                               "train_wall_s": res["train"]["wall_s"],
                               "prefill_wall_s": res["prefill"]["wall_s"],
                               "decode_ms_per_step":
                                   res["decode"]["ms_per_step"]}
        tally(f"{arch} flat", res)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
        try:
            mesh = M.init_mesh((1, 1), backend="nccl", device="cuda")
            one = me_steps(mesh, arch, cfg, params)
            one["coords"] = mesh.coords
        finally:
            dist.destroy_process_group()
        res["one"], res["one_wall_s"] = one, time.perf_counter() - t0
        if arch == ME_BINDING:
            res["binding"] = ma_binding(
                None, cfg, params, init_gates, spec=ME_RUNS[arch][3],
                feed=me_feed(cfg, arch)["prefill"])
        flat[arch] = res
        del params
        free_cuda()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(me_host_runs, cfgs)
        t0 = time.perf_counter()
        ranks = M.spawn(mesh_encdec_rank, (1, 2), args=("archs",),
                        backend="gloo", device="cuda", timeout_s=600)
        out["1x2 gloo wall_s"] = time.perf_counter() - t0
        meta = host.result()
    for arch, res in flat.items():
        cfg = cfgs[arch]
        want = ma_launches(res)
        summary = ms_check(f"mesh-encdec {arch} 1x1 nccl", cfg, (1, 1),
                           res["one"], res, meta[(arch, (1, 1))], True,
                           launches=want, scaled=True)
        summary["wall_s"] = res["one_wall_s"]
        out[f"{arch} 1x1 nccl"] = summary
        tally(f"{arch} 1x1 nccl", res["one"])
        tag = f"{arch} 1x2 gloo"
        out[tag] = {}
        for r, rr in sorted(ranks.items()):
            mine = rr[arch]
            summary = ms_check(f"mesh-encdec {tag} rank {r}", cfg, (1, 2),
                               mine, res, meta[(arch, (1, 2))], r == 0,
                               launches=want, scaled=True)
            summary.update(kv_heads=mine["kv_heads"])
            if "binding" in mine:
                summary["binding"] = ma_tie_check(
                    f"mesh-encdec {tag} rank {r} binding", res["binding"],
                    mine["binding"], mine["kv_heads"])
            out[tag][f"rank {r}"] = summary
        tally(tag, ranks[0][arch])
    for r, rr in sorted(ranks.items()):
        out["1x2 gloo"] = out.get("1x2 gloo", {})
        out["1x2 gloo"][f"rank {r}"] = {"wall_s": rr["wall_s"],
                                        "peak_bytes": rr["peak_bytes"]}
    del ranks
    free_cuda()
    # the seq-sharded reads: flat, then 2 x 1 gloo
    t0 = time.perf_counter()
    seq_flat = me_seq_runs(None)
    out["seq flat wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = M.spawn(mesh_encdec_rank, (2, 1), args=("seq",), backend="gloo",
                  device="cuda", timeout_s=600)
    out["seq 2x1 gloo wall_s"] = time.perf_counter() - t0
    seq_cfgs = {a: get_config(a).replace(dtype="float32", n_repeats=r)
                for a, (r, _) in ME_SEQ_RUNS.items()}
    for name, fr in seq_flat.items():
        cfg = seq_cfgs[name.split()[0]]
        counts[f"seq {name} flat"] = fr["launches"]
        check(fr["counts"]["collectives"] == {},
              f"mesh-encdec seq {name} flat: collectives "
              f"{fr['counts']['collectives']}")
        for r, rr in sorted(seq.items()):
            out[f"seq {name} 2x1 rank {r}"] = me_seq_check(
                f"mesh-encdec seq {name} 2x1 rank {r}", cfg, rr[name], fr,
                fr["launches"])
        counts[f"seq {name} 2x1 gloo"] = seq[0][name]["launches"]
    for key, sel in (("qwen3-0.6b quest", "paged_decode_selected"),
                     ("recurrentgemma-9b dense", "paged_decode_starts"),
                     ("qwen3-0.6b dense", "paged_decode")):
        check(counts[f"seq {key} 2x1 gloo"].get(sel, 0) > 0,
              f"mesh-encdec seq {key}: no {sel} launch on the 2 x 1 mesh")
    print("mesh-encdec: " + json.dumps({"card": card, "runs": out}),
          flush=True)
    return counts


# --------------------------------------------------------------------------
# mesh-xlstm: xlstm-350m on the mesh (its blocks split by head, the
# full-parameter train step with FSDP), and an MoE routing group gathered
# over "data" under a gradient
# --------------------------------------------------------------------------
MX_REPEATS = 2                   # of xlstm-350m's 12 (mLSTM, sLSTM)
# the train step starts from this AdamW step count: it runs at the
# schedule's peak rate (1e-3 at step 750), where its update (about 2.3e-3
# an element) shows in the new params
MX_START_STEP = 749
# the mLSTM gate biases' gradients are sums over every token that cancel
# to about a thousandth of the largest gradient, and two runs of the same
# CPU code put them up to 9.1e-4 of themselves apart: their holds take
# this share of the largest gradient as their scale's floor
MX_BIAS_LEAVES = ("b_i", "b_f")
MX_BIAS_FLOOR = 1e-2
MX_TRAIN = ("train_256", 256, 2, "train")
MX_PREFILL = ("prefill_512", 512, 1, "prefill")
MX_DECODE_STEPS = 8
MX_MOE = ("granite-moe-3b-a800m", 2, 64)    # arch, rows, tokens a row
# the MoE cotangent's scale: <y, c>'s gradients within a few hundred times
# 0.01 lb's, so a load-balance term counted once per rank would show
MX_MOE_C = 1e-6
MX_SHAPES = ((1, 2), (2, 1))


def mx_model(device):
    """xlstm-350m at full width (d 1,024, 4 heads), f32, cut to
    ``MX_REPEATS`` repeats, its weights drawn on ``device`` from seed 90
    (every rank draws the same)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config("xlstm-350m").replace(dtype="float32",
                                            n_repeats=MX_REPEATS)
    gen = torch.Generator(device=device).manual_seed(90)
    return cfg, init_model(cfg, gen, device)


def mx_feed(cfg) -> dict:
    """The train batch (tokens and a loss mask with zeros) and the
    prefill prompt, drawn on the host from seed 91."""
    import numpy as np
    import torch
    rng = np.random.default_rng(91)
    _, s, b, _ = MX_TRAIN
    mask = np.ones((b, s), np.float32)
    mask[1, -32:] = 0.0
    _, sp, bp, _ = MX_PREFILL
    return {"train": {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, s), dtype=np.int32)).cuda(),
                      "loss_mask": torch.from_numpy(mask).cuda()},
            "prefill": {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (bp, sp), dtype=np.int32)).cuda()}}


def mx_run(mesh, cfg, params, feed) -> dict:
    """The train bundle's full-parameter step (``trainer.lm_train_step``
    on the rank's blocks from AdamW step ``MX_START_STEP``: the blocks
    before and after it and both AdamW moments, 0.1 g and 0.001 g^2 of
    the gradient g), a prefill and
    ``MX_DECODE_STEPS`` greedy decode steps on its states, through
    ``make_bundle`` (``mesh=None``: the flat bundles); each step's first
    call counted without aten ops (:func:`ms_step`)."""
    import torch
    from repro_torch.launch.steps import make_bundle
    res = {}
    tr = make_bundle(cfg, ms_shape(MX_TRAIN), use_wgkv=False, device="cuda",
                     params=params, mesh=mesh)
    state, batch = ms_args(tr, mesh, feed["train"])
    state = state._replace(opt=state.opt._replace(
        step=torch.tensor(MX_START_STEP, dtype=torch.int32)))
    (new, aux), cnt, lc, wall = ms_step(tr.fn, state, batch, aten=False)
    res["train"] = {"loss": float(aux["loss"]),
                    "old": host_leaves(state.params),
                    "m": host_leaves(new.opt.m),
                    "v": host_leaves(new.opt.v),
                    "params": host_leaves(new.params),
                    "counts": cnt["collectives"], "launches": lc,
                    "wall_s": wall}
    del tr, new, state
    pre = make_bundle(cfg, ms_shape(MX_PREFILL), use_wgkv=False,
                      device="cuda", params=params, mesh=mesh)
    (logits, _, caches), cnt, lc, wall = ms_step(
        pre.fn, *ms_args(pre, mesh, feed["prefill"]), aten=False)
    res["prefill"] = {"logits": logits.cpu(), "counts": cnt["collectives"],
                      "launches": lc, "wall_s": wall}
    del pre
    name, s, b, _ = MX_PREFILL
    dec = make_bundle(cfg, ms_shape(("decode_" + name, s, b, "decode")),
                      use_wgkv=False, device="cuda", params=params,
                      caches=caches, mesh=mesh)
    token = logits.argmax(-1).to(torch.int32)
    (logits, caches), cnt, lc, _ = ms_step(dec.fn, dec.args[0], caches,
                                           {"token": token}, aten=False)
    res["decode_counts"], res["decode_launches"] = cnt["collectives"], lc
    token = logits.argmax(-1).to(torch.int32)
    steps = [(logits.cpu(), token.cpu())]
    t0 = time.perf_counter()
    for _ in range(MX_DECODE_STEPS - 1):
        logits, caches = dec.fn(dec.args[0], caches, {"token": token})
        token = logits.argmax(-1).to(torch.int32)
        steps.append((logits.cpu(), token.cpu()))
    res["decode"] = {"steps": steps, "states": host_leaves(caches),
                     "ms_per_step": (time.perf_counter() - t0) * 1e3
                     / (MX_DECODE_STEPS - 1)}
    return res


def mx_moe_inputs(cfg):
    """Block 0's MoE leaves of ``MX_MOE``'s arch at full width (seed 92 on
    the card), x [rows, tokens, D] and the cotangent (host-drawn, seed
    93)."""
    import numpy as np
    import torch
    from repro_torch.models.moe import init_moe
    _, rows, s = MX_MOE
    p = init_moe(torch.Generator(device="cuda").manual_seed(92), cfg,
                 "cuda")
    rng = np.random.default_rng(93)
    x = rng.standard_normal((rows, s, cfg.d_model)).astype(np.float32)
    c = (MX_MOE_C * rng.standard_normal(x.shape)).astype(np.float32)
    return p, torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()


def mx_moe_grad(mesh, cfg) -> dict:
    """The gradients of ``<y, c> + 0.01 lb`` through ``moe_ffn(groups=1)``
    (one routing group over every row) with respect to x and the MoE
    leaves: flat (``mesh`` None), or on a mesh whose "data" ranks each
    hold one row, where the group is gathered over "data" (the rank's
    rows of x's gradient, the leaves' summed over "data")."""
    import torch
    from repro_torch.models import moe as MoE
    from repro_torch.sharding import comm, rules
    p, x, c = mx_moe_inputs(cfg)
    p = {k: v.requires_grad_() for k, v in p.items()}
    rows = slice(0, x.shape[0])
    ctx = contextlib.nullcontext()
    if mesh is not None:
        rows = rules.block(x.shape[0], "data", mesh.coords, mesh)
        ctx = comm.active(mesh, rules.tp_plan(cfg, mesh, 0), rows="data")
    xl = x[rows].clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx, torch.enable_grad():
        y, aux = MoE.moe_ffn(p, cfg, xl, groups=1)
        dot = comm.sum_rows((y * c[rows]).sum()[None])[0] \
            if mesh is not None else (y * c).sum()
        grads = torch.autograd.grad(dot + 0.01 * aux["lb_loss"],
                                    [xl] + list(p.values()))
        out = {"x": grads[0].cpu().numpy()}
        for k, g in zip(p, grads[1:]):
            if mesh is not None:
                comm.all_reduce(g, mesh, "data")
            out[k] = g.cpu().numpy()
        if mesh is None:
            lb_router = torch.autograd.grad(
                0.01 * MoE.moe_ffn(p, cfg, x, groups=1)[1]["lb_loss"],
                [p["router"]])[0]
            out["lb_share"] = float(lb_router.abs().max()
                                    / abs(out["router"]).max())
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _mx_err(got, want, scale=None) -> float:
    """Max |got - want| over ``scale`` (default max |want|; arrays; the
    difference itself for a scale of 0)."""
    import numpy as np
    d = float(np.abs(got.astype(np.float64) - want).max())
    s = float(np.abs(want).max()) if scale is None else scale
    return d / s if s > 0 else d


def mx_adamw(old, m, v):
    """AdamW's step from ``MX_START_STEP`` on the blocks ``old`` with the
    moments ``m`` and ``v`` after it (numpy), in f64: the formula of
    ``training/optimizer.py`` at the train bundle's schedule."""
    import numpy as np
    from repro_torch.training.optimizer import cosine_schedule
    step = MX_START_STEP + 1
    lr = float(cosine_schedule(1e-3, 7500)(step))
    b1t, b2t = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
    old = old.astype(np.float64)
    return old - lr * ((m / b1t) / (np.sqrt(v / b2t) + 1e-8) + 0.01 * old)


def mx_compare(tag, cfg, shape, res, flat) -> dict:
    """One mesh run (:func:`mx_run`, the rank at ``res["coords"]``) held
    to the flat run: the loss within 1e-5 relative; the gradient, read
    as AdamW's first moment (0.1 g) and the root of its second
    (0.0316 |g|), the rank's block of each leaf (``rules.local_params``'
    FSDP placement) within 1e-4 of that leaf's own largest magnitude
    (the mLSTM gate biases' scale at least ``MX_BIAS_FLOOR`` of the
    largest gradient: see ``MX_BIAS_LEAVES``); each leaf's new value
    within 1e-4 of its scale of AdamW's step on the rank's block with
    those moments (:func:`mx_adamw`: at a rate where the update shows,
    AdamW's step of an element whose gradient lies within rounding of 0
    is not fixed by a gradient held to 1e-4), the update above 1e-3;
    logits within 1e-4 of their scale; greedy tokens equal; each state
    leaf's block (``rules.cache_placement``) within 1e-4 of its scale.
    Returns the errors."""
    import numpy as np
    import torch
    from repro_torch.sharding import rules
    mesh = {"data": shape[0], "model": shape[1]}
    coords = res["coords"]
    f_tr, m_tr = flat["train"], res["train"]
    rel = abs(m_tr["loss"] - f_tr["loss"]) / abs(f_tr["loss"])
    check(rel <= 1e-5, f"{tag}: loss {m_tr['loss']} vs flat "
          f"{f_tr['loss']} ({rel:.2e} relative)")
    errs = {}
    for part, fn in (("m", lambda x: x), ("v", np.sqrt)):
        check(set(m_tr[part]) == set(f_tr[part]), f"{tag}: {part} leaves")
        top = max(float(np.abs(fn(w)).max()) for w in f_tr[part].values())
        worst = (0.0, "")
        for path, want in f_tr[part].items():
            spec = rules.param_placement(path, want.shape, mesh, cfg,
                                         replicate_fsdp=False)
            blk = fn(rules.local_shard(torch.from_numpy(want), spec, coords,
                                       mesh, rules.gate_parts(path, cfg))
                     .numpy())
            got = m_tr[part][path]
            key = "/".join(path)
            check(got.shape == blk.shape,
                  f"{tag}: {part} {key} shape {got.shape}")
            scale = float(np.abs(blk).max())
            if path[-1] in MX_BIAS_LEAVES:
                scale = max(scale, MX_BIAS_FLOOR * top)
            worst = max(worst, (_mx_err(fn(got), blk, scale), key))
        check(worst[0] <= 1e-4, f"{tag}: {part} {worst[1]} differs by "
              f"{worst[0]:.3e} of its scale")
        errs[part] = worst
    worst, least = (0.0, ""), (float("inf"), "")
    for path, old in m_tr["old"].items():
        want = mx_adamw(old, m_tr["m"][path], m_tr["v"][path])
        key = "/".join(path)
        least = min(least, (float(np.abs(want - old).max()), key))
        worst = max(worst, (_mx_err(m_tr["params"][path], want), key))
    check(worst[0] <= 1e-4, f"{tag}: params {worst[1]} differ from AdamW's "
          f"step by {worst[0]:.3e} of their scale")
    check(least[0] > 1e-3, f"{tag}: params {least[1]}: AdamW's update "
          f"{least[0]:.3e} does not show")
    errs["params"], errs["least_update"] = worst, least
    rows = rules.block(flat["prefill"]["logits"].shape[0],
                       rules.tokens_spec(mesh, flat["prefill"]["logits"]
                                         .shape[0], 0)[0], coords, mesh)
    lg = [(res["prefill"]["logits"], flat["prefill"]["logits"][rows])]
    for (l, t), (fl, ft) in zip(res["decode"]["steps"],
                                flat["decode"]["steps"]):
        check(torch.equal(t, ft[rows]), f"{tag}: greedy tokens "
              f"{t.tolist()} != flat {ft[rows].tolist()}")
        lg.append((l, fl[rows]))
    scale = max(float(w.abs().max()) for _, w in lg)
    lg_err = max(float((g - w).abs().max()) for g, w in lg)
    check(lg_err <= 1e-4 * scale, f"{tag}: logits differ by {lg_err:.3e} "
          f"(scale {scale:.3g})")
    st = (0.0, "")
    for path, want in flat["decode"]["states"].items():
        spec = rules.cache_placement(path, want.shape, mesh, cfg)
        blk = rules.local_shard(torch.from_numpy(want), spec, coords,
                                mesh).numpy()
        got = res["decode"]["states"][path]
        key = "/".join(path)
        if np.issubdtype(want.dtype, np.floating):
            st = max(st, (_mx_err(got, blk), key))
        else:
            check(np.array_equal(got, blk), f"{tag}: state {key} differs")
    check(st[0] <= 1e-4, f"{tag}: state {st[1]} differs by {st[0]:.3e}")
    for kind, cnt in (("train", m_tr), ("prefill", res["prefill"])):
        check(cnt["launches"] == {}, f"{tag}: {kind} launched "
              f"{cnt['launches']}: the xLSTM runs no kernel")
    return {"loss_rel_err": rel, "grad_err": errs["m"],
            "grad_sq_err": errs["v"], "param_err": errs["params"],
            "least_update": errs["least_update"], "logit_err": lg_err,
            "logit_scale": scale, "state_err": st,
            "train_wall_s": m_tr["wall_s"],
            "prefill_wall_s": res["prefill"]["wall_s"],
            "decode_ms_per_step": res["decode"]["ms_per_step"],
            "collective_bytes": {"train": m_tr["counts"],
                                 "prefill": res["prefill"]["counts"],
                                 "decode": res["decode_counts"]}}


def mx_moe_compare(tag, cfg, res, flat, coords) -> dict:
    """The rank's MoE gradients (:func:`mx_moe_grad`) held to the flat
    ones within 1e-4 of each gradient's largest magnitude: x's for its
    rows, the leaves' summed over "data"."""
    errs = {}
    for key, want in flat.items():
        if key in ("lb_share", "wall_s"):
            continue
        if key == "x":
            want = want[coords["data"]:coords["data"] + 1]
        errs[key] = _mx_err(res[key], want)
        check(errs[key] <= 1e-4, f"{tag}: the gradient of {key} differs "
              f"by {errs[key]:.3e} of its scale")
    return {"errs": errs, "wall_s": res["wall_s"]}


def mesh_xlstm_rank(mesh, flat_path: str):
    """One rank of a gloo world on the one card: its blocks of
    xlstm-350m (the whole model drawn first), :func:`mx_run`, held here
    to the flat run saved at ``flat_path`` (:func:`mx_compare`; only the
    errors travel back); on a mesh with "data" 2 also the MoE routing
    group gathered over "data" (:func:`mx_moe_grad`)."""
    import torch
    from repro_torch.configs import get_config
    flat = torch.load(flat_path, weights_only=False)
    cfg, params = mx_model(mesh.device)
    t0 = time.perf_counter()
    res = mx_run(mesh, cfg, params, mx_feed(cfg))
    res["coords"] = mesh.coords
    shape = (mesh.shape["data"], mesh.shape["model"])
    tag = f"mesh-xlstm {shape[0]}x{shape[1]} rank {mesh.rank}"
    out = mx_compare(tag, cfg, shape, res, flat["xlstm"])
    del params, res
    if shape[0] == 2:
        mcfg = get_config(MX_MOE[0]).replace(dtype="float32")
        out["moe"] = mx_moe_compare(f"{tag} moe", mcfg,
                                    mx_moe_grad(mesh, mcfg), flat["moe"],
                                    mesh.coords)
    out["coords"] = mesh.coords
    out["wall_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mx_meta(cfg, shape, backend) -> dict:
    """Rank (0, 0)'s collective bytes of the phase's bundles on ``meta``
    over a fake group standing for ``backend``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch.steps import make_bundle
    from repro_torch.roofline.counter import WorkCounter
    out = {}
    with M.fake_mesh(shape, backend=backend) as mesh:
        res = None
        for tag, spec in (("train", MX_TRAIN), ("prefill", MX_PREFILL)):
            b = make_bundle(cfg, ms_shape(spec), use_wgkv=False, mesh=mesh)
            ops._identity_tables.cache_clear()
            with WorkCounter(aten=False) as wc:
                res = b.fn(*b.args)
            out[tag] = dict(wc.record()["collective_bytes_by_axis"])
        name, s, bb, _ = MX_PREFILL
        d = make_bundle(cfg, ms_shape(("decode_" + name, s, bb, "decode")),
                        use_wgkv=False, caches=res[2], mesh=mesh)
        with WorkCounter(aten=False) as wc:
            d.fn(*d.args)
        out["decode"] = dict(wc.record()["collective_bytes_by_axis"])
    return out


def mx_host_runs(cfg) -> tuple:
    """The phase's runs on ``meta``: the 16 x 16 dry run's rank-0 records
    of xlstm-350m (every layer) at the shapes it applies to, and rank
    (0, 0)'s collective bytes of the phase's bundles on each mesh."""
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    recs = {name: D.run_dryrun("xlstm-350m", name, mesh="single")
            for name in ("train_4k", "prefill_32k", "decode_32k",
                         "long_500k")}
    recs["host_s"] = time.perf_counter() - t0
    meta = {(1, 1): mx_meta(cfg, (1, 1), "nccl")}
    for shape in MX_SHAPES:
        meta[shape] = mx_meta(cfg, shape, "gloo")
    return recs, meta


def mesh_xlstm_phase(card: str):
    """xlstm-350m on a ``data x model`` mesh at full width (d 1,024, 4
    heads), f32, depth cut to ``MX_REPEATS`` of 12 repeats (printed): the
    full-parameter train step at 2 x 256 (remat; from AdamW step
    ``MX_START_STEP``; its gradients read from AdamW's moments), a prefill of 1 x 512 and 8 greedy decode steps on its
    states, flat, on a 1 x 1 NCCL mesh (in this process), a 1 x 2 gloo
    mesh (2 heads a rank: the mLSTM and sLSTM split by head, the sLSTM's
    MLP by its width) and a 2 x 1 gloo mesh (rows and FSDP over "data"),
    each held to the flat run (:func:`mx_compare`) and its collective
    bytes to the fake-group meta run's; in the 2 x 1 world also
    granite-moe-3b-a800m's ``moe_ffn`` at full width over 2 x 64 rows in
    one routing group gathered over "data", under a gradient, against
    the flat gradient (:func:`mx_moe_compare`). Then the 16 x 16 dry
    run's rank-0 records of xlstm-350m, each peak below the card's
    process bytes. No kernel runs on these paths; returns each run's
    launches (all empty)."""
    import socket
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.roofline import analysis as RA
    cfg, params = mx_model("cuda")
    whole = get_config("xlstm-350m")
    print("mesh-xlstm depth: " + json.dumps(
        {"n_layers": cfg.n_layers, "of": whole.n_layers,
         "repeats": cfg.n_repeats, "d_model": cfg.d_model,
         "n_heads": cfg.n_heads, "train": MX_TRAIN, "prefill": MX_PREFILL,
         "decode_steps": MX_DECODE_STEPS}), flush=True)
    out, counts = {}, {}
    t0 = time.perf_counter()
    feed = mx_feed(cfg)
    flat = mx_run(None, cfg, params, feed)
    out["flat"] = {"wall_s": time.perf_counter() - t0,
                   "train_wall_s": flat["train"]["wall_s"],
                   "prefill_wall_s": flat["prefill"]["wall_s"],
                   "decode_ms_per_step": flat["decode"]["ms_per_step"]}
    counts["flat"] = flat["train"]["launches"]
    del flat["train"]["old"]      # each rank reads its own blocks' start
    check(flat["train"]["counts"] == {},
          "mesh-xlstm flat: collectives counted")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = M.init_mesh((1, 1), backend="nccl", device="cuda")
        one = mx_run(mesh, cfg, params, feed)
        one["coords"] = mesh.coords
    finally:
        dist.destroy_process_group()
    del params
    free_cuda()
    mcfg = get_config(MX_MOE[0]).replace(dtype="float32")
    moe_flat = mx_moe_grad(None, mcfg)
    free_cuda()
    out["1x1 nccl"] = mx_compare("mesh-xlstm 1x1 nccl", cfg, (1, 1), one,
                                 flat)
    out["1x1 nccl"]["wall_s"] = time.perf_counter() - t0
    del one
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "flat.pt")
        torch.save({"xlstm": flat, "moe": moe_flat}, path)
        # the host runs and both gloo worlds side by side: the ranks are
        # host-bound and share the card
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1 + len(MX_SHAPES)) as pool:
            host = pool.submit(mx_host_runs, cfg)
            worlds = {shape: pool.submit(M.spawn, mesh_xlstm_rank, shape,
                                         args=(path,), backend="gloo",
                                         device="cuda", timeout_s=600)
                      for shape in MX_SHAPES}
            ranks = {shape: w.result() for shape, w in worlds.items()}
            recs, meta = host.result()
        out["gloo worlds wall_s"] = time.perf_counter() - t0
    out["dryrun_host_s"] = recs.pop("host_s")
    want = meta[(1, 1)]
    got = out["1x1 nccl"]["collective_bytes"]
    check(got == want, f"mesh-xlstm 1x1 nccl: collective bytes {got} != "
          f"the meta run's {want}")
    for shape, rr in ranks.items():
        tag = f"{shape[0]}x{shape[1]} gloo"
        for r, res in sorted(rr.items()):
            check(res["collective_bytes"] == meta[shape],
                  f"mesh-xlstm {tag} rank {r}: collective bytes "
                  f"{res['collective_bytes']} != the meta run's "
                  f"{meta[shape]}")
            out[f"{tag} rank {r}"] = res
        counts[tag] = {}
    check(all("model" in v for v in meta[(1, 2)].values()),
          f"mesh-xlstm 1x2: no collective over \"model\": {meta[(1, 2)]}")
    check("data" in meta[(2, 1)]["train"],
          f"mesh-xlstm 2x1: no FSDP collective: {meta[(2, 1)]}")
    out["moe flat"] = {"lb_share": moe_flat["lb_share"],
                       "wall_s": moe_flat["wall_s"]}
    for name, rec in recs.items():
        if rec.get("skipped"):
            print(f"mesh-xlstm dryrun 16x16 xlstm-350m {name}: skipped "
                  f"({rec['reason']})", flush=True)
            continue
        check(rec["memory"]["peak_bytes"] < RA.H100_PROCESS_BYTES,
              f"mesh-xlstm dryrun 16x16 {name}: peak "
              f"{rec['memory']['peak_bytes']} over the card's process bytes")
        print(f"mesh-xlstm dryrun 16x16 xlstm-350m {name} rank 0: "
              + json.dumps({k: rec.get(k) for k in (
                  "knobs", "memory", "collectives", "compute_s", "memory_s",
                  "collective_s", "bottleneck", "slstm_hidden_flops")}
                  | {"flops": rec["cost"]["flops"],
                     "bytes": rec["cost"]["bytes"],
                     "h100_process_bytes": RA.H100_PROCESS_BYTES,
                     "peak_over_h100_process_bytes":
                         rec["memory"]["peak_bytes"] / RA.H100_PROCESS_BYTES}),
              flush=True)
    print("mesh-xlstm: " + json.dumps({"card": card, "runs": out},
                                       default=str), flush=True)
    return counts


PHASE_S: dict = {}        # phase group -> seconds, in run order
_LAP = [0.0]


def lap(name: str) -> None:
    """Records the seconds since the previous lap under ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = round(now - _LAP[0], 1)
    _LAP[0] = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found; run from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    _LAP[0] = t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 1. device
    from repro_torch.benchmarks.common import card_line
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # 2. build
    from repro_torch.kernels import build
    build_s = build.timed_build_all()
    print(f"build: {build_s:.2f}s")
    lap("device+build")
    for name in build.KERNELS:
        log = build.log_path(name)
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    print(f"  ptxas {name}: {line.strip()[:160]}")
    # 3. kernels vs plain (serving shapes first, then a larger size)
    gate_main = gate_case(rows=2 * 8, s=1, seed=0)
    gate_big = gate_case(rows=2 * 8, s=4096, seed=1)
    gate_prefill = gate_case(rows=8, s=4096, seed=32)  # prefill-long's
    pd_main = dual_cache_case(2, 128, 256, torch.float32, seed=2)
    pd_bf16 = dual_cache_case(2, 128, 256, torch.bfloat16, seed=3)
    pd_big = dual_cache_case(8, 1024, 256, torch.float32, seed=4)
    vs_main = vertical_slash_case("float32", seed=5)
    vs_bf16 = vertical_slash_case("bfloat16", seed=6)
    gf_main = gated_flash_case(2048, "float32", seed=7)
    gf_bf16 = gated_flash_case(2048, "bfloat16", seed=8)
    gf_probe = gated_flash_case(32, "float32", seed=9)
    gf_probe_bf16 = gated_flash_case(32, "bfloat16", seed=10)
    # the serving shape (C 128 = 8 pages, K 2) and the offline decode
    # shape (C 1024 = 64 pages, K 8), each with the 256-token ring
    sel_main = selected_case(2, 128, 256, 2, torch.float32, seed=11)
    sel_bf16 = selected_case(2, 128, 256, 2, torch.bfloat16, seed=12)
    sel_long = selected_case(1, 1024, 256, 8, torch.float32, seed=13)
    sel_long_bf16 = selected_case(1, 1024, 256, 8, torch.bfloat16, seed=14)
    # recurrentgemma-9b's shapes: MQA (1 kv head, 16 q heads), hd 256, the
    # 2048-token local window, the gate's F = 2 x hd = 512; the scan at
    # [1, 4096, 4096] (one prompt, dr = d_model) and a ragged one with h0
    rg_scan = rglru_case(1, 4096, 4096, False, seed=20)
    rg_scan_h0 = rglru_case(3, 1000, 200, True, seed=21)
    rg_gate = gate_case(rows=1, s=4096, seed=22, h=1, f=512)
    rg_gate_dec = gate_case(rows=2, s=1, seed=23, h=1, f=512)
    rg_pd = dual_cache_case(1, 1024, 2048, torch.float32, seed=24, hkv=1,
                            grp=16, hd=256)
    rg_pd_bf16 = dual_cache_case(1, 1024, 2048, torch.bfloat16, seed=25,
                                 hkv=1, grp=16, hd=256)
    rg_pd_serve = dual_cache_case(2, 128, 2048, torch.float32, seed=26,
                                  hkv=1, grp=16, hd=256)
    rg_vs = vertical_slash_case("float32", seed=27, hkv=1, hd=256, w=2048)
    rg_vs_bf16 = vertical_slash_case("bfloat16", seed=28, hkv=1, hd=256,
                                     w=2048)
    rg_gf = gated_flash_case(4096, "float32", seed=29, hkv=1, hd=256, w=2048)
    rg_gf_bf16 = gated_flash_case(4096, "bfloat16", seed=30, hkv=1, hd=256,
                                  w=2048)
    rg_gf_probe = gated_flash_case(32, "float32", seed=31, hkv=1, hd=256,
                                   w=2048)
    # the dense baseline's shapes: serve-ab's decode read (2 slots,
    # capacity 512) and prefill-dense's (one row, 4160 slots), one
    # paged_decode segment; prefill-dense's causal prefill at S 4096
    dense_serve = dense_case(2, 512, [398, 383], torch.float32, seed=33)
    dense_long = dense_case(1, 4160, [4104], torch.float32, seed=34)
    dense_long_bf16 = dense_case(1, 4160, [4104], torch.bfloat16, seed=35)
    gf_causal = gated_flash_case(4096, "float32", seed=36, causal=True)
    gf_causal_bf16 = gated_flash_case(4096, "bfloat16", seed=37,
                                      causal=True)
    # this slice's: the dense baseline's windowed modes. gated_flash's
    # hard window at recurrentgemma-9b's prefill (16 / 1 heads of hd 256,
    # S 4096, W 2048) and at a qwen3 shape (16 / 8, hd 128, S 2048, W
    # 256); paged_decode from a start offset at the hybrid's dense decode
    # (G 16, hd 256, a 4,160-token buffer, t about 4,100, W 2048) and
    # ragged rows whose starts are not page-aligned; each mode's first
    # f32 case also runs its planted fault
    mode_runs = {k: [] for k in MODE_FAULTS}
    win_rg = window_flash_case(4096, "float32", seed=110, hkv=1, hd=256,
                               hq=16, w=2048,
                               runs=mode_runs["gated_flash_window"])
    win_rg_bf16 = window_flash_case(4096, "bfloat16", seed=111, hkv=1,
                                    hd=256, hq=16, w=2048)
    win_q3 = window_flash_case(2048, "float32", seed=112, hkv=8, hd=128,
                               hq=16, w=256,
                               runs=mode_runs["gated_flash_window"])
    win_q3_bf16 = window_flash_case(2048, "bfloat16", seed=113, hkv=8,
                                    hd=128, hq=16, w=256)
    st_rg = start_decode_case(1, 4160, [4104], 2048, torch.float32,
                              seed=114, runs=mode_runs["paged_decode_starts"])
    st_rg_bf16 = start_decode_case(1, 4160, [4104], 2048, torch.bfloat16,
                                   seed=115)
    st_ragged = start_decode_case(3, 4160, [4104, 3001, 2100], 2048,
                                  torch.float32, seed=116,
                                  runs=mode_runs["paged_decode_starts"])
    st_ragged_bf16 = start_decode_case(3, 4160, [4104, 3001, 2100], 2048,
                                       torch.bfloat16, seed=117)
    mode_runs = [(name, r) for name, rs in mode_runs.items() for r in rs]
    # the backward kernels at the train phase's shapes (qwen3-0.6b, batch
    # 2 x 2048 tokens) and at the substrate's (batch 2 x 128 tokens), then
    # each rebuilt with a planted fault on the same inputs
    gb_train, gb_train_run = gate_bwd_case(rows=2 * 8, s=2048, seed=40)
    gb_sub, gb_sub_run = gate_bwd_case(rows=2 * 2, s=128, seed=41, h=2,
                                       f=64, m=32)
    fb_train, fb_train_run = flash_bwd_case(32, 2048, seed=42, nk=16)
    fb_sub, fb_sub_run = flash_bwd_case(8, 128, seed=43, nk=4, hd=32, w=16)
    # this slice's: recurrentgemma-9b's training shapes (the scan at [1,
    # 4096, 4096], 16 q heads of hd 256 on 1 kv head with W 2048, the gate
    # at F 512), a ragged scan with h0, and G 3 (smollm-360m's 30 q / 10
    # kv heads of hd 64 at batch 2, its reduced config's hd 80)
    rb_train, rb_train_run = rglru_bwd_case(1, 4096, 4096, False, seed=44)
    rb_h0, rb_h0_run = rglru_bwd_case(3, 1000, 200, True, seed=45)
    fb_rg, fb_rg_run = flash_bwd_case(16, 4096, seed=46, nk=1, hd=256,
                                      w=2048)
    fb_g3, fb_g3_run = flash_bwd_case(30, 2048, seed=47, nk=10, hd=64)
    fb_g3_80, _ = flash_bwd_case(6, 256, seed=48, nk=2, hd=80, w=16)
    gb_rg, gb_rg_run = gate_bwd_case(rows=1, s=4096, seed=49, h=1, f=512)
    # the dense archs' odd groups at the shapes their full-width phases
    # give each forward kernel (f32): serve's dual cache (2 slots, C 128
    # of capacity 512, W 256), the gate at serve and over a 4,096-token
    # prefill, the offline decode's dual cache (C 1024), prefill's
    # vertical_slash (S 4096, C 1024, W 256) and the tau probe's
    # gated_flash (S 32); smollm-360m's gated_flash also at S 2048, its
    # train forward's
    dense_kernels = []
    for i, (arch, (hq, hkv, hd)) in enumerate(DENSE_HEADS.items()):
        sd, grp = 50 + 10 * i, hq // hkv
        dense_kernels += [
            (f"paged_decode {arch}", dual_cache_case(
                2, 128, 256, torch.float32, seed=sd, hkv=hkv, grp=grp,
                hd=hd)),
            (f"gate_mlp {arch}", gate_case(rows=2 * hkv, s=1, seed=sd + 1,
                                           h=hkv, f=2 * hd)),
            (f"gate_mlp {arch}", gate_case(rows=hkv, s=4096, seed=sd + 2,
                                           h=hkv, f=2 * hd)),
            (f"paged_decode {arch}", dual_cache_case(
                1, 1024, 256, torch.float32, seed=sd + 3, hkv=hkv, grp=grp,
                hd=hd)),
            (f"vertical_slash {arch}", vertical_slash_case(
                "float32", seed=sd + 4, hkv=hkv, hd=hd, hq=hq)),
            (f"gated_flash {arch}", gated_flash_case(
                32, "float32", seed=sd + 5, hkv=hkv, hd=hd, hq=hq))]
    dense_kernels.append(("gated_flash smollm-360m", gated_flash_case(
        2048, "float32", seed=80, hkv=5, hd=64, hq=15)))
    # the MoE archs' groups (granite's 24 / 8 at hd 64,
    # qwen3-moe's 64 / 4 at hd 128: G 16 at hd 128) at the shapes their
    # phases give each forward kernel (f32): serve's dual cache (C 128,
    # W 256) and the offline decode's (C 1024), the gate at serve (2
    # slots) and over a 4,096-token prefill, prefill's vertical_slash,
    # and gated_flash at the tau probe's S 32 and the forward's S 2048;
    # each kernel's first sound case also runs its planted fault
    moe_kernels, fwd_runs = [], []
    for i, (arch, (hq, hkv, hd)) in enumerate(MOE_HEADS.items()):
        sd, grp = 90 + 10 * i, hq // hkv
        runs = {k: [] for k in FWD_FAULTS}
        moe_kernels += [
            (f"paged_decode {arch}", dual_cache_case(
                2, 128, 256, torch.float32, seed=sd, hkv=hkv, grp=grp,
                hd=hd, runs=runs["paged_decode"])),
            (f"paged_decode {arch}", dual_cache_case(
                1, 1024, 256, torch.float32, seed=sd + 1, hkv=hkv, grp=grp,
                hd=hd)),
            (f"gate_mlp {arch}", gate_case(
                rows=2 * hkv, s=1, seed=sd + 2, h=hkv, f=2 * hd,
                runs=runs["gate_mlp_decode"])),
            (f"gate_mlp {arch}", gate_case(
                rows=hkv, s=4096, seed=sd + 3, h=hkv, f=2 * hd,
                runs=runs["gate_mlp_mma"])),
            (f"vertical_slash {arch}", vertical_slash_case(
                "float32", seed=sd + 4, hkv=hkv, hd=hd, hq=hq,
                runs=runs["vertical_slash"])),
            (f"gated_flash {arch}", gated_flash_case(
                32, "float32", seed=sd + 5, hkv=hkv, hd=hd, hq=hq,
                runs=runs["gated_flash"])),
            (f"gated_flash {arch}", gated_flash_case(
                2048, "float32", seed=sd + 6, hkv=hkv, hd=hd, hq=hq))]
        fwd_runs += [(name, r) for name, rs in runs.items() for r in rs]
    free_cuda()
    # this slice's: qwen2-vl-7b's G 7 and whisper-medium's 16 / 16 at hd
    # 64 (W 64), the gate over whisper's 1,500 cross keys, and the
    # backward kernels at whisper's train shape
    new_kernels, new_runs = new_arch_cases()
    free_cuda()
    # this slice's: the figures' shapes (fig. 8 at full width, the bench
    # substrate's selected read)
    fig_kernels = figure_cases()
    free_cuda()
    # one mesh rank's shapes: the serving mesh's, the mesh-steps', the
    # mesh-archs' (the RG-LRU scan on half the channels, granite's gate),
    # then mesh-encdec's seq-sharded reads with their lse (bf16 apart)
    me_f32, me_bf16 = me_cases()
    mesh_kernels = (mesh_cases() + mesh_step_cases() + mesh_arch_cases()
                    + me_f32)
    free_cuda()
    planted = planted_faults([("gate_mlp_bwd", gb_train_run),
                              ("gate_mlp_bwd", gb_sub_run),
                              ("gate_mlp_bwd", gb_rg_run),
                              ("gated_flash_bwd", fb_train_run),
                              ("gated_flash_bwd", fb_sub_run),
                              ("gated_flash_bwd", fb_g3_run),
                              ("gated_flash_bwd", fb_rg_run),
                              ("gated_flash_bwd_hd256", fb_rg_run),
                              ("rglru_scan_bwd", rb_train_run),
                              ("rglru_scan_bwd", rb_h0_run), *fwd_runs,
                              *new_runs, *mode_runs])
    del gb_train_run, gb_sub_run, fb_train_run, fb_sub_run, rb_train_run
    del rb_h0_run, fb_rg_run, fb_g3_run, gb_rg_run, fwd_runs, new_runs
    del mode_runs
    free_cuda()
    for tag, r in (("gate_mlp", gate_main), ("gate_mlp", gate_big),
                   ("gate_mlp", gate_prefill),
                   ("paged_decode", pd_main), ("paged_decode", pd_bf16),
                   ("paged_decode", pd_big), ("vertical_slash", vs_main),
                   ("vertical_slash", vs_bf16), ("gated_flash", gf_main),
                   ("gated_flash", gf_bf16), ("gated_flash", gf_probe),
                   ("gated_flash", gf_probe_bf16),
                   ("paged_decode_selected", sel_main),
                   ("paged_decode_selected", sel_bf16),
                   ("paged_decode_selected", sel_long),
                   ("paged_decode_selected", sel_long_bf16),
                   ("rglru_scan", rg_scan), ("rglru_scan", rg_scan_h0),
                   ("gate_mlp rg", rg_gate), ("gate_mlp rg", rg_gate_dec),
                   ("paged_decode rg", rg_pd), ("paged_decode rg", rg_pd_bf16),
                   ("paged_decode rg", rg_pd_serve),
                   ("vertical_slash rg", rg_vs),
                   ("vertical_slash rg", rg_vs_bf16),
                   ("gated_flash rg", rg_gf), ("gated_flash rg", rg_gf_bf16),
                   ("gated_flash rg", rg_gf_probe),
                   ("paged_decode dense", dense_serve),
                   ("paged_decode dense", dense_long),
                   ("paged_decode dense", dense_long_bf16),
                   ("gated_flash causal", gf_causal),
                   ("gated_flash causal", gf_causal_bf16),
                   ("gated_flash_window rg", win_rg),
                   ("gated_flash_window rg", win_rg_bf16),
                   ("gated_flash_window qwen3", win_q3),
                   ("gated_flash_window qwen3", win_q3_bf16),
                   ("paged_decode_starts rg", st_rg),
                   ("paged_decode_starts rg", st_rg_bf16),
                   ("paged_decode_starts ragged", st_ragged),
                   ("paged_decode_starts ragged", st_ragged_bf16),
                   ("gate_mlp_bwd", gb_train), ("gate_mlp_bwd", gb_sub),
                   ("gated_flash_bwd", fb_train),
                   ("gated_flash_bwd", fb_sub),
                   ("rglru_scan_bwd", rb_train), ("rglru_scan_bwd", rb_h0),
                   ("gated_flash_bwd rg", fb_rg),
                   ("gated_flash_bwd G3", fb_g3),
                   ("gated_flash_bwd G3", fb_g3_80),
                   ("gate_mlp_bwd rg", gb_rg), *dense_kernels,
                   *moe_kernels, *new_kernels, *fig_kernels,
                   *mesh_kernels, *me_bf16):
        print(f"kernel {tag}: " + json.dumps(r), flush=True)
    print("planted faults (backward: relative error, limit "
          f"{BWD_REL}; forward: max abs error, limit {TOL['float32']}): "
          + json.dumps(planted), flush=True)
    lap("kernels")
    # 4-10. the main paths, counts set to 0 just before each
    cli_counts = serve_cli(n_layers=28)
    lap("serve-cli")
    long_counts = serve_long(card)
    lap("serve-long")
    cfg, params = full_model(seed=2)
    base = prefill_long(cfg, params)
    prefill_counts = base["counts"]
    select_counts = decode_select(cfg, params, base)
    long_stats = {k: base[k] for k in ("prefill_ms", "decode_ms_per_step")}
    del base
    free_cuda()
    dense_counts = prefill_dense(cfg, params, long_stats)
    forward_counts = forward_gated(cfg, params)["launches"]
    lap("prefill-long..forward-gated")
    free_cuda()
    # the roofline: prefill-long's prefill, one of its decode steps (on
    # the caches that prefill returned: t = 4,096, the global cache at its
    # budget) and the train phase's step (launch.train: no remat, no
    # query chunks) as dry-run bundles, counted on meta and on the card
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import make_bundle
    pre_shape = InputShape("prefill_4k", 4096, 1, "prefill")
    roof = {}
    roof["prefill-long"], out = roofline_path(
        card, "prefill-long", "qwen3-0.6b", cfg, params, pre_shape,
        {"gate_mlp": 28, "vertical_slash": 28})
    card_caches = out[2]
    del out
    meta_pre = make_bundle(cfg, pre_shape, use_wgkv=True)
    meta_caches = meta_pre.fn(*meta_pre.args)[2]
    del meta_pre
    roof["decode"], out = roofline_path(
        card, "decode", "qwen3-0.6b", cfg, params,
        InputShape("decode_4k", 4096, 1, "decode"),
        {"gate_mlp": 28, "paged_decode": 28},
        caches=(meta_caches, card_caches))
    del out, card_caches, meta_caches
    free_cuda()
    roof["train"], out = roofline_path(
        card, "train", "qwen3-0.6b", cfg, params,
        InputShape("train_2k", 2048, 2, "train"),
        {k: 28 for k in ("gated_flash", "gated_flash_bwd", "gate_mlp",
                         "gate_mlp_bwd")},
        knob_overrides={"remat": False, "q_chunk": None})
    del out
    lap("roofline qwen3")
    # this slice's: Fig. 8 at full width on prefill-long's model, then the
    # figure benchmarks and the four examples
    free_cuda()
    fig8_full(card, cfg, params)
    del params
    free_cuda()
    figures_counts = figures_phase(card)
    lap("figures")
    free_cuda()
    compose_counts = serve_compose(card)
    lap("serve-compose")
    substrate_counts = substrate()
    lap("substrate")
    # the baselines and the prefix store (this slice's paths)
    ab_counts = serve_ab(card)
    lap("serve-ab")
    prefix_counts = prefix_phase(card)
    sub_ab_counts = substrate_ab()
    lap("prefix+substrate-ab")
    # this slice's: the serving tick under the run-time sentinels, and
    # the fixed-slot loop on card and CPU
    free_cuda()
    sentinel_counts = sentinels_phase(card)
    lap("sentinels")
    loop_counts = legacy_loop_phase()
    lap("legacy-loop")
    # sharded serving: flat, a 1 x 1 NCCL mesh, a 1 x 2 gloo mesh on the
    # one card
    free_cuda()
    mesh_counts = mesh_phase(card)
    lap("mesh")
    # the sharded step bundles: train (FSDP), prefill and decode on 1 x 1
    # NCCL, 1 x 2 and 2 x 1 gloo meshes, against the flat bundles
    free_cuda()
    mesh_counts.update({f"steps {k}": c for k, c in
                        mesh_steps_phase(card).items()})
    lap("mesh-steps")
    # the MoE and hybrid archs on the mesh: granite served and stepped,
    # recurrentgemma-9b trained and stepped, qwen3-moe stepped, 1 x 2
    free_cuda()
    mesh_counts.update({f"archs {k}": c for k, c in
                        mesh_archs_phase(card).items()})
    lap("mesh-archs")
    # whisper-medium and qwen2-vl-7b on the mesh (1 x 1 NCCL, 1 x 2 gloo),
    # and the seq-sharded dense and Quest reads (2 x 1 gloo)
    free_cuda()
    mesh_counts.update({f"encdec {k}": c for k, c in
                        mesh_encdec_phase(card).items()})
    lap("mesh-encdec")
    # xlstm-350m on the mesh (1 x 1 NCCL, 1 x 2 and 2 x 1 gloo), its
    # full-parameter train step, and an MoE routing group gathered over
    # "data" under a gradient
    free_cuda()
    mesh_counts.update({f"xlstm {k}": c for k, c in
                        mesh_xlstm_phase(card).items()})
    lap("mesh-xlstm")
    # gate-distillation training (this slice's paths)
    free_cuda()
    train_counts, train_stats = train_arch(card, "qwen3-0.6b", steps=4,
                                           batch=2, seq=2048, tag="train",
                                           check_backbone=True)
    free_cuda()
    train_sub_counts = train_substrate()
    lap("train+train-substrate")
    # 11-14. recurrentgemma-9b (one 32 GiB model at a time)
    free_cuda()
    rg_serve_counts = rg_serve(card)
    lap("rg-serve")
    free_cuda()
    rg_cfg, rg_params = rg_model(seed=5)
    rg_prefill_counts, rg_decode_counts, rg_dense_counts = rg_prefill(
        rg_cfg, rg_params)
    rg_forward_counts = rg_forward(rg_cfg, rg_params)
    lap("rg-prefill+rg-forward")
    free_cuda()
    roof["rg-prefill"], out = roofline_path(
        card, "rg-prefill", "recurrentgemma-9b", rg_cfg, rg_params,
        InputShape("rg_prefill_4k", 4096, 1, "prefill"),
        {"gate_mlp": 12, "vertical_slash": 12, "rglru_scan": 26})
    del out
    lap("roofline rg")
    print("roofline: " + json.dumps({k: {
        x: v[x] for x in ("bound_ms", "bound_ms_shapes", "bound_by",
                          "wall_ms", "device_ms", "wall_over_bound",
                          "model_flop_share_at_67T",
                          "predicted_peak_bytes", "measured_peak_bytes")}
        for k, v in roof.items()}), flush=True)
    del rg_params
    free_cuda()
    rg_substrate_counts, rg_sub_dense_counts = rg_substrate()
    lap("rg-substrate")
    # this slice's: the hybrid's training at full width, its reduced
    # config's training on card and CPU, the three dense archs, and
    # smollm-360m's training (gated_flash_bwd at G 3)
    free_cuda()
    rg_train_counts, rg_train_stats = train_arch(
        card, "recurrentgemma-9b", steps=3, batch=1, seq=4096,
        tag="rg-train")
    lap("rg-train")
    free_cuda()
    rg_train_sub_counts = rg_train_substrate()
    lap("rg-train-substrate")
    dense_counts_by = {}
    for seed, arch in enumerate(DENSE_HEADS):
        free_cuda()
        dense_counts_by[arch] = dense_arch(arch, card, seed=60 + seed)
        lap(f"dense-arch {arch}")
    free_cuda()
    smollm_train_counts, _ = train_arch(card, "smollm-360m", steps=2,
                                        batch=2, seq=2048,
                                        tag="smollm-train")
    lap("smollm-train")
    # the MoE archs: their reduced configs on card and CPU,
    # granite-moe-3b-a800m at full width (serve, prefill, gated forward,
    # training) and qwen3-moe-235b-a22b at full width, 4 repeats
    free_cuda()
    moe_reduced_counts = moe_reduced()
    lap("moe-reduced")
    free_cuda()
    moe_counts = moe_granite(card, seed=70)
    lap("moe granite")
    free_cuda()
    moe_train_counts, moe_train_stats = train_arch(
        card, "granite-moe-3b-a800m", steps=2, batch=2, seq=2048,
        tag="moe-train")
    lap("moe-train")
    free_cuda()
    q3m_counts = qwen3moe_d4(card, seed=71)
    lap("qwen3moe-d4")
    # this slice's: the three reduced configs on card and CPU, then
    # xlstm-350m, whisper-medium and qwen2-vl-7b at full width, one model
    # at a time
    free_cuda()
    new_reduced_counts = new_archs_reduced()
    lap("new-archs-reduced")
    free_cuda()
    xlstm_counts = xlstm_phase(card)
    lap("xlstm")
    free_cuda()
    whisper_counts = whisper_phase(card)
    lap("whisper")
    free_cuda()
    q2vl_counts = qwen2vl_phase(card)
    lap("qwen2vl")
    new_launches = {"xlstm": xlstm_counts,
                    **{f"whisper_{k}": c for k, c in whisper_counts.items()},
                    **{f"qwen2vl_{k}": c for k, c in q2vl_counts.items()},
                    **{f"new_reduced {a}": c
                       for a, c in new_reduced_counts.items()}}
    moe_launches = {"moe_serve": moe_counts["serve"],
                    "moe_prefill": moe_counts["prefill"],
                    "moe_forward": moe_counts["forward"],
                    "moe_train": moe_train_counts,
                    "qwen3moe_d4_serve": q3m_counts["serve"],
                    "qwen3moe_d4_prefill": q3m_counts["prefill"],
                    **{f"moe_reduced {a}": c
                       for a, c in moe_reduced_counts.items()}}

    def moe_entry(name):
        """A kernel's launches on each MoE path and on each of this
        slice's, and its cases at the MoE archs' heads and at this slice's
        (qwen2-vl-7b, whisper-medium)."""
        out = {"launches_moe": {k: c[name] for k, c in moe_launches.items()
                                if c.get(name)},
               "launches_new_archs": {k: c[name]
                                      for k, c in new_launches.items()
                                      if c.get(name)}}
        if name in moe_by:
            out["moe_archs"] = moe_by[name]
        if name in new_by:
            out["new_archs"] = new_by[name]
        return out
    rg = "recurrentgemma"
    attn = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    dense_by = {}  # kernel -> arch -> its cases at the dense archs' shapes
    for tag, r in dense_kernels:
        name, arch = tag.split()
        dense_by.setdefault(name, {}).setdefault(arch, []).append(r)

    moe_by = {}  # kernel -> arch -> its cases at the MoE archs' shapes
    for tag, r in moe_kernels:
        name, arch = tag.split()
        moe_by.setdefault(name, {}).setdefault(arch, []).append(r)
    new_by = {}  # kernel -> arch -> its cases at this slice's shapes
    for tag, r in new_kernels:
        name, arch = tag.split()
        new_by.setdefault(name, {}).setdefault(arch, []).append(r)

    fig_by = {}  # kernel -> figure -> its cases at the figures' shapes
    for tag, r in fig_kernels:
        name, fig = tag.split()
        fig_by.setdefault(name, {}).setdefault(fig, []).append(r)
    mesh_by = {}  # kernel -> its cases at one mesh rank's shapes
    for tag, r in mesh_kernels:
        mesh_by.setdefault(tag.split()[0], []).append(r)
    mesh_bf16 = {}
    for tag, r in me_bf16:
        mesh_bf16.setdefault(tag.split()[0], []).append(r)

    def dense_err(name):
        return max(r["max_abs_err"] for by in (dense_by, moe_by, new_by)
                   for rs in by[name].values() for r in rs)

    def new_err(name):
        return max(r["max_abs_err"] for rs in new_by[name].values()
                   for r in rs)
    kernels = [
        {"name": "gate_mlp", "route": "cuda",
         "source": "src/repro_torch/csrc/gate_mlp.cu",
         "replaces": "src/repro/kernels/gate_mlp.py:28",
         "launches": long_counts["gate_mlp"],
         "max_abs_err": max(dense_err("gate_mlp"), *(
             r["max_abs_err"] for r in (gate_main, gate_big, gate_prefill,
                                        rg_gate, rg_gate_dec))),
         **{k: gate_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
         "shape": gate_main["shape"], "device_ms": gate_main["device_ms"],
         "bound_rate": gate_main["bound_rate"],
         "bound_ms_cuda_cores": gate_main["bound_ms_cuda_cores"],
         "launches_serve_cli": cli_counts["gate_mlp"], "large": gate_big,
         "prefill": gate_prefill,
         "launches_prefill_long": prefill_counts["gate_mlp"],
         "launches_rg_prefill": rg_decode_counts["gate_mlp"],
         "launches_rg_serve": rg_serve_counts["gate_mlp"],
         "launches_train": train_counts["gate_mlp"],
         rg: {"prefill": rg_gate, "decode": rg_gate_dec},
         "dense_archs": dense_by["gate_mlp"],
         "launches_rg_train": rg_train_counts["gate_mlp"],
         "launches_smollm_train": smollm_train_counts["gate_mlp"],
         "launches_dense_archs": {a: {k: v["gate_mlp"] for k, v in c.items()}
                                  for a, c in dense_counts_by.items()}},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:59",
         "launches": long_counts["paged_decode"],
         "max_abs_err": max(pd_main["max_abs_err"], pd_big["max_abs_err"],
                            dense_err("paged_decode")),
         **{k: pd_main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
         "shape": pd_main["shape"],
         "max_abs_err_bf16": pd_bf16["max_abs_err"],
         "launches_serve_cli": cli_counts["paged_decode"],
         "bf16": pd_bf16, "large": pd_big,
         "launches_rg_prefill": rg_decode_counts["paged_decode"],
         "launches_rg_serve": rg_serve_counts["paged_decode"],
         rg: {"offline": rg_pd, "offline_bf16": rg_pd_bf16,
              "serve": rg_pd_serve},
         "launches_serve_ab": {k: v["paged_decode"]
                               for k, v in ab_counts.items()},
         "launches_prefill_dense": dense_counts["paged_decode"],
         "launches_prefix": {k: v["paged_decode"]
                             for k, v in prefix_counts.items()},
         "launches_substrate_ab": {k: v["paged_decode"]
                                   for k, v in sub_ab_counts.items()},
         "dense": {"serve": dense_serve, "offline": dense_long,
                   "offline_bf16": dense_long_bf16},
         "dense_archs": dense_by["paged_decode"],
         "launches_dense_archs": {
             a: {k: v["paged_decode"] for k, v in c.items()}
             for a, c in dense_counts_by.items()}},
        {"name": "vertical_slash", "route": "cuda",
         "source": "src/repro_torch/csrc/vertical_slash.cu",
         "replaces": "src/repro/kernels/vertical_slash.py:88",
         "launches": prefill_counts["vertical_slash"],
         "max_abs_err": max(vs_main["max_abs_err"],
                            dense_err("vertical_slash")),
         **{k: vs_main[k] for k in attn}, "shape": vs_main["shape"],
         "bound_rate": vs_main["bound_rate"],
         "bound_ms_cuda_cores": vs_main["bound_ms_cuda_cores"],
         "device_ms": vs_main["device_ms"],
         "max_abs_err_bf16": vs_bf16["max_abs_err"], "bf16": vs_bf16,
         "launches_rg_prefill": rg_prefill_counts["vertical_slash"],
         "launches_rg_substrate": rg_substrate_counts["vertical_slash"],
         rg: {"f32": rg_vs, "bf16": rg_vs_bf16},
         "dense_archs": dense_by["vertical_slash"],
         "launches_dense_archs": {
             a: {k: v["vertical_slash"] for k, v in c.items()}
             for a, c in dense_counts_by.items()}},
        {"name": "gated_flash", "route": "cuda",
         "source": "src/repro_torch/csrc/gated_flash.cu",
         "replaces": "src/repro/kernels/gated_flash.py:68",
         "launches": forward_counts["gated_flash"],
         "max_abs_err": max(gf_main["max_abs_err"],
                            gf_probe["max_abs_err"],
                            dense_err("gated_flash")),
         **{k: gf_main[k] for k in attn}, "shape": gf_main["shape"],
         "bound_rate": gf_main["bound_rate"],
         "bound_ms_cuda_cores": gf_main["bound_ms_cuda_cores"],
         "device_ms": gf_main["device_ms"],
         "max_abs_err_bf16": max(gf_bf16["max_abs_err"],
                                 gf_probe_bf16["max_abs_err"]),
         "launches_serve_cli": cli_counts["gated_flash"],
         "bf16": gf_bf16, "probe": gf_probe, "probe_bf16": gf_probe_bf16,
         "launches_rg_forward": rg_forward_counts["gated_flash"],
         "launches_rg_serve": rg_serve_counts["gated_flash"],
         rg: {"f32": rg_gf, "bf16": rg_gf_bf16, "probe": rg_gf_probe},
         "launches_prefill_dense": dense_counts["gated_flash"],
         "launches_train": train_counts["gated_flash"],
         "launches_train_substrate": train_sub_counts["gated_flash"],
         "causal": {"f32": gf_causal, "bf16": gf_causal_bf16},
         "dense_archs": dense_by["gated_flash"],
         "launches_rg_train": rg_train_counts["gated_flash"],
         "launches_smollm_train": smollm_train_counts["gated_flash"],
         "launches_dense_archs": {
             a: {k: v["gated_flash"] for k, v in c.items()}
             for a, c in dense_counts_by.items()}},
        {"name": "paged_decode_selected", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:133",
         "launches": select_counts["paged_decode_selected"],
         "max_abs_err": max(sel_main["max_abs_err"],
                            sel_long["max_abs_err"]),
         **{k: sel_main[k] for k in attn}, "shape": sel_main["shape"],
         "full_read_ms": sel_main["full_read_ms"],
         "max_abs_err_bf16": max(sel_bf16["max_abs_err"],
                                 sel_long_bf16["max_abs_err"]),
         "launches_serve_compose": compose_counts["paged_decode_selected"],
         "launches_substrate": substrate_counts["paged_decode_selected"],
         "bf16": sel_bf16, "offline": sel_long,
         "offline_bf16": sel_long_bf16},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:39",
         "launches": rg_prefill_counts["rglru_scan"],
         "max_abs_err": max(rg_scan["max_abs_err"],
                            rg_scan_h0["max_abs_err"]),
         **{k: rg_scan[k] for k in attn}, "shape": rg_scan["shape"],
         "device_ms": rg_scan["device_ms"],
         "launches_rg_forward": rg_forward_counts["rglru_scan"],
         "launches_rg_serve": rg_serve_counts["rglru_scan"],
         "launches_rg_substrate": rg_substrate_counts["rglru_scan"],
         "launches_rg_train": rg_train_counts["rglru_scan"],
         "launches_rg_train_substrate": rg_train_sub_counts["rglru_scan"],
         "ragged_h0": rg_scan_h0},
        {"name": "gate_mlp_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gate_mlp_bwd.cu",
         "replaces": "src/repro/kernels/gate_mlp.py:28",
         "launches": train_counts["gate_mlp_bwd"],
         "max_abs_err": max(gb_train["max_abs_err"], gb_sub["max_abs_err"],
                            new_err("gate_mlp_bwd")),
         **{k: gb_train[k] for k in attn}, "shape": gb_train["shape"],
         "device_ms": gb_train["device_ms"],
         "bound_rate": gb_train["bound_rate"],
         "bound_ms_cuda_cores": gb_train["bound_ms_cuda_cores"],
         "max_rel_err": gb_train["max_rel_err"],
         "launches_per_train_step":
             train_stats["launches_per_step"]["gate_mlp_bwd"],
         "launches_train_substrate": train_sub_counts["gate_mlp_bwd"],
         "planted_fault_rel_err": planted["gate_mlp_bwd"],
         "ptxas": ptxas_info("gate_mlp_bwd"),
         "smem_dynamic_bytes": build.load(
             "gate_mlp_bwd").gate_mlp_bwd_smem_bytes(256, 64),
         "substrate": gb_sub, rg: gb_rg,
         "smem_dynamic_bytes_rg": build.load(
             "gate_mlp_bwd").gate_mlp_bwd_smem_bytes(512, 64),
         "launches_rg_train": rg_train_counts["gate_mlp_bwd"],
         "launches_per_rg_train_step":
             rg_train_stats["launches_per_step"]["gate_mlp_bwd"],
         "launches_rg_train_substrate": rg_train_sub_counts["gate_mlp_bwd"],
         "launches_smollm_train": smollm_train_counts["gate_mlp_bwd"]},
        {"name": "gated_flash_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/gated_flash_bwd.cu",
         "replaces": "src/repro/kernels/gated_flash.py:68",
         "launches": train_counts["gated_flash_bwd"],
         "max_abs_err": max(fb_train["max_abs_err"], fb_sub["max_abs_err"],
                            new_err("gated_flash_bwd")),
         **{k: fb_train[k] for k in attn}, "shape": fb_train["shape"],
         "device_ms": fb_train["device_ms"],
         "bound_rate": fb_train["bound_rate"],
         "bound_ms_cuda_cores": fb_train["bound_ms_cuda_cores"],
         "library": fb_train["library"],
         "max_rel_err": fb_train["max_rel_err"],
         "launches_per_train_step":
             train_stats["launches_per_step"]["gated_flash_bwd"],
         "launches_train_substrate": train_sub_counts["gated_flash_bwd"],
         "planted_fault_rel_err": planted["gated_flash_bwd"],
         "library_fwd_bwd_ms": fb_train["library_fwd_bwd_ms"],
         "ptxas": ptxas_info("gated_flash_bwd"),
         "smem_dynamic_bytes": {
             f"{k}<{hd}>": build.load("gated_flash_bwd").gated_flash_bwd_smem_bytes(
                 hd, which) for hd in (64, 128, 256)
             for which, k in ((0, "bwd_kv_kernel"), (1, "bwd_q_kernel"))},
         "substrate": fb_sub, rg: fb_rg, "g3": [fb_g3, fb_g3_80],
         "head_splits_rg": build.load(
             "gated_flash_bwd").gated_flash_bwd_splits(256, 16),
         "planted_fault_rel_err_hd256": planted["gated_flash_bwd_hd256"],
         "launches_rg_train": rg_train_counts["gated_flash_bwd"],
         "launches_per_rg_train_step":
             rg_train_stats["launches_per_step"]["gated_flash_bwd"],
         "launches_rg_train_substrate":
             rg_train_sub_counts["gated_flash_bwd"],
         "launches_smollm_train": smollm_train_counts["gated_flash_bwd"]},
        {"name": "gated_flash_window", "route": "cuda",
         "source": "src/repro_torch/csrc/gated_flash.cu",
         "replaces": "src/repro/kernels/gated_flash.py:68",
         "reference_path": "src/repro/models/attention.py:312",
         "mode": "gated_flash's hard window (HARD): the dense baseline's "
                 "windowed prefill of local-attention blocks",
         "launches": rg_dense_counts["gated_flash_window"],
         "max_abs_err": max(win_rg["max_abs_err"], win_q3["max_abs_err"]),
         **{k: win_rg[k] for k in attn}, "shape": win_rg["shape"],
         "device_ms": win_rg["device_ms"],
         "bound_rate": win_rg["bound_rate"], "library": win_rg["library"],
         "max_abs_err_bf16": max(win_rg_bf16["max_abs_err"],
                                 win_q3_bf16["max_abs_err"]),
         "bf16": win_rg_bf16, "qwen3": {"f32": win_q3, "bf16": win_q3_bf16},
         "planted_fault_err": planted["gated_flash_window"],
         "launches_rg_substrate_dense":
             rg_sub_dense_counts["gated_flash_window"]},
        {"name": "paged_decode_starts", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_decode.py:59",
         "reference_path": "src/repro/models/attention.py:428",
         "mode": "paged_decode from a start offset: the dense baseline's "
                 "windowed decode read",
         "launches": rg_dense_counts["paged_decode_starts"],
         "max_abs_err": max(st_rg["max_abs_err"], st_ragged["max_abs_err"]),
         **{k: st_rg[k] for k in attn}, "shape": st_rg["shape"],
         "device_ms": st_rg["device_ms"], "split_plan": st_rg["split_plan"],
         "library": st_rg["library"],
         "max_abs_err_bf16": max(st_rg_bf16["max_abs_err"],
                                 st_ragged_bf16["max_abs_err"]),
         "bf16": st_rg_bf16,
         "ragged": {"f32": st_ragged, "bf16": st_ragged_bf16},
         "planted_fault_err": planted["paged_decode_starts"],
         "launches_rg_substrate_dense":
             rg_sub_dense_counts["paged_decode_starts"]},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:39",
         "launches": rg_train_counts["rglru_scan_bwd"],
         "max_abs_err": max(rb_train["max_abs_err"], rb_h0["max_abs_err"]),
         **{k: rb_train[k] for k in attn}, "shape": rb_train["shape"],
         "device_ms": rb_train["device_ms"],
         "max_rel_err": rb_train["max_rel_err"],
         "launches_per_rg_train_step":
             rg_train_stats["launches_per_step"]["rglru_scan_bwd"],
         "launches_rg_train_substrate":
             rg_train_sub_counts["rglru_scan_bwd"],
         "planted_fault_rel_err": planted["rglru_scan_bwd"],
         "ptxas": ptxas_info("rglru_scan_bwd"),
         "ragged_h0": rb_h0},
    ]
    for entry in kernels:
        entry.update(moe_entry(entry["name"]))
        entry["launches_sentinels"] = {k: c[entry["name"]]
                                       for k, c in sentinel_counts.items()}
        entry["launches_legacy_loop"] = loop_counts[entry["name"]]
        entry["launches_mesh"] = {k: c.get(entry["name"], 0)
                                  for k, c in mesh_counts.items()}
        entry["launches_figures"] = figures_counts[entry["name"]]
        if entry["name"] in fig_by:
            entry["figures"] = fig_by[entry["name"]]
            entry["max_abs_err"] = max(
                entry["max_abs_err"], *(r["max_abs_err"] for rs in
                                        fig_by[entry["name"]].values()
                                        for r in rs))
        if entry["name"] in mesh_by:
            entry["mesh_rank"] = mesh_by[entry["name"]]
            entry["max_abs_err"] = max(
                entry["max_abs_err"],
                *(r["max_abs_err"] for r in mesh_by[entry["name"]]))
        if entry["name"] in mesh_bf16:
            entry["mesh_rank_bf16"] = mesh_bf16[entry["name"]]
            entry["max_abs_err_bf16"] = max(
                entry["max_abs_err_bf16"],
                *(r["max_abs_err"] for r in mesh_bf16[entry["name"]]))
    print("phase seconds: " + json.dumps(PHASE_S))
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
