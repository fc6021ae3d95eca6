"""Synthetic data pipeline (port of ``repro/data/synthetic.py``; no
FineWeb/HELMET downloads).

  * ``token_stream`` — zipfian web-like token stream (gate distillation;
    paper Appendix C trains on FineWeb-Edu samples).
  * ``needle_task``  — key-value retrieval in a long haystack: the model
    must emit the payload that followed the needle marker when queried at
    the end.
  * ``copy_task``    — prompt echo after long filler.

Every draw comes from an explicit ``torch.Generator`` (on the device the
tokens are made on). That cannot reproduce ``jax.random``'s bits, so the
parity tests hand both packages the same numpy tokens; the structure of
each task is the reference's.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding import comm


def _specials(vocab: int):
    """Reserved control tokens at the top of the vocab."""
    return {"needle": vocab - 1, "query": vocab - 2, "sep": vocab - 3}


def _randint(gen: torch.Generator, lo: int, hi, shape) -> torch.Tensor:
    """Integers in [lo, hi) (hi a scalar or a tensor broadcastable to
    ``shape``), int64, on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    hi = torch.as_tensor(hi, device=gen.device)
    return lo + torch.floor(u * (hi - lo)).long().clamp(max=hi - lo - 1)


def token_stream(gen: torch.Generator, batch: int, seq: int, vocab: int,
                 zipf_a: float = 1.3) -> torch.Tensor:
    """Zipf-distributed token ids in [0, vocab-8) (specials excluded),
    int32, by inverse CDF of uniform draws."""
    u = torch.rand((batch, seq), generator=gen, device=gen.device)
    n = min(vocab - 8, 4096)
    w = 1.0 / np.arange(1, n + 1) ** zipf_a
    cdf = torch.as_tensor(np.cumsum(w) / np.sum(w), dtype=torch.float32,
                          device=gen.device)
    return torch.searchsorted(cdf, u).clamp(max=n - 1).to(torch.int32)


def needle_task(gen: torch.Generator, batch: int, seq: int, vocab: int,
                payload: int = 4, needle_frac_lo: float = 0.05,
                needle_frac_hi: float = 0.55, occurrences: int = 3
                ) -> Dict[str, torch.Tensor]:
    """tokens = [hay .. M p1..pk .. hay .. M p1..pk .. hay .. M p1..pk]
    (the same marker M each time): the payload appears ``occurrences``
    times in the first ``needle_frac_hi`` of the sequence, then the model
    must reproduce p1..pk after the final M at the tail. Returns tokens
    [B, S] int32, loss_mask [B, S] (1 on the answer span), answer [B,
    payload], needle_pos [B] and query_pos."""
    sp = _specials(vocab)
    dev = gen.device
    hay = token_stream(gen, batch, seq, vocab)
    pay = _randint(gen, 0, vocab - 8, (batch, payload))
    lo = int(seq * needle_frac_lo)
    hi = int(seq * needle_frac_hi)
    span = max((hi - lo) // max(occurrences, 1), payload + 2)
    offs = _randint(gen, 0, max(span - payload - 1, 1), (batch, occurrences))
    npos = lo + torch.arange(occurrences, device=dev)[None] * span + offs
    qpos = seq - payload - 1
    idx = torch.arange(seq, device=dev)[None]
    toks = hay.long()
    bidx = torch.arange(batch, device=dev)[:, None]
    for o in range(occurrences):
        off = idx - npos[:, o][:, None]
        toks = torch.where(off == 0, sp["needle"], toks)
        in_pay = (off >= 1) & (off <= payload)
        pay_val = pay[bidx, torch.clamp(off - 1, 0, payload - 1)]
        toks = torch.where(in_pay, pay_val, toks)
    toks = torch.where(idx == qpos, sp["needle"], toks)
    ans_off = idx - qpos - 1
    in_ans = (ans_off >= 0) & (ans_off < payload)
    ans_val = pay[bidx, torch.clamp(ans_off, 0, payload - 1)]
    toks = torch.where(in_ans, ans_val, toks)
    loss_mask = torch.broadcast_to(in_ans, toks.shape).float()
    return {"tokens": toks.to(torch.int32), "loss_mask": loss_mask,
            "answer": pay.to(torch.int32), "needle_pos": npos[:, 0],
            "query_pos": qpos}


def copy_task(gen: torch.Generator, batch: int, prompt: int, filler: int,
              vocab: int) -> Dict[str, torch.Tensor]:
    """[prompt tokens][SEP][filler][QUERY] -> the model must echo the
    prompt."""
    sp = _specials(vocab)
    dev = gen.device
    p = _randint(gen, 0, vocab - 8, (batch, prompt)).to(torch.int32)
    f = token_stream(gen, batch, filler, vocab)
    toks = torch.cat([
        p,
        torch.full((batch, 1), sp["sep"], dtype=torch.int32, device=dev),
        f,
        torch.full((batch, 1), sp["query"], dtype=torch.int32, device=dev),
    ], dim=1)
    return {"tokens": toks, "prompt": p}


class DistillStream:
    """Iterator of gate-distillation batches (paper Appendix C setup, with
    the generic instruction prefix replaced by a fixed SEP prefix): token
    streams, with a needle task every ``1 / task_mix`` batches. Tokens are
    drawn on ``device`` (default ``cuda``) from a generator seeded with
    ``seed``."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int,
                 task_mix: float = 0.5, device: DeviceLike = None):
        dev = resolve_device(device)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.task_mix = task_mix
        self._i = 0

    def __iter__(self) -> Iterator[Dict[str, Optional[torch.Tensor]]]:
        return self

    def __next__(self) -> Dict[str, Optional[torch.Tensor]]:
        self._i += 1
        if self._i % max(int(1 / max(self.task_mix, 1e-6)), 1) == 0:
            b = needle_task(self.gen, self.batch, self.seq, self.vocab)
            return {"tokens": b["tokens"], "loss_mask": None}
        return {"tokens": token_stream(self.gen, self.batch, self.seq,
                                       self.vocab),
                "loss_mask": None}


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy. On a mesh (``sharding.comm.active``) the
    mean over every rank's rows: the rank's summed loss and its count are
    added over the axes the rows are split over (``comm.sum_rows``)."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    if loss_mask is None and comm.ACTIVE is None:
        return nll.mean()
    if loss_mask is not None:
        m = loss_mask[:, 1:]
        num, den = (nll * m).sum(), m.sum().to(nll.dtype)
    else:
        num, den = nll.sum(), nll.new_tensor(float(nll.numel()))
    tot = comm.sum_rows(torch.stack([num, den]))
    return tot[0] / torch.clamp(tot[1], min=1.0)
