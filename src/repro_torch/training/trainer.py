"""Gate-only distillation trainer (port of ``repro/training/trainer.py``;
paper §3.3, Appendix C).

The backbone is FROZEN: only the Write-Gate MLP parameters are optimized.
They are pulled out of the parameter tree into a flat dict keyed by the
reference's ``/``-joined paths (``blocks/b0/attn/gate/w1``, ...), and only
those leaves require grad, so autograd builds no weight gradient for the
backbone. A gate leaf is stacked over the repeats (``[n_repeats, H, ...]``);
each layer's slice is a view of it, so the gradient reaches the stacked
leaf.

    L_total = || h_gated - h_teacher ||^2  +  lambda * L_sparsity(g)

On CUDA the student's attention and gate run through the ``gated_flash``
and ``gate_mlp`` kernels and their backward kernels; the teacher runs
under ``torch.no_grad()`` (the reference's ``stop_gradient``). There is no
``jit``: :func:`make_train_step` returns a plain callable. ``moe_groups``
(the routing groups of every ``attn_moe`` block) is passed through to
both forwards, as in the reference; its ``scan_unroll`` (an XLA compile
hint with no eager counterpart) is not taken.

On a mesh (``launch.steps.make_bundle`` with a mesh runs the step under
``sharding.comm.active``) the losses are global (``core/losses.py``),
each rank's gate leaves are its kv heads' slices, and the gate gradients
are summed over the axes the batch rows are split over before AdamW
updates the rank's slices (AdamW is elementwise). The MoE and RG-LRU
blocks run expert- and channel-parallel there (``models/moe.py``,
``models/rglru.py``), the xLSTM blocks head-parallel
(``models/xlstm.py``). Full-parameter LM training (:func:`lm_train_step`)
runs there too: the next-token loss is the global mean, every leaf the
rank holds gets the gradient of it (an FSDP block's summed by its
gather's backward, the rest by ``comm.sum_grads``), and AdamW
updates the rank's blocks with moments shaped like them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import flat_paths
from repro_torch.core.losses import total_loss
from repro_torch.data.synthetic import lm_loss
from repro_torch.models import transformer as T
from repro_torch.sharding import comm
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update)
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

GateDict = Dict[str, torch.Tensor]


# ==========================================================================
# gate-parameter extraction / injection
# ==========================================================================
def get_gates(params) -> GateDict:
    """The gate leaves of ``params`` by ``/``-joined path."""
    return {key: leaf for key, leaf in flat_paths(params)
            if "gate" in key.split("/")}


def set_gates(params, gates: GateDict):
    """``params`` with the gate leaves replaced by ``gates`` (the same
    tensor objects; every other leaf is shared, not copied)."""
    return tree_map_with_path(
        lambda path, leaf: gates.get("/".join(map(str, path)), leaf), params)


# ==========================================================================
# loss / step
# ==========================================================================
def _forward_kw(batch) -> Dict[str, Any]:
    """The forward's inputs besides the tokens a batch carries:
    ``enc_embeds`` (the encoder-decoder), ``positions`` (M-RoPE) and
    ``embeds`` (a VLM stream)."""
    return {k: batch[k] for k in ("enc_embeds", "positions", "embeds")
            if k in batch}


def distill_loss_fn(gates: GateDict, params, cfg: ModelConfig, batch, *,
                    lam: float, moe_groups: int = 1,
                    q_chunk: Optional[int] = None, remat: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: {"tokens": [B, S] (absent for a stream of ``embeds``),
    "loss_mask": [B, S] or None, and :func:`_forward_kw`'s inputs}."""
    p = set_gates(params, gates)
    kw = dict(_forward_kw(batch), moe_groups=moe_groups, q_chunk=q_chunk)
    with torch.no_grad():
        teacher = T.forward(p, cfg, batch.get("tokens"), mode="teacher",
                            with_logits=False, **kw)
    student = T.forward(p, cfg, batch.get("tokens"), mode="gated",
                        with_logits=False, remat=remat, **kw)
    return total_loss(student.hidden, teacher.hidden, student.gates, lam,
                      batch.get("loss_mask"))


def loss_and_grads(gates: GateDict, params, cfg: ModelConfig, batch, *,
                   lam: float, moe_groups: int = 1,
                   q_chunk: Optional[int] = None, remat: bool = False):
    """(loss, aux, grads): the distillation loss and its gradient with
    respect to every gate leaf, the reference's ``jax.value_and_grad`` of
    :func:`distill_loss_fn`. Nothing is accumulated into ``.grad``."""
    leaves = {k: v.detach().requires_grad_() for k, v in gates.items()}
    with torch.enable_grad():
        loss, aux = distill_loss_fn(leaves, params, cfg, batch, lam=lam,
                                    moe_groups=moe_groups, q_chunk=q_chunk,
                                    remat=remat)
        # a gate outside the loss's graph (whisper's cross-memory gates
        # in training) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, dict(zip(leaves, grads))


class TrainState(NamedTuple):
    gates: GateDict
    opt: AdamWState


def init_train_state(params) -> TrainState:
    # copies: a step returns new gate tensors and never writes into the
    # ones ``params`` holds
    gates = {k: v.detach().clone() for k, v in get_gates(params).items()}
    return TrainState(gates, adamw_init(gates))


def train_step(state: TrainState, params, cfg: ModelConfig, batch, *, lr,
               lam: Optional[float] = None, moe_groups: int = 1,
               q_chunk: Optional[int] = None, remat: bool = False
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    lam = cfg.wgkv.lam if lam is None else lam
    loss, aux, grads = loss_and_grads(state.gates, params, cfg, batch,
                                      lam=lam, moe_groups=moe_groups,
                                      q_chunk=q_chunk, remat=remat)
    grads = comm.sum_grads(grads)
    new_gates, new_opt = adamw_update(grads, state.opt, state.gates, lr=lr)
    return TrainState(new_gates, new_opt), dict(aux, loss=loss)


def make_train_step(cfg: ModelConfig, *, lr, lam=None, moe_groups=1,
                    q_chunk=None, remat=False):
    """``step(state, params, batch=...)``: :func:`train_step` with the
    config and options bound (a plain callable; nothing is compiled)."""
    return functools.partial(train_step, cfg=cfg, lr=lr, lam=lam,
                             moe_groups=moe_groups, q_chunk=q_chunk,
                             remat=remat)


# ==========================================================================
# standard LM training (every parameter; the reference uses it for archs
# WG-KV does not apply to)
# ==========================================================================
class LMTrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_lm_train_state(params) -> LMTrainState:
    return LMTrainState(params, adamw_init(params))


def lm_loss_fn(params, cfg: ModelConfig, batch, *, moe_groups=1,
               q_chunk=None, remat=False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The next-token loss plus 0.01 times the summed MoE load-balance
    loss (0 without ``attn_moe`` blocks), as in the reference; on a mesh
    both over the whole batch."""
    out = T.forward(params, cfg, batch.get("tokens"), mode="teacher",
                    moe_groups=moe_groups, q_chunk=q_chunk, remat=remat,
                    **_forward_kw(batch))
    ll = lm_loss(out.logits, batch["tokens"], batch.get("loss_mask"))
    return ll + 0.01 * out.lb_loss, {"lm_loss": ll, "lb_loss": out.lb_loss}


def lm_loss_and_grads(params, cfg: ModelConfig, batch, *, moe_groups=1,
                      q_chunk=None, remat=False):
    """(loss, aux, grads): :func:`lm_loss_fn` and its gradient with
    respect to every leaf of ``params`` (a tree of the same structure),
    the reference's ``jax.value_and_grad``. On a mesh ``params`` are the
    rank's blocks and each gradient is the global loss's in that block,
    summed over the batch rows' ranks (``comm.sum_grads``)."""
    leaves = tree_map(lambda v: v.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, aux = lm_loss_fn(leaves, cfg, batch, moe_groups=moe_groups,
                               q_chunk=q_chunk, remat=remat)
        flat = torch.autograd.grad(loss, tree_leaves(leaves),
                                   materialize_grads=True)
    comm.sum_grads(dict(zip((k for k, _ in flat_paths(params)), flat)))
    grads = iter(flat)
    grads = tree_map(lambda _: next(grads), params)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def lm_train_step(state: LMTrainState, cfg: ModelConfig, batch, *, lr,
                  moe_groups=1, q_chunk=None, remat=False
                  ) -> Tuple[LMTrainState, Dict[str, torch.Tensor]]:
    loss, aux, grads = lm_loss_and_grads(state.params, cfg, batch,
                                         moe_groups=moe_groups,
                                         q_chunk=q_chunk, remat=remat)
    new_params, new_opt = adamw_update(grads, state.opt, state.params, lr=lr)
    return LMTrainState(new_params, new_opt), dict(aux, loss=loss)
