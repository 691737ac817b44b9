"""AdamW with the reference's production knobs (`repro/optim/adamw.py`):
an optimizer-state dtype (bf16 states for the largest models),
global-norm clipping and a warmup + cosine schedule.

The math is the reference's, in f32, with the step count after the
increment in the bias correction. One difference by design: the update
writes params, mu and nu in place (under `torch.no_grad`), where the
reference returns new arrays: at 1.55 B f32 parameters a functional copy
of the three would hold another 18.6 GB on the card. The old state's
tensors are the new state's; `adamw_update` returns them in a new
`TrainState` all the same. A failure while it writes raises
`PartialUpdateError`: some leaves hold the new values and some the old,
so the step must not be retried on that state (`runtime.fault`
restores the last checkpoint instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.runtime import trace
from repro_torch.tree import sorted_leaves, tree_leaves, tree_map


class PartialUpdateError(RuntimeError):
    """`adamw_update` failed after it began writing the state in place."""


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" for huge models
    warmup_steps: int = 100
    total_steps: int = 10_000


@dataclasses.dataclass
class TrainState:
    """Fields in the reference's flattening order (params, mu, nu, step);
    ``step`` is a 0-d int32 tensor on the params' device."""
    params: Any
    mu: Any
    nu: Any
    step: torch.Tensor


def adamw_init(params, cfg: AdamWConfig) -> TrainState:
    dt = torch_dtype(cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    to 0 at ``total_steps``; f32, on step's device."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _global_sq(grads, shardings, mesh) -> list[torch.Tensor]:
    """Each leaf's sum of squares over the whole (unsharded) leaf, in
    the reference's leaf order: the rank's own sums, all-reduced over
    the axes each leaf is sharded on and only those (a replicated leaf
    is counted once), one all-reduce per set of axes."""
    from repro_torch.sharding import all_reduce, axes_of
    sqs = [g.float().square().sum() for g in sorted_leaves(grads)]
    if shardings is None:
        return sqs
    groups: dict[tuple, list[int]] = {}
    for i, spec in enumerate(sorted_leaves(shardings)):
        axes = tuple(sorted({a for e in spec for a in axes_of(e)}))
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in sorted(groups.items()):
        summed = all_reduce(torch.stack([sqs[i] for i in idx]), mesh, axes)
        for j, i in enumerate(idx):
            sqs[i] = summed[j]
    return sqs


def clip_by_global_norm(grads, max_norm: float, shardings=None, mesh=None):
    """(grads scaled by min(1, max_norm / ||grads||), ||grads||): the
    norm over every leaf in f32 (summed in the reference's leaf order),
    each leaf scaled in f32 and cast back. With ``shardings`` (a tree of
    specs shaped like ``grads``) and ``mesh`` the leaves are this rank's
    shards and the norm is the whole tree's, the same on every rank."""
    gnorm = torch.sqrt(sum(_global_sq(grads, shardings, mesh)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
@trace.traced("train.optimizer")
def adamw_update(state: TrainState, grads, cfg: AdamWConfig,
                 shardings=None, mesh=None) -> tuple[TrainState, dict]:
    """One AdamW step of ``grads`` (a tree shaped like the params) in
    place; returns (the state, {"grad_norm", "lr"}) as 0-d tensors.
    With ``shardings`` (the params' specs) and ``mesh``, the params, mu,
    nu and grads are this rank's shards: the update is elementwise, and
    only the clipping norm is global. Raises `PartialUpdateError` (from
    the cause) where a leaf's update fails: the leaves before it are
    written already."""
    with trace.span("train.clip"):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, shardings,
                                           mesh)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=sf.device) ** sf
    c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=sf.device) ** sf

    def upd(p, g, m, v):
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf.square() * (1 - b2)
        delta = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
        m.copy_(mf)
        v.copy_(vf)
    try:
        tree_map(upd, state.params, grads, state.mu, state.nu)
    except Exception as e:
        raise PartialUpdateError(
            "adamw_update failed while writing the state in place") from e
    state.step = step
    return state, {"grad_norm": gnorm, "lr": lr}
