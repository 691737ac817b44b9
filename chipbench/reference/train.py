"""The plain training step: the decoder's loss (`decoder.loss`) by
autograd in float32, the gradients clipped by their global norm, and
AdamW (Loshchilov and Hutter) with decoupled weight decay on every leaf,
bias-corrected moments, a linear warm-up and a cosine decay:

    g <- g min(1, clip / |g|)
    m <- b1 m + (1 - b1) g;   v <- b2 v + (1 - b2) g^2
    p <- p - lr_t ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
    lr_t = lr t / warmup while t < warmup, else
           lr (1 + cos(pi min(1, (t - warmup) / (total - warmup)))) / 2
"""

from __future__ import annotations

import math

import torch

from chipbench.reference import decoder
from chipbench.weights import flatten


def lr_at(opt: dict, t: int) -> float:
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if t < warm:
        return lr * t / max(warm, 1)
    prog = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * prog))


def steps(params: dict, config: dict, batches: list, opt: dict, initial,
          arith: str = "float32") -> dict:
    """Run one step a batch from ``params`` (the tree, float32; trained
    in place). Returns {"losses", "grad_norms": each leaf's norm of the
    first step's clipped gradient, "change_norms": each leaf's norm of
    its change over all the steps}, leaves named "a/b/c". ``initial()``
    yields (name, initial leaf) to measure the change against."""
    flat = flatten(params)
    names = list(flat)
    leaves = [flat[n].requires_grad_(True) for n in names]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches, start=1):
        loss = decoder.loss(params, config, batch, arith)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9),
                                max=1.0)
            grads = [g * scale for g in grads]
            if t == 1:
                grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
            lr = lr_at(opt, t)
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            for p, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * ((mi / c1) / (torch.sqrt(vi / c2) + eps)
                             + wd * p))
        del grads
    with torch.no_grad():
        change = {n: float((flat[n] - p0.float()).norm())
                  for n, p0 in initial()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
