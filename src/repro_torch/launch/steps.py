"""Step functions: train, prefill and serve (the reference's
`repro/launch/steps.py`; its sharding helpers come with multi-device
work, ROADMAP Queue 1 item 10)."""

from __future__ import annotations

import torch

from repro_torch.models import Model
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import AdamWConfig, TrainState, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def _value_and_grad(model: Model, params: dict, batch: dict):
    """(loss, gradient tree) of `Model.loss` at ``params``; every leaf is
    marked to require a gradient first (the int8 store's integer leaves
    make `Model.loss` raise TypeError before that)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        if not all(p.requires_grad for p in leaves if p.is_floating_point()):
            for p in leaves:
                if p.is_floating_point():
                    p.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach gets zeros, as from `jax.grad`
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    grad_accum_dtype: str = "float32"):
    """Gradient-accumulated train step: the batch is split along its
    first axis into ``microbatches`` sequential microbatches (bounding
    activation memory); gradients accumulate in ``grad_accum_dtype`` and
    are divided by the count, the loss is the microbatches' mean. The
    state is written only after every gradient is computed (in place:
    `adamw_update`), so a step that raises leaves it as it was."""

    def train_step(state: TrainState, batch: dict):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, state.params, batch)
        else:
            adt = torch_dtype(grad_accum_dtype)
            mbs = {k: torch.as_tensor(a).chunk(microbatches)
                   for k, a in batch.items()}
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                  device=p.device),
                            state.params)
            lsum = 0.0
            for i in range(microbatches):
                loss_i, g = _value_and_grad(
                    model, state.params, {k: v[i] for k, v in mbs.items()})
                gacc = tree_map(lambda acc, gg: acc.add_(gg.to(acc.dtype)),
                                gacc, g)
                lsum = lsum + loss_i
            loss = lsum / microbatches
            grads = tree_map(lambda g: g / microbatches, gacc)
        new_state, metrics = adamw_update(state, grads, opt_cfg)
        metrics["loss"] = loss
        return new_state, metrics
    return train_step


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, tokens, cache, pos):
        return model.decode_step(params, tokens, cache, pos)
    return serve_step
