"""Step functions (train / prefill / serve) and their sharding
derivations, port of the reference's `repro/launch/steps.py`.

Where the reference runs one pjit program over the mesh, the port runs
one rank's share of it: parameters, optimizer state, KV caches and
batches are placed by the specs resolved from logical axes
(`repro_torch.sharding`; a spec is the plain tuple `ShardingRules.spec`
returns, the reference's `PartitionSpec`), and the collectives XLA would
insert are called by hand (`models.tp`, the gradient sums below).
"""

from __future__ import annotations

import math

import torch

from repro_torch import sharding as S
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.cells import batch_logical
from repro_torch.models import Model
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import AdamWConfig, TrainState, adamw_update
from repro_torch.runtime import trace
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map


def _value_and_grad(model: Model, params: dict, batch: dict,
                    batch_axes: tuple[str, ...] = ()):
    """(loss, gradient tree) of `Model.loss` at ``params``; every leaf is
    marked to require a gradient first (the int8 store's integer leaves
    make `Model.loss` raise TypeError before that)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        if not all(p.requires_grad for p in leaves if p.is_floating_point()):
            for p in leaves:
                if p.is_floating_point():
                    p.requires_grad_(True)
        with trace.span("train.forward"):
            loss = (model.loss(params, batch) if model.placement is None
                    else model.loss(params, batch, batch_axes))
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach gets zeros, as from `jax.grad`
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def local_batch(batch: dict, rules: S.ShardingRules
                ) -> tuple[dict, tuple[str, ...]]:
    """(this rank's block of a global batch, the mesh axes its rows are
    split over): every input's rows on the logical "batch" axis."""
    out, axes = {}, ()
    for k, a in batch.items():
        t = torch.as_tensor(a)
        spec = rules.spec(("batch",) + (None,) * (t.dim() - 1),
                          tuple(t.shape))
        out[k] = S.shard(t, spec, rules.mesh)
        axes = S.axes_of(spec[0])
    return out, axes


def sync_grads(grads: dict, placement, batch_axes: tuple[str, ...]
               ) -> dict:
    """Each rank's gradient shares -> the global batch's gradients, in
    place: a leaf summed over every data axis it is not sharded on (an
    FSDP leaf's gather reduce-scattered its share already) and, where its
    gradient is a partial sum over 'model'
    (`Placement.partial_over_model`), over 'model'. Where the batch is
    replicated over some data axes, their ranks computed the same share:
    the sum is divided by their number."""
    mesh = placement.mesh
    data = placement.data_axes()
    repl = (math.prod(mesh.shape[a] for a in data)
            // math.prod(mesh.shape[a] for a in batch_axes))
    specs = dict(tree_leaves_with_path(placement.pspec))
    out = []
    for path, g in tree_leaves_with_path(grads):
        bound = {a for e in specs[path] for a in S.axes_of(e)}
        axes = tuple(a for a in data if a not in bound)
        if path in placement.partial_over_model:
            axes += ("model",)
        if axes:
            g = S.all_reduce(g, mesh, axes)
        out.append(g if repl == 1 else g.div_(repl))
    it = iter(out)
    return tree_map(lambda _: next(it), grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    grad_accum_dtype: str = "float32", placement=None):
    """Gradient-accumulated train step: the batch is split along its
    first axis into ``microbatches`` sequential microbatches (bounding
    activation memory); gradients accumulate in ``grad_accum_dtype`` and
    are divided by the count, the loss is the microbatches' mean. The
    state is written only after every gradient is computed (in place:
    `adamw_update`), so a step that raises leaves it as it was.

    On a mesh (``placement``, a `models.tp.Placement`, by default the
    model's own) the state holds this rank's shards
    (`train_state_shardings`) and every rank is handed the same global
    batch: microbatch i is the reference's microbatch i (rows i*B/n ..
    (i+1)*B/n), split over the data ranks (`local_batch`), so each
    microbatch's loss is normalized by its own global mask count as in
    the reference. After the last backward the gradients are summed over
    the data ranks (`sync_grads`), then AdamW updates the local shards
    under the global clipping norm. The step computes the reference's
    unsharded step on the global batch."""
    placement = placement if placement is not None else model.placement
    if placement is not None and model.placement is not placement:
        model = Model(model.cfg, placement)

    def value_and_grad(params, batch):
        if placement is None:
            return _value_and_grad(model, params, batch), ()
        part, axes = local_batch(batch, placement.rules)
        return _value_and_grad(model, params, part, axes), axes

    def train_step(state: TrainState, batch: dict):
        if microbatches == 1:
            (loss, grads), axes = value_and_grad(state.params, batch)
        else:
            adt = torch_dtype(grad_accum_dtype)
            mbs = {k: torch.as_tensor(a).chunk(microbatches)
                   for k, a in batch.items()}
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                  device=p.device),
                            state.params)
            lsum = 0.0
            for i in range(microbatches):
                (loss_i, g), axes = value_and_grad(
                    state.params, {k: v[i] for k, v in mbs.items()})
                gacc = tree_map(lambda acc, gg: acc.add_(gg.to(acc.dtype)),
                                gacc, g)
                lsum = lsum + loss_i
            loss = lsum / microbatches
            grads = gacc
        if placement is not None:
            with torch.no_grad():
                grads = sync_grads(grads, placement, axes)
        if microbatches > 1:
            grads = tree_map(lambda g: g / microbatches, grads)
        if placement is None:
            new_state, metrics = adamw_update(state, grads, opt_cfg)
        else:
            new_state, metrics = adamw_update(state, grads, opt_cfg,
                                              placement.pspec,
                                              placement.mesh)
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


# ---------------------------------------------------------------------------
# abstract values + shardings
# ---------------------------------------------------------------------------
def abstract_train_state(model: Model, opt_cfg: AdamWConfig) -> TrainState:
    """The train state as meta tensors (shapes and dtypes, no storage)."""
    p_shapes, _ = model.abstract_params()
    sdt = torch_dtype(opt_cfg.state_dtype)
    opt = tree_map(lambda t: torch.empty(t.shape, dtype=sdt, device="meta"),
                   p_shapes)
    return TrainState(params=p_shapes, mu=opt, nu=opt,
                      step=torch.empty((), dtype=torch.int32, device="meta"))


def train_state_shardings(model: Model, rules: S.ShardingRules,
                          opt_cfg: AdamWConfig) -> TrainState:
    """mu and nu take the params' specs; the step is replicated."""
    p_shard = model.param_shardings(rules)
    return TrainState(params=p_shard, mu=p_shard, nu=p_shard,
                      step=replicated(rules))


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec,
                    rules: S.ShardingRules, specs: dict) -> dict:
    lg = batch_logical(cfg, shape)
    return {k: rules.spec(lg[k], tuple(specs[k].shape)) for k in specs}


def cache_shardings(model: Model, rules: S.ShardingRules, batch: int,
                    max_len: int) -> dict:
    return model.cache_shardings(rules, batch, max_len)


def replicated(rules: S.ShardingRules) -> S.Spec:
    """The spec of a replicated value (the reference's ``P()``)."""
    return ()
