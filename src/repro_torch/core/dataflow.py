"""Two-cut-point dataflow audit, port of the reference's `core/dataflow.py`.

CHIME's rule: per transformer layer, exactly two activation tensors cross
the memory-domain boundary (AttnOut, FFNOut). On a mesh the domain
boundary is the tensor-parallel collective boundary: the attention block
ends with one partial-sum all-reduce (after the out-projection) and the
FFN block with one (after the down-projection); no collective fires
inside a fused region.

Where the reference lowers one layer and counts the collective ops in
its HLO, the port counts the collectives a run really issues: every one
goes through a counted wrapper of `repro_torch.sharding`, and
`count_collectives` reads that counter by the reference's kind names
("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
"collective-permute"; the port's own "broadcast" beside them).
`audit_layer_collectives` runs one `Model.forward` of the one-unit
variant of a config on a live mesh (every rank calls it) and returns the
counts; `audit_decode_collectives` does the same for one batched decode
step over a sharded pool, per scope (the layers, "embed", "head").
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import sharding as S
from repro_torch.bridge import shard_params
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.tree import tree_map

def count_collectives(scope_prefix: str | None = None) -> dict[str, int]:
    """Collectives issued since the last `sharding.reset_counts`, by kind
    (those with a nonzero count), over every scope or those whose name
    starts with ``scope_prefix``."""
    return {k: n for k, n in S.counts_by_kind(scope_prefix).items() if n}


def one_unit(cfg: ModelConfig) -> ModelConfig:
    """The config cut to its first segment's pattern, once."""
    seg = cfg.segments[0]
    return cfg.replace(num_layers=len(seg.pattern),
                       segments=(seg.__class__(seg.pattern, 1),),
                       remat="none")


def _placed(cfg: ModelConfig, mesh) -> tuple[Model, dict]:
    """The one-unit model placed on ``mesh`` and this rank's shards of
    its seed-0 weights (every rank draws the same full tree)."""
    model = Model(one_unit(cfg))
    dev = mesh.device or torch.device("cpu")
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    placed = model.place(mesh)
    return placed, shard_params(params, placed.placement.pspec, mesh)


def _batch(cfg: ModelConfig, batch: int, seq: int, dev) -> dict:
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        return {"frames": torch.as_tensor(rng.standard_normal(
            (batch, seq, cfg.frontend.frontend_dim)), dtype=torch.float32,
            device=dev)}
    if cfg.frontend is not None:
        tv = cfg.frontend.num_tokens
        return {"tokens": torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, (batch, seq - tv)), device=dev),
                "patches": torch.as_tensor(rng.standard_normal(
                    (batch, tv, cfg.frontend.frontend_dim)),
                    dtype=torch.float32, device=dev)}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (batch, seq)),
                                      device=dev)}


def audit_layer_collectives(cfg: ModelConfig, mesh, batch: int = 4,
                            seq: int = 32) -> dict[str, int]:
    """The collectives one full forward of the one-unit variant of
    ``cfg`` issues on ``mesh`` (the counterpart of the reference's
    `lower_single_layer_hlo` + `count_collectives`)."""
    model, params = _placed(cfg, mesh)
    data = _batch(model.cfg, batch, seq, mesh.device)
    S.reset_counts()
    model.forward(params, data)
    return count_collectives()


def audit_decode_collectives(cfg: ModelConfig, mesh, slots: int = 4,
                             max_len: int = 64) -> dict[str, dict]:
    """The collectives one batched decode step of the one-unit variant
    issues over a sharded ``slots``-slot pool, greedy token included, by
    scope ("layers": the unit's blocks, "embed", "head"). The rank
    decodes its own slots, as the sharded serving backend does."""
    model, params = _placed(cfg, mesh)
    base = Model(model.cfg)
    specs = base.cache_shardings(model.placement.rules, slots, max_len)
    dev = mesh.device
    entry = model.placement.rules.spec(("batch",), (slots,))[0]
    _, n = S.block_of(entry, mesh)
    full = base.init_cache(slots // n, max_len, dev)
    cache = {u: _take(full[u], specs[u], mesh, unit.repeats > 1)
             for u, unit in zip(full, base.plan)}
    toks = torch.zeros((slots // n, 1), dtype=torch.long, device=dev)
    pos = torch.full((slots // n,), 5, dtype=torch.long, device=dev)
    S.reset_counts()
    logits, _ = model.decode_step(params, toks, cache, pos, specs=specs)
    model.placement.greedy(logits[:, -1])
    return {sc: count_collectives(p) for sc, p in (("layers", "u"),
                                                   ("embed", "embed"),
                                                   ("head", "head"))}


def _take(tree, specs, mesh, stacked: bool):
    return tree_map(lambda t, s: S.shard(
        t, s, mesh, skip=(int(stacked),)).contiguous(), tree, specs)
