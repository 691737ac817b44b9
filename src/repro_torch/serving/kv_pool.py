"""Slot-indexed multi-request KV pool state over the CHIME tiered stores.

The pool is the model's decode cache (`Model.init_cache`) with the batch
axis read as *serving slots*: slot s holds the tiered store of whichever
request occupies it. Admission overwrites the slot with a freshly
prefilled cache — including its endurance counters, which keeps the
writes<=1-per-cold-slot discipline across slot recycling.

Port of the reference's `serving/kv_pool.py`: `KVPoolState` is a plain
dataclass (no pytree registration; the cache tree plus a matching tree
of slot-axis indices), `TieredKVPool` is host-side slot bookkeeping, and
the byte math shares `models.counting.kv_elems_per_token` with the rest
of the stack. The RRAM spill lanes live beside the cache in the state;
the paged prefix store is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kv_tiers as KT
from repro_torch.models.counting import (kv_elems_per_token,
                                         kv_scale_elems_per_token)
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map


@dataclasses.dataclass
class KVPoolState:
    """``cache``: the slot-batched cache tree. ``axes``: a matching tree
    of ints, each leaf's slot-axis index (1 for stacked units, whose
    leading axis is the layer repeat).

    ``spill``: the RRAM spill store (preemption victims and idle
    offloads), a tree like ``cache`` whose slot axis holds *spill
    lanes*, or None until the first eviction materializes it (a pool
    that never spills never pays for the copy) or when the backend has
    no lanes. Compressed lanes store the hot ring in int8 codec form, so
    their tree differs from the cache's: ``spill_axes`` then carries its
    own axis tree (None: the lanes mirror ``cache`` and ``axes``
    addresses both). ``spill_writes``: (n_lanes, n_endurance_blocks)
    int32 cumulative RRAM write counters per lane, never reset.
    """

    cache: dict
    axes: dict
    spill: dict | None = None
    spill_writes: torch.Tensor | None = None
    spill_axes: dict | None = None

    @property
    def num_slots(self) -> int:
        return tree_leaves(self.cache)[0].shape[tree_leaves(self.axes)[0]]

    @property
    def num_spill_lanes(self) -> int:
        if self.spill is None:
            return 0
        axes = self.axes if self.spill_axes is None else self.spill_axes
        return tree_leaves(self.spill)[0].shape[tree_leaves(axes)[0]]


def batch_axes(model, cache: dict) -> dict:
    """Tree matching ``cache`` whose leaves give the slot-axis index."""
    return {f"u{ui}": tree_map(lambda _, a=int(unit.repeats > 1): a,
                               cache[f"u{ui}"])
            for ui, unit in enumerate(model.plan)}


def slot_insert(pool: dict, req: dict, axes: dict, slot: int) -> dict:
    """Functional scatter of a batch-1 cache into slot ``slot``."""
    def leaf(p, r, a):
        out = p.clone()
        out.narrow(a, slot, 1).copy_(r.to(p.dtype))
        return out
    return tree_map(leaf, pool, req, axes)


def slot_select(new: dict, old: dict, axes: dict,
                active: torch.Tensor) -> dict:
    """Leafwise ``new`` where the slot is active, else ``old``."""
    def leaf(n, o, a):
        shape = [1] * n.dim()
        shape[a] = n.shape[a]
        return torch.where(active.view(shape), n, o)
    return tree_map(leaf, new, old, axes)


def map_spill_stores(tree, fn):
    """Rebuild a cache/spill tree with every TIERED store dict (one
    carrying a hot ring: 'hot', or its compressed 'hot_q' form) passed
    through ``fn``; flat stores are left in place. The structural
    transform between a slot image and its compressed lane form, and
    between their axis trees (with `kv_tiers.spill_store_meta`)."""
    if isinstance(tree, dict):
        if "hot" in tree or "hot_q" in tree:
            return fn(tree)
        return {k: map_spill_stores(v, fn) for k, v in tree.items()}
    return tree


# keys of the sequence-store leaves inside a block cache; anything else
# would be per-slot fixed-size DRAM state
_STORE_KEYS = frozenset({"hot", "cold_q", "cold_scale", "writes", "flat"})


def _charged_len(max_len: int, length: int | None,
                 block_tokens: int | None) -> int:
    """Sequence positions one occupant is charged for: ``max_len`` by
    default, or its own span rounded up to whole ``block_tokens`` pages
    and clamped to ``max_len``."""
    if length is None:
        return max_len
    bt = block_tokens or KT.ENDURANCE_BLOCK
    length = max(1, min(int(length), max_len))
    return min(-(-length // bt) * bt, max_len)


def slot_kv_bytes(model, max_len: int, *, length: int | None = None,
                  block_tokens: int | None = None) -> tuple[int, int]:
    """(dram_hot_bytes, rram_cold_bytes) of ONE slot's cache: the hot
    ring and flat stores are DRAM, the int8 cold tier and its scales are
    the RRAM budget; endurance counters are bookkeeping."""
    cfg = model.cfg
    cd = model.compute_dtype.itemsize
    seq_elems = kv_elems_per_token(cfg)
    L = _charged_len(max_len, length, block_tokens)
    state_bytes = 0
    for path, leaf in tree_leaves_with_path(model.cache_spec(1, max_len)):
        if path[-1] in _STORE_KEYS:
            continue
        state_bytes += leaf.numel() * leaf.element_size()
    if cfg.kv_policy == "tiered":
        W = min(cfg.kv_hot_window, L)
        hot = seq_elems * W * cd + state_bytes
        cold = (seq_elems * L * torch.int8.itemsize
                + kv_scale_elems_per_token(cfg) * L
                * torch.float32.itemsize)
    else:
        hot = seq_elems * L * cd + state_bytes
        cold = 0
    return int(hot), int(cold)


def spill_lane_bytes(model, max_len: int, compressed: bool = False, *,
                     length: int | None = None,
                     block_tokens: int | None = None) -> int:
    """RRAM bytes ONE occupied spill lane pins while a request is parked.

    A verbatim lane holds the full slot image (hot and cold halves of
    `slot_kv_bytes`). A compressed lane stores the hot ring as int8 plus
    per-(token, head) f32 scales while the cold tier rides verbatim; a
    flat cache has no hot ring, so compression changes nothing there.
    ``length``/``block_tokens`` apply the live block-granular charge of
    `slot_kv_bytes`."""
    hot, cold = slot_kv_bytes(model, max_len, length=length,
                              block_tokens=block_tokens)
    cfg = model.cfg
    if not compressed or cfg.kv_policy != "tiered":
        return hot + cold
    cd = model.compute_dtype.itemsize
    W = min(cfg.kv_hot_window,
            _charged_len(max_len, length, block_tokens))
    ring = kv_elems_per_token(cfg) * W * cd
    ring_q = kv_elems_per_token(cfg) * W          # int8 payload
    ring_scale = kv_scale_elems_per_token(cfg) * W \
        * torch.float32.itemsize
    return hot - ring + ring_q + ring_scale + cold


class TieredKVPool:
    """Host-side slot bookkeeping over an explicit `KVPoolState`; the
    cache arithmetic (insert / decode) belongs to the backend."""

    def __init__(self, state: KVPoolState, insert_fn, fresh_slot_fn,
                 num_spill_lanes: int = 0):
        self.state = state
        self._insert_fn = insert_fn        # (state, req_cache, slot) -> state
        self._fresh_slot = fresh_slot_fn   # () -> batch-1 zero cache
        self.num_slots = state.num_slots
        self._free = list(range(self.num_slots))
        self.num_spill_lanes = num_spill_lanes
        self._free_lanes = list(range(self.num_spill_lanes))

    # ---- views -------------------------------------------------------
    @property
    def cache(self) -> dict:
        return self.state.cache

    @property
    def axes(self) -> dict:
        return self.state.axes

    # ---- slot bookkeeping (host side) --------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.num_slots - len(self._free)

    def alloc(self) -> int:
        return self._free.pop(0)

    def free(self, slot: int):
        assert 0 <= slot < self.num_slots and slot not in self._free
        self._free.append(slot)
        self._free.sort()

    # ---- spill-lane bookkeeping (host side) --------------------------
    @property
    def free_lanes(self) -> int:
        return len(self._free_lanes)

    def alloc_lane(self) -> int:
        return self._free_lanes.pop(0)

    def release_lane(self, lane: int):
        assert 0 <= lane < self.num_spill_lanes \
            and lane not in self._free_lanes
        self._free_lanes.append(lane)
        self._free_lanes.sort()

    # ---- cache ops ---------------------------------------------------
    def insert(self, req_cache: dict, slot):
        """Overwrite slot ``slot`` with a batch-1 cache (this is also the
        endurance-counter reset on recycling)."""
        self.state = self._insert_fn(self.state, req_cache, slot)

    def reset(self, slot):
        self.insert(self._fresh_slot(), slot)

    # ---- endurance audit ---------------------------------------------
    def worst_case_writes(self) -> torch.Tensor | None:
        """Elementwise max of every tiered store's per-slot endurance
        counters -> (num_slots, n_blocks), or None if nothing is tiered."""
        worst = None
        for path, w in tree_leaves_with_path(self.state.cache):
            if path[-1] != "writes":
                continue
            if w.dim() == 3:              # (repeats, slots, blocks)
                w = w.amax(dim=0)
            worst = w if worst is None else torch.maximum(worst, w)
        return None if worst is None else worst.cpu()

    def endurance_report(self, prefill_lens, total_lens,
                         hot_window: int) -> dict:
        """Audit writes<=1-per-cold-slot for the current occupants, given
        the prompt and total lengths of each slot's last occupant. The
        spill lanes' cumulative counters are reported beside it; their
        keys are present (as zeros) before the lanes materialize."""
        worst = self.worst_case_writes()
        if worst is None:
            rep = {"tiered": False, "write_once_ok": True,
                   "max_writes_per_cold_slot": 0.0}
        else:
            nb = worst.shape[1]
            expected = torch.stack([
                KT.expected_block_writes(nb, hot_window, int(p), int(t))
                for p, t in zip(prefill_lens, total_lens)])
            excess = worst - expected
            ratio = worst / expected.clamp_min(1)
            ratio = torch.where((expected == 0) & (worst > 0),
                                torch.tensor(float("inf")), ratio)
            rep = {
                "tiered": True,
                "write_once_ok": bool((excess <= 0).all()),
                "max_writes_per_cold_slot": float(ratio.max()),
                "total_cold_writes": int(worst.sum()),
            }
        sw = self.state.spill_writes
        rep["spill_lanes"] = self.num_spill_lanes
        rep["total_spill_writes"] = 0 if sw is None else int(sw.sum())
        rep["max_spill_writes_per_block"] = \
            0 if sw is None else int(sw.max())
        rep["total_rram_writes"] = rep.get("total_cold_writes", 0) \
            + rep["total_spill_writes"]
        return rep
