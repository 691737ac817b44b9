"""Backend-executor seam: `InferenceBackend` is what the serving engine
drives, and `LocalBackend` executes it on one device.

Port of the `LocalBackend` half of the reference's `serving/backend.py`.
The backend owns the parameters, the KV pool layout (`KVPoolState`) and
the two step programs:

  * `extend_step` — one prefill chunk of an in-flight request over its
    chunk-resumable workspace; the final (``commit``) chunk folds the
    workspace into the stores, scatters them into the request's pool slot
    and returns its first greedy token;
  * `decode_step` — one greedy token on every slot in ONE batched model
    call with the (num_slots,) position vector, so the paged-decode
    kernel sees each slot's real length and block table. Inactive slots
    keep their cache verbatim (no phantom appends, no endurance drift).

Everything runs on ``device`` (default "cuda"; raises without a card —
pass device="cpu" to run on the CPU). Preemption spill lanes, the paged
prefix store, weight streaming and the sharded executor are not ported
yet: their entry points raise NotImplementedError naming the ROADMAP
item, and the engine reaches them only under priority traffic,
oversubscription or paging.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import kv_tiers as KT
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.models.counting import weight_stream_split
from repro_torch.serving.kv_pool import (KVPoolState, TieredKVPool,
                                         batch_axes, slot_insert,
                                         slot_kv_bytes, slot_select,
                                         spill_lane_bytes)
from repro_torch.tree import tree_map

_SPILL = "ROADMAP Queue 1 item 6 (preemption and spill lanes)"


def _resolve_fused_decode(flag: bool | None) -> bool:
    """Resolve the fused paged-decode knob: an explicit bool wins; None
    consults ``REPRO_SERVE_FUSED_DECODE`` (unset/empty/"0" = off)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_SERVE_FUSED_DECODE",
                          "").strip() not in ("", "0")


def _resolve_sparse_read(tau: float | None) -> float:
    """Resolve the SLIM sparse-read threshold: an explicit float wins;
    None consults ``REPRO_SERVE_SPARSE_READ``. Unparsable or negative
    values resolve to 0.0 (off): an env var must never wedge startup."""
    if tau is not None:
        return max(float(tau), 0.0)
    raw = os.environ.get("REPRO_SERVE_SPARSE_READ", "").strip()
    if not raw:
        return 0.0
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return 0.0
_PREFIX = "ROADMAP Queue 1 item 6 (paged prefix pool)"


@runtime_checkable
class InferenceBackend(Protocol):
    """What the engine needs from an executor (see the reference's
    protocol for the full contract)."""

    num_slots: int
    max_len: int
    hot_window: int
    requires_exact_prefill: bool
    chunk_unit: int
    n_spill: int
    fused_decode: bool        # fused paged-decode attention (resolved)
    sparse_read_tau: float    # SLIM page skip inside it (0.0 = exact)

    def weight_bytes(self) -> tuple[int, int]: ...

    def slot_kv_bytes(self, *, length: int | None = None
                      ) -> tuple[int, int]: ...

    def spill_lane_bytes(self) -> int: ...

    def sim_context(self) -> tuple: ...

    def make_pool(self) -> TieredKVPool: ...

    def fresh_extend(self) -> dict: ...

    def extend_step(self, batch: dict, state: KVPoolState, ext: dict,
                    slot, pos, length, commit: bool): ...

    def decode_step(self, toks, state: KVPoolState, pos, active): ...


class LocalBackend:
    """Single-device executor: every slot decodes in one batched call."""

    def __init__(self, model: Model, params: dict, num_slots: int,
                 max_len: int, *, device=None,
                 fused_decode: bool | None = None,
                 sparse_read: float | None = None):
        cfg = model.cfg
        if num_slots < 1:
            raise ValueError("backend needs at least one decode slot")
        if cfg.weight_stream_layers:
            raise NotImplementedError(
                "weight streaming: ROADMAP Queue 1 item 6")
        # fused paged decode (and the sparse read inside it): explicit arg
        # > cfg flag > env var, GQA-only, and the resolved values are
        # written back into the config the model runs with, as the
        # reference's backend does
        has_gqa = any(u.block.mixer in ("attn", "attn_shared")
                      for u in model.plan)
        if fused_decode is None and getattr(cfg, "fused_decode", False):
            fused_decode = True
        if sparse_read is None and getattr(cfg, "sparse_read_tau", 0.0):
            sparse_read = cfg.sparse_read_tau
        self.fused_decode = _resolve_fused_decode(fused_decode) and has_gqa
        self.sparse_read_tau = (_resolve_sparse_read(sparse_read)
                                if self.fused_decode else 0.0)
        if (self.fused_decode != bool(getattr(cfg, "fused_decode", False))
                or self.sparse_read_tau
                != float(getattr(cfg, "sparse_read_tau", 0.0))):
            cfg = cfg.replace(fused_decode=self.fused_decode,
                              sparse_read_tau=self.sparse_read_tau)
            model = Model(cfg)
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.num_slots = num_slots
        self.max_len = max_len
        # spill lanes the scheduler may plan with, as the reference's
        # default; evict_slot/restore_slot raise until spill is ported
        self.n_spill = num_slots
        self.hot_window = min(cfg.kv_hot_window, max_len)
        self.requires_exact_prefill = False   # attention-only plans
        self.chunk_unit = 1
        # prefix-store geometry the engine's paging path reads before it
        # reaches ensure_prefix (which raises until paging is ported)
        self.block_tokens = min(KT.ENDURANCE_BLOCK, max_len)
        self.prefix_blocks = num_slots * (-(-max_len // self.block_tokens))
        self._axes = batch_axes(model, model.cache_spec(num_slots, max_len))
        self._zero_slot = None
        self._zero_ext = None

    # ---- accounting --------------------------------------------------
    def slot_kv_bytes(self, *, length: int | None = None
                      ) -> tuple[int, int]:
        return slot_kv_bytes(self.model, self.max_len, length=length,
                             block_tokens=self.block_tokens)

    def spill_lane_bytes(self) -> int:
        return spill_lane_bytes(self.model, self.max_len)

    def weight_bytes(self) -> tuple[int, int]:
        return weight_stream_split(self.model.cfg)

    def sim_context(self) -> tuple:
        """(config, spill lanes compressed) for a telemetry ledger."""
        return self.model.cfg, False

    # ---- pool --------------------------------------------------------
    def init_pool(self) -> KVPoolState:
        cache = self.model.init_cache(self.num_slots, self.max_len,
                                      self.device)
        return KVPoolState(cache=cache, axes=self._axes)

    def fresh_slot(self) -> dict:
        """Batch-1 zero cache (explicit slot scrub); built once, reused."""
        if self._zero_slot is None:
            self._zero_slot = self.model.init_cache(1, self.max_len,
                                                    self.device)
        return self._zero_slot

    def fresh_extend(self) -> dict:
        """Zero extend state for one in-flight prefill; built once and
        shared — `Model.extend` never writes into its input."""
        if self._zero_ext is None:
            self._zero_ext = self.model.init_extend_cache(1, self.max_len,
                                                          self.device)
        return self._zero_ext

    def make_pool(self) -> TieredKVPool:
        return TieredKVPool(self.init_pool(), self._insert_state,
                            self.fresh_slot, num_spill_lanes=self.n_spill)

    def _insert_state(self, state: KVPoolState, req_cache: dict, slot
                      ) -> KVPoolState:
        return dataclasses.replace(
            state, cache=slot_insert(state.cache, req_cache, state.axes,
                                     int(slot)))

    # ---- step programs -----------------------------------------------
    def extend_step(self, batch: dict, state: KVPoolState, ext: dict,
                    slot, pos, length, commit: bool):
        pos, length = int(pos), int(length)
        if not commit:
            _, new_ext = self.model.extend(self.params, batch, ext, pos,
                                           length)
            return None, new_ext, state
        logits, committed = self.model.extend(self.params, batch, ext, pos,
                                              length, commit=True)
        tok = int(logits[0, -1].argmax(-1))
        cache = slot_insert(state.cache, committed, state.axes, int(slot))
        return tok, None, dataclasses.replace(state, cache=cache)

    def decode_step(self, toks, state: KVPoolState, pos, active
                    ) -> tuple[np.ndarray, KVPoolState]:
        """One greedy token per slot: ``toks`` (num_slots, 1), ``pos`` and
        ``active`` (num_slots,). Returns host tokens and the new state."""
        dev = self.device
        toks = torch.as_tensor(np.asarray(toks), device=dev).long()
        pos = torch.as_tensor(np.asarray(pos), device=dev).long()
        active = torch.as_tensor(np.asarray(active), device=dev).bool()
        logits, new = self.model.decode_step(self.params, toks, state.cache,
                                             pos)
        ntoks = logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
        cache = slot_select(new, state.cache, state.axes, active)
        return ntoks, dataclasses.replace(state, cache=cache)

    # ---- not on this slice -------------------------------------------
    def evict_slot(self, state, slot, lane, length):
        raise NotImplementedError(f"evict_slot: {_SPILL}")

    def restore_slot(self, state, lane, slot):
        raise NotImplementedError(f"restore_slot: {_SPILL}")

    def ensure_prefix(self, state):
        raise NotImplementedError(f"ensure_prefix: {_PREFIX}")

    def prefix_block_bytes(self) -> int:
        raise NotImplementedError(f"prefix_block_bytes: {_PREFIX}")

    def prefix_save_ws(self, state, ext, bid, pos):
        raise NotImplementedError(f"prefix_save_ws: {_PREFIX}")

    def prefix_load_ws(self, state, ext, bid, pos):
        raise NotImplementedError(f"prefix_load_ws: {_PREFIX}")

    def prefix_save_state(self, state, ext, bid):
        raise NotImplementedError(f"prefix_save_state: {_PREFIX}")

    def prefix_load_state(self, state, ext, bid):
        raise NotImplementedError(f"prefix_load_state: {_PREFIX}")


def make_backend(kind: str, model: Model, params, *, num_slots: int,
                 max_len: int, device=None, fused_decode: bool | None = None,
                 sparse_read: float | None = None) -> InferenceBackend:
    """CLI-facing factory; only ``kind='local'`` is ported."""
    if kind == "local":
        return LocalBackend(model, params, num_slots, max_len, device=device,
                            fused_decode=fused_decode,
                            sparse_read=sparse_read)
    if kind == "sharded":
        raise NotImplementedError(
            "ShardedBackend: ROADMAP Queue 1 item 10 (multi-device)")
    raise ValueError(f"unknown backend kind {kind!r}")
