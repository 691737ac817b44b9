"""Backend-executor seam: `InferenceBackend` is what the serving engine
drives; `LocalBackend` executes it on one device and `ShardedBackend` on
a mesh of ranks.

Port of the reference's `serving/backend.py`.
The backend owns the parameters, the KV pool layout (`KVPoolState`) and
the two step programs:

  * `extend_step` — one prefill chunk of an in-flight request over its
    chunk-resumable workspace; the final (``commit``) chunk folds the
    workspace into the stores, scatters them into the request's pool slot
    and returns its first greedy token;
  * `decode_step` — one greedy token on every slot in ONE batched model
    call with the (num_slots,) position vector, so the paged-decode
    kernel sees each slot's real length and block table. Inactive slots
    keep their cache verbatim (no phantom appends, no endurance drift,
    no recurrent state advanced: the one call advances every row).

Preemption and idle offload park a slot in an RRAM spill lane
(`evict_slot`) and bring it back into any free slot (`restore_slot`):
plain strided copies per cache leaf on its slot axis, verbatim (restore
bit-exact) or, under ``spill_compress``, with the hot ring in the int8
spill codec. Unlike the reference's functional programs, both write in
place — evict into the lane store, restore into the pool — so a spill
moves the lane's bytes once instead of copying the whole pool; the
engine always replaces its state with the one returned.

The paged prefix block store is a lazy tree of ``prefix_blocks`` x
``block_tokens`` full-precision workspace K/V rows (`ensure_prefix`):
`prefix_save_ws` writes one block's rows from a complete workspace into
the store, in place (the store belongs to the pool state), and
`prefix_load_ws` seeds them into an in-flight workspace and returns a
NEW tree — the engine hands it the shared zero tree of `fresh_extend`,
which must stay zero. Which block holds which prefix is host-side state
in `serving.block_pool.BlockPool`.

Weight streaming (``weight_stream``, W) resolves like the reference's
knob and is written into the config the model runs with. It is
accounting only: the RRAM tier is simulated, every unit runs the same
loop over weights that stay on the device, and `weight_bytes` reports
the DRAM / RRAM split (`Model.streamed_units` names the streamed units)
that the scheduler charges and chime_sim prices.

Everything runs on ``device`` (default "cuda"; raises without a card —
pass device="cpu" to run on the CPU). `ShardedBackend`
(`make_backend("sharded", ..., mesh=)`) runs the same engine on every
rank of a `launch.mesh` mesh: the parameters and every cache tree at the
rank's shards of their resolved specs, the model tensor parallel over
'model' (`models.tp`), the slots over 'data'; a 1 x 1 mesh gives
`LocalBackend`'s tokens.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import sharding as S
from repro_torch.core import kv_tiers as KT
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.models.counting import (streamed_unit_indices,
                                         weight_stream_split)
from repro_torch.models.model import SSM_MIXERS
from repro_torch.runtime import trace
from repro_torch.serving.kv_pool import (KVPoolState, TieredKVPool,
                                         batch_axes, map_spill_stores,
                                         slot_insert, slot_kv_bytes,
                                         slot_select, spill_lane_bytes)
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map


def _resolve_spill_compress(flag: bool | None) -> bool:
    """Resolve the compressed-spill-lane knob: an explicit bool wins;
    None consults ``REPRO_SERVE_SPILL_COMPRESS`` (unset/empty/"0" = off,
    anything else = on)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_SERVE_SPILL_COMPRESS",
                          "").strip() not in ("", "0")


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


def _resolve_weight_stream(layers: int | None) -> int:
    """Resolve the RRAM weight-streaming window (W = DRAM window repeats
    per streamed unit; 0 = off): an explicit value wins; None consults
    ``REPRO_SERVE_WEIGHT_STREAM``. Unparsable or negative values resolve
    to 0: an env var must never wedge startup."""
    if layers is not None:
        return max(int(layers), 0)
    raw = os.environ.get("REPRO_SERVE_WEIGHT_STREAM", "").strip()
    if not raw:
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


@runtime_checkable
class InferenceBackend(Protocol):
    """What the engine needs from an executor (see the reference's
    protocol for the full contract)."""

    num_slots: int
    max_len: int
    hot_window: int
    requires_exact_prefill: bool
    chunk_unit: int
    n_spill: int              # RRAM spill lanes (0 = no preemption)
    spill_compress: bool      # int8 hot ring in the lanes (resolved)
    block_tokens: int         # prefix-page granularity (tokens a block)
    prefix_blocks: int        # physical blocks in the prefix store
    fused_decode: bool        # fused paged-decode attention (resolved)
    sparse_read_tau: float    # SLIM page skip inside it (0.0 = exact)
    weight_stream: int        # RRAM weight-streaming window W (0 = off;
    #   0 too when nothing would stream)

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

    def evict_slot(self, state: KVPoolState, slot, lane, length
                   ) -> KVPoolState: ...

    def restore_slot(self, state: KVPoolState, lane, slot
                     ) -> KVPoolState: ...

    def ensure_prefix(self, state: KVPoolState) -> KVPoolState: ...

    def prefix_block_bytes(self) -> int: ...

    def prefix_save_ws(self, state: KVPoolState, ext: dict, bid, pos
                       ) -> KVPoolState: ...

    def prefix_load_ws(self, state: KVPoolState, ext: dict, bid, pos
                       ) -> dict: ...


class LocalBackend:
    """Single-device executor: every slot decodes in one batched call."""

    @trace.traced("setup.backend")
    def __init__(self, model: Model, params: dict, num_slots: int,
                 max_len: int, *, device=None,
                 n_spill: int | None = None,
                 spill_compress: bool | None = None,
                 prefix_blocks: int | None = None,
                 block_tokens: int | None = None,
                 fused_decode: bool | None = None,
                 sparse_read: float | None = None,
                 weight_stream: int | None = None):
        cfg = model.cfg
        if cfg.is_encoder:
            raise ValueError("encoder-only model cannot be served")
        if num_slots < 1:
            raise ValueError("backend needs at least one decode slot")
        if n_spill is None:
            n_spill = num_slots      # preemption available out of the box
        if n_spill < 0:
            raise ValueError("backend needs n_spill >= 0")
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
        # weight streaming: the same precedence, and the window resolves
        # to 0 when no unit would stream, so the scheduler's weight charge
        # and chime_sim never price a transfer the model does not make
        if weight_stream is None and cfg.weight_stream_layers:
            weight_stream = cfg.weight_stream_layers
        W = _resolve_weight_stream(weight_stream)
        if W and not streamed_unit_indices(
                cfg.replace(weight_stream_layers=W)):
            W = 0
        self.weight_stream = W
        if W != cfg.weight_stream_layers:
            cfg = cfg.replace(weight_stream_layers=W)
            model = Model(cfg)
        self.device = self._resolve_device(device)
        self.model = model
        self.params = self._place_params(params)
        self.num_slots = num_slots
        self.max_len = max_len
        self.n_spill = n_spill
        self.hot_window = min(cfg.kv_hot_window, max_len)
        # a recurrent (RWKV6 / Mamba2) state is cumulative over every row
        # it is given, so those plans prefill exact lengths, and their
        # non-final chunks land on the canonical cfg.ssm.chunk_size grid
        # (chunked prefill then runs whole prefill's op sequence)
        self.requires_exact_prefill = any(
            u.block.mixer in SSM_MIXERS for u in model.plan)
        self.chunk_unit = (cfg.ssm.chunk_size
                           if self.requires_exact_prefill and cfg.ssm
                           else 1)
        # prefix-store geometry: a page is an RRAM endurance block,
        # rounded to the chunk grid on recurrent plans (a state snapshot
        # off the grid could never seed a bit-identical resume) and
        # clamped to the slot length; the store holds enough blocks to
        # re-page every slot; its tensors are built on first use
        bt = (block_tokens if block_tokens is not None
              else min(KT.ENDURANCE_BLOCK, max_len))
        if bt < 1:
            raise ValueError(f"block_tokens must be >= 1, got {bt}")
        if self.chunk_unit > 1:
            bt = max((bt // self.chunk_unit) * self.chunk_unit,
                     self.chunk_unit)
        self.block_tokens = min(bt, max_len)
        if prefix_blocks is None:
            prefix_blocks = num_slots * (-(-max_len // self.block_tokens))
        if prefix_blocks < 1:
            raise ValueError(f"prefix_blocks must be >= 1, got "
                             f"{prefix_blocks}")
        self.prefix_blocks = prefix_blocks
        self._axes = batch_axes(model,
                                model.cache_spec(num_slots, max_len)[0])
        ext_spec = model.extend_spec(1, max_len)[0]
        self._ext_axes = batch_axes(model, ext_spec)
        # workspace leaves (`*_ws`) hold per-position K/V rows (a hybrid's
        # attention units have them, a pure RWKV6 plan none); any other
        # extend leaf is a recurrent state
        self.has_prefix_ws = any(_is_ws(p[-1]) for p, _ in
                                 tree_leaves_with_path(ext_spec))
        # compressed lanes restructure the tiered stores (hot ->
        # hot_q/hot_scale), so the lane tree has its own axis tree; a
        # flat cache has no hot ring, so the flag resolves to off there
        self.spill_compress = _resolve_spill_compress(spill_compress) \
            and cfg.kv_policy == "tiered"
        self._spill_axes = (map_spill_stores(self._axes,
                                             KT.spill_store_meta)
                            if self.spill_compress else self._axes)
        self._zero_slot = None
        self._zero_ext = None

    def _resolve_device(self, device) -> torch.device:
        return resolve_device(device)

    def _place_params(self, params: dict) -> dict:
        return tree_map(lambda t: t.to(self.device), params)

    # ---- accounting --------------------------------------------------
    def slot_kv_bytes(self, *, length: int | None = None
                      ) -> tuple[int, int]:
        return slot_kv_bytes(self.model, self.max_len, length=length,
                             block_tokens=self.block_tokens)

    def spill_lane_bytes(self) -> int:
        return spill_lane_bytes(self.model, self.max_len,
                                self.spill_compress)

    def weight_bytes(self) -> tuple[int, int]:
        return weight_stream_split(self.model.cfg)

    def sim_context(self) -> tuple:
        """(config, spill lanes compressed) for a telemetry ledger."""
        return self.model.cfg, self.spill_compress

    # ---- pool --------------------------------------------------------
    @trace.traced("setup.init_pool")
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
        shared — neither `Model.extend` nor `prefix_load_ws` writes into
        its input."""
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
    @trace.traced("backend.extend")
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

    @trace.traced("backend.decode")
    def decode_step(self, toks, state: KVPoolState, pos, active
                    ) -> tuple[np.ndarray, KVPoolState]:
        """One greedy token per slot: ``toks`` (num_slots, 1), ``pos`` and
        ``active`` (num_slots,). Returns host tokens and the new state."""
        dev = self.device
        with trace.span("decode.inputs"):
            toks = torch.as_tensor(np.asarray(toks), device=dev).long()
            pos = torch.as_tensor(np.asarray(pos), device=dev).long()
            active = torch.as_tensor(np.asarray(active), device=dev).bool()
        with trace.span("decode.model"):
            logits, new = self.model.decode_step(self.params, toks,
                                                 state.cache, pos)
        with trace.span("decode.sample"):
            ntoks = logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
        with trace.span("decode.select"):
            cache = slot_select(new, state.cache, state.axes, active)
        return ntoks, dataclasses.replace(state, cache=cache)

    # ---- spill lanes ---------------------------------------------------
    def evict_slot(self, state: KVPoolState, slot, lane, length
                   ) -> KVPoolState:
        """Pack slot ``slot``'s cache into spill lane ``lane`` (verbatim,
        or the hot ring int8-requantized under spill_compress) and bump
        the lane's endurance counters for a ``length``-token context.
        The lane store is written in place; the cache is only read."""
        if self.n_spill == 0:
            raise ValueError("backend was built with n_spill=0; nothing "
                             "can be evicted")
        if state.spill is None:           # first eviction: materialize
            lanes = self.model.init_cache(self.n_spill, self.max_len,
                                          self.device)
            if self.spill_compress:
                lanes = map_spill_stores(lanes, KT.spill_store_template)
            state = dataclasses.replace(
                state, spill=lanes,
                spill_writes=KT.init_spill_writes(self.n_spill,
                                                  self.max_len,
                                                  self.device),
                spill_axes=(self._spill_axes if self.spill_compress
                            else None))
        slot, lane = int(slot), int(lane)
        img = tree_map(lambda c, a: c.narrow(a, slot, 1), state.cache,
                       self._axes)
        if self.spill_compress:
            img = map_spill_stores(img, KT.spill_store_compress)
        tree_map(lambda s, r, a: s.narrow(a, lane, 1).copy_(r),
                 state.spill, img, self._spill_axes)
        KT.bump_spill_writes(state.spill_writes, lane, length)
        return state

    def restore_slot(self, state: KVPoolState, lane, slot
                     ) -> KVPoolState:
        """Copy spill lane ``lane`` back into pool slot ``slot`` in place:
        bit-exact from a verbatim lane; under spill_compress the hot ring
        comes back within `core.quant.spill_codec_bound`. Every other
        slot, and every lane counter, is left as it was."""
        if state.spill is None:
            raise ValueError("nothing has been spilled; there is no "
                             "lane to restore from")
        lane, slot = int(lane), int(slot)
        img = tree_map(lambda s, a: s.narrow(a, lane, 1), state.spill,
                       self._spill_axes)
        if self.spill_compress:
            cd = self.model.compute_dtype
            img = map_spill_stores(
                img, lambda st: KT.spill_store_decompress(st, cd))
        tree_map(lambda c, r, a: c.narrow(a, slot, 1).copy_(r),
                 state.cache, img, self._axes)
        return state

    # ---- paged prefix block store --------------------------------------
    def ensure_prefix(self, state: KVPoolState) -> KVPoolState:
        """Materialize the prefix block store on first use, on the
        backend's device: a zero extend tree with the batch axis sized to
        ``prefix_blocks`` and the sequence axis to ``block_tokens``."""
        if state.prefix is not None:
            return state
        store = self.model.init_extend_cache(self.prefix_blocks,
                                             self.block_tokens, self.device)
        return dataclasses.replace(state, prefix=store,
                                   prefix_axes=self._ext_axes)

    def prefix_block_bytes(self) -> int:
        """Bytes ONE prefix block pins: what the scheduler charges the
        shared store against the RRAM budget per pinned block."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(
            self.model.extend_spec(1, self.block_tokens)[0]))

    def _zip_ext(self, fn, ext: dict, store: dict) -> dict:
        """``ext`` rebuilt with ``fn(is_ws, ext_leaf, store_leaf,
        block_axis)`` at every leaf; workspace leaves (`*_ws`) hold
        per-position K/V rows, any other leaf a recurrent state."""
        def walk(e, s, a, key):
            if isinstance(e, dict):
                return {k: walk(e[k], s[k], a[k], k) for k in e}
            return fn(_is_ws(key), e, s, a)
        return walk(ext, store, self._ext_axes, None)

    def prefix_save_ws(self, state: KVPoolState, ext: dict, bid, pos
                       ) -> KVPoolState:
        """Write workspace rows [pos, pos + block_tokens) of ``ext`` into
        block ``bid``, in place: the one physical write a shared block
        ever takes."""
        bid, pos, bt = int(bid), int(pos), self.block_tokens

        def save(ws, e, s, a):
            if ws:
                s.narrow(a, bid, 1).copy_(e.narrow(a + 1, pos, bt))
        self._zip_ext(save, ext, state.prefix)
        return state

    def prefix_load_ws(self, state: KVPoolState, ext: dict, bid, pos
                       ) -> dict:
        """A copy of ``ext`` with block ``bid``'s rows at position ``pos``
        (the admission gather of one hit block). Never writes into
        ``ext``: the engine passes the shared zero tree of
        `fresh_extend`."""
        bid, pos, bt = int(bid), int(pos), self.block_tokens

        def load(ws, e, s, a):
            if not ws:
                return e
            out = e.clone()
            out.narrow(a + 1, pos, bt).copy_(s.narrow(a, bid, 1))
            return out
        return self._zip_ext(load, ext, state.prefix)

    def prefix_save_state(self, state: KVPoolState, ext: dict, bid
                          ) -> KVPoolState:
        """Snapshot ``ext``'s recurrent-state leaves into block ``bid``, in
        place: the chain terminal's state, what a hit resumes from. The
        engine calls it for exact-prefill (recurrent) plans only; an
        attention-only plan has no such leaf."""
        bid = int(bid)

        def save(ws, e, s, a):
            if not ws:
                s.narrow(a, bid, 1).copy_(e)
        self._zip_ext(save, ext, state.prefix)
        return state

    def prefix_load_state(self, state: KVPoolState, ext: dict, bid
                          ) -> dict:
        """A copy of ``ext`` with its recurrent-state leaves seeded from
        block ``bid`` (recurrent plans only, as `prefix_save_state`); its
        workspace leaves are left as they are."""
        bid = int(bid)
        return self._zip_ext(
            lambda ws, e, s, a: e if ws else s.narrow(a, bid, 1).to(
                e.dtype, copy=True), ext, state.prefix)


def _is_ws(key) -> bool:
    return str(key).endswith("_ws")


class ShardedBackend(LocalBackend):
    """The executor over a mesh of ranks, each running this same host
    program (the same engine and scheduler decisions) on its shards.

    Parameters sit at their `param_shardings` blocks (`bridge.
    shard_params`); the pool, the spill lanes, the extend state and the
    prefix store at the local shapes of `cache_shardings` /
    `extend_shardings`: slots, lanes and blocks over 'data' (where their
    counts divide), the cold kv_seq over 'model', the hot ring's kv heads
    over 'model'. The model runs tensor parallel over 'model'
    (`models.tp`). A decode step runs the rank's slots and all-gathers
    their greedy tokens over 'data'; an extend (batch 1, replicated)
    runs on every data rank and its commit is stored by the slot's
    owner. A slot image moves between ranks by broadcast from its owner
    (evict / restore, prefix blocks). The knob resolution, the byte
    accounting and the ledger context are `LocalBackend`'s. A 1 x 1 mesh
    is numerically the local path: every collective is over one rank."""

    def __init__(self, model: Model, params: dict, num_slots: int,
                 max_len: int, mesh=None, rules=None, *, device=None,
                 n_spill: int | None = None,
                 spill_compress: bool | None = None,
                 prefix_blocks: int | None = None,
                 block_tokens: int | None = None,
                 fused_decode: bool | None = None,
                 sparse_read: float | None = None,
                 weight_stream: int | None = None):
        from repro_torch.sharding import ShardingRules
        if mesh is None:
            from repro_torch.launch.mesh import make_local_mesh
            mesh = make_local_mesh(device)
        if mesh.is_abstract:
            raise ValueError("ShardedBackend needs a live mesh "
                             "(launch.mesh.get_mesh), not an abstract one")
        self.mesh = mesh
        self.rules = rules or ShardingRules(mesh)
        super().__init__(Model(model.cfg), params, num_slots, max_len,
                         device=device, n_spill=n_spill,
                         spill_compress=spill_compress,
                         prefix_blocks=prefix_blocks,
                         block_tokens=block_tokens,
                         fused_decode=fused_decode, sparse_read=sparse_read,
                         weight_stream=weight_stream)
        base = self.model
        self.model = base.place(mesh, self.rules)
        r = self.rules
        self._pool_specs = base.cache_shardings(r, num_slots, max_len)
        self._ext_specs = base.extend_shardings(r, 1, max_len)
        self._spill_specs = None
        if self.n_spill:
            self._spill_specs = base.cache_shardings(r, self.n_spill,
                                                     max_len)
            if self.spill_compress:
                self._spill_specs = map_spill_stores(self._spill_specs,
                                                     KT.spill_store_meta)
        self._pfx_specs = base.extend_shardings(r, self.prefix_blocks,
                                                self.block_tokens)
        self._slots = self._block("batch", num_slots)

    def _resolve_device(self, device) -> torch.device:
        return self.mesh.device if device is None else \
            resolve_device(device)

    def _place_params(self, params: dict) -> dict:
        from repro_torch.bridge import shard_params
        specs = self.model.param_shardings(self.rules)
        return tree_map(lambda t: t.to(self.device),
                        shard_params(params, specs, self.mesh))

    # ---- placement helpers ---------------------------------------------
    def _block(self, logical: str, n: int):
        """(mesh axes, this rank's first index, local count) of an
        ``n``-long axis resolved from ``logical``."""
        entry = self.rules.spec((logical,), (n,))[0]
        i, k = S.block_of(entry, self.mesh)
        return S.axes_of(entry), i * (n // k), n // k

    def _take_tree(self, tree: dict, specs: dict, axes: dict) -> dict:
        return tree_map(lambda t, s, a: S.shard(
            t, s, self.mesh, skip=(a,)).contiguous(), tree, specs, axes)

    def _read(self, t: torch.Tensor, spec, axis: int, i: int
              ) -> torch.Tensor:
        """Entry ``i`` of a leaf's slot axis, whole: broadcast from the
        rank that holds it over the slot axis's mesh axes, then gathered
        over every other sharded dim."""
        entry = spec[axis]
        axes = S.axes_of(entry)
        if not axes:
            img = t.narrow(axis, i, 1)
        else:
            n_loc = t.shape[axis]
            owner, li = divmod(i, n_loc)
            mine = S.block_of(entry, self.mesh)[0] == owner
            img = (t.narrow(axis, li, 1) if mine else
                   t.new_empty(t.shape[:axis] + (1,) + t.shape[axis + 1:]))
            img = img.contiguous()
            coords = []
            for a in reversed(axes):
                owner, c = divmod(owner, self.mesh.shape[a])
                coords.append((a, c))
            for a, c in coords:           # minor axis first
                img = S.broadcast(img, self.mesh, a, c)
        return S.unshard(img, spec, self.mesh, skip=(axis,))

    def _write(self, t: torch.Tensor, spec, axis: int, i: int,
               img: torch.Tensor) -> None:
        """Store a whole entry ``img`` at index ``i`` of a leaf's slot
        axis, in place, on the rank that holds it (its own block)."""
        entry = spec[axis]
        li = i
        if S.axes_of(entry):
            owner, li = divmod(i, t.shape[axis])
            if S.block_of(entry, self.mesh)[0] != owner:
                return
        t.narrow(axis, li, 1).copy_(
            S.shard(img, spec, self.mesh, skip=(axis,)).to(t.dtype))

    def _gather_tree(self, tree: dict, specs: dict) -> dict:
        return tree_map(lambda t, s: S.unshard(t, s, self.mesh), tree,
                        specs)

    # ---- pool ----------------------------------------------------------
    def init_pool(self) -> KVPoolState:
        _, _, n = self._slots
        cache = self._take_tree(self.model.init_cache(n, self.max_len,
                                                      self.device),
                                self._pool_specs, self._axes)
        return KVPoolState(cache=cache, axes=self._axes)

    def fresh_extend(self) -> dict:
        if self._zero_ext is None:
            full = self.model.init_extend_cache(1, self.max_len,
                                                self.device)
            self._zero_ext = tree_map(
                lambda t, s: S.shard(t, s, self.mesh).contiguous(), full,
                self._ext_specs)
        return self._zero_ext

    def make_pool(self) -> TieredKVPool:
        return TieredKVPool(self.init_pool(), self._insert_state,
                            self.fresh_slot, num_spill_lanes=self.n_spill,
                            num_slots=self.num_slots,
                            writes_of=self._all_writes)

    def _all_writes(self, cache: dict) -> dict:
        """``cache`` with every endurance-counter leaf holding every
        slot's counters (all-gathered over 'data'); what the endurance
        report reads."""
        def walk(c, s, a, key):
            if isinstance(c, dict):
                return {k: walk(c[k], s[k], a[k], k) for k in c}
            axes = S.axes_of(s[a])
            if key != "writes" or not axes:
                return c
            return S.all_gather(c, self.mesh, axes, dim=a)
        return walk(cache, self._pool_specs, self._axes, None)

    def _insert_state(self, state: KVPoolState, req_cache: dict, slot
                      ) -> KVPoolState:
        tree_map(lambda t, s, a, r: self._write(t, s, a, int(slot), r),
                 state.cache, self._pool_specs, self._axes, req_cache)
        return state

    # ---- step programs -----------------------------------------------
    def extend_step(self, batch: dict, state: KVPoolState, ext: dict,
                    slot, pos, length, commit: bool):
        pos, length = int(pos), int(length)
        if not commit:
            _, new_ext = self.model.extend(self.params, batch, ext, pos,
                                           length, specs=self._ext_specs)
            return None, new_ext, state
        logits, committed = self.model.extend(
            self.params, batch, ext, pos, length, commit=True,
            specs=self._ext_specs)
        tok = int(self.model.placement.greedy(logits[:, -1])[0])
        return tok, None, self._insert_state(state, committed, slot)

    def decode_step(self, toks, state: KVPoolState, pos, active
                    ) -> tuple[np.ndarray, KVPoolState]:
        """The rank's slots in one batched call, then the greedy tokens
        of every slot all-gathered over 'data'."""
        dev = self.device
        axes, i0, n = self._slots
        sl = slice(i0, i0 + n)
        toks = torch.as_tensor(np.asarray(toks)[sl], device=dev).long()
        pos = torch.as_tensor(np.asarray(pos)[sl], device=dev).long()
        active = torch.as_tensor(np.asarray(active)[sl],
                                 device=dev).bool()
        logits, new = self.model.decode_step(self.params, toks, state.cache,
                                             pos, specs=self._pool_specs)
        ntoks = self.model.placement.greedy(logits[:, -1]).to(torch.int32)
        if axes:
            with S.scope("data"):
                ntoks = S.all_gather(ntoks, self.mesh, axes, dim=0)
        cache = slot_select(new, state.cache, state.axes, active)
        return ntoks.cpu().numpy(), dataclasses.replace(state, cache=cache)

    # ---- spill lanes ---------------------------------------------------
    def evict_slot(self, state: KVPoolState, slot, lane, length
                   ) -> KVPoolState:
        if self.n_spill == 0:
            raise ValueError("backend was built with n_spill=0; nothing "
                             "can be evicted")
        if state.spill is None:           # first eviction: materialize
            _, _, n = self._block("batch", self.n_spill)
            lanes = self.model.init_cache(n, self.max_len, self.device)
            if self.spill_compress:
                lanes = map_spill_stores(lanes, KT.spill_store_template)
            lanes = self._take_tree(lanes, self._spill_specs,
                                    self._spill_axes)
            state = dataclasses.replace(
                state, spill=lanes,
                spill_writes=KT.init_spill_writes(self.n_spill,
                                                  self.max_len,
                                                  self.device),
                spill_axes=(self._spill_axes if self.spill_compress
                            else None))
        slot, lane = int(slot), int(lane)
        img = tree_map(lambda t, s, a: self._read(t, s, a, slot),
                       state.cache, self._pool_specs, self._axes)
        if self.spill_compress:
            img = map_spill_stores(img, KT.spill_store_compress)
        tree_map(lambda t, s, a, r: self._write(t, s, a, lane, r),
                 state.spill, self._spill_specs, self._spill_axes, img)
        KT.bump_spill_writes(state.spill_writes, lane, length)
        return state

    def restore_slot(self, state: KVPoolState, lane, slot
                     ) -> KVPoolState:
        if state.spill is None:
            raise ValueError("nothing has been spilled; there is no "
                             "lane to restore from")
        lane, slot = int(lane), int(slot)
        img = tree_map(lambda t, s, a: self._read(t, s, a, lane),
                       state.spill, self._spill_specs, self._spill_axes)
        if self.spill_compress:
            cd = self.model.compute_dtype
            img = map_spill_stores(
                img, lambda st: KT.spill_store_decompress(st, cd))
        return self._insert_state(state, img, slot)

    # ---- paged prefix block store --------------------------------------
    def ensure_prefix(self, state: KVPoolState) -> KVPoolState:
        if state.prefix is not None:
            return state
        _, _, n = self._block("batch", self.prefix_blocks)
        store = self._take_tree(
            self.model.init_extend_cache(n, self.block_tokens, self.device),
            self._pfx_specs, self._ext_axes)
        return dataclasses.replace(state, prefix=store,
                                   prefix_axes=self._ext_axes)

    def _zip_sharded(self, fn, ext: dict, store: dict) -> dict:
        """``ext`` rebuilt with ``fn(is_ws, whole ext leaf, store leaf,
        its specs, block axis, ext leaf specs)`` at every leaf."""
        def walk(e, s, ps, es, a, key):
            if isinstance(e, dict):
                return {k: walk(e[k], s[k], ps[k], es[k], a[k], k)
                        for k in e}
            return fn(_is_ws(key), e, s, ps, a, es)
        return walk(ext, store, self._pfx_specs, self._ext_specs,
                    self._ext_axes, None)

    def prefix_save_ws(self, state: KVPoolState, ext: dict, bid, pos
                       ) -> KVPoolState:
        bid, pos, bt = int(bid), int(pos), self.block_tokens

        def save(ws, e, s, ps, a, es):
            if ws:
                whole = S.unshard(e, es, self.mesh)
                self._write(s, ps, a, bid, whole.narrow(a + 1, pos, bt))
        self._zip_sharded(save, ext, state.prefix)
        return state

    def prefix_load_ws(self, state: KVPoolState, ext: dict, bid, pos
                       ) -> dict:
        bid, pos, bt = int(bid), int(pos), self.block_tokens

        def load(ws, e, s, ps, a, es):
            if not ws:
                return e
            out = S.unshard(e, es, self.mesh).clone()
            out.narrow(a + 1, pos, bt).copy_(self._read(s, ps, a, bid))
            return S.shard(out, es, self.mesh).contiguous()
        return self._zip_sharded(load, ext, state.prefix)

    def prefix_save_state(self, state: KVPoolState, ext: dict, bid
                          ) -> KVPoolState:
        bid = int(bid)

        def save(ws, e, s, ps, a, es):
            if not ws:
                self._write(s, ps, a, bid, S.unshard(e, es, self.mesh))
        self._zip_sharded(save, ext, state.prefix)
        return state

    def prefix_load_state(self, state: KVPoolState, ext: dict, bid
                          ) -> dict:
        bid = int(bid)

        def load(ws, e, s, ps, a, es):
            if ws:
                return e
            whole = self._read(s, ps, a, bid).to(e.dtype)
            return S.shard(whole, es, self.mesh).contiguous()
        return self._zip_sharded(load, ext, state.prefix)



def make_backend(kind: str, model: Model, params, *, num_slots: int,
                 max_len: int, device=None, mesh=None,
                 n_spill: int | None = None,
                 spill_compress: bool | None = None,
                 prefix_blocks: int | None = None,
                 block_tokens: int | None = None,
                 fused_decode: bool | None = None,
                 sparse_read: float | None = None,
                 weight_stream: int | None = None) -> InferenceBackend:
    """CLI-facing factory: ``kind`` in {'local', 'sharded'} (``mesh``:
    a live `launch.mesh` mesh; default the 1 x 1 local mesh)."""
    if kind == "local":
        return LocalBackend(model, params, num_slots, max_len, device=device,
                            n_spill=n_spill, spill_compress=spill_compress,
                            prefix_blocks=prefix_blocks,
                            block_tokens=block_tokens,
                            fused_decode=fused_decode,
                            sparse_read=sparse_read,
                            weight_stream=weight_stream)
    if kind == "sharded":
        return ShardedBackend(model, params, num_slots, max_len, mesh=mesh,
                              device=device, n_spill=n_spill,
                              spill_compress=spill_compress,
                              prefix_blocks=prefix_blocks,
                              block_tokens=block_tokens,
                              fused_decode=fused_decode,
                              sparse_read=sparse_read,
                              weight_stream=weight_stream)
    raise ValueError(f"unknown backend kind {kind!r}")
