"""Serving telemetry: step-span tracing, a simulated tier-traffic
ledger, and Perfetto + Prometheus export.

Three instruments, one object (`Telemetry`), wired through the engine
and scheduler:

1. **Span tracer** — every engine step emits phase spans (plan / evict /
   idle-offload / restore / chunk-prefill / commit / decode) and every
   request a lifecycle track (submit -> admit -> first-token ->
   preempt/park -> restore -> finish), timed via the engine's injectable
   clock. `chrome_trace()` exports Chrome-trace/Perfetto JSON: one
   timeline lane per KV slot (who occupied it, when), one per RRAM spill
   lane (who was parked), one per request.

2. **Tier-traffic ledger** (`TierLedger`) — per-step counters of DRAM
   hot-ring bytes, RRAM cold-tier reads and spill-lane bytes, priced
   through `chime_sim`'s per-kernel `CostTerm` stream into a cumulative
   DRAM/RRAM/compute energy split. Totals are `math.fsum` over the flat
   term multiset, so on a drained run they reconcile **bit-for-bit**
   with `metrics.simulated_efficiency` (which sums the same terms from
   the finished trace) — the live form of the paper's
   cross-chiplet-traffic claim.

3. **Gauges + decision log** — slot/lane occupancy, per-priority queue
   depth, endurance watermarks, and scheduler admission-denial /
   eviction reason codes (`deny_no_free_slot`, `deny_dram_budget`,
   `deny_rram_budget`, `deny_spill_lanes`, `deny_token_budget`,
   `evict_priority`, `offload_idle`, `restore`, `restore_yield`,
   `admit`) — exported as a Prometheus text exposition
   (`prometheus()`) and an optional JSONL snapshot stream.

Telemetry is strictly opt-in: `Engine(telemetry=None)` (the default)
installs `NullTelemetry`, whose hooks are empty methods — the disabled
path costs a handful of no-op calls per multi-millisecond step (<2%
throughput, asserted by the bench and tests). The module is pure
host-side bookkeeping, a copy of the reference's `serving/telemetry.py`
with its imports pointed at the port's simulator.
"""

from __future__ import annotations

import collections
import json
import math
import re
import time

import numpy as np

from repro_torch.simulator.chime_sim import (cost_layers, decode_token_terms,
                                       prefill_terms, prefix_adopt_terms,
                                       spill_terms, sum_terms,
                                       visual_tokens)
from repro_torch.simulator.chime_sim import closing_terms as _closing_terms
from repro_torch.simulator.hardware import CHIME

# the engine's step phases, in step order (`Engine.step` opens each as a
# program span of `runtime.trace` and, with a hub attached, as the hub's
# phase; "commit" nests in "chunk-prefill")
PHASES = ("plan", "evict", "idle-offload", "restore", "chunk-prefill",
          "commit", "decode")

# trace process ids: one Perfetto process group per facet
PID_ENGINE = 1      # engine step phases (+ counter tracks)
PID_SLOTS = 2       # KV slots: occupancy segments per slot
PID_LANES = 3       # RRAM spill lanes: parked segments per lane
PID_REQUESTS = 4    # request lifecycle segments per rid

#: every reason code the scheduler/engine can log, with glossary —
#: mirrored in the README reason-code table
REASON_CODES = {
    "admit": "queue head admitted (slot + both byte budgets ok)",
    "deny_no_free_slot": "queue head blocked: no free KV slot",
    "deny_dram_budget": "queue head blocked: DRAM hot-ring byte budget",
    "deny_dram_weights": "queue head blocked: resident weight working "
                         "set leaves no DRAM headroom for its KV",
    "deny_rram_budget": "queue head blocked: RRAM cold-tier byte budget",
    "deny_spill_lanes": "queue head blocked: oversubscribe overflow "
                        "exceeds free spill lanes",
    "deny_token_budget": "queue head blocked: step token budget "
                         "exhausted by decode slots/chunks",
    "deny_restore_dram_budget": "restore deferred: DRAM byte budget",
    "deny_restore_rram_budget": "restore deferred: RRAM byte budget",
    "deny_restore_spill_lanes": "restore deferred: spill-lane gate",
    "evict_priority": "runner preempted by a strictly higher-priority "
                      "waiter (KV spilled to an RRAM lane)",
    "offload_idle": "idle runner parked to RRAM for an equal-or-higher "
                    "priority waiter (capacity offload)",
    "restore": "spilled request restored into a free slot",
    "restore_yield": "restore yielded its slot to a higher-priority "
                     "queue head",
    "prefix_adopt": "admitted request seeded its prefill from cached "
                    "prefix blocks (skipped recompute of the hit span)",
}


# ---------------------------------------------------------------------------
# tier-traffic ledger
# ---------------------------------------------------------------------------
class TierLedger:
    """Per-step simulated traffic/energy accounting of the live engine.

    Every priced engine event (prefill commit, decode token at its
    context, spill, restore, per-request closing static charge) appends
    its `chime_sim.CostTerm` list; `totals()` folds the flat stream with
    `sum_terms` — the same order-independent fsum `simulated_efficiency`
    uses, so a drained run reconciles bitwise.

    On top of the priced terms, each step row splits the attention KV
    read of every decode token into DRAM hot-ring bytes (the bf16 ring,
    last ``kv_hot_window`` tokens) and RRAM cold-tier read bytes (the
    int8 prefix beyond the ring + its f32 scales) — the byte-level view
    of the tiered-attention dataflow."""

    def __init__(self, cfg, platform=None, spill_compressed: bool = False,
                 fused_decode: bool | None = None,
                 sparse_read_tau: float | None = None,
                 weight_stream: bool | None = None):
        from repro_torch.models.counting import (kv_elems_per_token,
                                           kv_scale_elems_per_token)
        self.cfg = cfg
        self.platform = platform or CHIME
        self.spill_compressed = bool(spill_compressed)
        # fused paged-decode pricing: explicit args (the backend's resolved
        # knobs) win; None falls back to the cfg fields so a bare
        # TierLedger(cfg) still prices what the model executes
        self.fused_decode = bool(
            getattr(cfg, "fused_decode", False) if fused_decode is None
            else fused_decode)
        self.sparse_read_tau = float(
            getattr(cfg, "sparse_read_tau", 0.0) if sparse_read_tau is None
            else sparse_read_tau)
        self.weight_stream = bool(
            getattr(cfg, "weight_stream_layers", 0) if weight_stream is None
            else weight_stream)
        self._layers = cost_layers(cfg)
        self._kv_elems = kv_elems_per_token(cfg)
        self._scale_elems = kv_scale_elems_per_token(cfg)
        try:
            self._hot_itemsize = np.dtype(cfg.compute_dtype).itemsize
        except TypeError:       # bfloat16: unknown to bare numpy
            self._hot_itemsize = 2
        self._hot_w = (cfg.kv_hot_window if cfg.kv_policy == "tiered"
                       else None)
        self._terms: list = []
        self._req_terms: dict[int, list] = {}
        self._req_prompt: dict[int, int] = {}
        self.steps: list[dict] = []
        self._row: dict | None = None
        self.requests_closed = 0

    # -- step framing --------------------------------------------------
    def step_begin(self, step: int):
        self._row = {"step": step, "tokens": 0,
                     "dram_hot_ring_bytes": 0.0,
                     "rram_cold_read_bytes": 0.0,
                     "rram_spill_bytes": 0.0,
                     "prefix_adopt_bytes": 0.0,
                     "dram_stream_bytes": 0.0,
                     "rram_stream_bytes": 0.0,
                     "sparse_skipped_bytes": 0.0,
                     "weight_stream_bytes": 0.0,
                     "kv_append_bytes": 0.0,
                     "ucie_bytes": 0.0,
                     "energy_j": 0.0}

    def step_end(self):
        if self._row is not None:
            self.steps.append(self._row)
            self._row = None

    def _record(self, rid: int, terms):
        self._terms.extend(terms)
        self._req_terms.setdefault(rid, []).extend(terms)
        row = self._row
        if row is None:
            return
        for tm in terms:
            row["energy_j"] += tm.energy_j
            if tm.domain == "dram":
                row["dram_stream_bytes"] += tm.bytes_moved
            elif tm.domain == "rram":
                row["rram_stream_bytes"] += tm.bytes_moved
            elif tm.domain == "spill":
                row["rram_spill_bytes"] += tm.bytes_moved
            elif tm.domain == "prefix":
                row["prefix_adopt_bytes"] += tm.bytes_moved
            elif tm.domain == "skipped":
                row["sparse_skipped_bytes"] += tm.bytes_moved
            elif tm.domain == "weight_stream":
                row["weight_stream_bytes"] += tm.bytes_moved
            elif tm.domain == "kv_write":
                row["kv_append_bytes"] += tm.bytes_moved
            elif tm.domain == "ucie":
                row["ucie_bytes"] += tm.bytes_moved

    # -- priced events -------------------------------------------------
    def prefill(self, rid: int, text_tokens: int, image: bool,
                cached: int = 0):
        """Request committed its prompt: price the prefill and remember
        the prompt length that anchors its decode contexts — computed
        with the simulator's own `visual_tokens` formula so the ledger
        and `simulated_efficiency` can never disagree on ctx. ``cached``
        prompt positions came from the shared prefix store: the prefill
        prices only the tail (same `cached_prefix` path as
        `request_terms`) plus the block-adoption transfer."""
        prompt = (visual_tokens(self.cfg) if image else 0) + text_tokens
        self._req_prompt[rid] = prompt
        terms = prefill_terms(self.cfg, self.platform, text_tokens,
                              image, self._layers, cached_prefix=cached,
                              weight_stream=self.weight_stream)
        if cached > 0:
            terms = terms + prefix_adopt_terms(self.cfg, self.platform,
                                               cached)
        self._record(rid, terms)

    def decode(self, rid: int, n_generated: int):
        """One emitted token: n_generated is the post-emit count, so the
        token's context is prompt + (n_generated - 1) — identical for the
        commit-emitted first token and decode-step tokens."""
        ctx = self._req_prompt[rid] + n_generated - 1
        self._record(rid, decode_token_terms(
            self.cfg, self.platform, ctx, self._layers,
            fused=self.fused_decode, sparse_tau=self.sparse_read_tau,
            weight_stream=self.weight_stream))
        row = self._row
        if row is not None:
            row["tokens"] += 1
            if self._hot_w is None:
                row["dram_hot_ring_bytes"] += (self._kv_elems * ctx
                                               * self._hot_itemsize)
            else:
                # the store-level hot/cold view: attendable bytes per
                # tier. Under the sparse read the skipped share of the
                # cold bytes shows up in sparse_skipped_bytes (from the
                # `skipped` CostTerms) while this counter keeps the full
                # attendable figure.
                row["dram_hot_ring_bytes"] += (
                    self._kv_elems * min(ctx, self._hot_w)
                    * self._hot_itemsize)
                cold_toks = max(ctx - self._hot_w, 0)
                row["rram_cold_read_bytes"] += cold_toks * (
                    self._kv_elems + 4 * self._scale_elems)

    def spill(self, rid: int, ctx: int, restore: bool):
        self._record(rid, spill_terms(self.cfg, self.platform, int(ctx),
                                      restore=restore,
                                      compressed=self.spill_compressed))

    def close(self, rid: int):
        """Request finished: charge its closing static-power terms
        (computed over its own non-spill term stream, exactly as
        `request_terms` does)."""
        terms = self._req_terms.get(rid)
        if terms:
            self._record(rid, _closing_terms(self.platform, terms))
            self.requests_closed += 1

    # -- reports -------------------------------------------------------
    def totals(self) -> dict:
        """Cumulative ledger: the reconciling sim_* aggregate plus the
        per-tier byte counters folded (fsum) over the step rows."""
        rows = self.steps + ([self._row] if self._row is not None else [])
        out = sum_terms(self._terms)
        out["tokens"] = int(sum(r["tokens"] for r in rows))
        out["requests_closed"] = self.requests_closed
        for k in ("dram_hot_ring_bytes", "rram_cold_read_bytes",
                  "rram_spill_bytes", "prefix_adopt_bytes",
                  "dram_stream_bytes", "rram_stream_bytes",
                  "sparse_skipped_bytes", "weight_stream_bytes",
                  "kv_append_bytes", "ucie_bytes"):
            out[k] = math.fsum(r[k] for r in rows)
        return out


# ---------------------------------------------------------------------------
# the telemetry hub
# ---------------------------------------------------------------------------
class Telemetry:
    """Live serving observability hub (see module docstring).

    Construct with no arguments and hand to ``Engine(telemetry=...)`` —
    the engine `bind`s its model config, spill codec, injectable clock
    and endurance reporter. ``stats_every`` > 0 emits a snapshot (JSONL
    line via ``snapshot_path``, console line via ``printer``) every N
    steps. ``max_events`` / ``max_decisions`` bound memory; overflow is
    counted, not silently lost."""

    enabled = True

    def __init__(self, cfg=None, platform=None,
                 spill_compressed: bool | None = None, clock=None,
                 stats_every: int = 0, snapshot_path: str | None = None,
                 printer=None, max_events: int = 200_000,
                 max_decisions: int = 10_000,
                 fused_decode: bool | None = None,
                 sparse_read_tau: float | None = None,
                 weight_stream: bool | None = None):
        self.cfg = cfg
        self.platform = platform
        self.spill_compressed = spill_compressed
        self.fused_decode = fused_decode
        self.sparse_read_tau = sparse_read_tau
        self.weight_stream = weight_stream
        self.clock = clock or time.perf_counter
        self.stats_every = int(stats_every or 0)
        self.snapshot_path = snapshot_path
        self.printer = printer
        self.max_events = max_events
        self.max_decisions = max_decisions
        self.ledger: TierLedger | None = None
        self.counters: collections.Counter = collections.Counter()
        self.decision_counts: collections.Counter = collections.Counter()
        self.decisions: list[dict] = []
        self.gauges: dict = {}
        self.phase_s: dict[str, float] = {}
        self.snapshots: list[dict] = []
        self.dropped_events = 0
        self.dropped_decisions = 0
        self._on_snapshot = None
        self._events: list[dict] = []
        self._phase_stack: list[tuple[str, float]] = []
        self._step = -1
        self._t0: float | None = None
        self._t_last = 0.0
        self._slot_open: dict[int, tuple[int, float]] = {}
        self._lane_open: dict[int, tuple[int, float]] = {}
        self._req_open: dict[int, tuple[str, float]] = {}
        self._req_slot: dict[int, int] = {}
        self._slots_seen: set[int] = set()
        self._lanes_seen: set[int] = set()
        self._rids_seen: set[int] = set()
        self._snap_file = None
        self._maybe_ledger()

    def _maybe_ledger(self):
        if self.ledger is None and self.cfg is not None:
            self.ledger = TierLedger(
                self.cfg, self.platform,
                bool(self.spill_compressed),
                fused_decode=self.fused_decode,
                sparse_read_tau=self.sparse_read_tau,
                weight_stream=self.weight_stream)

    def bind(self, *, cfg=None, spill_compressed=None, clock=None,
             platform=None, on_snapshot=None, fused_decode=None,
             sparse_read_tau=None, weight_stream=None):
        """Engine attachment: fill whatever the user left unset. The
        engine's clock always wins — it is the time authority every
        request timestamp already uses."""
        if self.cfg is None:
            self.cfg = cfg
        if self.spill_compressed is None:
            self.spill_compressed = spill_compressed
        if self.fused_decode is None:
            self.fused_decode = fused_decode
        if self.sparse_read_tau is None:
            self.sparse_read_tau = sparse_read_tau
        if self.weight_stream is None:
            self.weight_stream = weight_stream
        if self.platform is None:
            self.platform = platform
        if clock is not None:
            self.clock = clock
        if on_snapshot is not None:
            self._on_snapshot = on_snapshot
        self._maybe_ledger()

    # -- clock ---------------------------------------------------------
    def _now(self) -> float:
        t = self.clock()
        if self._t0 is None:
            self._t0 = t
        self._t_last = t
        return t

    def _us(self, t: float) -> int:
        return int(round((t - (self._t0 or 0.0)) * 1e6))

    def _emit(self, ev: dict):
        if len(self._events) >= self.max_events:
            self.dropped_events += 1
            return
        self._events.append(ev)

    def _span(self, pid: int, tid: int, name: str, t0: float, t1: float,
              args: dict | None = None):
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": self._us(t0), "dur": max(self._us(t1) - self._us(t0),
                                             1)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def _instant(self, pid: int, tid: int, name: str, t: float,
                 args: dict | None = None):
        ev = {"name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
              "ts": self._us(t)}
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- step framing / phases -----------------------------------------
    def step_begin(self, step: int):
        self._step = step
        self.counters["steps"] += 1
        if self.ledger is not None:
            self.ledger.step_begin(step)

    def step_end(self, gauges: dict | None = None):
        if gauges is not None:
            self.gauges = gauges
            t = self._now()
            self._emit({"name": "slots", "ph": "C", "pid": PID_ENGINE,
                        "tid": 0, "ts": self._us(t),
                        "args": {"active": gauges.get("slots_active", 0),
                                 "free": gauges.get("slots_free", 0)}})
            qd = gauges.get("queue_depth") or {}
            self._emit({"name": "queue_depth", "ph": "C",
                        "pid": PID_ENGINE, "tid": 0, "ts": self._us(t),
                        "args": {str(k): v for k, v in sorted(qd.items())}
                        or {"0": 0}})
        if self.ledger is not None:
            self.ledger.step_end()
        if self.stats_every and (self._step + 1) % self.stats_every == 0:
            self.snapshot()

    def phase_begin(self, name: str):
        self._phase_stack.append((name, self._now()))

    def phase_end(self, count: int | None = None, **args):
        """Close the innermost phase. ``count=0`` elides the span (an
        empty evict/restore phase every step would bury the timeline);
        any other value lands in the span args."""
        name, t0 = self._phase_stack.pop()
        t1 = self._now()
        if count == 0:
            return
        self.phase_s[name] = self.phase_s.get(name, 0.0) + (t1 - t0)
        if count is not None:
            args["count"] = count
        self._span(PID_ENGINE, 0, name, t0, t1, args or None)

    # -- request lifecycle ---------------------------------------------
    def _req_segment(self, rid: int, state: str | None, t: float):
        """Close the request's open lifecycle segment (if any) and open
        ``state`` (None = final close)."""
        open_ = self._req_open.pop(rid, None)
        if open_ is not None:
            self._span(PID_REQUESTS, rid, open_[0], open_[1], t)
        if state is not None:
            self._req_open[rid] = (state, t)
        self._rids_seen.add(rid)

    def request_submitted(self, req):
        t = self._now()
        self.counters["submitted"] += 1
        self._req_segment(req.rid, "queued", t)

    def request_admitted(self, req, slot: int):
        t = self._now()
        self.counters["admitted"] += 1
        self._req_segment(req.rid, "prefill", t)
        self._req_slot[req.rid] = slot
        self._slot_open[slot] = (req.rid, t)
        self._slots_seen.add(slot)

    def request_first_token(self, req):
        t = self._now()
        self.counters["prefill_commits"] += 1
        self._req_segment(req.rid, "decode", t)
        self._instant(PID_REQUESTS, req.rid, "first-token", t)
        if self.ledger is not None:
            image = req.has_image and self.cfg.frontend is not None
            self.ledger.prefill(req.rid, int(req.tokens.shape[0]), image,
                                cached=int(getattr(req, "prefix_hit", 0)))
        self.token(req)

    def token(self, req):
        self.counters["tokens"] += 1
        if self.ledger is not None:
            self.ledger.decode(req.rid, req.n_generated)

    def request_evicted(self, req, slot: int, lane: int, ctx: int,
                        offload: bool):
        t = self._now()
        self.counters["idle_offloads" if offload else "evictions"] += 1
        self._req_segment(req.rid, "parked", t)
        open_ = self._slot_open.pop(slot, None)
        if open_ is not None:
            self._span(PID_SLOTS, slot, f"r{open_[0]}", open_[1], t)
        self._req_slot.pop(req.rid, None)
        self._lane_open[lane] = (req.rid, t)
        self._lanes_seen.add(lane)
        self._instant(PID_REQUESTS, req.rid,
                      "offload" if offload else "preempt", t,
                      {"ctx": int(ctx), "lane": lane})
        if self.ledger is not None:
            self.ledger.spill(req.rid, ctx, restore=False)

    def request_restored(self, req, lane: int, slot: int, ctx: int):
        t = self._now()
        self.counters["restores"] += 1
        self._req_segment(req.rid, "decode", t)
        open_ = self._lane_open.pop(lane, None)
        if open_ is not None:
            self._span(PID_LANES, lane, f"r{open_[0]}", open_[1], t)
        self._req_slot[req.rid] = slot
        self._slot_open[slot] = (req.rid, t)
        self._slots_seen.add(slot)
        if self.ledger is not None:
            self.ledger.spill(req.rid, ctx, restore=True)

    def request_finished(self, req):
        t = self._now()
        self.counters["finished"] += 1
        self._req_segment(req.rid, None, t)
        slot = self._req_slot.pop(req.rid, None)
        if slot is not None:
            open_ = self._slot_open.pop(slot, None)
            if open_ is not None:
                self._span(PID_SLOTS, slot, f"r{open_[0]}", open_[1], t)
        if self.ledger is not None:
            self.ledger.close(req.rid)

    # -- decisions -----------------------------------------------------
    def decision(self, code: str, rid: int | None = None, **args):
        self.decision_counts[code] += 1
        if len(self.decisions) >= self.max_decisions:
            self.dropped_decisions += 1
            return
        d = {"step": self._step, "code": code}
        if rid is not None:
            d["rid"] = rid
        if args:
            d.update(args)
        self.decisions.append(d)

    # -- snapshots -----------------------------------------------------
    def snapshot(self) -> dict:
        snap = {
            "step": self._step,
            "t_s": round(self._t_last - (self._t0 or 0.0), 9),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "decisions": dict(self.decision_counts),
            "phase_s": dict(sorted(self.phase_s.items())),
        }
        if self.ledger is not None:
            snap["ledger"] = self.ledger.totals()
        if self._on_snapshot is not None:
            snap["endurance"] = self._on_snapshot()
        self.snapshots.append(snap)
        if self.snapshot_path:
            if self._snap_file is None:
                self._snap_file = open(self.snapshot_path, "a")
            self._snap_file.write(json.dumps(snap) + "\n")
            self._snap_file.flush()
        if self.printer is not None:
            g = self.gauges
            self.printer(
                f"[telemetry] step={self._step + 1} "
                f"tok={self.counters['tokens']} "
                f"fin={self.counters['finished']}"
                f"/{self.counters['submitted']} "
                f"slots={g.get('slots_active', '?')}"
                f"/{g.get('slots_total', '?')} "
                f"lanes_free={g.get('lanes_free', '?')} "
                f"spilled={g.get('spilled_requests', '?')}")
        return snap

    def close(self):
        if self._snap_file is not None:
            self._snap_file.close()
            self._snap_file = None

    # -- exports -------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON of everything so far. Open
        segments (still-running requests, occupied slots/lanes) are
        closed at the last observed timestamp; internal state is not
        mutated, so this can be called mid-run."""
        t_end = self._t_last
        events = list(self._events)

        def span(pid, tid, name, t0):
            ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
                  "ts": self._us(t0),
                  "dur": max(self._us(t_end) - self._us(t0), 1)}
            events.append(ev)

        for slot, (rid, t0) in self._slot_open.items():
            span(PID_SLOTS, slot, f"r{rid}", t0)
        for lane, (rid, t0) in self._lane_open.items():
            span(PID_LANES, lane, f"r{rid}", t0)
        for rid, (state, t0) in self._req_open.items():
            span(PID_REQUESTS, rid, state, t0)
        meta = [
            {"ph": "M", "pid": PID_ENGINE, "tid": 0,
             "name": "process_name",
             "args": {"name": "engine (step phases)"}},
            {"ph": "M", "pid": PID_SLOTS, "tid": 0,
             "name": "process_name",
             "args": {"name": "kv-slots (DRAM hot ring)"}},
            {"ph": "M", "pid": PID_LANES, "tid": 0,
             "name": "process_name",
             "args": {"name": "rram spill lanes"}},
            {"ph": "M", "pid": PID_REQUESTS, "tid": 0,
             "name": "process_name", "args": {"name": "requests"}},
        ]
        for slot in sorted(self._slots_seen):
            meta.append({"ph": "M", "pid": PID_SLOTS, "tid": slot,
                         "name": "thread_name",
                         "args": {"name": f"slot {slot}"}})
        for lane in sorted(self._lanes_seen):
            meta.append({"ph": "M", "pid": PID_LANES, "tid": lane,
                         "name": "thread_name",
                         "args": {"name": f"lane {lane}"}})
        for rid in sorted(self._rids_seen):
            meta.append({"ph": "M", "pid": PID_REQUESTS, "tid": rid,
                         "name": "thread_name",
                         "args": {"name": f"req {rid}"}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def prometheus(self) -> str:
        """Prometheus text exposition of counters, decisions, phase
        times, ledger totals, gauges and endurance watermarks."""
        lines: list[str] = []

        def esc(v) -> str:
            return str(v).replace("\\", r"\\").replace('"', r'\"') \
                .replace("\n", r"\n")

        def fam(name, typ, help_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            for labels, value in samples:
                lab = ""
                if labels:
                    lab = "{" + ",".join(
                        f'{k}="{esc(v)}"'
                        for k, v in sorted(labels.items())) + "}"
                lines.append(f"{name}{lab} {value}")

        c = self.counters
        fam("repro_serving_steps_total", "counter",
            "Engine steps executed.", [(None, c["steps"])])
        fam("repro_serving_tokens_total", "counter",
            "Tokens emitted (first tokens included).",
            [(None, c["tokens"])])
        fam("repro_serving_requests_total", "counter",
            "Request lifecycle events.",
            [({"event": e}, c[e])
             for e in ("submitted", "admitted", "finished")])
        fam("repro_serving_spill_events_total", "counter",
            "KV spill-store traffic events.",
            [({"kind": "preempt"}, c["evictions"]),
             ({"kind": "offload"}, c["idle_offloads"]),
             ({"kind": "restore"}, c["restores"])])
        denials = [({"reason": k[len("deny_"):]}, v)
                   for k, v in sorted(self.decision_counts.items())
                   if k.startswith("deny_")]
        fam("repro_serving_admission_denials_total", "counter",
            "Scheduler denials by reason code.", denials or [(None, 0)])
        fam("repro_serving_scheduler_decisions_total", "counter",
            "All scheduler decision codes.",
            [({"code": k}, v)
             for k, v in sorted(self.decision_counts.items())]
            or [(None, 0)])
        fam("repro_serving_phase_seconds_total", "counter",
            "Wall time per engine step phase.",
            [({"phase": k}, repr(v))
             for k, v in sorted(self.phase_s.items())] or [(None, 0)])
        if self.ledger is not None:
            tot = self.ledger.totals()
            fam("repro_serving_tier_bytes_total", "counter",
                "Simulated bytes moved per memory tier.",
                [({"tier": k[:-len("_bytes")]}, repr(tot[k]))
                 for k in ("dram_hot_ring_bytes", "rram_cold_read_bytes",
                           "rram_spill_bytes", "prefix_adopt_bytes",
                           "dram_stream_bytes", "rram_stream_bytes",
                           "weight_stream_bytes", "kv_append_bytes",
                           "ucie_bytes")])
            fam("repro_serving_sim_energy_joules_total", "counter",
                "Simulated energy by cost-term domain.",
                [({"domain": d}, repr(e))
                 for d, e in tot["sim_energy_split_j"].items()])
            fam("repro_serving_sim_seconds_total", "counter",
                "Simulated sequential execution time.",
                [(None, repr(tot["sim_total_s"]))])
        g = self.gauges
        for key, help_ in (("slots_active", "Occupied KV slots."),
                           ("slots_free", "Free KV slots."),
                           ("lanes_free", "Free RRAM spill lanes."),
                           ("spilled_requests",
                            "Requests parked in the spill store."),
                           ("inflight",
                            "Prompts currently prefilling (0 or 1)."),
                           ("prefix_blocks_used",
                            "Live prefix-cache blocks."),
                           ("prefix_blocks_free",
                            "Free prefix-cache blocks."),
                           ("prefix_max_refcount",
                            "Max concurrent sharers on one block."),
                           ("prefix_hits",
                            "Admissions that adopted a cached prefix."),
                           ("prefix_hit_tokens",
                            "Prompt positions skipped via prefix hits."),
                           ("prefix_cow_copies",
                            "Copy-on-write block copies."),
                           ("prefix_blocks_registered",
                            "Blocks ever registered (physical writes)."),
                           ("prefix_blocks_evicted",
                            "Blocks reclaimed from the prefix store.")):
            if key in g:
                fam(f"repro_serving_{key}", "gauge", help_,
                    [(None, g[key])])
        qd = g.get("queue_depth") or {}
        fam("repro_serving_queue_depth", "gauge",
            "Queued requests per priority class.",
            [({"priority": str(p)}, n) for p, n in sorted(qd.items())]
            or [({"priority": "0"}, 0)])
        if self._on_snapshot is not None:
            rep = self._on_snapshot()
            fam("repro_serving_endurance", "gauge",
                "Endurance audit watermarks (bool keys are 0/1).",
                [({"key": k},
                  int(v) if isinstance(v, (bool, int))
                  else repr(float(v)))
                 for k, v in sorted(rep.items())
                 if isinstance(v, (int, float, bool))])
        fam("repro_serving_trace_events_dropped_total", "counter",
            "Trace events dropped at the max_events cap.",
            [(None, self.dropped_events)])
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str):
        with open(path, "w") as f:
            f.write(self.prometheus())

    def summary(self) -> dict:
        """Compact end-of-run record (what `serving_bench` persists):
        counters, decision-code counts, span-phase time breakdown, and
        the ledger's per-tier bytes + energy split."""
        out = {
            "counters": dict(self.counters),
            "decisions": dict(self.decision_counts),
            "phase_s": dict(sorted(self.phase_s.items())),
            "dropped_events": self.dropped_events,
        }
        if self.ledger is not None:
            out["ledger"] = self.ledger.totals()
        return out


class NullTelemetry:
    """Disabled-telemetry stand-in: every hook is an empty method, so
    the engine's instrumented hot path costs a handful of no-op calls
    per step (<2% throughput — the contract the bench asserts).
    `Engine(telemetry=None)` installs this."""

    enabled = False
    ledger = None

    def bind(self, **kw):
        pass

    def step_begin(self, step):
        pass

    def step_end(self, gauges=None):
        pass

    def phase_begin(self, name):
        pass

    def phase_end(self, count=None, **args):
        pass

    def request_submitted(self, req):
        pass

    def request_admitted(self, req, slot):
        pass

    def request_first_token(self, req):
        pass

    def token(self, req):
        pass

    def request_evicted(self, req, slot, lane, ctx, offload):
        pass

    def request_restored(self, req, lane, slot, ctx):
        pass

    def request_finished(self, req):
        pass

    def decision(self, code, rid=None, **args):
        pass

    def snapshot(self):
        return {}

    def close(self):
        pass


# ---------------------------------------------------------------------------
# validators (shared by tests and the CI trace-schema smoke step)
# ---------------------------------------------------------------------------
_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{([^}]*)\})?"
    r" (-?(?:[0-9.]+(?:[eE][+-]?[0-9]+)?|[Ii]nf)|NaN)$")
_PROM_LABEL = re.compile(
    r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"$')


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Strictly parse a Prometheus text exposition; returns
    (metric_name, labels, value) samples. Raises ValueError on any
    malformed line, undeclared metric (no # TYPE), or bad label pair —
    the CI smoke step's schema gate."""
    declared: set[str] = set()
    samples: list[tuple[str, dict, float]] = []
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"):
                raise ValueError(f"line {ln}: malformed TYPE: {line!r}")
            declared.add(parts[2])
            continue
        if line.startswith("# HELP "):
            if len(line.split()) < 3:
                raise ValueError(f"line {ln}: malformed HELP: {line!r}")
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        name, rawlab, rawval = m.groups()
        if name not in declared:
            raise ValueError(f"line {ln}: sample for undeclared metric "
                             f"{name!r}")
        labels = {}
        if rawlab:
            for pair in rawlab.split(","):
                lm = _PROM_LABEL.match(pair)
                if not lm:
                    raise ValueError(f"line {ln}: malformed label "
                                     f"{pair!r}")
                labels[lm.group(1)] = lm.group(2)
        samples.append((name, labels, float(rawval)))
    return samples


def validate_chrome_trace(trace: dict) -> dict:
    """Structurally validate a Chrome-trace/Perfetto JSON object.
    Raises ValueError on schema violations; returns a summary
    ({events, spans, instants, counters, processes, phases}) for
    assertions on content."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with 'traceEvents'")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    spans = instants = counters = 0
    processes: set[int] = set()
    phases: set[str] = set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for key in ("ph", "pid", "tid", "name"):
            if key not in ev:
                raise ValueError(f"event {i}: missing {key!r}: {ev}")
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"],
                                                            int):
            raise ValueError(f"event {i}: pid/tid must be ints")
        processes.add(ev["pid"])
        ph = ev["ph"]
        if ph == "M":
            if "args" not in ev:
                raise ValueError(f"event {i}: metadata without args")
            continue
        if "ts" not in ev or not isinstance(ev["ts"], int) \
                or ev["ts"] < 0:
            raise ValueError(f"event {i}: bad ts: {ev}")
        if ph == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 1:
                raise ValueError(f"event {i}: X span needs dur >= 1")
            spans += 1
            if ev["pid"] == PID_ENGINE:
                phases.add(ev["name"])
        elif ph == "i":
            instants += 1
        elif ph == "C":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"event {i}: counter without args")
            counters += 1
        else:
            raise ValueError(f"event {i}: unexpected phase {ph!r}")
    return {"events": len(evs), "spans": spans, "instants": instants,
            "counters": counters, "processes": sorted(processes),
            "phases": sorted(phases)}
