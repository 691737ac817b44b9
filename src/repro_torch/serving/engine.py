"""Continuous-batching engine driven by per-step work plans: chunked
prefill through the unified `extend_step` + one backend decode step.

Step anatomy (one `Engine.step()` call):

  1. plan — the scheduler emits a `StepPlan`: under the step's token
     budget (decode slots take one token each), the in-flight prompt
     advances by prefill chunks of at most ``chunk_tokens`` positions,
     and the FCFS queue head is admitted (slot + DRAM/RRAM byte budgets
     permitting) once the previous prompt committed. Under pressure the
     plan may first PREEMPT: a strictly higher-priority waiter evicts
     the lowest-priority running victim's KV state into an RRAM spill
     lane (`backend.evict_slot`, verbatim image + endurance-counter
     bump), and spilled requests restore bit-exactly into freed slots
     (`backend.restore_slot`) so resumed decode is token-for-token
     identical to a never-evicted run;
  2. prefill chunks — each chunk is ONE `backend.extend_step` call that
     extends the in-flight request's chunk-resumable state; the final
     (``commit``) chunk folds it into the already-allocated pool slot and
     yields the request's first greedy token. A VQA prompt's visual span
     is chunked in patch space and its text tail in token space, split at
     the modality boundary;
  3. decode — ONE backend call advances every active slot:
     `backend.decode_step` runs the jitted per-slot decode (vmapped
     locally, pjit-sharded on a mesh). Slot shapes are static; the
     backend compiles once per chunk shape;
  4. retire — slots whose request hit EOS or max_new_tokens are freed
     for recycling; inactive slots' cache writes are masked out, so
     endurance counters only ever reflect real occupancies.

With the default knobs (no token budget, no chunk cap) a prompt prefills
in one chunk and the engine reproduces the PR 1/2 admit-whole-prompt
loop token-for-token. With a budget, long vision prompts no longer stall
every decode slot for the full prompt duration — decode slots keep
emitting between chunks (Sarathi-style chunked prefill), which is what
bounds TBT on the paper's multimodal workloads.

The engine is execution-agnostic: it talks to an
`serving.backend.InferenceBackend` and a model-free `TieredKVPool`, so
scheduling, metrics and the endurance audit run unmodified on the local
vmapped backend and the pjit-sharded one. Greedy decoding (matches
`launch.serve.generate`); tokens stream to each request's ``on_token``
callback as they are produced.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
import warnings

import numpy as np

from repro_torch.runtime import trace
from repro_torch.serving.backend import InferenceBackend
from repro_torch.serving.block_pool import (BlockPool, PrefixHit,
                                      request_prefix_keys)
from repro_torch.serving.request import FINISHED, PREEMPTED, RUNNING, Request
from repro_torch.serving.scheduler import (CapacityBudget, FCFSScheduler,
                                     PrefillChunk)
from repro_torch.serving.telemetry import PHASES, NullTelemetry
from repro_torch.simulator.hardware import CHIME


def bucket_len(n: int, minimum: int = 8) -> int:
    """Next power of two >= n (>= minimum): bounds jit retraces to
    O(log max_prompt) prefill shapes."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _env_int(name: str) -> int | None:
    """Env knob: a positive int enables, an explicit 0 disables (returned
    as 0 so it is distinguishable from unset), empty/absent returns None;
    anything else is ignored with a warning (an env var should never
    wedge startup)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError:
        warnings.warn(f"ignoring non-integer {name}={raw!r}")
        return None
    if v < 0:
        warnings.warn(f"ignoring negative {name}={v}")
        return None
    return v


def _env_float(name: str) -> float | None:
    """Float env knob with the same sanitation contract as `_env_int`."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        warnings.warn(f"ignoring non-numeric {name}={raw!r}")
        return None
    if v < 0:
        warnings.warn(f"ignoring negative {name}={v}")
        return None
    return v


@dataclasses.dataclass
class _Inflight:
    """The one prompt currently prefilling: its pool slot is already
    allocated (it pins the byte budgets) and ``ext`` carries the
    chunk-resumable state between extend calls. ``prefix`` holds the
    acquired prefix-cache hit (refcounts released once the prompt
    commits and re-registers its chain)."""
    req: Request
    slot: int
    pos: int
    ext: dict
    prefix: PrefixHit | None = None


class _Phase:
    """One engine phase (a name of `telemetry.PHASES`), opened and closed
    by one bracket: the program's span (`runtime.trace`) and the
    telemetry hub's phase. ``args`` land in the hub's span (``count=0``
    elides it there)."""

    __slots__ = ("tel", "name", "args", "span")

    def __init__(self, tel, name: str, args: dict):
        assert name in PHASES, name
        self.tel, self.name, self.args = tel, name, args

    def __enter__(self):
        self.span = trace.span(self.name)
        self.span.__enter__()
        self.tel.phase_begin(self.name)
        return self

    def __exit__(self, *exc):
        self.tel.phase_end(**self.args)
        return self.span.__exit__(*exc)


@dataclasses.dataclass
class _SpillRec:
    """Host-side resume state of one preempted request: which RRAM lane
    holds its packed cache image, and the decode-loop scalars
    (position, last emitted token, occupancy lengths for the endurance
    audit) that restore re-pins to a slot."""
    lane: int
    pos: int
    tok: int
    prefill_len: int
    total_len: int


class Engine:
    """Continuous-batching serving engine over an InferenceBackend.

    ``chunk_tokens`` caps a single prefill chunk and ``token_budget``
    caps the total tokens per step (decode slots included); both default
    to the ``REPRO_SERVE_CHUNK_TOKENS`` / ``REPRO_SERVE_TOKEN_BUDGET``
    env knobs, then to None (whole-prompt chunks — the pre-StepPlan
    behavior). When only ``chunk_tokens`` is set, the budget defaults to
    ``chunk_tokens + num_slots`` (one chunk plus all decode slots per
    step). ``oversubscribe`` (>= 1; env ``REPRO_SERVE_OVERSUBSCRIBE``,
    0/None = off) relaxes the scheduler's DRAM admission gate by that
    factor, spill-lane-backed — the Cambricon-LLM/SLIM-style
    spill-to-dense-tier trade for serving beyond DRAM capacity.
    ``idle_offload_steps`` (>= 1; env ``REPRO_SERVE_IDLE_OFFLOAD_STEPS``,
    0/None = off) enables proactive idle cold-KV offload: a blocked
    equal-or-higher-priority waiter may park a runner resident at least
    that many decode steps into an RRAM lane (bit-exact, same machinery
    as preemption) and take its freed DRAM under the base byte gates.
    ``telemetry`` attaches a `serving.telemetry.Telemetry` hub (span
    tracer + tier-traffic ledger + gauges/decision log); None (default)
    installs the no-op `NullTelemetry`.

    ``paged`` (env ``REPRO_SERVE_PAGED``, default off) switches the
    admission gate from per-slot worst-case ``max_len`` byte charges to
    live block-granular charges (each resident prices its block-rounded
    prompt+generation span). ``prefix_cache`` (default = ``paged``, and
    implying it) additionally shares identical request prefixes through
    the host-side `serving.block_pool.BlockPool`: an admitted request
    whose token/patch prefix hashes to cached chains seeds its prefill
    workspace from the shared blocks and starts prefilling at the hit
    position — only the tail is computed (and charged) — while shared
    blocks take exactly ONE physical write regardless of how many
    requests reference them (the RRAM write-once discipline). The slot
    pool semantics are unchanged either way, so ``Engine(paged=False)``
    stays the exact parity oracle.

    ``charge_weights`` (env ``REPRO_SERVE_CHARGE_WEIGHTS``; default None
    = on iff the backend resolved weight streaming on) charges the
    backend's DRAM-resident weight working set
    (`backend.weight_bytes()[0]`) off the top of the scheduler's DRAM
    budget, so admission sees weights + KV, not KV alone — the gate that
    denies an over-budget resident model (`dram_weights`) and admits its
    weight-streamed twin, whose working set is only embeddings + head +
    the per-unit sliding windows."""

    def __init__(self, backend,
                 scheduler: FCFSScheduler | None = None,
                 platform=CHIME, clock=time.perf_counter,
                 token_budget: int | None = None,
                 chunk_tokens: int | None = None,
                 oversubscribe: float | None = None,
                 idle_offload_steps: int | None = None,
                 paged: bool | None = None,
                 prefix_cache: bool | None = None,
                 charge_weights: bool | None = None,
                 telemetry=None):
        self.backend: InferenceBackend = backend
        self.max_len = backend.max_len
        self.clock = clock
        self.pool = backend.make_pool()
        hot_b, cold_b = backend.slot_kv_bytes()
        if chunk_tokens is None:
            chunk_tokens = _env_int("REPRO_SERVE_CHUNK_TOKENS")
        if token_budget is None:
            token_budget = _env_int("REPRO_SERVE_TOKEN_BUDGET")
        if oversubscribe is None:
            env_v = _env_float("REPRO_SERVE_OVERSUBSCRIBE")
            if env_v is not None and env_v != 0 and env_v < 1:
                # env-knob contract: never wedge startup on a bad value
                warnings.warn(f"ignoring REPRO_SERVE_OVERSUBSCRIBE="
                              f"{env_v} < 1")
                env_v = None
            oversubscribe = env_v
        if idle_offload_steps is None:
            idle_offload_steps = _env_int("REPRO_SERVE_IDLE_OFFLOAD_STEPS")
        # 0 is the explicit "disable" sentinel for both knobs (whole
        # prompts / unbounded budget — even when the env knob is set).
        # An explicitly unbounded budget is NOT rebound to the
        # chunk+slots default.
        for name, v in (("chunk_tokens", chunk_tokens),
                        ("token_budget", token_budget)):
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0 or None, got {v}")
        if oversubscribe is not None and oversubscribe != 0 \
                and oversubscribe < 1:
            raise ValueError(f"oversubscribe must be >= 1 (or 0/None to "
                             f"disable), got {oversubscribe}")
        oversubscribe = oversubscribe or None    # 0 = explicit disable
        if idle_offload_steps is not None and idle_offload_steps < 0:
            raise ValueError(f"idle_offload_steps must be >= 0 or None, "
                             f"got {idle_offload_steps}")
        idle_offload_steps = idle_offload_steps or None  # 0 = disable
        explicit_unbounded = token_budget == 0
        chunk_tokens = chunk_tokens or None
        token_budget = token_budget or None
        if (token_budget is None and not explicit_unbounded
                and chunk_tokens is not None):
            token_budget = chunk_tokens + backend.num_slots
        # ---- paged accounting + prefix cache -------------------------
        if paged is None:
            paged = bool(_env_int("REPRO_SERVE_PAGED"))
        if prefix_cache is None:
            prefix_cache = paged
        self.prefix_cache = bool(prefix_cache)
        self.paged = bool(paged) or self.prefix_cache   # cache implies it
        self.block_pool: BlockPool | None = None
        self._probed: dict[int, PrefixHit] = {}
        self._prefix_block_bytes = 0
        if self.prefix_cache:
            if not (hasattr(backend, "prefix_blocks")
                    and hasattr(backend, "block_tokens")):
                raise ValueError(
                    "prefix_cache/paged needs a backend with the prefix "
                    "block surface (prefix_blocks/block_tokens)")
            self.block_pool = BlockPool(backend.prefix_blocks,
                                        backend.block_tokens)
            self._prefix_block_bytes = backend.prefix_block_bytes()
        # a PR-2/3-era custom backend predates the spill surface: degrade
        # to preemption-disabled instead of crashing on the missing attr
        n_spill = getattr(backend, "n_spill", 0)
        lane_fn = getattr(backend, "spill_lane_bytes", None)
        lane_b = lane_fn() if callable(lane_fn) else hot_b + cold_b
        # ---- DRAM weight working-set charge --------------------------
        # charge_weights: explicit arg > REPRO_SERVE_CHARGE_WEIGHTS env >
        # on-iff-the-backend-streams default. The charge makes the DRAM
        # admission gate see the resident weight working set, not just
        # KV — which is what actually denies an over-budget resident
        # model and admits its streamed twin. Backends without the
        # weight surface (custom PR-era executors) degrade to the legacy
        # KV-only gates.
        if charge_weights is None:
            env_cw = _env_int("REPRO_SERVE_CHARGE_WEIGHTS")
            charge_weights = None if env_cw is None else bool(env_cw)
        wb_fn = getattr(backend, "weight_bytes", None)
        if charge_weights is None:
            charge_weights = bool(getattr(backend, "weight_stream", 0))
        self.charge_weights = bool(charge_weights) and callable(wb_fn)
        weight_b = float(wb_fn()[0]) if self.charge_weights else None
        if scheduler is None:
            scheduler = FCFSScheduler(CapacityBudget.from_platform(platform),
                                      hot_b, cold_b,
                                      token_budget=token_budget,
                                      chunk_tokens=chunk_tokens,
                                      oversubscribe=oversubscribe,
                                      spill_lanes=n_spill,
                                      idle_offload_steps=idle_offload_steps,
                                      lane_bytes=lane_b,
                                      weight_bytes=weight_b)
        elif not isinstance(scheduler, FCFSScheduler) or (
                type(scheduler).plan is not FCFSScheduler.plan):
            pass  # custom planner: it owns its own chunking policy
        else:
            # apply resolved knobs to a provided base-plan scheduler so
            # Engine(..., scheduler=..., chunk_tokens=N) and the
            # REPRO_SERVE_* env forcing are not silently dropped; the
            # scheduler's own explicitly-set knobs win
            if scheduler.chunk_tokens is None and chunk_tokens is not None:
                scheduler.chunk_tokens = chunk_tokens
            if scheduler.token_budget is None and token_budget is not None:
                scheduler.token_budget = token_budget
            if scheduler.oversubscribe is None \
                    and oversubscribe is not None:
                scheduler.oversubscribe = oversubscribe
            if scheduler.spill_lanes is None:
                scheduler.spill_lanes = n_spill
            if scheduler.idle_offload_steps is None \
                    and idle_offload_steps is not None:
                scheduler.idle_offload_steps = idle_offload_steps
            if scheduler.lane_bytes is None:
                scheduler.lane_bytes = lane_b
            if scheduler.weight_bytes is None and weight_b is not None:
                scheduler.weight_bytes = weight_b
        if self.paged:
            # live-block charges + prefix probing: back-fill only unset
            # hooks so a custom scheduler's own policy wins
            if getattr(scheduler, "charge_fn", None) is None:
                try:
                    scheduler.charge_fn = self._charge
                except AttributeError:
                    pass                       # __slots__ scheduler
            if self.prefix_cache \
                    and getattr(scheduler, "prefix_probe", None) is None:
                try:
                    scheduler.prefix_probe = self._probe
                except AttributeError:
                    pass
            if getattr(scheduler, "shared_bytes_fn", None) is None:
                try:
                    scheduler.shared_bytes_fn = self._shared_bytes
                except AttributeError:
                    pass
        self.scheduler = scheduler
        # one-release compat: a PR-3-era custom plan() override that does
        # not accept the preemption kwargs (running/free_lanes) still
        # plans — it just never preempts; warn so it migrates
        try:
            params_ = inspect.signature(type(scheduler).plan).parameters
            self._plan_preemptive = (
                "running" in params_ and "free_lanes" in params_) or any(
                p.kind is p.VAR_KEYWORD for p in params_.values())
        except (TypeError, ValueError):
            self._plan_preemptive = False
        if not self._plan_preemptive:
            warnings.warn(
                "scheduler.plan() does not accept running=/free_lanes=; "
                "the engine will plan without preemption. Accept those "
                "keywords to enable it",
                DeprecationWarning, stacklevel=2)
        if scheduler.max_concurrent < 1:
            wb = getattr(scheduler, "weight_bytes", None) or 0
            wmsg = (f" plus the {wb:.3e}-byte DRAM-resident weight "
                    f"working set" if wb else "")
            raise ValueError(
                f"one slot's KV state ({hot_b} hot + {cold_b} cold bytes)"
                f"{wmsg} exceeds the domain budgets; nothing can be "
                f"admitted")
        # num_slots beyond the byte budgets is allowed but idle: admission
        # is gated per-request by the scheduler, so effective concurrency
        # is min(num_slots, scheduler.max_concurrent)

        # ---- per-slot host state -------------------------------------
        n = backend.num_slots
        self._slot_req: list[Request | None] = [None] * n
        self._tok = np.zeros((n, 1), np.int32)
        self._pos = np.zeros((n,), np.int32)
        self._active = np.zeros((n,), bool)
        # lengths of the CURRENT/LAST occupant (endurance audit input)
        self._slot_prefill_len = [0] * n
        self._slot_total_len = [0] * n
        self._inflight: _Inflight | None = None
        self._spilled: dict[int, _SpillRec] = {}    # rid -> resume state
        self.finished: list[Request] = []
        self._next_rid = 0
        self.stats = {"steps": 0, "prefill_chunks": 0, "extend_calls": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "evictions": 0, "restores": 0, "idle_offloads": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0}

        # ---- telemetry (opt-in; None = no-op hooks, <2% contract) ----
        self.telemetry = telemetry if telemetry is not None \
            else NullTelemetry()
        if self.telemetry.enabled:
            ctx_fn = getattr(backend, "sim_context", None)
            t_cfg, t_comp = ctx_fn() if callable(ctx_fn) else (None, False)
            self.telemetry.bind(cfg=t_cfg, spill_compressed=t_comp,
                                clock=self.clock, platform=platform,
                                on_snapshot=self.endurance_report,
                                fused_decode=getattr(
                                    backend, "fused_decode", None),
                                sparse_read_tau=getattr(
                                    backend, "sparse_read_tau", None),
                                weight_stream=(
                                    None if getattr(backend,
                                                    "weight_stream", None)
                                    is None
                                    else bool(backend.weight_stream)))
            # the scheduler logs decision codes through the same hub; a
            # user-built scheduler that already carries one keeps it
            if getattr(self.scheduler, "telemetry", None) is None:
                try:
                    self.scheduler.telemetry = self.telemetry
                except AttributeError:
                    pass                       # __slots__ scheduler

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> Request:
        if req.total_len > self.max_len:
            raise ValueError(
                f"request needs {req.total_len} positions > pool max_len "
                f"{self.max_len}")
        if req.rid is None or req.rid < 0:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid + 1)
        req.arrival_s = self.clock()
        self.scheduler.submit(req)
        self.telemetry.request_submitted(req)
        return req

    # ------------------------------------------------------------------
    # paged accounting + prefix cache hooks (scheduler callbacks)
    # ------------------------------------------------------------------
    def _probe(self, req: Request) -> int:
        """Prefix-cache probe for the queue head: longest cached chain
        matching the request's token/patch prefix, usable at the
        backend's prefill grid. Probes are memoized per step (the charge
        and the admission start position must see the SAME hit) and pin
        their blocks against eviction for the step without refcounting —
        a denied admission must not leak references."""
        if self.block_pool is None:
            return 0
        if req.rid in self._probed:
            return self._probed[req.rid].length
        hit = self.block_pool.lookup(
            request_prefix_keys(req), max_hit=req.prompt_len - 1,
            require_state=self.backend.requires_exact_prefill,
            grid=self.backend.chunk_unit)
        self._probed[req.rid] = hit
        return hit.length

    def _charge(self, req: Request) -> tuple[int, int]:
        """(hot, cold) bytes this request charges the byte gates: its
        block-rounded total span, net of the FULL blocks its prefix hit
        covers (those live in the shared store, charged once via
        `_shared_bytes` no matter how many requests reference them)."""
        hit = 0
        if self.block_pool is not None:
            bt = self.backend.block_tokens
            hit = (self._probe(req) // bt) * bt
        return self.backend.slot_kv_bytes(
            length=max(req.total_len - hit, 1))

    def _shared_bytes(self) -> int:
        """Bytes the shared prefix store pins in RRAM: only blocks held
        by a live admission count. Unreferenced cached blocks are
        reclaimable (the pool LRU-evicts them when `register` runs dry),
        so charging them would wedge admission behind a cache that
        nothing ever shrinks."""
        if self.block_pool is None:
            return 0
        return self.block_pool.pinned_blocks * self._prefix_block_bytes

    # ------------------------------------------------------------------
    # prefill chunks
    # ------------------------------------------------------------------
    def _pad_target(self, valid: int, pos: int) -> int:
        """Chunk padding width: exact for recurrent architectures (padded
        rows would corrupt the carried states), the fixed chunk cap when
        chunking (one trace per modality), else the admission bucket (the
        seed's O(log max_prompt) trace bound). Never pads past the slot
        length so the workspace write stays in bounds."""
        if self.backend.requires_exact_prefill:
            return valid
        cap = getattr(self.scheduler, "chunk_tokens", None)
        if cap:
            return max(valid, min(cap, self.max_len - pos))
        return max(min(bucket_len(valid), self.max_len - pos), valid)

    def _chunk_batch(self, req: Request, kind: str, a: int, b: int,
                     pos: int) -> tuple[dict, int]:
        """Batch for the chunk covering absolute positions [a, b) of the
        prompt, single-modality by construction (``kind``). Right-pads to
        `_pad_target`; padded rows' K/V land beyond the chunk's valid
        length where they are never attendable and are overwritten by the
        next chunk."""
        valid = b - a
        target = self._pad_target(valid, pos)
        if kind == "patches":
            part = np.asarray(req.patches[a:b], np.float32)
            if target > valid:
                part = np.concatenate(
                    [part, np.zeros((target - valid,) + part.shape[1:],
                                    np.float32)])
            return {"patches": part[None]}, valid
        vis = 0 if req.patches is None else int(req.patches.shape[0])
        part = np.asarray(req.tokens[a - vis:b - vis], np.int32)
        if target > valid:
            part = np.concatenate(
                [part, np.zeros((target - valid,), np.int32)])
        return {"tokens": part[None]}, valid

    def _run_chunk(self, ch: PrefillChunk) -> list[tuple[int, int, bool]]:
        """Execute one planned chunk: allocate the slot on admission,
        split at the patch/text modality boundary, run the extend calls,
        and stream the first token when the prompt commits."""
        if ch.admit:
            slot = self.pool.alloc()
            self._inflight = _Inflight(req=ch.req, slot=slot, pos=0,
                                       ext=self.backend.fresh_extend())
            ch.req.admit_s = self.clock()
            self.telemetry.request_admitted(ch.req, slot)
            if ch.start > 0:
                self._adopt_prefix(ch)
        fl = self._inflight
        assert fl is not None and fl.req is ch.req and fl.pos == ch.start
        req = ch.req
        vis = 0 if req.patches is None else int(req.patches.shape[0])
        end = ch.start + ch.length
        parts: list[tuple[str, int, int]] = []
        if ch.start < vis:
            parts.append(("patches", ch.start, min(end, vis)))
        if end > vis:
            parts.append(("tokens", max(ch.start, vis), end))
        tok = None
        want_register = self.block_pool is not None and ch.commit
        full_ws = None
        for i, (kind, a, b) in enumerate(parts):
            commit = ch.commit and i == len(parts) - 1
            batch, valid = self._chunk_batch(req, kind, a, b, fl.pos)
            if commit and want_register:
                # the commit call folds the workspace into the slot and
                # returns the committed STORE form; registration needs
                # the complete workspace, so rerun the final chunk
                # uncommitted first (logits are identical either way)
                _, full_ws, _ = self.backend.extend_step(
                    batch, self.pool.state, fl.ext, fl.slot, fl.pos,
                    valid, False)
            tok, ext, state = self.backend.extend_step(
                batch, self.pool.state, fl.ext, fl.slot, fl.pos, valid,
                commit)
            if commit:
                self.pool.state = state
            else:
                fl.ext = ext
            fl.pos += valid
            self.stats["extend_calls"] += 1
        self.stats["prefill_chunks"] += 1
        if not ch.commit:
            return []
        if want_register:
            self._register_prefix(fl, full_ws)
        return self._commit(fl, int(tok))

    def _adopt_prefix(self, ch: PrefillChunk):
        """Seed the freshly-admitted prefill from its probed prefix-cache
        hit: acquire the chain (refcounts drop at registration), gather
        each hit block's workspace rows — and, for exact-prefill
        (recurrent) backends, the chain-terminal state snapshot — into
        the extend workspace, and resume prefill AT the hit position."""
        fl = self._inflight
        req = ch.req
        hit = self._probed.get(req.rid)
        assert hit is not None and hit.length == ch.start, \
            "admission start desynced from the probed prefix hit"
        pool = self.block_pool
        pool.acquire(hit)
        fl.prefix = hit
        self.pool.state = self.backend.ensure_prefix(self.pool.state)
        if self.backend.has_prefix_ws:
            for node in hit.nodes:
                fl.ext = self.backend.prefix_load_ws(
                    self.pool.state, fl.ext, node.bid, node.start)
        if self.backend.requires_exact_prefill:
            fl.ext = self.backend.prefix_load_state(
                self.pool.state, fl.ext, hit.nodes[-1].bid)
        fl.pos = ch.start
        req.prefix_hit = ch.start
        self.stats["prefix_hits"] += 1
        self.stats["prefix_hit_tokens"] += ch.start
        self.telemetry.decision("prefix_adopt", rid=req.rid,
                                hit_tokens=ch.start,
                                blocks=len(hit.nodes))

    def _register_prefix(self, fl: _Inflight, full_ws: dict):
        """Fold the committed prompt's prefix into the shared store:
        dedup against existing chains, write ONLY the new (diverging)
        blocks — each exactly once, the endurance contract — snapshot
        the recurrent state at the chain terminal when the backend needs
        exact resume points, and release the adopted hit's refcounts."""
        req, pool = fl.req, self.block_pool
        bt = self.backend.block_tokens
        self.pool.state = self.backend.ensure_prefix(self.pool.state)
        new, term = pool.register(request_prefix_keys(req),
                                  max_start=self.max_len - bt)
        for node in new:
            if self.backend.has_prefix_ws:
                self.pool.state = self.backend.prefix_save_ws(
                    self.pool.state, full_ws, node.bid, node.start)
            pool.note_write(node.bid)
        if (self.backend.requires_exact_prefill and term is not None
                and not term.has_state and term.end == req.prompt_len
                and term.end % self.backend.chunk_unit == 0):
            self.pool.state = self.backend.prefix_save_state(
                self.pool.state, full_ws, term.bid)
            pool.note_write(term.bid)
            term.has_state = True
        if fl.prefix is not None:
            if fl.prefix.partial and new:
                pool.stats["cow_copies"] += 1
            pool.release(fl.prefix)
            fl.prefix = None

    def _commit(self, fl: _Inflight, tok: int
                ) -> list[tuple[int, int, bool]]:
        req, slot = fl.req, fl.slot
        self._inflight = None
        tel = self.telemetry
        with self._phase("commit", rid=req.rid):
            req.first_token_s = self.clock()
            req.status = RUNNING
            req.emit(tok)
            req.token_times.append(self.clock())
            tel.request_first_token(req)
            # the slot's cache now holds this request's stores either
            # way; record its occupancy so the endurance audit stays
            # truthful
            self._slot_prefill_len[slot] = req.prompt_len
            self._slot_total_len[slot] = req.prompt_len
            if req.finished_by(tok):
                self._finish(req)        # 1-token request: retires at once
                self.pool.free(slot)
                return [(req.rid, tok, True)]
            req.slot = slot
            req.resident_steps = 0       # fresh residency (offload clock)
            self._slot_req[slot] = req
            self._tok[slot, 0] = tok
            self._pos[slot] = req.prompt_len
            self._active[slot] = True
        return [(req.rid, tok, False)]

    # ------------------------------------------------------------------
    # the step loop
    # ------------------------------------------------------------------
    def _finish(self, req: Request):
        req.status = FINISHED
        req.finish_s = self.clock()
        release = getattr(self.scheduler, "release", None)
        if callable(release):
            release(req)                 # retire its paged byte charge
        self.finished.append(req)
        self.telemetry.request_finished(req)

    def _retire(self, slot: int):
        req = self._slot_req[slot]
        self._finish(req)
        self._slot_req[slot] = None
        self._active[slot] = False
        req.slot = -1
        self.pool.free(slot)

    # ------------------------------------------------------------------
    # preemption: spill to RRAM / bit-exact restore
    # ------------------------------------------------------------------
    def _evict(self, req: Request, offload: bool = False):
        """Pack ``req``'s slot into a free RRAM spill lane and park it.
        The image is the slot's cache verbatim (plus the decode-loop
        scalars recorded host-side), so the later restore resumes decode
        token-for-token identically to a never-evicted run — unless the
        backend compresses spill lanes, in which case the hot ring pays
        the documented codec error. ``offload`` marks a proactive idle
        cold-KV offload (capacity) rather than a preemption (priority);
        the mechanics are identical, only the stats differ."""
        slot = req.slot
        assert slot >= 0 and self._slot_req[slot] is req \
            and self._active[slot]
        lane = self.pool.alloc_lane()
        ctx = int(self._pos[slot])
        self.pool.state = self.backend.evict_slot(self.pool.state, slot,
                                                  lane, ctx)
        self._spilled[req.rid] = _SpillRec(
            lane=lane, pos=ctx, tok=int(self._tok[slot, 0]),
            prefill_len=self._slot_prefill_len[slot],
            total_len=self._slot_total_len[slot])
        req.status = PREEMPTED
        req.slot = -1
        req.evict_times.append(self.clock())
        req.evict_ctx.append(ctx)
        req.n_idle_offloads += 1 if offload else 0
        self._slot_req[slot] = None
        self._active[slot] = False
        self.pool.free(slot)
        self.stats["idle_offloads" if offload else "evictions"] += 1
        self.telemetry.request_evicted(req, slot, lane, ctx, offload)

    def _restore(self, req: Request):
        """Scatter ``req``'s spill lane back into a (possibly different)
        free slot and rejoin decode at the exact position it left."""
        rec = self._spilled.pop(req.rid)
        slot = self.pool.alloc()
        self.pool.state = self.backend.restore_slot(self.pool.state,
                                                    rec.lane, slot)
        self.pool.release_lane(rec.lane)
        req.status = RUNNING
        req.slot = slot
        req.resident_steps = 0           # restored: a fresh time slice
        req.restore_times.append(self.clock())
        self._slot_req[slot] = req
        self._tok[slot, 0] = rec.tok
        self._pos[slot] = rec.pos
        self._active[slot] = True
        self._slot_prefill_len[slot] = rec.prefill_len
        self._slot_total_len[slot] = rec.total_len
        self.stats["restores"] += 1
        self.telemetry.request_restored(req, rec.lane, slot, rec.pos)

    def _phase(self, name: str, **args) -> _Phase:
        return _Phase(self.telemetry, name, args)

    @trace.traced("step")
    def step(self) -> list[tuple[int, int, bool]]:
        """Execute one StepPlan: spill evictions, restores, prefill
        chunks, then one decode token on every active slot. Returns
        streamed events: (rid, token, done).

        A plan is a commitment, not a peek: producing it pops admitted
        requests off the scheduler queue (and moves evicted/restored
        requests between the running and spilled sets), and this method
        executes every entry in it before decoding."""
        events: list[tuple[int, int, bool]] = []
        fl = self._inflight
        tel = self.telemetry
        tel.step_begin(self.stats["steps"])
        if self.block_pool is not None:
            # fresh pin epoch: this step's probes protect their blocks
            # from LRU eviction without taking refcounts
            self.block_pool.begin_epoch()
            self._probed.clear()
        with self._phase("plan") as ph:
            kwargs = {}
            if self._plan_preemptive:
                kwargs = dict(
                    running=tuple(r for r in self._slot_req
                                  if r is not None),
                    free_lanes=self.pool.free_lanes)
            plan = self.scheduler.plan(
                active_slots=self.pool.active_slots,
                decode_slots=int(self._active.sum()),
                free_slots=self.pool.free_slots,
                inflight=None if fl is None else (fl.req, fl.pos),
                chunk_unit=self.backend.chunk_unit, **kwargs)
            evictions = tuple(getattr(plan, "evictions", ()))
            offloads = tuple(getattr(plan, "offloads", ()))
            restores = tuple(getattr(plan, "restores", ()))
            ph.args["chunks"] = len(plan.chunks)
        with self._phase("evict", count=len(evictions)):
            for req in evictions:
                self._evict(req)
        with self._phase("idle-offload", count=len(offloads)):
            for req in offloads:
                self._evict(req, offload=True)
        with self._phase("restore", count=len(restores)):
            for req in restores:
                self._restore(req)
        with self._phase("chunk-prefill", count=len(plan.chunks)):
            for ch in plan.chunks:
                events.extend(self._run_chunk(ch))
        self.stats["steps"] += 1
        # plan.decode is the planner's say (a custom planner may dedicate
        # a step to prefill); _active is the physical guard
        if not plan.decode or not self._active.any():
            tel.step_end(self._gauges() if tel.enabled else None)
            return events
        with self._phase("decode") as ph:
            trace.count("decode.phases")
            ntoks, self.pool.state = self.backend.decode_step(
                self._tok, self.pool.state, self._pos, self._active)
            ntoks = np.asarray(ntoks)
            self.stats["decode_steps"] += 1
            n_emitted = 0
            for slot in np.nonzero(self._active)[0]:
                req = self._slot_req[slot]
                tok = int(ntoks[slot])
                req.emit(tok)
                req.token_times.append(self.clock())
                tel.token(req)
                req.resident_steps += 1
                self._pos[slot] += 1
                self._slot_total_len[slot] += 1
                self._tok[slot, 0] = tok
                self.stats["decode_tokens"] += 1
                n_emitted += 1
                done = req.finished_by(tok)
                events.append((req.rid, tok, done))
                if done:
                    self._retire(int(slot))
            ph.args["count"] = n_emitted
        tel.step_end(self._gauges() if tel.enabled else None)
        return events

    def _gauges(self) -> dict:
        """Occupancy/queue snapshot for the telemetry hub (built only
        when telemetry is enabled)."""
        queue = getattr(self.scheduler, "_queue", ())
        depth: dict[int, int] = {}
        for r in queue:
            depth[r.priority] = depth.get(r.priority, 0) + 1
        g = {
            "slots_total": self.backend.num_slots,
            "slots_active": self.pool.active_slots,
            "slots_free": self.pool.free_slots,
            "slots_decoding": int(self._active.sum()),
            "lanes_free": self.pool.free_lanes,
            "spilled_requests": len(self._spilled),
            "inflight": 0 if self._inflight is None else 1,
            "queue_depth": depth,
        }
        if self.block_pool is not None:
            bp = self.block_pool
            g.update(
                prefix_blocks_used=bp.used_blocks,
                prefix_blocks_free=bp.free_blocks,
                prefix_max_refcount=bp.max_refcount,
                prefix_hits=self.stats["prefix_hits"],
                prefix_hit_tokens=self.stats["prefix_hit_tokens"],
                prefix_cow_copies=bp.stats["cow_copies"],
                prefix_blocks_registered=bp.stats["blocks_registered"],
                prefix_blocks_evicted=bp.stats["blocks_evicted"],
            )
        return g

    @property
    def idle(self) -> bool:
        """True when nothing is queued, prefilling, decoding or parked
        in the spill store."""
        return not (self.scheduler.pending or self.pool.active_slots
                    or self._inflight is not None or self._spilled)

    def run(self, requests=None, max_steps: int | None = None
            ) -> list[Request]:
        """Drain: submit ``requests`` (if given) and step until queue,
        in-flight prefill and slots are empty. Returns the finished
        requests in completion order. Raises once ``max_steps`` steps
        have run without draining."""
        for r in requests or ():
            self.submit(r)
        start = len(self.finished)
        steps = 0
        while not self.idle:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} "
                                   f"steps")
            self.step()
            steps += 1
        return self.finished[start:]

    # ------------------------------------------------------------------
    # reports
    # ------------------------------------------------------------------
    def endurance_report(self) -> dict:
        rep = self.pool.endurance_report(
            self._slot_prefill_len, self._slot_total_len,
            self.backend.hot_window)
        rep["spills"] = self.stats["evictions"] \
            + self.stats["idle_offloads"]
        rep["preemptions"] = self.stats["evictions"]
        rep["idle_offloads"] = self.stats["idle_offloads"]
        rep["restores"] = self.stats["restores"]
        return rep
