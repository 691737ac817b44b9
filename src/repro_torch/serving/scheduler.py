"""Step-plan scheduling: FCFS + capacity-gated admission + Sarathi-style
chunked prefill under a per-step token budget.

CHIME's two memory domains cap concurrency independently: every admitted
request pins a bf16 hot ring (+ recurrent states) in the M3D DRAM stack
and an int8 cold prefix (+ scales) in the write-once RRAM tier. The
scheduler derives byte budgets from the `simulator/hardware.py` domain
capacities and admits the queue head only while BOTH domains have room —
so a bigger hot window or longer max_len genuinely buys fewer concurrent
requests, the same trade the paper's Table III/IV capacities impose.

Since PR 3 the scheduler emits a `StepPlan` per engine step instead of
popping whole requests: each step gets ``token_budget`` tokens, decode
slots take one each, and the remainder goes to in-flight prefill chunks
of at most ``chunk_tokens`` positions (the paper's long-vision-prompt
workloads no longer stall every decode slot for a whole prompt). Ordering
stays strictly FCFS — one prompt prefills at a time, and the queue head
is admitted (slot + byte budgets permitting) only once the previous
prompt committed. Defaults (no budget, no chunk cap) reproduce the PR 1/2
admit-whole-prompt behavior exactly.

Since PR 4 the scheduler is PREEMPTIVE under oversubscription: requests
carry a ``priority`` (higher runs first; FCFS within a class), and when
the queue head outranks a running request while no slot is free, the
plan evicts the lowest-priority, most-recently-admitted victim into an
RRAM spill lane (`StepPlan.evictions`) and later restores it bit-exactly
(`StepPlan.restores`) once capacity frees. ``oversubscribe`` relaxes the
DRAM admission gate by that factor — the marginal resident's bulk KV is
RRAM-resident cold tier, and the overflow must be covered by free spill
lanes so any overflow slot can always be paged out (Cambricon-LLM/SLIM-
style spill-to-dense-tier serving beyond DRAM capacity).

Since PR 5 RRAM is a first-class CAPACITY tier, not just a preemption
parking lot: with ``idle_offload_steps=N`` set, a waiter that cannot get
in (and does not strictly outrank anyone — so PR 4 preemption did not
fire) may still be admitted by OFFLOADING a runner that has been
resident >= N decode steps (`StepPlan.offloads` — the same verbatim,
bit-exact evict/restore machinery; equal-priority rotation is
RRAM-backed time slicing with quantum N). The freed DRAM hot bytes admit
the waiter under the BASE byte gates — no all-or-nothing oversubscribe
factor. ``lane_bytes`` is what one parked image charges against the
RRAM budget: compressed lanes (int8 hot ring, see `core/quant.py`)
shrink it, which is how a fixed RRAM spill budget backs more lanes.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.serving.request import Request
from repro_torch.simulator.hardware import CHIME, Platform


@dataclasses.dataclass(frozen=True)
class CapacityBudget:
    """KV byte budgets per memory domain."""
    dram_bytes: float
    rram_bytes: float

    @classmethod
    def from_platform(cls, platform: Platform = CHIME,
                      kv_fraction: float = 0.5) -> "CapacityBudget":
        """Reserve ``kv_fraction`` of each domain for KV state (the rest
        holds weights and activations; the paper keeps FFN weights
        resident in RRAM and attention weights in DRAM)."""
        dram = platform.domains["dram"].capacity_bytes * kv_fraction
        rram_dom = platform.domains.get("rram", platform.domains["dram"])
        rram = rram_dom.capacity_bytes * kv_fraction
        return cls(dram, rram)

    def max_concurrent(self, hot_bytes_per_slot: int,
                       cold_bytes_per_slot: int, *,
                       weight_bytes: float = 0.0) -> int:
        """Largest slot count both domains can hold simultaneously.
        ``weight_bytes`` (the DRAM-resident weight working set) comes off
        the top of the DRAM budget before any KV slot charges it."""
        dram = self.dram_bytes - weight_bytes
        if dram < 0:
            return 0
        lim = float("inf")
        if hot_bytes_per_slot > 0:
            lim = min(lim, dram // hot_bytes_per_slot)
        if cold_bytes_per_slot > 0:
            lim = min(lim, self.rram_bytes // cold_bytes_per_slot)
        return int(lim) if lim != float("inf") else 2 ** 30

    def admits(self, n_resident: int, hot_bytes_per_slot: int,
               cold_bytes_per_slot: int, *, oversubscribe: float = 1.0,
               spilled: int = 0, spill_lanes: int = 0,
               spilled_bytes: float = 0.0,
               weight_bytes: float = 0.0) -> bool:
        """Can an (n_resident+1)-th request's KV state fit?

        ``oversubscribe`` scales the DRAM gate (>= 1): residents beyond
        the base DRAM capacity are spill-backed, so the overflow plus the
        ``spilled`` requests already parked in RRAM must fit in
        ``spill_lanes`` lanes, and ``spilled_bytes`` (the parked images)
        counts against the RRAM budget alongside the cold tiers.
        ``weight_bytes`` is the DRAM-resident weight working set — it is
        NOT spill-backed, so it shrinks the DRAM budget before the
        oversubscribe factor applies."""
        return self.deny_reason(
            n_resident, hot_bytes_per_slot, cold_bytes_per_slot,
            oversubscribe=oversubscribe, spilled=spilled,
            spill_lanes=spill_lanes, spilled_bytes=spilled_bytes,
            weight_bytes=weight_bytes) is None

    def deny_reason(self, n_resident: int, hot_bytes_per_slot: int,
                    cold_bytes_per_slot: int, *,
                    oversubscribe: float = 1.0, spilled: int = 0,
                    spill_lanes: int = 0,
                    spilled_bytes: float = 0.0,
                    weight_bytes: float = 0.0) -> str | None:
        """`admits`, but naming WHICH gate blocks: ``dram_weights``
        (the weight working set alone overflows DRAM — nothing can ever
        be admitted; stream the weights instead), ``dram_budget``,
        ``spill_lanes`` or ``rram_budget`` (None = admissible) — the
        telemetry decision log's admission-denial reason codes."""
        hot, cold = hot_bytes_per_slot, cold_bytes_per_slot
        dram = self.dram_bytes - weight_bytes
        if dram < 0:
            return "dram_weights"
        n = n_resident + 1
        if n * hot > dram * oversubscribe:
            return "dram_budget"
        if hot > 0 and oversubscribe > 1.0:
            overflow = n - int(dram // hot)
            if overflow > 0 and overflow + spilled > spill_lanes:
                return "spill_lanes"
        if n * cold + spilled_bytes > self.rram_bytes:
            return "rram_budget"
        return None

    def deny_reason_bytes(self, hot_bytes: float, cold_bytes: float, *,
                          hot_unit: int = 0, oversubscribe: float = 1.0,
                          spilled: int = 0, spill_lanes: int = 0,
                          spilled_bytes: float = 0.0,
                          weight_bytes: float = 0.0) -> str | None:
        """`deny_reason` for LIVE byte totals instead of uniform per-slot
        worst cases: the paged pool charges each resident its block-
        rounded prompt+generation footprint, so the gate compares the
        summed hot/cold bytes (candidate included) directly against the
        domain budgets. ``hot_unit`` (one full slot's hot bytes) converts
        DRAM overflow into spill-lane slots for the oversubscribe gate."""
        dram = self.dram_bytes - weight_bytes
        if dram < 0:
            return "dram_weights"
        if hot_bytes > dram * oversubscribe:
            return "dram_budget"
        if hot_unit > 0 and oversubscribe > 1.0:
            over = hot_bytes - dram
            overflow = int(-(-over // hot_unit)) if over > 0 else 0
            if overflow > 0 and overflow + spilled > spill_lanes:
                return "spill_lanes"
        if cold_bytes + spilled_bytes > self.rram_bytes:
            return "rram_budget"
        return None


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    """One planned extend call: ``length`` prompt positions of ``req``
    starting at absolute position ``start``. ``admit`` means the request
    enters prefill with this chunk (the engine allocates its pool slot
    first); ``commit`` means the chunk completes the prompt (the backend
    folds the workspace into the slot and the first token streams)."""
    req: Request
    admit: bool
    start: int
    length: int
    commit: bool


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The work one engine step executes, in order: spill ``evictions``
    (victim slots pack into RRAM lanes), ``restores`` (spilled requests
    scatter back into freed slots and rejoin decode this step), prefill
    chunks (in FCFS order, at most one request in flight at a time), then
    one decode token on every active slot. ``decode`` is True when the
    step is expected to decode — slots were already active (surviving the
    evictions), a restore re-activates one, or a committing chunk
    activates one this step."""
    chunks: tuple[PrefillChunk, ...]
    decode: bool
    evictions: tuple = ()         # Requests leaving their slot for a lane
    restores: tuple = ()          # Requests resuming from a lane
    offloads: tuple = ()          # idle residents parking for a waiter
    #   (executed exactly like evictions; split out so the engine's
    #   preemption and capacity-offload stats stay distinguishable —
    #   at most ONE of evictions/offloads is non-empty per plan)

    @property
    def prefill_tokens(self) -> int:
        return sum(c.length for c in self.chunks)


class FCFSScheduler:
    """Priority + first-come-first-served StepPlan producer gated by the
    capacity budget and a per-step token budget.

    The queue orders by (priority desc, arrival) — strictly FCFS within
    a priority class: if the head does not fit, nothing is admitted (no
    starvation of large requests by small ones), and a new prompt starts
    prefilling only after the in-flight one commits.

    ``token_budget`` caps the total tokens one step computes (each active
    decode slot costs 1; the remainder feeds prefill chunks).
    ``chunk_tokens`` caps a single prefill chunk. Both default to None
    (unbounded / whole-prompt chunks — the pre-StepPlan behavior).

    ``oversubscribe`` (>= 1, None = engine-resolved, default off) relaxes
    the DRAM admission gate by that factor, spill-lane-backed (see
    `CapacityBudget.admits`). ``spill_lanes`` (None = engine fills it
    from the backend) bounds simultaneous preemptions; when a waiter
    strictly outranks a running request and no slot is free, `plan`
    evicts the lowest-priority, most-recently-admitted victim.

    ``idle_offload_steps`` (>= 1, None = engine-resolved, default off)
    enables proactive idle cold-KV offload: a blocked waiter of EQUAL or
    higher priority may park a runner resident >= that many decode steps
    (see the module docstring). ``lane_bytes`` (None = engine fills it
    from the backend; falls back to one full slot image) is the RRAM
    bytes one parked spill image charges against the budget.

    ``charge_fn`` (None = per-slot worst case) switches the byte gates
    to PAGED accounting: it maps a request to its (hot, cold) byte
    charge — the engine supplies block-rounded prompt+generation bytes
    net of the request's prefix-cache hit — and the scheduler sums live
    charges across residents (admit adds, park subtracts, restore
    re-adds, `release` retires) instead of multiplying a uniform slot
    worst case. ``prefix_probe`` (None = no prefix cache) is called on
    the queue head right before its admission check and returns the
    cached-prefix hit length; the head's first chunk then STARTS at that
    position, so only the tail charges the step token budget.
    ``shared_bytes_fn`` reports the prefix store's *pinned* bytes
    (blocks referenced by a live admission — unreferenced cached blocks
    are reclaimable and must not gate admission), charged against the
    RRAM budget alongside parked spill images.

    ``weight_bytes`` (None = engine fills it from the backend when
    weight charging is on; None/0 reproduces the legacy KV-only gates)
    is the DRAM-resident weight working set, charged off the top of the
    DRAM budget before any KV byte gate — weight streaming shrinks it to
    embeddings + head + the per-unit sliding windows, which is what lets
    an over-budget model through the gate at all (deny reason
    ``dram_weights`` when the weights alone overflow the domain).
    """

    def __init__(self, budget: CapacityBudget, hot_bytes_per_slot: int,
                 cold_bytes_per_slot: int,
                 token_budget: int | None = None,
                 chunk_tokens: int | None = None,
                 oversubscribe: float | None = None,
                 spill_lanes: int | None = None,
                 idle_offload_steps: int | None = None,
                 lane_bytes: int | None = None,
                 charge_fn=None, prefix_probe=None,
                 shared_bytes_fn=None,
                 weight_bytes: float | None = None):
        if chunk_tokens is not None and chunk_tokens < 1:
            # a cap < 1 would make plan() emit degenerate chunks forever
            raise ValueError(f"chunk_tokens must be >= 1 or None, got "
                             f"{chunk_tokens}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1 or None, got "
                             f"{token_budget}")
        if oversubscribe is not None and oversubscribe < 1:
            raise ValueError(f"oversubscribe must be >= 1 or None, got "
                             f"{oversubscribe}")
        if weight_bytes is not None and weight_bytes < 0:
            raise ValueError(f"weight_bytes must be >= 0 or None, got "
                             f"{weight_bytes}")
        if idle_offload_steps is not None and idle_offload_steps < 1:
            # < 1 would offload a request the same step it got its slot:
            # zero guaranteed progress per rotation = potential livelock
            raise ValueError(f"idle_offload_steps must be >= 1 or None, "
                             f"got {idle_offload_steps}")
        self.budget = budget
        self.hot_bytes_per_slot = hot_bytes_per_slot
        self.cold_bytes_per_slot = cold_bytes_per_slot
        self.token_budget = token_budget
        self.chunk_tokens = chunk_tokens
        self.oversubscribe = oversubscribe
        self.spill_lanes = spill_lanes
        self.idle_offload_steps = idle_offload_steps
        self.lane_bytes = lane_bytes
        self.charge_fn = charge_fn
        self.prefix_probe = prefix_probe
        self.shared_bytes_fn = shared_bytes_fn
        # DRAM-resident weight working set charged off the top of the
        # DRAM budget (None = engine fills it from the backend when
        # weight charging is on; stays None -> charges 0, the legacy
        # KV-only accounting)
        self.weight_bytes = weight_bytes
        # paged accounting: admission-time (hot, cold) charge per resident
        # rid; parked requests keep their entry (sums drop, re-add on
        # restore) so the round trip is charge-neutral
        self._charges: dict[int, tuple[int, int]] = {}
        self._charged_hot = 0
        self._charged_cold = 0
        self._queue: collections.deque[Request] = collections.deque()
        self._spilled: list[Request] = []
        self.admitted = 0
        self._seq = 0                 # admission recency (victim pick)
        # decision-log sink: the engine attaches its Telemetry hub here
        # (None = no logging; `_note` is then a cheap None check)
        self.telemetry = None

    def _note(self, code: str, req: Request | None = None, **args):
        """Log one scheduler decision (reason codes in
        `telemetry.REASON_CODES`) if a telemetry hub is attached."""
        if self.telemetry is not None:
            self.telemetry.decision(
                code, rid=None if req is None else req.rid, **args)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue by (priority desc, arrival): FCFS within a class."""
        pr = req.priority
        if not self._queue or self._queue[-1].priority >= pr:
            self._queue.append(req)
            return
        for i, q in enumerate(self._queue):
            if q.priority < pr:
                self._queue.insert(i, req)
                return
        self._queue.append(req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def spilled(self) -> int:
        return len(self._spilled)

    @property
    def _slot_bytes(self) -> int:
        return self.hot_bytes_per_slot + self.cold_bytes_per_slot

    # ---- paged (live-byte) charge bookkeeping ------------------------
    def _charge_of(self, req: Request | None) -> tuple[int, int]:
        """(hot, cold) bytes ``req`` charges: the stored admission-time
        value, a fresh ``charge_fn`` quote, or the slot worst case when
        no candidate is known."""
        if req is not None and req.rid in self._charges:
            return self._charges[req.rid]
        if req is not None and self.charge_fn is not None:
            return self.charge_fn(req)
        return (self.hot_bytes_per_slot, self.cold_bytes_per_slot)

    def _charge_admit(self, req: Request):
        if self.charge_fn is None:
            return
        h, c = self._charge_of(req)
        self._charges[req.rid] = (h, c)
        self._charged_hot += h
        self._charged_cold += c

    def _charge_drop(self, req: Request):
        """Park: the resident's bytes leave the live sums (entry kept
        for the symmetric re-add on restore)."""
        if self.charge_fn is None or req.rid not in self._charges:
            return
        h, c = self._charges[req.rid]
        self._charged_hot -= h
        self._charged_cold -= c

    def _charge_readd(self, req: Request):
        if self.charge_fn is None or req.rid not in self._charges:
            return
        h, c = self._charges[req.rid]
        self._charged_hot += h
        self._charged_cold += c

    def release(self, req: Request):
        """Retire a finished request's byte charge (engine calls this
        when the request leaves its slot for good). No-op in slot mode
        and for rids never charged."""
        if req.rid in self._charges:
            h, c = self._charges.pop(req.rid)
            self._charged_hot -= h
            self._charged_cold -= c

    def _admits(self, n_active: int, spilled_after: int,
                cand: Request | None = None,
                parked: Request | None = None) -> bool:
        """Byte/lane gate for one more resident, with ``spilled_after``
        requests (still) parked in the spill store."""
        return self._deny_reason(n_active, spilled_after, cand=cand,
                                 parked=parked) is None

    def _deny_reason(self, n_active: int, spilled_after: int,
                     cand: Request | None = None,
                     parked: Request | None = None) -> str | None:
        """`_admits` with the blocking gate named (None = admissible).

        Slot mode charges ``n_active + 1`` uniform worst cases. Charge
        mode (``charge_fn`` set) sums the live per-resident charges,
        minus ``parked`` (the victim this step would spill), plus the
        actual ``cand`` charge (worst case when the candidate is not
        known, e.g. `can_admit` probes)."""
        lane_b = (self._slot_bytes if self.lane_bytes is None
                  else self.lane_bytes)
        shared = (self.shared_bytes_fn() if self.shared_bytes_fn
                  is not None else 0)
        if self.charge_fn is None:
            return self.budget.deny_reason(
                n_active, self.hot_bytes_per_slot,
                self.cold_bytes_per_slot,
                oversubscribe=self.oversubscribe or 1.0,
                spilled=spilled_after,
                spill_lanes=self.spill_lanes or 0,
                spilled_bytes=spilled_after * lane_b + shared,
                weight_bytes=self.weight_bytes or 0.0)
        hot, cold = self._charged_hot, self._charged_cold
        if parked is not None:
            ph, pc = self._charge_of(parked)
            hot, cold = hot - ph, cold - pc
        ch, cc = self._charge_of(cand)
        return self.budget.deny_reason_bytes(
            hot + ch, cold + cc,
            hot_unit=self.hot_bytes_per_slot,
            oversubscribe=self.oversubscribe or 1.0,
            spilled=spilled_after,
            spill_lanes=self.spill_lanes or 0,
            spilled_bytes=spilled_after * lane_b + shared,
            weight_bytes=self.weight_bytes or 0.0)

    @property
    def max_concurrent(self) -> int:
        return self.budget.max_concurrent(
            self.hot_bytes_per_slot, self.cold_bytes_per_slot,
            weight_bytes=self.weight_bytes or 0.0)

    def can_admit(self, n_active: int) -> bool:
        return bool(self._queue) and self._admits(n_active, self.spilled)

    # ------------------------------------------------------------------
    def plan(self, *, active_slots: int, decode_slots: int,
             free_slots: int, inflight: tuple[Request, int] | None,
             chunk_unit: int = 1, running: tuple = (),
             free_lanes: int = 0) -> StepPlan:
        """Produce this step's work plan.

        ``active_slots`` counts resident requests (decoding + the one
        prefilling, which already pins a slot and its byte budgets);
        ``inflight`` is (request, next position) of the prompt currently
        prefilling, or None. ``chunk_unit`` comes from the backend: every
        non-final chunk is rounded to a multiple of it so recurrent
        architectures keep their canonical chunk grid (exact-length
        chunks; a chunk may overshoot the token budget by less than one
        unit rather than stall). ``running`` is the victim-candidate set
        (requests currently decoding; the in-flight prefill is never
        preempted) and ``free_lanes`` the spill lanes available.

        Planning is a COMMITMENT, not a peek: admissions pop the queue,
        evictions/offloads move the victim into the scheduler's spilled
        set, and restores pop it back — the engine executes every entry
        of the returned plan within the same step, in eviction ->
        offload -> restore -> chunk -> decode order."""
        evictions: list[Request] = []
        offloads: list[Request] = []
        restores: list[Request] = []
        victims = list(running)

        def best_waiter():
            """The best waiter that could take a freed slot this step:
            the spilled head, or the queue head when no prompt is in
            flight — whichever has the higher priority (the spilled head
            wins ties: it restores first). None = nobody is waiting."""
            cand = self._spilled[0] if self._spilled else None
            if self._queue and inflight is None:
                head = self._queue[0]
                if cand is None or head.priority > cand.priority:
                    cand = head
            return cand

        def park(victim, into):
            """Commit one victim to a spill lane: shared bookkeeping of
            phases 1/1b (the one-victim-per-step accounting must never
            diverge between preemption and idle offload)."""
            nonlocal free_lanes, free_slots, active_slots, decode_slots
            into.append(victim)
            victims.remove(victim)
            self._spill_insert(victim)
            self._charge_drop(victim)
            free_lanes -= 1
            free_slots += 1
            active_slots -= 1
            decode_slots -= 1

        # ---- phase 1: preemptive eviction --------------------------------
        # one victim per step: when the best waiter (spilled or queue
        # head) strictly outranks the weakest runner and cannot get in
        # as things stand — no free slot, OR the byte budgets block it —
        # spill the lowest-priority, most-recently-admitted runner.
        # Never evict unless the waiter would actually be admissible
        # with the victim parked (one fewer resident, one more spilled
        # image in RRAM): a useless eviction strands the victim and can
        # livelock the step loop.
        waiter_blocked = free_slots == 0 \
            or not self._admits(active_slots, self.spilled)
        if waiter_blocked and free_lanes > 0 and victims:
            waiter = best_waiter()
            if waiter is not None:
                victim = min(victims, key=lambda r: (r.priority,
                                                     -r.admit_seq))
                if victim.priority < waiter.priority \
                        and self._admits(active_slots - 1,
                                         self.spilled + 1,
                                         cand=waiter, parked=victim):
                    park(victim, evictions)
                    self._note("evict_priority", victim,
                               waiter_priority=waiter.priority)

        # ---- phase 1b: proactive idle cold-KV offload --------------------
        # RRAM as a capacity tier: when the waiter STILL cannot get in —
        # nobody strictly outranked anyone, so phase 1 did not fire —
        # any runner that has been resident >= idle_offload_steps decode
        # steps has had its time slice and may be parked for an equal-
        # or higher-priority waiter. Same victim pick, same admissibility
        # guard, same one-victim-per-step discipline as preemption; the
        # parked image restores FCFS once capacity frees, so at equal
        # priority this is RRAM-backed round-robin with quantum N. The
        # freed DRAM hot bytes admit the waiter under the BASE gates —
        # no oversubscribe factor involved.
        if self.idle_offload_steps is not None and not evictions:
            blocked = free_slots == 0 \
                or not self._admits(active_slots, self.spilled)
            if blocked and free_lanes > 0 and victims:
                waiter = best_waiter()
                if waiter is not None:
                    waiter_prio = waiter.priority
                    eligible = [
                        r for r in victims
                        if r.resident_steps >= self.idle_offload_steps
                        and r.priority <= waiter_prio]
                    victim = (min(eligible,
                                  key=lambda r: (r.priority,
                                                 -r.admit_seq))
                              if eligible else None)
                    if victim is not None \
                            and self._admits(active_slots - 1,
                                             self.spilled + 1,
                                             cand=waiter,
                                             parked=victim):
                        # the parking must actually BENEFIT a waiter:
                        # either the queue head takes the freed slot
                        # (phase 3), or the spilled head restores into
                        # it (phase 2) — which it only does if it sorts
                        # before the victim in restore order; otherwise
                        # the victim itself would bounce straight back
                        # next step, a useless RRAM round trip that
                        # starves the real waiter.
                        vkey = (-victim.priority, victim.admit_seq)
                        queue_takes = bool(self._queue) \
                            and inflight is None
                        head = self._spilled[0] if self._spilled else None
                        spill_takes = head is not None and \
                            (-head.priority, head.admit_seq) < vkey
                        if queue_takes or spill_takes:
                            park(victim, offloads)
                            self._note("offload_idle", victim,
                                       waiter_priority=waiter_prio)

        # ---- phase 2: restores ------------------------------------------
        # spilled requests resume in (priority, admission) order, but
        # yield free slots to a strictly higher-priority queue head that
        # can actually take them (it would otherwise evict them right
        # back — thrash). A head that outranks but is byte-blocked does
        # NOT hold the slot hostage: the restore proceeds, or the step
        # loop would never drain.
        while self._spilled and free_slots > 0:
            cand = self._spilled[0]
            if any(cand is e for e in evictions) \
                    or any(cand is o for o in offloads):
                break                     # never round-trip within a step
            if self._queue and inflight is None \
                    and self._queue[0].priority > cand.priority \
                    and self._admits(active_slots, self.spilled,
                                     cand=self._queue[0]):
                self._note("restore_yield", cand,
                           to_rid=self._queue[0].rid)
                break
            reason = self._deny_reason(active_slots, self.spilled - 1,
                                       cand=cand)
            if reason is not None:
                self._note("deny_restore_" + reason, cand)
                break
            restores.append(self._spilled.pop(0))
            self._charge_readd(restores[-1])
            self._note("restore", restores[-1])
            free_slots -= 1
            active_slots += 1
            decode_slots += 1             # a restored slot decodes now

        # ---- phase 3: admission + prefill chunks ------------------------
        chunks: list[PrefillChunk] = []
        budget = (float("inf") if self.token_budget is None
                  else self.token_budget - decode_slots)
        cap = self.chunk_tokens or float("inf")
        cur = inflight
        while budget > 0:
            admit = False
            if cur is None:
                if not self._queue:
                    break
                if free_slots <= 0:
                    self._note("deny_no_free_slot", self._queue[0])
                    break
                head = self._queue[0]
                # probe the prefix cache BEFORE the byte gate: the hit
                # shrinks the head's charge (charge_fn reads the same
                # probe result), and the admitted prefill starts at the
                # hit position — only the tail charges the token budget
                hit = (int(self.prefix_probe(head))
                       if self.prefix_probe is not None else 0)
                reason = self._deny_reason(active_slots, self.spilled,
                                           cand=head)
                if reason is not None:
                    self._note("deny_" + reason, head)
                    break
                req = self._queue.popleft()
                admit = True
                free_slots -= 1
                active_slots += 1
                self.admitted += 1
                req.admit_seq = self._seq
                self._seq += 1
                self._charge_admit(req)
                if hit:
                    self._note("admit", req, prefix_hit=hit)
                else:
                    self._note("admit", req)
                cur = (req, hit)
            req, p = cur
            remaining = req.prompt_len - p
            c = int(min(remaining, budget, cap))
            if c < remaining and chunk_unit > 1:
                c = (c // chunk_unit) * chunk_unit or min(chunk_unit,
                                                          remaining)
            commit = (p + c) == req.prompt_len
            chunks.append(PrefillChunk(req, admit, p, c, commit))
            budget -= c
            cur = None if commit else (req, p + c)
        if self._queue and cur is None and free_slots > 0 \
                and budget <= 0:
            self._note("deny_token_budget", self._queue[0])
        return StepPlan(chunks=tuple(chunks),
                        decode=decode_slots > 0
                        or any(c.commit for c in chunks),
                        evictions=tuple(evictions),
                        restores=tuple(restores),
                        offloads=tuple(offloads))

    def _spill_insert(self, req: Request):
        """Park an evicted request, keeping the spilled set in
        (priority desc, admission asc) restore order."""
        key = (-req.priority, req.admit_seq)
        for i, q in enumerate(self._spilled):
            if (-q.priority, q.admit_seq) > key:
                self._spilled.insert(i, req)
                return
        self._spilled.append(req)
