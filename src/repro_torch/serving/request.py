"""Request dataclasses for the serving engine.

A request is a prompt (text token ids, optionally preceded by visual
patch embeddings for VQA traffic) plus decode limits. The engine mutates
the runtime fields in place as the request moves queue -> slot -> done.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                       # (S_text,) int32 prompt ids
    max_new_tokens: int
    patches: Optional[np.ndarray] = None     # (T_vis, frontend_dim) or None
    eos_id: Optional[int] = None
    on_token: Optional[Callable[["Request", int], Any]] = None
    # scheduling class: higher runs first, FCFS within a class; a
    # strictly higher-priority waiter may preempt a running request
    # (its KV state spills to RRAM and restores bit-exactly later)
    priority: int = 0

    # -- runtime state (engine-owned) ----------------------------------
    status: str = QUEUED
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    arrival_s: float = 0.0
    # engine-clock stamp of slot admission (0.0 = never admitted);
    # admit_s - arrival_s is the request's queue wait
    admit_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    # per-token emission timestamps (engine clock); diffs are the
    # request's time-between-tokens trace for the TBT percentiles
    token_times: list = dataclasses.field(default_factory=list)
    # scheduler-owned admission recency (victim tie-break)
    admit_seq: int = -1
    # decode steps taken since this request last got a slot (admission
    # or restore); the idle-offload policy's residency clock — a runner
    # is offloadable for an equal-priority waiter once it reaches the
    # scheduler's idle_offload_steps
    resident_steps: int = 0
    # spill trace: paired evict/restore timestamps (engine clock) and
    # the context length each spill packed into its lane — preemptions
    # AND idle offloads both land here (they share the machinery);
    # ``n_idle_offloads`` says how many of the events were offloads
    evict_times: list = dataclasses.field(default_factory=list)
    restore_times: list = dataclasses.field(default_factory=list)
    evict_ctx: list = dataclasses.field(default_factory=list)
    n_idle_offloads: int = 0
    # prompt positions adopted from the shared prefix cache at admission
    # (0 = cold prefill); the telemetry ledger and the simulated-
    # efficiency model both price only the prompt tail beyond this
    prefix_hit: int = 0

    @property
    def prompt_len(self) -> int:
        """Backbone positions consumed by the prompt (visual + text)."""
        vis = 0 if self.patches is None else self.patches.shape[0]
        return vis + int(self.tokens.shape[0])

    @property
    def has_image(self) -> bool:
        return self.patches is not None

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def done(self) -> bool:
        return self.status == FINISHED

    @property
    def n_evictions(self) -> int:
        """Total spill events (priority preemptions + idle offloads)."""
        return len(self.evict_times)

    @property
    def n_preemptions(self) -> int:
        """Spill events where a strictly higher-priority waiter forced
        this request out (excludes capacity-driven idle offloads)."""
        return len(self.evict_times) - self.n_idle_offloads

    def emit(self, token: int):
        self.generated.append(int(token))
        if self.on_token is not None:
            self.on_token(self, int(token))

    def finished_by(self, token: int) -> bool:
        """True if emitting ``token`` completes the request."""
        if self.eos_id is not None and int(token) == self.eos_id:
            return True
        return self.n_generated >= self.max_new_tokens


def make_synthetic_requests(cfg, n: int, prompt_len: int, gen_len: int,
                            seed: int = 0, image_every: int = 0,
                            jitter: int = 0,
                            priority_every: int = 0,
                            shared_prefix: int = 0) -> list[Request]:
    """A reproducible request stream for benchmarks/examples. Every
    ``image_every``-th request is a VQA request (visual patches + a text
    tail) when the config has a vision frontend; ``jitter`` varies prompt
    lengths +-jitter tokens to exercise bucketing; every
    ``priority_every``-th request is priority-1 interactive traffic
    (``priority_every=1`` marks all), so a saturated engine exercises
    preemption. ``shared_prefix`` > 0 makes every request open with the
    SAME ``shared_prefix`` leading prompt positions (one fixed system-
    prompt token run, and for VQA requests one fixed image) — the
    shared-system-prompt/shared-image stream the prefix cache is built
    for; tails stay per-request random so divergence is exercised."""
    rng = np.random.default_rng(seed)
    shared_toks = rng.integers(
        0, cfg.vocab_size, max(shared_prefix, 0)).astype(np.int32)
    shared_patches = None
    out = []
    for i in range(n):
        plen = prompt_len
        if jitter:
            plen = max(1, prompt_len + int(rng.integers(-jitter,
                                                        jitter + 1)))
        patches = None
        if image_every and cfg.frontend is not None \
                and i % image_every == 0:
            tv = cfg.frontend.num_tokens
            if shared_prefix:
                if shared_patches is None:
                    shared_patches = rng.standard_normal(
                        (tv, cfg.frontend.frontend_dim)).astype(
                            np.float32)
                patches = shared_patches
            else:
                patches = rng.standard_normal(
                    (tv, cfg.frontend.frontend_dim)).astype(np.float32)
            plen = max(1, plen - tv)
        toks = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        if shared_prefix:
            head = shared_toks[:min(shared_prefix, plen - 1)]
            toks[:head.shape[0]] = head
        prio = (1 if priority_every
                and i % priority_every == priority_every - 1 else 0)
        out.append(Request(rid=i, tokens=toks, max_new_tokens=gen_len,
                           patches=patches, priority=prio))
    return out
