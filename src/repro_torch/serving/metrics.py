"""Serving metrics: measured latency and throughput.

Wall-clock numbers (TTFT, per-request latency, aggregate tok/s) come from
the engine's clock. The simulated-efficiency half of the reference's
module (`simulated_efficiency`, priced by `chime_sim`) is not ported yet.

Partial metrics: a request that never emitted a token has no TTFT and a
request that never finished has no latency — those keys are simply
absent rather than computed from the dataclass' 0.0 defaults (which
yielded negative garbage). Evictions whose restore never happened are
excluded from restore-latency pairing and surfaced as
``unrestored_evictions``.
"""

from __future__ import annotations

import numpy as np


def _restore_latencies(req) -> np.ndarray:
    """Per-preemption spilled time: paired (restore - evict) gaps. An
    eviction whose restore has not happened yet is excluded."""
    n = min(len(req.evict_times), len(req.restore_times))
    return (np.asarray(req.restore_times[:n])
            - np.asarray(req.evict_times[:n]))


def request_metrics(req) -> dict:
    """Per-request metrics; partial for in-flight/never-run requests.

    ``ttft_s`` only exists once a first token was emitted, ``latency_s``
    only once the request finished — `Request` defaults both stamps to
    0.0, so subtracting a real arrival time from them is meaningless."""
    m = {
        "rid": req.rid,
        "prompt_len": req.prompt_len,
        "n_generated": req.n_generated,
        "finished": req.finish_s > 0.0,
        "priority": req.priority,
        "spills": req.n_evictions,
        "preemptions": req.n_preemptions,
        "idle_offloads": req.n_idle_offloads,
    }
    if req.prefix_hit > 0:
        m["prefix_hit_tokens"] = int(req.prefix_hit)
    if req.admit_s > 0.0:
        m["queue_s"] = req.admit_s - req.arrival_s
    if req.first_token_s > 0.0:
        m["ttft_s"] = req.first_token_s - req.arrival_s
    if req.finish_s > 0.0:
        m["latency_s"] = req.finish_s - req.arrival_s
    spilled = _restore_latencies(req)
    if spilled.size:
        m["spilled_s"] = float(spilled.sum())
    unrestored = len(req.evict_times) - len(req.restore_times)
    if unrestored > 0:
        m["unrestored_evictions"] = unrestored
    tbt = np.diff(req.token_times)
    if tbt.size:
        m["tbt_p50_s"] = float(np.percentile(tbt, 50))
        m["tbt_p95_s"] = float(np.percentile(tbt, 95))
        m["tbt_max_s"] = float(tbt.max())
    return m


def aggregate_metrics(finished, wall_s: float) -> dict:
    """Aggregate over finished requests for a run of ``wall_s`` seconds.

    TTFT percentiles are over requests; time-between-tokens (TBT)
    percentiles pool every request's inter-token gaps — the tail that
    chunked prefill exists to bound (a whole-prompt prefill stalls every
    in-flight request's next token for the full prompt duration).

    Tolerates a mixed population: requests that never emitted a token
    (zero-generation admissions, drained queues) are excluded from the
    TTFT pool, unfinished requests from the latency pool, and the counts
    of both exclusions are reported instead of poisoning the
    percentiles with zero-based garbage."""
    if not finished:
        return {"requests": 0, "total_tokens": 0, "tok_per_s": 0.0}
    total = int(sum(r.n_generated for r in finished))
    m = {
        "requests": len(finished),
        "total_tokens": total,
        "tok_per_s": total / max(wall_s, 1e-9),
    }
    ttft = np.array([r.first_token_s - r.arrival_s for r in finished
                     if r.first_token_s > 0.0])
    if ttft.size:
        m["mean_ttft_s"] = float(ttft.mean())
        m["ttft_p50_s"] = float(np.percentile(ttft, 50))
        m["ttft_p95_s"] = float(np.percentile(ttft, 95))
    lat = np.array([r.finish_s - r.arrival_s for r in finished
                    if r.finish_s > 0.0])
    if lat.size:
        m["mean_latency_s"] = float(lat.mean())
        m["p95_latency_s"] = float(np.percentile(lat, 95))
    m["no_token_requests"] = int(
        sum(1 for r in finished if r.first_token_s <= 0.0))
    m["unfinished_requests"] = int(
        sum(1 for r in finished if r.finish_s <= 0.0))
    tbt = np.concatenate(
        [np.diff(r.token_times) for r in finished] or [np.zeros(0)])
    if tbt.size:
        m["tbt_p50_s"] = float(np.percentile(tbt, 50))
        m["tbt_p95_s"] = float(np.percentile(tbt, 95))
        m["tbt_max_s"] = float(tbt.max())
    # spills: how often requests were parked in RRAM (split into
    # priority preemptions vs capacity-driven idle offloads) and how
    # long they sat there before their restore
    m["spills"] = int(sum(r.n_evictions for r in finished))
    m["preemptions"] = int(sum(r.n_preemptions for r in finished))
    m["idle_offloads"] = int(sum(r.n_idle_offloads for r in finished))
    m["restores"] = int(sum(len(r.restore_times) for r in finished))
    m["unrestored_evictions"] = int(
        sum(max(len(r.evict_times) - len(r.restore_times), 0)
            for r in finished))
    rl = np.concatenate([_restore_latencies(r) for r in finished]
                        or [np.zeros(0)])
    if rl.size:
        m["restore_latency_p50_s"] = float(np.percentile(rl, 50))
        m["restore_latency_p95_s"] = float(np.percentile(rl, 95))
    # prefix cache: how many admissions skipped prefill work, how many
    # prompt positions they adopted, and the hit rate over the stream
    hits = [r for r in finished if r.prefix_hit > 0]
    m["prefix_hits"] = len(hits)
    m["prefix_hit_tokens"] = int(sum(r.prefix_hit for r in hits))
    m["prefix_hit_rate"] = len(hits) / len(finished)
    if hits:
        hit_ttft = np.array([r.first_token_s - r.arrival_s for r in hits
                             if r.first_token_s > 0.0])
        if hit_ttft.size:
            m["prefix_hit_mean_ttft_s"] = float(hit_ttft.mean())
        cold_ttft = np.array(
            [r.first_token_s - r.arrival_s for r in finished
             if r.prefix_hit == 0 and r.first_token_s > 0.0])
        if cold_ttft.size:
            m["cold_mean_ttft_s"] = float(cold_ttft.mean())
    return m
