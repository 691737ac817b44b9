"""Serving metrics: measured latency/throughput + simulated efficiency.

Wall-clock numbers (TTFT, per-request latency, aggregate tok/s) come from
the engine's clock. Tokens/J is *simulated* on the CHIME platform,
never measured on the card that served: each finished request's
(prompt, step-count) trace is fed through the analytical simulator's
per-kernel cost terms (`simulator/chime_sim.py`) — the same instrument
the paper-claims tests validate. Port of the reference's module with
its imports pointed at the port.

Partial metrics: a request that never emitted a token has no TTFT and a
request that never finished has no latency — those keys are simply
absent rather than computed from the dataclass' 0.0 defaults (which
yielded negative garbage). Evictions whose restore never happened are
excluded from restore-latency pairing and surfaced as
``unrestored_evictions``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.simulator.chime_sim import (cost_layers, request_terms,
                                       spill_terms, sum_terms)
from repro_torch.simulator.hardware import CHIME, Platform


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


def simulated_efficiency(cfg, finished, platform: Platform = CHIME,
                         spill_compressed: bool = False,
                         fused_decode: bool | None = None,
                         sparse_read_tau: float | None = None,
                         weight_stream: bool | None = None) -> dict:
    """Simulated time/energy for the served trace on ``platform``.

    Each request contributes a VQA workload of its own (prompt length,
    generated step count); the per-token attention cost grows with that
    request's context exactly as the engine's tiered reads did.
    Spilled requests (preemption victims and idle cold-KV offloads
    alike) additionally pay the simulated RRAM spill/restore traffic for
    each recorded eviction context (`spill_terms`); ``spill_compressed``
    prices the int8 compressed-lane representation instead of the
    full-precision image (pass the backend's ``spill_compress``).

    Implemented as a `math.fsum` over the flat `CostTerm` stream of the
    whole trace (`chime_sim.request_terms`), which makes the totals
    order-independent: the telemetry `TierLedger`, which prices the SAME
    events step-by-step as the engine runs, reconciles with this
    function bit-for-bit on a drained run.

    ``fused_decode`` / ``sparse_read_tau`` price the fused paged-decode
    attention path instead of the streamed two-segment merge (pass the
    backend's resolved knobs; None falls back to the cfg fields so the
    defaults match whatever the model actually executed).
    ``weight_stream`` additionally prices the RRAM weight fetches of the
    streamed scan units (same resolution: the backend's resolved knob,
    else truthy ``cfg.weight_stream_layers``).
    """
    fused = bool(getattr(cfg, "fused_decode", False)
                 if fused_decode is None else fused_decode)
    tau = float(getattr(cfg, "sparse_read_tau", 0.0)
                if sparse_read_tau is None else sparse_read_tau)
    wstream = bool(getattr(cfg, "weight_stream_layers", 0)
                   if weight_stream is None else weight_stream)
    layers = cost_layers(cfg)
    terms = []
    n_spills = 0
    tokens = 0
    for req in finished:
        for ctx in req.evict_ctx:
            terms += spill_terms(cfg, platform, int(ctx),
                                 compressed=spill_compressed)
            terms += spill_terms(cfg, platform, int(ctx), restore=True,
                                 compressed=spill_compressed)
            n_spills += 1
        if req.n_generated == 0:
            continue
        image = req.has_image and cfg.frontend is not None
        terms += request_terms(cfg, platform, int(req.tokens.shape[0]),
                               req.n_generated, image, layers,
                               cached_prefix=int(req.prefix_hit),
                               fused=fused, sparse_tau=tau,
                               weight_stream=wstream)
        tokens += req.n_generated
    agg = sum_terms(terms)
    energy, sim_s = agg["sim_energy_j"], agg["sim_total_s"]
    return {
        "platform": platform.name,
        "sim_energy_j": energy,
        "sim_total_s": sim_s,
        "sim_spills": n_spills,
        "sim_spill_compressed": bool(spill_compressed),
        "sim_fused_decode": fused,
        "sim_sparse_read_tau": tau,
        "sim_weight_stream": wstream,
        "sim_spill_energy_j": agg["sim_spill_energy_j"],
        "sim_spill_s": agg["sim_spill_s"],
        "sim_energy_split_j": agg["sim_energy_split_j"],
        "sim_tokens_per_j": tokens / energy if energy else 0.0,
        "sim_tok_per_s_sequential": tokens / sim_s if sim_s else 0.0,
    }
