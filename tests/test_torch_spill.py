"""PyTorch port: preemption, idle offload, int8 spill lanes and the rest
of chunked prefill, against the JAX reference engine.

Each scenario runs twice on the CPU, through the port's `Engine` over
`LocalBackend` and through the reference's, with the same f32 weights
(`build_pair`) and the same request stream, and the two must agree
exactly: token streams, every StepPlan (chunks, evictions, restores,
idle offloads), `Engine.stats`, the endurance report and the spill
lanes' RRAM write counters. Verbatim lanes restore bit-exactly;
compressed lanes restore the hot ring within `spill_codec_bound` and
every other leaf bit-exactly.

The scenarios are the `local` cases of the reference's
`test_serving_preempt.py` and `test_serving_spill.py`, and the flat,
VLM-boundary and interleaving cases of `test_serving_chunked.py`, on the
architectures the port serves (granite-3-2b and mobilevlm-1.7b, reduced).
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from repro.serving import CapacityBudget as RefCapacityBudget
from repro.serving import Engine as RefEngine
from repro.serving import FCFSScheduler as RefFCFSScheduler
from repro.serving import LocalBackend as RefBackend
from repro.serving import Request as RefRequest
from repro.serving import aggregate_metrics as ref_aggregate_metrics
from repro.serving import make_synthetic_requests as ref_synthetic
from repro.serving import simulated_efficiency as ref_sim_eff
from repro.serving import spill_lane_bytes as ref_spill_lane_bytes
from repro_torch.core import kv_tiers as KT
from repro_torch.core.quant import spill_codec_bound
from repro_torch.serving import (CapacityBudget, Engine, FCFSScheduler,
                                 LocalBackend, Request, aggregate_metrics,
                                 make_synthetic_requests, request_metrics,
                                 simulated_efficiency, spill_lane_bytes)
from repro_torch.tree import tree_leaves_with_path, tree_map
from test_torch_config import build_pair
from test_torch_serving import _record_plans

jax.config.update("jax_platform_name", "cpu")

# the reference suite's documented drift of one decode step from a
# compressed-lane restore, relative to max |logit|
SPILL_COMPRESS_LOGIT_RTOL = 1e-2


# ---------------------------------------------------------------------------
# one scenario, two engines
# ---------------------------------------------------------------------------
def side(port: bool, arch: str = "granite-3-2b", kv_policy: str = "tiered",
         hot_window: int = 8) -> types.SimpleNamespace:
    """The classes and model of one side of a twin run: the port
    (``port=True``, on the CPU) or the reference."""
    rc, rmodel, rparams, pc, model, params = build_pair(arch, kv_policy,
                                                        hot_window)

    def engine(cls):
        def make(*a, **kw):
            eng = cls(*a, **kw)
            eng.plans = _record_plans(eng)
            return eng
        return make

    if port:
        return types.SimpleNamespace(
            port=True, cfg=pc, model=model, params=params,
            backend=lambda n, L, **kw: LocalBackend(model, params, n, L,
                                                    device="cpu", **kw),
            Engine=engine(Engine), FCFSScheduler=FCFSScheduler,
            CapacityBudget=CapacityBudget, Request=Request,
            synthetic=make_synthetic_requests)
    return types.SimpleNamespace(
        port=False, cfg=rc, model=rmodel, params=rparams,
        backend=lambda n, L, **kw: RefBackend(rmodel, rparams, n, L, **kw),
        Engine=engine(RefEngine), FCFSScheduler=RefFCFSScheduler,
        CapacityBudget=RefCapacityBudget, Request=RefRequest,
        synthetic=ref_synthetic)


def make_requests(s, specs, seed: int = 0, priorities=None):
    """`tests/conftest.py::make_requests` on either side's Request."""
    rng = np.random.default_rng(seed)
    return [s.Request(rid=i,
                      tokens=rng.integers(0, s.cfg.vocab_size, p)
                      .astype(np.int32),
                      max_new_tokens=g,
                      priority=0 if priorities is None else priorities[i])
            for i, (p, g) in enumerate(specs)]


def tokens(reqs) -> list:
    return [r.generated for r in sorted(reqs, key=lambda r: r.rid)]


def assert_twins(eng, reqs, reng, rreqs):
    """The port's engine state after a scenario equals the reference's."""
    assert eng.plans == reng.plans
    assert tokens(reqs) == tokens(rreqs)
    assert eng.stats == reng.stats
    assert eng.endurance_report() == reng.endurance_report()
    assert [(r.n_evictions, r.evict_ctx) for r in reqs] == \
        [(r.n_evictions, r.evict_ctx) for r in rreqs]
    sw, rsw = eng.pool.state.spill_writes, reng.pool.state.spill_writes
    assert (sw is None) == (rsw is None)
    if sw is not None:
        assert sw.tolist() == np.asarray(rsw).tolist()


def twin(scenario, *args, **side_kw):
    """Run ``scenario(side, *args) -> (engine, requests)`` on the port and
    on the reference, assert they agree, and return both results."""
    port = scenario(side(True, **side_kw), *args)
    ref = scenario(side(False, **side_kw), *args)
    assert_twins(*port, *ref)
    return port, ref


# ---------------------------------------------------------------------------
# preemption (reference test_serving_preempt.py, local cases)
# ---------------------------------------------------------------------------
def _preempted(s, chunk):
    """Two priority-0 victims decoding in both slots (a DRAM budget of
    exactly two residents) when a priority-1 intruder lands."""
    backend = s.backend(2, 32)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched, chunk_tokens=chunk)
    reqs = make_requests(s, [(12, 10), (12, 10), (8, 4)], seed=3,
                         priorities=[0, 0, 1])
    for r in reqs[:2]:
        eng.submit(r)
    guard = 0
    while not (eng.pool.active_slots == 2 and eng._inflight is None):
        eng.step()
        guard += 1
        assert guard < 60, "victims never reached steady decode"
    eng.step()
    eng.submit(reqs[2])
    eng.run(max_steps=400)
    return eng, reqs


@pytest.mark.parametrize("chunk", [0, 5])
def test_preempted_restore_matches_reference(chunk):
    (eng, reqs), _ = twin(_preempted, chunk)
    assert eng.stats["evictions"] >= 1
    assert eng.stats["restores"] == eng.stats["evictions"]
    assert len(eng.finished) == 3
    victims = [r for r in reqs if r.n_evictions]
    assert victims and all(r.priority == 0 for r in victims)
    assert eng.endurance_report()["write_once_ok"]


def _vqa_evictions(s):
    backend = s.backend(2, 40)
    hot_b, cold_b = backend.slot_kv_bytes()
    low = s.synthetic(s.cfg, 3, prompt_len=20, gen_len=8, seed=2,
                      image_every=2)
    (high,) = s.synthetic(s.cfg, 1, prompt_len=12, gen_len=3, seed=7)
    high.rid, high.priority = 3, 1
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched)
    for r in low:
        eng.submit(r)
    guard = 0
    while eng.pool.active_slots < 2 or eng._inflight is not None:
        eng.step()
        guard += 1
        assert guard < 60
    eng.submit(high)
    eng.run(max_steps=400)
    return eng, low + [high]


def test_mixed_vqa_stream_with_evictions_matches_reference():
    (eng, reqs), _ = twin(_vqa_evictions, arch="mobilevlm-1.7b",
                          hot_window=16)
    assert eng.stats["evictions"] >= 1 and len(eng.finished) == 4
    assert any(r.patches is not None and r.n_generated for r in reqs)
    assert eng.endurance_report()["write_once_ok"]


def _oversubscribed(s, over):
    backend = s.backend(4, 24)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=over, spill_lanes=4)
    eng = s.Engine(backend, scheduler=sched)
    reqs = make_requests(s, [(8, 6), (13, 6), (16, 4), (8, 8), (11, 5),
                             (16, 6)], seed=11)
    for r in reqs:
        eng.submit(r)
    eng.peak = 0
    while not eng.idle:
        eng.step()
        eng.peak = max(eng.peak, eng.pool.active_slots)
    return eng, reqs


def test_oversubscribed_stream_matches_reference():
    """Oversubscription only relaxes admission: 2x the DRAM budget runs
    four residents instead of two and gives the same tokens."""
    (blocked, breqs), _ = twin(_oversubscribed, 1.0)
    (oversub, oreqs), (roversub, _) = twin(_oversubscribed, 2.0)
    assert blocked.peak == 2 and oversub.peak == roversub.peak == 4
    assert tokens(breqs) == tokens(oreqs)


def _endurance_cycles(s):
    """Two evict/restore cycles of one long-lived request."""
    backend = s.backend(2, 64)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched)
    reqs = make_requests(s, [(8, 30), (8, 30)], seed=5)
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    intruders = make_requests(s, [(8, 3), (8, 3)], seed=6,
                              priorities=[1, 1])
    for k, intr in enumerate(intruders):
        intr.rid = 10 + k
        eng.submit(intr)
        guard = 0
        while intr.status != "finished":
            eng.step()
            guard += 1
            assert guard < 100
        for _ in range(2):
            eng.step()
    eng.run(max_steps=400)
    return eng, reqs + intruders


def test_evict_restore_endurance_accounting_exact():
    (eng, reqs), _ = twin(_endurance_cycles, hot_window=4)
    assert eng.stats["evictions"] == 2 and eng.stats["restores"] == 2
    evicted = next(r for r in reqs if r.n_evictions)
    assert evicted.n_evictions == 2
    sw = eng.pool.state.spill_writes
    nb = sw.shape[1]
    assert sw.sum(dim=0).tolist() == \
        KT.expected_spill_block_writes(nb, evicted.evict_ctx).tolist()
    assert int(sw.sum()) == sum(
        (ctx + KT.ENDURANCE_BLOCK - 1) // KT.ENDURANCE_BLOCK
        for ctx in evicted.evict_ctx)
    # restores add no cold writes to any slot
    worst = eng.pool.worst_case_writes()
    for slot in range(2):
        want = KT.expected_block_writes(
            worst.shape[1], eng.backend.hot_window,
            eng._slot_prefill_len[slot], eng._slot_total_len[slot])
        assert worst[slot].tolist() == want.tolist()
    rep = eng.endurance_report()
    assert rep["write_once_ok"] and rep["spills"] == 2
    assert rep["total_spill_writes"] == int(sw.sum())
    assert rep["spill_lanes"] == 2


def _metrics_preempt(s):
    backend = s.backend(2, 32)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched)
    reqs = make_requests(s, [(12, 10), (12, 10), (8, 4)], seed=3,
                         priorities=[0, 0, 1])
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.submit(reqs[2])
    eng.run(max_steps=300)
    return eng, reqs


def test_preemption_metrics_and_sim_spill_energy():
    (eng, reqs), (reng, rreqs) = twin(_metrics_preempt)
    done = eng.finished
    m = aggregate_metrics(done, wall_s=1.0)
    rm_ = ref_aggregate_metrics(reng.finished, wall_s=1.0)
    for k in ("preemptions", "restores", "spills", "idle_offloads",
              "requests", "total_tokens"):
        assert m[k] == rm_[k], k
    assert m["preemptions"] >= 1 and m["restores"] == m["preemptions"]
    assert m["restore_latency_p95_s"] >= m["restore_latency_p50_s"] >= 0
    victim = next(r for r in done if r.n_evictions)
    rm = request_metrics(victim)
    assert rm["preemptions"] == victim.n_evictions and rm["spilled_s"] > 0
    sim = simulated_efficiency(eng.backend.sim_context()[0], done)
    assert sim == ref_sim_eff(reng.backend.sim_context()[0], reng.finished)
    assert sim["sim_spills"] == eng.stats["evictions"]
    assert sim["sim_energy_j"] > sim["sim_spill_energy_j"] > 0


def test_spill_buffers_materialize_lazily():
    s = side(True)
    backend = s.backend(2, 24)
    pool = backend.make_pool()
    assert backend.n_spill == 2 and pool.num_spill_lanes == 2
    assert pool.state.spill is None and pool.state.spill_writes is None
    with pytest.raises(ValueError, match="nothing has been spilled"):
        backend.restore_slot(pool.state, 0, 0)
    st = backend.evict_slot(pool.state, 0, 0, 4)
    assert st.spill is not None and st.num_spill_lanes == 2
    assert int(st.spill_writes.sum()) == 1


def _no_spill(s):
    backend = s.backend(2, 32, n_spill=0)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched)
    reqs = make_requests(s, [(12, 10), (12, 10), (8, 4)], seed=3,
                         priorities=[0, 0, 1])
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    eng.submit(reqs[2])
    eng.run(max_steps=300)
    return eng, reqs


def test_no_spill_lanes_disables_preemption():
    s = side(True)
    backend = s.backend(2, 32, n_spill=0)
    pool = backend.make_pool()
    assert backend.n_spill == 0 and pool.num_spill_lanes == 0
    with pytest.raises(ValueError, match="n_spill=0"):
        backend.evict_slot(pool.state, 0, 0, 4)
    (eng, _), _ = twin(_no_spill)
    assert eng.stats["evictions"] == 0 and len(eng.finished) == 3


# ---------------------------------------------------------------------------
# idle offload and compressed lanes (reference test_serving_spill.py)
# ---------------------------------------------------------------------------
def _offloaded(s, chunk, compress=False, max_len=32,
               specs=((12, 10), (12, 10), (8, 6))):
    """Three equal-priority requests on two slots: the third is admitted
    only by parking an idle runner in an RRAM lane."""
    backend = s.backend(2, max_len, spill_compress=compress)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0, idle_offload_steps=2,
                            lane_bytes=backend.spill_lane_bytes())
    eng = s.Engine(backend, scheduler=sched, chunk_tokens=chunk)
    reqs = make_requests(s, list(specs), seed=3 if max_len == 32 else 5)
    eng.run(reqs, max_steps=500)
    return eng, reqs


@pytest.mark.parametrize("chunk", [0, 5])
def test_idle_offload_matches_reference(chunk):
    (eng, reqs), _ = twin(_offloaded, chunk)
    assert eng.stats["idle_offloads"] >= 1 and eng.stats["evictions"] == 0
    assert eng.stats["restores"] == eng.stats["idle_offloads"]
    assert len(eng.finished) == 3
    assert eng.endurance_report()["write_once_ok"]


def test_idle_offload_matches_uninterrupted_run():
    s = side(True)
    eng, reqs = _offloaded(s, 0)
    assert eng.stats["idle_offloads"] >= 1
    backend = s.backend(2, 32)
    hot_b, cold_b = backend.slot_kv_bytes()
    calm = Engine(backend, scheduler=FCFSScheduler(
        CapacityBudget(1e15, 1e15), hot_b, cold_b, oversubscribe=1.0))
    ref = make_requests(s, [(12, 10), (12, 10), (8, 6)], seed=3)
    calm.run(ref, max_steps=500)
    assert calm.stats["idle_offloads"] == 0
    assert tokens(reqs) == tokens(ref)


def _steady(backend, s, gen_steps=3):
    """One request decoded a few steps into slot 0."""
    eng = Engine(backend)
    (req,) = make_requests(s, [(8, 20)], seed=5)
    eng.submit(req)
    for _ in range(gen_steps):
        eng.step()
    assert eng._active[0]
    return eng


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _leafwise_compare(cache0, cache1, codec_bound=True):
    """(hot leaves within the codec bound, leaves bit-exact)."""
    hot = exact = 0
    for (path, a), (_, b) in zip(tree_leaves_with_path(cache0),
                                 tree_leaves_with_path(cache1)):
        if path[-1] == "hot" and codec_bound:
            err = (a.float() - b.float()).abs()
            bound = spill_codec_bound(a)
            assert bool((err <= bound * (1 + 1e-4) + 1e-7).all()), path
            hot += 1
        else:
            assert torch.equal(a, b), path
            exact += 1
    return hot, exact


def test_compressed_lane_restore_within_codec_bound():
    s = side(True)
    backend = s.backend(2, 32, spill_compress=True)
    assert backend.spill_compress
    eng = _steady(backend, s)
    st0 = eng.pool.state
    before = _clone(st0.cache)
    st1 = backend.evict_slot(st0, 0, 0, int(eng._pos[0]))
    assert st1.num_spill_lanes == backend.n_spill
    keys = {p[-1] for p, _ in tree_leaves_with_path(st1.spill)}
    assert {"hot_q", "hot_scale"} <= keys and "hot" not in keys
    st2 = backend.restore_slot(st1, 0, 1)      # into the other slot
    moved = tree_map(lambda t, a: t.narrow(a, 1, 1), st2.cache,
                     backend._axes)
    orig = tree_map(lambda t, a: t.narrow(a, 0, 1), before, backend._axes)
    n_hot, n_exact = _leafwise_compare(orig, moved)
    assert n_hot >= 1 and n_exact >= 1


def test_compressed_restore_logit_drift_within_documented_tol():
    s = side(True)
    backend = s.backend(1, 32, spill_compress=True)
    eng = _steady(backend, s)
    st0 = eng.pool.state
    before = _clone(st0.cache)
    ctx = int(eng._pos[0])
    st2 = backend.restore_slot(backend.evict_slot(st0, 0, 0, ctx), 0, 0)
    tok = torch.as_tensor(np.asarray(eng._tok)).long()
    pos = torch.tensor([ctx])
    a, _ = s.model.decode_step(s.params, tok, before, pos)
    b, _ = s.model.decode_step(s.params, tok, st2.cache, pos)
    drift = float((a - b).abs().max())
    assert drift <= SPILL_COMPRESS_LOGIT_RTOL * float(a.abs().max())
    assert drift > 0.0                  # the codec really is lossy


def test_compressed_flat_policy_spill_is_bit_exact():
    s = side(True, kv_policy="flat")
    backend = s.backend(2, 32, spill_compress=True)
    assert not backend.spill_compress
    assert backend.spill_lane_bytes() == sum(backend.slot_kv_bytes())
    eng = _steady(backend, s)
    before = _clone(eng.pool.state.cache)
    st2 = backend.restore_slot(
        backend.evict_slot(eng.pool.state, 0, 0, int(eng._pos[0])), 0, 0)
    _leafwise_compare(before, st2.cache, codec_bound=False)


def test_restore_leaves_other_slots_and_lanes_unchanged():
    """Evict slot 0 into lane 1, scribble over slot 0, restore into
    slot 0: slot 0 comes back verbatim, slot 1 and every lane counter
    but lane 1's are untouched, and the lane counts one spill."""
    s = side(True)
    backend = s.backend(2, 40, spill_compress=False)
    eng = Engine(backend)
    for r in make_requests(s, [(9, 20), (13, 20)], seed=8):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    st = eng.pool.state
    before = _clone(st.cache)
    st = backend.evict_slot(st, 0, 1, 12)
    assert st.spill_writes.tolist() == [[0], [1]]
    tree_map(lambda t, a: t.narrow(a, 0, 1).fill_(7), st.cache,
             backend._axes)
    lanes = _clone(st.spill)
    st = backend.restore_slot(st, 1, 0)
    _leafwise_compare(before, st.cache, codec_bound=False)
    _leafwise_compare(lanes, st.spill, codec_bound=False)
    assert st.spill_writes.tolist() == [[0], [1]]


def _compressed_drain(s):
    backend = s.backend(2, 32, spill_compress=True)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0, idle_offload_steps=2,
                            lane_bytes=backend.spill_lane_bytes())
    eng = s.Engine(backend, scheduler=sched)
    low = make_requests(s, [(12, 10), (12, 10), (8, 6)], seed=3)
    for r in low:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    (high,) = make_requests(s, [(8, 4)], seed=7, priorities=[1])
    high.rid = 9
    eng.submit(high)
    eng.run(max_steps=500)
    return eng, low + [high]


def test_compressed_engine_drains_under_preemption_and_offload():
    (eng, reqs), (reng, _) = twin(_compressed_drain)
    done = eng.finished
    assert len(done) == 4
    assert eng.stats["evictions"] >= 1 and eng.stats["idle_offloads"] >= 1
    assert eng.stats["restores"] == eng.stats["evictions"] \
        + eng.stats["idle_offloads"]
    assert all(r.n_generated == r.max_new_tokens for r in done)
    m = aggregate_metrics(done, wall_s=1.0)
    assert m["spills"] == m["preemptions"] + m["idle_offloads"]
    cfg, comp = eng.backend.sim_context()
    assert comp is True
    sim = simulated_efficiency(cfg, done, spill_compressed=comp)
    assert sim == ref_sim_eff(reng.backend.sim_context()[0], reng.finished,
                              spill_compressed=True)
    sim_fp = simulated_efficiency(cfg, done, spill_compressed=False)
    assert sim["sim_spills"] == eng.stats["restores"]
    assert sim["sim_spill_energy_j"] < sim_fp["sim_spill_energy_j"]


@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
def test_spill_lane_bytes_match_reference(kv_policy):
    s, r = side(True, kv_policy=kv_policy), side(False, kv_policy=kv_policy)
    for comp in (False, True):
        for length in (None, 5, 30):
            assert spill_lane_bytes(s.model, 32, comp, length=length) == \
                ref_spill_lane_bytes(r.model, 32, comp, length=length)
        b = s.backend(2, 32, spill_compress=comp)
        assert b.spill_lane_bytes() == \
            r.backend(2, 32, spill_compress=comp).spill_lane_bytes()
    full = spill_lane_bytes(s.model, 32, compressed=False)
    comp = spill_lane_bytes(s.model, 32, compressed=True)
    assert full == sum(s.backend(2, 32).slot_kv_bytes())
    assert (comp < full) == (kv_policy == "tiered")


def test_offload_endurance_counters_exact():
    s = side(True, hot_window=4)
    eng0 = Engine(s.backend(2, 64))
    rep0 = eng0.endurance_report()              # before any lane exists
    assert rep0["total_spill_writes"] == 0
    assert rep0["max_spill_writes_per_block"] == 0
    assert rep0["total_rram_writes"] == rep0.get("total_cold_writes", 0)
    (eng, reqs), _ = twin(_offloaded, 0, False, 64,
                          ((8, 14), (8, 14), (8, 8)), hot_window=4)
    assert len(eng.finished) == 3 and eng.stats["idle_offloads"] >= 2
    sw = eng.pool.state.spill_writes
    all_ctx = [c for r in reqs for c in r.evict_ctx]
    assert len(all_ctx) == eng.stats["idle_offloads"]
    assert sw.sum(dim=0).tolist() == \
        KT.expected_spill_block_writes(sw.shape[1], all_ctx).tolist()


# ---------------------------------------------------------------------------
# chunked prefill, the rest (reference test_serving_chunked.py)
# ---------------------------------------------------------------------------
def _whole_and_chunked(s, specs, max_len, chunk, synthetic=None):
    def reqs():
        if synthetic:
            return s.synthetic(s.cfg, **synthetic)
        return make_requests(s, specs, seed=3)
    whole = s.Engine(s.backend(2, max_len))
    got_w = tokens(whole.run(reqs(), max_steps=500))
    chunked = s.Engine(s.backend(2, max_len), chunk_tokens=chunk)
    creqs = reqs()
    chunked.run(creqs, max_steps=900)
    assert tokens(creqs) == got_w, "chunked prefill diverged from whole"
    assert chunked.stats["prefill_chunks"] > len(creqs)
    return chunked, creqs


def test_chunked_matches_whole_flat_policy():
    (eng, _), _ = twin(_whole_and_chunked,
                       [(16, 6), (13, 6), (8, 4), (16, 4)], 24, 5,
                       kv_policy="flat")
    assert eng.endurance_report()["write_once_ok"]


def test_chunked_vlm_stream_splits_at_modality_boundary():
    """Chunks of 6 positions (fewer than the visual span) split VQA
    prompts at the patch/text boundary."""
    (eng, reqs), _ = twin(_whole_and_chunked, None, 32, 6,
                          dict(n=3, prompt_len=20, gen_len=4, seed=2,
                               image_every=2),
                          arch="mobilevlm-1.7b", hot_window=16)
    assert any(r.patches is not None for r in reqs)
    assert eng.stats["prefill_chunks"] > 3


def _interleaved(s):
    eng = s.Engine(s.backend(2, 32), chunk_tokens=4)
    short = make_requests(s, [(8, 12)], seed=1)[0]
    eng.submit(short)
    eng.step()
    long_req = s.Request(rid=7, tokens=np.arange(20, dtype=np.int32) % 11,
                         max_new_tokens=4)
    eng.submit(long_req)
    eng.overlap = 0
    while not eng.idle:
        before = eng.stats["prefill_chunks"]
        events = eng.step()
        prefilled = eng.stats["prefill_chunks"] > before
        if prefilled and any(rid == short.rid for rid, _, _ in events):
            eng.overlap += 1
    return eng, [short, long_req]


def test_decode_interleaves_with_chunked_prefill():
    (eng, reqs), (reng, _) = twin(_interleaved)
    assert eng.overlap == reng.overlap >= 2
    assert [r.n_generated for r in reqs] == [12, 4]
