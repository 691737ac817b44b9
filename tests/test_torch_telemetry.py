"""PyTorch port: the telemetry hub and the tier-traffic ledger, against
the JAX reference.

CONSERVATION is the load-bearing property: on a drained run the port's
`TierLedger` totals equal the port's `simulated_efficiency` bit for bit
(`==`), and both equal the reference's ledger and simulated efficiency
on the same stream — with and without spills, verbatim and compressed
lanes. Plus the Perfetto trace schema (a mid-run trace closes its open
segments without touching live state), the Prometheus exposition,
scheduler decision codes, the JSONL snapshot stream and the
`NullTelemetry` no-op contract.
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest

from repro.serving import Telemetry as RefTelemetry
from repro.serving import simulated_efficiency as ref_sim_eff
from repro_torch.serving import (REASON_CODES, Engine, LocalBackend,
                                 NullTelemetry, Request, Telemetry,
                                 aggregate_metrics, parse_prometheus,
                                 request_metrics, simulated_efficiency,
                                 validate_chrome_trace)
from test_torch_spill import make_requests, side, tokens

jax.config.update("jax_platform_name", "cpu")


def _preempt(s, telemetry, spill_compress=False, chunk_tokens=5):
    """Forced preemption: a DRAM budget of exactly two residents, both
    slots decoding priority-0 work when a priority-1 intruder lands —
    evict, park, restore, drain (the reference suite's scenario)."""
    backend = s.backend(2, 32, spill_compress=spill_compress)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched, chunk_tokens=chunk_tokens,
                   telemetry=telemetry)
    reqs = make_requests(s, [(12, 10), (12, 10), (8, 4)], seed=3,
                         priorities=[0, 0, 1])
    for r in reqs[:2]:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    eng.submit(reqs[2])
    eng.run(max_steps=400)
    assert len(eng.finished) == 3 and eng.stats["evictions"] >= 1
    return eng, reqs


@functools.lru_cache(maxsize=None)
def _ref_preempt(spill_compress: bool):
    """The reference engine's run of the scenario (memoized)."""
    tel = RefTelemetry()
    eng, _ = _preempt(side(False), tel, spill_compress)
    return eng, tel


@functools.lru_cache(maxsize=None)
def _port_preempt():
    """The port's verbatim-lane run with a snapshotting hub, shared by
    the read-only trace / exposition / decision-code tests."""
    tel = Telemetry(stats_every=3)
    eng, reqs = _preempt(side(True), tel)
    return eng, reqs, tel


# ---------------------------------------------------------------------------
# conservation: ledger == simulated_efficiency == the reference's, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spill_compress", [False, True])
def test_ledger_conserves_bit_for_bit(spill_compress):
    tel = Telemetry()
    eng, _ = _preempt(side(True), tel, spill_compress)
    reng, rtel = _ref_preempt(spill_compress)
    cfg, comp = eng.backend.sim_context()
    assert comp == spill_compress
    led = tel.ledger.totals()
    sim = simulated_efficiency(cfg, eng.finished, spill_compressed=comp)
    for k in ("sim_energy_j", "sim_total_s", "sim_spill_energy_j",
              "sim_spill_s", "sim_energy_split_j"):
        assert led[k] == sim[k], k
    assert np.isclose(sum(led["sim_energy_split_j"].values()),
                      led["sim_energy_j"], rtol=1e-12)
    # the same floats as the reference's ledger and simulated efficiency
    assert led == rtel.ledger.totals()
    assert tel.ledger.steps == rtel.ledger.steps
    assert sim == ref_sim_eff(reng.backend.sim_context()[0], reng.finished,
                              spill_compressed=spill_compress)
    assert tokens(eng.finished) == tokens(reng.finished)
    assert led["requests_closed"] == 3
    assert led["tokens"] == sum(r.n_generated for r in eng.finished)
    for k in ("dram_hot_ring_bytes", "rram_cold_read_bytes",
              "rram_spill_bytes", "kv_append_bytes"):
        assert led[k] > 0, k


def test_ledger_conserves_without_spills():
    def run(s, tel_cls):
        tel = tel_cls()
        eng = s.Engine(s.backend(2, 24), telemetry=tel)
        eng.run(make_requests(s, [(8, 6), (10, 4), (6, 5)], seed=1))
        return eng, tel
    eng, tel = run(side(True), Telemetry)
    reng, rtel = run(side(False), RefTelemetry)
    led = tel.ledger.totals()
    sim = simulated_efficiency(eng.backend.sim_context()[0], eng.finished)
    assert led["sim_energy_j"] == sim["sim_energy_j"]
    assert led["sim_total_s"] == sim["sim_total_s"]
    assert led["sim_energy_split_j"] == sim["sim_energy_split_j"]
    assert led["rram_spill_bytes"] == 0.0
    assert led == rtel.ledger.totals()
    assert eng.plans == reng.plans


# ---------------------------------------------------------------------------
# trace + exposition schemas
# ---------------------------------------------------------------------------
def test_chrome_trace_schema_and_content(tmp_path):
    eng, _, tel = _port_preempt()
    path = tmp_path / "trace.json"
    tel.write_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    info = validate_chrome_trace(trace)
    for phase in ("plan", "chunk-prefill", "commit", "decode", "evict",
                  "restore"):
        assert phase in info["phases"], info["phases"]
    assert info["processes"] == [1, 2, 3, 4]
    assert info["spans"] > 0 and info["counters"] > 0
    names = [e["name"] for e in trace["traceEvents"]]
    assert "preempt" in names and "first-token" in names
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert all(e["dur"] >= 1 for e in xs)


def test_chrome_trace_mid_run_closes_open_segments():
    """chrome_trace() mid-run closes open slot/request segments at the
    last timestamp without mutating live state."""
    s = side(True)
    tel = Telemetry()
    eng = Engine(s.backend(2, 24), telemetry=tel)
    for r in make_requests(s, [(8, 8), (8, 8)], seed=2):
        eng.submit(r)
    for _ in range(4):
        eng.step()
    open_before = dict(tel._req_open)
    info = validate_chrome_trace(tel.chrome_trace())
    assert tel._req_open == open_before
    assert info["spans"] > 0
    eng.run(max_steps=200)
    assert len(eng.finished) == 2


def test_validate_chrome_trace_rejects_garbage():
    with pytest.raises(ValueError):
        validate_chrome_trace({"events": []})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X"}]})
    with pytest.raises(ValueError):        # X span without dur
        validate_chrome_trace({"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "name": "p", "ts": 0}]})
    with pytest.raises(ValueError):        # negative ts
        validate_chrome_trace({"traceEvents": [
            {"ph": "i", "pid": 1, "tid": 0, "name": "p", "ts": -1}]})


def test_prometheus_exposition(tmp_path):
    eng, _, tel = _port_preempt()
    path = tmp_path / "metrics.prom"
    tel.write_prometheus(str(path))
    by: dict = {}
    for name, labels, value in parse_prometheus(path.read_text()):
        by.setdefault(name, []).append((labels, value))
    assert by["repro_serving_tokens_total"][0][1] == sum(
        r.n_generated for r in eng.finished)
    assert by["repro_serving_steps_total"][0][1] == eng.stats["steps"]
    ev = {lab["kind"]: v
          for lab, v in by["repro_serving_spill_events_total"]}
    assert ev["preempt"] == eng.stats["evictions"]
    assert ev["restore"] == eng.stats["restores"]
    codes = {lab["code"]
             for lab, _ in by["repro_serving_scheduler_decisions_total"]}
    assert "admit" in codes and "evict_priority" in codes
    assert codes <= set(REASON_CODES)
    led = tel.ledger.totals()
    sim_e = {lab["domain"]: v
             for lab, v in by["repro_serving_sim_energy_joules_total"]}
    for dom, e in led["sim_energy_split_j"].items():
        assert sim_e[dom] == e             # bitwise via repr round-trip
    assert by["repro_serving_sim_seconds_total"][0][1] \
        == led["sim_total_s"]
    assert "repro_serving_endurance" in by


def test_parse_prometheus_rejects_garbage():
    with pytest.raises(ValueError):        # sample without # TYPE
        parse_prometheus("foo_total 3\n")
    with pytest.raises(ValueError):        # malformed sample line
        parse_prometheus("# TYPE foo counter\nfoo{ 3\n")
    with pytest.raises(ValueError):        # malformed label pair
        parse_prometheus('# TYPE foo counter\nfoo{bar=3} 1\n')
    ok = parse_prometheus('# TYPE foo counter\nfoo{a="b"} 2.5\n')
    assert ok == [("foo", {"a": "b"}, 2.5)]


# ---------------------------------------------------------------------------
# decision codes
# ---------------------------------------------------------------------------
def test_decision_codes_preemption_match_reference():
    _, _, tel = _port_preempt()
    _, rtel = _ref_preempt(False)
    dc = tel.decision_counts
    assert dc == rtel.decision_counts
    assert dc["admit"] == 3 and dc["evict_priority"] == 1
    assert dc["restore"] >= 1
    evict = [d for d in tel.decisions if d["code"] == "evict_priority"]
    assert evict and "rid" in evict[0] and "waiter_priority" in evict[0]
    assert tel.decisions == rtel.decisions     # step, code, rid, context


def test_decision_codes_denials_match_reference():
    """A DRAM budget of one resident with two requests waiting logs
    deny_dram_budget for the blocked queue head."""
    def run(s, tel):
        backend = s.backend(2, 24)
        hot_b, cold_b = backend.slot_kv_bytes()
        sched = s.FCFSScheduler(s.CapacityBudget(1 * hot_b, 1e15), hot_b,
                                cold_b, oversubscribe=1.0)
        eng = s.Engine(backend, scheduler=sched, telemetry=tel)
        eng.run(make_requests(s, [(8, 6), (8, 6)], seed=4))
        return tel
    tel = run(side(True), Telemetry())
    rtel = run(side(False), RefTelemetry())
    assert tel.decision_counts == rtel.decision_counts
    assert tel.decision_counts["deny_dram_budget"] >= 1
    assert tel.decision_counts["admit"] == 2
    assert set(tel.decision_counts) <= set(REASON_CODES)


# ---------------------------------------------------------------------------
# disabled telemetry and snapshots
# ---------------------------------------------------------------------------
def test_null_telemetry_default_and_token_parity():
    s = side(True)
    specs = [(10, 6), (8, 5)]
    eng_off = Engine(s.backend(2, 24))
    assert isinstance(eng_off.telemetry, NullTelemetry)
    assert eng_off.telemetry.enabled is False
    eng_off.run(make_requests(s, specs, seed=5))
    eng_on = Engine(LocalBackend(s.model, s.params, 2, 24, device="cpu"),
                    telemetry=Telemetry())
    eng_on.run(make_requests(s, specs, seed=5))
    assert tokens(eng_off.finished) == tokens(eng_on.finished)
    null = NullTelemetry()
    null.bind(cfg=s.cfg)
    null.step_begin(0)
    null.phase_begin("plan")
    null.phase_end(count=0)
    null.decision("admit", rid=1)
    null.step_end({})
    assert null.snapshot() == {} and null.ledger is None


def test_snapshot_jsonl_stream(tmp_path):
    path = tmp_path / "snaps.jsonl"
    tel = Telemetry(stats_every=3, snapshot_path=str(path))
    _preempt(side(True), tel)
    tel.close()
    snaps = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(snaps) == len(tel.snapshots) >= 2
    for snap in snaps:
        assert {"step", "counters", "decisions", "ledger",
                "endurance"} <= set(snap)
    toks = [snap["counters"]["tokens"] for snap in snaps]
    assert toks == sorted(toks)
    assert snaps[-1]["endurance"]["write_once_ok"]
    assert snaps[-1]["endurance"]["total_spill_writes"] > 0


# ---------------------------------------------------------------------------
# metrics edge cases
# ---------------------------------------------------------------------------
def _bare_request(**kw):
    return Request(rid=kw.pop("rid", 0), tokens=np.zeros(4, np.int32),
                   max_new_tokens=kw.pop("max_new_tokens", 4), **kw)


def test_metrics_partial_and_unrestored():
    assert aggregate_metrics([], 1.0) == {"requests": 0, "total_tokens": 0,
                                          "tok_per_s": 0.0}
    req = _bare_request()
    req.arrival_s, req.admit_s, req.first_token_s = 1.0, 1.5, 2.0
    req.generated = [7, 7]
    req.evict_times, req.evict_ctx = [2.5], [6]
    m = request_metrics(req)
    assert m["queue_s"] == pytest.approx(0.5)
    assert m["ttft_s"] == pytest.approx(1.0)
    assert "latency_s" not in m and "spilled_s" not in m
    assert m["unrestored_evictions"] == 1 and m["finished"] is False


def test_simulated_efficiency_zero_generation_and_unpaired_spill():
    s = side(True)
    req = _bare_request()
    sim0 = simulated_efficiency(s.cfg, [req])
    assert sim0["sim_energy_j"] == 0.0 and sim0["sim_tokens_per_j"] == 0.0
    req.evict_ctx = [6]
    sim1 = simulated_efficiency(s.cfg, [req])
    assert sim1["sim_spills"] == 1
    assert sim1["sim_energy_j"] == sim1["sim_spill_energy_j"] > 0.0
    r = side(False)
    rreq = r.Request(rid=0, tokens=np.zeros(4, np.int32), max_new_tokens=4)
    rreq.evict_ctx = [6]
    assert sim1 == ref_sim_eff(r.cfg, [rreq])
