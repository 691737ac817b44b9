"""The program's spans as the benchmark reads them (`program_trace`), on
made-up events and on CPU runs at the tests' size: launches and idle
gaps owned by the right "repro::" range, every key of the harness's own
profile unchanged by the program's ranges, readers that give None where
there is nothing to read, and a run whose window reads the KV copies
the stores' shapes give."""

from __future__ import annotations

import time
import types

import pytest
from torch.autograd import DeviceType

from chipbench import profiling, program_trace, serve, work
from chipbench.tests import small


def _ev(name, start, end, thread=1, id=0, device=DeviceType.CPU):
    return types.SimpleNamespace(
        name=name, thread=thread, id=id, device_type=device,
        is_async=False, is_user_annotation=False, device_time_total=0.0,
        time_range=types.SimpleNamespace(start=start, end=end))


def _launch(t, thread, id, start, end, name="kern"):
    """A launching call on the host and the kernel it launched."""
    return [_ev("cudaLaunchKernel", t, t + 1, thread, id),
            _ev(name, start, end, 0, id, DeviceType.CUDA)]


def test_a_launch_belongs_to_its_threads_innermost_range():
    evs = [_ev("repro::train.backward", 0, 1000, thread=1),
           _ev("repro::grad.ffn_act", 100, 500, thread=2),
           _ev("repro::grad.inner", 120, 160, thread=2),
           *_launch(130, 2, 1, 300, 310),       # inner, on thread 2
           *_launch(200, 2, 2, 320, 330),       # grad.ffn_act, thread 2
           *_launch(210, 1, 3, 340, 350),       # thread 1: train.backward
           *_launch(220, 3, 4, 360, 380),       # no range on thread 3
           *_launch(600, 1, 5, 700, 710),
           *_launch(1200, 1, 6, 1300, 1310)]    # outside every range
    out = program_trace.read(evs)
    r = out["ranges"]
    assert r["grad.inner"]["launches"] == 1
    # thread 3 has none open: the range begun last on any thread
    assert r["grad.ffn_act"]["launches"] == 2
    assert r["grad.ffn_act"]["device_s"] == pytest.approx(30e-6)
    assert r["train.backward"]["launches"] == 2
    # the autograd thread's ranges nest under the caller's
    assert r["grad.ffn_act"]["total_launches"] == 3
    assert r["train.backward"]["total_launches"] == 5
    assert r["train.backward"]["total_device_s"] == pytest.approx(60e-6)
    assert out["outside"]["launches"] == 1
    assert {n: v["calls"] for n, v in r.items()} == {
        "train.backward": 1, "grad.ffn_act": 1, "grad.inner": 1}


def test_an_idle_gap_belongs_to_the_range_begun_last():
    evs = [_ev("repro::decode", 0, 1000, thread=1),
           _ev("repro::attn.decode", 100, 400, thread=1),
           _ev("repro::other", 150, 300, thread=2),
           *_launch(10, 1, 1, 0, 120),
           *_launch(110, 1, 2, 200, 210),
           *_launch(420, 1, 3, 450, 500)]
    r = program_trace.read(evs)["ranges"]
    # the gap [120, 200) opens inside decode > attn.decode; the gap
    # [210, 450) while "other", begun last, is open on another thread
    assert r["attn.decode"]["idle_s"] == pytest.approx(80e-6)
    assert r["other"]["idle_s"] == pytest.approx(240e-6)
    assert r["decode"]["idle_s"] == 0
    assert r["decode"]["total_idle_s"] == pytest.approx(320e-6)
    assert r["attn.decode"]["total_idle_s"] == pytest.approx(320e-6)
    assert r["decode"]["total_launches"] == 3
    paths = program_trace.read(evs)["paths"]
    assert paths["decode > attn.decode > other"]["idle_s"] == \
        pytest.approx(240e-6)
    assert paths["decode > attn.decode"]["launches"] == 1


def _window_events(with_program: bool):
    """A made-up profiled window: the harness's step and decode ranges,
    host operations, launches and kernels, and (or not) the program's
    ranges around them."""
    evs = [_ev("chipbench::step", 0, 1000), _ev("chipbench::decode", 50, 900),
           _ev("aten::mm", 60, 80), *_launch(62, 1, 1, 70, 150, "mm_kernel"),
           _ev("aten::copy_", 300, 320),
           *_launch(305, 1, 2, 310, 400, "copy_kernel"),
           _ev("aten::item", 600, 650),
           *_launch(610, 1, 3, 620, 700, "elementwise_kernel"),
           *_launch(960, 1, 4, 980, 990, "tail_kernel")]
    if with_program:
        evs += [_ev("repro::step", 1, 999), _ev("repro::decode", 40, 910),
                _ev("repro::attn.append", 290, 330),
                _ev("repro::decode.sample", 590, 660)]
    return evs


def test_the_harness_profile_reads_the_same_with_program_ranges():
    prof = types.SimpleNamespace

    def profile_of(evs):
        return prof(events=lambda: evs)
    args = (1e-3, {}, {"decode": {"calls": 1, "bound_s": 0.0}})
    plain = profiling.read(profile_of(_window_events(False)), *args)
    both = program_trace._read_both(profiling.read)(
        profile_of(_window_events(True)), *args)
    assert set(both) == set(plain) | {"program"}
    for k in plain:
        assert both[k] == plain[k], k
    assert [g[0] for g in both["idle_gaps"]] == [
        g[0] for g in plain["idle_gaps"]]
    r = both["program"]["ranges"]
    assert r["decode"]["total_launches"] == 3 \
        == both["ranges"]["decode"]["launches"]
    assert r["attn.append"]["launches"] == 1
    # the program's ranges, unfiltered, would rename the harness's gaps
    mixed = profiling.read(profile_of(_window_events(True)), *args)
    assert [g[0] for g in mixed["idle_gaps"]] != [
        g[0] for g in plain["idle_gaps"]]


EMPTY = [{}, {"kind": "serve", "profile": None, "program": None},
         {"kind": "train", "profile": {"steps": 2}},
         {"kind": "serve", "program": {"spans": {}, "counters": {}},
          "profile": {"program": {"ranges": {}}}},
         {"kind": "train", "program": {"spans": {}, "counters": {}},
          "profile": {"steps": 2, "program": {"ranges": {}}}}]


@pytest.mark.parametrize("name", sorted(program_trace.READERS))
@pytest.mark.parametrize("rec", EMPTY)
def test_readers_give_none_where_there_is_nothing_to_read(name, rec):
    assert program_trace.READERS[name](rec) is None


def test_readers_on_a_record():
    rng = dict(calls=2, device_s=0.0, launches=0, idle_s=0.0,
               total_device_s=0.25, total_launches=9000, total_idle_s=0.2)
    serve_rec = {"kind": "serve",
                 "program": {"spans": {"decode": {"calls": 4,
                                                  "host_s": 0.6}},
                             "counters": {"decode.phases": 4,
                                          "kv.copy_bytes.append": 4e9,
                                          "kv.copy_bytes.select": 2e9,
                                          "kv.copy_bytes.insert": 9e9}},
                 "profile": {"program": {"ranges": {"decode": rng}}}}
    m = {k: f(serve_rec) for k, f in program_trace.READERS.items()}
    assert m["decode_step_ms.code"] == pytest.approx(150.0)
    assert m["decode_launches.code"] == 4500
    assert m["decode_idle_ms.code"] == pytest.approx(100.0)
    assert m["kv_copy_mb.code"] == pytest.approx(1500.0)   # not "insert"
    assert m["grad_ms.train"] is None
    train_rec = {"kind": "train", "profile": {"steps": 2, "program": {
        "ranges": {"grad.ffn_act": rng, "grad.qkv_proj": rng,
                   "train.backward": rng}}}}
    m = {k: f(train_rec) for k, f in program_trace.READERS.items()}
    assert m["grad_ms.train"] == pytest.approx(250.0)
    assert m["backward_idle_ms.train"] == pytest.approx(100.0)
    assert m["decode_step_ms.code"] is None


def _store_bytes(cfg: dict, setup: dict) -> int:
    """One tiered K or V store of the pool, from the cell's sizes."""
    S, L, W = setup["slots"], setup["max_len"], setup["kv_hot_window"]
    Hkv, Dh = cfg["num_key_value_heads"], cfg["head_dim"]
    item = 2 if setup["dtype"] == "bfloat16" else 4
    return S * (L * Hkv * Dh + L * Hkv * 4 + W * Hkv * Dh * item
                + -(-L // 128) * 4)


def test_a_serving_run_reads_its_window_and_restores_the_harness(
        monkeypatch):
    from repro_torch.runtime import trace
    small.fixed_clock(monkeypatch)
    cell = small.cell("stablelm-code")
    saved = (serve.Phases.mark, work.peaks, profiling.read)
    out = program_trace.run_with_spans(cell, 31, 0.5, False, "cpu",
                                       time.perf_counter())
    assert (serve.Phases.mark, work.peaks, profiling.read) == saved
    assert not trace.enabled()
    rec = out["rec"]
    assert out["result"]["correct"]
    spans, c = rec["program"]["spans"], rec["program"]["counters"]
    assert spans["decode"]["calls"] == c["decode.phases"] > 0
    assert spans["step"]["calls"] == len(rec["steps"])
    pool = 2 * cell.config["num_hidden_layers"] * _store_bytes(cell.config,
                                                              cell.setup)
    assert program_trace.kv_copy_mb(rec) == pytest.approx(3 * pool / 1e6,
                                                          rel=1e-12)
    assert program_trace.decode_step_ms(rec) > 0
    assert "setup.backend" in rec["program_setup"]["spans"]


def test_a_training_run_reads_its_window(monkeypatch):
    small.fixed_clock(monkeypatch)
    cell = small.cell("fastvlm-train")
    out = program_trace.run_with_spans(cell, 41, 0.2, False, "cpu",
                                       time.perf_counter())
    spans = out["rec"]["program"]["spans"]
    n = out["rec"]["train_steps"]
    for name in ("train.forward", "train.backward", "train.optimizer",
                 "train.clip", "grad.attn_stream", "grad.ffn_act",
                 "grad.fused_norm", "grad.qkv_proj"):
        assert spans[name]["calls"] % n == 0 and spans[name]["calls"], name
    assert spans["train.forward"]["calls"] == n


def test_a_run_whose_window_edge_is_not_found_fails(monkeypatch):
    from repro_torch.runtime import trace
    small.fixed_clock(monkeypatch)
    monkeypatch.setitem(program_trace.OPENS, "train", "no such mark")
    saved = (serve.Phases.mark, work.peaks, profiling.read)
    with pytest.raises(program_trace.WindowNotFound, match="opening"):
        program_trace.run_with_spans(small.cell("fastvlm-train"), 43, 0.2,
                                     False, "cpu", time.perf_counter())
    assert (serve.Phases.mark, work.peaks, profiling.read) == saved
    assert not trace.enabled()
