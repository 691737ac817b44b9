"""The profiled window's arithmetic on made-up events: the union of busy
intervals, idle gaps named by the host's innermost range and operation,
and ranges installed and removed around attributes."""

from __future__ import annotations

import types

import pytest

from chipbench import profiling


def test_union_of_overlapping_intervals():
    total, merged = profiling._union([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert total == 5
    assert merged == [[0, 3], [5, 7]]


def _ev(name, start, end, thread=1):
    return types.SimpleNamespace(name=name, thread=thread,
                                 time_range=types.SimpleNamespace(
                                     start=start, end=end))


def test_gaps_are_named_by_the_host_range_and_operation():
    cpu = [_ev("chipbench::step", 0, 200), _ev("chipbench::decode", 10, 90),
           _ev("aten::copy_", 40, 60), _ev("aten::item", 70, 95),
           _ev("chipbench::step", 100, 200, thread=2),
           _ev("aten::mm", 100, 130, thread=2)]
    merged = [[0, 40], [50, 70], [80, 100], [120, 140]]
    gaps = dict(profiling._gaps(merged, cpu, 1))
    # the third gap opens in another thread's product; only the main
    # thread's ranges name a gap
    assert gaps == {"decode > aten::copy_": pytest.approx(10e-6),
                    "decode > aten::item": pytest.approx(10e-6),
                    "step > aten::mm": pytest.approx(20e-6)}


def test_spans_wrap_and_restore_attributes():
    mod = types.SimpleNamespace(f=lambda x: x + 1)
    inst = type("C", (), {"g": lambda self, x: 2 * x})()
    sp = profiling.Spans()
    sp.add(mod, "f", "eff", lambda x: 0.5)
    sp.add(inst, "g", lambda x: f"gee{x}")
    orig = mod.f
    with sp:
        assert mod.f(1) == 2 and inst.g(3) == 6
        assert mod.f is not orig
    assert mod.f is orig and "g" not in vars(inst)
    assert sp.account == {"eff": {"calls": 1, "bound_s": 0.5},
                          "gee3": {"calls": 1, "bound_s": 0.0}}
