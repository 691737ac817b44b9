"""The metrics' arithmetic: rates over the whole window, tails over all
requests, shares that read nothing where nothing was measured."""

from __future__ import annotations

import math
import statistics

import pytest

from chipbench import readers, spec


def _reqs(ttfts_ms):
    return [{"sent": 10.0, "first": None if t is None else 10.0 + t / 1e3,
             "done": None} for t in ttfts_ms]


def test_percentile_matches_linear_interpolation():
    vals = [float(v) for v in range(1, 101)]
    assert readers.percentile(vals, 90) == pytest.approx(90.1)
    assert readers.percentile([5.0], 90) == 5.0
    assert readers.percentile([1.0, 2.0, math.inf], 90) == math.inf


def test_tail_over_all_requests_shows_a_stall_chunk_medians_hide():
    # 120 requests, the last 15 stalled behind a 4 s pause of the engine
    ttfts = [300.0 + (i % 7) for i in range(105)] + [4000.0] * 15
    rec = {"kind": "serve", "requests": _reqs(ttfts)}
    p90 = readers.ttft_ms(rec, 90)
    assert p90 > 3000.0
    chunks = [ttfts[i:i + 10] for i in range(0, 120, 10)]
    assert statistics.median(statistics.median(c) for c in chunks) < 310.0


def test_a_request_that_never_answered_is_the_slowest():
    rec = {"kind": "serve", "requests": _reqs([100.0] * 8 + [None] * 2)}
    assert readers.ttft_ms(rec, 90) == math.inf


def test_rate_is_all_tokens_over_all_the_window():
    rec = {"kind": "serve", "tokens_in_window": 900, "window_s": 45.0,
           "steps": [], "requests": []}
    assert readers.output_tok_s(rec) == pytest.approx(20.0)
    assert readers.train_tok_s(rec) is None
    rec = {"kind": "train", "train_tokens": 2048 * 60, "window_s": 45.0}
    assert readers.train_tok_s(rec) == pytest.approx(2048 * 60 / 45.0)


def test_prefill_step_time_is_over_the_steps_that_carried_a_chunk():
    steps = [{"t0": 0.0, "t1": 0.1, "prefill": False},
             {"t0": 0.1, "t1": 0.4, "prefill": True},
             {"t0": 0.4, "t1": 0.5, "prefill": False},
             {"t0": 0.5, "t1": 1.0, "prefill": True}]
    rec = {"kind": "serve", "steps": steps}
    assert readers.prefill_step_ms(rec) == pytest.approx(400.0)
    rec["steps"] = [s for s in steps if not s["prefill"]]
    assert readers.prefill_step_ms(rec) is None


def test_shares_read_nothing_without_a_profile():
    rec = {"kind": "serve", "profile": None, "work_flops": 0,
           "window_s": 1.0, "peak_flops": 1.0}
    assert readers.roofline(rec, "attn_decode") is None
    assert readers.device_idle(rec) is None
    assert readers.mfu(rec) is None


def test_shares_from_a_profile():
    prof = {"busy_s": 0.25, "window_s": 1.0,
            "ranges": {"ffn.extend": {"device_s": 0.2, "bound_s": 0.05},
                       "attn_decode": {"device_s": 0.0, "bound_s": 0.01}}}
    rec = {"kind": "serve", "profile": prof, "work_flops": 4e12,
           "window_s": 10.0, "peak_flops": 1e15}
    assert readers.roofline(rec, "ffn.extend") == pytest.approx(25.0)
    assert readers.roofline(rec, "attn_decode") is None
    assert readers.device_idle(rec) == pytest.approx(75.0)
    assert readers.mfu(rec) == pytest.approx(0.04)


def test_metric_files_read_the_record():
    rec = {"kind": "serve", "setup_s": 12.5, "tokens_in_window": 10,
           "window_s": 2.0, "requests": _reqs([100.0, 200.0]), "steps": []}
    assert spec.reader("setup_s")(rec) == 12.5
    assert spec.reader("output_tok_s")(rec) == 5.0
    assert spec.reader("ttft_p90_ms.code")(rec) == pytest.approx(190.0)
