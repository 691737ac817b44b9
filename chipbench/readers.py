"""The arithmetic the metric files (`metrics/*.py`) share. Each takes a
run's record (`serve.run` / `train.run`) and returns a number, or None
where the record holds nothing to read (never 0 for a share)."""

from __future__ import annotations

import math
import statistics


def percentile(values: list, q: float) -> float:
    """The q-th percentile of every value (linear between the two
    nearest ranks, numpy's default); an infinite value (a request that
    never answered) counts as the slowest."""
    vals = sorted(values)
    if not vals:
        return math.nan
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    if math.isinf(vals[hi]) or math.isinf(vals[lo]):
        return math.inf
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def output_tok_s(rec: dict):
    if rec.get("kind") != "serve":
        return None
    return rec["tokens_in_window"] / rec["window_s"]


def ttft_ms(rec: dict, q: float):
    """The q-th percentile over every request sent in the window of the
    time from its sending to its first token."""
    if rec.get("kind") != "serve" or not rec["requests"]:
        return None
    return percentile([math.inf if r["first"] is None
                       else 1e3 * (r["first"] - r["sent"])
                       for r in rec["requests"]], q)


def prefill_step_ms(rec: dict):
    """Mean host time of the window's `Engine.step()` calls that carried
    a prefill chunk."""
    if rec.get("kind") != "serve":
        return None
    ts = [1e3 * (s["t1"] - s["t0"]) for s in rec["steps"] if s["prefill"]]
    return statistics.fmean(ts) if ts else None


def _profile(rec: dict):
    return rec.get("profile") or None


def roofline(rec: dict, rng: str):
    """A range's least time over its kernels' device time, in %."""
    p = _profile(rec)
    r = p and p["ranges"].get(rng)
    if not r or r["device_s"] <= 0 or r["bound_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["device_s"]


def mfu(rec: dict):
    """The window's FLOPs (the benchmark's count) over the window times
    the card's peak, in %."""
    if not rec.get("work_flops"):
        return None
    return 100.0 * rec["work_flops"] / (rec["window_s"] * rec["peak_flops"])


def device_idle(rec: dict):
    """The share of the profiled window with no device operation, in %."""
    p = _profile(rec)
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def setup_s(rec: dict):
    return rec["setup_s"]


def train_tok_s(rec: dict):
    if rec.get("kind") != "train":
        return None
    return rec["train_tokens"] / rec["window_s"]
