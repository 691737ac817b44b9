"""The profiled window of a ``--trace 1`` run, and what is read from it.

The window is a fixed number of the cell's own steps, run after the
measured window with the same load, under `torch.profiler` (CPU and
CUDA activity). It opens behind a spin kernel, synchronised: the
profiler has been seen to lose a window's first device events, and the
spin takes their place (it is left out of every sum).

Spans are ``record_function`` ranges named "chipbench::<name>", placed
from here around the program's operation-level entry points (module or
instance attributes swapped for the window, as the program looks them up
at call time). Each range's wrapper adds the least time of the work its
call does (`work`) to the range's account, so a range's roofline share
reads the same work whatever kernels run inside it.

A device event (kernel, copy, set) belongs to a range when the API call
that launched it (matched by the CUPTI correlation id) ran on the host
inside that range. The device's busy time is the union of its events'
intervals; an idle gap is named by what the host was doing when it
began: the main thread's innermost "chipbench::" range and the
operation begun last on any thread.

The launches of the hand-written kernels in the window are checked
against the program's launch counters; a window that lost events is
profiled again, up to three times.
"""

from __future__ import annotations

import bisect
import sys
import time

CLOCK = time.perf_counter
SPIN_CYCLES = 10_000_000          # ~5 ms at the H100's clock
PREFIX = "chipbench::"

# the first kernel each wrapper launches a call, by name (one a call)
HEAD_KERNELS = {
    ("fused_norm",): ("fused_norm_kernel",),
    ("qkv_proj",): ("qkv_gemv_kernel", "qkv_wgmma_kernel", "qkv_fma_kernel",
                    "qkv_tf32_kernel"),
    ("attn_stream",): ("attn_wgmma_kernel", "attn_fma_kernel",
                       "attn_tf32_kernel"),
    ("ffn_act", "ffn_act_int8"): ("ffn_stream_mma_kernel", "ffn_up_kernel",
                                  "ffn_act_kernel", "ffn_up_tf32_kernel"),
    ("paged_decode_tiered",): ("paged_decode_tiered_kernel",),
    ("paged_decode_flat",): ("paged_decode_flat_kernel",)}


class Spans:
    """Ranges around attributes, installed while the context is open.
    ``add(obj, attr, name, work)``: calls of ``obj.attr`` run inside
    "chipbench::<name>" (a callable ``name`` is called with the call's
    arguments) and ``work(*args, **kw)`` returns the call's least time
    (or None); ``account[name]`` sums the calls and their least times."""

    def __init__(self):
        self._targets = []
        self._saved = []
        self.account: dict[str, dict] = {}

    def add(self, obj, attr: str, name, work=None) -> None:
        self._targets.append((obj, attr, name, work))

    def __enter__(self):
        import torch
        self.account = {}
        for obj, attr, name, work in self._targets:
            fn = getattr(obj, attr)

            def ranged(*a, _fn=fn, _name=name, _work=work, **kw):
                n = _name(*a, **kw) if callable(_name) else _name
                with torch.profiler.record_function(PREFIX + n):
                    out = _fn(*a, **kw)
                acc = self.account.setdefault(n, {"calls": 0, "bound_s": 0.0})
                acc["calls"] += 1
                if _work is not None:
                    acc["bound_s"] += _work(*a, **kw) or 0.0
                return out
            self._saved.append((obj, attr, fn, attr in vars(obj)))
            setattr(obj, attr, ranged)
        return self

    def __exit__(self, *exc):
        for obj, attr, fn, own in reversed(self._saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
        self._saved = []
        return False


def _union(intervals: list) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _is_device(e, cuda) -> bool:
    return (e.device_type == cuda and not getattr(e, "is_user_annotation",
                                                   False)
            and "spin_kernel" not in e.name)


def read(prof, window_s: float, counts: dict, account: dict) -> dict:
    """What the traced window says: busy seconds, the device events and
    their names, each range's device seconds and least time, the top
    device operations, the longest idle gaps by the host's range and
    operation, and the hand-written kernels' launches against their
    counters."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    dev = [e for e in evs if _is_device(e, DeviceType.CUDA)]
    cpu = [e for e in evs if e.device_type == DeviceType.CPU
           and not e.is_async]
    busy_us, merged = _union([(e.time_range.start, e.time_range.end)
                              for e in dev])
    steps = [e for e in cpu if e.name == PREFIX + "step"]
    main = steps[0].thread if steps else None
    # ranges on the main thread, by name
    ranges: dict[str, list] = {}
    for e in cpu:
        if e.name.startswith(PREFIX) and e.thread == main:
            ranges.setdefault(e.name[len(PREFIX):], []).append(
                (e.time_range.start, e.time_range.end, e))
    for v in ranges.values():
        v.sort(key=lambda r: r[0])
    starts = {n: [r[0] for r in v] for n, v in ranges.items()}
    # the launching API call of each device event, by correlation id
    api = {e.id: e.time_range.start for e in cpu
           if e.name.startswith("cu") and e.id}
    dev_s = {n: 0.0 for n in ranges}
    launches = {n: 0 for n in ranges}
    unmatched = 0.0
    for e in dev:
        t = api.get(e.id)
        dur = e.time_range.end - e.time_range.start
        if t is None:
            unmatched += dur
            continue
        for n, v in ranges.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and v[i][1] >= t:
                dev_s[n] += dur
                launches[n] += 1
    total_us = sum(e.time_range.end - e.time_range.start for e in dev)
    tree_step_us = sum(r[2].device_time_total for r in ranges.get("step", []))
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = _gaps(merged, cpu, main)
    check = {}
    for wrappers, names in HEAD_KERNELS.items():
        want = sum(counts.get(w, 0) for w in wrappers)
        got = sum(1 for e in dev if any(n in e.name for n in names))
        check["+".join(wrappers)] = {"counter": want, "profile": got}
    return {
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "device_events": len(dev),
        "device_s_total": total_us / 1e6,
        "unmatched_s": unmatched / 1e6,
        "step_tree_s": tree_step_us / 1e6,
        "ranges": {n: {"device_s": dev_s[n] / 1e6,
                       "launches": launches[n],
                       "calls": account.get(n, {}).get("calls",
                                                       len(ranges[n])),
                       "bound_s": account.get(n, {}).get("bound_s", 0.0)}
                   for n in ranges},
        "device_ops": [[k, v / 1e6] for k, v in top],
        "idle_gaps": gaps,
        "launch_check": check,
        "launch_check_ok": all(v["counter"] == v["profile"]
                               for v in check.values()),
    }


def _gaps(merged: list, cpu: list, main) -> list:
    """The idle gaps between merged device intervals, summed by what the
    host was doing when each began: "<range> > <operation>", the range
    the main thread was in and the operation that began last on any
    thread (the autograd engine launches a backward from its own)."""
    evs = sorted((e.time_range.start, e.time_range.end, e.name,
                  e.thread == main) for e in cpu)
    out: dict[str, float] = {}
    active: list = []
    j = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while j < len(evs) and evs[j][0] <= a:
            active.append(evs[j])
            j += 1
        active = [r for r in active if r[1] > a]
        rng = [r for r in active if r[2].startswith(PREFIX) and r[3]]
        ops = [r for r in active if not r[2].startswith(PREFIX)]
        name = (max(rng)[2][len(PREFIX):] if rng else "outside ranges")
        if ops:
            name += " > " + max(ops)[2]
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(out.items(),
                                      key=lambda kv: -kv[1])[:10]]


def window(run_steps, spans: Spans, launch_counts, tries: int = 3) -> dict:
    """Profile ``run_steps()`` (which runs the window's steps and returns
    a dict of counts) inside ``spans``; again, up to ``tries`` windows,
    while the hand-written kernels' launches in the profile differ from
    their counters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rec = None
    for attempt in range(tries):
        c0 = launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = CLOCK()
            with spans:
                info = run_steps()
            torch.cuda.synchronize()
            t1 = CLOCK()
        c1 = launch_counts()
        counts = {k: c1[k] - c0.get(k, 0) for k in c1}
        rec = read(prof, t1 - t0, counts, spans.account)
        rec.update(info, attempts=attempt + 1)
        print(f"[chipbench] profiled window {attempt + 1}: "
              f"{rec['device_events']} device events, busy "
              f"{rec['busy_s']:.4f} of {rec['window_s']:.4f} s; device time "
              f"{rec['device_s_total']:.4f} s, {rec['unmatched_s']:.4f} s of "
              f"it with no launching call found, {rec['step_tree_s']:.4f} s "
              f"under the step ranges by the profiler's own tree",
              file=sys.stderr)
        if rec["launch_check_ok"]:
            break
        print(f"[chipbench] profiled window {attempt + 1}: launches in the "
              f"profile differ from the counters: {rec['launch_check']}",
              file=sys.stderr)
    return rec

