"""A cell's run with the program's own spans on, and what is read from
them.

    python3 chipbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--record <path>]

The program (``src/repro_torch``) brackets its work in spans named
"repro::<name>" and counts its KV copies (`repro_torch.runtime.trace`);
they are off unless turned on. This script runs a cell as `run.py` does,
with them on from process start (a run with them off is `run.py`'s):
the set-up's account is kept when the measured window opens, the
account is then zeroed, and the window's is kept when it closes
(``rec["program"]``); the spans stay on through the profiled window. The harness's own files
are used as they are: the window's edges are found by wrapping
`serve.Phases.mark` (the last set-up phase's mark opens the window) and
`work.peaks` (called first once the window has closed), and the profile
is read by `profiling.read` on the events without "repro::" ranges, so
every key it gives reads as without the spans, plus a ``program`` key
(`read`) from every event. A run in which either edge is not found fails
(`WindowNotFound`, exit code 1) rather than give the whole run's account
as the window's.

The last line of standard output is one JSON object: `run.py`'s result,
``program_metrics`` (the readers below: None where the record holds
nothing to read, never 0), ``program`` (the window's account) and, with
``--trace 1``, ``program_profile`` (`read`) and ``consistency``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# run as a script, this file's directory heads sys.path, where its
# sibling modules would shadow top-level ones (``profile``)
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

PREFIX = "repro::"
# the set-up phase whose mark opens the measured window, by cell kind
OPENS = {"serve": "fill", "train": "checked steps"}


# ---------------------------------------------------------------------------
# the profile: device time, launches and idle by the program's ranges
# ---------------------------------------------------------------------------
class _Open:
    """The program's ranges open at a moment of a host sweep: a stack a
    thread (a thread's ranges nest)."""

    def __init__(self):
        self.stacks: dict = {}

    def push(self, inst):
        self.stacks.setdefault(inst[3], []).append(inst)

    def pop(self, inst):
        st = self.stacks[inst[3]]
        for i in range(len(st) - 1, -1, -1):
            if st[i] is inst:
                del st[i]
                return

    def owner(self, thread):
        """The innermost range open on ``thread``; where it has none (or
        ``thread`` is None), the range begun last on any thread."""
        st = self.stacks.get(thread)
        if st:
            return st[-1]
        tops = [s[-1] for s in self.stacks.values() if s]
        return max(tops, key=lambda r: (r[0], -r[1])) if tops else None


def read(events, launch_names=("cu",)) -> dict:
    """The program's ranges in a list of profiler events (each with
    ``name``, ``thread``, ``time_range``, ``id``, ``device_type``,
    ``is_async``; device events as `profiling.read` keeps them).

    A device event belongs to the innermost "repro::" range open on the
    thread of its launching call (a CPU event named "cu..." with its
    correlation id) at the call's start, and where that thread has none
    open, to the range begun last on any thread (the autograd engine's
    thread runs a backward outside the caller's ranges). An idle gap
    between the device's busy intervals belongs to the range begun last
    of those open at the gap's start, on any thread. A range's parent is
    the range that owns its start, found the same way, so the autograd
    thread's ranges nest under the caller's.

    Returns {"ranges": {name: {calls, device_s, launches, idle_s,
    total_device_s, total_launches, total_idle_s}}, "paths": {path:
    {device_s, launches, idle_s}}, "outside": {...}}: a range's own
    figures and, as total_*, its own with every range nested in it (a
    name counted once a chain); by path ("decode > backend.decode >
    ..."), the own figures of the ranges at that place in the nesting."""
    from torch.autograd import DeviceType

    from chipbench import profiling
    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and not e.is_async]
    dev = [e for e in events if profiling._is_device(e, DeviceType.CUDA)]
    insts = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):],
              e.thread) for e in cpu if e.name.startswith(PREFIX)]
    api = {e.id: (e.time_range.start, e.thread) for e in cpu
           if e.id and e.name.startswith(launch_names)}
    _, merged = profiling._union([(e.time_range.start, e.time_range.end)
                                  for e in dev])
    # sweep: at one moment, starts (outer first), then queries, then ends
    marks = []
    for r in insts:
        marks.append((r[0], 0, -r[1], r))
        marks.append((r[1], 2, 0, r))
    launches = []
    for e in dev:
        a = api.get(e.id)
        if a is not None:
            launches.append((a[0], 1, 0, ("launch", a[1],
                                          e.time_range.end
                                          - e.time_range.start)))
    unmatched = sum(e.time_range.end - e.time_range.start for e in dev
                    if e.id not in api)
    gaps = [(a, 1, 0, ("gap", None, b - a))
            for (_, a), (b, _) in zip(merged, merged[1:])]
    marks += launches + gaps
    marks.sort(key=lambda m: m[:3])
    opened = _Open()
    parent: dict = {}
    own: dict = {}                      # id(inst) -> [dev_us, n, idle_us]
    outside = [0.0, 0, 0.0]
    for _, kind, _, x in marks:
        if kind == 0:
            parent[id(x)] = opened.owner(x[3])
            opened.push(x)
        elif kind == 2:
            opened.pop(x)
        else:
            what, thread, dur = x
            r = opened.owner(thread)
            acc = outside if r is None else own.setdefault(
                id(r), [0.0, 0, 0.0])
            if what == "launch":
                acc[0] += dur
                acc[1] += 1
            else:
                acc[2] += dur
    by_id = {id(r): r for r in insts}
    out: dict = {}
    paths: dict = {}

    def path(r):
        names = []
        while r is not None:
            names.append(r[2])
            r = parent.get(id(r))
        return " > ".join(reversed(names))

    def entry(name):
        return out.setdefault(name, {
            "calls": 0, "device_s": 0.0, "launches": 0, "idle_s": 0.0,
            "total_device_s": 0.0, "total_launches": 0,
            "total_idle_s": 0.0})
    for r in insts:
        entry(r[2])["calls"] += 1
    for key, (d, n, idle) in own.items():
        r = by_id[key]
        o = entry(r[2])
        o["device_s"] += d / 1e6
        o["launches"] += n
        o["idle_s"] += idle / 1e6
        q = paths.setdefault(path(r), {"device_s": 0.0, "launches": 0,
                                       "idle_s": 0.0})
        q["device_s"] += d / 1e6
        q["launches"] += n
        q["idle_s"] += idle / 1e6
        seen = set()
        while r is not None:
            if r[2] not in seen:
                seen.add(r[2])
                t = entry(r[2])
                t["total_device_s"] += d / 1e6
                t["total_launches"] += n
                t["total_idle_s"] += idle / 1e6
            r = parent.get(id(r))
    return {"ranges": dict(sorted(out.items())),
            "paths": dict(sorted(paths.items())),
            "outside": {"device_s": outside[0] / 1e6,
                        "launches": outside[1],
                        "idle_s": outside[2] / 1e6,
                        "unmatched_s": unmatched / 1e6}}


def _read_both(orig):
    """`profiling.read` on the events without "repro::" ranges, and the
    program's ranges (`read`) from every event, as its ``program``."""
    def read_profile(prof, window_s, counts, account):
        evs = list(prof.events())
        rest = [e for e in evs if not e.name.startswith(PREFIX)]
        out = orig(types.SimpleNamespace(events=lambda: rest), window_s,
                   counts, account)
        out["program"] = read(evs)
        return out
    return read_profile


# ---------------------------------------------------------------------------
# the readers of the program's spans and counters
# ---------------------------------------------------------------------------
COPY_SITES = ("append", "restack", "select")


def _spans(rec):
    return (rec.get("program") or {}).get("spans") or {}


def _counters(rec):
    return (rec.get("program") or {}).get("counters") or {}


def _ranges(rec):
    prof = rec.get("profile") or {}
    return (prof.get("program") or {}).get("ranges") or {}


def decode_step_ms(rec):
    """Mean host ms of the engine's decode phases in the measured
    window."""
    s = _spans(rec).get("decode")
    if not s or not s["calls"]:
        return None
    return 1e3 * s["host_s"] / s["calls"]


def decode_launches(rec):
    """Device operations launched inside the engine's decode phases of
    the profiled window, a phase."""
    r = _ranges(rec).get("decode")
    if not r or not r["calls"]:
        return None
    return r["total_launches"] / r["calls"]


def decode_idle_ms(rec):
    """Device-idle ms whose gaps open inside a decode phase of the
    profiled window, a phase."""
    r = _ranges(rec).get("decode")
    if not r or not r["calls"]:
        return None
    return 1e3 * r["total_idle_s"] / r["calls"]


def kv_copy_mb(rec):
    """Bytes the decode step's KV copies wrote in the measured window
    (the append's, the restack's and the slot select's), a decode phase,
    in 1e6 B."""
    c = _counters(rec)
    n = c.get("decode.phases")
    if not n or not any(f"kv.copy_bytes.{s}" in c for s in COPY_SITES):
        return None
    return sum(c.get(f"kv.copy_bytes.{s}", 0) for s in COPY_SITES) / n / 1e6


def _train_steps(rec):
    prof = rec.get("profile") or {}
    return prof.get("steps") if rec.get("kind") == "train" else None


def grad_ms(rec):
    """Device ms a train step of the operations launched inside the
    kernels' backward (the "grad.<wrapper>" ranges), profiled window."""
    steps = _train_steps(rec)
    g = [r["total_device_s"] for n, r in _ranges(rec).items()
         if n.startswith("grad.")]
    if not steps or not g:
        return None
    return 1e3 * sum(g) / steps


def backward_idle_ms(rec):
    """Device-idle ms a train step whose gaps open inside the backward,
    profiled window."""
    steps = _train_steps(rec)
    r = _ranges(rec).get("train.backward")
    if not steps or not r:
        return None
    return 1e3 * r["total_idle_s"] / steps


READERS = {"decode_step_ms.code": decode_step_ms,
           "decode_launches.code": decode_launches,
           "decode_idle_ms.code": decode_idle_ms,
           "kv_copy_mb.code": kv_copy_mb,
           "grad_ms.train": grad_ms,
           "backward_idle_ms.train": backward_idle_ms}


def consistency(rec) -> dict:
    """The program's ranges against the harness's: launches under the
    decode phase and under the backend's decode call; device time under
    the train step's forward and backward and under the harness's
    forward-backward range."""
    prof = rec.get("profile") or {}
    ours, theirs = _ranges(rec), prof.get("ranges") or {}
    out = {}
    if "decode" in ours and "decode" in theirs:
        out["decode_launches"] = {"program": ours["decode"]["total_launches"],
                                  "harness": theirs["decode"]["launches"]}
    if "forward_backward" in theirs:
        fb = sum(ours.get(n, {}).get("total_device_s", 0.0)
                 for n in ("train.forward", "train.backward"))
        h = theirs["forward_backward"]["device_s"]
        out["forward_backward_s"] = {"program": fb, "harness": h,
                                     "share": fb / h if h else None}
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
class WindowNotFound(RuntimeError):
    """The harness's window edges were not where `_Hooks` looks for them
    (the mark named in `OPENS`, the first call to `work.peaks`)."""


class _Hooks:
    """The program's spans turned on for one run and read at the
    harness's window edges, by wrapping the harness's functions."""

    def __init__(self, kind: str):
        from chipbench import profiling, serve, work
        from repro_torch.runtime import trace
        self.trace = trace
        self.setup = self.window = None
        self._saved = [(o, a, getattr(o, a)) for o, a in (
            (serve.Phases, "mark"), (work, "peaks"), (profiling, "read"))]
        mark, peaks, read_profile = (f for _, _, f in self._saved)
        hooks = self

        def opening(phases, name):
            out = mark(phases, name)
            if name == OPENS[kind]:
                hooks.setup = trace.snapshot()
                trace.reset()
            return out

        def closing(*a, **kw):
            if hooks.window is None:
                hooks.window = trace.snapshot()
            return peaks(*a, **kw)
        serve.Phases.mark = opening
        work.peaks = closing
        profiling.read = _read_both(read_profile)
        trace.reset()
        trace.enable()

    def restore(self):
        self.trace.disable()
        for obj, attr, fn in self._saved:
            setattr(obj, attr, fn)


def run_with_spans(cell, seed: int, seconds: float, trace: bool,
                   device: str, t_start: float) -> dict:
    """`run.run_cell` with the program's spans on: its record gains
    ``program`` (the measured window's account) and ``program_setup``
    (the set-up's), and with a profiled window ``profile["program"]``.
    Raises `WindowNotFound` if either edge of the window was not seen."""
    from chipbench import run
    hooks = _Hooks(cell.setup["kind"])
    try:
        out = run.run_cell(cell, seed, seconds, trace, device, t_start)
    finally:
        hooks.restore()
    if hooks.setup is None or hooks.window is None:
        edge = "opening" if hooks.setup is None else "close"
        raise WindowNotFound(
            f"the measured window's {edge} was not seen (the mark "
            f"{OPENS[cell.setup['kind']]!r}, the first work.peaks call)")
    out["rec"]["program"] = hooks.window
    out["rec"]["program_setup"] = hooks.setup
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None,
                    help="also write the run's record (JSON) to this path")
    args = ap.parse_args(argv)
    from chipbench import run, spec
    root = CHECKOUT
    if not (root / "src" / "repro_torch" / "runtime" / "trace.py").is_file():
        print("[program_trace] the checkout's program has no spans "
              "(src/repro_torch/runtime/trace.py)", file=sys.stderr)
        return 2
    run.prepare_env(root)
    cell = spec.cell(args.workload, root)
    import torch
    if not torch.cuda.is_available():
        print("[program_trace] no CUDA card", file=sys.stderr)
        return 2
    try:
        out = run_with_spans(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    except WindowNotFound as e:
        print(f"[program_trace] {e}", file=sys.stderr)
        return 1
    rec = out["rec"]
    res = {"result": out["result"],
           "program_metrics": {k: f(rec) for k, f in READERS.items()},
           "program": rec.get("program"),
           "program_setup": rec.get("program_setup")}
    if args.trace and rec.get("profile"):
        res["program_profile"] = rec["profile"].get("program")
        res["consistency"] = consistency(rec)
    if args.record:
        with open(args.record, "w") as f:
            json.dump({"res": res, "numbers": out["numbers"], "rec": rec},
                      f, default=str)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
