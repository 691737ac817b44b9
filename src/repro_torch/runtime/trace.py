"""Named spans and counters inside the port, on the clock of the device
trace.

``span(name)`` brackets a piece of the program: ``with span("attn.kernel"):
...``; ``@traced(name)`` runs every call of a function inside one.
``count(name, n)`` adds to a counter; ``count_bytes(name, tree)`` adds
the bytes of a tensor tree's leaves (``numel() * element_size()``, from
shapes alone).

Off (the default), `span` checks one module-level flag and returns a
shared no-op object, and `count` / `count_bytes` return at once: nothing
is allocated, no torch function is called, nothing syncs the device.

On (`enable`), a span opens a profiler range "repro::<name>" (the
RecordFunction that ``torch.profiler.record_function`` opens, through
its light entry ``torch._C._profiler._RecordFunctionFast``, ~15x cheaper
to open): under a running `torch.profiler.profile` the range lies in the
same trace as the device events, on their clock, nested under whatever
range is open on the calling thread (the autograd engine's thread runs
the backward's spans). Each span also adds its call and its host seconds
(`time.perf_counter`) to an in-process account, and each counter its
amount; `snapshot` returns both, `reset` zeroes them.

The names, the layer each belongs to and the metric each feeds are
listed in PERF.md (section 3).
"""

from __future__ import annotations

import functools
import threading
import time

import torch

PREFIX = "repro::"
_RANGE = torch._C._profiler._RecordFunctionFast

_ON = False
_LOCK = threading.Lock()
_SPANS: dict[str, list] = {}        # name -> [calls, host seconds]
_COUNTERS: dict[str, int] = {}


class _Off:
    """The span returned while tracing is off: enters and exits, nothing
    else (one object shared by every call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _RANGE(PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        with _LOCK:
            acc = _SPANS.get(self.name)
            if acc is None:
                _SPANS[self.name] = [1, dt]
            else:
                acc[0] += 1
                acc[1] += dt
        return False


def span(name: str):
    """A context manager around one piece of work named ``name``."""
    if not _ON:
        return _OFF
    return _Span(name)


def traced(name: str):
    """``@traced(name)``: every call of the decorated function runs
    inside ``span(name)`` (the flag is read at call time)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if not _ON:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _ON:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def count_bytes(name: str, tree) -> None:
    """Add to the counter ``name`` the bytes of every tensor in ``tree``
    (a tensor, or nested dicts / lists / tuples of them)."""
    if not _ON:
        return
    count(name, _nbytes(tree))


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def enabled() -> bool:
    return _ON


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def reset() -> None:
    """Zero the account and the counters (the flag is left as it is)."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def snapshot() -> dict:
    """{"spans": {name: {"calls", "host_s"}}, "counters": {name: n}}
    since the last `reset`."""
    with _LOCK:
        return {"spans": {n: {"calls": c, "host_s": s}
                          for n, (c, s) in sorted(_SPANS.items())},
                "counters": dict(sorted(_COUNTERS.items()))}
