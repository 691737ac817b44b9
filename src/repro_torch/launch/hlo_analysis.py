"""Roofline terms of one step, from a walk of its dispatched ops: port of
the reference's `launch/hlo_analysis.py`.

The reference compiles a step for the production mesh and re-derives
FLOPs, bytes and collective traffic from the optimized HLO text, with
execution multiplicities (XLA's cost analysis counts a while-loop body
once). The port has no compiled program to parse. `analyze` runs the
step once on meta tensors (shapes and dtypes, no storage) at one rank's
local shapes, under a `TorchDispatchMode`, and counts what each
dispatched aten op would do. Every layer executes in Python, so there is
no loop multiplicity to correct. It aggregates, per device (one rank):

  - FLOPs as `torch.utils.flop_counter.FlopCounterMode` counts them (the
    matmul family, convolutions, attention: 2 per multiply-add);
    ``recompute_flops`` is the part spent by `kernels.ops.KernelGrad`'s
    backward rerunning the plain twin's forward, which the reference's
    plain-path gradient does not do;
  - bytes accessed: operands + outputs of each executed op. Views and
    the ops of the reference's ``_SKIP_BYTES_OPS`` (bitcast / reshape:
    every view and `_unsafe_view`; broadcast / iota / constant: `expand`
    and the creation ops) are not counted. A hand-written kernel's call
    (`kernels.ops`) is counted at its call site, from its operands and
    outputs only, as the reference counts a fusion at its call site;
  - collective bytes by the reference's kind names (plus the port's
    ``broadcast``), from `sharding`'s counters: each wrapper's calls and
    the bytes of its result at the rank's local shape;
  - ``temp_bytes``: the peak of the bytes of the storages created during
    the walk and alive at once (each storage counted once, freed when
    its last reference drops). A kernel call's temporaries are not
    counted, only its outputs.

Roofline terms (NVIDIA H100 SXM, one card):
  compute    = FLOPs / 989 TFLOP/s (bf16 dense tensor cores)
  memory     = bytes / 3.35 TB/s (HBM3)
  collective = collective bytes / 450 GB/s (NVLink 4: 900 GB/s a card,
               450 GB/s each direction)
A mesh axis wider than one 8-card NVLink node crosses InfiniBand (about
50 GB/s a card), so on the production meshes the collective term is a
lower bound. These are analytic figures, not measurements.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as S
from repro_torch.kernels import ops

# NVIDIA H100 SXM constants, one card
PEAK_FLOPS = 989e12         # bf16 dense FLOP/s
HBM_BW = 3.35e12            # B/s
NVLINK_BW = 450e9           # B/s, NVLink 4, one direction

# the reference's kinds, then the port's own
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")

_aten = torch.ops.aten
# the reference's _SKIP_BYTES_OPS beyond the views: reshape (a copy-free
# view the autograd graph does not track), broadcast / iota / constant
_SKIP_BYTES = {
    _aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten.zeros, _aten.zeros_like,
    _aten.new_zeros, _aten.ones, _aten.ones_like, _aten.new_ones,
    _aten.full, _aten.full_like, _aten.new_full, _aten.scalar_tensor,
    _aten.arange, _aten.linspace, _aten.lift_fresh, _aten.lift_fresh_copy}


def tensors_of(tree) -> list[torch.Tensor]:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        vals = tree.values()
    elif isinstance(tree, (list, tuple)):
        vals = tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        vals = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        return []
    return [t for v in vals for t in tensors_of(v)]


def nbytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Walk(TorchDispatchMode):
    """The dispatch mode under `FlopCounterMode`: bytes, storages and
    the kernel call sites (`kernels.ops.WALK` while it runs)."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flop_counter = flops
        self.bytes = 0
        self.recompute_flops = 0
        self.live: dict[int, int] = {}
        self.cur = self.peak = 0
        self.site: set[int] | None = None    # storages made in a call site

    # ---- storages --------------------------------------------------------
    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def _track(self, outs: list[torch.Tensor], seen: set[int]) -> None:
        for t in outs:
            if t.layout != torch.strided:
                continue
            k = _key(t)
            if k in self.live or k in seen:
                continue
            seen.add(k)
            if self.site is not None:
                self.site.add(k)
                continue
            st = t.untyped_storage()
            self.live[k] = st.nbytes()
            self.cur += self.live[k]
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._free, k)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tensors_of((args, kwargs))
        self._track(tensors_of(out), {_key(t) for t in ins
                                    if t.layout == torch.strided})
        if self.site is None and not func.is_view \
                and func._overloadpacket not in _SKIP_BYTES:
            self.bytes += nbytes(ins) + nbytes(out)
        return out

    # ---- kernels.ops hooks -------------------------------------------------
    def call_site(self, fn, args, kw):
        """A kernel wrapper's call: its bytes are its operands and outputs;
        its FLOPs the twin's inside it; its temporaries not live."""
        if self.site is not None:
            return fn(*args, **kw)
        self.site = set()
        try:
            out = fn(*args, **kw)
        finally:
            made, self.site = self.site, None
        outs = [t for t in tensors_of(out) if _key(t) in made]
        self._track(outs, set())
        self.bytes += nbytes((args, kw)) + nbytes(out)
        return out

    def recompute(self, plain, xs):
        """`KernelGrad`'s rerun of the twin's forward in the backward."""
        before = self.flop_counter.get_total_flops()
        out = plain(*xs)
        self.recompute_flops += self.flop_counter.get_total_flops() - before
        return out


def analyze(step, *args, **kwargs) -> dict:
    """Run ``step(*args, **kwargs)`` once (on meta tensors: nothing is
    computed) and return its per-device FLOPs, recompute FLOPs, bytes,
    collective bytes and counts by kind, collective op count, temp and
    output bytes. `sharding`'s counters are left as they were found."""
    saved = S.COUNTS.copy(), S.BYTES.copy()
    S.reset_counts()
    flops = FlopCounterMode(display=False)
    walk = _Walk(flops)
    prev, ops.WALK = ops.WALK, walk
    try:
        with walk, flops:
            out = step(*args, **kwargs)
        counts, moved = S.counts_by_kind(), S.bytes_by_kind()
    finally:
        ops.WALK = prev
        S.reset_counts()
        S.COUNTS.update(saved[0])
        S.BYTES.update(saved[1])
    coll = {k: float(moved.get(k, 0)) for k in KINDS}
    coll.update({k: float(v) for k, v in moved.items() if k not in coll})
    return {
        "flops": float(flops.get_total_flops()),
        "recompute_flops": float(walk.recompute_flops),
        "bytes": float(walk.bytes),
        "collective_bytes": coll,
        "collective_total": float(sum(moved.values())),
        "collective_op_count": int(sum(counts.values())),
        "collective_counts": counts,
        "temp_bytes": int(walk.peak),
        "output_bytes": nbytes(out),
    }


# ---------------------------------------------------------------------------
# public API used by dryrun.py
# ---------------------------------------------------------------------------
def collective_bytes(a: dict) -> dict:
    """An `analyze` result in the reference's ``collectives`` keys (the
    walk's FLOPs and bytes as ``hlo_flops`` / ``hlo_bytes``), plus the
    recompute FLOPs and the counts by kind."""
    return {
        "ops": a["collective_op_count"],
        "by_kind": a["collective_bytes"],
        "total": a["collective_total"],
        "hlo_flops": a["flops"],
        "hlo_bytes": a["bytes"],
        "recompute_flops": a["recompute_flops"],
        "counts": a["collective_counts"],
    }


def model_flops(params_active: int, shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D inference (D = processed tokens)."""
    if shape.kind == "train":
        return 6.0 * params_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * params_active * shape.global_batch * shape.seq_len
    return 2.0 * params_active * shape.global_batch


def roofline_terms(result: dict, shape) -> dict:
    n_chips = result["n_chips"]
    coll = result["collectives"]
    # the walk's figures; the cost fields where a result has none
    flops_dev = coll.get("hlo_flops") or \
        (result["cost"]["flops_per_device"] or 0.0)
    bytes_dev = coll.get("hlo_bytes") or \
        (result["cost"]["bytes_accessed_per_device"] or 0.0)
    coll_dev = coll["total"]

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(result["active_params"], shape)
    hlo_flops_total = flops_dev * n_chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": terms[dominant],
        "model_flops": mf,
        "hlo_flops_total": hlo_flops_total,
        "useful_flops_ratio": (mf / hlo_flops_total
                               if hlo_flops_total else None),
        "roofline_fraction": (compute_s / terms[dominant]
                              if terms[dominant] else None),
    }
