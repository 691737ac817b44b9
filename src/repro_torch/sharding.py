"""Logical-axis sharding rules with divisibility fallback, the placement
helpers of the sharded executor, and every collective the port issues.

Port of the reference's `sharding.py`. Every tensor dimension carries a
*logical* axis name; a rule table maps logical names to an ordered chain
of mesh-axis candidates. A candidate binds only if (a) every mesh axis in
it exists in the mesh, (b) the dimension size is divisible by the product
of the candidate axis sizes, and (c) none of its mesh axes is already
used by another dimension of the same tensor. Otherwise the resolver
falls through to the next candidate and ultimately replicates that
dimension (starcoder2's 36 query heads on an 8-way model axis replicate).
`ShardingRules.spec` returns a plain tuple that mirrors the reference's
`PartitionSpec`: per dimension None, one axis name, or a tuple of names.

Placement: a rank holds the contiguous block of every sharded dimension
its mesh coordinates select (`shard`, of shape `local_shape`), and
`unshard` all-gathers a block back to the full tensor.

Collectives. Where XLA inserts collectives implicitly, the port calls
them by hand, and only through the counted wrappers of this module, one
per kind, each over the process group of one mesh axis (or, for a tuple
of axes, over each in turn):

  * `all_reduce`     ("all-reduce", a sum or a max),
  * `all_gather`     ("all-gather", concatenated along one dimension),
  * `reduce_scatter` ("reduce-scatter"),
  * `broadcast`      ("broadcast", from one coordinate of the axis),
  * `send` / `recv`  ("collective-permute", point to point),
  * `barrier`        ("barrier"),
  * `world_max`      ("all-reduce", a max over every rank at once: the
                      fault loop's agreement, `runtime.fault`).

Serving issues all-reduces, all-gathers and broadcasts (evict, restore
and prefix blocks move by broadcast from their owner). Training issues
all-reduces, all-gathers and reduce-scatters, most of them in the
backward. `send` / `recv` have no caller yet: they are for a slot moved
between two data ranks alone (ROADMAP "Performance work", h).

Differentiation. Where autograd records (grad mode on and the input
requires a gradient) `all_reduce`, `all_gather`, `reduce_scatter` and
`enter` are `torch.autograd.Function`s; elsewhere they are the plain
collectives (serving is unchanged). The backward of a collective depends
on what consumes its output, so the call site says which it needs:

  * `all_reduce` (a sum) passes its gradient through unchanged: it is
    the exit of a tensor-parallel region (AttnOut, FFNOut, the MoE's
    expert-parallel sum, the vocab-parallel embedding), or the sum of
    the data ranks' shares of the loss, each rank's gradient being its
    own share;
  * `enter` is the matching entry: the identity forward, an all-reduce
    of the gradient backward (a replicated tensor entering
    column-parallel projections or local experts, each rank's gradient
    a partial sum);
  * `all_gather(..., backward="sum")` reduce-scatters the gradient: the
    consumer's gradient differs rank by rank (an FSDP weight gathered
    over 'data', each data rank its own batch; K/V rows gathered over
    'model' for heads split over it); ``backward="slice"`` takes the
    rank's block of it: the consumer is replicated, its gradient the
    same on every rank (vocab-split logits; a leaf gathered over
    'model' and computed replicated), and a sum would be m times it;
  * `reduce_scatter` all-gathers the gradient.

Each call adds one to `COUNTS[(scope, kind)]` and the bytes of its
result at the rank's local shape to `BYTES[(scope, kind)]` (the
reference's `hlo_analysis` counts a collective by its result shape),
``scope`` being the innermost `scope` context (the model names its
units, the embedding and the head); `core.dataflow.count_collectives`
reads the counts by the reference's HLO kind names, `bytes_by_kind` the
bytes.

On an abstract mesh (`Mesh.is_abstract`: no process groups) every
wrapper moves nothing: it returns a tensor of the shape and dtype the
live call would (an all-reduce's, a broadcast's and a recv's the
input's; an all-gather's the gathered shape; a reduce-scatter's the
scattered one; a barrier nothing) and counts it as the live call does.
A step run on meta tensors over such a mesh is the analytic walk of
`launch.hlo_analysis`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Mapping, Sequence

import torch

# Each logical axis maps to an ordered chain of candidates. A candidate is a
# tuple of mesh axis names (sharded over their product) or () for "replicate".
# "pod" appears jointly with "data" for batch so multi-pod meshes shard the
# global batch over pods too.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # data-parallel dims
    "batch": (("pod", "data"), ("data",)),
    # sequence: replicated for training activations by default; long-context
    # decode re-binds kv_seq below (sequence parallelism).
    "seq": ((),),
    # Megatron-style sequence parallelism for the residual stream
    "seq_sp": (("model",), ()),
    "kv_seq": ((),),
    # KV-cache sequence dim: over 'data' where the batch cannot take it,
    # otherwise over 'model' (GQA kv-head counts rarely divide a wide
    # model axis, so the sequence is what distributes the KV bytes)
    "kv_seq_shard": (("data",), ("model",), ()),
    # model-parallel dims
    "embed": ((),),
    "fsdp_embed": (("data",), ()),           # ZeRO-3-ish weight storage dim
    "mlp": (("model",), ()),
    "heads": (("model",), ()),
    "kv_heads": (("model",), ()),
    "qkv_flat": (("model",), ()),
    "vocab": (("model",), ()),
    "experts": (("model",), ()),
    "moe_ff": (("data",), ()),   # expert-FFN dim FSDP (cfg.moe_ff_fsdp)
    "head_dim": ((),),
    "state": ((),),
    # generic never-sharded
    "none": ((),),
}


class Mesh:
    """Named mesh axes and their sizes; a live mesh also carries the
    `torch.distributed` DeviceMesh whose per-axis process groups the
    collectives run over and whose coordinates select a rank's blocks.
    Without one it is abstract (the reference's `AbstractMesh`): it
    resolves specs at any size and places nothing."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None, device=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_mesh = device_mesh
        self.device = None if device is None else torch.device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_abstract(self) -> bool:
        return self.device_mesh is None

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 on an abstract mesh)."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        if self.device_mesh is None:
            raise ValueError("an abstract mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}{', abstract' if self.is_abstract else ''})"


def AbstractMesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Axis names and sizes, no devices: spec resolution at any size."""
    return Mesh(shape, axis_names)


Spec = tuple  # per dim: None | axis name | tuple of axis names


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolves logical axis names -> a spec tuple for a given mesh."""

    mesh: Mesh
    rules: Mapping[str, tuple[tuple[str, ...], ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **over: tuple[tuple[str, ...], ...]
                       ) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(over)
        return ShardingRules(self.mesh, merged)

    def _axis_size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def _candidate_ok(self, cand: tuple[str, ...], dim: int | None,
                      used: set[str]) -> bool:
        for a in cand:
            if a not in self.mesh.shape or a in used:
                return False
        if dim is not None and cand and dim % self._axis_size(cand) != 0:
            return False
        return True

    def spec(self, logical: Sequence[str | None],
             shape: Sequence[int] | None = None) -> Spec:
        """Resolve a logical-axis tuple (one entry per tensor dim) to a
        spec tuple, applying the divisibility fallback chain per dim."""
        if shape is not None and len(shape) != len(logical):
            raise ValueError(f"logical {logical} vs shape {shape} rank "
                             f"mismatch")
        used: set[str] = set()
        out: list = []
        for i, name in enumerate(logical):
            if name is None:
                out.append(None)
                continue
            if name not in self.rules:
                raise KeyError(f"unknown logical axis {name!r}")
            dim = None if shape is None else shape[i]
            chosen: tuple[str, ...] = ()
            for cand in self.rules[name]:
                if self._candidate_ok(cand, dim, used):
                    chosen = cand
                    break
            used.update(chosen)
            if not chosen:
                out.append(None)
            elif len(chosen) == 1:
                out.append(chosen[0])
            else:
                out.append(tuple(chosen))
        return tuple(out)


def tree_shardings(rules: ShardingRules, logical_tree, shape_tree):
    """A tree of logical tuples + the matching tree of tensors (meta or
    real: only ``.shape`` is read) -> the tree of resolved specs."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(rules, logical_tree[k], shape_tree[k])
                for k in logical_tree}
    return rules.spec(logical_tree, tuple(shape_tree.shape))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def axes_of(entry) -> tuple[str, ...]:
    """A spec entry as a tuple of axis names (() when replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_of(entry, mesh: Mesh) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of a dimension bound
    to ``entry``: the axes' coordinates read major to minor."""
    idx, n = 0, 1
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + mesh.coord(a)
        n *= mesh.shape[a]
    return idx, n


def local_shape(spec: Spec, shape: Sequence[int], mesh: Mesh
                ) -> tuple[int, ...]:
    """The per-rank block shape of a ``shape`` tensor placed by ``spec``."""
    return tuple(d // math.prod(mesh.shape[a] for a in axes_of(e))
                 for d, e in zip(shape, spec))


def full_shape(spec: Spec, shape: Sequence[int], mesh: Mesh
               ) -> tuple[int, ...]:
    """The whole tensor's shape of a ``shape`` block placed by ``spec``."""
    return tuple(d * math.prod(mesh.shape[a] for a in axes_of(e))
                 for d, e in zip(shape, spec))


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def shard(t: torch.Tensor, spec: Spec, mesh: Mesh,
          skip: Sequence[int] = ()) -> torch.Tensor:
    """This rank's contiguous block of a full tensor (a view), every
    sharded dimension but those in ``skip`` narrowed."""
    for d, e in enumerate(spec):
        if d in skip or e is None:
            continue
        i, n = block_of(e, mesh)
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


DATA_AXES = ("pod", "data")


def unshard(t: torch.Tensor, spec: Spec, mesh: Mesh,
            skip: Sequence[int] = ()) -> torch.Tensor:
    """The all-gather back to full: every sharded dimension of a rank's
    block but those in ``skip`` gathered over its axes. Differentiated,
    a dimension over data axes reduce-scatters its gradient (each data
    rank computes on its own rows), one over 'model' takes the rank's
    block of it (the gathered leaf feeds a replicated computation)."""
    for d, e in enumerate(spec):
        if d in skip or e is None:
            continue
        axes = axes_of(e)
        t = all_gather(t, mesh, axes, dim=d,
                       backward="sum" if set(axes) <= set(DATA_AXES)
                       else "slice")
    return t


# ---------------------------------------------------------------------------
# counted collectives
# ---------------------------------------------------------------------------
COUNTS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
_SCOPES: list[str] = ["other"]


@contextlib.contextmanager
def scope(name: str):
    """Charge the collectives issued inside to ``name``."""
    _SCOPES.append(name)
    try:
        yield
    finally:
        _SCOPES.pop()


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()


def counts_by_kind(scope_prefix: str | None = None) -> dict[str, int]:
    """Collective counts by kind, over every scope or over the scopes
    whose name starts with ``scope_prefix``."""
    out: dict[str, int] = {}
    for (sc, kind), n in COUNTS.items():
        if scope_prefix is None or sc.startswith(scope_prefix):
            out[kind] = out.get(kind, 0) + n
    return out


def bytes_by_kind(scope_prefix: str | None = None) -> dict[str, int]:
    """Collective result bytes by kind, as `counts_by_kind` counts."""
    out: dict[str, int] = {}
    for (sc, kind), n in BYTES.items():
        if scope_prefix is None or sc.startswith(scope_prefix):
            out[kind] = out.get(kind, 0) + n
    return out


def _count(kind: str, result: torch.Tensor | None) -> None:
    key = (_SCOPES[-1], kind)
    COUNTS[key] += 1
    BYTES[key] += 0 if result is None else \
        result.numel() * result.element_size()


def _dist():
    import torch.distributed as dist
    return dist


def _axes_list(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _records(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _all_reduce(t: torch.Tensor, mesh: Mesh, axis, op: str = "sum"
                ) -> torch.Tensor:
    dist = _dist()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = t.contiguous()
    for a in _axes_list(axis):
        _count("all-reduce", out)
        if not mesh.is_abstract:
            dist.all_reduce(out, op=rop, group=mesh.group(a))
    return out


def _all_gather(t: torch.Tensor, mesh: Mesh, axis, dim: int
                ) -> torch.Tensor:
    dist = _dist()
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    for a in reversed(_axes_list(axis)):
        n = mesh.shape[a]
        # blocks concatenate along dim 0 of the flat buffer; along another
        # dim they are moved there and back (one block: no move needed)
        src = (t if n == 1 else t.movedim(dim, 0)).contiguous()
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        _count("all-gather", out)
        if not mesh.is_abstract:
            gather(out, src, group=mesh.group(a))
        t = out if n == 1 else out.movedim(0, dim).contiguous()
    return t


def _reduce_scatter(t: torch.Tensor, mesh: Mesh, axis, dim: int
                    ) -> torch.Tensor:
    dist = _dist()
    rs = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    for a in _axes_list(axis):            # major axis first
        n = mesh.shape[a]
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        _count("reduce-scatter", out)
        if not mesh.is_abstract:
            rs(out, src, group=mesh.group(a))
        t = out.movedim(0, dim).contiguous()
    return t


def _block(t: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axis``."""
    i, n = block_of(tuple(_axes_list(axis)), mesh)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _all_reduce(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim, backward):
        ctx.mesh, ctx.axis, ctx.dim, ctx.bwd = mesh, axis, dim, backward
        return _all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "sum":
            g = _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim)
        else:
            g = _block(g, ctx.mesh, ctx.axis, ctx.dim)
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def all_reduce(t: torch.Tensor, mesh: Mesh, axis, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (or, ``op="max"``, the max of) ``t`` over ``axis`` (one name
    or a tuple), in place when it is contiguous; returns the result.
    Differentiated (a sum): out of place, the gradient passed through."""
    if op == "sum" and _records(t):
        return _AllReduce.apply(t, mesh, axis)
    return _all_reduce(t, mesh, axis, op)


def enter(t: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The entry of a tensor-parallel region: ``t`` itself forward (no
    collective), its gradient summed over ``axis`` backward."""
    if _records(t):
        return _Enter.apply(t, mesh, axis)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis, dim: int = 0,
               backward: str = "slice") -> torch.Tensor:
    """The blocks of ``axis`` concatenated along ``dim`` in coordinate
    order (a tuple of axes is gathered minor axis first). Differentiated,
    ``backward`` is "sum" (reduce-scatter the gradient) or "slice" (the
    rank's block of it)."""
    if backward not in ("sum", "slice"):
        raise ValueError(f"all_gather backward {backward!r}")
    if _records(t):
        return _AllGather.apply(t, mesh, axis, dim, backward)
    return _all_gather(t, mesh, axis, dim)


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axis, dim: int = 0
                   ) -> torch.Tensor:
    """Sum over ``axis`` (a tuple: major axis first), then this rank's
    block along ``dim``; differentiated, the gradient is all-gathered."""
    if _records(t):
        return _ReduceScatter.apply(t, mesh, axis, dim)
    return _reduce_scatter(t, mesh, axis, dim)


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src: int
              ) -> torch.Tensor:
    """``t`` from coordinate ``src`` of ``axis`` to every rank of it (in
    place when contiguous); returns it."""
    dist = _dist()
    out = t.contiguous()
    _count("broadcast", out)
    if not mesh.is_abstract:
        g = mesh.group(axis)
        dist.broadcast(out, src=dist.get_global_rank(g, src), group=g)
    return out


def barrier(mesh: Mesh) -> None:
    """Every rank of ``mesh`` waits here for the others (counted with
    no bytes)."""
    dist = _dist()
    _count("barrier", None)
    if not mesh.is_abstract:
        dist.all_reduce(torch.zeros(1, device=mesh.device or "cpu"))


def world_max(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of ``t`` over every rank of ``mesh``: one
    all-reduce over the default (world) group, in place when ``t`` is
    contiguous; returns the result. The fault loop's agreement."""
    dist = _dist()
    out = t.contiguous()
    _count("all-reduce", out)
    if not mesh.is_abstract:
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def send(t: torch.Tensor, mesh: Mesh, axis: str, dst: int) -> None:
    """Point to point: ``t`` to coordinate ``dst`` of ``axis``."""
    dist = _dist()
    t = t.contiguous()
    _count("collective-permute", t)
    if not mesh.is_abstract:
        dist.send(t, dst=dist.get_global_rank(mesh.group(axis), dst))


def recv(t: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """Point to point: fill ``t`` from coordinate ``src`` of ``axis``."""
    dist = _dist()
    out = t.contiguous()
    _count("collective-permute", out)
    if not mesh.is_abstract:
        dist.recv(out, src=dist.get_global_rank(mesh.group(axis), src))
    return out
