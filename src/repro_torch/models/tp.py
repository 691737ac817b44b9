"""One rank's view of a model placed on a mesh: tensor parallelism over
'model' at CHIME's two cut points, data parallelism over 'data', and
gather-at-use for every stored shard a layer cannot split.

`Placement` is what `Model(cfg, placement=...)` runs with. A rank holds
each parameter leaf at its resolved shard (`Model.param_shardings`) and
each cache leaf at its resolved shard (`Model.cache_shardings` /
`extend_shardings`). Per block it decides, from the resolved specs alone:

  * attention (GQA), MLA, the RWKV6 time mix — tensor parallel when the
    query heads are sharded over 'model' (GQA also needs the rank's
    query heads to cover whole kv groups or lie in one): column-parallel
    projections at the local heads, the row-parallel output projection,
    then ONE all-reduce (AttnOut), the output bias added after it;
  * the dense / int8 / biased FFN and the RWKV channel mix — tensor
    parallel when their hidden dim is sharded: ONE all-reduce (FFNOut);
  * the MoE — expert parallel when the experts are sharded: each rank
    computes its own experts' rows; the routed and shared partial sums
    leave in ONE all-reduce;
  * anything else (Mamba2's fused w_in, whose halves do not line up with
    its z / xBC / dt split; heads the resolver replicates, as
    starcoder2's 36 on an 8-way axis) — every stored shard gathered at
    use and the layer computed replicated, with NO all-reduce (a partial
    sum would be counted once a rank).

Training differentiates through the same placement (`sharding`'s
collectives are autograd Functions where autograd records): a TP region
starts at `TP.enter` on each replicated tensor its split computation
reads and ends at its one all-reduce. The attention projections are one
fused Q/K/V call, so under TP with the kv heads replicated the K/V
projections sit inside the region and their leaves' gradients are
partial sums over 'model' (`Placement.partial_over_model`); the train
step sums them. `DP` is the batch's split over the data axes: the
loss's and the load-balancing term's global sums, and the capacity
MoE's global row positions.

A TP layer keeps every dimension bound to 'model' local and gathers the
rest (an FSDP 'data' dim). Cache leaves are gathered at use over every
sharded dimension but the slot axis (the rank's own slots) and an RWKV6
state's heads under TP; a decode step appends each new K/V row to the
full store (the rows all-gathered over 'model' when the kv heads are
sharded), the kernels read the heads the local queries need, and the
rank keeps the block of the updated store it owns. The vocab is split
over 'model': a masked embedding lookup and one all-reduce, a
column-parallel head, greedy argmax as a local max and one gather (ties
to the lowest global index, as `torch.argmax`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import sharding as S
from repro_torch.tree import tree_map

MODEL = "model"


@dataclasses.dataclass(frozen=True)
class TP:
    """A layer's split over the mesh's 'model' axis.

    ``kv`` is the global range of kv heads the rank's queries read and
    ``kv_sharded`` says whether the rank's K/V projections give only its
    own kv heads (then the new rows are all-gathered for the store).
    ``heads`` is an RWKV6 time mix's local head range; ``experts`` a
    MoE's local expert range (None: the experts are replicated) and
    ``shared`` whether its shared experts are split too."""

    mesh: S.Mesh
    kv: tuple[int, int] | None = None
    kv_sharded: bool = False
    heads: tuple[int, int] | None = None
    experts: tuple[int, int] | None = None
    shared: bool = False

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The region's exit (AttnOut, FFNOut, the expert-parallel sum):
        the partial sums summed; the gradient passes through."""
        return S.all_reduce(t, self.mesh, MODEL)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """The region's entry: a replicated tensor read by the rank's
        split computation (its gradient summed over 'model')."""
        return S.enter(t, self.mesh, MODEL)

    def kv_local(self, t: torch.Tensor) -> torch.Tensor:
        """K or V rows (B, S, Hx, Dh) from the rank's projection -> the
        kv heads its queries read."""
        if self.kv_sharded:
            return t
        return self.kv_read(t, 2)

    def kv_full(self, t: torch.Tensor) -> torch.Tensor:
        """K or V rows from the rank's projection -> every kv head."""
        if self.kv_sharded:      # read by heads split over 'model'
            return S.all_gather(t, self.mesh, MODEL, dim=2, backward="sum")
        return t

    def kv_read(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A full-headed tensor -> the heads the local queries read."""
        if self.kv is None or (self.kv[0] == 0
                               and self.kv[1] == t.shape[dim]):
            return t
        return t.narrow(dim, self.kv[0], self.kv[1] - self.kv[0]) \
            .contiguous()

    def store_read(self, store: dict) -> dict:
        """A full-headed K/V store (flat or tiered) -> its heads the local
        queries read (the endurance counters untouched)."""
        return {k: (v if k == "writes" else self.kv_read(v, 2))
                for k, v in store.items()}


@dataclasses.dataclass(frozen=True)
class DP:
    """The batch's split over the mesh's data axes ``axes`` (those its
    rows are sharded on; () when every rank holds the whole batch)."""

    mesh: S.Mesh
    axes: tuple[str, ...] = ()

    @property
    def n(self) -> int:
        return S.block_of(self.axes, self.mesh)[1]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data ranks (the gradient passes through:
        each rank's is its own share's)."""
        return S.all_reduce(t, self.mesh, self.axes)

    def lower(self, counts: torch.Tensor) -> torch.Tensor:
        """Per-element sums of ``counts`` over the data ranks before this
        one (one all-gather), e.g. an expert's rows on lower ranks."""
        every = S.all_gather(counts[None], self.mesh, self.axes, dim=0)
        return every[:S.block_of(self.axes, self.mesh)[0]].sum(0)


def _model_dims(spec) -> tuple[int, ...]:
    return tuple(d for d, e in enumerate(spec) if e == MODEL)


class Placement:
    """One rank of ``mesh``: its coordinates, the resolved parameter
    specs, and the per-block decisions and gathers described above."""

    def __init__(self, model, mesh: S.Mesh, rules: S.ShardingRules
                 | None = None):
        self.mesh = mesh
        self.rules = rules or S.ShardingRules(mesh)
        self.cfg = model.cfg
        self.plan = model.plan
        self.shapes, axes = model.abstract_params()
        self.pspec = S.tree_shardings(self.rules, axes, self.shapes)
        self.m = mesh.shape.get(MODEL, 1)
        self.mi = mesh.coord(MODEL) if MODEL in mesh.shape else 0

    # ---- leaves ------------------------------------------------------
    def gather(self, t: torch.Tensor, spec, keep=()) -> torch.Tensor:
        return S.unshard(t, spec, self.mesh, skip=keep)

    def take(self, t: torch.Tensor, spec, keep=()) -> torch.Tensor:
        return S.shard(t, spec, self.mesh, skip=keep).contiguous()

    def replicated(self, p, spec):
        """Leaves computed replicated: every sharded dim gathered."""
        return self._work(p, spec, False)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering a column-parallel product."""
        return S.enter(t, self.mesh, MODEL)

    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in S.DATA_AXES if a in self.mesh.shape)

    @functools.cached_property
    def partial_over_model(self) -> set[tuple]:
        """Paths of the parameter leaves replicated over 'model' whose
        gradients are partial sums over it: the K/V projections of an
        attention layer that runs tensor parallel with its kv heads
        replicated (inside the region of the fused Q/K/V call)."""
        out = set()
        for ui, unit in enumerate(self.plan):
            if unit.block.mixer not in ("attn", "attn_shared"):
                continue
            root = (("shared_attn",) if unit.block.mixer == "attn_shared"
                    else ("units", f"u{ui}"))
            shp, ps = self.shapes, self.pspec
            for k in root:
                shp, ps = shp[k], ps[k]
            shp, ps = shp["mixer"], ps["mixer"]
            if unit.repeats > 1 and unit.block.mixer == "attn":
                shp = {k: v[0] for k, v in shp.items()}
                ps = {k: v[1:] for k, v in ps.items()}
            local = {k: torch.empty(S.local_shape(ps[k], tuple(v.shape),
                                                  self.mesh), device="meta")
                     for k, v in shp.items()}
            tp = self._attn_tp(local, ps)
            if tp is not None and not tp.kv_sharded:
                out.update(root + ("mixer", k) for k in ("wk", "wv", "bk",
                                                         "bv") if k in shp)
        return out

    def _work(self, p, spec, tp: bool):
        """A sublayer's leaves at use: under TP every dim bound to
        'model' stays local, every other sharded dim is gathered."""
        return tree_map(lambda t, s: self.gather(
            t, s, _model_dims(s) if tp else ()), p, spec)

    # ---- per-block decisions -----------------------------------------
    def block(self, spec, bp: dict, ps: dict):
        """(the block's leaves at use, {"mixer"/"mlp": TP or None}, the
        cache dims kept local) for one layer of plan block ``spec``."""
        work = {k: v for k, v in bp.items()}
        tps: dict = {}
        keep: dict = {}
        mix, mps = bp["mixer"], ps["mixer"]
        tp = None
        if spec.mixer in ("attn", "attn_shared"):
            tp = self._attn_tp(mix, mps)
        elif spec.mixer == "mla" and mps["wk_b"][1] == MODEL:
            tp = TP(self.mesh)
        elif spec.mixer == "rwkv6" and mps["w_r"][1] == MODEL:
            hl = mix["w_r"].shape[1]
            tp = TP(self.mesh, heads=(self.mi * hl, (self.mi + 1) * hl))
            keep = {"tm": {"s": (1,)}}
        work["mixer"] = self._work(mix, mps, tp is not None)
        tps["mixer"] = tp
        if "mlp" in bp:
            work["mlp"], tps["mlp"] = self._mlp(spec.mlp, bp["mlp"],
                                                ps["mlp"])
        for k in ("ln1", "ln2"):
            if k in bp:
                work[k] = self._work(bp[k], ps[k], False)
        return work, tps, keep

    def _attn_tp(self, p: dict, ps: dict) -> TP | None:
        if ps["wq"][1] != MODEL:
            return None
        hl = p["wq"].shape[1]
        H = hl * self.m
        kv_sharded = ps["wk"][1] == MODEL
        Hkv = p["wk"].shape[1] * (self.m if kv_sharded else 1)
        G = H // Hkv
        h0 = self.mi * hl
        if kv_sharded:
            kl = Hkv // self.m
            return TP(self.mesh, kv=(self.mi * kl, (self.mi + 1) * kl),
                      kv_sharded=True)
        if hl % G and G % hl:
            return None       # the local queries straddle kv groups
        return TP(self.mesh, kv=(h0 // G, (h0 + hl - 1) // G + 1))

    def _mlp(self, kind: str, p: dict, ps: dict):
        if kind == "moe":
            ep = ps["w_up"][0] == MODEL
            shared = "shared" in p and ps["shared"]["w_up"][1] == MODEL
            work = dict(self._work({k: v for k, v in p.items()
                                    if k != "shared"},
                                   {k: v for k, v in ps.items()
                                    if k != "shared"}, ep))
            if "shared" in p:
                work["shared"] = self._work(p["shared"], ps["shared"],
                                            shared)
            if not (ep or shared):
                return work, None
            el = p["w_up"].shape[0]
            return work, TP(self.mesh, shared=shared,
                            experts=(self.mi * el, (self.mi + 1) * el)
                            if ep else None)
        first = "w_k" if kind == "rwkv_cm" else (
            "w_up_q" if "w_up_q" in p else "w_up")
        tp = ps[first][1] == MODEL
        return self._work(p, ps, tp), TP(self.mesh) if tp else None

    # ---- caches ------------------------------------------------------
    def cache_in(self, cache: dict, spec: dict, keep: dict) -> dict:
        """A layer's cache at use: gathered over every sharded dim but
        the slot axis (0) and the ``keep`` dims."""
        def walk(c, s, k):
            if isinstance(c, dict):
                return {n: walk(c[n], s[n], k.get(n, {}) if isinstance(
                    k, dict) else ()) for n in c}
            return self.gather(c, s, (0,) + tuple(k or ()))
        return walk(cache, spec, keep)

    def cache_out(self, cache: dict, spec: dict, keep: dict) -> dict:
        """The rank's block of a layer's updated cache."""
        def walk(c, s, k):
            if isinstance(c, dict):
                return {n: walk(c[n], s[n], k.get(n, {}) if isinstance(
                    k, dict) else ()) for n in c}
            return self.take(c, s, (0,) + tuple(k or ()))
        return walk(cache, spec, keep)

    def cache_whole(self, cache: dict, keep: dict) -> dict:
        """A committed layer cache with its ``keep`` dims (split over
        'model') gathered too: whole, for the slot's owner to store."""
        def walk(c, k):
            if isinstance(c, dict):
                return {n: walk(c[n], k.get(n, {}) if isinstance(k, dict)
                                else ()) for n in c}
            for d in (k or ()):
                c = S.all_gather(c, self.mesh, MODEL, dim=d)
            return c
        return walk(cache, keep)

    # ---- vocab -------------------------------------------------------
    def embed(self, table: torch.Tensor, ids: torch.Tensor, cd
              ) -> torch.Tensor:
        """Rows ``ids`` of the vocab-parallel table: a masked lookup of
        the rank's rows, then one all-reduce."""
        spec = self.pspec["embed"]["table"]
        table = self.gather(table, spec, _model_dims(spec))
        if spec[0] != MODEL:
            return table[ids].to(cd)
        vl = table.shape[0]
        v0 = self.mi * vl
        local = ids - v0
        hit = (local >= 0) & (local < vl)
        rows = table[local.clamp(0, vl - 1)].to(cd)
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        with S.scope("embed"):
            return S.all_reduce(rows, self.mesh, MODEL)

    def head_weight(self, params: dict) -> tuple[torch.Tensor, bool]:
        """(the head's local (Vloc, D) rows (tied) or (D, Vloc) columns,
        whether the vocab is split)."""
        if self.cfg.tie_embeddings:
            spec = self.pspec["embed"]["table"]
            w, vdim = params["embed"]["table"], 0
        else:
            spec = self.pspec["lm_head"]
            w, vdim = params["lm_head"], 1
        split = spec[vdim] == MODEL
        return self.gather(w, spec, (vdim,) if split else ()), split

    def vocab_split(self) -> bool:
        """Whether the head's vocab columns are split over 'model'."""
        if self.cfg.tie_embeddings:
            return self.pspec["embed"]["table"][0] == MODEL
        return self.pspec["lm_head"][1] == MODEL

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Local-vocab logits (..., Vloc) -> every column."""
        if not self.vocab_split():
            return logits
        with S.scope("head"):     # read by the replicated loss
            return S.all_gather(logits, self.mesh, MODEL,
                                dim=logits.dim() - 1, backward="slice")

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """argmax over the full vocab of local-vocab logits (B, Vloc):
        a local max, then one gather of (value, global index); ties go
        to the lowest global index."""
        idx = logits.argmax(-1)
        if not self.vocab_split():
            return idx
        val = logits.gather(-1, idx[..., None])[..., 0].float()
        gidx = (idx + self.mi * logits.shape[-1]).float()
        with S.scope("head"):
            both = S.all_gather(torch.stack([val, gidx])[None], self.mesh,
                                MODEL, dim=0)            # (m, 2, B)
        vals, gids = both[:, 0], both[:, 1]
        best = vals.max(0).values
        first = (vals == best).int().argmax(0)           # lowest rank
        return gids.gather(0, first[None])[0].long()
