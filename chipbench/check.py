"""The comparisons that decide ``correct``, and their numbers.

Serving (`served_gap`): every sampled served token is judged by the
reference's logits at the position that produced it: how far the
token's logit lies below the reference's best, in standard deviations
of that row of logits (a unit that holds across widths and vocabularies).
The number compared is the widest such gap over the sample. A served id
outside the published vocabulary has no logit there and reads as
infinitely far. The control (`control_gap`) reads, at the same
positions, the gap of the token that the lower precision puts first.

Training (`train_numbers`): per step, the relative gap of the loss; per
parameter leaf, the gap between the program's and the reference's
norms of the first step's gradient (clipped, as the optimizer takes it)
and of the change the first three steps made, each over the larger of
that leaf's reference norm and the median leaf's. A leaf whose reference
gradient is under a thousandth of the median leaf's moves by rounding
alone, and is left out of the change. The numbers compared are the
worst step's and the worst leaf's.
"""

from __future__ import annotations

import math
import statistics


def _gaps(ref, tokens) -> list[float]:
    import torch
    ref = ref.float()
    V = ref.shape[-1]
    t = torch.as_tensor([int(x) for x in tokens], device=ref.device)
    ok = (t >= 0) & (t < V)
    picked = ref.gather(-1, t.clamp(0, V - 1)[:, None])[:, 0]
    gap = (ref.max(dim=-1).values - picked) / ref.std(dim=-1)
    return torch.where(ok, gap, torch.full_like(gap, math.inf)).tolist()


def served_gap(ref_logits: list, served: list) -> dict:
    """The widest gap of a served token, over the sampled sequences."""
    gaps = [g for r, s in zip(ref_logits, served) for g in _gaps(r, s)]
    return {"gap_std": max(gaps) if gaps else math.inf,
            "tokens": len(gaps)}


def control_gap(ref_logits: list, ctl_logits: list) -> dict:
    """The widest gap of the token the control puts first."""
    picks = [c.float().argmax(dim=-1).tolist() for c in ctl_logits]
    return served_gap(ref_logits, picks)


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    paths = [p for p in ref if keep is None or p in keep]
    med = statistics.median(ref[p] for p in paths)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in paths)


def train_numbers(prog: dict, ref: dict, tiny: float = 1e-3) -> dict:
    """``prog`` and ``ref``: {"losses": [3], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = {p for p, v in g.items() if v >= tiny * med}
    return {"loss_rel": loss,
            "grad_leaf": _leaf_gaps(prog["grad_norms"], g),
            "change_leaf": _leaf_gaps(prog["change_norms"],
                                      ref["change_norms"], moving),
            "still_leaves": len(g) - len(moving)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number under its limit, {name: {"value", "limit"}})."""
    out = {k: {"value": numbers[k], "limit": lim}
           for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
