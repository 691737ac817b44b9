"""The one traffic generator: it reads a traffic file (`traffic/*.json`)
and the seed, and makes what the clients send or the trainer feeds.

Every seed gets the same sizes. A length distribution is cut into
``round`` equal quantiles and the length at each quantile's middle is
kept; every round of ``round`` consecutive requests holds each of those
prompt lengths and each answer length once, in orders the seed draws
(the two independently), with token ids and visual features from the
seed. So two seeds differ in the order of the requests within a round,
never in how much work a round holds, and a window that takes a few
rounds takes nearly the same work whatever the seed.

Serving (``"kind": "closed_loop"``): ``clients`` clients each send a
request, wait for its last token and send the next; request i of the
pool is the i-th sent. A request is ``prompt_tokens`` text ids, a fresh
image (the configuration's visual tokens) where ``image_every`` says so,
and ``answer_tokens`` greedy tokens with no stop token.

Training (``"kind": "train_rows"``): ``batch`` rows of ``seq`` positions
a step, the first ``image_tokens`` from visual features, the rest text;
the loss is the next token on the text. Every step's rows are drawn anew
on the card.
"""

from __future__ import annotations

import statistics

import numpy as np


def _mix(*xs: int) -> int:
    """A 63-bit seed from whole numbers of any size (splitmix64 steps)."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (int(x) & (2 ** 64 - 1))) * 0xBF58476D1CE4E5B9 % 2 ** 64
        h ^= h >> 31
    return h % 2 ** 63


def lengths(spec: dict, n: int) -> list[int]:
    """The fixed multiset of ``n`` lengths of a distribution spec:
    {"dist": "lognormal", "median", "sigma", "min", "max"} or
    {"dist": "uniform", "min", "max"}, taken at the middles of ``n``
    equal quantiles, rounded and clipped to [min, max]."""
    lo, hi = spec["min"], spec["max"]
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        vals = [lo + q * (hi - lo) for q in qs]
    elif spec["dist"] == "lognormal":
        nd = statistics.NormalDist(0.0, spec["sigma"])
        vals = [spec["median"] * np.exp(nd.inv_cdf(q)) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(min(max(round(v), lo), hi)) for v in vals]


def serve_requests(traffic: dict, vocab: int, image: tuple[int, int] | None,
                   seed: int) -> list[dict]:
    """The pool of requests in sending order: {"tokens" (int32 ids),
    "patches" ((Tv, Fv) float32 or None), "answer" (tokens to serve)}.
    ``image`` is the configuration's (visual tokens, feature width)."""
    n, m = traffic["pool"], traffic["round"]
    if n % m:
        raise ValueError(f"pool {n} is not a whole number of rounds of {m}")
    rng = np.random.default_rng(_mix(seed, 1))
    ps = np.array(lengths(traffic["prompt_tokens"], m))
    ans = np.array(lengths(traffic["answer_tokens"], m))
    prompt = np.concatenate([ps[rng.permutation(m)] for _ in range(n // m)])
    answer = np.concatenate([ans[rng.permutation(m)] for _ in range(n // m)])
    every = traffic.get("image_every", 0)
    out = []
    for i in range(n):
        patches = None
        if every and image is not None and i % every == 0:
            patches = rng.standard_normal(image, dtype=np.float32)
        toks = rng.integers(0, vocab, int(prompt[i]), dtype=np.int64)
        out.append({"tokens": toks.astype(np.int32), "patches": patches,
                    "answer": int(answer[i])})
    return out


def train_batch(traffic: dict, vocab: int, feature_width: int, seed: int,
                step: int, device) -> dict:
    """Training step ``step``'s batch, drawn on ``device`` from (seed,
    step): {"tokens" (B, S - Tv), "patches" (B, Tv, Fv), "labels" (B, S),
    "loss_mask" (B, S)}. The labels are the next text token; the visual
    positions and the last one carry no loss."""
    import torch
    B, S, Tv = traffic["batch"], traffic["seq"], traffic["image_tokens"]
    g = torch.Generator(device=device).manual_seed(_mix(seed, 2, step))
    toks = torch.randint(0, vocab, (B, S - Tv), generator=g, device=device)
    patches = torch.randn((B, Tv, feature_width), generator=g,
                          device=device)
    labels = torch.zeros((B, S), dtype=torch.long, device=device)
    labels[:, Tv:S - 1] = toks[:, 1:]
    mask = torch.zeros((B, S), device=device)
    mask[:, Tv:S - 1] = 1.0
    return {"tokens": toks, "patches": patches, "labels": labels,
            "loss_mask": mask}
