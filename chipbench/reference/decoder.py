"""A dense GQA decoder in plain PyTorch, float32, for the benchmark's
correctness checks: the published block of the configuration files
(`configs/*.json`) as the program runs it, written from the published
description and not from the program.

The block: pre-norm (RMSNorm or LayerNorm with bias, at the file's eps),
Q / K / V projections (with biases where the file says so), rotary
embedding over the whole head in the half-split form (HF's
``rotate_half``), grouped-query attention at scale Dh^-0.5, the output
projection (with a bias where the weights hold one), a residual, then a
pre-norm SiLU-gated FFN, down(silu(x W_up) * (x W_gate)), and a
residual. The head is the tied embedding or ``lm_head``; served tokens
are judged over the published vocabulary, and the training softmax runs
over the padded one, as the program's does. A vision frontend is a
two-layer connector, gelu_tanh(f W1 + b1) W2 + b2, over precomputed
patch features.

Weights are the benchmark's (`chipbench.weights`), in the program's tree
layout: layers of a repeated unit stacked on a leading axis. They are
read layer by layer and turned into float32 one layer at a time, so the
reference fits beside nothing else on the card.

The tiered KV store is worked out again (`served_logits`): a served
position reads the keys and values of the last ``hot_window`` positions
as computed, and every older one through the int8 round trip of the
cold tier (one symmetric scale per position and kv head, round half to
even). Prompt positions read every earlier key as computed, as a prefill
does.

``arith`` sets the precision of the products: "float32" is the
reference; "fp8" (e4m3, a scale per row of activations and per column
of weights) and "tf32" (inputs rounded to TF32's 10 mantissa bits,
ties away from zero, f32 sums; in the backward too) are the lower
precisions that the benchmark's controls put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# the precision of the products
# ---------------------------------------------------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as the tensor cores' cvt.rna does."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = g @ b.transpose(-1, -2)
        gb = a.transpose(-1, -2) @ g
        return (_unbroadcast(ga, a.shape), _unbroadcast(gb, b.shape))


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x through e4m3 and back, one scale along ``dim``'s slices."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Arith:
    """float32 products (the reference)."""
    name = "float32"

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    def attn(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b


class TF32(Arith):
    name = "tf32"

    def linear(self, x, w):
        return _TF32MatMul.apply(x, w)

    attn = linear


class FP8(Arith):
    """e4m3 weights and activations in the projections, the FFN and the
    head; attention's products stay in float32."""
    name = "fp8"

    def linear(self, x, w):
        return _fp8(x, -1) @ _fp8(w, -2)


ARITH = {"float32": Arith(), "tf32": TF32(), "fp8": FP8()}


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------
class Arch:
    """The sizes and choices of a configuration file that the block reads."""

    def __init__(self, config: dict):
        # the block as it runs: a file's ``port_block`` group replaces the
        # published choices it names
        config = {**config, **config.get("port_block", {})}
        self.D = config["hidden_size"]
        self.H = config["num_attention_heads"]
        self.Hkv = config["num_key_value_heads"]
        self.Dh = config.get("head_dim", self.D // self.H)
        self.V = config["vocab_size"]
        self.theta = float(config["rope_theta"])
        if "rms_norm_eps" in config:
            self.norm, self.eps = "rmsnorm", float(config["rms_norm_eps"])
        else:
            self.norm, self.eps = "layernorm", float(config["layer_norm_eps"])
        if config["hidden_act"] != "silu":
            raise ValueError(f"unsupported FFN {config['hidden_act']!r}")
        if config.get("partial_rotary_factor", 1.0) != 1.0 \
                or config.get("qk_layernorm") \
                or config.get("use_parallel_residual"):
            raise ValueError("the block supports whole-head rotary, no q/k "
                             "norm and a sequential residual only")
        self.tied = bool(config["tie_word_embeddings"])


def layers(params: dict):
    """Each layer's leaves in order: the units u0, u1, ... of the tree, a
    stacked unit (its leaves on a leading layer axis) one layer at a time."""
    units = params["units"]
    for name in sorted(units, key=lambda u: int(u[1:])):
        unit = units[name]
        n = unit["ln1"]["scale"].shape[0] \
            if unit["ln1"]["scale"].dim() == 2 else None
        if n is None:
            yield unit
            continue
        for r in range(n):
            yield _map(unit, lambda t, r=r: t[r])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def f32(tree):
    return _map(tree, lambda t: t.float())


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def norm(x: torch.Tensor, p: dict, a: Arch) -> torch.Tensor:
    if a.norm == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + a.eps) \
            * p["scale"]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + a.eps) * p["scale"] + p["bias"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (B, T, heads, Dh), positions (T,)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def int8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """x through the cold tier: int8 over the last axis, one scale."""
    m = x.abs().amax(-1, keepdim=True)
    scale = torch.where(m > 0, m / 127.0, torch.ones_like(m))
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def attention(q, k, v, prompt_len: int, hot_window: int | None,
              arith: Arith, rows: int = 512) -> torch.Tensor:
    """Causal grouped attention of q (B, T, H, Dh) over k, v (B, T, Hkv,
    Dh), in blocks of ``rows`` queries. With ``hot_window`` W, a query at
    a position p >= ``prompt_len`` reads the positions <= p - W through
    the cold tier's int8 round trip."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, Dh).permute(0, 2, 3, 1, 4)   # B Hkv G T Dh
    kt = k.permute(0, 2, 3, 1)[:, :, None]                     # B Hkv 1 Dh T
    vt = v.permute(0, 2, 1, 3)[:, :, None]                     # B Hkv 1 T Dh
    tiered = hot_window is not None and T > prompt_len
    if tiered:
        kqt = int8_round_trip(k).permute(0, 2, 3, 1)[:, :, None]
        vqt = int8_round_trip(v).permute(0, 2, 1, 3)[:, :, None]
    scale = Dh ** -0.5
    outs = []
    for s in range(0, T, rows):
        e = min(T, s + rows)
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(e, device=q.device)[None, :]
        sc = arith.attn(qg[:, :, :, s:e], kt[..., :e]) * scale
        cold = None
        if tiered and e > prompt_len:
            cold = (i >= prompt_len) & (j <= i - hot_window)
            if bool(cold.any()):
                scq = arith.attn(qg[:, :, :, s:e], kqt[..., :e]) * scale
                sc = torch.where(cold, scq, sc)
            else:
                cold = None
        sc = sc.masked_fill(j > i, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        if cold is None:
            o = arith.attn(p, vt[:, :, :, :e])
        else:
            o = arith.attn(p.masked_fill(cold, 0.0), vt[:, :, :, :e]) \
                + arith.attn(p.masked_fill(~cold, 0.0), vqt[:, :, :, :e])
        outs.append(o)                                         # B Hkv G b Dh
    o = torch.cat(outs, dim=3)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh)


def block(h: torch.Tensor, lw: dict, a: Arch, prompt_len: int,
          hot_window: int | None, arith: Arith) -> torch.Tensor:
    """One layer over h (B, T, D), float32 leaves ``lw``."""
    B, T, D = h.shape
    m = lw["mixer"]
    x = norm(h, lw["ln1"], a)
    q = arith.linear(x, m["wq"].reshape(D, -1)).reshape(B, T, a.H, a.Dh)
    k = arith.linear(x, m["wk"].reshape(D, -1)).reshape(B, T, a.Hkv, a.Dh)
    v = arith.linear(x, m["wv"].reshape(D, -1)).reshape(B, T, a.Hkv, a.Dh)
    if "bq" in m:
        q, k, v = q + m["bq"], k + m["bk"], v + m["bv"]
    pos = torch.arange(T, device=h.device)
    q, k = rope(q, pos, a.theta), rope(k, pos, a.theta)
    o = attention(q, k, v, prompt_len, hot_window, arith)
    out = arith.linear(o.reshape(B, T, a.H * a.Dh), m["wo"].reshape(-1, D))
    if "bo" in m:
        out = out + m["bo"]
    h = h + out
    x = norm(h, lw["ln2"], a)
    f = lw["mlp"]
    g = F.silu(arith.linear(x, f["w_up"])) * arith.linear(x, f["w_gate"])
    return h + arith.linear(g, f["w_down"])


def embed(params: dict, tokens: torch.Tensor, patches, arith: Arith
          ) -> torch.Tensor:
    """(B, T, D) float32 inputs: the connector over ``patches`` (B, Tv,
    Fv) or None, then the token embeddings of ``tokens`` (B, S)."""
    x = params["embed"]["table"][tokens.long()].float()
    if patches is None:
        return x
    fe = f32(params["frontend"])
    v = F.gelu(arith.linear(patches.float(), fe["w1"]) + fe["b1"],
               approximate="tanh")
    v = arith.linear(v, fe["w2"]) + fe["b2"]
    return torch.cat([v, x], dim=1)


def head(params: dict, a: Arch, x: torch.Tensor, arith: Arith
         ) -> torch.Tensor:
    """Logits over every row of the table (or column of ``lm_head``): the
    published vocabulary and, where the program pads it, the padded rows,
    which the benchmark's weights hold at zero (so their logits are 0 and
    they enter the training softmax as the program's do)."""
    x = norm(x, f32(params["final_norm"]), a)
    if a.tied:
        w = params["embed"]["table"].float().t()
    else:
        w = params["lm_head"].float()
    return arith.linear(x, w)


# ---------------------------------------------------------------------------
# served sequences
# ---------------------------------------------------------------------------
@torch.no_grad()
def served_logits(params: dict, config: dict, seqs: list[dict],
                  hot_window: int | None, arith: str = "float32"
                  ) -> list[torch.Tensor]:
    """The logits behind every served token of each sequence: for a
    sequence {"tokens": prompt text ids, "patches": (Tv, Fv) or None,
    "served": the served ids}, the rows (n_served, V) at the positions
    that produced them (the prompt's last position onwards), every
    sequence fed its prompt and its served tokens but the last. Layer by
    layer over all sequences; the card's memory holds one layer's
    float32 weights and every sequence's hidden rows."""
    a, ar = Arch(config), ARITH[arith]
    dev = params["embed"]["table"].device
    hs, plens = [], []
    for s in seqs:
        served = np.asarray(s["served"], np.int64)
        toks = np.concatenate([np.asarray(s["tokens"], np.int64),
                               served[:-1]])
        pt = None if s.get("patches") is None else torch.as_tensor(
            np.asarray(s["patches"], np.float32), device=dev)[None]
        hs.append(embed(params, torch.as_tensor(toks, device=dev)[None],
                        pt, ar))
        plens.append((0 if pt is None else pt.shape[1]) + len(s["tokens"]))
    for lw in layers(params):
        lw = f32(lw)
        for i, P in enumerate(plens):
            hs[i] = block(hs[i], lw, a, P, hot_window, ar)
        del lw
    out = []
    for h, P, s in zip(hs, plens, seqs):
        n = len(s["served"])
        out.append(head(params, a, h[0, P - 1:P - 1 + n], ar)[:, :a.V])
    return out


def loss(params: dict, config: dict, batch: dict,
         arith: str = "float32") -> torch.Tensor:
    """Mean next-token cross-entropy of a training batch {"tokens" (B, S
    - Tv), "patches" (B, Tv, Fv), "labels" (B, S), "loss_mask" (B, S)}:
    the full causal forward, float32, differentiable in every leaf."""
    a, ar = Arch(config), ARITH[arith]
    h = embed(params, batch["tokens"], batch.get("patches"), ar)
    T = h.shape[1]
    for lw in layers(params):
        h = block(h, lw, a, T, None, ar)
    logits = head(params, a, h, ar)
    ll = logits.gather(-1, batch["labels"].long()[..., None])[..., 0] \
        - torch.logsumexp(logits, dim=-1)
    mask = batch["loss_mask"].float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)

