"""Shared layers: parameter init helpers, norms, rotary, dense MLP, the
RWKV6 channel mix and the mixture of experts (dropless for serving,
capacity-dropping in the full-sequence forward).

Port of the reference's `models/layers.py`. Parameter
shapes and init scales follow the reference (normal with std
fan_in**-0.5 unless a scale is given; norm scales ones, biases zeros),
drawn from an explicit `torch.Generator`. The reference's `jax.random`
stream cannot be reproduced, so parity tests carry the reference's own
weights across with `repro_torch.bridge.params_from_jax`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


# a leaf with more elements than this is drawn in chunks along its leading
# axis, straight into its destination (llama4's (128, 5120, 8192) expert
# bank would otherwise pass through two f32 temporaries of its own size);
# every smaller leaf is drawn whole, as one `torch.randn` call. The bound
# lies above every leaf of the other served configs (the largest,
# paligemma-3b's 257,216 x 2048 table, has 502.5 Mi elements), so their
# random weights are the ones a whole draw gives; llama4's expert banks
# and its embedding table and head are chunked
CHUNK_ELEMS = 1 << 29


class ParamInit:
    """Draws parameters in the reference's shapes and scales from one
    generator, in a fixed order, on ``device``.

    ``out`` (an iterator of tensors, one per leaf in the order the leaves
    are drawn) makes every leaf land in the next of those tensors, e.g.
    one layer's slices of a stacked unit; on the "meta" device nothing
    is drawn and the leaves carry shapes and dtypes only.

    Every leaf is drawn with its logical axes (one name or None per
    dimension, the reference's `ParamBuilder.param` tuples); `axes_tree`
    maps a tree of drawn leaves onto the tree of those tuples."""

    def __init__(self, generator: torch.Generator | None, dtype: torch.dtype,
                 device, out=None):
        self.gen = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.out = out
        # on "meta": every leaf, in the order drawn
        self.drawn: list[torch.Tensor] | None = (
            [] if self.device.type == "meta" else None)
        self.axes: dict[int, tuple] = {}      # id(leaf) -> logical axes

    def axes_tree(self, tree):
        """The logical-axes tree of a tree of leaves drawn here."""
        if isinstance(tree, dict):
            return {k: self.axes_tree(v) for k, v in tree.items()}
        return self.axes[id(tree)]

    def _named(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Record ``t``'s logical axes (None: every dim replicated)."""
        axes = (None,) * t.dim() if axes is None else axes
        assert len(axes) == t.dim(), (tuple(t.shape), axes)
        self.axes[id(t)] = tuple(axes)
        return t

    def _dest(self, shape: tuple[int, ...], dtype: torch.dtype
              ) -> torch.Tensor:
        if self.out is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
            if self.drawn is not None:
                self.drawn.append(t)
            return t
        t = next(self.out)
        assert t.shape == shape and t.dtype == dtype, (t.shape, shape)
        return t

    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, dtype=torch.float32,
                           device=self.device)

    def normal(self, shape: tuple[int, ...], axes=None,
               scale: float | None = None) -> torch.Tensor:
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        std = scale if scale is not None else fan_in ** -0.5
        out = self._named(self._dest(shape, self.dtype), axes)
        if out.is_meta:
            return out
        rows = max(CHUNK_ELEMS // max(out[0].numel(), 1), 1)
        if out.numel() <= CHUNK_ELEMS or len(shape) < 2:
            rows = shape[0]
        for i in range(0, shape[0], rows):
            part = out[i:i + rows]
            part.copy_(self._randn(part.shape).mul_(std))
        return out

    def zeros(self, shape: tuple[int, ...], axes=None) -> torch.Tensor:
        return self._fill(self._named(self._dest(shape, self.dtype), axes),
                          0.0)

    def ones(self, shape: tuple[int, ...], axes=None) -> torch.Tensor:
        return self._fill(self._named(self._dest(shape, self.dtype), axes),
                          1.0)

    def int8(self, shape: tuple[int, ...], axes=None) -> torch.Tensor:
        """Uniform int8 in [-127, 127], as the reference's int8 leaves."""
        out = self._named(self._dest(shape, torch.int8), axes)
        if not out.is_meta:
            out.copy_(torch.randint(-127, 128, shape, generator=self.gen,
                                    dtype=torch.int16, device=self.device))
        return out

    def const(self, shape: tuple[int, ...], axes, value: float
              ) -> torch.Tensor:
        """A constant f32 leaf, whatever the parameter dtype."""
        return self._fill(self._named(self._dest(shape, torch.float32),
                                      axes), value)

    @staticmethod
    def _fill(t: torch.Tensor, value: float) -> torch.Tensor:
        return t if t.is_meta else t.fill_(value)


def embed_axis(cfg: ModelConfig) -> str:
    """Weight-storage axis for the d_model dim: FSDP shards it over 'data'."""
    return "fsdp_embed" if getattr(cfg, "fsdp", False) else "embed"


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(b: ParamInit, cfg: ModelConfig, dim: int | None = None) -> dict:
    d = dim or cfg.d_model
    p = {"scale": b.ones((d,), (None,))}
    if cfg.norm_type == "layernorm":
        p["bias"] = b.zeros((d,), (None,))
    return p


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm in f32; LayerNorm uses the biased variance."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        out = ((xf - mean) * torch.rsqrt(var + eps) * p["scale"].float()
               + p["bias"].float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary (half-split, f32)
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------
def _relu2(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


ACT = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "silu": F.silu,
    "relu2": _relu2,
}


def act_of(kind: str):
    return ACT["silu" if kind == "silu_gated" else
               "gelu" if kind in ("gelu", "gelu_gated") else "relu2"]


def init_mlp(b: ParamInit, cfg: ModelConfig, d_ff: int | None = None,
             mlp_type: str | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    kind = mlp_type or cfg.mlp_type
    gated = kind in ("silu_gated", "gelu_gated")
    e = embed_axis(cfg)
    if cfg.ffn_weight_store == "int8":
        # the "RRAM-domain" store: int8 weights with per-output-column f32
        # scales, the reference's leaves and constant scale values
        sc_up = cfg.d_model ** -0.5 / 127.0
        sc_dn = d_ff ** -0.5 / 127.0
        p = {"w_up_q": b.int8((cfg.d_model, d_ff), (e, "mlp")),
             "w_up_scale": b.const((d_ff,), ("mlp",), sc_up)}
        if gated:
            p["w_gate_q"] = b.int8((cfg.d_model, d_ff), (e, "mlp"))
            p["w_gate_scale"] = b.const((d_ff,), ("mlp",), sc_up)
        p["w_down_q"] = b.int8((d_ff, cfg.d_model), ("mlp", e))
        p["w_down_scale"] = b.const((cfg.d_model,), (None,), sc_dn)
    else:
        p = {"w_up": b.normal((cfg.d_model, d_ff), (e, "mlp"))}
        if gated:
            p["w_gate"] = b.normal((cfg.d_model, d_ff), (e, "mlp"))
        p["w_down"] = b.normal((d_ff, cfg.d_model), ("mlp", e))
    if cfg.use_mlp_bias:
        p["b_up"] = b.zeros((d_ff,), ("mlp",))
        p["b_down"] = b.zeros((cfg.d_model,), (None,))
    return p


def apply_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor,
              mlp_type: str | None = None, tp=None) -> torch.Tensor:
    """GEMM -> (+bias) -> act -> (* gate GEMM) -> GEMM -> (+bias): the
    plain path, used where the fused kernels do not apply (biases). An
    int8 weight store is dequantized first, in the compute dtype, as the
    reference's jnp path does."""
    kind = mlp_type or cfg.mlp_type
    act = act_of(kind)
    cd = torch_dtype(cfg.compute_dtype)
    if "w_up_q" in p:
        p = dict(p)
        for k in ("w_up", "w_gate", "w_down"):
            if f"{k}_q" in p:
                p[k] = p[f"{k}_q"].to(cd) * p[f"{k}_scale"].to(cd)
    h = torch.einsum("...d,df->...f", x, p["w_up"].to(cd))
    if "b_up" in p:
        h = h + p["b_up"].to(h.dtype)
    h = act(h)
    if "w_gate" in p:
        h = h * torch.einsum("...d,df->...f", x, p["w_gate"].to(cd))
    out = torch.einsum("...f,fd->...d", h, p["w_down"].to(cd))
    if tp is not None:        # row-parallel: sum, then the bias once
        out = tp.all_reduce(out)
    if "b_down" in p:
        out = out + p["b_down"].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# RWKV6 channel mix (a token-shifted MLP)
# ---------------------------------------------------------------------------
def init_rwkv_cm(b: ParamInit, cfg: ModelConfig) -> dict:
    e = embed_axis(cfg)
    return {"mu_k": b.zeros((cfg.d_model,), (None,)),
            "mu_r": b.zeros((cfg.d_model,), (None,)),
            "w_k": b.normal((cfg.d_model, cfg.d_ff), (e, "mlp")),
            "w_v": b.normal((cfg.d_ff, cfg.d_model), ("mlp", e)),
            "w_r": b.normal((cfg.d_model, cfg.d_model), (e, None))}


def apply_rwkv_cm(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  x_prev: torch.Tensor | None = None, tp=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel mix, plain (the reference runs no kernel here). x:
    (B,S,D); ``x_prev`` (B,D) is the last row of the previous step, or
    None (token shift within the sequence, zeros before it). Returns
    (out, new x_prev)."""
    cd = torch_dtype(cfg.compute_dtype)
    if x_prev is None:
        shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    elif x.shape[1] > 1:
        shifted = torch.cat([x_prev[:, None], x[:, :-1]], 1)
    else:
        shifted = x_prev[:, None]
    xk = x + (shifted - x) * p["mu_k"].to(x.dtype)
    xr = x + (shifted - x) * p["mu_r"].to(x.dtype)
    if tp is not None:        # xk enters the d_ff split
        xk = tp.enter(xk)
    k = F.relu(xk @ p["w_k"].to(cd)).square()
    kv = k @ p["w_v"].to(cd)
    if tp is not None:        # w_k / w_v split over d_ff
        kv = tp.all_reduce(kv)
    r = torch.sigmoid(xr @ p["w_r"].to(cd))
    return r * kv, x[:, -1]


# ---------------------------------------------------------------------------
# mixture of experts: top-k routing, sort-based dispatch, dropless (the
# serving form) or capacity-dropping (the full-sequence forward), and
# the load-balancing loss the training loss adds
# ---------------------------------------------------------------------------


def init_moe(b: ParamInit, cfg: ModelConfig) -> dict:
    """Router, the experts stacked on a leading (E,) axis, and the shared
    experts as one gated MLP under ``shared`` (the reference's leaves)."""
    m = cfg.moe
    e = embed_axis(cfg)
    if cfg.moe_ff_fsdp:
        # the expert d_ff dim over 'data' (the reference's switch)
        up_ax, dn_ax = ("experts", None, "moe_ff"), ("experts", "moe_ff", None)
    else:
        up_ax, dn_ax = ("experts", e, None), ("experts", None, e)
    p = {"router": b.normal((cfg.d_model, m.num_experts), (e, None),
                            scale=cfg.d_model ** -0.5),
         "w_up": b.normal((m.num_experts, cfg.d_model, m.d_ff_expert),
                          up_ax),
         "w_gate": b.normal((m.num_experts, cfg.d_model, m.d_ff_expert),
                            up_ax),
         "w_down": b.normal((m.num_experts, m.d_ff_expert, cfg.d_model),
                            dn_ax)}
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(b, cfg, d_ff=m.d_ff_shared,
                               mlp_type="silu_gated")
    return p


def moe_capacity(cfg: ModelConfig, T: int, dropless: bool) -> int:
    """Rows an expert holds for T tokens: T when dropless (the top-k
    experts of a token are distinct, so no expert gets more), else the
    reference's ``max(int(T * k / E * capacity_factor), 1)``, rounded up
    to a multiple of 128 from 128 on."""
    if dropless:
        return T
    m = cfg.moe
    cap = max(int(T * m.top_k / m.num_experts * m.capacity_factor), 1)
    if cap >= 128:
        cap = ((cap + 127) // 128) * 128
    return cap


def moe_combine(contrib: torch.Tensor, order: torch.Tensor,
                k: int) -> torch.Tensor:
    """Each token's k expert rows summed in a fixed order. ``contrib``
    (T*k, D) holds the rows in expert-sorted order, ``order`` the sort
    permutation of the token-major (token, choice) pairs. Inverting it
    puts every token's k rows side by side (a token has exactly k: its
    top-k experts are distinct), and they are added choice 0, 1, ..., k-1:
    the same sums in the same order on every run and device, with no
    atomics and no host sync."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    rows = contrib[inv].view(-1, k, contrib.shape[-1])
    out = rows[:, 0]
    for i in range(1, k):
        out = out + rows[:, i]
    return out


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor,
              dropless: bool = True, tp=None, dp=None) -> torch.Tensor:
    """Top-k routed experts plus the shared experts, x (B,S,D) -> (B,S,D).

    The reference's function step by step: an f32 router softmax, top-k
    gates renormalised, the (token, expert) pairs stably sorted by expert
    and scattered into an (E, cap, D) buffer, the three expert products
    as batched matmuls over every expert, the rows gathered back, scaled
    by their gates and summed per token (`moe_combine`, in a fixed order
    where the reference scatter-adds). Dropless (serving): cap = T, so no
    token is dropped and routing is independent per token (chunked
    prefill equals whole-prompt prefill). Capacity-dropping (the
    full-sequence forward): rows past `moe_capacity` in their expert are
    dropped and contribute zero; the gates are not renormalised after the
    drop, as in the reference. The step never waits on the host: counts
    come from ``scatter_add_``, no ``.item()``, ``bincount`` or
    ``nonzero``. The shared experts are the plain `apply_mlp`, as in the
    reference.

    Under ``tp`` with ``tp.experts`` the rank holds those experts only:
    it computes their rows (the others' are zero). With ``tp.shared``
    the shared experts' F is split. The partial sums (routed, shared or
    both) leave in one all-reduce; a part that is replicated (the routed
    sum when the experts are not split, the shared output when its F is
    not) is added after it, so it is counted once. The split parts read
    the tokens and the gates through `TP.enter`.

    Under ``dp`` (a `models.tp.DP`: the rank holds its block of a batch
    split over data ranks) the capacity-dropping form is the global
    batch's: the capacity comes from the global T, and a row's position
    in its expert is its position on this rank plus the expert's rows
    on lower data ranks (one all-gather of the per-expert counts)."""
    m = cfg.moe
    cd = torch_dtype(cfg.compute_dtype)
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.num_experts
    xf = x.reshape(T, D)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)            # (T,k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_expert = gate_idx.reshape(-1)                          # (T*k,)
    flat_token = torch.arange(T * k, device=x.device) // k     # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_w = gate_w.reshape(-1)[order]

    # position of each routed row within its expert: its rank in the
    # sorted order less the rows of the experts before it
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, sorted_expert, torch.ones_like(sorted_expert))
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_expert = (torch.arange(T * k, device=x.device)
                     - offsets[sorted_expert])
    if dp is None or dropless:
        cap = moe_capacity(cfg, T, dropless)
        keep = pos_in_expert < cap
    else:                     # the global batch's positions and capacity
        cap = moe_capacity(cfg, T * dp.n, dropless)
        keep = (pos_in_expert + dp.lower(counts)[sorted_expert]) < cap
    # a dropped row lands in the spare last row of the buffer (a kept
    # row's local position is at most its global one, so below cap)
    slot = torch.where(keep, sorted_expert * cap + pos_in_expert, E * cap)
    ep = tp is not None and tp.experts is not None
    xe = tp.enter(xf) if ep else xf
    buf = xf.new_zeros((E * cap + 1, D))
    buf[slot] = xe[sorted_token]
    buf = buf[:-1].view(E, cap, D)

    if ep:                    # this rank's experts only
        e0, e1 = tp.experts
        buf_all, buf = buf, buf[e0:e1]
    h = torch.bmm(buf, p["w_up"].to(cd))
    h = F.silu(h) * torch.bmm(buf, p["w_gate"].to(cd))
    out_buf = torch.bmm(h, p["w_down"].to(cd))
    if ep:
        full = torch.zeros_like(buf_all, dtype=out_buf.dtype)
        full[e0:e1] = out_buf
        out_buf = full
    out_buf = out_buf.view(E * cap, D)

    gathered = out_buf[slot.clamp_max(E * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    if ep:
        sorted_w = tp.enter(sorted_w)
    contrib = gathered * sorted_w[:, None].to(out_buf.dtype)
    out = moe_combine(contrib.to(x.dtype), order, k).reshape(B, S, D)
    shared_split = tp is not None and tp.shared
    shared = (apply_mlp(p["shared"], cfg,
                        tp.enter(x) if shared_split else x,
                        mlp_type="silu_gated")
              if m.num_shared_experts > 0 else None)
    # only partial sums go into the one all-reduce: the routed rows when
    # the experts are split, the shared output when its F is split; a
    # part that is whole on every rank is added after the reduction
    split = ((out, ep), (shared, shared_split))
    whole = [t for t, s in split if t is not None and not s]
    partial = [t for t, s in split if t is not None and s]
    if partial:
        whole.append(tp.all_reduce(sum(partial[1:], partial[0])))
    return sum(whole[1:], whole[0])


def moe_aux_loss(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 dp=None) -> torch.Tensor:
    """Switch-style load-balancing loss of one MoE layer on x (B,S,D):
    E * sum_e (share of tokens whose top-1 is e) * (mean router
    probability of e), from the router's f32 softmax. Under ``dp`` both
    means are over the global batch: the sums and the token count are
    summed over the data ranks before the product (each rank's gradient
    is then its own tokens' share)."""
    m = cfg.moe
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                          @ p["router"].float(), dim=-1)
    top1 = F.one_hot(probs.argmax(-1), m.num_experts).float()
    if dp is None:
        return m.num_experts * (top1.mean(0) * probs.mean(0)).sum()
    T = float(probs.shape[0] * dp.n)
    frac_tokens = dp.sum(top1.sum(0)) / T
    frac_probs = dp.sum(probs.sum(0)) / T
    return m.num_experts * (frac_tokens * frac_probs).sum()
