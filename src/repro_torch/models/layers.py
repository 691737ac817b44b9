"""Shared layers: parameter init helpers, norms, rotary, dense MLP, the
RWKV6 channel mix and the dropless mixture of experts.

Port of the reference's `models/layers.py` for the serving path. Parameter
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


class ParamInit:
    """Draws parameters in the reference's shapes and scales from one
    generator, in a fixed order, on ``device``."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.gen = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape: tuple[int, ...],
               scale: float | None = None) -> torch.Tensor:
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        std = scale if scale is not None else fan_in ** -0.5
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (x * std).to(self.dtype)

    def zeros(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def int8(self, shape: tuple[int, ...]) -> torch.Tensor:
        """Uniform int8 in [-127, 127], as the reference's int8 leaves."""
        x = torch.randint(-127, 128, shape, generator=self.gen,
                          dtype=torch.int16, device=self.device)
        return x.to(torch.int8)

    def const(self, shape: tuple[int, ...], value: float) -> torch.Tensor:
        """A constant f32 leaf, whatever the parameter dtype."""
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(b: ParamInit, cfg: ModelConfig, dim: int | None = None) -> dict:
    d = dim or cfg.d_model
    p = {"scale": b.ones((d,))}
    if cfg.norm_type == "layernorm":
        p["bias"] = b.zeros((d,))
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
    if cfg.ffn_weight_store == "int8":
        # the "RRAM-domain" store: int8 weights with per-output-column f32
        # scales, the reference's leaves and constant scale values
        sc_up = cfg.d_model ** -0.5 / 127.0
        sc_dn = d_ff ** -0.5 / 127.0
        p = {"w_up_q": b.int8((cfg.d_model, d_ff)),
             "w_up_scale": b.const((d_ff,), sc_up)}
        if gated:
            p["w_gate_q"] = b.int8((cfg.d_model, d_ff))
            p["w_gate_scale"] = b.const((d_ff,), sc_up)
        p["w_down_q"] = b.int8((d_ff, cfg.d_model))
        p["w_down_scale"] = b.const((cfg.d_model,), sc_dn)
    else:
        p = {"w_up": b.normal((cfg.d_model, d_ff))}
        if gated:
            p["w_gate"] = b.normal((cfg.d_model, d_ff))
        p["w_down"] = b.normal((d_ff, cfg.d_model))
    if cfg.use_mlp_bias:
        p["b_up"] = b.zeros((d_ff,))
        p["b_down"] = b.zeros((cfg.d_model,))
    return p


def apply_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor,
              mlp_type: str | None = None) -> torch.Tensor:
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
    if "b_down" in p:
        out = out + p["b_down"].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# RWKV6 channel mix (a token-shifted MLP)
# ---------------------------------------------------------------------------
def init_rwkv_cm(b: ParamInit, cfg: ModelConfig) -> dict:
    return {"mu_k": b.zeros((cfg.d_model,)),
            "mu_r": b.zeros((cfg.d_model,)),
            "w_k": b.normal((cfg.d_model, cfg.d_ff)),
            "w_v": b.normal((cfg.d_ff, cfg.d_model)),
            "w_r": b.normal((cfg.d_model, cfg.d_model))}


def apply_rwkv_cm(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  x_prev: torch.Tensor | None = None
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
    k = F.relu(xk @ p["w_k"].to(cd)).square()
    kv = k @ p["w_v"].to(cd)
    r = torch.sigmoid(xr @ p["w_r"].to(cd))
    return r * kv, x[:, -1]


# ---------------------------------------------------------------------------
# mixture of experts: top-k routing, sort-based dispatch, dropless (the
# serving form); the capacity-dropping path and the load-balancing loss
# belong to training
# ---------------------------------------------------------------------------
TRAINING_ITEM = "ROADMAP Queue 1 item 9 (training)"


def init_moe(b: ParamInit, cfg: ModelConfig) -> dict:
    """Router, the experts stacked on a leading (E,) axis, and the shared
    experts as one gated MLP under ``shared`` (the reference's leaves)."""
    m = cfg.moe
    p = {"router": b.normal((cfg.d_model, m.num_experts),
                            scale=cfg.d_model ** -0.5),
         "w_up": b.normal((m.num_experts, cfg.d_model, m.d_ff_expert)),
         "w_gate": b.normal((m.num_experts, cfg.d_model, m.d_ff_expert)),
         "w_down": b.normal((m.num_experts, m.d_ff_expert, cfg.d_model))}
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(b, cfg, d_ff=m.d_ff_shared,
                               mlp_type="silu_gated")
    return p


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor,
              dropless: bool = True) -> torch.Tensor:
    """Top-k routed experts plus the shared experts, x (B,S,D) -> (B,S,D).

    The reference's function step by step: an f32 router softmax, top-k
    gates renormalised, the (token, expert) pairs stably sorted by expert
    and scattered into an (E, cap, D) buffer, the three expert products
    as batched matmuls over every expert, the rows gathered back, scaled
    by their gates and scatter-added per token. Dropless: cap = T, the
    worst case, so no token is dropped and routing is independent per
    token (chunked prefill equals whole-prompt prefill). The step never
    waits on the host: counts come from ``scatter_add_``, no ``.item()``,
    ``bincount`` or ``nonzero``. The shared experts are the plain
    `apply_mlp`, as in the reference."""
    if not dropless:
        raise NotImplementedError(
            f"capacity-dropping MoE: {TRAINING_ITEM}; serving is dropless")
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
    # the top-k experts of a token are distinct, so an expert holds at
    # most T rows: with cap = T every row keeps its place
    cap = T
    slot = sorted_expert * cap + pos_in_expert
    buf = xf.new_zeros((E * cap, D))
    buf[slot] = xf[sorted_token]
    buf = buf.view(E, cap, D)

    h = torch.bmm(buf, p["w_up"].to(cd))
    h = F.silu(h) * torch.bmm(buf, p["w_gate"].to(cd))
    out_buf = torch.bmm(h, p["w_down"].to(cd)).view(E * cap, D)

    contrib = out_buf[slot] * sorted_w[:, None].to(out_buf.dtype)
    out = x.new_zeros((T, D)).index_add_(0, sorted_token,
                                         contrib.to(x.dtype))
    out = out.view(B, S, D)
    if m.num_shared_experts > 0:
        out = out + apply_mlp(p["shared"], cfg, x, mlp_type="silu_gated")
    return out


def moe_aux_loss(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The Switch-style load-balancing loss is a training term."""
    raise NotImplementedError(f"moe_aux_loss: {TRAINING_ITEM}")
