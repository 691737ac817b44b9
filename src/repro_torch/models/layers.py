"""Shared layers: parameter init helpers, norms, rotary, dense MLP.

Port of the reference's `models/layers.py` for the dense path. Parameter
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
