"""MLLM connector: precomputed frontend embeddings -> backbone
pseudo-tokens (the vision encoder itself is a stub, as in the reference)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamInit, embed_axis, torch_dtype


def init_frontend(b: ParamInit, cfg: ModelConfig) -> dict:
    f = cfg.frontend
    e = embed_axis(cfg)
    p = {"w1": b.normal((f.frontend_dim, cfg.d_model), (None, e)),
         "b1": b.zeros((cfg.d_model,), (None,))}
    if f.connector == "mlp":
        p["w2"] = b.normal((cfg.d_model, cfg.d_model), (e, None))
        p["b2"] = b.zeros((cfg.d_model,), (None,))
    return p


def apply_connector(p: dict, cfg: ModelConfig,
                    feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, T, frontend_dim) -> (B, T, d_model). GELU is the tanh
    form (`jax.nn.gelu`'s default)."""
    cd = torch_dtype(cfg.compute_dtype)
    h = torch.einsum("btf,fd->btd", feats.to(cd), p["w1"].to(cd)) \
        + p["b1"].to(cd)
    if "w2" in p:
        h = F.gelu(h, approximate="tanh")
        h = torch.einsum("btd,de->bte", h, p["w2"].to(cd)) + p["b2"].to(cd)
    return h
