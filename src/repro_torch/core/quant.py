"""Per-(token, head) symmetric int8 quantization — the KV cold-tier codec.

Port of the reference's `quantize_per_token` / `dequantize_per_token`.
The int8 payload and the f32 scale match the reference bit for bit: f32
true division, round-half-to-even (`torch.round`, like `jnp.round`),
clip to +-127, and scale 1.0 where the row max is 0.
"""

from __future__ import annotations

import torch


def quantize_per_token(x: torch.Tensor, bits: int = 8
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize over the trailing feature dim -> (q int8, scale f32[..., 1])."""
    xf = x.float()
    maxv = xf.abs().amax(dim=-1, keepdim=True)
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.where(maxv > 0, maxv / qmax, torch.ones_like(maxv))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_per_token(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
