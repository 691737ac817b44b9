"""Per-(token, head) symmetric int8 quantization: the KV cold-tier codec
and the compressed spill-lane codec.

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


# ---------------------------------------------------------------------------
# RRAM spill-lane hot-ring codec (serving: compressed spill lanes).
#
# A compressed spill lane re-quantizes the full-precision hot ring with
# the SAME per-(token, head) symmetric int8 scheme as the cold tier, so
# one codec and one error contract cover both. For each feature row r
# (the trailing axis sharing one scale):
#
#     |x - decompress(compress(x))| <= max|r| / 254      elementwise
#
# (scale = max|r|/127, rounding error <= scale/2; an all-zero row comes
# back exactly). `spill_codec_bound` materializes that bound.
# ---------------------------------------------------------------------------
SPILL_CODEC_QMAX = 127.0  # int8 symmetric levels per polarity


def compress_spill_hot(hot: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hot ring -> (int8, f32 scale[..., 1]) lane form."""
    return quantize_per_token(hot)


def decompress_spill_hot(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Restore a compressed hot ring to the cache dtype; the error is
    bounded by `spill_codec_bound`."""
    return dequantize_per_token(q, scale, dtype)


def spill_codec_bound(x: torch.Tensor) -> torch.Tensor:
    """Elementwise reconstruction-error bound of the spill codec for
    input ``x``: max|feature row| / 254, broadcast over the row."""
    xf = x.float()
    return (xf.abs().amax(dim=-1, keepdim=True)
            / (2.0 * SPILL_CODEC_QMAX)).expand_as(xf)
