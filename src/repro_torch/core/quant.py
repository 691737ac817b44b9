"""Symmetric int8 quantization: the blockwise `QTensor`, the KV
cold-tier codec, the compressed spill-lane codec and the per-tensor
gradient codec.

Port of the reference's `core/quant.py`. Every int8 payload and f32
scale matches the reference bit for bit: true division in the input's
float type (f32 for the blockwise and per-token codecs),
round-half-to-even (`torch.round`, like `jnp.round`), clip to +-qmax,
and scale 1.0 where the maximum is 0.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    """Blockwise-quantized tensor: q int8 (an int4 rides in the int8
    carrier), f32 scales, quantized along the last axis in blocks."""
    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8


def quantize(x: torch.Tensor, bits: int = 8, block: int = 256) -> QTensor:
    """Symmetric blockwise quantization along the last axis; one block
    spans the axis where ``block`` does not divide it."""
    *lead, d = x.shape
    if d % block != 0:
        block = d
    xb = x.reshape(*lead, d // block, block).float()
    maxv = xb.abs().amax(dim=-1, keepdim=True)
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.where(maxv > 0, maxv / qmax, torch.ones_like(maxv))
    q = torch.clamp(torch.round(xb / scale), -qmax, qmax).to(torch.int8)
    return QTensor(q.reshape(*lead, d),
                   scale[..., 0].reshape(*lead, d // block), bits)


def dequantize(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    *lead, d = t.q.shape
    nb = t.scale.shape[-1]
    xb = t.q.reshape(*lead, nb, d // nb).float() * t.scale[..., None]
    return xb.reshape(*lead, d).to(dtype)


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


# ---------------------------------------------------------------------------
# gradient compression (the cross-pod int8 all-reduce's codec)
# ---------------------------------------------------------------------------
def grad_scale(g: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 scale, in g's type: max|g| / 127, 1.0
    for an all-zero tensor. Split out so a collective can agree on one
    shared scale before anything quantizes."""
    maxv = g.abs().amax()
    return torch.where(maxv > 0, maxv / 127.0, torch.ones_like(maxv))


def compress_grad(g: torch.Tensor, scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 on ``scale``'s grid (None: g's own `grad_scale`)."""
    if scale is None:
        scale = grad_scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_grad(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
