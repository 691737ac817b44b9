"""FUSED_NORM: row RMSNorm / LayerNorm.

Replaces the TPU kernel `repro/kernels/fused_norm.py::fused_norm`. The
CUDA kernel is `csrc/fused_norm.cu` (one block per row, row staged once
in shared memory, bytes-bound; see its header). Unlike the reference,
ragged M needs no divisibility: the grid is one block per row.

`fused_norm` launches the kernel for a CUDA tensor and runs
`fused_norm_plain` only for a CPU tensor; ``fused_norm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def fused_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor | None, kind: str = "rms",
                     eps: float = 1e-6) -> torch.Tensor:
    """x (M, D) -> (M, D): f32 math, biased variance, * scale (+ bias)."""
    xf = x.float()
    if kind == "rms":
        out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        out = out * scale.float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps) * scale.float() \
            + bias.float()
    return out.to(x.dtype)


ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def fused_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    """x (M, D) -> (M, D) in x.dtype."""
    if kind not in ("rms", "layer"):
        raise ValueError(kind)
    if kind == "layer" and bias is None:
        raise ValueError("layer norm needs a bias")
    if not x.is_cuda:
        return fused_norm_plain(x, scale, bias, kind, eps)
    M, D = x.shape
    if x.stride(-1) != 1:
        raise ValueError("fused_norm needs unit stride on the feature dim")
    for t in (scale, bias):
        if t is not None and (t.device != x.device or t.shape != (D,)
                              or not t.is_contiguous()):
            raise ValueError("scale/bias must be contiguous (D,) tensors on "
                             "x's device")
    if bias is not None and bias.dtype != scale.dtype:
        raise TypeError("scale and bias must share a dtype")
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    lib, fn = build.bind("fused_norm", "fused_norm", ARGTYPES)
    err = fn(
        build.ptr(x), build.ptr(scale),
        None if bias is None else build.ptr(bias), build.ptr(out), M, D,
        x.stride(0), out.stride(0), int(kind == "layer"), eps,
        build.dtype_code(x.dtype), build.dtype_code(scale.dtype),
        build.stream_ptr(x.device))
    build.check(lib, err, "fused_norm")
    fused_norm.launches += 1
    return out


fused_norm.launches = 0
