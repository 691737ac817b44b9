"""FUSED_NORM: row RMSNorm / LayerNorm.

Replaces the TPU kernel `repro/kernels/fused_norm.py::fused_norm`. The
CUDA kernel is `csrc/fused_norm.cu` (see its header): the row lives in
registers, x and scale (and bias) are loaded together before the
reduction, and `threads_per_row` threads share a row. `variant` picks
its 16-byte vector variant, or the scalar one where D, the row pitch or
a base address does not fit 16-byte vectors. Unlike the reference,
ragged M needs no divisibility.

`fused_norm` launches the kernel for a CUDA tensor and runs
`fused_norm_plain` only for a CPU tensor; ``fused_norm.launches`` counts
kernel launches. The wrapper's host path is kept short (it runs 57-65
times a decode step): integer device checks, the C entry bound once,
one 10-argument call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

VECTOR_BYTES = 16      # the vector variant's loads and stores
MAX_THREADS = 1024     # threads a row at most
MAX_UNITS = 8          # units (vectors or elements) a thread: FN_MAX_VPT


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


def variant(D: int, row_stride: int, elem_size: int, addr_bits: int) -> str:
    """"vector" where D and the row pitch are whole 16-byte vectors of x
    and every base address (x, scale, bias; ``addr_bits`` is their
    bitwise or) is 16-byte aligned; else "scalar"."""
    ve = VECTOR_BYTES // elem_size
    if D % ve or row_stride % ve or addr_bits % VECTOR_BYTES:
        return "scalar"
    return "vector"


@functools.lru_cache(maxsize=64)
def threads_per_row(units: int) -> int:
    """Threads that share a row of ``units`` vectors (or elements): one
    unit a thread, rounded up to whole warps, at most MAX_THREADS."""
    return min(MAX_THREADS, -(-units // 32) * 32)


ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p]
# mode bits of the C entry: 1 LayerNorm, 2 x bf16, 4 scale bf16, 8 vector,
# threads a row from bit 4 on
_MODE_X = {torch.float32: 0, torch.bfloat16: 2}
_MODE_S = {torch.float32: 0, torch.bfloat16: 4}
_entry = None          # the C entry, bound at the first launch


def _bind():
    global _entry
    _entry = build.bind("fused_norm", "fused_norm", ARGTYPES)[1]
    return _entry


def _plan(x: torch.Tensor, scale: torch.Tensor, bias, mode: int) -> tuple:
    """Check a CUDA call's operands and pick its launch: (x, scale, bias
    addresses, M, D, row pitch, mode bits with the threads a row,
    device)."""
    M, D = x.shape
    x_stride, unit = x.stride()
    if unit != 1:
        raise ValueError("fused_norm needs unit stride on the feature dim")
    dev = x.get_device()
    for t in (scale, bias):
        if t is not None and (t.get_device() != dev or t.shape != (D,)
                              or not t.is_contiguous()):
            raise ValueError("scale/bias must be contiguous (D,) tensors on "
                             "x's device")
    if bias is not None and bias.dtype != scale.dtype:
        raise TypeError("scale and bias must share a dtype")
    mx, ms = _MODE_X.get(x.dtype), _MODE_S.get(scale.dtype)
    if mx is None or ms is None:
        raise TypeError(f"fused_norm takes float32 or bfloat16, got "
                        f"{x.dtype} x and {scale.dtype} scale")
    px, ps = x.data_ptr(), scale.data_ptr()
    pb = 0 if bias is None else bias.data_ptr()
    es = 2 if mx else 4
    if variant(D, x_stride, es, px | ps | pb) == "vector":
        units, mode = D * es // VECTOR_BYTES, mode | 8
    else:
        units = D
    tpr = threads_per_row(units)
    if units > MAX_UNITS * tpr:
        raise ValueError(f"fused_norm: D = {D} is wider than {MAX_UNITS} "
                         f"units of {MAX_THREADS} threads")
    return px, ps, pb, M, D, x_stride, mode | mx | ms | tpr << 4, dev


def fused_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    """x (M, D) -> (M, D) in x.dtype."""
    if kind == "rms":
        mode = 0
    elif kind == "layer":
        if bias is None:
            raise ValueError("layer norm needs a bias")
        mode = 1
    else:
        raise ValueError(kind)
    if not x.is_cuda:
        return fused_norm_plain(x, scale, bias, kind, eps)
    px, ps, pb, M, D, x_stride, mode, dev = _plan(x, scale, bias, mode)
    out = torch.empty_like(x)   # row-major: x's strides are kept only if dense
    err = (_entry or _bind())(
        px, ps, pb, out.data_ptr(), M, D, x_stride, eps, mode,
        torch._C._cuda_getCurrentRawStream(dev))
    if err:
        build.check(build.load("fused_norm"), err, "fused_norm")
    fused_norm.launches += 1
    return out


fused_norm.launches = 0
