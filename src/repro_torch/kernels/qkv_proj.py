"""FUSED_QKV_PROJ: q, k, v = x·Wq (+bq), x·Wk (+bk), x·Wv (+bv).

Replaces the TPU kernel `repro/kernels/qkv_proj.py::qkv_proj`. The CUDA
kernel is `csrc/qkv_proj.cu`: the three weights are separate operands
read in place (the TPU kernel takes them concatenated), f32 accumulation
with the bias added in f32, and each projection written straight into its
own contiguous (M, N) output — the model's (B, S, H, Dh) layout. Decode
(M <= 4) runs a split-N GEMV with 16-byte weight loads; larger M a tiled
GEMM (see its header).

`qkv_proj` launches the kernel for CUDA tensors and runs `qkv_proj_plain`
only for CPU tensors; ``qkv_proj.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def qkv_proj_plain(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor, bq=None, bk=None, bv=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (M, D); w* (D, N*); b* (N*,) or None -> (M, N*) each, in
    x.dtype, f32 math."""
    xf = x.float()
    outs = []
    for w, b in ((wq, bq), (wk, bk), (wv, bv)):
        o = xf @ w.float()
        if b is not None:
            o = o + b.float()
        outs.append(o.to(x.dtype))
    return tuple(outs)


ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def qkv_proj(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor, bq=None, bk=None, bv=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (M, D); w* (D, N*); b* (N*,), all three or none -> q, k, v
    (M, N*) in x.dtype."""
    if not x.is_cuda:
        return qkv_proj_plain(x, wq, wk, wv, bq, bk, bv)
    biases = (bq, bk, bv)
    if any(b is None for b in biases) != all(b is None for b in biases):
        raise ValueError("qkv_proj: give all three biases or none")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("qkv_proj: x must be a contiguous (M, D) tensor")
    M, D = x.shape
    ws = (wq, wk, wv)
    for name, w, b in zip("qkv", ws, biases):
        N = w.shape[-1]
        build.require_operands("qkv_proj", x.device, {
            f"W{name}": (w, (D, N), x.dtype),
            f"b{name}": (b, (N,), x.dtype)})
        if w.data_ptr() % 16 or (N * w.element_size()) % 16:
            raise ValueError(f"qkv_proj: W{name} rows must be 16-byte "
                             f"aligned (the kernel loads 16-byte vectors)")
    outs = tuple(torch.empty((M, w.shape[1]), dtype=x.dtype,
                             device=x.device) for w in ws)
    lib, fn = build.bind("qkv_proj", "qkv_proj", ARGTYPES)
    err = fn(build.ptr(x), *(build.ptr(w) for w in ws),
             *(None if b is None else build.ptr(b) for b in biases),
             *(build.ptr(o) for o in outs), M, D,
             *(w.shape[1] for w in ws), build.dtype_code(x.dtype),
             build.stream_ptr(x.device))
    build.check(lib, err, "qkv_proj")
    qkv_proj.launches += 1
    return outs


qkv_proj.launches = 0
