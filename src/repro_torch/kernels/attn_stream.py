"""FUSED_ATTN_STREAM: flash-style GQA attention.

Replaces the TPU kernel `repro/kernels/attn_stream.py::attn_stream`. The
CUDA kernel is `csrc/attn_stream.cu` (one block per (b*h, 32-query tile),
the key-tile loop inside the block; see its header). Layout: q
(B, H, S, D), k/v (B, Hkv, L, D) -> (B, H, S, D); head h reads kv head
h // (H // Hkv). Causal alignment is q_offset = L - S, and causal S > L
raises, as in the reference.

The kernel reads any strides with a contiguous last dim, so callers pass
transposed views of model-layout tensors without copies, and may pass
``out`` (any such view) to receive the result in place.

`attn_stream` launches the kernel for CUDA tensors and runs
`attn_stream_plain` only for CPU tensors; ``attn_stream.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 20
HEAD_DIMS = (16, 32, 64, 128)


def _check_causal(S: int, L: int, causal: bool):
    if causal and S > L:
        raise ValueError(
            f"causal attn_stream requires S <= L (got S={S}, L={L}): with "
            f"q_offset = L - S negative the first S - L queries precede "
            f"every key and their attention is undefined")


def attn_stream_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """Grouped softmax attention in f32 with the kernel's mask."""
    B, H, S, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    _check_causal(S, L, causal)
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, S, D)
    scores = torch.einsum("bkgsd,bkld->bkgsl", qf, k.float()) * scale
    if causal:
        mask = (torch.arange(L, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + (L - S))
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgsl,bkld->bkgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]


def attn_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, scale: float | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """q (B,H,S,D); k,v (B,Hkv,L,D) -> (B,H,S,D) in q.dtype."""
    B, H, S, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    _check_causal(S, L, causal)
    if not q.is_cuda:
        o = attn_stream_plain(q, k, v, causal, scale)
        if out is not None:
            out.copy_(o)
            return out
        return o
    if k.shape != (B, Hkv, L, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"attn_stream shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"attn_stream kernel supports head dims "
                         f"{HEAD_DIMS}, got {D}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")
    if out is None:
        out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if out.shape != (B, H, S, D) or out.dtype != q.dtype:
        raise ValueError("out must match q's shape and dtype")
    for t in (q, k, v, out):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("attn_stream needs tensors on one device with "
                             "a contiguous last dim")
    scale = scale if scale is not None else D ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib, fn = build.bind("attn_stream", "attn_stream", ARGTYPES)
    err = fn(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), B, H, Hkv,
        S, L, D, ctypes.cast(strides, ctypes.c_void_p), int(causal), scale,
        build.dtype_code(q.dtype), build.stream_ptr(q.device))
    build.check(lib, err, "attn_stream")
    attn_stream.launches += 1
    return out


attn_stream.launches = 0
