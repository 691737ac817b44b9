"""FUSED_ATTN_STREAM: flash-style GQA attention.

Replaces the TPU kernel `repro/kernels/attn_stream.py::attn_stream`. The
CUDA kernels are in `csrc/attn_stream.cu` (see its header). Layout: q
(B, H, S, D), k/v (B, Hkv, L, D) -> (B, H, S, D); head h reads kv head
h // (H // Hkv). Causal alignment is q_offset = L - S, and causal S > L
raises, as in the reference.

`kernel_variant` picks the kernel by dtype and head dim, a documented
dispatch:
- bf16 runs the tensor-core kernel: one warpgroup per 64-query tile,
  Q.K^T and P.V by wgmma, K/V tiles of 64 keys in a 2-stage cp.async
  ring; where the grid is small a query tile's key tiles are split over
  a cluster of up to 3 blocks (`kv_split`) and merged in rank order.
  P is rounded to bf16 before P.V, so its outputs differ from the
  twin's f32 math by about one bf16 step (held to 2e-2 on the card);
- f32 at a head dim in TF32X3_HEAD_DIMS (the training path, the f32
  parity prefills and extends) runs "tf32x3": the same online softmax
  with S = Q.K^T and P.V each three TF32 tensor-core products a k-step
  (the 3xTF32 split of `csrc/tf32x3.cuh`, within 3·2^-22 of each term
  beyond f32's own rounding; one TF32 product would miss the 1e-4
  parity the f32 paths are checked to). A split launch first writes
  K's hi / lo pair plane and V^T's (wgmma takes TF32 only K-major) into
  a workspace allocated per call; Q is split inside the kernel, and a
  64-query tile's key tiles are dealt out to two warpgroups, merged in
  order;
- f32 at head dims 16, 32 and 256 (the tf32x3 tiles of Dh 256 exceed
  a block's shared memory: `tf32x3_smem_bytes`) runs "fma", the
  CUDA-core kernel (f32 FMAs, 32-query tiles).
The f32 dispatch does not look at S: kernel_sweep.py's tf32 section
found tf32x3 faster for every extend from one query row, and slower
only on prefills of 1-32 rows, by at most 3 µs.

Head dims 160 (stablelm-12b) and 256 (paligemma-3b) are stored as whole
128-byte panels plus, at 160, one 64-byte panel (no padding); at 256 the
bf16 kernel's tiles take 161 KB, one block an SM (`wgmma_smem_bytes`).

The kernels read any strides with a contiguous last dim (bf16: 16-byte
aligned rows), so callers pass transposed views of model-layout tensors
without copies, and may pass ``out`` (any such view) to receive the
result in place.

`attn_stream` launches the kernel for CUDA tensors and runs
`attn_stream_plain` only for CPU tensors; ``attn_stream.launches``
counts launches (one a call, the tf32x3 form's split launch included)
and ``attn_stream.variant`` names the form the last CUDA call ran.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tf32x3 import tf32x3_pair_ld

NEG_INF = -2.0 ** 20
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
# mirror of the bf16 kernel's tiles in csrc/attn_stream.cu (WG_*); chip_smoke
# holds `wgmma_smem_bytes` against the library's `attn_stream_smem_bytes`
WGMMA_BQ, WGMMA_BK, WGMMA_STAGES = 64, 64, 2
WGMMA_MAX_SPLIT = 3      # WG_MAX_SPLIT: blocks (a cluster) per query tile
BLOCKS_PER_SM = 1        # grid target the key split is sized for
SMEM_LIMIT = 232_448     # shared memory one block may use on Hopper
# mirror of the f32 3xTF32 kernel's tiles (TA_* in csrc/attn_stream.cu):
# 64 query rows, their key tiles of 32 (16 above Dh 128) dealt out to 2
# warpgroups, each with its own K and V^T tile; every tile a pair tile
# (16 hi, then their 16 lo f32 values a block); chip_smoke holds
# `tf32x3_smem_bytes` against the library's `attn_stream_tf32_smem_bytes`
TF32X3_BQ, TF32X3_WGS = 64, 2
TF32X3_HEAD_DIMS = (64, 128, 160)
FORMS = ("fma", "wgmma", "tf32x3")     # the C entry's codes


def wgmma_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of the bf16 kernel: the Q tile, the K/V
    ring, and 1 KB to align the tiles."""
    tile = 2 * head_dim
    return (WGMMA_BQ * tile + 2 * WGMMA_STAGES * WGMMA_BK * tile + 1024)


def tf32x3_bk(head_dim: int) -> int:
    """Keys a tile of the tf32x3 kernel: 32, or 16 above Dh 128."""
    return 16 if head_dim > 128 else 32


def tf32x3_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of the tf32x3 kernel at ``head_dim``: Q's
    pair tile (TF32X3_BQ rows of head_dim hi and lo values), a K and a
    V^T pair tile of `tf32x3_bk` keys for each of TF32X3_WGS
    warpgroups, and 1 KB to align the tiles. Beyond SMEM_LIMIT (Dh 256:
    257 KB) the form does not take the head dim."""
    bk = tf32x3_bk(head_dim)
    return 8 * head_dim * (TF32X3_BQ + TF32X3_WGS * 2 * bk) + 1024


def tf32x3_scratch(B: int, Hkv: int, L: int, head_dim: int) -> int:
    """f32 elements of the tf32x3 workspace: K's pair plane (B Hkv L rows
    of head_dim) and V^T's (B Hkv head_dim rows of L keys, zeros to the
    next multiple of 16)."""
    return B * Hkv * (L * tf32x3_pair_ld(head_dim)
                      + head_dim * tf32x3_pair_ld(L))


@functools.lru_cache(maxsize=256)
def kv_split(B: int, H: int, S: int, L: int, n_sms: int) -> int:
    """Blocks (one cluster) that share a query tile of the bf16 kernel,
    each taking a contiguous run of its key tiles, merged in rank order:
    as many as keep the grid within BLOCKS_PER_SM blocks per SM (the
    longest causal tile sets the time; a second wave or idle cluster
    members cost more than the split saves), no more than the longest
    tile's key tiles or WGMMA_MAX_SPLIT."""
    blocks = -(-S // WGMMA_BQ) * B * H
    longest = -(-L // WGMMA_BK)
    return max(1, min(WGMMA_MAX_SPLIT, longest,
                      BLOCKS_PER_SM * n_sms // max(blocks, 1)))


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches: "wgmma" (bf16), "tf32x3" (f32 at
    a head dim in TF32X3_HEAD_DIMS) or "fma" (f32 at the others). Raises
    for a head dim or dtype no kernel takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_stream kernel supports head dims "
                         f"{HEAD_DIMS}, got {head_dim}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "tf32x3" if head_dim in TF32X3_HEAD_DIMS else "fma"
    raise TypeError(f"attn_stream kernels take float32 or bfloat16, got "
                    f"{dtype}")


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


ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def attn_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, scale: float | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """q (B,H,S,D); k,v (B,Hkv,L,D) -> (B,H,S,D) in q.dtype. On CUDA
    tensors the kernel is `kernel_variant`'s: bf16 the tensor-core
    kernel (P rounded to bf16 before P.V), f32 the 3xTF32 tensor-core
    kernel or the CUDA-core one."""
    B, H, S, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    _check_causal(S, L, causal)
    if not q.is_cuda:
        o = attn_stream_plain(q, k, v, causal, scale)
        if out is not None:
            out.copy_(o)
            return out
        return o
    dt, dev = q.dtype, q.device
    if k.shape != (B, Hkv, L, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"attn_stream shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    variant = kernel_variant(dt, D)
    if k.dtype != dt or v.dtype != dt:
        raise TypeError("q, k and v must share a dtype")
    if out is None:
        out = torch.empty((B, H, S, D), dtype=dt, device=dev)
    elif out.shape != (B, H, S, D) or out.dtype != dt:
        raise ValueError("out must match q's shape and dtype")
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    for t in (q, k, v, out):
        if t.device != dev or t.stride(-1) != 1:
            raise ValueError("attn_stream needs tensors on one device with "
                             "a contiguous last dim")
    if variant == "wgmma" and (any(st % 8 for st in strides) or any(
            t.data_ptr() % 16 for t in (q, k, v, out))):
        raise ValueError("bf16 attn_stream needs 16-byte aligned rows (the "
                         "kernel loads them with 16-byte cp.async)")
    split = kv_split(B, H, S, L, build.sm_count(dev.index)) \
        if variant == "wgmma" else 1
    scratch = (torch.empty(tf32x3_scratch(B, Hkv, L, D), dtype=dt,
                           device=dev) if variant == "tf32x3" else None)
    lib, fn = build.bind("attn_stream", "attn_stream", ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             Hkv, S, L, D, *strides, int(causal),
             D ** -0.5 if scale is None else scale,
             build.dtype_code(dt), split, FORMS.index(variant),
             None if scratch is None else scratch.data_ptr(),
             build.stream_ptr(dev))
    build.check(lib, err, f"attn_stream ({variant})")
    attn_stream.launches += 1
    attn_stream.variant = variant
    return out


attn_stream.launches = 0
attn_stream.variant = None
