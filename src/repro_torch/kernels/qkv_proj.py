"""FUSED_QKV_PROJ: q, k, v = x·Wq (+bq), x·Wk (+bk), x·Wv (+bv).

Replaces the TPU kernel `repro/kernels/qkv_proj.py::qkv_proj`. The CUDA
kernels are in `csrc/qkv_proj.cu`: the three weights are separate operands
read in place (the TPU kernel takes them concatenated), f32 accumulation
with the bias added in f32, and each projection written straight into its
own contiguous (M, N) output — the model's (B, S, H, Dh) layout.

`kernel_variant` picks the kernel, a documented dispatch (see the .cu
header):
- M <= GEMV_MAX_M (decode), f32 and bf16: a GEMV split over N and D,
  the D split from `gemv_split`, the partial sums added in a fixed order
  inside each thread-block cluster;
- larger M, bf16: a wgmma GEMM (64 or 128 rows as `gemm_warpgroups`
  picks, by 128 columns; a cp.async ring as deep as shared memory
  allows), the bias added in f32 before the one rounding to bf16;
- larger M, f32: the CUDA-core GEMM (f32 FMAs): wgmma has no f32 mode
  that holds the 1e-4 parity the f32 paths are checked to.

`qkv_proj` launches the kernel for CUDA tensors and runs `qkv_proj_plain`
only for CPU tensors; ``qkv_proj.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

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


GEMV_MAX_M = 4           # rows the decode GEMV takes (GV_MMAX)
GEMV_THREADS = 256       # GV_NT: 32 row groups of 8 threads
GEMV_MAX_SPLIT = 8       # GV_MAX_SPLIT: the portable cluster size
GEMV_BLOCKS_PER_SM = 2   # GV_MIN_BLOCKS: GEMV blocks an SM holds at once
# mirror of the bf16 GEMM's tiles (TC_*: 64 rows a warpgroup, 128
# columns, 64-deep tiles, the ring as deep as a block's shared memory
# allows); chip_smoke holds `wgmma_smem_bytes` against the library's
# `qkv_proj_smem_bytes`
WGMMA_BN, WGMMA_BK, WGMMA_MAX_STAGES = 128, 64, 8
SMEM_LIMIT = 232_448     # shared memory one block may use on Hopper


def gemv_columns(dtype: torch.dtype) -> int:
    """Output columns a GEMV block owns: 128 bytes of a weight row."""
    return 128 // (4 if dtype == torch.float32 else 2)


@functools.lru_cache(maxsize=256)
def gemv_split(M: int, D: int, ns: tuple, n_sms: int,
               dtype: torch.dtype) -> tuple[int, int]:
    """(n_split, d_chunk): split D into n_split chunks of d_chunk rows (a
    multiple of the 32 row groups; the last chunk may be short): the
    fewest chunks that give every SM a block of the grid (column tiles x
    n_split), kept within what the SMs hold at once (GEMV_BLOCKS_PER_SM
    each: one wave). Fewer, longer chunks amortise a block's fixed costs
    (x staging, the cluster's reduction). n_split is a cluster's size,
    at most GEMV_MAX_SPLIT."""
    rows = GEMV_THREADS // 8
    tiles = max(1, sum(-(-n // gemv_columns(dtype)) for n in ns))
    fit = GEMV_BLOCKS_PER_SM * n_sms // tiles
    n_split = max(1, min(GEMV_MAX_SPLIT, fit, -(-n_sms // tiles),
                         -(-D // rows)))
    d_chunk = -(-(-(-D // n_split)) // rows) * rows
    return -(-D // d_chunk), d_chunk


def gemv_smem_bytes(M: int, d_chunk: int, dtype: torch.dtype) -> int:
    """The GEMV's shared memory: x's chunk in f32 (dynamic), the per-warp
    and per-block partials (static)."""
    return 4 * (M * d_chunk
                + (GEMV_THREADS // 32 + 1) * GEMV_MAX_M * gemv_columns(dtype))


def wgmma_stages(warpgroups: int) -> int:
    """Ring stages of the bf16 GEMM: as many x / W tile pairs as one
    block's shared memory holds after 1 KB of alignment, at most
    WGMMA_MAX_STAGES."""
    stage = 2 * WGMMA_BK * (64 * warpgroups + WGMMA_BN)
    return min(WGMMA_MAX_STAGES, (SMEM_LIMIT - 1024) // stage)


def wgmma_smem_bytes(warpgroups: int) -> int:
    """Dynamic shared memory of the bf16 GEMM at ``warpgroups`` (64 rows
    each) a block: the ring and 1 KB to align the tiles."""
    return (wgmma_stages(warpgroups)
            * 2 * WGMMA_BK * (64 * warpgroups + WGMMA_BN) + 1024)


@functools.lru_cache(maxsize=256)
def gemm_warpgroups(M: int, ns: tuple, n_sms: int) -> int:
    """Warpgroups a block of the bf16 GEMM (rows 64 x that): two, which
    read each weight tile half as often, when the grid of 128-row tiles
    still gives three of four SMs a block; else one."""
    tiles = sum(-(-n // WGMMA_BN) for n in ns)
    return 2 if 4 * -(-M // 128) * tiles >= 3 * n_sms else 1


def kernel_variant(M: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call launches: "gemv" for M <= GEMV_MAX_M, else
    "wgmma" (bf16) or "fma" (f32). Raises for any other dtype."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv_proj kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if M <= GEMV_MAX_M:
        return "gemv"
    return "wgmma" if dtype == torch.bfloat16 else "fma"


ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _bad(what: str, t, shape, dtype, device) -> ValueError:
    return ValueError(f"qkv_proj: {what} must be a contiguous {dtype} "
                      f"tensor of shape {tuple(shape)} on {device} with "
                      f"16-byte aligned rows, got {t.dtype} "
                      f"{tuple(t.shape)} on {t.device}")


def qkv_proj(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor, bq=None, bk=None, bv=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (M, D); w* (D, N*); b* (N*,), all three or none -> q, k, v
    (M, N*) in x.dtype. On CUDA tensors the kernel is `kernel_variant`'s;
    every row (x's, each weight's) must be 16-byte aligned."""
    if not x.is_cuda:
        return qkv_proj_plain(x, wq, wk, wv, bq, bk, bv)
    biases = (bq, bk, bv)
    if (bq is None) != (bk is None) or (bq is None) != (bv is None):
        raise ValueError("qkv_proj: give all three biases or none")
    dt, dev = x.dtype, x.device
    if x.dim() != 2:
        raise ValueError("qkv_proj: x must be a (M, D) tensor")
    M, D = x.shape
    variant = kernel_variant(M, dt)
    es = x.element_size()
    if not x.is_contiguous() or x.data_ptr() % 16 or (D * es) % 16:
        raise _bad("x", x, (M, D), dt, dev)
    ws = (wq, wk, wv)
    ns = []                              # a tuple below: the planners cache
    for name, w, b in zip("qkv", ws, biases):
        N = w.shape[-1]
        if (w.dim() != 2 or w.shape[0] != D or w.dtype != dt
                or w.device != dev or not w.is_contiguous()
                or w.data_ptr() % 16 or (N * es) % 16):
            raise _bad(f"W{name}", w, (D, N), dt, dev)
        if b is not None and (b.shape != (N,) or b.dtype != dt
                              or b.device != dev or not b.is_contiguous()):
            raise _bad(f"b{name}", b, (N,), dt, dev)
        ns.append(N)
    n_split, d_chunk, wgs = 1, D, 1
    sms = build.sm_count(dev.index)
    if variant == "gemv":
        n_split, d_chunk = gemv_split(M, D, tuple(ns), sms, dt)
    elif variant == "wgmma":
        wgs = gemm_warpgroups(M, tuple(ns), sms)
    outs = tuple(torch.empty((M, N), dtype=dt, device=dev) for N in ns)
    lib, fn = build.bind("qkv_proj", "qkv_proj", ARGTYPES)
    err = fn(x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
             None if bq is None else bq.data_ptr(),
             None if bk is None else bk.data_ptr(),
             None if bv is None else bv.data_ptr(),
             outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
             M, D, *ns, n_split, d_chunk, wgs, build.dtype_code(dt),
             build.stream_ptr(dev))
    build.check(lib, err, "qkv_proj")
    qkv_proj.launches += 1
    return outs


qkv_proj.launches = 0
