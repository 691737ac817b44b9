"""FUSED_FFN_ACT: GEMM(x·W_up) -> act (* x·W_gate) -> GEMM(·W_down).

`ffn_act` replaces the TPU kernel `repro/kernels/ffn_act.py::ffn_act`
(weights in the model's type); `ffn_act_int8` replaces
`repro/kernels/ffn_act.py::ffn_act_int8` (the "RRAM" weight store: int8
weights with per-output-column f32 scales, factored out of the sums).
Both CUDA wrappers run one of three forms of `csrc/ffn_act.cuh` (see its
header), picked by `kernel_variant` from M, x's dtype and whether every
row starts 16-byte aligned:

- "stream" (bf16 x, M <= STREAM_MAX_M, decode): one fused kernel bound
  by the weight bytes, its products on tensor cores (mma.sync). A slice
  of STREAM_SLICE hidden units is split over D among the blocks of a
  cluster; each block streams its W_up / W_gate row segments and then its
  W_down rows through a cp.async ring and keeps its hidden tile, rounded
  to 16 bits, in shared memory; the blocks of a cluster add their (M, D)
  partials in rank order, and a second kernel adds the clusters' partials
  in order. `stream_plan` picks the D split and the cluster size.
- "wgmma" (bf16 x, larger M, prefill): two tensor-core GEMMs. Phase 1
  writes h = act(x·W_up) [* x·W_gate] in bf16 to an (M, F) workspace
  (3.5-5.7 MB at the serving prefill shapes: it stays in L2; the TPU
  kernel's (block_m, D) f32 VMEM accumulator does not fit a Hopper
  block's shared memory), phase 2 multiplies h into W_down, F split over
  a cluster when the tile grid underfills the card (`wgmma_plan`).
- "fma" (f32 x at every M, the f32 parity path; or rows not 16-byte
  aligned): f32 FMA tiles over (16-row tile, F chunk, band of FMA_BAND
  output columns), one f32 partial per chunk (`f_chunking`).

d_model is bounded only by the stream form's shared memory (x's rows and
the (M, D) f32 partial: `stream_smem_bytes` <= SMEM_LIMIT, D 5120 at M 8
in bf16); the wgmma form loops over D, the fma form over its bands.

Ragged M, D and F are masked, not asserted. Activations: ``silu_gated``,
``gelu``, ``gelu_gated`` (tanh GELU) and ``relu2``; the int8 TPU kernel is
ungated only, the port's also takes the int8 gate that the model's int8
FFN (`models.layers.apply_mlp`) multiplies in.

Each wrapper launches its kernels for CUDA tensors (a refused launch
raises; nothing falls back) and runs its plain twin (`ffn_act_plain`;
`ffn_act_int8_plain`, the same over the dequantized weights) only for CPU
tensors. ``<wrapper>.launches`` counts calls that launched (one a call,
whatever the form's kernel count); ``<wrapper>.variant`` names the form
the last CUDA call ran.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

ACTS = {"silu_gated": 0, "gelu": 1, "gelu_gated": 1, "relu2": 2}
SMEM_LIMIT = 232_448     # shared memory one block may use on Hopper
# the stream form (SM_* in csrc/ffn_act.cuh)
STREAM_MAX_M = 8         # rows the stream form takes (decode)
STREAM_THREADS = 256
STREAM_SLICE = 128       # hidden units a slice (16 a warp)
STREAM_STAGES = 3        # its ring: deeper rings measured no faster
STREAM_STAGE_BYTES = 18_432       # 16 KB of bf16 rows and their 16-byte pads
STREAM_INT8_STAGE_BYTES = 12_288  # 8 KB of int8 rows and pads
STREAM_MAX_SPLIT = 8     # the portable cluster size
# the wgmma form (TC_* in csrc/ffn_act.cuh)
WGMMA_BK, WGMMA_MAX_STAGES, WGMMA_BN = 64, 6, 128
# the fma form
BF = 32                  # its hidden-unit step
FMA_ROWS = 16            # its rows a block
BLOCKS_PER_SM = 4        # grid target its F-chunk count is sized for
FMA_BAND = 12 * 256      # the fma form's output columns a block: 12 a
                         # thread; a wider d_model takes more bands
VARIANTS = ("fma", "stream", "wgmma")           # the C entry's codes


def activation(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN's act of ``kind`` on pre-activations h (the gate is not
    applied here)."""
    if kind == "silu_gated":
        return F.silu(h)
    if kind in ("gelu", "gelu_gated"):
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        return F.relu(h).square()
    raise ValueError(kind)


def ffn_act_plain(x: torch.Tensor, w_up: torch.Tensor,
                  w_gate: torch.Tensor | None, w_down: torch.Tensor,
                  kind: str = "silu_gated") -> torch.Tensor:
    """x (M, D); w_up/w_gate (D, F); w_down (F, D) -> (M, D), f32 math."""
    xf = x.float()
    h = activation(xf @ w_up.float(), kind)
    if w_gate is not None:
        h = h * (xf @ w_gate.float())
    return (h @ w_down.float()).to(x.dtype)


def kernel_variant(M: int, dtype: torch.dtype, aligned: bool = True
                   ) -> str:
    """The form a CUDA call runs: for bf16 x "stream" at M <=
    STREAM_MAX_M, else "wgmma"; "fma" for f32 x, and at any M where a row
    of x or of a weight does not start 16-byte aligned (``aligned``
    False). Raises for any other dtype."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffn_act kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if not aligned or dtype == torch.float32:
        return "fma"
    return "stream" if M <= STREAM_MAX_M else "wgmma"


def stream_plan(F_: int, n_sms: int) -> tuple[int, int, int]:
    """(ds, cluster, n_blocks) of the stream form: slices of STREAM_SLICE
    units, each split over D among the most blocks ``ds`` (a power of
    two, 16 W_down rows a block at least) that keeps the grid within two
    blocks an SM (the kernel's launch bounds), and as many slices a
    cluster as make it STREAM_MAX_SPLIT blocks, for fewer partials in the
    final sum; the grid padded to whole clusters. Set from
    kernel_sweep.py's ffn section."""
    n = -(-F_ // STREAM_SLICE)
    ds = 1
    while (2 * ds <= STREAM_MAX_SPLIT and STREAM_SLICE % (32 * ds) == 0
           and n * 2 * ds <= 2 * n_sms):
        ds *= 2
    group = 1
    while 2 * group * ds <= STREAM_MAX_SPLIT and 2 * group <= n:
        group *= 2
    return ds, ds * group, -(-n // group) * group * ds


def stream_smem_bytes(M: int, D: int, ds: int, int8: bool = False) -> int:
    """Dynamic shared memory of the stream kernel: x (8 16-bit rows of the
    block's D rows, padded) / the phase-1 fragments (8 KB) / the (M, D)
    f32 output partial in one region, the slice's phase-1 sums (2 x
    STREAM_SLICE x 8 f32), the ring (rows padded by 16 bytes: 16 KB of
    bf16 rows a stage, or 8 KB of int8 rows), h (8 16-bit rows of
    STREAM_SLICE / ds + 8), for a block reading 1 / ds of D."""
    dch = -(-(-(-D // ds)) // 16) * 16
    union = -(-max(16 * (dch + 8), 8192, 4 * M * D) // 16) * 16
    stage = STREAM_INT8_STAGE_BYTES if int8 else STREAM_STAGE_BYTES
    return (union + 64 * STREAM_SLICE + STREAM_STAGES * stage
            + 16 * (STREAM_SLICE // ds + 8))


def wgmma_stages(w_es: int, bm: int, nb: int) -> tuple[int, int]:
    """(ring stages, dynamic shared memory) of a GEMM phase: bm x
    WGMMA_BN tiles over nb weight operands of ``w_es`` bytes an element
    (1: int8, copied raw and widened into two bf16 buffers)."""
    xb, wb = 2 * bm * WGMMA_BK, 2 * WGMMA_BK * WGMMA_BN
    stage = xb + nb * (WGMMA_BK * WGMMA_BN if w_es == 1 else wb)
    wide = 2 * nb * wb if w_es == 1 else 0
    stages = min(WGMMA_MAX_STAGES, (SMEM_LIMIT - 1024 - wide) // stage)
    return stages, stages * stage + wide + 1024


def wgmma_smem_bytes(phase: int, w_es: int, wgs: int) -> int:
    """Dynamic shared memory of phase 1 (two weight operands) or phase 2
    (one) of the wgmma form, in 64·wgs x WGMMA_BN tiles."""
    return wgmma_stages(w_es, 64 * wgs, 2 if phase == 1 else 1)[1]


def wgmma_plan(M: int, D: int, F_: int, n_sms: int
               ) -> tuple[int, int, int]:
    """(wgs, ks, k_chunk) of the wgmma form, set from kernel_sweep.py's
    ffn section: both phases in 128 x WGMMA_BN tiles (64 at M <= 64),
    which read x and W fewest times; phase 2's F split into ks chunks of
    k_chunk (a multiple of 64), ks the power of two up to
    STREAM_MAX_SPLIT (a cluster; 3-block clusters pack the SMs' groups
    badly) with the least waves / ks, the smaller on a tie; no split where
    the tiles alone fill the card."""
    wgs = 2 if M > 64 else 1
    tiles = -(-M // (64 * wgs)) * -(-D // WGMMA_BN)
    steps = -(-F_ // WGMMA_BK)
    ks = min((k for k in (1, 2, 4, 8) if k <= steps and tiles < n_sms or
              k == 1), key=lambda k: (-(-tiles * k // n_sms) / k, k))
    k_chunk = -(-steps // ks) * WGMMA_BK
    return wgs, -(-F_ // k_chunk), k_chunk


def f_chunking(M: int, F_: int, n_sms: int, D: int) -> tuple[int, int]:
    """(f_per_block, n_fchunks) of the fma form: split F so the grid
    (row tiles x F chunks x column bands of D) holds about BLOCKS_PER_SM
    blocks per SM, in whole BF steps."""
    units = -(-F_ // BF)
    n_mt = -(-M // FMA_ROWS) * -(-D // FMA_BAND)
    want = max(1, min(units, -(-(BLOCKS_PER_SM * n_sms) // n_mt)))
    per = -(-units // want)
    return per * BF, -(-units // per)


def dequantize(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (K, N) weights times their (N,) column scales, in f32."""
    return w_q.float() * scale.float()


def ffn_act_int8_plain(x, w_up_q, w_up_scale, w_gate_q, w_gate_scale,
                       w_down_q, w_down_scale, kind: str = "silu_gated"
                       ) -> torch.Tensor:
    """x (M, D); int8 w_up_q/w_gate_q (D, F) with f32 scales (F,); int8
    w_down_q (F, D) with f32 scale (D,) -> (M, D), f32 math."""
    return ffn_act_plain(
        x, dequantize(w_up_q, w_up_scale),
        None if w_gate_q is None else dequantize(w_gate_q, w_gate_scale),
        dequantize(w_down_q, w_down_scale), kind)


ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
INT8_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]


@functools.lru_cache(maxsize=256)
def _plan(M: int, D: int, F_: int, x_bf16: bool, vec: int, x_ok: bool,
          dev: int) -> tuple:
    """(form code, form, the three plan ints, the scratch's shape and
    dtype: the f32 partials, or the bf16 hidden of the wgmma form) of a
    CUDA call on device ``dev``. ``vec``: bit 1 when the rows of W_up /
    W_gate start 16-byte aligned, bit 2 those of W_down; ``x_ok`` those
    of x. Cached: a decode step calls with the same shapes every layer
    (code that swaps a planner clears the cache: kernel_sweep.py)."""
    variant = kernel_variant(M, torch.bfloat16 if x_bf16 else torch.float32,
                             vec == 3 and x_ok)
    n_sms = build.sm_count(dev)
    if variant == "stream":
        plan = stream_plan(F_, n_sms)
        scratch = (plan[2] // plan[1], M, D), torch.float32
    elif variant == "wgmma":
        plan = wgmma_plan(M, D, F_, n_sms)
        scratch = (M, F_), torch.bfloat16
    else:
        per, n_fc = f_chunking(M, F_, n_sms, D)
        plan = (per, n_fc, vec)
        scratch = (n_fc, M, D), torch.float32
    return (VARIANTS.index(variant), variant, plan, *scratch)


def _pointers(entry: str, dev: int, operands: tuple) -> list:
    """Check each operand (name, tensor or None, shape, dtype): a
    contiguous tensor of that shape and dtype on CUDA device ``dev``, or
    None for an absent one. Returns their addresses (0 for None)."""
    ptrs = []
    for name, t, shape, dt in operands:
        if t is None:
            ptrs.append(0)
            continue
        if (t.shape != shape or t.dtype != dt or t.get_device() != dev
                or not t.is_contiguous()):
            raise ValueError(f"{entry}: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on cuda:{dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def _launch(entry: str, fn, x: torch.Tensor, dev: int, ptrs: list,
            wptrs: tuple, w_es: int, F_: int, kind: str
            ) -> tuple[torch.Tensor, str]:
    """Plan and launch C entry ``fn`` of library ``entry``: x's address
    and the weights' ``ptrs``, the scratch and the output, then shape,
    act, dtype, form and plan. ``wptrs`` are the addresses of W_up,
    W_gate and W_down, of ``w_es`` bytes an element. Returns (out,
    form)."""
    M, D = x.shape
    dt = build.dtype_code(x.dtype)
    px = x.data_ptr()
    up, gate, down = wptrs
    vec = (int((F_ * w_es) % 16 == 0 and (up | gate) % 16 == 0)
           | 2 * int((D * w_es) % 16 == 0 and down % 16 == 0))
    code, variant, plan, shape, sdt = _plan(
        M, D, F_, dt == 1, vec,
        (D * x.element_size()) % 16 == 0 and px % 16 == 0, dev)
    if (variant == "stream"
            and stream_smem_bytes(M, D, plan[0], w_es == 1) > SMEM_LIMIT):
        raise ValueError(f"{entry} stream form: d_model {D} at M {M} "
                         f"exceeds a block's shared memory")
    scratch = x.new_empty(shape, dtype=sdt)
    out = torch.empty_like(x)
    err = fn(px, *ptrs, scratch.data_ptr(), out.data_ptr(), M, D, F_,
             ACTS[kind], dt, code, *plan,
             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        build.check(build.load(entry), err, f"{entry} ({variant})")
    return out, variant


_entries: dict = {}      # C entries, bound at the first launch


def _entry(name: str, argtypes: list):
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = build.bind(name, name, argtypes)[1]
    return fn


def _x_device(entry: str, x: torch.Tensor) -> int:
    """x's CUDA device index; x must be a contiguous (M, D) tensor."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{entry}: x must be a contiguous (M, D) tensor")
    return x.get_device()


def ffn_act(x: torch.Tensor, w_up: torch.Tensor,
            w_gate: torch.Tensor | None, w_down: torch.Tensor,
            kind: str = "silu_gated") -> torch.Tensor:
    """x (M, D); w_up/w_gate (D, F); w_down (F, D) -> (M, D) in x.dtype."""
    if kind not in ACTS:
        raise ValueError(kind)
    if not x.is_cuda:
        return ffn_act_plain(x, w_up, w_gate, w_down, kind)
    dev = _x_device("ffn_act", x)
    D, F_ = x.shape[1], w_up.shape[1]
    ptrs = _pointers("ffn_act", dev, (
        ("w_up", w_up, (D, F_), x.dtype),
        ("w_gate", w_gate, (D, F_), x.dtype),
        ("w_down", w_down, (F_, D), x.dtype)))
    out, ffn_act.variant = _launch(
        "ffn_act", _entry("ffn_act", ARGTYPES), x, dev, ptrs, ptrs,
        x.element_size(), F_, kind)
    ffn_act.launches += 1
    return out


ffn_act.launches = 0
ffn_act.variant = None


def ffn_act_int8(x: torch.Tensor, w_up_q: torch.Tensor,
                 w_up_scale: torch.Tensor, w_gate_q: torch.Tensor | None,
                 w_gate_scale: torch.Tensor | None, w_down_q: torch.Tensor,
                 w_down_scale: torch.Tensor, kind: str = "silu_gated"
                 ) -> torch.Tensor:
    """x (M, D) f32/bf16; int8 w_up_q/w_gate_q (D, F) with f32 scales
    (F,); int8 w_down_q (F, D) with f32 scale (D,) -> (M, D) in x.dtype.
    ``w_gate_q``/``w_gate_scale`` are None for an ungated FFN."""
    if kind not in ACTS:
        raise ValueError(kind)
    if not x.is_cuda:
        return ffn_act_int8_plain(x, w_up_q, w_up_scale, w_gate_q,
                                  w_gate_scale, w_down_q, w_down_scale, kind)
    if (w_gate_q is None) != (w_gate_scale is None):
        raise ValueError("ffn_act_int8: w_gate_q and w_gate_scale go "
                         "together")
    dev = _x_device("ffn_act_int8", x)
    D, F_ = x.shape[1], w_up_q.shape[1]
    i8, f32 = torch.int8, torch.float32
    ptrs = _pointers("ffn_act_int8", dev, (
        ("w_up_q", w_up_q, (D, F_), i8),
        ("w_up_scale", w_up_scale, (F_,), f32),
        ("w_gate_q", w_gate_q, (D, F_), i8),
        ("w_gate_scale", w_gate_scale, (F_,), f32),
        ("w_down_q", w_down_q, (F_, D), i8),
        ("w_down_scale", w_down_scale, (D,), f32)))
    out, ffn_act_int8.variant = _launch(
        "ffn_act_int8", _entry("ffn_act_int8", INT8_ARGTYPES), x, dev, ptrs,
        ptrs[0::2], 1, F_, kind)
    ffn_act_int8.launches += 1
    return out


ffn_act_int8.launches = 0
ffn_act_int8.variant = None
