"""FUSED_FFN_ACT: GEMM(x·W_up) -> act (* x·W_gate) -> GEMM(·W_down).

`ffn_act` replaces the TPU kernel `repro/kernels/ffn_act.py::ffn_act`
(weights in the model's type); `ffn_act_int8` replaces
`repro/kernels/ffn_act.py::ffn_act_int8` (the "RRAM" weight store: int8
weights with per-output-column f32 scales, dequantized as they are read).
Both CUDA kernels share `csrc/ffn_act.cuh`: blocks over (row tile, F
chunk), the hidden tile kept in shared memory, f32 partials per F chunk
summed in a fixed order by a second kernel (see its header). Ragged M and
F are masked, not asserted. Activations: ``silu_gated``, ``gelu``,
``gelu_gated`` (tanh GELU) and ``relu2``; the int8 TPU kernel is ungated
only, the port's also takes the int8 gate that the model's int8 FFN
(`models.layers.apply_mlp`) multiplies in.

Each wrapper launches its kernels for CUDA tensors and runs its plain twin
(`ffn_act_plain`; `ffn_act_int8_plain`, the same over the dequantized
weights) only for CPU tensors; ``<wrapper>.launches`` counts launches (one
per call: the product kernel and its reduction).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

ACTS = {"silu_gated": 0, "gelu": 1, "gelu_gated": 1, "relu2": 2}
BF = 32                  # the kernel's hidden-unit step
BLOCKS_PER_SM = 4        # grid target the F-chunk count is sized for


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
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
    h = _act(xf @ w_up.float(), kind)
    if w_gate is not None:
        h = h * (xf @ w_gate.float())
    return (h @ w_down.float()).to(x.dtype)


def row_tile(M: int) -> int:
    """The kernel's rows per block: 4 for decode's M <= 4, else 16."""
    return 4 if M <= 4 else 16


def f_chunking(M: int, F_: int, n_sms: int) -> tuple[int, int]:
    """(f_per_block, n_fchunks): split F so the grid holds about
    BLOCKS_PER_SM blocks per SM, in whole BF steps."""
    units = -(-F_ // BF)
    n_mt = -(-M // row_tile(M))
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


MAX_D = 12 * 256         # the kernel's register accumulator: 12 x 256
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
INT8_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]


def _rows_aligned(*ws) -> bool:
    """True when every row of the weights starts 16-byte aligned, so the
    kernel may load their tiles 16 bytes at a time."""
    return all(w is None or (w.data_ptr() % 16 == 0
                             and (w.shape[1] * w.element_size()) % 16 == 0)
               for w in ws)


def _launch(entry: str, argtypes: list, x: torch.Tensor, weights: list,
            F_: int, kind: str, vec: int) -> torch.Tensor:
    """Launch library ``entry``'s C function of the same name: pointers
    of x (contiguous (M, D)) and ``weights`` (None -> null), then the f32
    partial scratch and the output, then the shape and tiling. ``vec``
    holds the kernel's alignment bits: 1 for W_up / W_gate rows, 2 for
    W_down rows."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{entry}: x must be a contiguous (M, D) tensor")
    M, D = x.shape
    if D > MAX_D:
        raise ValueError(f"{entry} kernel supports d_model <= {MAX_D}, "
                         f"got {D}")
    f_per_block, n_fc = f_chunking(M, F_, build.sm_count(x.device.index))
    partial = torch.empty((n_fc, M, D), dtype=torch.float32, device=x.device)
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    lib, fn = build.bind(entry, entry, argtypes)
    err = fn(build.ptr(x),
             *(None if w is None else build.ptr(w) for w in weights),
             build.ptr(partial), build.ptr(out), M, D, F_, row_tile(M),
             f_per_block, n_fc, ACTS[kind], vec,
             build.dtype_code(x.dtype), build.stream_ptr(x.device))
    build.check(lib, err, entry)
    return out


def ffn_act(x: torch.Tensor, w_up: torch.Tensor,
            w_gate: torch.Tensor | None, w_down: torch.Tensor,
            kind: str = "silu_gated") -> torch.Tensor:
    """x (M, D); w_up/w_gate (D, F); w_down (F, D) -> (M, D) in x.dtype."""
    if kind not in ACTS:
        raise ValueError(kind)
    if not x.is_cuda:
        return ffn_act_plain(x, w_up, w_gate, w_down, kind)
    M, D = x.shape
    F_ = w_up.shape[1]
    build.require_operands("ffn_act", x.device, {
        "w_up": (w_up, (D, F_), x.dtype),
        "w_gate": (w_gate, (D, F_), x.dtype),
        "w_down": (w_down, (F_, D), x.dtype)})
    out = _launch("ffn_act", ARGTYPES, x, [w_up, w_gate, w_down], F_, kind,
                  int(_rows_aligned(w_up, w_gate)))
    ffn_act.launches += 1
    return out


ffn_act.launches = 0


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
    M, D = x.shape
    F_ = w_up_q.shape[1]
    if (w_gate_q is None) != (w_gate_scale is None):
        raise ValueError("ffn_act_int8: w_gate_q and w_gate_scale go "
                         "together")
    build.require_operands("ffn_act_int8", x.device, {
        "w_up_q": (w_up_q, (D, F_), torch.int8),
        "w_up_scale": (w_up_scale, (F_,), torch.float32),
        "w_gate_q": (w_gate_q, (D, F_), torch.int8),
        "w_gate_scale": (w_gate_scale, (F_,), torch.float32),
        "w_down_q": (w_down_q, (F_, D), torch.int8),
        "w_down_scale": (w_down_scale, (D,), torch.float32)})
    out = _launch("ffn_act_int8", INT8_ARGTYPES, x,
                  [w_up_q, w_up_scale, w_gate_q, w_gate_scale, w_down_q,
                   w_down_scale], F_, kind,
                  int(_rows_aligned(w_up_q, w_gate_q))
                  | 2 * int(_rows_aligned(w_down_q)))
    ffn_act_int8.launches += 1
    return out


ffn_act_int8.launches = 0
