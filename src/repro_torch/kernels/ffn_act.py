"""FUSED_FFN_ACT: GEMM(x·W_up) -> act (* x·W_gate) -> GEMM(·W_down).

Replaces the TPU kernel `repro/kernels/ffn_act.py::ffn_act`. The CUDA
kernel is `csrc/ffn_act.cu`: blocks over (16-row M tile, F chunk), the
hidden tile kept in shared memory, f32 partials per F chunk summed in a
fixed order by a second kernel (see its header). Ragged M and F are
masked, not asserted. Activations: ``silu_gated``, ``gelu``,
``gelu_gated`` (tanh GELU) and ``relu2``.

`ffn_act` launches the kernels for CUDA tensors and runs `ffn_act_plain`
only for CPU tensors; ``ffn_act.launches`` counts launches (one per call:
the product kernel and its reduction).
"""

from __future__ import annotations

import ctypes
import functools

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


ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows_aligned(*ws) -> bool:
    """True when every row of the (D, F) weights starts 16-byte aligned,
    so the kernel may load their tiles 16 bytes at a time."""
    return all(w is None or (w.data_ptr() % 16 == 0
                             and (w.shape[1] * w.element_size()) % 16 == 0)
               for w in ws)


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
    if w_up.shape != (D, F_) or w_down.shape != (F_, D) or (
            w_gate is not None and w_gate.shape != (D, F_)):
        raise ValueError("ffn_act weight shapes")
    ws = [t for t in (x, w_up, w_gate, w_down) if t is not None]
    if any(t.dtype != x.dtype or t.device != x.device
           or not t.is_contiguous() for t in ws):
        raise ValueError("ffn_act needs contiguous tensors of one dtype on "
                         "one device")
    if D > 12 * 256:
        raise ValueError(f"ffn_act kernel supports d_model <= 3072, got {D}")
    f_per_block, n_fc = f_chunking(M, F_, _sm_count(x.device))
    partial = torch.empty((n_fc, M, D), dtype=torch.float32, device=x.device)
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    lib, fn = build.bind("ffn_act", "ffn_act", ARGTYPES)
    err = fn(
        build.ptr(x), build.ptr(w_up),
        None if w_gate is None else build.ptr(w_gate), build.ptr(w_down),
        build.ptr(partial), build.ptr(out), M, D, F_, row_tile(M),
        f_per_block, n_fc, ACTS[kind], int(_rows_aligned(w_up, w_gate)), build.dtype_code(x.dtype), build.stream_ptr(x.device))
    build.check(lib, err, "ffn_act")
    ffn_act.launches += 1
    return out


ffn_act.launches = 0
