"""Model-layout adapters over the kernel wrappers (the reference's
`kernels/ops.py`): the model keeps (B, S, H, D) activations and the
store-native cache layouts; these adapt them to each kernel's layout,
as strided views where the kernel can read them in place.

Gradients. A kernel launched through ctypes is invisible to autograd,
so the four kernels of the training path (`fused_norm`, `qkv_proj`,
`attn_stream`, `ffn_act`) run inside `KernelGrad` wherever a gradient is
needed: its forward is the kernel (the plain twin on a CPU tensor), its
backward the VJP of the plain twin, recomputed on the saved inputs. The
reference has no backward kernel (no `custom_vjp`: `jax.grad`
differentiates its plain path), so none is written here. Where no
gradient is needed (serving, `no_grad`) the wrapper is called directly
and nothing is saved. `ffn_act_int8` and the paged decodes are never
differentiated: training does not reach them.

The analytic walk (`launch.hlo_analysis.analyze`) sets `WALK` while it
runs a step on meta tensors. Each kernel wrapper's call is then one
call site (`WALK.call_site`): its FLOPs are the twin's products inside
it, its bytes only its operands and outputs, as the card's kernel moves
them. `KernelGrad`'s rerun of the twin's forward in the backward is
ordinary ops (the card materialises them), reported apart as
recompute (`WALK.recompute`). With `WALK` None (always, outside the
walk) each call is the plain call.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import attn_stream as _attn
from repro_torch.kernels import ffn_act as _ffn
from repro_torch.kernels import fused_norm as _norm
from repro_torch.kernels import paged_decode as _paged
from repro_torch.kernels import qkv_proj as _qkv

PAGED_DECODE_BLOCK = 128  # cold-page tokens per table entry (= endurance blk)

# the analytic walk's observer while it runs (`launch.hlo_analysis`)
WALK = None


def _call(fn, *args, **kw):
    """``fn(*args, **kw)``, a kernel wrapper's call: one call site of the
    analytic walk while it runs."""
    if WALK is None:
        return fn(*args, **kw)
    return WALK.call_site(fn, args, kw)


class KernelGrad(torch.autograd.Function):
    """``kernel(*inputs)`` forward; backward through ``plain(*inputs)``,
    the same function in plain PyTorch, recomputed under autograd on the
    saved inputs. ``inputs`` are tensors or None; the outputs a tensor
    or a tuple of tensors."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return _call(kernel, *inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            outs = (ctx.plain(*xs) if WALK is None
                    else WALK.recompute(ctx.plain, xs))
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [x for x, n in zip(xs, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
        return (None, None, *(next(got) if n else None for n in need))


def _recording(*inputs) -> bool:
    """Whether autograd records a call on ``inputs``: grad mode on and an
    input that requires a gradient (checked first, so the serving path,
    under `no_grad`, pays one call)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


def _attn_call(q, k, v, causal):
    out = torch.empty_like(q)
    _attn.attn_stream(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal,
                      out=out.transpose(1, 2))
    return out


def _attn_plain(q, k, v, causal):
    return _attn.attn_stream_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal).transpose(1, 2)


def attn_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,L,Hkv,D) -> (B,S,H,D). The kernel reads the
    transposed views in place and writes straight into the model-layout
    output."""
    if _recording(q, k, v):
        return KernelGrad.apply(functools.partial(_attn_call, causal=causal),
                                functools.partial(_attn_plain, causal=causal),
                                q, k, v)
    return _call(_attn_call, q, k, v, causal)


def paged_decode_tiered_operands(q: torch.Tensor, k_store: dict,
                                 v_store: dict, pos, *, tau: float = 0.0,
                                 block_k: int = PAGED_DECODE_BLOCK):
    """The kernel wrapper's (positional, keyword) arguments for
    `paged_decode_tiered` below: q in the kernel's (B, Hkv, G, D) layout,
    the stores read in place, per-slot lengths and the identity block
    table from `kv_tiers.cold_page_table` (dead pages are -1)."""
    B, _, H, D = q.shape
    Hkv = k_store["hot"].shape[2]
    W = KT.hot_window_of(k_store)
    max_len = k_store["cold_q"].shape[1]
    bk = min(block_k, max_len)
    lengths = KT.pos_rows(pos, B, q.device).to(torch.int32)
    table = KT.cold_page_table(lengths, W, max_len, bk)
    return ((q[:, 0].reshape(B, Hkv, H // Hkv, D).contiguous(),
             k_store["hot"], v_store["hot"], k_store["cold_q"],
             k_store["cold_scale"], v_store["cold_q"], v_store["cold_scale"],
             lengths, table), dict(scale=D ** -0.5, block_k=bk, tau=tau))


def paged_decode_tiered(q: torch.Tensor, k_store: dict, v_store: dict,
                        pos, *, tau: float = 0.0,
                        block_k: int = PAGED_DECODE_BLOCK) -> torch.Tensor:
    """Decode attention over tiered stores. q (B,1,H,D); ``pos`` an int or
    a (B,) tensor of per-slot positions (the token just appended).
    Returns (B,1,H,D)."""
    B, _, H, D = q.shape
    args, kw = paged_decode_tiered_operands(q, k_store, v_store, pos,
                                            tau=tau, block_k=block_k)
    return _call(_paged.paged_decode_tiered, *args, **kw).reshape(
        B, H, D)[:, None]


def paged_decode_flat_operands(q: torch.Tensor, k_store: dict,
                               v_store: dict, pos, *,
                               block_k: int = PAGED_DECODE_BLOCK):
    """The kernel wrapper's (positional, keyword) arguments for
    `paged_decode_flat` below: q in the kernel's (B, Hkv, G, D) layout,
    the flat stores read in place, per-slot lengths and the identity
    table `kv_tiers.cold_page_table` with hot window 0 (valid = position
    <= pos)."""
    B, _, H, D = q.shape
    k, v = k_store["flat"], v_store["flat"]
    Hkv, max_len = k.shape[2], k.shape[1]
    bk = min(block_k, max_len)
    lengths = KT.pos_rows(pos, B, q.device).to(torch.int32)
    table = KT.cold_page_table(lengths, 0, max_len, bk)
    return ((q[:, 0].reshape(B, Hkv, H // Hkv, D).contiguous(), k, v,
             lengths, table), dict(scale=D ** -0.5, block_k=bk))


def paged_decode_flat(q: torch.Tensor, k_store: dict, v_store: dict, pos, *,
                      block_k: int = PAGED_DECODE_BLOCK) -> torch.Tensor:
    """Decode attention over flat stores {"flat": (B, max_len, Hkv, D)},
    read in place. q (B,1,H,D); ``pos`` an int or a (B,) tensor of
    per-slot positions. Returns (B,1,H,D)."""
    B, _, H, D = q.shape
    args, kw = paged_decode_flat_operands(q, k_store, v_store, pos,
                                          block_k=block_k)
    return _call(_paged.paged_decode_flat, *args, **kw).reshape(
        B, H, D)[:, None]


def _qkv_call(proj, x, wq, wk, wv, bq, bk, bv):
    D = x.shape[-1]
    lead = x.shape[:-1]
    ws = (wq, wk, wv)
    bs = (None,) * 3 if bq is None else tuple(b.reshape(-1)
                                             for b in (bq, bk, bv))
    outs = proj(x.reshape(-1, D), *(w.reshape(D, -1) for w in ws), *bs)
    return tuple(o.reshape(*lead, *w.shape[1:]) for o, w in zip(outs, ws))


def qkv_proj(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor, bq=None, bk=None, bv=None):
    """x (B,S,D); weights (D, Hx, Dh), biases (Hx, Dh) or None -> q, k, v
    in model layout (B,S,Hx,Dh). The weights are read in place (2-D
    views), never concatenated."""
    if _recording(x, wq, wk, wv, bq, bk, bv):
        return KernelGrad.apply(
            functools.partial(_qkv_call, _qkv.qkv_proj),
            functools.partial(_qkv_call, _qkv.qkv_proj_plain),
            x, wq, wk, wv, bq, bk, bv)
    return _call(_qkv_call, _qkv.qkv_proj, x, wq, wk, wv, bq, bk, bv)


def ffn_act_int8(x: torch.Tensor, w_up_q: torch.Tensor,
                 w_up_scale: torch.Tensor, w_gate_q, w_gate_scale,
                 w_down_q: torch.Tensor, w_down_scale: torch.Tensor,
                 kind: str) -> torch.Tensor:
    lead = x.shape[:-1]
    out = _call(_ffn.ffn_act_int8, x.reshape(-1, x.shape[-1]), w_up_q,
                w_up_scale, w_gate_q, w_gate_scale, w_down_q, w_down_scale,
                kind)
    return out.reshape(*lead, -1)


def _rows(fn, x, *rest, kind):
    """``fn`` over x's rows: (..., D) -> (M, D) in, (..., N) out."""
    return fn(x.reshape(-1, x.shape[-1]), *rest, kind=kind).reshape(
        *x.shape[:-1], -1)


def ffn_act(x: torch.Tensor, w_up: torch.Tensor, w_gate, w_down: torch.Tensor,
            kind: str) -> torch.Tensor:
    if _recording(x, w_up, w_gate, w_down):
        return KernelGrad.apply(
            functools.partial(_rows, _ffn.ffn_act, kind=kind),
            functools.partial(_rows, _ffn.ffn_act_plain, kind=kind),
            x, w_up, w_gate, w_down)
    return _call(_rows, _ffn.ffn_act, x, w_up, w_gate, w_down, kind=kind)


def fused_norm(x: torch.Tensor, scale: torch.Tensor, bias, kind: str = "rms"
               ) -> torch.Tensor:
    if _recording(x, scale, bias):
        return KernelGrad.apply(
            functools.partial(_rows, _norm.fused_norm, kind=kind),
            functools.partial(_rows, _norm.fused_norm_plain, kind=kind),
            x, scale, bias)
    return _call(_rows, _norm.fused_norm, x, scale, bias, kind=kind)
