"""Model-layout adapters over the kernel wrappers (the reference's
`kernels/ops.py`): the model keeps (B, S, H, D) activations and the
store-native cache layouts; these adapt them to each kernel's layout,
as strided views where the kernel can read them in place."""

from __future__ import annotations

import torch

from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import attn_stream as _attn
from repro_torch.kernels import ffn_act as _ffn
from repro_torch.kernels import fused_norm as _norm
from repro_torch.kernels import paged_decode as _paged

PAGED_DECODE_BLOCK = 128  # cold-page tokens per table entry (= endurance blk)


def attn_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,L,Hkv,D) -> (B,S,H,D). The kernel reads the
    transposed views in place and writes straight into the model-layout
    output."""
    out = torch.empty_like(q)
    _attn.attn_stream(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal,
                      out=out.transpose(1, 2))
    return out


def paged_decode_tiered(q: torch.Tensor, k_store: dict, v_store: dict,
                        pos, *, tau: float = 0.0,
                        block_k: int = PAGED_DECODE_BLOCK) -> torch.Tensor:
    """Decode attention over tiered stores. q (B,1,H,D); ``pos`` an int or
    a (B,) tensor of per-slot positions (the token just appended). The
    per-slot identity block table comes from `kv_tiers.cold_page_table`
    (dead pages are -1). Returns (B,1,H,D)."""
    B, _, H, D = q.shape
    Hkv = k_store["hot"].shape[2]
    W = KT.hot_window_of(k_store)
    max_len = k_store["cold_q"].shape[1]
    bk = min(block_k, max_len)
    lengths = KT.pos_rows(pos, B, q.device).to(torch.int32)
    table = KT.cold_page_table(lengths, W, max_len, bk)
    o = _paged.paged_decode_tiered(
        q[:, 0].reshape(B, Hkv, H // Hkv, D).contiguous(),
        k_store["hot"], v_store["hot"], k_store["cold_q"],
        k_store["cold_scale"], v_store["cold_q"], v_store["cold_scale"],
        lengths, table, scale=D ** -0.5, block_k=bk, tau=tau)
    return o.reshape(B, H, D)[:, None]


def ffn_act(x: torch.Tensor, w_up: torch.Tensor, w_gate, w_down: torch.Tensor,
            kind: str) -> torch.Tensor:
    lead = x.shape[:-1]
    out = _ffn.ffn_act(x.reshape(-1, x.shape[-1]), w_up, w_gate, w_down,
                       kind)
    return out.reshape(*lead, -1)


def fused_norm(x: torch.Tensor, scale: torch.Tensor, bias, kind: str = "rms"
               ) -> torch.Tensor:
    lead = x.shape[:-1]
    out = _norm.fused_norm(x.reshape(-1, x.shape[-1]), scale, bias, kind)
    return out.reshape(*lead, -1)
