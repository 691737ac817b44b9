"""Kernel dispatch for the model (the reference's fusion registry, paper
§III-C ③, Table I), PyTorch port.

On a CUDA tensor the port calls its Hopper kernels — `fused_norm` for
every norm, `ffn_act` for the dense FFN, `attn_stream` for causal prefill
AND every chunked-prefill extend, `paged_decode_tiered` for decode over
the tiered store — whatever ``cfg.use_pallas_kernels`` / ``cfg.fused_decode``
say: those flags name the TPU's Pallas path, and the port's main path on
the card is the kernels. The fields stay in the config so the two
packages' configs stay equal field by field. On a CPU tensor the same
dispatch reaches each kernel wrapper's plain twin.

Where the kernels do not apply the plain path runs on either device: an
FFN with biases (`apply_mlp`, as the reference) and flat-policy decode
(`store_read` + softmax, the reference default).
``fused_decode=True`` on a flat store on CUDA raises: `paged_decode_flat`
is not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L

FFN_KINDS = ("gelu", "silu_gated", "gelu_gated", "relu2")


def sparse_read_tau(cfg: ModelConfig) -> float:
    """The SLIM sparse-read threshold is an option of the fused decode
    path, as in the reference: 0 (exact) unless ``fused_decode``."""
    if not getattr(cfg, "fused_decode", False):
        return 0.0
    return max(float(getattr(cfg, "sparse_read_tau", 0.0) or 0.0), 0.0)


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return ops.fused_norm(x, p["scale"], None, kind="rms")
    return ops.fused_norm(x, p["scale"], p["bias"], kind="layer")


def apply_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor,
              mlp_type: str | None = None) -> torch.Tensor:
    kind = mlp_type or cfg.mlp_type
    if kind not in FFN_KINDS:
        raise NotImplementedError(
            f"mlp {kind!r}: ROADMAP Queue 1 item 7 (remaining mixers)")
    if "b_up" in p or "w_up" not in p:
        return L.apply_mlp(p, cfg, x, mlp_type=kind)
    gate = p.get("w_gate")
    return ops.ffn_act(x, p["w_up"].to(x.dtype),
                       None if gate is None else gate.to(x.dtype),
                       p["w_down"].to(x.dtype), kind)


def apply_attention_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, max_len: int, length=None
                        ) -> tuple[torch.Tensor, dict]:
    """Causal full-sequence attention (prefill); the post-RoPE K/V are
    absorbed into flat or tiered stores of ``max_len`` positions.
    ``length`` (default S) counts the valid, unpadded prompt rows."""
    q, k, v = A.qkv_proj(p, cfg, x, positions)
    o = ops.attn_stream(q, k, v, causal=True)
    ln = x.shape[1] if length is None else length
    cache = {kv: KT.store_from_full(t, cfg.kv_policy, cfg.kv_hot_window,
                                    ln, max_len)
             for kv, t in (("k", k), ("v", v))}
    return A.attn_out(p, cfg, o), cache


def apply_attention_extend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           positions: torch.Tensor, cache: dict, pos: int,
                           length, commit: bool
                           ) -> tuple[torch.Tensor, dict]:
    """Chunk-resumable prefill attention (serving `Model.extend`).

    ``cache`` is the workspace {"k_ws", "v_ws"} of full-precision
    (B, max_len, Hkv, D) buffers. The chunk's K/V land at rows
    pos..pos+C-1, and its queries attend the first pos + C rows through
    `attn_stream`, causal with q_offset = L - S = pos: query i sees key
    j iff j <= pos + i, the reference's extend mask, so the serving
    engine's prefill runs the kernel too. ``commit`` (the final chunk)
    folds the workspace into the flat/tiered stores with the same
    `store_from_full` whole-prompt prefill uses."""
    pos = int(pos)
    q, k, v = A.qkv_proj(p, cfg, x, positions)
    C = x.shape[1]
    kf = cache["k_ws"].clone()
    vf = cache["v_ws"].clone()
    kf[:, pos:pos + C] = k.to(kf.dtype)
    vf[:, pos:pos + C] = v.to(vf.dtype)
    o = ops.attn_stream(q, kf[:, :pos + C], vf[:, :pos + C], causal=True)
    out = A.attn_out(p, cfg, o)
    if commit:
        ln = pos + (C if length is None else int(length))
        max_len = kf.shape[1]
        return out, {
            "k": KT.store_from_full(kf, cfg.kv_policy, cfg.kv_hot_window,
                                    ln, max_len),
            "v": KT.store_from_full(vf, cfg.kv_policy, cfg.kv_hot_window,
                                    ln, max_len),
        }
    return out, {"k_ws": kf, "v_ws": vf}


def apply_attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           cache: dict, pos) -> tuple[torch.Tensor, dict]:
    """One-token decode over flat or tiered stores. ``pos`` is an int or
    a (B,) tensor of per-row positions (the batched serving decode)."""
    B = x.shape[0]
    positions = KT.pos_rows(pos, B, x.device)[:, None]
    q, k_new, v_new = A.qkv_proj(p, cfg, x, positions)
    ck = KT.store_append(cache["k"], k_new, pos)
    cv = KT.store_append(cache["v"], v_new, pos)
    if "hot" in ck:
        o = ops.paged_decode_tiered(q, ck, cv, pos, tau=sparse_read_tau(cfg))
    else:
        if getattr(cfg, "fused_decode", False) and x.is_cuda:
            raise NotImplementedError(
                "fused decode over a flat store needs paged_decode_flat: "
                "ROADMAP Queue 2 item 5 (not ported yet)")
        cd = L.torch_dtype(cfg.compute_dtype)
        kv, valid = KT.store_read(ck, pos, cd)
        vv, _ = KT.store_read(cv, pos, cd)
        mask = valid[None, None, None, :] if valid.dim() == 1 \
            else valid[:, None, None, :]
        o = A.gqa_scores_softmax_pv(
            q, kv, vv, mask, scores_dtype=L.torch_dtype(cfg.attn_scores_dtype))
    return A.attn_out(p, cfg, o), {"k": ck, "v": cv}
