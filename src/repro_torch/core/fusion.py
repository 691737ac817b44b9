"""Kernel dispatch for the model (the reference's fusion registry, paper
§III-C ③, Table I), PyTorch port.

On a CUDA tensor the port calls its Hopper kernels — `fused_norm` for
every norm, `qkv_proj` for every Q/K/V projection (in
`models.attention.qkv_proj`), `ffn_act` for the dense FFN and
`ffn_act_int8` for the int8 "RRAM" weight store, `attn_stream` for
causal prefill, the causal full-sequence forward AND every
chunked-prefill extend, `paged_decode_tiered`
for decode over the tiered store and `paged_decode_flat` for fused decode
over a flat store — whatever ``cfg.use_pallas_kernels`` says: that flag
names the TPU's Pallas path, and the port's main path on the card is the
kernels. The field stays in the config so the two packages' configs stay
equal field by field. On a CPU tensor the same dispatch reaches each
kernel wrapper's plain twin.

Fused decode and the SLIM sparse read are the reference's knobs, read as
the reference reads them here: ``cfg.fused_decode`` or the
``REPRO_SERVE_FUSED_DECODE`` env var, ``cfg.sparse_read_tau`` or
``REPRO_SERVE_SPARSE_READ`` (the serving backend resolves them once more,
explicit argument first, and rewrites the config). Tiered decode always
runs `paged_decode_tiered`, exact (tau = 0) unless fused decode is on —
the reference's unfused two-segment merge is exact too.

Where the kernels do not apply the plain path runs on either device: an
FFN with biases (`apply_mlp`, as the reference), flat-store decode
without fused decode (`store_read` + softmax, the reference default),
MLA (projections, attention and tiered decode are plain torch in the
reference too; fused decode is GQA-only), an encoder's non-causal
attention (the reference's kernel is causal only) and the MoE experts (batched
matmuls, as the reference's einsums). A dense-first MoE layer's FFN is a
plain gated FFN and runs `ffn_act`.
"""

from __future__ import annotations

import os

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.runtime import trace

FFN_KINDS = ("gelu", "silu_gated", "gelu_gated", "relu2")


def _use_fused_decode(cfg: ModelConfig) -> bool:
    """Fused paged decode: the cfg flag, else ``REPRO_SERVE_FUSED_DECODE``
    (unset, empty or "0" = off)."""
    if getattr(cfg, "fused_decode", False):
        return True
    return os.environ.get("REPRO_SERVE_FUSED_DECODE", "") not in ("", "0")


def _sparse_read_tau(cfg: ModelConfig) -> float:
    """SLIM sparse-read threshold: the cfg value if > 0, else
    ``REPRO_SERVE_SPARSE_READ``; malformed or negative reads as 0 (off)."""
    tau = float(getattr(cfg, "sparse_read_tau", 0.0) or 0.0)
    if tau > 0.0:
        return tau
    raw = os.environ.get("REPRO_SERVE_SPARSE_READ", "")
    try:
        return max(float(raw), 0.0) if raw else 0.0
    except ValueError:
        return 0.0


def _reduce(out: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel output's partial sums, summed over 'model' under
    ``tp`` (the MLA latents are replicated, its heads split)."""
    return out if tp is None else tp.all_reduce(out)


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return ops.fused_norm(x, p["scale"], None, kind="rms")
    return ops.fused_norm(x, p["scale"], p["bias"], kind="layer")


@trace.traced("ffn")
def apply_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor,
              mlp_type: str | None = None,
              dropless: bool = True, tp=None, dp=None) -> torch.Tensor:
    """The FFN half of a block; under ``tp`` (a `models.tp.TP`) the
    leaves are the rank's hidden-dim (or expert) shard, x enters the
    region (`TP.enter`) and the partial sums leave in one all-reduce
    (FFNOut), a bias added after it. ``dp`` (`models.tp.DP`) is the
    batch's split over data ranks, which the capacity MoE reads."""
    kind = mlp_type or cfg.mlp_type
    if kind == "moe":
        # serving routes dropless: capacity competition would couple the
        # tokens of a batch and make chunked prefill depend on the
        # chunking; the full-sequence forward drops past the capacity
        kw = {} if dp is None else {"dp": dp}
        return L.apply_moe(p, cfg, x, dropless=dropless, tp=tp, **kw)
    if kind == "rwkv_cm":
        raise ValueError("rwkv_cm is stateful; handled in model block")
    if kind not in FFN_KINDS:
        raise ValueError(f"unknown mlp kind {kind!r}")
    if tp is not None:
        x = tp.enter(x)
    if "b_up" in p:
        return L.apply_mlp(p, cfg, x, mlp_type=kind, tp=tp)
    if "w_up_q" in p:
        out = ops.ffn_act_int8(x, p["w_up_q"], p["w_up_scale"],
                               p.get("w_gate_q"), p.get("w_gate_scale"),
                               p["w_down_q"], p["w_down_scale"], kind)
    else:
        gate = p.get("w_gate")
        out = ops.ffn_act(x, p["w_up"].to(x.dtype),
                          None if gate is None else gate.to(x.dtype),
                          p["w_down"].to(x.dtype), kind)
    return out if tp is None else tp.all_reduce(out)


def apply_attention_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, causal: bool = True,
                        build_cache: bool = False, max_len: int = 0,
                        length=None, tp=None
                        ) -> tuple[torch.Tensor, dict | None]:
    """Full-sequence attention (prefill, or the full forward of a decoder
    or an encoder). Causal attention runs `attn_stream`; non-causal
    (hubert's encoder) is the plain `gqa_scores_softmax_pv` with no mask
    and scores in ``cfg.attn_scores_dtype``, on either device, as the
    reference calls its kernel only when causal. With ``build_cache`` the
    post-RoPE K/V are absorbed into flat or tiered stores of ``max_len``
    positions, the first ``length`` (default S) valid; else no cache.
    Under ``tp`` the queries are the rank's heads and the stores get
    every kv head. The region starts at x (`TP.enter`): with the kv
    heads replicated, the K/V projections run inside it."""
    if tp is not None:
        x = tp.enter(x)
    q, k, v = A.qkv_proj(p, cfg, x, positions)
    kr, vr = (k, v) if tp is None else (tp.kv_local(k), tp.kv_local(v))
    if causal:
        o = ops.attn_stream(q, kr, vr, causal=True)
    else:
        o = A.gqa_scores_softmax_pv(
            q, kr, vr, None,
            scores_dtype=L.torch_dtype(cfg.attn_scores_dtype))
    cache = None
    if build_cache:
        if tp is not None:
            k, v = tp.kv_full(k), tp.kv_full(v)
        ln = x.shape[1] if length is None else length
        cache = {kv: KT.store_from_full(t, cfg.kv_policy, cfg.kv_hot_window,
                                        ln, max_len)
                 for kv, t in (("k", k), ("v", v))}
    return A.attn_out(p, cfg, o, tp), cache


@trace.traced("attn.extend")
def apply_attention_extend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           positions: torch.Tensor, cache: dict, pos: int,
                           length, commit: bool, tp=None
                           ) -> tuple[torch.Tensor, dict]:
    """Chunk-resumable prefill attention (serving `Model.extend`).

    ``cache`` is the workspace {"k_ws", "v_ws"} of full-precision
    (B, max_len, Hkv, D) buffers. The chunk's K/V land at rows
    pos..pos+C-1, and its queries attend the first pos + C rows through
    `attn_stream`, causal with q_offset = L - S = pos: query i sees key
    j iff j <= pos + i, the reference's extend mask, so the serving
    engine's prefill runs the kernel too. ``commit`` (the final chunk)
    folds the workspace into the flat/tiered stores with the same
    `store_from_full` whole-prompt prefill uses. Under ``tp`` the
    workspace holds every kv head (the chunk's rows gathered to it) and
    the local queries attend their own."""
    pos = int(pos)
    with trace.span("attn.qkv"):
        q, k, v = A.qkv_proj(p, cfg, x, positions)
        if tp is not None:
            k, v = tp.kv_full(k), tp.kv_full(v)
    C = x.shape[1]
    with trace.span("attn.workspace"):
        kf = cache["k_ws"].clone()
        vf = cache["v_ws"].clone()
        kf[:, pos:pos + C] = k.to(kf.dtype)
        vf[:, pos:pos + C] = v.to(vf.dtype)
        trace.count_bytes("kv.copy_bytes.workspace", (kf, vf))
    kr, vr = kf[:, :pos + C], vf[:, :pos + C]
    if tp is not None:
        kr, vr = tp.kv_read(kr, 2), tp.kv_read(vr, 2)
    with trace.span("attn.kernel"):
        o = ops.attn_stream(q, kr, vr, causal=True)
    with trace.span("attn.out"):
        out = A.attn_out(p, cfg, o, tp)
    if commit:
        ln = pos + (C if length is None else int(length))
        max_len = kf.shape[1]
        with trace.span("attn.commit"):
            return out, {
                "k": KT.store_from_full(kf, cfg.kv_policy,
                                        cfg.kv_hot_window, ln, max_len),
                "v": KT.store_from_full(vf, cfg.kv_policy,
                                        cfg.kv_hot_window, ln, max_len),
            }
    return out, {"k_ws": kf, "v_ws": vf}


@trace.traced("attn.decode")
def apply_attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           cache: dict, pos, tp=None
                           ) -> tuple[torch.Tensor, dict]:
    """One-token decode over flat or tiered stores. ``pos`` is an int or
    a (B,) tensor of per-row positions (the batched serving decode).
    Under ``tp`` the new rows of every kv head are appended to the
    full-headed stores and the kernels read the local queries' heads."""
    B = x.shape[0]
    with trace.span("attn.qkv"):
        positions = KT.pos_rows(pos, B, x.device)[:, None]
        q, k_new, v_new = A.qkv_proj(p, cfg, x, positions)
        if tp is not None:
            k_new, v_new = tp.kv_full(k_new), tp.kv_full(v_new)
    with trace.span("attn.append"):
        ck = KT.store_append(cache["k"], k_new, pos)
        cv = KT.store_append(cache["v"], v_new, pos)
    rk, rv = (ck, cv) if tp is None else (tp.store_read(ck),
                                          tp.store_read(cv))
    fused = _use_fused_decode(cfg)
    with trace.span("attn.kernel"):
        if "hot" in ck:
            o = ops.paged_decode_tiered(
                q, rk, rv, pos, tau=_sparse_read_tau(cfg) if fused else 0.0)
        elif fused:
            o = ops.paged_decode_flat(q, rk, rv, pos)
        else:
            cd = L.torch_dtype(cfg.compute_dtype)
            kv, valid = KT.store_read(rk, pos, cd)
            vv, _ = KT.store_read(rv, pos, cd)
            mask = valid[None, None, None, :] if valid.dim() == 1 \
                else valid[:, None, None, :]
            o = A.gqa_scores_softmax_pv(
                q, kv, vv, mask,
                scores_dtype=L.torch_dtype(cfg.attn_scores_dtype))
    with trace.span("attn.out"):
        out = A.attn_out(p, cfg, o, tp)
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA: the latent stores {"c_kv", "k_rope"} (flat or tiered, the same
# store functions as K/V, at inner shapes (R,) and (rope,))
# ---------------------------------------------------------------------------
def apply_mla_seq(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True,
                  build_cache: bool = False, max_len: int = 0,
                  length=None, tp=None) -> tuple[torch.Tensor, dict | None]:
    """Whole-sequence MLA (``cfg.mla_absorbed`` picks the form), causal
    unless an encoder's; with ``build_cache`` the latents are absorbed
    into flat or tiered stores of ``max_len`` positions, the first
    ``length`` (default S) valid; else no cache. Under ``tp`` the
    replicated latents and query input enter the head split
    (`TP.enter`)."""
    S = x.shape[1]
    c_kv, k_rope = A.mla_latents(p, cfg, x, positions)
    q_nope, q_rope = A.mla_queries(p, cfg, x, positions,
                                   None if tp is None else tp.enter)
    if tp is not None:
        c_kv, k_rope = tp.enter(c_kv), tp.enter(k_rope)
    mask = A.causal_mask(S, S, device=x.device) if causal else None
    out = _reduce(A.mla_attention(p, cfg, q_nope, q_rope, c_kv, k_rope,
                                  mask, absorbed=cfg.mla_absorbed), tp)
    cache = None
    if build_cache:
        ln = S if length is None else length
        cache = {n: KT.store_from_full(t, cfg.kv_policy, cfg.kv_hot_window,
                                       ln, max_len)
                 for n, t in (("c_kv", c_kv), ("k_rope", k_rope))}
    return out, cache


def apply_mla_extend(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, cache: dict, pos: int,
                     length, commit: bool, tp=None
                     ) -> tuple[torch.Tensor, dict]:
    """Chunk-resumable MLA prefill: the workspace {"c_kv_ws",
    "k_rope_ws"} of full-precision (B, max_len, .) latents takes the
    chunk's rows at pos..pos+C-1, and the chunk's queries attend its
    first pos + C rows causally (query i sees row j iff j <= pos + i:
    the exact rows of `apply_mla_seq`; a first chunk is the whole-prompt
    call's very shapes, so it rounds as `apply_mla_seq` does, as the
    GQA extend's `attn_stream` over the same slice). ``commit`` (the
    final chunk) folds the workspace into the flat/tiered latent stores
    with `store_from_full`."""
    pos = int(pos)
    C = x.shape[1]
    c_kv, k_rope = A.mla_latents(p, cfg, x, positions)
    q_nope, q_rope = A.mla_queries(p, cfg, x, positions)
    cf = cache["c_kv_ws"].clone()
    rf = cache["k_rope_ws"].clone()
    cf[:, pos:pos + C] = c_kv.to(cf.dtype)
    rf[:, pos:pos + C] = k_rope.to(rf.dtype)
    trace.count_bytes("kv.copy_bytes.workspace", (cf, rf))
    mask = A.causal_mask(C, pos + C, offset=pos, device=x.device)
    out = _reduce(A.mla_attention(p, cfg, q_nope, q_rope, cf[:, :pos + C],
                                  rf[:, :pos + C], mask,
                                  absorbed=cfg.mla_absorbed), tp)
    if commit:
        ln = pos + (C if length is None else int(length))
        max_len = cf.shape[1]
        return out, {
            n: KT.store_from_full(t, cfg.kv_policy, cfg.kv_hot_window, ln,
                                  max_len)
            for n, t in (("c_kv", cf), ("k_rope", rf))}
    return out, {"c_kv_ws": cf, "k_rope_ws": rf}


def apply_mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos, tp=None) -> tuple[torch.Tensor, dict]:
    """One-token MLA decode over the latent stores; ``pos`` is an int or
    a (B,) tensor of per-row positions. Fused decode is GQA-only (MLA's
    two-latent score sum does not fit the paged kernels), so MLA stays
    on this path whatever ``cfg.fused_decode`` says: tiered stores
    through `mla_attend_tiered` (absorbed), flat ones through
    `store_read` + `mla_attention` in the configured form."""
    B = x.shape[0]
    positions = KT.pos_rows(pos, B, x.device)[:, None]
    c_new, r_new = A.mla_latents(p, cfg, x, positions)
    q_nope, q_rope = A.mla_queries(p, cfg, x, positions)
    cc = KT.store_append(cache["c_kv"], c_new, pos)
    cr = KT.store_append(cache["k_rope"], r_new, pos)
    if "hot" in cc:
        out = A.mla_attend_tiered(p, cfg, q_nope, q_rope, cc, cr, pos)
    else:
        cd = L.torch_dtype(cfg.compute_dtype)
        c_all, valid = KT.store_read(cc, pos, cd)
        r_all, _ = KT.store_read(cr, pos, cd)
        out = A.mla_attention(p, cfg, q_nope, q_rope, c_all, r_all,
                              A._valid4(valid), absorbed=cfg.mla_absorbed)
    return _reduce(out, tp), {"c_kv": cc, "k_rope": cr}
