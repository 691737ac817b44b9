"""Attention mixers: GQA (projections, the plain softmax attention,
flat-cache decode and the two-segment hot ring + int8 cold tier decode
merge) and DeepSeek-V2's MLA over its compressed latent cache.

Port of the reference's `models/attention.py`. The GQA functions are the
CPU path and the twins the kernels in `repro_torch.kernels` are held
against; `qkv_proj` goes through the `qkv_proj` wrapper, whose plain twin
is its CPU path. MLA runs no kernel, as in the reference: its
projections, kv-norm and attention are plain torch on either device,
scores in f32. Masks fill with ``NEG_INF = -2**20`` (not -inf), as the
reference does.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamInit, apply_rope, embed_axis,
                                       torch_dtype)

NEG_INF = -2.0 ** 20


def init_attn(b: ParamInit, cfg: ModelConfig) -> dict:
    e = embed_axis(cfg)
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": b.normal((cfg.d_model, H, Dh), (e, "heads", None)),
        "wk": b.normal((cfg.d_model, Hkv, Dh), (e, "kv_heads", None)),
        "wv": b.normal((cfg.d_model, Hkv, Dh), (e, "kv_heads", None)),
        "wo": b.normal((H, Dh, cfg.d_model), ("heads", None, e)),
    }
    if cfg.use_attn_bias:
        p["bq"] = b.zeros((H, Dh), ("heads", None))
        p["bk"] = b.zeros((Hkv, Dh), ("kv_heads", None))
        p["bv"] = b.zeros((Hkv, Dh), ("kv_heads", None))
        p["bo"] = b.zeros((cfg.d_model,), (None,))
    return p


def qkv_proj(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X·Wq (+bq), X·Wk (+bk), X·Wv (+bv); RoPE on q and k (keys are
    cached post-RoPE). x (B,S,D) -> (B,S,H,Dh), (B,S,Hkv,Dh) x2. The
    three projections are one `qkv_proj` call: the kernel on a CUDA
    tensor, its plain twin on the CPU."""
    cd = torch_dtype(cfg.compute_dtype)
    ws = [p[n].to(cd) for n in ("wq", "wk", "wv")]
    bs = [p[n].to(cd) for n in ("bq", "bk", "bv")] if "bq" in p \
        else [None] * 3
    q, k, v = ops.qkv_proj(x, *ws, *bs)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _bcast_kv_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B,L,Hkv,D) -> (B,L,H,D) by group broadcast: head h reads kv head
    h // G."""
    B, L, Hkv, D = t.shape
    G = H // Hkv
    if G == 1:
        return t
    return t[:, :, :, None].expand(B, L, Hkv, G, D).reshape(B, L, H, D)


def gqa_scores_softmax_pv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None,
                          scale: float | None = None,
                          scores_dtype=torch.float32) -> torch.Tensor:
    """Grouped attention. q (B,S,H,D); k,v (B,L,Hkv,D); mask broadcastable
    to (B,H,S,L) or None. Returns (B,S,H,D) in q.dtype."""
    H, D = q.shape[2], q.shape[3]
    scale = scale if scale is not None else D ** -0.5
    kf = _bcast_kv_heads(k.to(scores_dtype), H)
    vf = _bcast_kv_heads(v.to(scores_dtype), H)
    scores = torch.einsum("bshd,blhd->bhsl", q.to(scores_dtype), kf) * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhsl,blhd->bshd", probs, vf)
    return out.to(q.dtype)


def attend_flat(cfg, q: torch.Tensor, cache: dict, pos) -> torch.Tensor:
    """Decode attention over a flat cache {"k", "v"} of (B, L, Hkv, D):
    q (B,1,H,D), keys valid at positions <= pos (an int or a (B,)
    tensor of per-slot positions)."""
    k = cache["k"]
    B, L = k.shape[:2]
    p = KT.pos_rows(pos, B, k.device)
    valid = torch.arange(L, device=k.device) <= p[:, None]
    return gqa_scores_softmax_pv(q, k, cache["v"], _valid4(valid))


def flat_cache_logical() -> dict:
    ax = ("batch", "kv_seq_shard", "kv_heads", None)
    return {"k": ax, "v": ax}


def attn_out(p: dict, cfg: ModelConfig, o: torch.Tensor,
             tp=None) -> torch.Tensor:
    """The output projection; under ``tp`` (row-parallel over the local
    heads) the partial sums leave in one all-reduce (AttnOut) and the
    bias is added once, after it."""
    out = torch.einsum("bshk,hkd->bsd", o,
                       p["wo"].to(torch_dtype(cfg.compute_dtype)))
    if tp is not None:
        out = tp.all_reduce(out)
    if "bo" in p:
        out = out + p["bo"].to(out.dtype)
    return out


def causal_mask(S: int, L: int, offset: int = 0,
                device="cpu") -> torch.Tensor:
    """(1,1,S,L) causal mask: query i attends key j iff j <= i + offset."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(L, device=device)[None, :]
    return (kj <= qi + offset)[None, None]


# ---------------------------------------------------------------------------
# two-part (tiered) decode attention: flash-style partial softmax merge
# ---------------------------------------------------------------------------
def _valid4(valid: torch.Tensor) -> torch.Tensor:
    """(L,) or (B, L) validity -> broadcastable to (B,H,S,L)."""
    return valid[None, None, None, :] if valid.dim() == 1 \
        else valid[:, None, None, :]


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, scale: float,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None,
                      sdt=torch.float32):
    """One attendable segment -> flash partials (m, denom, acc), f32.

    q (B,S,H,D); k,v (B,L,Hkv,D), possibly int8 with per-(token, head)
    scales k_scale/v_scale (B,L,Hkv,1) that factor OUT of the dots:
    scores = (q·k_q)·k_scale and pv = (p·v_scale)·v_q."""
    H = q.shape[2]
    kf = _bcast_kv_heads(k.to(sdt), H)
    scores = torch.einsum("bshd,blhd->bhsl", q.to(sdt), kf) * scale
    if k_scale is not None:
        ks = _bcast_kv_heads(k_scale, H)[..., 0]           # (B,L,H)
        scores = scores * ks.transpose(1, 2)[:, :, None, :].to(scores.dtype)
    scores = torch.where(_valid4(valid), scores.float(),
                         torch.tensor(NEG_INF, device=scores.device))
    m = scores.amax(dim=-1, keepdim=True)                  # (B,H,S,1)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    pv = p.to(sdt)
    if v_scale is not None:
        vs = _bcast_kv_heads(v_scale, H)[..., 0]
        pv = pv * vs.transpose(1, 2)[:, :, None, :].to(pv.dtype)
    vf = _bcast_kv_heads(v.to(sdt), H)
    acc = torch.einsum("bhsl,blhd->bhsd", pv, vf).float()
    return m, denom, acc


def merge_partials(parts, out_dtype) -> torch.Tensor:
    """Merge flash partials across segments -> (B,S,H,D)."""
    m_star = parts[0][0]
    for m, _, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    denom = 0.0
    acc = 0.0
    for m, d, a in parts:
        w = torch.exp(m - m_star)
        denom = denom + d * w
        acc = acc + a * w
    out = acc / torch.clamp(denom, min=1e-30)
    return out.transpose(1, 2).to(out_dtype)


def tiered_valid(pos, W: int, max_len: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cold_valid, hot_valid) for a scalar or (B,) ``pos``: a cold token
    is attendable iff its position <= pos - W, a hot slot iff its ring
    position is in [0, pos]."""
    p = pos if isinstance(pos, torch.Tensor) else torch.tensor(int(pos))
    p = p.to(device=device, dtype=torch.long)
    cold_valid = torch.arange(max_len, device=device) <= (p[..., None] - W)
    hot_pos = KT.hot_ring_positions(p, W)
    hot_valid = (hot_pos >= 0) & (hot_pos <= p[..., None])
    return cold_valid, hot_valid


def attend_tiered(cfg, q: torch.Tensor, k_store: dict, v_store: dict,
                  pos) -> torch.Tensor:
    """Decode attention over a tiered KV store without concat or dequant
    materialization: the cold (int8) and hot (ring) segments each give
    flash partials, merged by softmax stitching. ``pos`` may be a (B,)
    tensor of per-slot positions."""
    scale = q.shape[-1] ** -0.5
    sdt = torch_dtype(cfg.attn_scores_dtype)
    W = k_store["hot"].shape[1]
    cold_valid, hot_valid = tiered_valid(pos, W, k_store["cold_q"].shape[1],
                                         q.device)
    p_cold = partial_attention(
        q, k_store["cold_q"], v_store["cold_q"], cold_valid, scale,
        k_scale=k_store["cold_scale"], v_scale=v_store["cold_scale"],
        sdt=sdt)
    p_hot = partial_attention(q, k_store["hot"], v_store["hot"], hot_valid,
                              scale, sdt=sdt)
    return merge_partials([p_cold, p_hot], q.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): the cache holds the kv_lora_rank latent c_kv and the
# shared RoPE key k_rope, one row per token (stores of inner shape (R,)
# and (rope,)); the CHIME tiers stack on that latent
# ---------------------------------------------------------------------------
def init_mla(b: ParamInit, cfg: ModelConfig) -> dict:
    m = cfg.mla
    H = cfg.num_heads
    e = embed_axis(cfg)
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = b.normal((cfg.d_model, m.q_lora_rank), (e, None))
        p["q_norm_scale"] = b.ones((m.q_lora_rank,), (None,))
        p["wq_b"] = b.normal((m.q_lora_rank, H, qk_dim),
                             (None, "heads", None))
    else:
        p["wq"] = b.normal((cfg.d_model, H, qk_dim), (e, "heads", None))
    p["wkv_a"] = b.normal((cfg.d_model, m.kv_lora_rank), (e, None))
    p["kv_norm_scale"] = b.ones((m.kv_lora_rank,), (None,))
    p["wk_rope"] = b.normal((cfg.d_model, m.qk_rope_head_dim), (e, None))
    p["wk_b"] = b.normal((m.kv_lora_rank, H, m.qk_nope_head_dim),
                         (None, "heads", None))
    p["wv_b"] = b.normal((m.kv_lora_rank, H, m.v_head_dim),
                         (None, "heads", None))
    p["wo"] = b.normal((H, m.v_head_dim, cfg.d_model), ("heads", None, e))
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """The latent RMSNorm, in f32 (the reference's plain `_rms`, not the
    fused_norm kernel)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            * scale.float()).to(x.dtype)


def mla_latents(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed KV latent c_kv (B,S,R) and the shared post-RoPE key
    k_rope (B,S,rope): what the (tierable) MLA cache stores."""
    cd = torch_dtype(cfg.compute_dtype)
    c_kv = _rms(torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(cd)),
                p["kv_norm_scale"])
    k_rope = torch.einsum("bsd,dr->bsr", x, p["wk_rope"].to(cd))
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_queries(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, enter=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) after RoPE), through the
    low-rank wq_a / wq_b pair when ``q_lora_rank`` is set, else wq.
    ``enter`` (tensor parallel) takes the replicated input of the
    head-split product: the low-rank query, or x."""
    m = cfg.mla
    cd = torch_dtype(cfg.compute_dtype)
    enter = enter or (lambda t: t)
    if m.q_lora_rank:
        cq = _rms(torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(cd)),
                  p["q_norm_scale"])
        q = torch.einsum("bsr,rhk->bshk", enter(cq), p["wq_b"].to(cd))
    else:
        q = torch.einsum("bsd,dhk->bshk", enter(x), p["wq"].to(cd))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_attention(p: dict, cfg: ModelConfig, q_nope: torch.Tensor,
                  q_rope: torch.Tensor, c_kv: torch.Tensor,
                  k_rope: torch.Tensor, mask: torch.Tensor | None,
                  absorbed: bool) -> torch.Tensor:
    """MLA attention from latents, scores in f32; ``mask`` (bool)
    broadcastable to (B,H,S,L), or None (no mask). Two forms of one function:

    * expanded: per-head K_nope and V materialized from the latent, then
      plain multi-head attention;
    * absorbed: W_uk folded into the query and W_uv into the output, so
      scores and PV run in the kv_lora_rank latent space and no
      (B,L,H,128) key is built.

    Returns the output projection (B,S,D)."""
    cd = torch_dtype(cfg.compute_dtype)
    scores = torch.einsum("bshr,blr->bhsl", q_rope.float(), k_rope.float())
    if absorbed:
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(cd))
        scores = scores + torch.einsum("bshr,blr->bhsl", q_lat.float(),
                                       c_kv.float())
    else:
        k_nope = torch.einsum("blr,rhk->blhk", c_kv, p["wk_b"].to(cd))
        scores = scores + torch.einsum("bshk,blhk->bhsl", q_nope.float(),
                                       k_nope.float())
    scores = scores * _mla_scale(cfg)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if absorbed:
        o_lat = torch.einsum("bhsl,blr->bshr", probs, c_kv.float()).to(cd)
        o = torch.einsum("bshr,rhv->bshv", o_lat, p["wv_b"].to(cd))
    else:
        v = torch.einsum("blr,rhv->blhv", c_kv, p["wv_b"].to(cd))
        o = torch.einsum("bhsl,blhv->bshv", probs, v.float()).to(cd)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(cd))


def mla_attend_tiered(p: dict, cfg: ModelConfig, q_nope: torch.Tensor,
                      q_rope: torch.Tensor, c_store: dict, r_store: dict,
                      pos) -> torch.Tensor:
    """Tiered MLA decode, always in the absorbed (latent-space) form: the
    cold latent tier stays int8, its per-token scales factored out of
    both score dots and the PV dot; the cold and hot segments merge by
    softmax stitching (`merge_partials`). ``pos`` may be a (B,) tensor:
    each row's cold and hot validity is its own (`tiered_valid`).
    Returns the output projection (B,S,D)."""
    cd = torch_dtype(cfg.compute_dtype)
    scale = _mla_scale(cfg)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope,
                         p["wk_b"].to(cd)).float()          # (B,S,H,R)
    qr = q_rope.float()
    W = KT.hot_window_of(c_store)
    cold_valid, hot_valid = tiered_valid(pos, W, c_store["cold_q"].shape[1],
                                         q_nope.device)

    def seg(c, c_scale, r, r_scale, valid):
        cf = c.float()
        nope = torch.einsum("bshr,blr->bhsl", q_lat, cf)
        rope = torch.einsum("bshr,blr->bhsl", qr, r.float())
        if c_scale is not None:
            nope = nope * c_scale[..., 0][:, None, None, :]
            rope = rope * r_scale[..., 0][:, None, None, :]
        scores = ((nope + rope) * scale).masked_fill(~_valid4(valid),
                                                     NEG_INF)
        mx = scores.amax(dim=-1, keepdim=True)
        pr = torch.exp(scores - mx)
        den = pr.sum(dim=-1, keepdim=True)
        if c_scale is not None:
            pr = pr * c_scale[..., 0][:, None, None, :]
        return mx, den, torch.einsum("bhsl,blr->bhsr", pr, cf)

    parts = [seg(c_store["cold_q"], c_store["cold_scale"],
                 r_store["cold_q"], r_store["cold_scale"], cold_valid),
             seg(c_store["hot"], None, r_store["hot"], None, hot_valid)]
    o_lat = merge_partials(parts, cd)                       # (B,S,H,R)
    o = torch.einsum("bshr,rhv->bshv", o_lat, p["wv_b"].to(cd))
    return torch.einsum("bshv,hvd->bsd", o, p["wo"].to(cd))


def mla_cache_logical() -> dict:
    return {"c_kv": ("batch", "kv_seq_shard", None),
            "k_rope": ("batch", "kv_seq_shard", None)}
