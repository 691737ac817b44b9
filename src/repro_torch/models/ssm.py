"""Attention-free mixers: RWKV6 (Finch, data-dependent decay) and Mamba2
(SSD), with their single-step decode recurrences. PyTorch port of the
reference's `models/ssm.py`.

Both use the same *chunked hybrid* algorithm: the sequence is split into
chunks of ``chunk`` positions; the intra-chunk contribution is an exact
scan over the chunk's positions (a Python loop, every chunk of the
sequence batched on an (N,) axis where the reference vmaps), and the
inter-chunk contribution a loop over chunks carrying the recurrent state.
Every exponential is exp(a sum of negative log-decays) <= 1, so the
algorithm is stable at any length. The chunk grid is absolute: a sequence
is identity-padded to whole chunks (`_pad_to_grid`), so a prompt run
whole and the same prompt run as chunk-aligned `extend` slices take the
same op sequence.

The reference has no Pallas kernel for either recurrence (`jax.lax.scan`
and `einsum` only), so both stay plain PyTorch ops here, op for op. The
recurrent states are f32; the token-shift / conv history is in the
compute dtype, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamInit, embed_axis, torch_dtype

f32 = torch.float32


# ---------------------------------------------------------------------------
# RWKV6 time-mix
# ---------------------------------------------------------------------------
def init_rwkv6(b: ParamInit, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H, K = cfg.num_heads, cfg.head_dim
    r = cfg.ssm.rwkv_lora_rank
    rd = cfg.ssm.rwkv_decay_lora
    e = embed_axis(cfg)
    return {
        "mu_x": b.zeros((D,), (None,)),
        "mu": b.zeros((5, D), (None, None)),         # w,k,v,r,g bases
        "lora_a": b.normal((D, 5 * r), (e, None), scale=0.01),
        "lora_b": b.normal((5, r, D), (None, None, None), scale=0.01),
        "decay_base": b.zeros((D,), (None,)),
        "decay_a": b.normal((D, rd), (e, None), scale=0.01),
        "decay_b": b.normal((rd, D), (None, None), scale=0.01),
        "bonus_u": b.zeros((H, K), ("heads", None)),
        "w_r": b.normal((D, H, K), (e, "heads", None)),
        "w_k": b.normal((D, H, K), (e, "heads", None)),
        "w_v": b.normal((D, H, K), (e, "heads", None)),
        "w_g": b.normal((D, D), (e, None)),
        "w_o": b.normal((H, K, D), ("heads", None, e)),
        "ln_x_scale": b.ones((H, K), ("heads", None)),
        "ln_x_bias": b.zeros((H, K), ("heads", None)),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) through a (D,H,K) projection -> (B,S,H,K)."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).unflatten(-1, (H, K))


def _rwkv6_inputs(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  shifted: torch.Tensor, heads: tuple[int, int] | None = None,
                  enter=None):
    """Token-shift mixing + projections. x, shifted: (B,S,D). Returns
    r, k, v (B,S,H,K), logw (B,S,H,K) f32 negative log-decay, g (B,S,D).
    ``enter`` (tensor parallel) takes the replicated tensors the rank's
    heads read: the r / k / v inputs and the decay."""
    enter = enter or (lambda t: t)
    cd = torch_dtype(cfg.compute_dtype)
    H, K = cfg.num_heads, cfg.head_dim
    sx = shifted - x
    base = x + sx * p["mu_x"].to(x.dtype)
    r_lora = torch.tanh(base @ p["lora_a"].to(cd))
    r_lora = r_lora.unflatten(-1, (5, -1))                    # (B,S,5,r)
    dyn = torch.einsum("bsir,ird->bsid", r_lora, p["lora_b"].to(cd))
    mixed = x[:, :, None] + sx[:, :, None] * (
        p["mu"].to(x.dtype) + dyn)                             # (B,S,5,D)
    xw, xk, xv, xr, xg = mixed.unbind(2)

    decay_raw = (p["decay_base"].float()
                 + (xw.float() @ p["decay_a"].float()) @ p["decay_b"].float())
    logw = -torch.exp(decay_raw)                               # (B,S,D) < 0
    B, S, _ = x.shape
    logw = enter(logw.reshape(B, S, H, K))
    if heads is not None:     # the rank's heads (w_r / w_k / w_v split)
        logw = logw[:, :, heads[0]:heads[1]]
    rr = _heads(enter(xr), p["w_r"].to(cd))
    kk = _heads(enter(xk), p["w_k"].to(cd))
    vv = _heads(enter(xv), p["w_v"].to(cd))
    g = F.silu(xg @ p["w_g"].to(cd))
    return rr, kk, vv, logw, g


def _rwkv6_finish(p: dict, cfg: ModelConfig, y: torch.Tensor,
                  g: torch.Tensor, tp=None) -> torch.Tensor:
    """Per-head groupnorm (ln_x, population variance), gate, output
    projection. y: (B,S,H,K); under ``tp`` the rank's heads, the
    row-parallel projection's partial sums reduced before the gate."""
    cd = torch_dtype(cfg.compute_dtype)
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    yn = yn * p["ln_x_scale"].float() + p["ln_x_bias"].float()
    H, K, D = p["w_o"].shape
    out = yn.to(cd).flatten(-2) @ p["w_o"].to(cd).reshape(H * K, D)
    if tp is not None:
        out = tp.all_reduce(out)
    return out * g


def _pad_to_grid(S: int, chunk: int, *tensors):
    """Zero-pad (B,S,...) tensors along axis 1 to the next multiple of
    ``chunk``. Zero inputs are identity elements of both recurrences
    (k = v = 0 adds nothing to the state; logw = 0 / dt = 0 is decay
    exp(0) = 1), so a padded tail leaves the state as the exact length
    would, and a sequence run whole and as chunk-aligned slices runs the
    same op sequence."""
    S_pad = ((S + chunk - 1) // chunk) * chunk
    if S_pad == S:
        return tensors
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, S_pad - S))
                 for t in tensors)


def wkv6_chunked(r, k, v, logw, u, state0, chunk: int):
    """Chunked WKV6. r, k, v, logw: (B,S,H,K) [f32 math]; u: (H,K);
    state0: (B,H,K,K) [key dim, value dim]. Returns y (B,S,H,K) f32 and
    the state. S need not divide ``chunk`` (see `_pad_to_grid`)."""
    B, S, H, K = r.shape
    r, k, v, logw = _pad_to_grid(S, chunk, r, k, v, logw)
    N = r.shape[1] // chunk
    rc = r.float().reshape(B, N, chunk, H, K)
    kc = k.float().reshape(B, N, chunk, H, K)
    vc = v.float().reshape(B, N, chunk, H, K)
    wc = logw.float().reshape(B, N, chunk, H, K)

    # intra-chunk: exact scan over chunk positions, every chunk at once
    S_loc = torch.zeros((B, N, H, K, K), dtype=f32, device=r.device)
    ys = []
    for t in range(chunk):
        rt, kt, vt, wt = rc[:, :, t], kc[:, :, t], vc[:, :, t], wc[:, :, t]
        # y_t = r_t . S_loc + (r_t . (u * k_t)) v_t
        y = torch.einsum("bnhk,bnhkv->bnhv", rt, S_loc)
        y = y + torch.einsum("bnhk,bnhk->bnh", rt, u * kt)[..., None] * vt
        S_loc = torch.exp(wt)[..., None] * S_loc \
            + kt[..., None] * vt[..., None, :]
        ys.append(y)
    y_intra = torch.stack(ys, 2)                               # (B,N,c,H,K)

    # inter-chunk: loop over chunks carrying the state. S_loc holds every
    # chunk's own final local state
    cum = torch.cumsum(wc, 2)                                  # inclusive
    cum_excl = cum - wc                                        # exclusive
    decay_all = torch.exp(cum[:, :, -1])                       # (B,N,H,K)
    r_dec = rc * torch.exp(cum_excl)                           # bounded <= 1
    state = state0.float()
    y_inter = []
    for n in range(N):
        y_inter.append(torch.einsum("bchk,bhkv->bchv", r_dec[:, n], state))
        state = decay_all[:, n][..., None] * state + S_loc[:, n]
    y_inter = torch.stack(y_inter, 1)                          # (B,N,c,H,K)

    y = (y_intra + y_inter).reshape(B, N * chunk, H, K)[:, :S]
    return y, state


def wkv6_step(r, k, v, logw, u, s):
    """The exact single-step WKV6 recurrence (decode). r, k, v, logw:
    (B,1,H,K); s: (B,H,K,K) f32. Returns y (B,1,H,K) f32 and the state."""
    rt, kt, vt = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    wt = logw[:, 0]
    y = torch.einsum("bhk,bhkv->bhv", rt, s) \
        + torch.einsum("bhk,bhk->bh", rt, u * kt)[..., None] * vt
    s = torch.exp(wt)[..., None] * s + kt[..., None] * vt[..., None, :]
    return y[:, None], s


def apply_rwkv6(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: dict | None, tp=None) -> tuple[torch.Tensor, dict]:
    """Sequence (prefill / extend chunk) or single-step (decode) RWKV6
    time-mix. state = {"s": (B,H,K,K) f32, "x_prev": (B,D)} or None
    (fresh). Under ``tp`` the heads are the rank's ``tp.heads`` (its
    state too) and the output projection is row-parallel."""
    B, S, D = x.shape
    heads = None if tp is None else tp.heads
    if state is None:
        state = init_rwkv6_state(cfg, B, x.device)
        if heads is not None:
            state["s"] = state["s"][:, heads[0]:heads[1]]
    if S == 1:
        shifted = state["x_prev"][:, None]
    else:
        shifted = torch.cat([state["x_prev"][:, None], x[:, :-1]], 1)
    r, k, v, logw, g = _rwkv6_inputs(p, cfg, x, shifted, heads,
                                     None if tp is None else tp.enter)
    u = p["bonus_u"].float()

    if S == 1:
        y, s = wkv6_step(r, k, v, logw, u, state["s"])
    else:
        # the canonical grid: absolute blocks of chunk_size (identity-
        # padded tail), so chunk-aligned extend splits run whole's ops
        chunk = min(cfg.ssm.chunk_size, S)
        y, s = wkv6_chunked(r, k, v, logw, u, state["s"], chunk)

    out = _rwkv6_finish(p, cfg, y.to(x.dtype), g, tp)
    return out, {"s": s, "x_prev": x[:, -1]}


def init_rwkv6_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    H, K = cfg.num_heads, cfg.head_dim
    return {"s": torch.zeros((batch, H, K, K), dtype=f32, device=device),
            "x_prev": torch.zeros((batch, cfg.d_model),
                                  dtype=torch_dtype(cfg.compute_dtype),
                                  device=device)}


def rwkv6_state_logical() -> dict:
    return {"s": ("batch", "heads", None, None), "x_prev": ("batch", None)}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------
def _m2_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = d_inner // cfg.ssm.head_dim
    return d_inner, heads, cfg.ssm.state_dim


def init_mamba2(b: ParamInit, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_inner, H, n = _m2_dims(cfg)
    conv_dim = d_inner + 2 * n
    e = embed_axis(cfg)
    return {
        "w_in": b.normal((D, d_inner + conv_dim + H), (e, "mlp")),
        "conv_w": b.normal((cfg.ssm.conv_width, conv_dim), (None, None),
                           scale=0.5),
        "conv_b": b.zeros((conv_dim,), (None,)),
        "a_log": b.zeros((H,), (None,)),
        "dt_bias": b.zeros((H,), (None,)),
        "d_skip": b.ones((H,), (None,)),
        "norm_scale": b.ones((d_inner,), (None,)),
        "w_out": b.normal((d_inner, D), ("mlp", e)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as `jax.nn.softplus` computes it (logaddexp(x, 0):
    max(x, 0) + log1p(exp(-|x|))), with no linear branch above a
    threshold as `F.softplus` has."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def ssd_chunked(xh, Bm, Cm, dt, a_log, state0, chunk: int):
    """Chunked SSD. xh: (B,S,H,P) head inputs; Bm, Cm: (B,S,n); dt:
    (B,S,H); state0: (B,H,P,n). Returns y (B,S,H,P) f32 and the state.
    S need not divide ``chunk``: the tail is identity-padded (dt = 0 ->
    decay 1, xh * dt = 0; see `_pad_to_grid`)."""
    B, S, H, P = xh.shape
    n = Bm.shape[-1]
    xh, Bm, Cm, dt = _pad_to_grid(S, chunk, xh, Bm, Cm, dt)
    N = xh.shape[1] // chunk
    loga = -torch.exp(a_log.float()) * dt.float()              # (B,S,H) < 0
    xc = (xh.float() * dt.float()[..., None]).reshape(B, N, chunk, H, P)
    bc = Bm.float().reshape(B, N, chunk, n)
    cc = Cm.float().reshape(B, N, chunk, n)
    lc = loga.reshape(B, N, chunk, H)

    S_loc = torch.zeros((B, N, H, P, n), dtype=f32, device=xh.device)
    ys = []
    for t in range(chunk):
        xt, bt, ct, lt = xc[:, :, t], bc[:, :, t], cc[:, :, t], lc[:, :, t]
        S_loc = torch.exp(lt)[..., None, None] * S_loc \
            + xt[..., None] * bt[:, :, None, None, :]
        ys.append(torch.einsum("bnhps,bns->bnhp", S_loc, ct))
    y_intra = torch.stack(ys, 2)                               # (B,N,c,H,P)

    cum = torch.cumsum(lc, 2)                                  # inclusive
    decay_all = torch.exp(cum[:, :, -1])                       # (B,N,H)
    state = state0.float()
    y_inter = []
    for i in range(N):
        # y_inter_t = exp(cum_t) * C_t . state (the state used inclusively)
        y_inter.append(torch.einsum(
            "bchs,bhps->bchp",
            torch.exp(cum[:, i])[..., None] * cc[:, i][:, :, None, :],
            state))
        state = decay_all[:, i][..., None, None] * state + S_loc[:, i]
    y_inter = torch.stack(y_inter, 1)

    y = (y_intra + y_inter).reshape(B, N * chunk, H, P)[:, :S]
    return y, state


def ssd_step(xh, Bm, Cm, dt, a_log, s):
    """The exact single-step SSD recurrence (decode). xh: (B,1,H,P); Bm,
    Cm: (B,1,n); dt: (B,1,H); s: (B,H,P,n) f32. Returns y (B,1,H,P) f32
    and the state (the new state is read inclusively)."""
    lt = -torch.exp(a_log.float()) * dt[:, 0]                  # (B,H)
    s = torch.exp(lt)[..., None, None] * s \
        + (xh[:, 0].float() * dt[:, 0][..., None])[..., None] \
        * Bm[:, 0].float()[:, None, None, :]
    y = torch.einsum("bhps,bs->bhp", s, Cm[:, 0].float())
    return y[:, None], s


def apply_mamba2(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: dict | None) -> tuple[torch.Tensor, dict]:
    """Mamba2 block. state = {"conv": (B,W-1,conv_dim), "ssm":
    (B,H,P,n) f32} or None (fresh)."""
    B, S, D = x.shape
    d_inner, H, n = _m2_dims(cfg)
    P = cfg.ssm.head_dim
    W = cfg.ssm.conv_width
    conv_dim = d_inner + 2 * n
    cd = torch_dtype(cfg.compute_dtype)
    if state is None:
        state = init_mamba2_state(cfg, B, x.device)

    proj = x @ p["w_in"].to(cd)
    z, xBC, dt_raw = proj.split([d_inner, conv_dim, H], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())       # (B,S,H)

    # causal depthwise conv over the carried history (len S + W - 1):
    # out[t] = sum_s w[s] * hist[t + s]
    hist = torch.cat([state["conv"].to(xBC.dtype), xBC], 1)
    new_conv = hist[:, -(W - 1):]
    conv_out = torch.zeros_like(xBC)
    for s in range(W):
        conv_out = conv_out + hist[:, s:s + S] * p["conv_w"][s].to(xBC.dtype)
    conv_out = F.silu(conv_out + p["conv_b"].to(xBC.dtype))

    xh, Bm, Cm = conv_out.split([d_inner, n, n], dim=-1)
    xh = xh.reshape(B, S, H, P)

    if S == 1:
        y, ssm_state = ssd_step(xh, Bm, Cm, dt, p["a_log"], state["ssm"])
    else:
        # the canonical grid (see apply_rwkv6)
        chunk = min(cfg.ssm.chunk_size, S)
        y, ssm_state = ssd_chunked(xh, Bm, Cm, dt, p["a_log"], state["ssm"],
                                   chunk)

    y = y + p["d_skip"].float()[:, None] * xh.float() * 1.0
    y = y.reshape(B, S, d_inner).to(cd)

    # gated RMSNorm (mamba2 style)
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
         * p["norm_scale"].float()).to(cd)
    out = y @ p["w_out"].to(cd)
    return out, {"conv": new_conv.to(state["conv"].dtype), "ssm": ssm_state}


def init_mamba2_state(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    d_inner, H, n = _m2_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_dim),
                            dtype=torch_dtype(cfg.compute_dtype),
                            device=device),
        "ssm": torch.zeros((batch, H, cfg.ssm.head_dim, n), dtype=f32,
                           device=device),
    }


def mamba2_state_logical() -> dict:
    return {"conv": ("batch", None, "mlp"),
            "ssm": ("batch", "mlp", None, None)}
