"""PyTorch port: each ported kernel's plain twin against the reference
Pallas kernel (interpret mode on the CPU), and the extend path routed
through `attn_stream`.

Tolerance 2e-5 (f32), as `tests/test_kernels.py`: both sides compute in
f32 in other orders. The CUDA kernels themselves run only on a card:
`test_cuda_kernels_match_plain_twins` is marked ``cuda`` and skips
without one (`python3 chip_smoke.py` holds them at full size).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as RF
from repro.core import kv_tiers as RKT
from repro.kernels import attn_stream as RAS
from repro.kernels import ffn_act as RFF
from repro.kernels import fused_norm as RFN
from repro.kernels import paged_decode as RPD
from repro.kernels import ref as RREF
from repro_torch import kernels
from repro_torch.core import fusion as F
from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import attn_stream as AS
from repro_torch.kernels import ffn_act as FF
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import paged_decode as PD
from test_torch_config import build_pair

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(kw or TOL))


# ---------------------------------------------------------------------------
# fused_norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_fused_norm_twin_matches_pallas(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((16, 96)) * 2 + 0.3).astype(np.float32)
    s = rng.standard_normal(96).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32) if kind == "layer" \
        else None
    want = RFN.fused_norm(jnp.asarray(x), jnp.asarray(s),
                          None if b is None else jnp.asarray(b), kind,
                          interpret=True)
    _close(FN.fused_norm(_t(x), _t(s), None if b is None else _t(b), kind),
           want)


def test_fused_norm_twin_ragged_rows():
    """The port masks ragged M where the reference asserts divisibility:
    hold the odd row count against the reference's jnp oracle."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 40)).astype(np.float32)
    s, b = (rng.standard_normal(40).astype(np.float32) for _ in range(2))
    _close(FN.fused_norm(_t(x), _t(s), _t(b), "layer"),
           RREF.fused_norm_ref(jnp.asarray(x), jnp.asarray(s),
                               jnp.asarray(b), "layer"))


# ---------------------------------------------------------------------------
# attn_stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,Hkv,S,L,D,causal", [
    (1, 2, 2, 64, 64, 16, True),      # G = 1
    (2, 4, 2, 40, 72, 16, True),      # G = 2, causal S < L, ragged
    (1, 6, 1, 33, 33, 32, False),     # G = 6, ragged, non-causal
    (1, 12, 2, 20, 50, 16, True),     # G = 6, the fastvlm grouping
])
def test_attn_stream_twin_matches_pallas(B, H, Hkv, S, L, D, causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    want = RAS.attn_stream(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, block_q=16, block_k=16,
                           interpret=True)
    _close(AS.attn_stream(_t(q), _t(k), _t(v), causal=causal), want)


def test_attn_stream_causal_s_greater_than_l_raises():
    q = torch.zeros(1, 2, 9, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="S <= L"):
        AS.attn_stream(q, k, k, causal=True)


def test_attn_stream_out_argument_receives_strided_result():
    """ops.attn_stream hands the kernel transposed views and a strided
    output; the plain path honours the same contract."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((2, 9, 6, 16)).astype(np.float32))
    k = _t(rng.standard_normal((2, 12, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((2, 12, 2, 16)).astype(np.float32))
    got = ops.attn_stream(q, k, v, causal=True)
    want = AS.attn_stream_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# ffn_act
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["silu_gated", "gelu", "gelu_gated",
                                  "relu2"])
def test_ffn_act_twin_matches_pallas(kind):
    rng = np.random.default_rng(4)
    M, D, Fd = 8, 32, 64
    x = rng.standard_normal((M, D)).astype(np.float32)
    wu = (rng.standard_normal((D, Fd)) / 6).astype(np.float32)
    wg = (rng.standard_normal((D, Fd)) / 6).astype(np.float32) \
        if kind.endswith("gated") else None
    wd = (rng.standard_normal((Fd, D)) / 8).astype(np.float32)
    want = RFF.ffn_act(jnp.asarray(x), jnp.asarray(wu),
                       None if wg is None else jnp.asarray(wg),
                       jnp.asarray(wd), kind, interpret=True)
    _close(FF.ffn_act(_t(x), _t(wu), None if wg is None else _t(wg), _t(wd),
                      kind), want)


@pytest.mark.parametrize("M,F_,sms", [(4, 8960, 132), (320, 8960, 132),
                                      (5, 1000, 132), (1, 40, 8)])
def test_ffn_act_chunking_covers_f(M, F_, sms):
    """The F split of the CUDA kernel covers [0, F) exactly once in whole
    32-unit steps and aims at a few blocks per SM."""
    per, n = FF.f_chunking(M, F_, sms)
    assert per % FF.BF == 0 and (n - 1) * per < F_ <= n * per
    n_mt = -(-M // FF.row_tile(M))
    assert n_mt * n <= max(FF.BLOCKS_PER_SM * sms, n_mt)


# ---------------------------------------------------------------------------
# paged_decode_tiered
# ---------------------------------------------------------------------------
def _stores(rng, B, max_len, Hkv, D, W, lengths, cold_scale=1.0):
    """Per-slot tiered stores from the reference's prefill writer."""
    def build(full):
        parts = [RKT.tiered_from_full(jnp.asarray(full[b:b + 1]), W,
                                      lengths[b] + 1, max_len)
                 for b in range(B)]
        return jax.tree.map(lambda *xs: np.concatenate(xs, 0), *parts)
    kf = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    kf[:, :max(lengths) - W] *= cold_scale
    return build(kf), build(vf)


@pytest.mark.parametrize("G", [1, 2, 6])
@pytest.mark.parametrize("tau", [0.0, 1e-3])
@pytest.mark.parametrize("dead", [False, True])
def test_paged_decode_twin_matches_pallas(G, tau, dead):
    """Ragged per-slot lengths; dead table entries; the sparse read with
    a cold tier small enough that tau = 1e-3 really skips pages."""
    rng = np.random.default_rng(5)
    B, max_len, Hkv, D, W, bk = 4, 64, 2, 16, 8, 16
    lengths = [63, 40, 9, 4]
    ks, vs = _stores(rng, B, max_len, Hkv, D, W, lengths,
                     cold_scale=0.02 if tau else 1.0)
    q = (rng.standard_normal((B, Hkv, G, D)) * 2).astype(np.float32)
    if tau:       # hot keys aligned with q: the running max dominates
        ks["hot"] = np.repeat(q.mean(2)[:, None], W, 1) * 2
    table = np.stack([np.asarray(RKT.cold_page_table(lengths[b], W, max_len,
                                                     bk)) for b in range(B)])
    if dead:
        table[0, 1] = table[1, 0] = -1
    args = [q, ks["hot"], vs["hot"], ks["cold_q"], ks["cold_scale"],
            vs["cold_q"], vs["cold_scale"],
            np.asarray(lengths, np.int32), table.astype(np.int32)]
    want = RPD.paged_decode_tiered(*map(jnp.asarray, args), scale=D ** -0.5,
                                   block_k=bk, tau=tau, interpret=True)
    got = PD.paged_decode_tiered(*map(_t, args), scale=D ** -0.5,
                                 block_k=bk, tau=tau)
    _close(got, want)
    if tau:       # the skip rule fired: the exact read differs
        exact = PD.paged_decode_tiered(*map(_t, args), block_k=bk)
        assert not torch.allclose(exact, got, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# wrappers on the CPU: plain twin, no launch counted
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_twin_and_count_nothing():
    kernels.reset_launch_counts()
    x = torch.randn(3, 32)
    FN.fused_norm(x, torch.ones(32), None)
    FF.ffn_act(x, torch.randn(32, 64), None, torch.randn(64, 32), "gelu")
    q = torch.randn(1, 2, 5, 16)
    AS.attn_stream(q, q, q)
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}


# ---------------------------------------------------------------------------
# extend routed through attn_stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite-3-2b", "fastvlm-small"])
def test_extend_via_attn_stream_matches_reference(arch):
    """Three chunks over the workspace, the last one padded (valid rows
    < chunk width) and committing: outputs and workspaces within 2e-5 of
    the reference's `apply_attention_extend`, committed stores within
    one int8 step (their inputs differ by f32 rounding)."""
    rc, _, rparams, pc, _, params = build_pair(arch)
    # layer 0 of the stacked two-layer unit
    rp = jax.tree.map(lambda a: a[0], rparams["units"]["u0"]["mixer"])
    pp = {k: v[0] for k, v in params["units"]["u0"]["mixer"].items()}
    rng = np.random.default_rng(6)
    max_len, Hkv, Dh = 24, pc.num_kv_heads, pc.head_dim
    ws = {"k_ws": np.zeros((1, max_len, Hkv, Dh), np.float32),
          "v_ws": np.zeros((1, max_len, Hkv, Dh), np.float32)}
    rcache = jax.tree.map(jnp.asarray, ws)
    pcache = {k: _t(v) for k, v in ws.items()}
    pos = 0
    for C, valid, commit in [(6, 6, False), (5, 5, False), (6, 3, True)]:
        x = rng.standard_normal((1, C, pc.d_model)).astype(np.float32)
        positions = (pos + np.arange(C, dtype=np.int32))[None]
        rout, rcache = RF.apply_attention_extend(
            rp, rc, jnp.asarray(x), jnp.asarray(positions), rcache, pos,
            valid, None, commit)
        pout, pcache = F.apply_attention_extend(
            pp, pc, _t(x), _t(positions), pcache, pos, valid, commit)
        _close(pout[:, :valid], np.asarray(rout)[:, :valid])
        pos += valid
        if not commit:
            for k in ("k_ws", "v_ws"):
                _close(pcache[k], rcache[k])
    for kv in ("k", "v"):
        r, p = rcache[kv], pcache[kv]
        _close(p["hot"], r["hot"])
        _close(p["cold_scale"], r["cold_scale"])
        assert np.abs(p["cold_q"].numpy().astype(int)
                      - np.asarray(r["cold_q"]).astype(int)).max() <= 1
        np.testing.assert_array_equal(p["writes"].numpy(),
                                      np.asarray(r["writes"]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_kernels_match_plain_twins():
    """Each CUDA kernel against its plain twin at small shapes (f32,
    1e-4). Runs only where a card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g, device=dev)
    x, s = r(5, 96), r(96)
    torch.testing.assert_close(FN.fused_norm(x, s, None),
                               FN.fused_norm_plain(x, s, None),
                               atol=1e-4, rtol=0)
    wu, wg, wd = r(96, 200) / 10, r(96, 200) / 10, r(200, 96) / 14
    torch.testing.assert_close(FF.ffn_act(x, wu, wg, wd, "silu_gated"),
                               FF.ffn_act_plain(x, wu, wg, wd, "silu_gated"),
                               atol=1e-4, rtol=0)
    q, k = r(1, 6, 20, 64), r(1, 2, 30, 64)
    torch.testing.assert_close(AS.attn_stream(q, k, k),
                               AS.attn_stream_plain(q, k, k),
                               atol=1e-4, rtol=0)
    lengths = torch.tensor([40, 7], dtype=torch.int32, device=dev)
    qd, hot = r(2, 2, 3, 64), r(2, 8, 2, 64)
    cq = torch.randint(-127, 128, (2, 48, 2, 64), generator=g, device=dev,
                       dtype=torch.int8)
    cs = torch.rand(2, 48, 2, 1, generator=g, device=dev) / 100
    args = (qd, hot, hot, cq, cs, cq, cs, lengths,
            KT.cold_page_table(lengths, 8, 48, 16))
    torch.testing.assert_close(PD.paged_decode_tiered(*args, block_k=16),
                               PD.paged_decode_tiered_plain(*args,
                                                            block_k=16),
                               atol=1e-4, rtol=0)
