"""PyTorch port: each ported kernel's plain twin against the reference
Pallas kernel (interpret mode on the CPU), and the extend path routed
through `attn_stream`.

Tolerance 2e-5 (f32), as `tests/test_kernels.py`: both sides compute in
f32 in other orders; 1e-5 for the `qkv_proj`, `ffn_act_int8` and
`paged_decode_flat` twins, whose sums are short. The CUDA kernels
themselves run only on a card:
`test_cuda_kernels_match_plain_twins` is marked ``cuda`` and skips
without one (`python3 chip_smoke.py` holds them at full size).
"""

from __future__ import annotations

import importlib.util
import math
import pathlib

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
from repro.kernels import ops as ROPS
from repro.kernels import paged_decode as RPD
from repro.kernels import qkv_proj as RQK
from repro.kernels import ref as RREF
from repro.models import attention as RA
from repro.models import layers as RL
from repro_torch import kernels
from repro_torch.core import fusion as F
from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import attn_stream as AS
from repro_torch.kernels import ffn_act as FF
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import qkv_proj as QK
from repro_torch.models import attention as A
from test_torch_config import F32, _configs, build_pair

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-5, atol=2e-5)
TOL2 = dict(rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("D,pitch,dtype,offset,want", [
    (1536, 1536, torch.bfloat16, 0, "vector"),    # fastvlm-1.7b
    (2560, 2560, torch.bfloat16, 0, "vector"),    # mobilevlm-3b
    (1000, 1000, torch.bfloat16, 0, "vector"),    # 125 vectors: ragged warp
    (1001, 1001, torch.bfloat16, 0, "scalar"),    # D not whole vectors
    (1536, 1540, torch.bfloat16, 0, "scalar"),    # pitch not whole vectors
    (1536, 1544, torch.bfloat16, 0, "vector"),    # strided, pitch whole
    (1536, 1544, torch.bfloat16, 1, "scalar"),    # base 2 bytes off
    (200, 200, torch.float32, 0, "vector"),
    (202, 202, torch.float32, 0, "scalar")])
def test_fused_norm_variant_by_d_and_alignment(D, pitch, dtype, offset, want):
    """The wrapper's choice between the 16-byte vector kernel and the
    scalar one, from D, the row pitch and the base addresses of real
    (strided, offset) views."""
    big = torch.zeros(3, pitch + offset, dtype=dtype)
    x = big[:, offset:offset + D]
    sc = torch.ones(D, dtype=torch.float32)
    got = FN.variant(D, x.stride(0), x.element_size(),
                     x.data_ptr() | sc.data_ptr())
    assert got == want
    # a scale 16-byte aligned in no view of it forces the scalar kernel
    if want == "vector":
        sc_off = torch.ones(D + 1, dtype=torch.float32)[1:]
        assert FN.variant(D, x.stride(0), x.element_size(),
                          x.data_ptr() | sc_off.data_ptr()) == "scalar"


@pytest.mark.parametrize("units,tpr", [
    (192, 192),      # fastvlm-1.7b bf16: 1536 / 8
    (320, 320),      # mobilevlm-3b bf16: 2560 / 8
    (125, 128),      # D 1000 bf16
    (1001, 1024),    # D 1001, scalar
    (50, 64),        # D 200 f32
    (12, 32),        # D 96 bf16
    (4096, 1024)])   # D 32768 bf16: four vectors a thread
def test_fused_norm_threads_per_row(units, tpr):
    """About one 16-byte vector a thread in whole warps, at most 1024
    threads a row; past that a thread loops over at most MAX_UNITS."""
    assert FN.threads_per_row(units) == tpr
    assert tpr % 32 == 0 and -(-units // tpr) <= FN.MAX_UNITS


# ---------------------------------------------------------------------------
# attn_stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,Hkv,S,L,D,causal", [
    (1, 2, 2, 64, 64, 16, True),      # G = 1
    (2, 4, 2, 40, 72, 16, True),      # G = 2, causal S < L, ragged
    (1, 6, 1, 33, 33, 32, False),     # G = 6, ragged, non-causal
    (1, 12, 2, 20, 50, 16, True),     # G = 6, the fastvlm grouping
    (1, 8, 2, 20, 36, 160, True),     # stablelm-12b's head dim, G = 4
    (1, 8, 1, 20, 36, 256, True),     # paligemma-3b's head dim, MQA
    (1, 9, 1, 20, 36, 128, True),     # G = 9, starcoder2-7b's grouping
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
    """The F split of the fma form covers [0, F) exactly once in whole
    32-unit steps and aims at a few blocks per SM (one column band at
    mobilevlm-3b's d_model)."""
    D = 2560
    per, n = FF.f_chunking(M, F_, sms, D)
    assert per % FF.BF == 0 and (n - 1) * per < F_ <= n * per
    n_mt = -(-M // FF.FMA_ROWS) * -(-D // FF.FMA_BAND)
    assert n_mt * n <= max(FF.BLOCKS_PER_SM * sms, n_mt)


@pytest.mark.parametrize("F_,sms", [(8960, 132), (6912, 132), (1000, 132),
                                    (40, 8), (1024, 132), (128, 132),
                                    (70000, 132)])
def test_ffn_stream_plan_covers_f(F_, sms):
    """The stream form's blocks cover every hidden unit once: each slice
    split over D among ds blocks of one cluster, each with whole 16-row
    W_down steps, within two blocks an SM unless one block a slice is
    already more, the grid padded by less than one cluster of at most 8
    blocks."""
    ds, cl, nb = FF.stream_plan(F_, sms)
    fs = FF.STREAM_SLICE
    assert 1 <= cl <= FF.STREAM_MAX_SPLIT and nb % cl == 0
    assert cl % ds == 0 and fs % (16 * ds) == 0
    n = -(-F_ // fs)
    assert n * ds <= nb < (n + cl // ds) * ds
    assert n * ds <= 2 * sms or ds == 1
    units = np.zeros(nb // ds * fs, int)
    for sl in range(nb // ds):
        for r in range(ds):            # block r's W_down rows of the slice
            lo = sl * fs + r * (fs // ds)
            units[lo:lo + fs // ds] += 1
    assert (units == 1).all()


@pytest.mark.parametrize("M,D,F_,sms", [(256, 2560, 6912, 132),
                                        (320, 1536, 8960, 132),
                                        (65, 320, 1000, 132),
                                        (257, 320, 1024, 132),
                                        (9, 2560, 6912, 132),
                                        (4096, 2560, 6912, 132)])
def test_ffn_wgmma_plan_covers_f(M, D, F_, sms):
    """The wgmma form's phase-2 F split: chunks of whole 64-deep tiles
    covering [0, F) once, a cluster of at most 8 blocks, and no split
    where the tiles alone fill the card; 128-row tiles above 64 rows."""
    wgs, ks, kc = FF.wgmma_plan(M, D, F_, sms)
    assert wgs == (2 if M > 64 else 1)
    assert kc % FF.WGMMA_BK == 0 and (ks - 1) * kc < F_ <= ks * kc
    assert 1 <= ks <= FF.STREAM_MAX_SPLIT
    tiles = -(-M // (64 * wgs)) * -(-D // FF.WGMMA_BN)
    assert ks == 1 or tiles < sms


@pytest.mark.parametrize("M,dtype,aligned,want", [
    (1, torch.bfloat16, True, "stream"), (4, torch.float32, True, "fma"),
    (8, torch.bfloat16, True, "stream"), (9, torch.bfloat16, True, "wgmma"),
    (256, torch.bfloat16, True, "wgmma"), (9, torch.float32, True, "fma"),
    (320, torch.float32, True, "fma"), (4, torch.bfloat16, False, "fma"),
    (256, torch.bfloat16, False, "fma")])
def test_ffn_kernel_variant(M, dtype, aligned, want):
    assert FF.kernel_variant(M, dtype, aligned) == want


def test_ffn_kernel_variant_rejects_other_dtypes():
    with pytest.raises(TypeError):
        FF.kernel_variant(4, torch.float16)


def test_ffn_plan_follows_a_swapped_planner():
    """kernel_sweep.py times each plan by swapping a planner of the
    module; the wrapper's cached `_plan` must then launch that plan, and
    the planned one again once the planner is restored."""
    spec = importlib.util.spec_from_file_location(
        "kernel_sweep", pathlib.Path(__file__).parents[1] / "kernel_sweep.py")
    kernel_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernel_sweep)
    key = (4, 1536, 8960, True, 3, True, 0)
    sms = FF.build.sm_count
    FF.build.sm_count = lambda dev: 132
    try:
        FF._plan.cache_clear()
        planned = FF._plan(*key)[2]
        assert planned == FF.stream_plan(8960, 132)
        with kernel_sweep.swapped(FF, "stream_plan", lambda *a: (1, 4, 280)):
            assert FF._plan(*key)[2] == (1, 4, 280)
        assert FF._plan(*key)[2] == planned
        key = (256, 2560, 6912, True, 3, True, 0)
        with kernel_sweep.swapped(FF, "wgmma_plan", lambda *a: (1, 3, 2304)):
            assert FF._plan(*key)[2] == (1, 3, 2304)
        assert FF._plan(*key)[2] == FF.wgmma_plan(256, 2560, 6912, 132)
    finally:
        FF.build.sm_count = sms
        FF._plan.cache_clear()


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("D", [320, 1536, 2560, 3072])
@pytest.mark.parametrize("ds", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_ffn_stream_mma_smem_fits_hopper(M, D, ds, int8):
    """The stream kernel's shared memory fits one block, two an SM (its
    launch bounds) at decode's 4 rows up to D 2560; its x rows hold every
    k-step's reach (the block's D rows rounded up to 16) and its bf16
    ring stage 16 KB of rows."""
    b = FF.stream_smem_bytes(M, D, ds, int8)
    assert b <= FF.SMEM_LIMIT and b % 16 == 0
    if M <= 4 and D <= 2560:
        assert 2 * (b + 1024) <= 228 * 1024
    fs = FF.STREAM_SLICE
    rows = FF.STREAM_STAGE_BYTES // (2 * (2 * fs + 16)) // 16 * 16
    assert rows * 2 * fs * 2 >= 14 * 1024 and rows % 16 == 0
    dch = -(-(-(-D // ds)) // 16) * 16
    assert b >= 16 * (dch + 8) + FF.STREAM_STAGES * (
        FF.STREAM_INT8_STAGE_BYTES if int8 else FF.STREAM_STAGE_BYTES)


@pytest.mark.parametrize("w_es", [1, 2])
@pytest.mark.parametrize("phase,wgs", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_ffn_wgmma_smem_fits_hopper(w_es, phase, wgs):
    """Each GEMM phase's ring (at least 3 stages: loads run 1+ tiles
    ahead) and, for int8, its two widened buffers fit one block; phase
    2's f32 partial of the cluster merge fits over its ring."""
    stages, b = FF.wgmma_stages(w_es, 64 * wgs, 2 if phase == 1 else 1)
    assert stages >= 3 and b == FF.wgmma_smem_bytes(phase, w_es, wgs)
    assert b <= FF.SMEM_LIMIT
    if phase == 2:
        bn = FF.WGMMA_BN
        xb, wb = 2 * 64 * wgs * FF.WGMMA_BK, 2 * FF.WGMMA_BK * bn
        stage = xb + (FF.WGMMA_BK * bn if w_es == 1 else wb)
        assert 4 * 64 * wgs * bn <= stages * stage


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


@pytest.mark.parametrize("G,tau,dead,D", [
    pytest.param(G, tau, dead, 16, id=f"{dead}-{tau}-{G}")
    for dead in (False, True) for tau in (0.0, 1e-3) for G in (1, 2, 6)] + [
    pytest.param(G, 0.0, True, D, id=f"D{D}-G{G}")
    for D, G in ((160, 4), (160, 9), (256, 8))])
def test_paged_decode_twin_matches_pallas(G, tau, dead, D):
    """Ragged per-slot lengths; dead table entries; the sparse read with
    a cold tier small enough that tau = 1e-3 really skips pages; the
    dense archs' head dims 160 (G 4, and 9: 16 score rows on the card)
    and 256 (G 8)."""
    rng = np.random.default_rng(5)
    B, max_len, Hkv, W, bk = 4, 64, 2, 8, 16
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
# paged_decode_flat
# ---------------------------------------------------------------------------
def _flat_case(rng, B, max_len, Hkv, G, D):
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("G,dead,D", [
    pytest.param(G, dead, 16, id=f"{dead}-{G}")
    for dead in (False, True) for G in (1, 2, 4)] + [
    pytest.param(G, True, D, id=f"D{D}-G{G}")
    for D, G in ((128, 9), (160, 4), (256, 8))])
def test_paged_decode_flat_twin_matches_pallas(G, dead, D):
    """Ragged per-slot lengths, max_len 200 (not a multiple of the 128
    page: the port masks the tail page the reference pads), and dead
    table entries, against the reference kernel in interpret mode; also
    at starcoder2-7b's G 9 and the dense archs' head dims 160 and 256."""
    rng = np.random.default_rng(7)
    B, max_len, Hkv, bk = 4, 200, 2, 128
    q, k, v = _flat_case(rng, B, max_len, Hkv, G, D)
    lengths = np.asarray([199, 150, 127, 3], np.int32)
    table = np.asarray(RKT.cold_page_table(jnp.asarray(lengths)[:, None], 0,
                                           max_len, bk)).astype(np.int32)
    if dead:
        table[0, 0] = table[1, 1] = -1
    args = [q, k, v, lengths, table]
    want = RPD.paged_decode_flat(*map(jnp.asarray, args), scale=D ** -0.5,
                                 block_k=bk, interpret=True)
    got = PD.paged_decode_flat(*map(_t, args), scale=D ** -0.5, block_k=bk)
    _close(got, want, **TOL2)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_paged_decode_flat_adapter_matches_reference_per_slot(G):
    """The model-layout adapter with ragged per-slot positions against one
    reference call per slot: `ops.paged_decode_flat` (interpret mode) and
    `attention.attend_flat`; the port's `attend_flat` equals both."""
    rng = np.random.default_rng(8)
    B, max_len, Hkv, D = 3, 40, 2, 16
    H = Hkv * G
    qm = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    pos = [39, 17, 0]
    got = ops.paged_decode_flat(_t(qm), {"flat": _t(k)}, {"flat": _t(v)},
                                torch.tensor(pos))
    plain = A.attend_flat(None, _t(qm), {"k": _t(k), "v": _t(v)},
                          torch.tensor(pos))
    for b in range(B):
        sl = slice(b, b + 1)
        want = ROPS.paged_decode_flat(
            None, jnp.asarray(qm[sl]), {"flat": jnp.asarray(k[sl])},
            {"flat": jnp.asarray(v[sl])}, pos[b])
        oracle = RA.attend_flat(None, jnp.asarray(qm[sl]),
                                {"k": jnp.asarray(k[sl]),
                                 "v": jnp.asarray(v[sl])}, pos[b])
        _close(got[sl], want, **TOL2)
        _close(got[sl], oracle, **TOL2)
        _close(plain[sl], oracle, **TOL2)


def _empty_state(Hkv, G, D):
    """The partial of a warp or rank with no attendable key."""
    return (torch.full((1, Hkv, G, 1), PD.NEG_INF), torch.zeros(1, Hkv, G, 1),
            torch.zeros(1, Hkv, G, D))


def _combine(parts):
    """Flash partials (m, d, acc) combined as the split kernels combine a
    block's warps and then a cluster's blocks: each weighted by exp(m -
    the parts' max), summed in order. An empty part weighs 0 beside a
    live one."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    ws = [torch.exp(p[0] - m) for p in parts]
    return (m, sum(w * p[1] for w, p in zip(ws, parts)),
            sum(w * p[2] for w, p in zip(ws, parts)))


def _live_keys(pos, table_row, block_k, max_len):
    """Logical positions the flat kernel must attend for one slot."""
    return {j * block_k + i for j, phys in enumerate(table_row)
            if phys >= 0 for i in range(block_k)
            if j * block_k + i <= pos and phys * block_k + i < max_len}


def _flat_partition(pos, n_pages, block_k, tile_keys, split):
    """The flat kernel's assignment of one slot's live key tiles, in its
    own arithmetic (csrc/paged_decode.cu, the FL_ section): tiles of
    ``tile_keys`` keys, ceil(block_k / tile_keys) to a page, live up to
    the one holding position ``pos``; rank r of the cluster takes a
    contiguous run, its warp w every FLAT_WARPS-th tile of the run from
    the w-th. -> [rank][warp] lists of (page, first key in the page,
    keys) triples."""
    tpp = -(-block_k // tile_keys)
    n_live = 0 if pos < 0 else min(
        n_pages * tpp,
        (pos // block_k) * tpp + (pos % block_k) // tile_keys + 1)
    per = -(-n_live // split)
    out = []
    for r in range(split):
        jb = min(n_live, r * per)
        je = min(n_live, jb + per)
        out.append([[(t // tpp, (t % tpp) * tile_keys,
                      min(tile_keys, block_k - (t % tpp) * tile_keys))
                     for t in range(jb + w, je, PD.FLAT_WARPS)]
                    for w in range(PD.FLAT_WARPS)])
    return out


def _partition_keys(part, pos, table_row, block_k, max_len):
    """Attendable logical keys of each (rank, warp) of a partition."""
    return [[[j * block_k + c0 + i for (j, c0, n) in tiles for i in range(n)
              if table_row[j] >= 0 and j * block_k + c0 + i <= pos
              and table_row[j] * block_k + c0 + i < max_len]
             for tiles in ranks] for ranks in part]


@pytest.mark.parametrize("B,Hkv,max_len,block_k", [
    (4, 20, 512, 128),     # mobilevlm-3b path A
    (4, 2, 512, 128),      # fastvlm-1.7b heads on a flat store
    (4, 20, 500, 128),     # ragged tail page
    (8, 20, 512, 128),     # B * Hkv >= 132: no split
    (2, 2, 200, 16),       # small pages
    (3, 1, 40, 8),         # pages smaller than a tile
    (1, 1, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_flat_split_covers_live_keys_once(B, Hkv, max_len,
                                                       block_k, dtype):
    """The flat kernel's split, in its own arithmetic (`_flat_partition`):
    across the cluster's ranks and their warps every attendable key of a
    slot is read exactly once, for lengths at position 0, at page edges,
    at the end of the store, and with dead pages (the last live one
    included). The split comes from shapes and the SM count only, stays
    within a portable cluster, is 1 where B * Hkv fills the card and fills
    it at mobilevlm-3b's decode shape."""
    split = PD.flat_split(B, Hkv, 132)
    assert 1 <= split <= PD.FLAT_MAX_SPLIT
    if B * Hkv >= 132:
        assert split == 1
    if (B, Hkv, max_len) == (4, 20, 512):
        assert B * Hkv * split >= 132
    n_pages = -(-max_len // block_k)
    for D in PD.HEAD_DIMS:
        tk = PD.flat_tile_keys(D, dtype)
        for pos in sorted({0, 1, block_k - 1, block_k, max_len // 2,
                           max_len - 2, max_len - 1}):
            last = pos // block_k
            for dead in ((), (last,), (0, last), (max(last - 1, 0),)):
                table_row = [j if j * block_k <= pos and j not in dead
                             else -1 for j in range(n_pages)]
                for s_ in sorted({1, split, PD.FLAT_MAX_SPLIT}):
                    part = _flat_partition(pos, n_pages, block_k, tk, s_)
                    assert len(part) == s_
                    assert all(len(w) == PD.FLAT_WARPS for w in part)
                    assert all(c0 + n <= block_k for r in part for w in r
                               for (_, c0, n) in w)
                    got = [k for r in _partition_keys(
                        part, pos, table_row, block_k, max_len)
                        for w in r for k in w]
                    assert sorted(got) == sorted(_live_keys(
                        pos, table_row, block_k, max_len))
                    assert len(got) == len(set(got))


@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("block_k", [128, 16])
def test_paged_decode_flat_rank_order_merge_matches_plain(G, block_k):
    """A plain-PyTorch model of the split kernel: per-(rank, warp)
    partials over `_flat_partition`'s keys (an empty warp or rank gives m
    = NEG_INF, d = 0), each rank's warps combined at their common max,
    then the ranks (`_combine`), as the kernel merges them, equals
    `paged_decode_flat_plain` within 1e-6 in f32 at every split, with
    lengths at 0 and page edges, a ragged tail page and dead pages."""
    rng = np.random.default_rng(12)
    B, max_len, Hkv, D = 4, 200, 2, 16
    q, k, v = map(_t, _flat_case(rng, B, max_len, Hkv, G, D))
    lengths = torch.tensor([0, block_k, 199, 150], dtype=torch.int32)
    table = KT.cold_page_table(lengths, 0, max_len, block_k).clone()
    table[2, 1] = -1
    table[3, -1] = -1
    want = PD.paged_decode_flat_plain(q, k, v, lengths, table,
                                      block_k=block_k)
    tk = PD.flat_tile_keys(D, torch.float32)
    n_pages = table.shape[1]
    qf, scale = q.float(), D ** -0.5
    for split in range(1, PD.FLAT_MAX_SPLIT + 1):
        got = torch.empty_like(want)
        for b in range(B):
            pos, row = int(lengths[b]), table[b].tolist()
            blocks = []
            for ranks in _partition_keys(
                    _flat_partition(pos, n_pages, block_k, tk, split),
                    pos, row, block_k, max_len):
                warps = []
                for keys in ranks:
                    if not keys:        # an empty warp: (NEG_INF, 0, 0)
                        warps.append(_empty_state(Hkv, G, D))
                        continue
                    rows = torch.tensor([row[t // block_k] * block_k
                                         + t % block_k for t in keys])
                    warps.append(PD._segment(
                        qf[b:b + 1], k[b:b + 1, rows], v[b:b + 1, rows],
                        torch.ones(1, len(keys), dtype=bool), scale))
                blocks.append(_combine(warps))
            m, d, acc = _combine(blocks)
            got[b] = (acc / d.clamp_min(1e-30))[0]
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("head_dim", PD.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_flat_tiles_fit_shared_memory(head_dim, dtype):
    """The flat kernel's tiles (the Python mirror of the .cu constants,
    which chip_smoke holds against the built library): a row's 16-byte
    chunks over a power of two lanes (a warp's 32 at most; the lanes past
    Dh 160's 20 chunks hold zeros, and past 32 chunks a lane holds two),
    a tile's K and V rows (padding lanes included) filling one ring stage,
    four chunks a lane; the warps' partials (m, d and G x D accumulators,
    G up to `max_group`) fit their rings; at mobilevlm-3b's 4 pages four
    blocks share an SM."""
    es = torch.tensor([], dtype=dtype).element_size()
    tk = PD.flat_tile_keys(head_dim, dtype)
    chunks = head_dim * es // 16
    lanes_a_key = PD.row_lanes(chunks)
    per_lane = -(-chunks // lanes_a_key)
    assert chunks <= lanes_a_key * per_lane and per_lane in (1, 2)
    assert lanes_a_key == 32 or lanes_a_key == chunks
    assert tk == 4 // per_lane * (32 // lanes_a_key)
    assert 2 * tk * lanes_a_key * per_lane * 16 == PD.FLAT_STAGE_BYTES
    ring = PD.FLAT_STAGES * PD.FLAT_STAGE_BYTES
    gmax = PD.max_group(head_dim)
    assert gmax == (PD.MAX_GROUP if head_dim <= 160 else 8)
    assert 4 * (2 * gmax + gmax * head_dim) <= ring
    assert PD.flat_smem_bytes(4) == PD.FLAT_WARPS * ring + 16
    assert 4 * PD.flat_smem_bytes(4) <= PD.SMEM_LIMIT
    assert PD.flat_smem_bytes(-(-32768 // 16)) <= PD.SMEM_LIMIT


# ---------------------------------------------------------------------------
# paged_decode_tiered: the split-K kernel's partition, merge and sparse walk
# ---------------------------------------------------------------------------
def _tiered_lists(pos, W, n_pages, block_k, tile_keys):
    """(n_hot, n_cold, tiles a page) of one slot's tile list in the tiered
    kernel's own arithmetic (csrc/paged_decode.cu, the tiered section):
    hot tiles of ``tile_keys`` ring slots up to the one holding slot
    min(pos, W - 1), then cold tiles, ceil(block_k / tile_keys) to a page,
    up to the one holding position pos - W."""
    last = pos - W
    n_hot = 0 if pos < 0 else min(-(-W // tile_keys), pos // tile_keys + 1)
    tpp = -(-block_k // tile_keys)
    n_cold = 0 if last < 0 else min(
        n_pages * tpp, (last // block_k) * tpp + (last % block_k) // tile_keys
        + 1)
    return n_hot, n_cold, tpp


def _tiered_tile(t, n_hot, tpp, tile_keys):
    """Tile t of the list: ("hot", first slot) or ("cold", page, first
    key in the page)."""
    if t < n_hot:
        return ("hot", t * tile_keys)
    u = t - n_hot
    return ("cold", u // tpp, (u % tpp) * tile_keys)


def _tiered_partition(pos, W, n_pages, block_k, tile_keys, split):
    """The split kernel's assignment of one slot's tile list: rank r of the
    cluster takes a contiguous run, its warp w every FLAT_WARPS-th tile of
    the run from the w-th. -> [rank][warp] lists of tiles."""
    n_hot, n_cold, tpp = _tiered_lists(pos, W, n_pages, block_k, tile_keys)
    n = n_hot + n_cold
    per = -(-n // split)
    out = []
    for r in range(split):
        jb = min(n, r * per)
        je = min(n, jb + per)
        out.append([[_tiered_tile(t, n_hot, tpp, tile_keys)
                     for t in range(jb + w, je, PD.FLAT_WARPS)]
                    for w in range(PD.FLAT_WARPS)])
    return out


def _tiered_tile_keys(tile, pos, W, table_row, block_k, max_len, tile_keys):
    """The attendable keys of one tile, by the kernel's masks: ("hot",
    ring slot) for slot < W and slot <= pos; ("cold", logical position,
    physical row) for a live page, inside the page and the store, position
    <= pos - W."""
    if tile[0] == "hot":
        return [("hot", s, s) for s in range(tile[1], tile[1] + tile_keys)
                if s < W and s <= pos]
    _, j, c0 = tile
    phys = table_row[j]
    return [("cold", j * block_k + kk, phys * block_k + kk)
            for kk in range(c0, c0 + tile_keys)
            if phys >= 0 and kk < block_k and j * block_k + kk <= pos - W
            and phys * block_k + kk < max_len]


def _tiered_attendable(pos, W, table_row, block_k, max_len):
    """The keys the reference attends for one slot: ring slots whose
    position pos - ((pos - i) mod W) is >= 0, and cold positions <= pos -
    W on live pages inside the store."""
    hot = {("hot", i, i) for i in range(W) if pos - ((pos - i) % W) >= 0}
    cold = {("cold", j * block_k + i, phys * block_k + i)
            for j, phys in enumerate(table_row) if phys >= 0
            for i in range(block_k)
            if j * block_k + i <= pos - W and phys * block_k + i < max_len}
    return hot | cold


def test_paged_decode_tiered_split_planner():
    """`tiered_split` from shapes only: 8 at fastvlm-1.7b's decode (B 4,
    Hkv 2), 4 at mobilevlm-3b's (Hkv 20), 1 where B * Hkv fills the 132
    SMs, and 1 for the sparse read at every shape."""
    assert PD.tiered_split(4, 2, 132, False) == 8
    assert PD.tiered_split(4, 20, 132, False) == 4
    for (B, Hkv) in ((8, 20), (132, 1), (33, 4), (4, 40)):
        assert PD.tiered_split(B, Hkv, 132, False) == 1
    for (B, Hkv) in ((4, 2), (4, 20), (1, 1), (8, 20)):
        assert PD.tiered_split(B, Hkv, 132, True) == 1
    for (B, Hkv) in ((1, 1), (2, 3), (4, 2), (4, 20), (5, 13)):
        assert 1 <= PD.tiered_split(B, Hkv, 132, False) <= PD.FLAT_MAX_SPLIT


@pytest.mark.parametrize("W,max_len,block_k", [
    (128, 512, 128),     # fastvlm-1.7b / mobilevlm-3b serving
    (64, 224, 128),      # f32 parity runs: a ragged tail page
    (128, 500, 128),     # ragged tail page
    (8, 64, 16),         # small pages
    (16, 40, 8),         # pages smaller than a tile
    (4, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_tiered_split_covers_live_keys_once(W, max_len, block_k,
                                                         dtype):
    """The tiered kernel's tile list and split, in its own arithmetic:
    across the cluster's ranks and their warps every attendable key of a
    slot, hot and cold together, is read exactly once, at every split
    from 1 to the maximum, for lengths at 0, 1, W - 1, W, W + 1, at page
    edges and at max_len - 1, with dead pages (the last live one
    included), at every head dim."""
    n_pages = -(-max_len // block_k)
    edges = {W + k * block_k + o for k in range(n_pages) for o in (-1, 0)}
    positions = sorted(p for p in {0, 1, W - 1, W, W + 1, max_len - 1,
                                   *edges} if 0 <= p < max_len)
    for D in PD.HEAD_DIMS:
        tk = PD.tiered_tile_keys(D, dtype)
        for pos in positions:
            last = (pos - W) // block_k
            for dead in ((), (last,), (0, last), (max(last - 1, 0),)):
                table_row = [j if j * block_k <= pos - W and j not in dead
                             else -1 for j in range(n_pages)]
                want = _tiered_attendable(pos, W, table_row, block_k,
                                          max_len)
                for split in range(1, PD.FLAT_MAX_SPLIT + 1):
                    part = _tiered_partition(pos, W, n_pages, block_k, tk,
                                             split)
                    assert len(part) == split
                    assert all(len(w) == PD.FLAT_WARPS for w in part)
                    got = [k for r in part for w in r for t in w
                           for k in _tiered_tile_keys(t, pos, W, table_row,
                                                      block_k, max_len, tk)]
                    assert len(got) == len(set(got))
                    assert set(got) == want, (D, pos, dead, split)


def _tiered_case(rng, B, W, max_len, Hkv, G, D, lengths, block_k,
                 cold_scale=1.0):
    """f32 q and hot ring, int8 cold pages with f32 scales, the identity
    table of ``lengths``."""
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, D))
                         .astype(np.float32))
    hk, hv = (torch.from_numpy(rng.standard_normal((B, W, Hkv, D))
                               .astype(np.float32)) for _ in range(2))
    ckq, cvq = (torch.from_numpy(rng.integers(-127, 128, (B, max_len, Hkv,
                                                          D), np.int8))
                for _ in range(2))
    cks, cvs = (torch.from_numpy((0.004 + 0.008 * rng.random(
        (B, max_len, Hkv, 1))).astype(np.float32)) for _ in range(2))
    cks = cks * cold_scale
    lengths = torch.tensor(lengths, dtype=torch.int32)
    table = KT.cold_page_table(lengths, W, max_len, block_k).clone()
    return [q, hk, hv, ckq, cks, cvq, cvs, lengths, table]


def _warp_partial(args, b, keys, scale):
    """Flash partial of one warp over its keys of slot b: hot rows at
    full precision, cold int8 rows with their scales out of the dots."""
    q, hk, hv, ckq, cks, cvq, cvs = args[:7]
    hot = [r for (src, _, r) in keys if src == "hot"]
    cold = [r for (src, _, r) in keys if src == "cold"]
    one = torch.ones(1, len(hot), q.shape[1], 1)
    k = torch.cat([hk[b:b + 1, hot], ckq[b:b + 1, cold].float()], 1)
    v = torch.cat([hv[b:b + 1, hot], cvq[b:b + 1, cold].float()], 1)
    ks = torch.cat([one, cks[b:b + 1, cold]], 1)
    vs = torch.cat([one, cvs[b:b + 1, cold]], 1)
    return PD._segment(q[b:b + 1].float(), k, v,
                       torch.ones(1, len(keys), dtype=torch.bool), scale,
                       ks, vs)


@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("block_k", [16, 32])
def test_paged_decode_tiered_rank_order_merge_matches_plain(G, block_k):
    """A plain-PyTorch model of the split kernel: per-(rank, warp)
    partials over `_tiered_partition`'s keys (hot and cold in one warp's
    list; an empty warp or rank gives (NEG_INF, 0, 0)), each rank's warps
    combined at their common max, then the ranks (`_combine`), as the
    kernel merges them, equals `paged_decode_tiered_plain` within 1e-6 in
    f32 at
    every split: lengths below W (no cold key live), at W, at a page edge
    and at max_len - 1 (a ragged tail page), a dead page and a dead last
    live page."""
    rng = np.random.default_rng(16)
    B, W, max_len, Hkv, D = 5, 16, 100, 2, 16
    lengths = [3, W, W + 2 * block_k - 1, 99, 70]
    args = _tiered_case(rng, B, W, max_len, Hkv, G, D, lengths, block_k)
    table = args[8]
    table[3, 1] = -1
    table[4, (70 - W) // block_k] = -1        # the last live page
    want = PD.paged_decode_tiered_plain(*args, block_k=block_k)
    tk = PD.tiered_tile_keys(D, torch.float32)
    n_pages, scale = table.shape[1], D ** -0.5
    for split in range(1, PD.FLAT_MAX_SPLIT + 1):
        got = torch.empty_like(want)
        for b in range(B):
            pos, row = lengths[b], table[b].tolist()
            blocks = []
            for ranks in _tiered_partition(pos, W, n_pages, block_k, tk,
                                           split):
                warps = []
                for tiles in ranks:
                    keys = [k for t in tiles for k in _tiered_tile_keys(
                        t, pos, W, row, block_k, max_len, tk)]
                    warps.append(_warp_partial(args, b, keys, scale) if keys
                                 else _empty_state(Hkv, G, D))
                blocks.append(_combine(warps))
            m, d, acc = _combine(blocks)
            got[b] = (acc / d.clamp_min(1e-30))[0]
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_paged_decode_tiered_sparse_walk_matches_twin(monkeypatch):
    """tau > 0: a plain model of the kernel's in-order walk (one block a
    (slot, kv head); the hot ring's tiles over its 4 warps, then each live
    page's tiles, the skip test applied at each page boundary to the
    block-wide max of the warps' running maxima, in the kernel's log2
    domain) makes the same skip decisions as the twin (recorded from its
    merges) and gives its output within 1e-6; some pages are skipped,
    some read. The planner never splits the sparse read."""
    rng = np.random.default_rng(17)
    B, W, max_len, Hkv, G, D, bk, tau = 4, 8, 64, 2, 2, 16, 16, 1e-3
    lengths = [63, 40, 9, 4]
    args = _tiered_case(rng, B, W, max_len, Hkv, G, D, lengths, bk,
                        cold_scale=0.05)
    q = args[0] * 2
    args[0] = q
    args[1] = q.mean(2)[:, None].repeat(1, W, 1, 1) * 2   # hot ~ q: large m
    args[8][0, 1] = -1
    taken = []
    merge = PD._merge

    def record(state, part, take=None):
        if take is not None:
            taken.append(take[:, :, 0, 0].clone())
        return merge(state, part, take)
    monkeypatch.setattr(PD, "_merge", record)
    want = PD.paged_decode_tiered_plain(*args, block_k=bk, tau=tau)
    monkeypatch.setattr(PD, "_merge", merge)
    twin = torch.stack(taken)                  # (n_pages, B, Hkv)
    assert PD.tiered_split(B, Hkv, 132, True) == 1

    log2e = 1 / math.log(2)
    scale, table = D ** -0.5, args[8]
    n_pages = table.shape[1]
    tk = PD.tiered_tile_keys(D, torch.float32)
    got = torch.empty_like(want)
    model = torch.zeros_like(twin)
    tested = torch.zeros_like(twin)      # live pages the skip test ran on
    for b in range(B):
        pos, row = lengths[b], table[b].tolist()
        n_hot, n_cold, tpp = _tiered_lists(pos, W, n_pages, bk, tk)
        for h in range(Hkv):
            q2 = q[b, h].float() * scale * log2e            # (G, D)
            ql1 = q2.abs().sum(-1)
            warp_m = torch.full((PD.FLAT_WARPS, G), PD.NEG_INF)
            read = []

            def take(lo, hi):
                for t in range(lo, hi):
                    keys = _tiered_tile_keys(
                        _tiered_tile(t, n_hot, tpp, tk), pos, W, row, bk,
                        max_len, tk)
                    read.extend(keys)
                    for (src, _, r) in keys:
                        k = (args[1][b, r, h] if src == "hot"
                             else args[3][b, r, h].float() * args[4][b, r, h])
                        w = (t - lo) % PD.FLAT_WARPS
                        warp_m[w] = torch.maximum(warp_m[w], q2 @ k)
            take(0, n_hot)
            for j in range(n_pages):
                if row[j] < 0 or j * bk > pos - W:
                    continue
                rows = [row[j] * bk + i for i in range(bk)
                        if j * bk + i <= pos - W and row[j] * bk + i < max_len]
                mk = float(args[4][b, rows, h, 0].max()) if rows else 0.0
                live = bool((127.0 * mk * ql1 >= warp_m.amax(0)
                             + math.log(tau) * log2e).any())
                model[j, b, h], tested[j, b, h] = live, True
                if live:
                    take(n_hot + j * tpp, min(n_hot + n_cold,
                                              n_hot + (j + 1) * tpp))
            part = _warp_partial([q[:, h:h + 1]] + [
                t[:, :, h:h + 1] for t in args[1:7]], b, read, scale)
            m, d, acc = part
            got[b, h] = (acc / d.clamp_min(1e-30))[0, 0]
    assert torch.equal(model, twin)
    assert model[tested].any() and not model[tested].all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kernel", ["paged_decode_tiered",
                                    "paged_decode_flat"])
def test_paged_decode_check_wants_aligned_q(kernel):
    """The paged decodes' operand check (run here on CPU tensors): the
    kernels load q 16 bytes at a time, so a q that does not start 16-byte
    aligned raises, as a misaligned K/V store does."""
    base = torch.zeros(1 + 4 * 2 * 2 * 16)
    q = base[:-1].view(4, 2, 2, 16)
    table = torch.zeros(4, 2, dtype=torch.int32)
    expect = {"table": (table, (4, 2), torch.int32)}
    PD._check(kernel, q, expect)
    with pytest.raises(ValueError, match="q must be contiguous and start"):
        PD._check(kernel, base[1:].view(4, 2, 2, 16), expect)


@pytest.mark.parametrize("head_dim", PD.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_tiered_tiles_fit_shared_memory(head_dim, dtype):
    """The tiered kernel's tiles (the Python mirror of the .cu constants,
    which chip_smoke holds against the built library): a lane owns 8
    features of a row in both sources (a row over a power of two lanes,
    the padding lanes' zeros included); a hot tile's K and V rows fill one
    ring stage in whole 16-byte chunks (8 KB on the tensor-core path at
    head dims 160 / 256, whose tiles then hold the 8 keys an mma takes);
    a cold tile's int8 K and V rows and their k and v scales fit one; a
    warp's partial (m, d and G x D accumulators, G up to `max_group`)
    fits its ring; the tensor-core scores' warp scratch (bf16, G >= 2)
    follows the table. By shared memory at 4 pages (with the 1 KB a block
    is reserved and 1 KB for the static merge arrays) every instance
    leaves an SM room for the planner's FLAT_BLOCKS_PER_SM blocks, and
    head dims 64 and 128 for four; chip_smoke reads the blocks an SM
    holds, registers included, from the library. A 32k-token table fits
    a block."""
    es = torch.tensor([], dtype=dtype).element_size()
    chunks = head_dim // PD.TIERED_FEATURES
    lanes_a_key = PD.row_lanes(chunks)
    assert chunks <= lanes_a_key <= 32 and PD.TIERED_FEATURES * es % 16 == 0
    assert lanes_a_key == 32 or lanes_a_key == chunks
    sm_bytes = 233_472                     # shared memory of a Hopper SM
    for G in range(1, PD.max_group(head_dim) + 1):
        gm = 1 << (G - 1).bit_length()
        mma = dtype == torch.bfloat16 and gm >= 2
        stage = PD.tiered_stage_bytes(head_dim, gm, dtype)
        assert stage == PD.FLAT_STAGE_BYTES * (
            2 if mma and lanes_a_key == 32 else 1)
        tk = PD.tiered_tile_keys(head_dim, dtype, gm)
        assert tk % (32 // lanes_a_key) == 0 and (not mma or tk % 8 == 0)
        row = lanes_a_key * PD.TIERED_FEATURES   # with the padding lanes
        assert 2 * tk * row * es == stage
        assert tk * (2 * row + 2 * 4) <= stage
        ring = PD.FLAT_STAGES * stage
        assert 4 * (2 * gm + gm * head_dim) <= ring
        scratch = gm * (tk + 3) if mma else 0
        b = PD.tiered_smem_bytes(4, head_dim, G, dtype)
        assert b == PD.FLAT_WARPS * (ring + 4 * scratch) + 16 and b % 16 == 0
        fit = sm_bytes // (b + 2048)
        assert fit >= PD.FLAT_BLOCKS_PER_SM
        assert fit >= 4 or head_dim < 64 or (mma and head_dim > 128)
        assert PD.tiered_smem_bytes(-(-32768 // 16), head_dim, G,
                                    dtype) <= PD.SMEM_LIMIT


# ---------------------------------------------------------------------------
# qkv_proj
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("M", [16, 7])
def test_qkv_proj_twin_matches_pallas(use_bias, M):
    """Three operands against the reference kernel over the concatenated
    weight (interpret mode); M = 7 is ragged against every tile."""
    rng = np.random.default_rng(9)
    D, ns = 64, (96, 32, 32)
    x = rng.standard_normal((M, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, n)) * 0.1).astype(np.float32)
          for n in ns]
    bs = [rng.standard_normal(n).astype(np.float32) for n in ns] \
        if use_bias else [None] * 3
    want = RQK.qkv_proj(jnp.asarray(x), jnp.asarray(np.concatenate(ws, 1)),
                        jnp.asarray(np.concatenate(bs)) if use_bias
                        else None, interpret=True)
    got = QK.qkv_proj(_t(x), *map(_t, ws),
                      *(None if b is None else _t(b) for b in bs))
    _close(torch.cat(got, 1), want, **TOL2)


def test_qkv_proj_model_layout_roundtrip():
    """ops.qkv_proj reads (D, H, Dh) weights as 2-D views and returns the
    model layout, as the reference's adapter does."""
    rng = np.random.default_rng(10)
    B, S, D, H, Hkv, Dh = 2, 5, 64, 8, 2, 16
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ws = [(rng.standard_normal((D, h, Dh)) * 0.1).astype(np.float32)
          for h in (H, Hkv, Hkv)]
    bs = [rng.standard_normal((h, Dh)).astype(np.float32)
          for h in (H, Hkv, Hkv)]
    want = ROPS.qkv_proj(*map(jnp.asarray, [x, *ws, *bs]))
    got = ops.qkv_proj(*map(_t, [x, *ws, *bs]))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, **TOL2)


def _qkv_widths(cfg):
    """(D, (Nq, Nk, Nv)) of a config's QKV projection."""
    return cfg.d_model, (cfg.num_heads * cfg.head_dim,
                         cfg.num_kv_heads * cfg.head_dim,
                         cfg.num_kv_heads * cfg.head_dim)


def _qkv_shapes():
    from repro_torch.configs.base import get_config
    full = [get_config(a) for a in ("fastvlm-1.7b", "mobilevlm-3b")]
    small = [_configs(a)[1] for a in ("fastvlm-small", "mobilevlm-small",
                                      "granite-3-2b")]
    return [(c.name, True, *_qkv_widths(c)) for c in full] + \
        [(c.name, False, *_qkv_widths(c)) for c in small]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("name,full,D,ns", _qkv_shapes())
def test_qkv_gemv_split_covers_every_element_once(name, full, D, ns, M,
                                                  dtype):
    """The decode GEMV's grid (column tiles of every operand x D chunks)
    covers each (D row, output column) exactly once, each cluster is at
    most the portable 8 blocks with no empty chunk, and at the published
    widths the grid holds at least one block per SM of an H100 (132)."""
    n_split, d_chunk = QK.gemv_split(M, D, ns, 132, dtype)
    cw = QK.gemv_columns(dtype)
    assert 1 <= n_split <= QK.GEMV_MAX_SPLIT
    assert d_chunk % (QK.GEMV_THREADS // 8) == 0
    assert (n_split - 1) * d_chunk < D <= n_split * d_chunk
    blocks = 0
    for N in ns:
        assert (N * (4 if dtype == torch.float32 else 2)) % 16 == 0
        hits = np.zeros((D, N), np.int8)
        for t in range(-(-N // cw)):          # the kernel's column tiles
            for y in range(n_split):          # ... times its D chunks
                d0 = y * d_chunk
                hits[d0:d0 + min(d_chunk, D - d0), t * cw:(t + 1) * cw] += 1
                blocks += 1
        assert (hits == 1).all()
    # one wave: no more blocks than the SMs hold at once
    assert blocks <= QK.GEMV_BLOCKS_PER_SM * 132 or n_split == 1
    if full:
        assert blocks >= 132
    else:       # small widths: as many chunks as D and the cluster allow
        tiles = blocks // n_split
        assert n_split == min(QK.GEMV_MAX_SPLIT, -(-D // 32),
                              -(-132 // tiles),
                              max(1, QK.GEMV_BLOCKS_PER_SM * 132 // tiles))
    assert QK.gemv_smem_bytes(M, d_chunk, dtype) <= QK.SMEM_LIMIT


@pytest.mark.parametrize("head_dim", AS.HEAD_DIMS)
def test_attn_stream_tiles_fit_shared_memory(head_dim):
    """The bf16 kernel's Q tile and K/V ring (the Python mirror of the .cu
    constants, which chip_smoke holds against the built library) fit one
    block's shared memory on Hopper, with room for a second block at the
    head dims up to 64."""
    need = AS.wgmma_smem_bytes(head_dim)
    assert need <= AS.SMEM_LIMIT
    assert need == (AS.WGMMA_BQ + 2 * AS.WGMMA_STAGES * AS.WGMMA_BK) \
        * head_dim * 2 + 1024
    if head_dim <= 64:
        assert 2 * need <= AS.SMEM_LIMIT


@pytest.mark.parametrize("warpgroups", [1, 2])
def test_qkv_gemm_tiles_fit_shared_memory(warpgroups):
    """The bf16 GEMM's x / W ring fits one block's shared memory with at
    least three stages (two tiles ahead, one in the products), and its
    tiles are whole wgmma shapes."""
    assert QK.wgmma_smem_bytes(warpgroups) <= QK.SMEM_LIMIT
    assert QK.wgmma_stages(warpgroups) >= 3
    assert QK.WGMMA_BN % 64 == 0 and QK.WGMMA_BN <= 256
    assert QK.WGMMA_BK % 64 == 0       # whole 128-byte swizzle rows of x


@pytest.mark.parametrize("M,D,ns,want", [
    (256, 2560, (2560,) * 3, 2),              # mobilevlm-3b prefill
    (320, 1536, (1536, 256, 256), 1),         # fastvlm-1.7b prefill
    (2048, 1536, (1536, 256, 256), 2),
    (5, 64, (96, 32, 32), 1)])
def test_qkv_gemm_warpgroups(M, D, ns, want):
    """Two warpgroups a block (128-row tiles) only where their grid still
    gives three of four of the 132 SMs a block."""
    assert QK.gemm_warpgroups(M, ns, 132) == want


@pytest.mark.parametrize("B,H,S,L,causal", [
    (1, 12, 320, 320, True),       # fastvlm-1.7b prefill
    (1, 20, 256, 256, True),       # mobilevlm-3b prefill
    (1, 12, 64, 320, True),        # an extend chunk at q_offset 256
    (2, 6, 100, 333, True), (1, 4, 200, 200, False), (1, 2, 5, 40, True),
    (8, 32, 512, 512, True)])      # a full grid: no split
def test_attn_stream_kv_split_partitions_key_tiles(B, H, S, L, causal):
    """The bf16 kernel's key split: for every query tile, the cluster's
    blocks take contiguous runs [jb, je) of its live key tiles (those
    not wholly above the causal diagonal) that cover each exactly once,
    at most WGMMA_MAX_SPLIT blocks a cluster."""
    split = AS.kv_split(B, H, S, L, 132)
    assert 1 <= split <= AS.WGMMA_MAX_SPLIT
    bq, bk = AS.WGMMA_BQ, AS.WGMMA_BK
    for qt in range(-(-S // bq)):
        kv_end = min(L, qt * bq + bq + L - S) if causal else L
        n_kt = -(-kv_end // bk)
        per = -(-n_kt // split)
        seen = []
        for rank in range(split):       # the kernel's own arithmetic
            jb = min(n_kt, rank * per)
            seen += range(jb, min(n_kt, jb + per))
        assert seen == list(range(n_kt))
    if B * H * -(-S // bq) >= AS.BLOCKS_PER_SM * 132:
        assert split == 1


@pytest.mark.parametrize("head_dim", AS.HEAD_DIMS)
def test_attn_stream_variant_by_dtype(head_dim):
    assert AS.kernel_variant(torch.bfloat16, head_dim) == "wgmma"
    assert AS.kernel_variant(torch.float32, head_dim) == "fma"


@pytest.mark.parametrize("dtype,head_dim,exc", [
    (torch.float16, 128, TypeError), (torch.bfloat16, 48, ValueError),
    (torch.float32, 320, ValueError), (torch.int8, 64, TypeError)])
def test_attn_stream_variant_rejects_before_launch(dtype, head_dim, exc):
    """What no kernel takes raises in the dispatch, before the library is
    loaded or anything launches."""
    with pytest.raises(exc):
        AS.kernel_variant(dtype, head_dim)


@pytest.mark.parametrize("M,dtype,want", [
    (1, torch.bfloat16, "gemv"), (4, torch.bfloat16, "gemv"),
    (5, torch.bfloat16, "wgmma"), (320, torch.bfloat16, "wgmma"),
    (4, torch.float32, "gemv"), (5, torch.float32, "fma"),
    (256, torch.float32, "fma")])
def test_qkv_proj_variant_boundary(M, dtype, want):
    """The decode/prefill boundary stays at M = 4; bf16 prefill runs the
    tensor-core GEMM, f32 the CUDA-core one."""
    assert QK.GEMV_MAX_M == 4
    assert QK.kernel_variant(M, dtype) == want


def test_qkv_proj_variant_rejects_other_dtypes():
    with pytest.raises(TypeError):
        QK.kernel_variant(4, torch.float16)


# ---------------------------------------------------------------------------
# ffn_act_int8
# ---------------------------------------------------------------------------
def _int8_ffn(rng, D, Fd, gated):
    def q8(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def sc(n):
        return rng.uniform(1e-3, 2e-3, n).astype(np.float32)
    return (q8(D, Fd), sc(Fd), q8(D, Fd) if gated else None,
            sc(Fd) if gated else None, q8(Fd, D), sc(D))


@pytest.mark.parametrize("kind", ["gelu", "relu2"])
def test_ffn_act_int8_twin_matches_pallas(kind):
    rng = np.random.default_rng(11)
    M, D, Fd = 16, 64, 128
    x = rng.standard_normal((M, D)).astype(np.float32)
    w1q, w1s, _, _, w2q, w2s = _int8_ffn(rng, D, Fd, gated=False)
    want = RFF.ffn_act_int8(*map(jnp.asarray, (x, w1q, w1s, w2q, w2s)),
                            kind, block_m=8, block_f=64, interpret=True)
    got = FF.ffn_act_int8(_t(x), _t(w1q), _t(w1s), None, None, _t(w2q),
                          _t(w2s), kind)
    _close(got, want, **TOL2)


def test_ffn_act_int8_gated_twin_matches_reference_apply_mlp():
    """silu_gated over the int8 store: the function the reference model
    computes there (`layers.apply_mlp`'s int8 branch)."""
    rng = np.random.default_rng(12)
    rc = _configs("mobilevlm-small")[0].replace(ffn_weight_store="int8",
                                                **F32)
    M, D, Fd = 6, rc.d_model, rc.d_ff
    x = rng.standard_normal((2, M // 2, D)).astype(np.float32)
    w = _int8_ffn(rng, D, Fd, gated=True)
    names = ("w_up_q", "w_up_scale", "w_gate_q", "w_gate_scale",
             "w_down_q", "w_down_scale")
    want = RL.apply_mlp({n: jnp.asarray(a) for n, a in zip(names, w)}, rc,
                        jnp.asarray(x), None)
    got = ops.ffn_act_int8(_t(x), *map(_t, w), "silu_gated")
    _close(got, want, **TOL2)


# ---------------------------------------------------------------------------
# the CUDA forms' orders of operations, emulated in plain PyTorch
# ---------------------------------------------------------------------------
def _f16_scaled(v):
    """v rounded to fp16 after scaling by 2^-k (k >= 0 the least with
    max|v| * 2^-k < 2^14), the scale undone: the stream kernel's x and h
    for int8 weights."""
    k = max(0, math.frexp(float(v.abs().max()))[1] - 14)
    return (v * 2.0 ** -k).half().float() * 2.0 ** k


def _stream_order(x, wu, s1, wg, sg, wd, s2, kind, cl, ds, r16=None):
    """The stream form in f32, in its order: a slice of STREAM_SLICE
    hidden units split over D among ``ds`` blocks (contiguous row ranges,
    whole 16-row steps), the blocks' sums added in block order, then the
    column scales, act and the gate; block r's (M, D) partial over W_down
    rows [r STREAM_SLICE / ds, +STREAM_SLICE / ds) of the slice; the
    partials added in rank order inside each cluster of ``cl`` blocks,
    the clusters' sums in cluster order, times s2. ``r16`` rounds as the
    kernel does: "bf16" rounds each block's h to bf16 (x is bf16
    already), "f16" rounds each block's x rows and its h to fp16 after
    their power-of-two scaling (int8 weights)."""
    M, D = x.shape
    F_ = wu.shape[1]
    fs = FF.STREAM_SLICE
    dch = -(-(-(-D // ds)) // 16) * 16
    n = -(-(-(-F_ // fs) * ds) // cl) * cl      # blocks, whole clusters
    parts = []
    for blk in range(n):
        sl, dr = divmod(blk, ds)
        cols = slice(sl * fs, min(F_, (sl + 1) * fs))
        if sl * fs >= F_:
            parts.append(torch.zeros(M, D))
            continue

        def sums(w):
            tot = torch.zeros(M, cols.stop - cols.start)
            for r in range(ds):
                rows = torch.arange(r * dch, min(D, (r + 1) * dch))
                xr = x[:, rows]
                if r16 == "f16" and len(rows):
                    xr = _f16_scaled(xr)
                tot = tot + xr @ w[rows, cols]
            return tot
        u = sums(wu) * (1 if s1 is None else s1[cols])
        h = FF.activation(u, kind)
        if wg is not None:
            h = h * sums(wg) * (1 if sg is None else sg[cols])
        fch = fs // ds
        mine = slice(dr * fch, min(cols.stop - cols.start, (dr + 1) * fch))
        hm = h[:, mine]
        if r16 == "bf16":
            hm = hm.bfloat16().float()
        elif r16 == "f16" and hm.numel():
            hm = _f16_scaled(hm)
        parts.append(hm @ wd[cols][mine])
    out = torch.zeros(M, D)
    for c in range(n // cl):
        csum = torch.zeros(M, D)
        for r in range(cl):
            csum = csum + parts[c * cl + r]
        out = out + csum
    return out * (1 if s2 is None else s2)


def _prefill_order(x, wu, s1, wg, sg, wd, s2, kind, ks):
    """The wgmma form's order: bf16 operands (int8 weights widened, which
    is exact), f32 products, h = act(x·W_up·s1) [* x·W_gate·sg] rounded to
    bf16, then h·W_down over ``ks`` F chunks added in rank order, times
    s2, rounded to bf16."""
    bf = torch.bfloat16

    def w16(w):
        return w.to(bf).float()
    xf = x.to(bf).float()
    u = xf @ w16(wu) * (1 if s1 is None else s1)
    h = FF.activation(u, kind)
    if wg is not None:
        h = h * (xf @ w16(wg) * (1 if sg is None else sg))
    h = h.to(bf).float()
    F_ = wu.shape[1]
    kc = -(-F_ // ks)
    out = torch.zeros(x.shape[0], wd.shape[1])
    for r in range(ks):
        out = out + h[:, r * kc:(r + 1) * kc] @ w16(wd)[r * kc:(r + 1) * kc]
    return (out * (1 if s2 is None else s2)).to(bf)


@pytest.mark.parametrize("kind,cl,ds", [("silu_gated", 4, 1), ("gelu", 2, 1),
                                        ("relu2", 8, 2), ("gelu_gated", 1, 1),
                                        ("silu_gated", 8, 2),
                                        ("relu2", 4, 4)])
def test_ffn_stream_order_matches_plain_and_pallas(kind, cl, ds):
    """The stream form's summation order (D split, slice, rank and
    cluster order, scales after the sums) gives the plain twin's result
    within 1e-5, over bf16-typed and int8 weights, and the reference
    Pallas kernel's (interpret mode). With the kernel's 16-bit roundings
    (bf16 x and h for bf16 weights; x and h in scaled fp16 for int8) it
    stays within u * sum_f |h_f w_fd| (u = 2^-9 bf16, 2^-11 fp16) of the
    plain twin on the same bf16 x, the bound the kernel's header
    states."""
    rng = np.random.default_rng(21)
    M, D, Fd = 4, 96, 600
    x = rng.standard_normal((M, D)).astype(np.float32)
    gated = kind.endswith("gated")
    wu = (rng.standard_normal((D, Fd)) / 6).astype(np.float32)
    wg = (rng.standard_normal((D, Fd)) / 6).astype(np.float32) \
        if gated else None
    wd = (rng.standard_normal((Fd, D)) / 16).astype(np.float32)
    tw = [_t(wu), None if wg is None else _t(wg), _t(wd)]
    got = _stream_order(_t(x), tw[0], None, tw[1], None, tw[2], None, kind,
                        cl, ds)
    _close(got, FF.ffn_act_plain(_t(x), *tw, kind), **TOL2)
    want = RFF.ffn_act(jnp.asarray(x), jnp.asarray(wu),
                       None if wg is None else jnp.asarray(wg),
                       jnp.asarray(wd), kind, block_f=120, interpret=True)
    _close(got, want, **TOL)
    w = _int8_ffn(rng, D, Fd, gated)
    t8 = [None if a is None else _t(a) for a in w]
    f8 = [None if t8[i] is None else FF.dequantize(t8[i], t8[i + 1])
          for i in (0, 2, 4)]
    got8 = _stream_order(_t(x), t8[0].float(), t8[1],
                         None if t8[2] is None else t8[2].float(), t8[3],
                         t8[4].float(), t8[5], kind, cl, ds)
    _close(got8, FF.ffn_act_int8_plain(_t(x), *t8, kind), **TOL2)
    # the kernel's roundings, held to the stated bound
    xb = _t(x).bfloat16().float()
    for ws, q, r16, u in ((tw, (None,) * 3, "bf16", 2.0 ** -9),
                          (f8, (t8[1], t8[3], t8[5]), "f16", 2.0 ** -11)):
        wl = [None if a is None else a.bfloat16().float() if r16 == "bf16"
              else a for a in ws]
        ref = FF.ffn_act_plain(xb, *wl, kind)
        h = FF.activation(xb @ wl[0], kind)
        if wl[1] is not None:
            h = h * (xb @ wl[1])
        if r16 == "bf16":
            got16 = _stream_order(xb, wl[0], None, wl[1], None, wl[2], None,
                                  kind, cl, ds, r16)
        else:
            got16 = _stream_order(xb, t8[0].float(), q[0],
                                  None if t8[2] is None else t8[2].float(),
                                  q[1], t8[4].float(), q[2], kind, cl, ds,
                                  r16)
        err = (got16 - ref).abs()
        assert (err <= u * (h.abs() @ wl[2].abs()) + 1e-5).all()


@pytest.mark.parametrize("kind,gated,ks", [("silu_gated", True, 3),
                                           ("gelu", False, 1),
                                           ("relu2", False, 2)])
def test_ffn_prefill_order_within_bf16_tolerance(kind, gated, ks):
    """The wgmma form's two-phase order (h rounded to bf16, scales after
    the sums, F split in rank order) stays within the card's bf16
    tolerance (2e-2) of the f32 plain twin, over int8 weights, and of the
    reference int8 Pallas kernel (interpret mode) where it applies
    (ungated)."""
    rng = np.random.default_rng(22)
    M, D, Fd = 70, 128, 384
    x = rng.standard_normal((M, D)).astype(np.float32)
    w = list(_int8_ffn(rng, D, Fd, gated))
    w[5] = (w[5] / 16).astype(np.float32)      # outputs below 2
    tw = [None if a is None else _t(a) for a in w]
    got = _prefill_order(_t(x), tw[0].float(), tw[1],
                         None if tw[2] is None else tw[2].float(), tw[3],
                         tw[4].float(), tw[5], kind, ks)
    want = FF.ffn_act_int8_plain(_t(x).bfloat16(), *tw, kind)
    assert 0.05 < float(want.float().abs().max()) < 2
    _close(got.float(), want.float(), rtol=0, atol=2e-2)
    if not gated:
        ref = RFF.ffn_act_int8(*map(jnp.asarray, (x, w[0], w[1], w[4],
                                                  w[5])),
                               kind, block_m=14, block_f=64, interpret=True)
        _close(got.float(), ref, rtol=0, atol=2e-2)


def test_int8_weights_round_trip_through_bf16_and_the_byte_permute():
    """The premises of the int8 paths: every int8 value is exact in bf16
    (the wgmma form widens int8 tiles to bf16), and (q ^ 0x80) placed in
    the mantissa of 2^23 is the float 2^23 + 128 + q (the f32 stream
    kernel's widening: a byte permute and one subtraction); bf16 is the
    high half of its f32; and the same in fp16 over 1024."""
    q = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(q.to(torch.bfloat16).to(torch.int8), q)
    assert torch.equal(q.to(torch.bfloat16).float(), q.float())
    u = (q.numpy().view(np.uint8) ^ 0x80).astype(np.uint32) | 0x4B000000
    np.testing.assert_array_equal(u.view(np.float32) - np.float32(8388736),
                                  q.numpy().astype(np.float32))
    b = torch.randn(64).bfloat16()
    hi = b.view(torch.int16).numpy().astype(np.int32) << 16
    np.testing.assert_array_equal(hi.view(np.float32), b.float().numpy())
    # the tensor-core stream form's fp16 pairs: byte 0x64 over (q ^ 0x80)
    # is the half 1024 + 128 + q; minus 1152 (0x6480) leaves q exactly
    h = 0x6400 | (q.numpy().view(np.uint8) ^ 0x80).astype(np.uint16)
    np.testing.assert_array_equal(
        h.view(np.float16) - np.float16(1152), q.numpy().astype(np.float16))
    assert np.uint16(0x6480).view(np.float16) == 1152


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
    w8 = torch.randint(-127, 128, (32, 64), dtype=torch.int8)
    FF.ffn_act_int8(x, w8, torch.ones(64), None, None, w8.T.contiguous(),
                    torch.ones(32), "gelu")
    QK.qkv_proj(x, *(torch.randn(32, 16) for _ in range(3)))
    kv = torch.randn(1, 8, 2, 16)
    PD.paged_decode_flat(q[:, :, :1].transpose(1, 2).contiguous(), kv, kv,
                         torch.tensor([5], dtype=torch.int32),
                         torch.zeros(1, 1, dtype=torch.int32), block_k=8)
    assert len(kernels.WRAPPERS) == 7
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
    1e-4), the flat paged decode on a ragged 8-row store, and the bf16
    tensor-core paths of attn_stream and qkv_proj (2e-2). Runs only where
    a card is present."""
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
    fargs = (qd, hot, hot, lengths, KT.cold_page_table(lengths, 0, 8, 16))
    torch.testing.assert_close(PD.paged_decode_flat(*fargs, block_k=16),
                               PD.paged_decode_flat_plain(*fargs,
                                                          block_k=16),
                               atol=1e-4, rtol=0)
    # fused_norm's scalar kernel on rows whose pitch is not whole vectors
    xs = r(5, 100)[:, :96]
    torch.testing.assert_close(FN.fused_norm(xs, s, s, "layer"),
                               FN.fused_norm_plain(xs, s, s, "layer"),
                               atol=1e-4, rtol=0)
    # the split flat kernel at mobilevlm-3b's decode heads (a cluster of
    # blocks a (slot, kv head)) on a store with a ragged tail page
    lf = torch.tensor([0, 128, 250, 199], dtype=torch.int32, device=dev)
    qf, kf = r(4, 20, 1, 128), r(4, 251, 20, 128)
    fargs = (qf, kf, kf, lf, KT.cold_page_table(lf, 0, 251, 128))
    torch.testing.assert_close(PD.paged_decode_flat(*fargs),
                               PD.paged_decode_flat_plain(*fargs),
                               atol=1e-4, rtol=0)
    ws = (r(96, 64), r(96, 32), r(96, 32))
    for a, b in zip(QK.qkv_proj(x, *ws), QK.qkv_proj_plain(x, *ws)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    # bf16 (2e-2: outputs below 2, one bf16 step 7.8e-3): the tensor-core
    # attention at every head dim, causal S < L and ragged S = L = 200,
    # and the GEMV at M = 1, 3, 4 and the wgmma GEMM at M = 5 and 77
    bf = torch.bfloat16
    for (S, L, D) in ((40, 72, 16), (33, 33, 32), (200, 200, 64),
                      (64, 130, 128)):
        q, k, v = r(1, 6, S, D).to(bf), r(1, 2, L, D).to(bf), \
            (0.4 * r(1, 2, L, D)).to(bf)
        torch.testing.assert_close(AS.attn_stream(q, k, v).float(),
                                   AS.attn_stream_plain(q, k, v).float(),
                                   atol=2e-2, rtol=0)
    for M in (1, 3, 4, 5, 77):
        xb = r(M, 96).to(bf)
        wb = [(w / 10).to(bf) for w in ws]
        bb = [(0.1 * r(w.shape[1])).to(bf) for w in ws]
        for a, b in zip(QK.qkv_proj(xb, *wb, *bb),
                        QK.qkv_proj_plain(xb, *wb, *bb)):
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                       rtol=0)
    w8 = [torch.randint(-127, 128, s_, generator=g, device=dev,
                        dtype=torch.int8) for s_ in ((96, 208), (96, 208),
                                                     (208, 96))]
    sc = [torch.full((n,), 1e-3, device=dev) for n in (208, 208, 96)]
    args8 = (w8[0], sc[0], w8[1], sc[1], w8[2], sc[2], "silu_gated")
    torch.testing.assert_close(FF.ffn_act_int8(x, *args8),
                               FF.ffn_act_int8_plain(x, *args8),
                               atol=1e-4, rtol=0)


def test_require_operands_names_the_bad_operand():
    """The wrappers' CUDA-side operand check (run here on CPU tensors):
    shape, dtype and contiguity faults raise naming the operand; an
    absent optional operand passes."""
    from repro_torch.kernels import build
    w = torch.zeros(4, 6)
    build.require_operands("k", w.device, {"w": (w, (4, 6), torch.float32),
                                           "b": (None, (6,), torch.float32)})
    for bad in ((w, (6, 4), torch.float32),        # shape
                (w, (4, 6), torch.bfloat16),       # dtype
                (w.T, (6, 4), torch.float32)):     # contiguity
        with pytest.raises(ValueError, match="k: w must be"):
            build.require_operands("k", w.device, {"w": bad})
