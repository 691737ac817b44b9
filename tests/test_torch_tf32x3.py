"""The f32 tensor-core form ("tf32x3") of `ffn_act` and `qkv_proj`.

The CUDA kernels run only on a card (`python3 chip_smoke.py` holds them
against their plain twins at the training shapes). Here their arithmetic
is emulated in numpy: each f32 operand is rounded to TF32 as
cvt.rna.tf32.f32 does (an add of 0x1000 to the magnitude bits, then a
mask of 0xFFFFE000), cut into hi + lo, and a product is lo·hi + hi·lo +
hi·hi, each TF32 product exact in f32 and summed in f32. At fastvlm-1.7b's
widths (D 1536, F 8960) and 16 rows from a numpy seed that emulation is
held to the JAX package's own oracles (`repro.kernels.ref.ffn_act_ref`,
`qkv_proj_ref`) at the f32 paths' gate, 1e-4 of the largest element, and
a single TF32 product is shown to miss it. The plan tests hold the form's
tiles, shared memory and phase-2 split at every f32 shape the port runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RREF
from repro_torch.kernels import ffn_act as FF
from repro_torch.kernels import qkv_proj as QK
from repro_torch.kernels import tf32x3 as TF

jax.config.update("jax_platform_name", "cpu")

GATE = 1e-4                # the f32 paths' gate (chip_smoke.py's TOL)
SPLIT_BOUND = 3 * 2.0 ** -22   # csrc/tf32x3.cuh: a term's error / |a b|
FASTVLM_D, FASTVLM_F, ROWS = 1536, 8960, 16
FASTVLM_NS = (1536, 256, 256)  # 12 / 2 / 2 heads of 128


def tf32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties
    away from zero), the low 13 bits cleared."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm_3x(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The kernel's product: lo·hi + hi·lo + hi·hi, summed in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh) + (ah @ bl) + (ah @ bh)


def mm_1x(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A single TF32 product, summed in f32."""
    return tf32(a) @ tf32(b)


MM = {"tf32x3": mm_3x, "tf32": mm_1x}


def _silu(h):
    return h / (np.float32(1) + np.exp(-h))


def _ffn(mm, x, wu, wg, wd):
    h = (_silu(mm(x, wu)) * mm(x, wg)).astype(np.float32)
    return mm(h, wd)


@pytest.fixture(scope="module")
def fastvlm():
    """16 rows of fastvlm-1.7b's FFN and QKV projection operands."""
    rng = np.random.default_rng(27)
    D, F_ = FASTVLM_D, FASTVLM_F

    def w(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    x = w(ROWS, D, std=1.0)
    ffn = (w(D, F_, std=D ** -0.5), w(D, F_, std=D ** -0.5),
           w(F_, D, std=F_ ** -0.5))
    qkv = (w(D, sum(FASTVLM_NS), std=D ** -0.5),
           w(sum(FASTVLM_NS), std=0.1))
    want_ffn = np.asarray(RREF.ffn_act_ref(
        jnp.asarray(x), *(jnp.asarray(t) for t in ffn), "silu_gated"))
    want_qkv = np.asarray(RREF.qkv_proj_ref(
        jnp.asarray(x), jnp.asarray(qkv[0]), jnp.asarray(qkv[1])))
    return x, ffn, qkv, want_ffn, want_qkv


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kernel", ["ffn_act", "qkv_proj"])
@pytest.mark.parametrize("form,holds", [("tf32x3", True), ("tf32", False)])
def test_emulated_form_against_the_reference_oracle(fastvlm, kernel, form,
                                                    holds):
    """At fastvlm-1.7b's widths the 3xTF32 emulation is within 1e-4 of
    the largest element of the JAX oracle (f32 on the CPU); one TF32
    product a term misses that gate, so the gate sees the split."""
    x, ffn, qkv, want_ffn, want_qkv = fastvlm
    mm = MM[form]
    if kernel == "ffn_act":
        err = _rel(_ffn(mm, x, *ffn), want_ffn)
    else:
        err = _rel(mm(x, qkv[0]) + qkv[1], want_qkv)
    assert (err <= GATE) == holds, (kernel, form, err)
    if holds:
        assert err < GATE / 20          # f32's order, far inside the gate
    else:
        assert err > 2 * GATE           # and not a near miss


def test_tf32_rounding_is_cvt_rna():
    """The emulated rounding: to nearest, ties away from zero, 10 stored
    mantissa bits; exact TF32 values and zero stay as they are."""
    one_ulp = 2.0 ** -10
    a = np.array([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0 + 3 * 2.0 ** -11,
                  0.0, -0.0, 1.5, 2.0 ** -126], np.float32)
    want = np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0,
                     1.0 + 2 * one_ulp, 0.0, -0.0, 1.5, 2.0 ** -126],
                    np.float32)
    np.testing.assert_array_equal(tf32(a), want)
    assert not (tf32(a).view(np.uint32) & np.uint32(0x1FFF)).any()


def test_split_is_exact_to_its_bound():
    """a = hi + lo + e with hi, lo TF32 values, |lo| <= 2^-11 |a| and
    |e| <= 2^-22 |a|, over normal f32 values of every scale."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(200_000)
         * 2.0 ** rng.integers(-60, 60, 200_000)).astype(np.float32)
    hi, lo = split(a)
    for t in (hi, lo):
        assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
    a64, hi64, lo64 = (t.astype(np.float64) for t in (a, hi, lo))
    assert (np.abs(lo64) <= 2.0 ** -11 * np.abs(a64)).all()
    assert (np.abs(a64 - hi64 - lo64) <= 2.0 ** -22 * np.abs(a64)).all()


@pytest.mark.parametrize("K", [8, 1536, 8960])
def test_three_products_within_the_stated_bound(K):
    """The note's bound in exact arithmetic: dropping lo·lo and the two
    roundings moves sum_k a_k b_k by at most 3·2^-22 sum_k |a_k b_k|."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((4, K)).astype(np.float32)
    b = (rng.standard_normal((K, 64)) * rng.uniform(
        0.01, 100, (K, 1))).astype(np.float32)
    (ah, al), (bh, bl) = (tuple(t.astype(np.float64) for t in split(m))
                          for m in (a, b))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = al @ bh + ah @ bl + ah @ bh
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert (np.abs(exact - three) <= SPLIT_BOUND * mag).all()


# every f32 FFN / projection shape the port runs: the registered configs'
# d_model and F (dense FFNs and experts), at the training M 2048 and the
# parity prefills' 256-320 rows
F32_DS = (1280, 1536, 2048, 2560, 4608, 5120)
F32_FS = (1408, 5120, 6912, 8192, 8960, 10944, 13824, 16384, 18432)
F32_MS = (FF.TF32X3_MIN_M, 77, 256, 300, 320, 2000, 2048)


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_tf32x3_smem_fits_hopper(gated):
    """Both GEMMs' ring (hi / lo pair tiles of x or h and of the weights,
    3 stages at least) fits a block and holds phase 2's f32 partial of the
    cluster merge; the mirror's sizes are the arithmetic of
    csrc/tf32x3.cuh. A phase-1 B tile is 128 rows: 64 columns of W_up
    beside the same 64 of W_gate, or 128 of an ungated W_up."""
    stages, b = FF.tf32x3_stages()
    stage = 2 * 4 * FF.TF32_BK * (FF.TF32_BM + FF.TF32_BN)
    assert b == FF.tf32x3_smem_bytes() == stages * stage + 1024
    assert 3 <= stages <= FF.TF32_MAX_STAGES and b <= FF.SMEM_LIMIT
    assert (stages, b) == (3, 197_632)
    assert 4 * FF.TF32_BM * FF.TF32_BN <= stages * stage
    assert FF.tf32x3_columns(gated) * (2 if gated else 1) == FF.TF32_BN
    # the tensor cores' sums reach the f32 accumulator every 64 of K
    assert FF.TF32_FLUSH * FF.TF32_BK == 64


def test_qkv_tf32x3_smem_fits_hopper():
    b = QK.tf32x3_smem_bytes()
    assert b == FF.tf32x3_smem_bytes() and b <= QK.SMEM_LIMIT
    assert (QK.TF32_BM, QK.TF32_BN, QK.TF32_BK) == (
        FF.TF32_BM, FF.TF32_BN, FF.TF32_BK)
    # a pair block (16 hi, 16 lo f32) is one 128-byte swizzled line; a
    # k-tile holds whole blocks of whole 8-deep k-steps
    assert 8 * TF.TF32_PAIR == 128 and QK.TF32_BK % TF.TF32_PAIR == 0


@pytest.mark.parametrize("D", F32_DS)
@pytest.mark.parametrize("F_", F32_FS)
def test_ffn_tf32x3_plan_covers_every_f32_shape(D, F_):
    """At every f32 shape the port runs: the form is picked, the tiles
    cover ragged M, D and F (zero-filled past the edge), and phase 2's F
    split is whole 16-deep tiles covering [0, F) once, in at most a
    portable cluster; the workspace holds every plane."""
    for M in F32_MS:
        assert FF.kernel_variant(M, torch.float32) == "tf32x3"
        ks, kc, flush = FF.tf32x3_plan(M, D, F_, 132)
        assert flush == 0 and 1 <= ks <= FF.STREAM_MAX_SPLIT
        assert kc % FF.TF32_BK == 0 and (ks - 1) * kc < F_ <= ks * kc
        mt, nt2 = -(-M // FF.TF32_BM), -(-D // FF.TF32_BN)
        assert mt * FF.TF32_BM >= M > (mt - 1) * FF.TF32_BM
        assert nt2 * FF.TF32_BN >= D
        for gated in (True, False):
            fw = FF.tf32x3_columns(gated)
            assert -(-F_ // fw) * fw >= F_ > (-(-F_ // fw) - 1) * fw
        assert -(-D // FF.TF32_BK) * FF.TF32_BK >= D   # phase 1's K
        # a split only where the tile grid leaves SMs idle in its last wave
        assert ks == 1 or (mt * nt2) % 132
        for gated in (True, False):
            # pair planes: a row of K is ceil(K / 16) blocks of 16 hi and
            # 16 lo values; x, W_up^T [, W_gate^T] of D, W_down^T, h of F
            ldd, ldf = -(-D // 16) * 32, -(-F_ // 16) * 32
            assert TF.tf32x3_pair_ld(D) == ldd
            assert FF.tf32x3_scratch(M, D, F_, gated) == (
                (M + (2 if gated else 1) * F_) * ldd + (D + M) * ldf)


@pytest.mark.parametrize("M,D,F_,sms,want", [
    (2048, 1536, 8960, 132, 2), (320, 1536, 8960, 132, 3),
    (256, 2560, 6912, 132, 3), (2048, 2048, 8192, 132, 1),
    (64, 128, 32, 132, 1)])
def test_ffn_tf32x3_plan_split(M, D, F_, sms, want):
    """The split at fastvlm's training shape (16 x 12 tiles: 2 waves
    unsplit, 1.5 at ks 2), at the parity prefills (36 / 40 tiles: one
    wave of 3 x the tiles), and none where it does not shorten the waves
    (16 x 16 tiles: 2 waves at every ks) or F is one k-tile."""
    assert FF.tf32x3_plan(M, D, F_, sms)[0] == want


def test_qkv_tf32x3_scratch():
    assert QK.tf32x3_scratch(2048, 1536, FASTVLM_NS) == 2 * (
        2048 + 2048) * 1536
    assert QK.tf32x3_scratch(77, 1000, (96, 32, 32)) == (
        (77 + 160) * 63 * 32)
    assert QK.TF32_MAX_STAGES == FF.TF32_MAX_STAGES
