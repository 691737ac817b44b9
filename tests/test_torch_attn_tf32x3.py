"""The f32 tensor-core form ("tf32x3") of `attn_stream`.

The CUDA kernel runs only on a card (`python3 chip_smoke.py` holds it
against the plain twin at the training shape and the f32 prefill shapes).
Here its arithmetic is emulated in numpy, step for step:
- each f32 operand is rounded to TF32 as cvt.rna.tf32.f32 does and cut
  into hi + lo (`tf32` / `split` of tests/test_torch_tf32x3.py);
- S = Q.K^T of each key tile is three TF32 products a k-step of 8
  (lo·hi, hi·lo, hi·hi), each added into the accumulator by the tensor
  cores with one rounding toward zero (modelled: the k-step's exact dot
  product added in f64, then truncated to f32);
- the online softmax in f32 (exp2 of log2e-scaled scores, the running
  max, the rescale);
- P split into hi / lo in registers and multiplied into a zeroed
  fragment with V^T's pair plane, whose keys sit in each group of 8 in
  the order 0 2 4 6 1 3 5 7 (`key_pos`, the kernel's tf_key_pos), so
  the S accumulator's registers serve as the .tf32 A fragment; the
  tile's sum is added into the f32 output in f32.
At fastvlm-1.7b's heads (H 12, Hkv 2, Dh 128) that emulation is held to
the JAX package's own oracle (`repro.kernels.ref.attn_stream_ref`) at the
f32 paths' gate, 1e-4 of the largest element, and a single TF32 product
is shown to miss it. The plan tests hold the form's shared memory at
every head dim it takes and its dispatch by head dim.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RREF
from repro_torch.kernels import attn_stream as AS
from repro_torch.kernels import tf32x3 as TF
from test_torch_tf32x3 import GATE, SPLIT_BOUND, split, tf32

jax.config.update("jax_platform_name", "cpu")

NEG_INF = np.float32(-2.0 ** 20)
LOG2E = np.float32(1.4426950408889634)
FASTVLM_H, FASTVLM_HKV, FASTVLM_DH = 12, 2, 128


def key_pos(l: int) -> int:
    """Position of key ``l`` in V^T's pair plane (the kernel's
    tf_key_pos): in each group of 8 keys the even ones, then the odd."""
    e = l & 7
    return (l & ~7) | (4 + (e >> 1) if e & 1 else e >> 1)


def rz_add(acc: np.ndarray, prod: np.ndarray) -> np.ndarray:
    """acc (f32) + prod (exact, f64) rounded toward zero to f32: the
    tensor cores' accumulation of one product."""
    x = acc.astype(np.float64) + prod
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_products(acc, a_parts, b_parts, fresh: bool, k: int = 8):
    """The tensor-core products of a GEMM over the last axis of a (.., M,
    K) and b (.., N, K) (both K-major, as wgmma reads TF32): per k-step
    of ``k``, the listed (a, b) TF32 parts multiplied and each product
    added into ``acc`` with one rounding toward zero. ``fresh``: the
    first product overwrites acc (scale_d 0)."""
    K = a_parts[0][0].shape[-1]
    for k0 in range(0, K, k):
        for i, (a, b) in enumerate(zip(a_parts, b_parts)):
            p = np.matmul(a[0][..., k0:k0 + k].astype(np.float64),
                          np.swapaxes(b[0][..., k0:k0 + k], -1, -2)
                          .astype(np.float64))
            if fresh and k0 == 0 and i == 0:
                acc = rz_add(np.zeros_like(acc), p)
            else:
                acc = rz_add(acc, p)
    return acc


def emulate(q, k, v, causal: bool = True, products: str = "tf32x3"):
    """The tf32x3 kernel's arithmetic on q (B, H, S, D), k / v (B, Hkv, L,
    D), f32, in numpy; ``products`` "tf32" keeps only hi·hi (a single
    TF32 product a term)."""
    B, H, S, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    G, bk = H // Hkv, AS.tf32x3_bk(D)
    scale_log2 = np.float32(D ** -0.5) * LOG2E
    kh = np.repeat(k, G, axis=1)          # head h reads kv head h // G
    vh = np.repeat(v, G, axis=1)
    lp = -(-L // 16) * 16
    # V^T's plane: keys at key_pos, zeros from L to a multiple of 16
    vt = np.zeros((B, H, D, lp), np.float32)
    for l in range(L):
        vt[..., key_pos(l)] = vh[:, :, l, :]
    qs, ks, vs = split(q), split(kh), split(vt)

    three = products == "tf32x3"

    def ops(a, b):
        """(a parts, b parts): lo·hi, hi·lo, hi·hi, or hi·hi alone."""
        if not three:
            return [(a[0],)], [(b[0],)]
        return [(a[1],), (a[0],), (a[0],)], [(b[0],), (b[1],), (b[0],)]

    q_pos = np.arange(S)[:, None] + (L - S)
    o = np.zeros((B, H, S, D), np.float32)
    m = np.full((B, H, S), NEG_INF, np.float32)
    den = np.zeros((B, H, S), np.float32)
    for k0 in range(0, L, bk):            # every query row's key tiles
        ke = min(k0 + bk, L)
        kt = tuple(np.pad(t[:, :, k0:ke], ((0, 0), (0, 0),
                                           (0, k0 + bk - ke), (0, 0)))
                   for t in ks)           # rows past L zero-filled
        s = tc_products(np.zeros((B, H, S, bk), np.float32),
                        *ops(qs, kt), fresh=True)
        kj = k0 + np.arange(bk)[None, :]
        ok = kj < L
        if causal:
            ok = ok & (kj <= q_pos)
        s = np.where(ok, s * scale_log2, NEG_INF).astype(np.float32)
        mn = np.maximum(m, s.max(-1))
        al = np.exp2(m - mn).astype(np.float32)
        p = np.exp2(s - mn[..., None]).astype(np.float32)
        den = (den * al + p.sum(-1, dtype=np.float32)).astype(np.float32)
        m = mn
        # P's A fragment holds keys in V^T's order: column c of the
        # product is the key at plane position c
        order = [k0 + j for j in range(bk)]
        inv = np.empty(bk, int)
        for j in range(bk):
            inv[key_pos(order[j]) - k0] = j
        pa = split(np.ascontiguousarray(p[..., inv]))
        vtile = tuple(np.pad(t[..., k0:min(k0 + bk, lp)],
                             ((0, 0), (0, 0), (0, 0),
                              (0, k0 + bk - min(k0 + bk, lp))))
                      for t in vs)
        tmp = tc_products(np.zeros((B, H, S, D), np.float32),
                          *ops(pa, vtile), fresh=True)
        o = (o * al[..., None] + tmp).astype(np.float32)
    return (o / np.maximum(den, np.float32(1e-30))[..., None]).astype(
        np.float32)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def fastvlm_heads():
    """fastvlm-1.7b's heads (H 12, Hkv 2, Dh 128) at B 1, S = L = 128,
    and an extend (S 64 over L 100: q_offset 36, a ragged key tile)."""
    rng = np.random.default_rng(28)
    out = {}
    for name, S, L in (("prefill", 128, 128), ("extend", 64, 100)):
        q = rng.standard_normal((1, FASTVLM_H, S, FASTVLM_DH)).astype(
            np.float32)
        k, v = (rng.standard_normal((1, FASTVLM_HKV, L, FASTVLM_DH))
                .astype(np.float32) for _ in range(2))
        want = np.asarray(RREF.attn_stream_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
        out[name] = (q, k, v, want)
    return out


@pytest.mark.parametrize("case", ["prefill", "extend"])
@pytest.mark.parametrize("form,holds", [("tf32x3", True), ("tf32", False)])
def test_emulated_attention_against_the_reference_oracle(fastvlm_heads,
                                                         case, form, holds):
    """The 3xTF32 emulation is within 1e-4 of the largest element of the
    JAX oracle (f32 on the CPU), at f32's order; a single TF32 product a
    term misses that gate, so the gate sees the split."""
    q, k, v, want = fastvlm_heads[case]
    err = _rel(emulate(q, k, v, True, form), want)
    assert (err <= GATE) == holds, (case, form, err)
    if holds:
        assert err < GATE / 20, err
    else:
        assert err > 2 * GATE, err


def test_emulation_matches_the_torch_twin(fastvlm_heads):
    """The port's plain twin (what the card's kernel is held to) agrees
    with the emulation as it does with the oracle."""
    q, k, v, want = fastvlm_heads["prefill"]
    twin = AS.attn_stream_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True).numpy()
    assert _rel(twin, want) < 1e-6
    assert _rel(emulate(q, k, v), twin) < GATE / 20


def test_key_order_is_a_permutation_of_each_group():
    for g in range(0, 64, 8):
        assert sorted(key_pos(l) for l in range(g, g + 8)) == list(
            range(g, g + 8))
    assert [key_pos(l) for l in range(8)] == [0, 4, 1, 5, 2, 6, 3, 7]


@pytest.mark.parametrize("head_dim", AS.TF32X3_HEAD_DIMS)
def test_p_fragment_meets_the_permuted_vt(head_dim):
    """Register for register, as the kernel builds them: thread t of the
    warpgroup (warp w, lane l) holds S's accumulator fragment s[4c + 2i +
    e] = P[16w + l/4 + 8i, 8c + 2(l%4) + e]; the kernel hands
    s[4c + (j&1)·2 + (j>>1)] to a[j] of k-step c, and the .tf32 A
    fragment (PTX ISA) reads a[0] (r, l%4), a[1] (r + 8, l%4), a[2] (r,
    l%4 + 4), a[3] (r + 8, l%4 + 4). Against V^T's plane with keys at
    key_pos the product is P·V exactly."""
    bk = AS.tf32x3_bk(head_dim)
    rng = np.random.default_rng(head_dim)
    P = rng.integers(-8, 9, (AS.TF32X3_BQ, bk)).astype(np.float64)
    V = rng.integers(-8, 9, (bk, head_dim)).astype(np.float64)
    plane = np.zeros((head_dim, bk))
    for key in range(bk):
        plane[:, key_pos(key)] = V[key]
    acc = np.zeros((AS.TF32X3_BQ, head_dim))
    for c in range(bk // 8):
        A = np.full((AS.TF32X3_BQ, 8), np.nan)
        for t in range(128):
            w, ln = t // 32, t % 32
            r, tq = 16 * w + ln // 4, ln % 4
            s = {4 * c + 2 * i + e: P[r + 8 * i, 8 * c + 2 * tq + e]
                 for i in (0, 1) for e in (0, 1)}
            a = [s[4 * c + (j & 1) * 2 + (j >> 1)] for j in range(4)]
            A[r, tq], A[r + 8, tq], A[r, tq + 4], A[r + 8, tq + 4] = a
        assert not np.isnan(A).any()
        acc += A @ plane[:, 8 * c:8 * c + 8].T
    np.testing.assert_array_equal(acc, P @ V)


def test_rz_accumulation_stays_inside_the_split_bound():
    """The tensor cores' truncating adds over one key tile's P·V (4
    k-steps x 3 products) and over S's 16 k-steps at Dh 128 move a sum
    by at most one f32 ulp of the running |sum| each: well inside the
    split's 3·2^-22 a term at these lengths."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((32, 128)).astype(np.float32)
    (ah, al), (bh, bl) = split(a), split(b)
    got = tc_products(np.zeros((64, 32), np.float32),
                      [(al,), (ah,), (ah,)], [(bh,), (bl,), (bh,)],
                      fresh=True)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64).T
    steps = 3 * 128 // 8
    assert (np.abs(got - exact)
            <= (SPLIT_BOUND + steps * 2.0 ** -23) * mag).all()
    assert tf32(np.float32(1.0)) == 1.0


@pytest.mark.parametrize("head_dim", AS.HEAD_DIMS)
def test_tf32x3_smem_fits_hopper(head_dim):
    """Q's pair tile (64 rows) and a K and a V^T pair tile for each of
    the two warpgroups fit a block at every head dim the form takes (Dh
    64: 97 KB, two blocks an SM; Dh 128: 193 KB; Dh 160 at 16-key tiles:
    161 KB). At Dh 256 they take 257 KB, past the 227 KB a block may
    use, so Dh 256 keeps the fma kernel, as do Dh 16 and 32 (reduced
    configs only)."""
    b = AS.tf32x3_smem_bytes(head_dim)
    bk = AS.tf32x3_bk(head_dim)
    assert b == 8 * head_dim * (AS.TF32X3_BQ + 2 * AS.TF32X3_WGS * bk) \
        + 1024
    if head_dim in AS.TF32X3_HEAD_DIMS:
        assert b <= AS.SMEM_LIMIT
        assert {64: 99_328, 128: 197_632, 160: 164_864}[head_dim] == b
        # a key tile is whole pair blocks of whole 8-deep k-steps
        assert bk % TF.TF32_PAIR == 0 and head_dim % 32 == 0
    elif head_dim == 256:
        assert b == 263_168 > AS.SMEM_LIMIT
    assert AS.TF32X3_HEAD_DIMS == (64, 128, 160)


@pytest.mark.parametrize("head_dim", AS.HEAD_DIMS)
def test_tf32x3_dispatch_by_head_dim(head_dim):
    """f32 takes the tf32x3 form at every head dim whose tiles fit a
    block, whatever the number of query rows, and the fma form at the
    others; bf16 is always the wgmma kernel."""
    want = ("tf32x3" if AS.tf32x3_smem_bytes(head_dim) <= AS.SMEM_LIMIT
            and head_dim >= 64 else "fma")
    assert AS.kernel_variant(torch.float32, head_dim) == want
    assert AS.kernel_variant(torch.bfloat16, head_dim) == "wgmma"
    assert AS.FORMS == ("fma", "wgmma", "tf32x3")


@pytest.mark.parametrize("B,Hkv,L,D,want", [
    (8, 2, 256, 128, 8 * 2 * (256 * 256 + 128 * 512)),   # training
    (1, 2, 100, 128, 2 * (100 * 256 + 128 * 7 * 32)),    # ragged L
    (1, 8, 256, 160, 8 * (256 * 320 + 160 * 512))])
def test_tf32x3_scratch(B, Hkv, L, D, want):
    """The workspace: K's pair plane (L rows of 2 D floats) and V^T's (D
    rows of L keys rounded up to 16, hi and lo) per (b, kv head)."""
    assert AS.tf32x3_scratch(B, Hkv, L, D) == want
    assert TF.tf32x3_pair_ld(L) == -(-L // 16) * 32
