"""PyTorch port: per-module parity of the layers, connector and GQA
attention math against the JAX reference on the CPU.

Inputs are drawn with numpy from a seed and fed to both sides. Tolerance
2e-5 (f32), as `tests/test_kernels.py` holds the reference kernels:
both sides compute in f32, in other summation orders.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.core import kv_tiers as RKT
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import vision as RV
from repro_torch.configs.base import get_config
from repro_torch.core import kv_tiers as KT
from repro_torch.kernels import paged_decode as PD
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import vision as V

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-5, atol=2e-5)
CFG = types.SimpleNamespace(attn_scores_dtype="float32")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(port, ref, **kw):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(kw or TOL))


def _cfgs(**kw):
    base = dict(param_dtype="float32", compute_dtype="float32")
    return (ref_get_config("fastvlm-1.7b").replace(**base, **kw),
            get_config("fastvlm-1.7b").replace(**base, **kw))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    rc, pc = _cfgs(norm_type=norm)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 0.5).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    _close(L.apply_norm({k: _t(v) for k, v in p.items()}, pc, _t(x)),
           RL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, rc, x))


def test_apply_rope_half_split():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos), 10_000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
           rtol=2e-5, atol=5e-5)


@pytest.mark.parametrize("kind", ["silu_gated", "gelu", "gelu_gated",
                                  "relu2"])
@pytest.mark.parametrize("bias", [False, True])
def test_apply_mlp(kind, bias):
    rc, pc = _cfgs(d_model=32, d_ff=64, mlp_type=kind, use_mlp_bias=bias)
    rng = np.random.default_rng(2)
    p = {"w_up": rng.standard_normal((32, 64)) / 6,
         "w_down": rng.standard_normal((64, 32)) / 8}
    if kind.endswith("gated"):
        p["w_gate"] = rng.standard_normal((32, 64)) / 6
    if bias:
        p["b_up"] = rng.standard_normal(64)
        p["b_down"] = rng.standard_normal(32)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _close(L.apply_mlp({k: _t(v) for k, v in p.items()}, pc, _t(x)),
           RL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, rc, x,
                        None))


def test_apply_connector_tanh_gelu():
    rc, pc = _cfgs()
    rng = np.random.default_rng(3)
    D, Fd = rc.d_model, 24
    rc, pc = rc.replace(d_model=40), pc.replace(d_model=40)
    p = {"w1": rng.standard_normal((Fd, 40)) / 5,
         "b1": rng.standard_normal(40),
         "w2": rng.standard_normal((40, 40)) / 6,
         "b2": rng.standard_normal(40)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    feats = rng.standard_normal((2, 6, Fd)).astype(np.float32)
    assert D == 1536
    _close(V.apply_connector({k: _t(v) for k, v in p.items()}, pc,
                             _t(feats)),
           RV.apply_connector({k: jnp.asarray(v) for k, v in p.items()}, rc,
                              feats))


def test_qkv_proj_with_bias():
    rc, pc = _cfgs(d_model=32, num_heads=6, num_kv_heads=2, head_dim=8)
    rng = np.random.default_rng(4)
    p = {"wq": rng.standard_normal((32, 6, 8)), "wk":
         rng.standard_normal((32, 2, 8)), "wv": rng.standard_normal((32, 2, 8)),
         "bq": rng.standard_normal((6, 8)), "bk": rng.standard_normal((2, 8)),
         "bv": rng.standard_normal((2, 8))}
    p = {k: (v / 4).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
    got = A.qkv_proj({k: _t(v) for k, v in p.items()}, pc, _t(x), _t(pos))
    want = RA.qkv_proj({k: jnp.asarray(v) for k, v in p.items()}, rc, x,
                       jnp.asarray(pos), None)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("G", [1, 2, 6])
def test_gqa_scores_softmax_pv(G):
    rng = np.random.default_rng(5)
    B, S, L_, Hkv, D = 2, 5, 9, 2, 16
    q = rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, L_, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L_, Hkv, D)).astype(np.float32)
    mask = np.asarray(RA.causal_mask(S, L_, offset=L_ - S))
    _close(A.gqa_scores_softmax_pv(_t(q), _t(k), _t(v), _t(mask)),
           RA.gqa_scores_softmax_pv(q, k, v, mask))
    np.testing.assert_array_equal(A.causal_mask(S, L_, L_ - S).numpy(),
                                  mask)


def _ragged_stores(rng, B, max_len, Hkv, D, W, lengths):
    """Per-slot tiered stores built by the reference's prefill writer
    (ragged per-slot lengths), plus the same stores as port tensors."""
    kf = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)

    def build(full):
        parts = [RKT.tiered_from_full(jnp.asarray(full[b:b + 1]), W,
                                      lengths[b] + 1, max_len)
                 for b in range(B)]
        return jax.tree.map(lambda *xs: np.concatenate(xs, 0), *parts)
    ks, vs = build(kf), build(vf)
    return ks, vs, {k: _t(a) for k, a in ks.items()}, \
        {k: _t(a) for k, a in vs.items()}


@pytest.mark.parametrize("G", [1, 2, 6])
def test_attend_tiered_and_plain_paged_decode_ragged_pos(G):
    """The reference's two-segment merge (per slot, scalar pos) against
    the port's attend_tiered and the plain paged-decode twin, both fed
    the (B,) per-slot position vector."""
    rng = np.random.default_rng(6)
    B, max_len, Hkv, D, W = 4, 40, 2, 16, 8
    lengths = [39, 20, 8, 3]
    ks, vs, pks, pvs = _ragged_stores(rng, B, max_len, Hkv, D, W, lengths)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    want = np.concatenate([
        np.asarray(RA.attend_tiered(
            CFG, q[b:b + 1], jax.tree.map(lambda x: x[b:b + 1], ks),
            jax.tree.map(lambda x: x[b:b + 1], vs), jnp.int32(lengths[b])))
        for b in range(B)])
    pos = torch.tensor(lengths)
    _close(A.attend_tiered(CFG, _t(q), pks, pvs, pos), want)
    table = KT.cold_page_table(pos, W, max_len, 16)
    o = PD.paged_decode_tiered_plain(
        _t(q[:, 0].reshape(B, Hkv, G, D)), pks["hot"], pvs["hot"],
        pks["cold_q"], pks["cold_scale"], pvs["cold_q"], pvs["cold_scale"],
        pos.int(), table, block_k=16)
    _close(o.reshape(B, 1, Hkv * G, D), want)
