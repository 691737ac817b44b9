"""PyTorch port: the int8 cold-tier codec and the tiered KV store against
the JAX reference on the CPU.

Tolerance: exact. The int8 payloads, the f32 scales, the hot ring and
the endurance counters must match the reference bit for bit (both sides
use f32 true division and round-half-to-even), including per-slot
positions across the ring wrap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_tiers as RKT
from repro.core.quant import dequantize_per_token as r_dequant
from repro.core.quant import quantize_per_token as r_quant
from repro_torch.core import kv_tiers as KT
from repro_torch.core.quant import dequantize_per_token, quantize_per_token

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _eq(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_per_token_bit_exact(scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 2, 16)) * scale).astype(np.float32)
    x[0, 0] = 0.0                                 # all-zero rows: scale 1
    x[1, 2, 0, :4] = [0.5, -0.5, 1.5, 2.5]        # half-way values
    q, s = quantize_per_token(_t(x))
    rq, rs = r_quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        dequantize_per_token(q, s, torch.float32).numpy(),
        np.asarray(r_dequant(rq, rs, jnp.float32)))


@pytest.mark.parametrize("length", [3, 8, 20, 150])
def test_tiered_from_full_exact(length):
    rng = np.random.default_rng(1)
    S, max_len, W = 150, 300, 8
    full = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    _eq(KT.tiered_from_full(_t(full), W, length, max_len),
        RKT.tiered_from_full(jnp.asarray(full), W, length, max_len))


def test_tiered_append_per_slot_across_ring_wrap():
    """Prefill each slot at its own length, then a run of batched appends
    with a (B,) position vector crossing the ring wrap and an endurance
    block: every leaf equals the reference's per-slot scalar appends."""
    rng = np.random.default_rng(2)
    B, max_len, W, Hkv, D = 3, 160, 8, 2, 16
    starts = [5, 12, 126]
    full = rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
    ref = [RKT.tiered_from_full(jnp.asarray(full[b:b + 1]), W, starts[b],
                                max_len) for b in range(B)]
    port = {k: torch.cat([_t(r[k]) for r in ref]) for k in ref[0]}
    for step in range(12):
        new = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        pos = [s + step for s in starts]
        ref = [RKT.tiered_append(ref[b], jnp.asarray(new[b:b + 1]),
                                 jnp.int32(pos[b])) for b in range(B)]
        port = KT.tiered_append(port, _t(new), torch.tensor(pos))
    _eq(port, {k: np.concatenate([np.asarray(r[k]) for r in ref])
               for k in ref[0]})
    assert int(port["writes"].sum()) > 0


def test_tiered_append_scalar_pos_and_read():
    rng = np.random.default_rng(3)
    full = rng.standard_normal((2, 30, 2, 8)).astype(np.float32)
    ref = RKT.tiered_from_full(jnp.asarray(full), 8, 10, 40)
    port = KT.tiered_from_full(_t(full), 8, 10, 40)
    for pos in range(10, 25):
        new = rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
        ref = RKT.tiered_append(ref, jnp.asarray(new), pos)
        port = KT.tiered_append(port, _t(new), pos)
    _eq(port, ref)
    vals, valid = KT.tiered_read(port, 24, torch.float32)
    rvals, rvalid = RKT.tiered_read(ref, 24, jnp.float32)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))


@pytest.mark.parametrize("pos", [0, 7, 8, 130, 300])
def test_page_table_and_ring_positions(pos):
    np.testing.assert_array_equal(
        KT.cold_page_table(pos, 8, 300, 128).numpy(),
        np.asarray(RKT.cold_page_table(pos, 8, 300, 128)))
    np.testing.assert_array_equal(
        KT.hot_ring_positions(pos, 8).numpy(),
        np.asarray(RKT.hot_ring_positions(pos, 8)))
    vec = KT.cold_page_table(torch.tensor([pos, 3]), 8, 300, 128)
    assert vec.shape == (2, KT.n_cold_pages(300, 128))
    np.testing.assert_array_equal(
        vec[0].numpy(), np.asarray(RKT.cold_page_table(pos, 8, 300, 128)))


def test_endurance_report_and_expected_writes():
    rng = np.random.default_rng(4)
    full = rng.standard_normal((2, 400, 1, 8)).astype(np.float32)
    ref = RKT.tiered_from_full(jnp.asarray(full), 16, 300, 512)
    port = KT.tiered_from_full(_t(full), 16, 300, 512)
    for pos in range(300, 420):
        new = rng.standard_normal((2, 1, 1, 8)).astype(np.float32)
        ref = RKT.tiered_append(ref, jnp.asarray(new), pos)
        port = KT.tiered_append(port, _t(new), pos)
    rep, rrep = KT.endurance_report(port), RKT.endurance_report(ref)
    for k in rrep:
        np.testing.assert_array_equal(rep[k].numpy(), np.asarray(rrep[k]))
    for args in [(4, 16, 300, 420), (4, 16, 0, 0), (3, 128, 500, 520)]:
        np.testing.assert_array_equal(
            KT.expected_block_writes(*args).numpy(),
            np.asarray(RKT.expected_block_writes(*args)))
    np.testing.assert_array_equal(
        port["writes"][0].numpy(),
        KT.expected_block_writes(4, 16, 300, 420).numpy())


@pytest.mark.parametrize("policy", ["flat", "tiered"])
def test_store_dispatch(policy):
    rng = np.random.default_rng(5)
    full = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    port = KT.store_from_full(_t(full), policy, 4, 12, 20)
    ref = RKT.store_from_full(jnp.asarray(full), policy, 4, 12, 20)
    new = rng.standard_normal((1, 1, 2, 8)).astype(np.float32)
    port = KT.store_append(port, _t(new), 12)
    ref = RKT.store_append(ref, jnp.asarray(new), 12)
    _eq(port, ref)
    vals, valid = KT.store_read(port, 12, torch.float32)
    rvals, rvalid = RKT.store_read(ref, 12, jnp.float32)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    init = KT.store_init(2, 20, (2, 8), policy, 4, torch.float32)
    rinit = RKT.store_init(2, 20, (2, 8), policy, 4, jnp.float32)
    _eq(init, rinit)
