"""PyTorch port: the CHIME mapping plan, the analytic simulator and the
spill codec, against the JAX reference.

The planner and `chime_sim` are pure Python over the config; the port's
copies must give the reference's numbers exactly (`==`, no tolerance):
`math.fsum` folds and term order are kept, so any drift is a porting
fault. The spill codec must give the reference's int8 payload and
scales bit for bit, and its round trip must stay within
`spill_codec_bound`.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.core import kv_tiers as RKT
from repro.core import quant as RQ
from repro.core.planner import plan_for as ref_plan_for
from repro.serving import Request as RefRequest
from repro.serving import simulated_efficiency as ref_sim_eff
from repro.simulator import chime_sim as RS
from repro.simulator import hardware as RH
from repro_torch.configs.base import get_config
from repro_torch.core import kv_tiers as KT
from repro_torch.core import quant as Q
from repro_torch.core.planner import plan_for
from repro_torch.serving import Request, simulated_efficiency
from repro_torch.simulator import chime_sim as S
from repro_torch.simulator import hardware as H

jax.config.update("jax_platform_name", "cpu")

PAPER_ARCHS = ("granite-3-2b", "fastvlm-0.6b", "fastvlm-1.7b",
               "mobilevlm-1.7b", "mobilevlm-3b")
PLATFORMS = ("CHIME", "DRAM_ONLY", "JETSON_ORIN_NX")


def _cfgs(arch: str, **knobs):
    return (ref_get_config(arch).replace(**knobs),
            get_config(arch).replace(**knobs))


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_plan_matches_reference(arch):
    rc, pc = _cfgs(arch)
    ref, mine = ref_plan_for(rc), plan_for(pc)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    mine.audit()
    assert mine.cross_domain_tensors_per_layer() == \
        ref.cross_domain_tensors_per_layer()
    for dtype_bytes in (1, 2, 4):
        assert mine.cross_domain_bytes_per_token(pc, dtype_bytes) == \
            ref.cross_domain_bytes_per_token(rc, dtype_bytes)
    # CHIME's invariant: two activation-only cut points per layer
    assert set(mine.cross_domain_tensors_per_layer().values()) == {2}


def test_plan_audit_rejects_a_third_cut_point():
    plan = plan_for(get_config("granite-3-2b"))
    lp = plan.layers[0]
    bad = dataclasses.replace(
        plan, layers=(dataclasses.replace(
            lp, cut_points=lp.cut_points + ("Extra",)),))
    with pytest.raises(AssertionError, match="cut points > 2"):
        bad.audit()


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_simulate_matches_reference(arch, platform):
    rc, pc = _cfgs(arch)
    for wl in ((128, 488, True), (64, 16, False)):
        ref = RS.simulate(rc, getattr(RH, platform), RS.Workload(*wl))
        mine = S.simulate(pc, getattr(H, platform), S.Workload(*wl))
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.tokens_per_j > 0 and mine.total_s > 0


@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
@pytest.mark.parametrize("arch", ["fastvlm-1.7b", "mobilevlm-3b"])
def test_cost_terms_match_reference(arch, kv_policy):
    """Every term function the serving ledger prices with: the same
    CostTerm tuples, in the same order."""
    rc, pc = _cfgs(arch, kv_policy=kv_policy, kv_hot_window=128)
    for plat in PLATFORMS:
        rp, pp = getattr(RH, plat), getattr(H, plat)
        rl, pl = RS.cost_layers(rc), S.cost_layers(pc)
        assert pl == rl
        for ctx in (1, 127, 128, 129, 300, 511):
            for fused, tau in ((False, 0.0), (True, 0.0), (True, 1e-3)):
                assert S.decode_token_terms(
                    pc, pp, ctx, pl, fused=fused, sparse_tau=tau) == \
                    RS.decode_token_terms(rc, rp, ctx, rl, fused=fused,
                                          sparse_tau=tau)
            for restore in (False, True):
                for comp in (False, True):
                    assert S.spill_terms(pc, pp, ctx, restore=restore,
                                         compressed=comp) == \
                        RS.spill_terms(rc, rp, ctx, restore=restore,
                                       compressed=comp)
            assert S.prefix_adopt_terms(pc, pp, ctx) == \
                RS.prefix_adopt_terms(rc, rp, ctx)
        for text, image, cached in ((112, True, 0), (256, False, 0),
                                    (256, False, 128)):
            assert S.prefill_terms(pc, pp, text, image, pl,
                                   cached_prefix=cached) == \
                RS.prefill_terms(rc, rp, text, image, rl,
                                 cached_prefix=cached)
            terms = S.request_terms(pc, pp, text, 24, image, pl,
                                    cached_prefix=cached, fused=True)
            assert terms == RS.request_terms(rc, rp, text, 24, image, rl,
                                             cached_prefix=cached,
                                             fused=True)
            assert S.closing_terms(pp, terms) == RS.closing_terms(rp, terms)
            assert S.sum_terms(terms) == RS.sum_terms(terms)


def test_spill_terms_compressed_moves_fewer_bytes():
    _, pc = _cfgs("mobilevlm-3b", kv_policy="tiered", kv_hot_window=128)
    full = S.sum_terms(S.spill_terms(pc, H.CHIME, 300))
    comp = S.sum_terms(S.spill_terms(pc, H.CHIME, 300, compressed=True))
    assert 0 < comp["sim_spill_energy_j"] < full["sim_spill_energy_j"]


def _finished(cls, cfg, seed: int):
    """Synthetic finished requests (prompt, generated count, image flag,
    eviction contexts) for pricing; no model runs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        n = int(rng.integers(3, 40))
        r = cls(rid=i, tokens=np.zeros(n, np.int32),
                max_new_tokens=int(rng.integers(0, 20)),
                patches=(np.zeros((cfg.frontend.num_tokens,
                                   cfg.frontend.frontend_dim), np.float32)
                         if i % 2 == 0 else None))
        r.generated = [1] * r.max_new_tokens
        r.evict_ctx = [int(c) for c in rng.integers(4, 60,
                                                   int(rng.integers(0, 3)))]
        out.append(r)
    return out


@pytest.mark.parametrize("spill_compressed", [False, True])
@pytest.mark.parametrize("arch", ["fastvlm-1.7b", "mobilevlm-3b"])
def test_simulated_efficiency_matches_reference(arch, spill_compressed):
    rc, pc = _cfgs(arch, kv_policy="tiered", kv_hot_window=128)
    for fused, tau in ((None, None), (True, 0.0), (True, 1e-3)):
        ref = ref_sim_eff(rc, _finished(RefRequest, rc, 4),
                          spill_compressed=spill_compressed,
                          fused_decode=fused, sparse_read_tau=tau)
        mine = simulated_efficiency(pc, _finished(Request, pc, 4),
                                    spill_compressed=spill_compressed,
                                    fused_decode=fused, sparse_read_tau=tau)
        assert mine == ref
        assert mine["sim_spills"] > 0 and mine["sim_tokens_per_j"] > 0
        assert mine["sim_weight_stream"] is False


# ---------------------------------------------------------------------------
# spill codec and spill endurance accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 2, 16), (1, 3, 5, 4, 64),
                                   (4, 1, 128)])
def test_spill_codec_round_trip_within_bound(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape)
         * rng.uniform(0.01, 30.0, shape[:-1] + (1,))).astype(np.float32)
    x[0, ..., 0, :] = 0.0                       # all-zero rows come back
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jax.numpy.asarray(x).astype(dtype)
    q, s = Q.compress_spill_hot(xt)
    rq, rs = RQ.compress_spill_hot(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    back = Q.decompress_spill_hot(q, s, torch.float32)
    bound = Q.spill_codec_bound(xt)
    np.testing.assert_array_equal(bound.numpy(),
                                  np.asarray(RQ.spill_codec_bound(xj)))
    # the bound up to f32 rounding of q * scale, as the reference's
    # spill tests hold it
    err = (back - xt.float()).abs()
    assert bool((err <= bound * (1 + 1e-4) + 1e-7).all())
    assert float(err[0, ..., 0, :].max()) == 0.0


def test_spill_block_writes_unit():
    nb = KT.n_endurance_blocks(512)
    assert nb == 4
    for length, want in ((0, [0, 0, 0, 0]), (1, [1, 0, 0, 0]),
                         (128, [1, 0, 0, 0]), (129, [1, 1, 0, 0])):
        got = KT.spill_block_writes(nb, length)
        assert got.tolist() == want
        assert got.tolist() == np.asarray(
            RKT.spill_block_writes(nb, length)).tolist()
    assert KT.expected_spill_block_writes(nb, [129, 300, 512]).tolist() \
        == [3, 3, 2, 1]
    w = KT.bump_spill_writes(KT.init_spill_writes(3, 512), 1, 300)
    assert w.tolist() == [[0] * 4, [1, 1, 1, 0], [0] * 4]
    assert w.tolist() == np.asarray(RKT.bump_spill_writes(
        RKT.init_spill_writes(3, 512), 1, 300)).tolist()
