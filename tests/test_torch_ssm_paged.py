"""PyTorch port: the recurrent archs (rwkv6-7b, zamba2-1.2b; reduced, f32)
over the paged prefix pool with its recurrent-state snapshots, under RRAM
weight streaming, and decode against the reference's full forward.

* Paged prefix sharing: the SSM `local` cases of the reference's
  `test_serving_paged.py` (a 32-token head on the chunk grid, the
  registering prompt equal to it, tails of 8). The port's engine equals
  the reference's — tokens, StepPlans, stats (prefix hits included),
  block-pool stats and per-block writes, endurance — and the slot
  pool's tokens. A recurrent chain's terminal block takes one extra
  write, the state snapshot (`prefix_save_state`), and a hit resumes
  from it (`prefix_load_state`).
* Weight streaming (`test_weight_stream.py`'s SSM cases): streamed ==
  resident == the reference streamed engine, whole and chunked; zamba2's
  shared attention block never streams; the streamed ledger equals
  `simulated_efficiency` and the reference's.
* `test_smoke_archs.py`'s recurrent case: the port's prefill then
  decode steps against the reference's full forward, 1e-3 (its
  tolerance there).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serving import Telemetry as RefTelemetry
from repro.serving import simulated_efficiency as ref_sim_eff
from repro_torch.configs.base import get_config
from repro_torch.models import Model
from repro_torch.models.counting import streamed_unit_indices, weight_units
from repro_torch.serving import Telemetry, simulated_efficiency
from test_torch_config import build_pair
from test_torch_paged import assert_paged_twins, drain_warm, \
    shared_head_requests
from test_torch_spill import assert_twins, make_requests, side, tokens

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("rwkv6-7b", "zamba2-1.2b")
# test_serving_paged.py's CASES for the recurrent archs
PAGED = {"rwkv6-7b": dict(head=32, tails=(0, 8, 8), gen=5, bt=32,
                          max_len=48, chunk=32),
         "zamba2-1.2b": dict(head=32, tails=(0, 8, 8), gen=5, bt=16,
                             max_len=48, chunk=16)}
# test_weight_stream.py's CASES for the recurrent archs
STREAM = {"rwkv6-7b": dict(specs=((40, 6), (35, 4)), max_len=48, chunk=32),
          "zamba2-1.2b": dict(specs=((40, 6), (24, 4)), max_len=48,
                              chunk=16)}


@functools.lru_cache(maxsize=None)
def _ref(scenario, arch, *args):
    return scenario(side(False, arch=arch), arch, *args)


# ---------------------------------------------------------------------------
# the paged prefix pool with state snapshots
# ---------------------------------------------------------------------------
def _shared_head(s, arch, chunk, paged=True):
    case = PAGED[arch]
    eng = s.Engine(s.backend(2, case["max_len"], block_tokens=case["bt"]),
                   chunk_tokens=chunk, paged=paged)
    return drain_warm(eng, shared_head_requests(
        s, case["head"], case["tails"], case["gen"]))


def _counted(s, name, calls):
    """``s`` whose backends count their calls of method ``name``."""
    make = s.backend

    def backend(*a, **kw):
        be = make(*a, **kw)
        fn = getattr(be, name)

        def wrapped(*fa, **fkw):
            calls.append(name)
            return fn(*fa, **fkw)
        setattr(be, name, wrapped)
        return be
    s.backend = backend
    return s


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matches_reference_and_slot_pool(arch, mode):
    case = PAGED[arch]
    chunk = None if mode == "whole" else case["chunk"]
    calls = []
    s = _counted(_counted(side(True, arch=arch), "prefix_save_state",
                          calls), "prefix_load_state", calls)
    eng, reqs = _shared_head(s, arch, chunk)
    assert_paged_twins(eng, reqs, *_ref(_shared_head, arch, chunk))
    n_sharers = len(case["tails"]) - 1
    assert eng.stats["prefix_hits"] == n_sharers
    assert eng.stats["prefix_hit_tokens"] >= n_sharers * case["head"]
    bp = eng.block_pool
    bp.check_invariants()
    assert bp.total_refcount == 0
    assert eng.endurance_report()["write_once_ok"]
    # the chain terminal's state was snapshot once and every hit
    # resumed from it
    assert calls.count("prefix_save_state") == 1
    assert calls.count("prefix_load_state") == n_sharers
    slot, sreqs = _shared_head(side(True, arch=arch), arch, chunk,
                               paged=False)
    assert slot.block_pool is None and tokens(reqs) == tokens(sreqs)


def test_ssm_state_snapshot_write_accounting():
    """A 32-token rwkv6 prompt registers 1 block (one write, though
    rwkv6 has no workspace rows to copy) plus 1 state snapshot: 2 writes
    on that block; sharers add none. The snapshot is all the block
    holds."""
    eng, _ = _shared_head(side(True, arch="rwkv6-7b"), "rwkv6-7b", None)
    bp = eng.block_pool
    assert eng.stats["prefix_hits"] == 2
    assert eng.stats["prefix_hit_tokens"] == 2 * PAGED["rwkv6-7b"]["head"]
    assert bp.stats["blocks_registered"] == 1
    assert bp.stats["block_writes"] == 2
    assert int(bp.block_writes.max()) == 2
    bp.check_invariants()
    assert not eng.backend.has_prefix_ws
    store = eng.pool.state.prefix
    assert set(store["u0"]) == {"tm", "cm_x_prev"}
    assert float(store["u0"]["tm"]["s"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# weight streaming
# ---------------------------------------------------------------------------
def _streamed(s, arch, W, chunk, telemetry=False):
    case = STREAM[arch]
    eng = s.Engine(s.backend(2, case["max_len"], weight_stream=W),
                   chunk_tokens=chunk,
                   telemetry=(None if not telemetry else
                              Telemetry() if s.port else RefTelemetry()))
    reqs = make_requests(s, list(case["specs"]), seed=3)
    eng.run(reqs, max_steps=400)
    assert len(eng.finished) == len(case["specs"])
    return eng, reqs


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_matches_resident_and_reference(arch, mode):
    chunk = None if mode == "whole" else STREAM[arch]["chunk"]
    s = side(True, arch=arch)
    eng, reqs = _streamed(s, arch, 1, chunk, True)
    be = eng.backend
    assert be.weight_stream == 1 and be.model.streamed_units()
    assert_twins(eng, reqs, *_ref(_streamed, arch, 1, chunk, True))
    resident, rreqs = _streamed(s, arch, 0, chunk)
    assert resident.backend.model.streamed_units() == ()
    assert tokens(reqs) == tokens(rreqs)
    assert eng.plans == resident.plans
    led = eng.telemetry.ledger.totals()
    sim = simulated_efficiency(be.sim_context()[0], eng.finished,
                               weight_stream=True)
    for k in ("sim_energy_j", "sim_total_s", "sim_energy_split_j"):
        assert led[k] == sim[k], k
    reng = _ref(_streamed, arch, 1, chunk, True)[0]
    assert sim == ref_sim_eff(reng.backend.sim_context()[0], reng.finished,
                              weight_stream=True)
    assert led == reng.telemetry.ledger.totals()


def test_shared_attention_units_never_stream():
    """Only the per-layer Mamba2 units stream; the one shared attention
    weight set stays DRAM-resident (and is no unit's parameters)."""
    cfg = get_config("zamba2-1.2b", reduced=True).replace(
        weight_stream_layers=1)
    assert [m for (m, _, _, _) in weight_units(cfg)] == [
        "mamba2", "attn_shared", "mamba2", "attn_shared"]
    assert streamed_unit_indices(cfg) == (0, 2)
    assert Model(cfg).streamed_units() == (0, 2)


# ---------------------------------------------------------------------------
# decode against the reference's full forward (test_smoke_archs.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_full_forward(arch):
    """Prefill 4 tokens then decode 4 on the port (flat store): each
    step's logits against the reference's whole-sequence forward at that
    position, rtol = atol = 1e-3 as the reference's smoke test holds its
    own recurrent decode."""
    _, rmodel, rparams, pc, model, params = build_pair(arch, "flat")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0,
                                       pc.vocab_size), np.int32)
    full = np.asarray(rmodel.forward(rparams, {"tokens": jnp.asarray(toks)}))
    logits, cache = model.prefill(params, {"tokens": toks[:, :4]}, 16)
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, 3],
                               rtol=1e-3, atol=1e-3)
    for i in range(4, 8):
        logits, cache = model.decode_step(params, toks[:, i:i + 1], cache, i)
        np.testing.assert_allclose(logits[:, -1].numpy(), full[:, i],
                                   rtol=1e-3, atol=1e-3)
