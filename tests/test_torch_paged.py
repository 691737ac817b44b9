"""PyTorch port: the paged prefix pool (shared system prompt, shared
image), against the JAX reference engine.

Each scenario runs through the port's `Engine` over `LocalBackend` on
the CPU and through the reference's, with the same f32 weights
(`build_pair`) and the same request stream, and the two must agree
exactly: token streams, every StepPlan, `Engine.stats` (prefix hits and
hit tokens included), the block pool's stats and per-block physical
writes, and the endurance report; where a Telemetry hub rides along,
the ledgers too. The reference runs are memoized per session.

The scenarios are the GQA `local` cases of the reference's
`test_serving_paged.py` on the architectures the port serves
(granite-3-2b and mobilevlm-1.7b, reduced), plus two traps of the port's
own in-place tensors: the prefix store lives on the backend's device,
and a hit admission never writes into the shared zero workspace.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.serving import Telemetry as RefTelemetry
from repro.serving import simulated_efficiency as ref_sim_eff
from repro_torch.serving import (LocalBackend, Telemetry, parse_prometheus,
                                 simulated_efficiency)
from repro_torch.tree import tree_leaves
from test_torch_config import build_pair
from test_torch_spill import side, tokens

jax.config.update("jax_platform_name", "cpu")

# granite-3-2b's geometry in the reference suite: ``head`` is the shared
# prompt prefix, ``tails`` the per-request unique suffix lengths
# (request 0 registers the chain, the rest share it)
HEAD, TAILS, GEN, BT, MAX_LEN, CHUNK = 12, (4, 1, 4), 5, 4, 24, 6


def shared_head_requests(s, head, tails, gen, seed=3, priorities=None):
    """Requests sharing a ``head``-token prompt prefix, with unique random
    tails of the given lengths (the reference suite's stream)."""
    rng = np.random.default_rng(seed)
    head_toks = rng.integers(0, s.cfg.vocab_size, head).astype(np.int32)
    reqs = []
    for i, tail in enumerate(tails):
        toks = head_toks if tail == 0 else np.concatenate(
            [head_toks,
             rng.integers(0, s.cfg.vocab_size, tail).astype(np.int32)])
        reqs.append(s.Request(
            rid=i, tokens=np.asarray(toks, np.int32), max_new_tokens=gen,
            priority=0 if priorities is None else priorities[i]))
    return reqs


def drain_warm(eng, reqs):
    """Drain the chain-registering request first, then the sharers
    together, so every sharer's admission probe sees the chain."""
    eng.submit(reqs[0])
    while not eng.idle:
        eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    while not eng.idle:
        eng.step()
    return eng, reqs


def assert_paged_twins(eng, reqs, reng, rreqs):
    """The port's paged engine equals the reference's after a scenario."""
    assert eng.plans == reng.plans
    assert tokens(reqs) == tokens(rreqs)
    assert eng.stats == reng.stats
    assert eng.endurance_report() == reng.endurance_report()
    assert [r.prefix_hit for r in reqs] == [r.prefix_hit for r in rreqs]
    bp, rbp = eng.block_pool, reng.block_pool
    assert (bp is None) == (rbp is None)
    if bp is not None:
        assert bp.stats == rbp.stats
        assert bp.block_writes.tolist() == \
            np.asarray(rbp.block_writes).tolist()
        assert (bp.used_blocks, bp.pinned_blocks, bp.total_refcount) == \
            (rbp.used_blocks, rbp.pinned_blocks, rbp.total_refcount)


_REF: dict = {}


def twin(scenario, *args, **side_kw):
    """Run ``scenario(side, *args) -> (engine, requests)`` on the port and
    on the reference (memoized per session), assert they agree, and
    return the port's result."""
    key = (scenario.__name__, args, tuple(sorted(side_kw.items())))
    if key not in _REF:
        _REF[key] = scenario(side(False, **side_kw), *args)
    port = scenario(side(True, **side_kw), *args)
    assert_paged_twins(*port, *_REF[key])
    return port


def slot_tokens(scenario, *args, **side_kw):
    """The port's slot-pool (paged=False) tokens on the same stream."""
    eng, reqs = scenario(side(True, **side_kw), *args, paged=False)
    assert eng.block_pool is None and eng.stats["prefix_hits"] == 0
    return tokens(reqs)


def check_paged(eng, n_sharers, head):
    assert eng.stats["prefix_hits"] == n_sharers
    assert eng.stats["prefix_hit_tokens"] >= n_sharers * head
    bp = eng.block_pool
    bp.check_invariants()
    assert bp.total_refcount == 0, "refcounts leaked past drain"
    assert int(bp.block_writes.max()) <= 1
    assert eng.endurance_report()["write_once_ok"]


# ---------------------------------------------------------------------------
# exact parity: whole and chunked prefill (GQA, local)
# ---------------------------------------------------------------------------
def _shared_head(s, chunk, paged=True):
    eng = s.Engine(s.backend(2, MAX_LEN, block_tokens=BT),
                   chunk_tokens=chunk, paged=paged)
    return drain_warm(eng, shared_head_requests(s, HEAD, TAILS, GEN))


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunked"])
def test_paged_matches_reference_and_slot_pool(chunk):
    eng, reqs = twin(_shared_head, chunk)
    check_paged(eng, len(TAILS) - 1, HEAD)
    assert tokens(reqs) == slot_tokens(_shared_head, chunk)


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunked"])
def test_paged_matches_reference_and_slot_pool_mla(chunk):
    """deepseek-v2-lite (the reference's MLA case, granite's geometry):
    the prefix blocks hold the latent workspaces."""
    mla = dict(arch="deepseek-v2-lite")
    eng, reqs = twin(_shared_head, chunk, **mla)
    check_paged(eng, len(TAILS) - 1, HEAD)
    assert tokens(reqs) == slot_tokens(_shared_head, chunk, **mla)
    assert set(eng.pool.state.prefix["u1"]) == {"c_kv_ws", "k_rope_ws"}


def _shared_image(s, paged=True):
    """Many questions about ONE image: the visual span plus an 8-token
    text head are shared; tails of 4, 2 and 4 tokens."""
    f = s.cfg.frontend
    rng = np.random.default_rng(5)
    patches = np.asarray(rng.standard_normal((f.num_tokens,
                                              f.frontend_dim)), np.float32)
    head = rng.integers(0, s.cfg.vocab_size, 8).astype(np.int32)
    streams = [np.concatenate([head, rng.integers(0, s.cfg.vocab_size, t)
                               .astype(np.int32)]) for t in (4, 2, 4)]
    reqs = [s.Request(rid=i, tokens=toks, patches=patches.copy(),
                      max_new_tokens=4) for i, toks in enumerate(streams)]
    max_len = f.num_tokens + 12 + 4 + 4
    eng = s.Engine(s.backend(2, max_len, block_tokens=4), paged=paged)
    return drain_warm(eng, reqs)


def test_shared_image_vlm_matches_reference_and_slot_pool():
    kw = dict(arch="mobilevlm-1.7b", hot_window=16)
    eng, reqs = twin(_shared_image, **kw)
    tv = eng.backend.model.cfg.frontend.num_tokens
    check_paged(eng, 2, tv + 8)          # the image and the text head
    assert tokens(reqs) == slot_tokens(_shared_image, **kw)


# ---------------------------------------------------------------------------
# copy-on-write and write-once
# ---------------------------------------------------------------------------
def _cow(s, paged=True):
    """Two prompts diverging strictly INSIDE block [8, 12)."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, s.cfg.vocab_size, 12).astype(np.int32)
    fork = base.copy()
    fork[10] = (fork[10] + 1) % s.cfg.vocab_size
    reqs = [s.Request(rid=0, tokens=base, max_new_tokens=4),
            s.Request(rid=1, tokens=fork, max_new_tokens=4)]
    eng = s.Engine(s.backend(2, 20, block_tokens=4), paged=paged)
    return drain_warm(eng, reqs)


def test_cow_divergence_mid_block():
    eng, reqs = twin(_cow)
    bp = eng.block_pool
    assert eng.stats["prefix_hits"] == 1 and reqs[1].prefix_hit == 10
    assert bp.stats["cow_copies"] == 1
    assert bp.stats["blocks_registered"] == bp.stats["block_writes"] == 4
    assert int(bp.block_writes.max()) == 1
    bp.check_invariants()
    assert tokens(reqs) == slot_tokens(_cow)


def _n_way(s):
    """Five identical prompts, one at a time: the first writes 4 blocks,
    the other four adopt them."""
    toks = np.random.default_rng(2).integers(0, s.cfg.vocab_size, 16)
    eng = s.Engine(s.backend(2, 24, block_tokens=4), paged=True)
    reqs = []
    for i in range(5):
        reqs.append(s.Request(rid=i, tokens=toks.astype(np.int32),
                              max_new_tokens=4))
        eng.submit(reqs[-1])
        while not eng.idle:
            eng.step()
    return eng, reqs


def test_shared_blocks_written_once_n_way():
    eng, reqs = twin(_n_way)
    bp = eng.block_pool
    assert eng.stats["prefix_hits"] == 4
    assert bp.stats["blocks_registered"] == bp.stats["block_writes"] == 4
    assert int(bp.block_writes.max()) == 1
    assert bp.max_refcount == 0
    bp.check_invariants()
    assert len({tuple(r.generated) for r in reqs}) == 1


def test_prefix_state_copies_never_run_on_attention_plans():
    """`prefix_save_state` / `prefix_load_state` are the recurrent-state
    snapshots; an attention-only plan has no state leaf, so a paged run
    never calls them, and called directly they move nothing."""
    s = side(True)
    calls = []
    eng = s.Engine(s.backend(2, 24, block_tokens=4), paged=True)
    be = eng.backend
    for name in ("prefix_save_state", "prefix_load_state"):
        setattr(be, name, lambda *a, _n=name: calls.append(_n))
    drain_warm(eng, shared_head_requests(s, HEAD, TAILS, GEN))
    assert eng.stats["prefix_hits"] == 2 and calls == []
    assert not be.requires_exact_prefill and be.has_prefix_ws
    state = eng.pool.state
    ext = LocalBackend.prefix_load_state(be, state, be.fresh_extend(), 0)
    assert all(a is b for a, b in zip(tree_leaves(ext),
                                      tree_leaves(be.fresh_extend())))
    before = [t.clone() for t in tree_leaves(state.prefix)]
    LocalBackend.prefix_save_state(be, state, ext, 0)
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves(state.prefix)))


# ---------------------------------------------------------------------------
# preemption, admission
# ---------------------------------------------------------------------------
def _preempted(s, paged=True):
    """A priority-1 sharer lands mid-run and preempts a priority-0
    victim into an RRAM spill lane."""
    reqs = shared_head_requests(s, 12, (4, 1, 2, 3), gen=8, seed=4,
                                priorities=(0, 0, 0, 1))
    eng = s.Engine(s.backend(2, 24, n_spill=2, block_tokens=4),
                   paged=paged)
    eng.submit(reqs[0])
    while not eng.idle:
        eng.step()
    for r in reqs[1:3]:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.submit(reqs[3])
    while not eng.idle:
        eng.step()
    return eng, reqs


def test_paged_parity_under_preemption():
    eng, reqs = twin(_preempted)
    assert eng.stats["evictions"] >= 1, "the trace never preempted"
    assert eng.stats["prefix_hits"] >= 3
    eng.block_pool.check_invariants()
    assert eng.block_pool.total_refcount == 0
    assert eng.endurance_report()["write_once_ok"]
    assert tokens(reqs) == slot_tokens(_preempted)


def _admission(s, paged=True):
    """A DRAM budget of 2 worst-case slot images, 4 slots; the peak
    concurrency rides on the engine."""
    backend = s.backend(4, 28, block_tokens=4)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(
        s.CapacityBudget(2 * hot_b, 16 * (hot_b + cold_b)), hot_b, cold_b)
    eng = s.Engine(backend, scheduler=sched, paged=paged)
    reqs = shared_head_requests(s, 20, (4, 1, 2, 3), gen=4, seed=6)
    eng.submit(reqs[0])
    while not eng.idle:
        eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.peak = 0
    while not eng.idle:
        eng.step()
        eng.peak = max(eng.peak, eng.pool.active_slots)
    return eng, reqs


def test_block_charged_admission_beats_slot_charging():
    eng, reqs = twin(_admission, hot_window=28)
    slot_eng, slot_reqs = _admission(side(True, hot_window=28), paged=False)
    assert tokens(reqs) == tokens(slot_reqs)
    assert slot_eng.peak == 2, "worst-case charging caps at the budget"
    assert eng.peak == 3, f"block charging admitted {eng.peak} sharers"


def _no_wedge(s):
    """An RRAM budget with no headroom over two residents: only pinned
    blocks may charge it, so wave after wave still admits."""
    backend = s.backend(4, 24, block_tokens=4)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 2 * cold_b),
                            hot_b, cold_b, oversubscribe=1.0)
    eng = s.Engine(backend, scheduler=sched, paged=True)
    reqs = shared_head_requests(s, 12, (4, 1, 4, 2, 3), gen=4, seed=9)
    eng.run(list(reqs), max_steps=300)
    return eng, reqs


def test_cached_blocks_do_not_wedge_admission():
    eng, reqs = twin(_no_wedge)
    assert len(eng.finished) == 5
    assert eng.block_pool.pinned_blocks == 0
    assert eng.block_pool.used_blocks > 0, "the cache should stay warm"


# ---------------------------------------------------------------------------
# the ledger: tail-only prefills + prefix adoption, priced exactly
# ---------------------------------------------------------------------------
def _ledgered(s):
    s.tel = (Telemetry if s.port else RefTelemetry)()
    eng = s.Engine(s.backend(2, MAX_LEN, block_tokens=BT), paged=True,
                   telemetry=s.tel)
    eng.tel = s.tel
    return drain_warm(eng, shared_head_requests(s, HEAD, TAILS, GEN))


def test_paged_ledger_reconciles_with_reference(tmp_path):
    eng, _ = twin(_ledgered)
    reng, _ = _REF[("_ledgered", (), ())]
    tel, rtel = eng.tel, reng.tel
    assert eng.stats["prefix_hits"] == 2
    led = tel.ledger.totals()
    sim = simulated_efficiency(eng.backend.sim_context()[0], eng.finished)
    for k in ("sim_energy_j", "sim_total_s", "sim_energy_split_j"):
        assert led[k] == sim[k], k
    assert led["prefix_adopt_bytes"] > 0
    assert led == rtel.ledger.totals()
    assert tel.ledger.steps == rtel.ledger.steps
    assert sim == ref_sim_eff(reng.backend.sim_context()[0], reng.finished)
    path = tmp_path / "metrics.prom"
    tel.write_prometheus(str(path))
    by = {name: v for name, _, v in parse_prometheus(path.read_text())}
    assert by["repro_serving_prefix_hits"] == 2
    assert by["repro_serving_prefix_hit_tokens"] == \
        eng.stats["prefix_hit_tokens"]
    assert "repro_serving_prefix_blocks_used" in by
    assert "repro_serving_prefix_cow_copies" in by
    tel.close()


# ---------------------------------------------------------------------------
# the port's traps: the store's device, the shared zero workspace
# ---------------------------------------------------------------------------
def test_prefix_store_lives_on_the_backend_device():
    """`init_extend_cache` defaults to the CPU; the store must be built
    on ``backend.device`` (here the meta device, where a CPU leaf would
    show), with the block geometry and per-block bytes of the
    reference's."""
    _, rmodel, rparams, _, model, params = build_pair()
    be = LocalBackend(model, params, 2, 24, device="meta", block_tokens=4)
    state = be.ensure_prefix(be.init_pool())
    leaves = tree_leaves(state.prefix)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert be.ensure_prefix(state) is state
    assert state.prefix_axes == be._ext_axes
    assert leaves[0].shape[:3] == (model.plan[0].repeats, be.prefix_blocks,
                                   4)
    from repro.serving import LocalBackend as RefBackend
    ref = RefBackend(rmodel, rparams, 2, 24, block_tokens=4)
    assert (be.block_tokens, be.prefix_blocks, be.prefix_block_bytes()) \
        == (ref.block_tokens, ref.prefix_blocks, ref.prefix_block_bytes())
    dflt = LocalBackend(model, params, 2, 512, device="meta")
    rdflt = RefBackend(rmodel, rparams, 2, 512)
    assert (dflt.block_tokens, dflt.prefix_blocks) == \
        (rdflt.block_tokens, rdflt.prefix_blocks) == (128, 8)
    for bad in (dict(block_tokens=0), dict(prefix_blocks=0)):
        with pytest.raises(ValueError):
            LocalBackend(model, params, 2, 24, device="meta", **bad)


def _hit_then_cold(s):
    """A registering request, a sharer admitted on a hit, then a cold
    request with a prompt of its own. On the port the zero workspace of
    `fresh_extend` is checked after the hit admission."""
    reqs = shared_head_requests(s, HEAD, (4, 2), GEN, seed=7)
    cold = s.Request(rid=2, max_new_tokens=GEN, tokens=np.random.default_rng(
        8).integers(0, s.cfg.vocab_size, 10).astype(np.int32))
    eng = s.Engine(s.backend(2, MAX_LEN, block_tokens=BT), paged=True)
    drain_warm(eng, reqs)
    if s.port:
        assert eng.stats["prefix_hits"] == 1
        assert all(not t.any() for t in tree_leaves(
            eng.backend.fresh_extend())), \
            "a hit admission wrote into the shared zero workspace"
    eng.submit(cold)
    while not eng.idle:
        eng.step()
    return eng, reqs + [cold]


def test_hit_admission_leaves_zero_workspace_for_cold_admissions():
    eng, reqs = twin(_hit_then_cold)
    assert eng.stats["prefix_hits"] == 1 and reqs[2].prefix_hit == 0
    assert all(not t.any() for t in tree_leaves(eng.backend.fresh_extend()))
