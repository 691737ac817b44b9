"""PyTorch port: the recurrent archs (rwkv6-7b, zamba2-1.2b; reduced, f32)
through the serving engine — chunked prefill, preemption and idle
offload into RRAM spill lanes — against the JAX reference engine.

Each scenario is an SSM `local` case of the reference's suites
(`test_serving_chunked.py`, `test_serving_preempt.py`,
`test_serving_spill.py`: the same prompt / generation lengths, slot
lengths, chunk caps and request seeds), run through the port's `Engine`
over `LocalBackend` and through the reference's with the same weights
(`build_pair`). The two must agree exactly: token streams, every
StepPlan, `Engine.stats`, the endurance report and the spill lanes'
write counters (`test_torch_spill.assert_twins`). The recurrent plans
prefill exact lengths on the ``cfg.ssm.chunk_size`` grid, and the
recurrent states ride the spill lanes verbatim, compressed lanes too.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro_torch.serving import LocalBackend
from repro_torch.tree import tree_leaves_with_path, tree_map
from test_torch_config import build_pair
from test_torch_spill import (_preempted, assert_twins, make_requests,
                              side, tokens)

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("rwkv6-7b", "zamba2-1.2b")
# test_serving_chunked.py's ARCH_CASES, test_serving_preempt.py's and
# test_serving_spill.py's CASES for the recurrent archs
CHUNKED = {"rwkv6-7b": dict(specs=((40, 6), (35, 4)), max_len=48, chunk=32),
           "zamba2-1.2b": dict(specs=((40, 6), (24, 4)), max_len=48,
                               chunk=16)}
PREEMPT = {"rwkv6-7b": dict(specs=((40, 8), (40, 8), (32, 4)), max_len=48,
                            chunk=32),
           "zamba2-1.2b": dict(specs=((24, 8), (24, 8), (16, 4)),
                               max_len=48, chunk=16)}
SPILL = {"rwkv6-7b": dict(specs=((40, 8), (40, 8), (32, 5)), max_len=48,
                          chunk=32),
         "zamba2-1.2b": dict(specs=((24, 8), (24, 8), (16, 5)), max_len=48,
                             chunk=16)}
STATE_KEYS = ("s", "x_prev", "cm_x_prev", "conv", "ssm")


def _twin(scenario, arch, *args):
    """``scenario`` on the port and on the reference (memoized), asserted
    equal; returns the port's (engine, requests)."""
    port = scenario(side(True, arch=arch), arch, *args)
    assert_twins(*port, *_ref(scenario, arch, *args))
    return port


@functools.lru_cache(maxsize=None)
def _ref(scenario, arch, *args):
    return scenario(side(False, arch=arch), arch, *args)


# ---------------------------------------------------------------------------
# chunked prefill == whole prefill (test_serving_chunked.py)
# ---------------------------------------------------------------------------
def _served(s, arch, chunk):
    case = CHUNKED[arch]
    eng = s.Engine(s.backend(2, case["max_len"]), chunk_tokens=chunk)
    reqs = make_requests(s, list(case["specs"]), seed=3)
    eng.run(reqs, max_steps=900)
    return eng, reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_whole_and_reference(arch):
    """Whole-prompt and chunked engines each equal the reference's; the
    chunk cap forces multi-chunk prompts on the grid, and chunked ==
    whole token for token."""
    whole, wreqs = _twin(_served, arch, None)
    chunked, creqs = _twin(_served, arch, CHUNKED[arch]["chunk"])
    assert tokens(creqs) == tokens(wreqs)
    assert chunked.stats["prefill_chunks"] > len(creqs)
    assert chunked.backend.requires_exact_prefill
    assert chunked.backend.chunk_unit == build_pair(arch)[3].ssm.chunk_size
    assert chunked.endurance_report()["write_once_ok"]


# ---------------------------------------------------------------------------
# preemption (test_serving_preempt.py)
# ---------------------------------------------------------------------------
def _preempt_case(s, arch, chunk):
    case = PREEMPT[arch]
    return _preempted(s, chunk, case["max_len"], case["specs"])


@pytest.mark.parametrize("chunk", ["whole", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_restore_matches_reference(arch, chunk):
    chunk = 0 if chunk == "whole" else PREEMPT[arch]["chunk"]
    eng, reqs = _twin(_preempt_case, arch, chunk)
    assert eng.stats["evictions"] >= 1
    assert eng.stats["restores"] == eng.stats["evictions"]
    assert len(eng.finished) == 3
    victims = [r for r in reqs if r.n_evictions]
    assert victims and all(r.priority == 0 for r in victims)
    assert eng.endurance_report()["write_once_ok"]
    lanes = eng.pool.state.spill
    assert any(p[-1] in STATE_KEYS for p, _ in tree_leaves_with_path(lanes))


# ---------------------------------------------------------------------------
# idle offload, verbatim and compressed lanes (test_serving_spill.py)
# ---------------------------------------------------------------------------
def _offload_case(s, arch, chunk, compress):
    """Three equal-priority requests on two slots: the third is admitted
    only by parking an idle runner (idle after 2 steps)."""
    case = SPILL[arch]
    backend = s.backend(2, case["max_len"], spill_compress=compress)
    hot_b, cold_b = backend.slot_kv_bytes()
    sched = s.FCFSScheduler(s.CapacityBudget(2 * hot_b, 1e15), hot_b,
                            cold_b, oversubscribe=1.0, idle_offload_steps=2,
                            lane_bytes=backend.spill_lane_bytes())
    eng = s.Engine(backend, scheduler=sched, chunk_tokens=chunk)
    reqs = make_requests(s, list(case["specs"]), seed=3)
    eng.run(reqs, max_steps=500)
    return eng, reqs


@pytest.mark.parametrize("chunk,compress", [("whole", False),
                                            ("chunked", False),
                                            ("whole", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_idle_offload_matches_reference(arch, chunk, compress):
    chunk = 0 if chunk == "whole" else SPILL[arch]["chunk"]
    eng, reqs = _twin(_offload_case, arch, chunk, compress)
    assert eng.stats["idle_offloads"] >= 1 and eng.stats["evictions"] == 0
    assert eng.stats["restores"] == eng.stats["idle_offloads"]
    assert len(eng.finished) == 3
    assert eng.endurance_report()["write_once_ok"]
    assert eng.backend.spill_compress == compress


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spill_lanes_carry_recurrent_states_verbatim(arch, compress):
    """evict_slot then restore_slot into another slot: every recurrent
    state leaf comes back bit for bit (compressed lanes requantize only
    the hot ring), and the other slots are left as they were."""
    _, _, _, _, model, params = build_pair(arch)
    be = LocalBackend(model, params, 3, 48, device="cpu", n_spill=2,
                      spill_compress=compress)
    pool = be.make_pool()
    rng = np.random.default_rng(8)
    cache = tree_map(lambda t: (torch.from_numpy(rng.standard_normal(
        t.shape).astype(np.float32)).to(t.dtype) if t.is_floating_point()
        else t), pool.state.cache)
    state = pool.state.__class__(cache=cache, axes=pool.state.axes)
    before = tree_map(lambda t: t.clone(), cache)
    state = be.evict_slot(state, 0, 1, 20)
    state = be.restore_slot(state, 1, 2)
    n = 0
    for path, t in tree_leaves_with_path(state.cache):
        a = _leaf(state.axes, path)
        old = _leaf(before, path)
        if path[-1] in STATE_KEYS:
            assert torch.equal(t.narrow(a, 2, 1), old.narrow(a, 0, 1)), path
            n += 1
        assert torch.equal(t.narrow(a, 0, 2), old.narrow(a, 0, 2)), path
    assert n > 0


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
