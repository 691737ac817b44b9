"""PyTorch port: the serving slice end to end on the CPU, against the JAX
reference — reduced granite-3-2b and the bias/tied-head fastvlm-1.7b
twin, f32, tiered store with hot window 8.

Tolerances: logits 1e-4 max-abs (f32 reassociation over two layers);
greedy tokens identical; scheduler plans and endurance reports
identical.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import generate as ref_generate
from repro.serving import Engine as RefEngine
from repro.serving import LocalBackend as RefBackend
from repro.serving import Request as RefRequest
from repro_torch.configs.base import Segment, get_config
from repro_torch.launch.serve import generate, main
from repro_torch.models import Model
from repro_torch.serving import (Engine, LocalBackend, Request,
                                 make_backend, parse_prometheus,
                                 validate_chrome_trace)
from repro_torch.tree import tree_leaves, tree_leaves_with_path
from test_torch_config import ARCHS, build_pair

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4


def _stream(cfg, seed: int = 0):
    """A mixed text + VQA stream (VQA where the config has a frontend):
    ragged prompt and generation lengths, prompts long enough to push
    tokens out of the 8-slot hot ring into the int8 cold tier."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(5):
        patches = None
        if cfg.frontend is not None and i % 2 == 0:
            patches = rng.standard_normal(
                (cfg.frontend.num_tokens, cfg.frontend.frontend_dim)
            ).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(3, 14))).astype(np.int32)
        out.append((toks, patches, int(rng.integers(4, 12))))
    return out


def _requests(stream, cls):
    return [cls(rid=i, tokens=t, max_new_tokens=g, patches=p)
            for i, (t, p, g) in enumerate(stream)]


def _batch(toks, patches):
    b = {"tokens": toks[None]}
    if patches is not None:
        b["patches"] = patches[None]
    return b


def _record_plans(engine):
    plans = []
    plan = engine.scheduler.plan

    def recording(**kw):
        p = plan(**kw)
        plans.append((tuple((c.req.rid, c.admit, c.start, c.length,
                             c.commit) for c in p.chunks), p.decode,
                      tuple(r.rid for r in p.evictions),
                      tuple(r.rid for r in p.restores),
                      tuple(r.rid for r in p.offloads)))
        return p
    engine.scheduler.plan = recording
    return plans


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch):
    rc, rmodel, rparams, pc, model, params = build_pair(arch)
    toks, patches, _ = _stream(pc, seed=1)[0]
    batch = _batch(toks, patches)
    rl, _ = rmodel.prefill(rparams, batch, 40)
    pl, _ = model.prefill(params, batch, 40)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                               atol=LOGIT_TOL)
    # right-padded prompt with an explicit valid length
    pad = {**batch, "tokens": np.concatenate(
        [batch["tokens"], np.zeros((1, 3), np.int32)], 1)}
    n = toks.shape[0] + (0 if patches is None else patches.shape[0])
    rl, _ = rmodel.prefill(rparams, pad, 40, length=n)
    pl, _ = model.prefill(params, pad, 40, length=n)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    _, rmodel, rparams, pc, model, params = build_pair(arch)
    toks, patches, _ = _stream(pc, seed=2)[0]
    n = toks.shape[0] + (0 if patches is None else patches.shape[0])
    want, _ = ref_generate(rmodel, rparams, _batch(toks, patches), n, 14)
    got, _, logits = generate(model, params, _batch(toks, patches), n, 14,
                              device="cpu", return_logits=True)
    assert got[0].tolist() == np.asarray(want)[0].tolist()
    assert logits.shape == (1, 14, model.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_extend_equals_whole_prefill(arch):
    """Chunked prefill through `extend` (the kernel path: attn_stream with
    q_offset = pos) gives the whole-prompt logits and cache, and matches
    the reference's chunked extend."""
    _, rmodel, rparams, pc, model, params = build_pair(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, pc.vocab_size, 17).astype(np.int32)
    max_len = 32
    whole, wcache = model.prefill(params, {"tokens": toks[None]}, max_len)
    ext = model.init_extend_cache(1, max_len)
    rext = rmodel.init_extend_cache(1, max_len)
    pos = 0
    for C, valid, commit in [(6, 6, False), (8, 8, False), (8, 3, True)]:
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :valid] = toks[pos:pos + valid]
        logits, ext = model.extend(params, {"tokens": chunk}, ext, pos,
                                   valid, commit=commit)
        rlogits, rext = rmodel.extend(rparams, {"tokens": chunk}, rext, pos,
                                      valid, commit=commit)
        pos += valid
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=0,
                               atol=LOGIT_TOL)
    # committed stores agree on the prompt's positions (rows past it hold
    # the padded chunk's never-attendable K/V, as in the reference)
    n = toks.shape[0]
    for kv in ("k", "v"):
        got, want = ext["u0"][kv], wcache["u0"][kv]
        torch.testing.assert_close(got["hot"], want["hot"], rtol=0,
                                   atol=2e-5)
        assert torch.equal(got["writes"], want["writes"])
        torch.testing.assert_close(got["cold_scale"][:, :, :n],
                                   want["cold_scale"][:, :, :n], rtol=2e-5,
                                   atol=0)
        diff = got["cold_q"][:, :, :n].int() - want["cold_q"][:, :, :n].int()
        assert diff.abs().max() <= 1


# ---------------------------------------------------------------------------
# serving: engine == generate == reference generate; same plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_generate_and_reference(arch):
    _, rmodel, rparams, pc, model, params = build_pair(arch)
    stream = _stream(pc, seed=4)
    eng = Engine(LocalBackend(model, params, 3, 48, device="cpu"))
    done = eng.run(_requests(stream, Request))
    assert len(done) == len(stream)
    for r in sorted(done, key=lambda r: r.rid):
        toks, patches, gen = stream[r.rid]
        b = _batch(toks, patches)
        mine, _ = generate(model, params, b, r.prompt_len, gen,
                           device="cpu")
        ref, _ = ref_generate(rmodel, rparams, b, r.prompt_len, gen)
        assert r.generated == mine[0].tolist() == \
            np.asarray(ref)[0].tolist(), r.rid
    rep = eng.endurance_report()
    assert rep["write_once_ok"] and rep["total_cold_writes"] > 0


@pytest.mark.parametrize("chunk_tokens", [None, 5])
def test_engine_plans_tokens_and_endurance_match_reference_engine(
        chunk_tokens):
    """Port and reference engines on the same mixed VQA + text stream,
    whole-prompt and chunked prefill: identical StepPlan sequences,
    token streams and endurance reports."""
    _, rmodel, rparams, pc, model, params = build_pair("fastvlm-small")
    stream = _stream(pc, seed=5)
    eng = Engine(LocalBackend(model, params, 2, 40, device="cpu"),
                 chunk_tokens=chunk_tokens)
    reng = RefEngine(RefBackend(rmodel, rparams, 2, 40),
                     chunk_tokens=chunk_tokens)
    plans, rplans = _record_plans(eng), _record_plans(reng)
    done = eng.run(_requests(stream, Request))
    rdone = reng.run(_requests(stream, RefRequest))
    assert plans == rplans and len(plans) > len(stream)
    assert [r.generated for r in sorted(done, key=lambda r: r.rid)] == \
        [r.generated for r in sorted(rdone, key=lambda r: r.rid)]
    assert eng.endurance_report() == reng.endurance_report()
    assert eng.stats == reng.stats


def test_batched_decode_keeps_inactive_slots_verbatim():
    _, _, _, pc, model, params = build_pair("granite-3-2b")
    be = LocalBackend(model, params, 3, 24, device="cpu")
    pool = be.make_pool()
    toks = np.zeros((3, 1), np.int32)
    pos = np.array([0, 5, 9], np.int32)
    active = np.array([True, False, True])
    _, state = be.decode_step(toks, pool.state, pos, active)
    for (path, new), old in zip(tree_leaves_with_path(state.cache),
                                tree_leaves(pool.state.cache)):
        assert torch.equal(new[:, 1], old[:, 1]), path
    hot = state.cache["u0"]["k"]["hot"]
    assert hot[:, 0].abs().sum() > 0 and hot[:, 2].abs().sum() > 0


# ---------------------------------------------------------------------------
# entry points: the card by default, never a silent CPU run
# ---------------------------------------------------------------------------
def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, _, pc, model, params = build_pair("granite-3-2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalBackend(model, params, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, params, {"tokens": np.zeros((1, 3), np.int32)}, 3, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced", "--requests", "1"])


def test_unported_paths_raise_not_implemented():
    """What is still to port raises, naming its ROADMAP item: other
    mixers, the paged prefix store, weight streaming and the sharded
    backend. (Spill lanes are ported: evict_slot works.)"""
    cfg = get_config("granite-3-2b", reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg.replace(segments=(Segment(("mamba2",), 2),)))
    _, _, _, _, model, params = build_pair("granite-3-2b")
    be = LocalBackend(model, params, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        be.ensure_prefix(be.init_pool())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LocalBackend(Model(model.cfg.replace(weight_stream_layers=1)),
                     params, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_backend("sharded", model, params, num_slots=2, max_len=16,
                     device="cpu")
    assert be.evict_slot(be.init_pool(), 0, 0, 4).num_spill_lanes == 2


def test_serve_cli_on_cpu():
    done = main(["--arch", "fastvlm-1.7b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--concurrency", "2", "--prompt-len",
                 "12", "--gen", "4", "--image-every", "2", "--hot-window",
                 "4", "--dtype", "float32"])
    assert len(done) == 3 and all(r.n_generated == 4 for r in done)


def test_serve_cli_preempts_with_telemetry_on_cpu(tmp_path, capsys):
    """Priority traffic mid-run, int8 spill lanes, chunked prefill and
    the telemetry exports: every request finishes, something was
    preempted, and the ledger reconciles EXACTLY with
    simulated_efficiency."""
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    done = main(["--arch", "fastvlm-1.7b", "--reduced", "--device", "cpu",
                 "--requests", "6", "--concurrency", "2", "--prompt-len",
                 "12", "--gen", "6", "--image-every", "3", "--hot-window",
                 "4", "--dtype", "float32", "--priority-every", "2",
                 "--spill-compress", "--chunk-tokens", "8",
                 "--metrics-out", str(prom), "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert len(done) == 6 and all(r.n_generated == 6 for r in done)
    assert "int8-compressed lanes" in out and "preemptions" in out
    assert "chunked prefill:" in out and "tok/J" in out
    assert "(reconciles with simulated_efficiency: EXACT)" in out
    validate_chrome_trace(json.loads(trace.read_text()))
    assert parse_prometheus(prom.read_text())
