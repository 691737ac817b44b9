"""PyTorch port: the serving slice end to end on the CPU, against the JAX
reference — reduced granite-3-2b and the bias/tied-head fastvlm-1.7b
twin, f32, tiered store with hot window 8; and deepseek-v2-lite (MLA +
MoE, reduced), the reference's `local` MLA cases.

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
from repro.serving import slot_kv_bytes as ref_slot_kv_bytes
from repro.serving import Engine as RefEngine
from repro.serving import LocalBackend as RefBackend
from repro.serving import Request as RefRequest
from repro_torch.configs.base import Segment, get_config
from repro_torch.launch.serve import generate, main
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model
from repro_torch.serving import (Engine, LocalBackend, Request,
                                 make_backend, parse_prometheus,
                                 slot_kv_bytes, validate_chrome_trace)
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
@pytest.mark.parametrize("arch", ARCHS + ("nemotron-4-340b",))
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
    """Nothing left raises NotImplementedError: the train CLI's
    production mesh (multi-device training) builds the 256-rank mesh,
    which a one-process world refuses with the mesh module's ValueError
    naming both sizes. The sharded backend builds, on a world-1 gloo
    mesh. Learned position embeddings
    (hubert-xlarge's) build, and an encoder is refused by the backend
    with the reference's ValueError. (Every mixer, spill lanes, the
    paged prefix store and weight streaming are ported: they work.)"""
    cfg = get_config("granite-3-2b", reduced=True)
    Model(cfg.replace(segments=(Segment(("mamba2",), 2),)))
    learned = Model(cfg.replace(pos_emb="learned"))
    assert learned.init(device="cpu")["pos_emb"].shape[1] == cfg.d_model
    enc = Model(cfg.replace(is_encoder=True))
    with pytest.raises(ValueError, match="encoder-only"):
        LocalBackend(enc, enc.init(device="cpu"), 2, 16, device="cpu")
    _, _, _, _, model, params = build_pair("granite-3-2b")
    be = LocalBackend(model, params, 2, 16, device="cpu")
    sharded = make_backend("sharded", model, params, num_slots=2,
                           max_len=16, device="cpu")
    assert sharded.mesh.shape == {"data": 1, "model": 1}
    assert sharded.weight_bytes() == be.weight_bytes()
    with pytest.raises(ValueError, match="has 256 devices, the world size "
                                         "is 1"):
        train_main(["--reduced", "--device", "cpu", "--production-mesh"])
    assert be.evict_slot(be.init_pool(), 0, 0, 4).num_spill_lanes == 2
    assert be.ensure_prefix(be.init_pool()).prefix is not None
    streamed = LocalBackend(Model(model.cfg.replace(weight_stream_layers=1)),
                            params, 2, 16, device="cpu")
    assert streamed.weight_stream == 1


# ---------------------------------------------------------------------------
# deepseek-v2-lite (MLA latent cache + dropless MoE): the reference's local
# MLA cases (test_serving.py, test_serving_chunked.py, test_serving_fused.py)
# ---------------------------------------------------------------------------
MLA = "deepseek-v2-lite"


def _text_requests(cls, cfg, specs, seed):
    """`tests/conftest.py::make_requests` on either side's Request."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, n)
                .astype(np.int32), max_new_tokens=g)
            for i, (n, g) in enumerate(specs)]


@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
def test_slot_kv_bytes_matches_cache_walk_mla(kv_policy):
    """slot_kv_bytes of the latent cache equals a byte walk of the real
    cache (the int8 cold tier and its scales are RRAM, the rest DRAM,
    endurance counters bookkeeping) and the reference's figure."""
    rc, rmodel, _, pc, model, _ = build_pair(MLA, kv_policy)
    max_len, hot, cold = 24, 0, 0
    for path, leaf in tree_leaves_with_path(model.cache_spec(1, max_len)[0]):
        if path[-1] == "writes":
            continue
        n = leaf.numel() * leaf.element_size()
        if path[-1] in ("cold_q", "cold_scale"):
            cold += n
        else:
            hot += n
    assert slot_kv_bytes(model, max_len) == (hot, cold) == \
        ref_slot_kv_bytes(rmodel, max_len)
    if kv_policy == "flat":
        m = pc.mla
        assert hot == 4 * pc.num_layers * max_len * (m.kv_lora_rank
                                                     + m.qk_rope_head_dim)


@pytest.mark.parametrize("chunk_tokens", [None, 5])
def test_engine_matches_generate_and_reference_engine_mla(chunk_tokens):
    """Whole-prompt (3 x 16-token prompts, as the reference's MLA case)
    and chunked prefill (16, 13 and 8 tokens in chunks of 5): the port's
    engine gives the reference engine's plans, tokens, stats and
    endurance report, and each request's tokens equal `generate`."""
    _, rmodel, rparams, pc, model, params = build_pair(MLA)
    specs = ([(16, 6)] * 3 if chunk_tokens is None
             else [(16, 6), (13, 6), (8, 6)])
    seed = 5 if chunk_tokens is None else 3
    eng = Engine(LocalBackend(model, params, 2, 24, device="cpu"),
                 chunk_tokens=chunk_tokens)
    reng = RefEngine(RefBackend(rmodel, rparams, 2, 24),
                     chunk_tokens=chunk_tokens)
    plans, rplans = _record_plans(eng), _record_plans(reng)
    done = eng.run(_text_requests(Request, pc, specs, seed))
    rdone = reng.run(_text_requests(RefRequest, pc, specs, seed))
    assert plans == rplans
    got = [r.generated for r in sorted(done, key=lambda r: r.rid)]
    assert got == [r.generated for r in sorted(rdone, key=lambda r: r.rid)]
    assert eng.stats == reng.stats
    assert eng.endurance_report() == reng.endurance_report()
    assert eng.endurance_report()["write_once_ok"]
    for r in sorted(done, key=lambda r: r.rid):
        mine, _ = generate(model, params, {"tokens": r.tokens[None]},
                           r.prompt_len, r.max_new_tokens, device="cpu")
        assert r.generated == mine[0].tolist(), r.rid
    if chunk_tokens:
        assert eng.stats["prefill_chunks"] > len(specs)


def test_extend_chunks_equal_prefill_logits_mla():
    """Chunks (5, 5, 5, 1) of a 16-token prompt through the MLA
    workspace give whole-prompt prefill's logits and the reference's."""
    _, rmodel, rparams, pc, model, params = build_pair(MLA)
    toks = np.random.default_rng(3).integers(0, pc.vocab_size, 16).astype(
        np.int32)
    whole, _ = model.prefill(params, {"tokens": toks[None]}, 24)
    rwhole, _ = rmodel.prefill(rparams, {"tokens": toks[None]}, 24)
    ext, pos = model.init_extend_cache(1, 24), 0
    assert set(ext["u0"]) == {"c_kv_ws", "k_rope_ws"}
    for i, n in enumerate((5, 5, 5, 1)):
        logits, ext = model.extend(params, {"tokens": toks[None, pos:pos + n]},
                                   ext, pos, n, commit=i == 3)
        pos += n
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rwhole), rtol=0,
                               atol=LOGIT_TOL)


def test_mla_backend_resolves_fused_knob_off_and_serves_identically():
    """Fused decode is GQA-only: asked for on an MLA model it resolves
    off (and the sparse read with it), and the tokens equal the default
    backend's. Only recurrent states change the prefill rules, so MLA
    keeps ``requires_exact_prefill`` False and ``chunk_unit`` 1; its
    workspace leaves (`*_ws`) are the latent workspaces."""
    _, _, _, pc, model, params = build_pair(MLA)
    be = LocalBackend(model, params, 2, 24, device="cpu", fused_decode=True,
                      sparse_read=0.1)
    assert not be.fused_decode and be.sparse_read_tau == 0.0
    assert not be.requires_exact_prefill and be.chunk_unit == 1
    assert be.has_prefix_ws
    assert {p[-1] for p, _ in tree_leaves_with_path(
        model.extend_spec(1, 24)[0])} == {"c_kv_ws", "k_rope_ws"}
    runs = []
    for backend in (be, LocalBackend(model, params, 2, 24, device="cpu")):
        done = Engine(backend).run(
            _text_requests(Request, pc, [(16, 8), (5, 8), (13, 4)], 3))
        runs.append([r.generated for r in sorted(done, key=lambda r: r.rid)])
    assert runs[0] == runs[1]


def test_serve_cli_mla_on_cpu(capsys):
    done = main(["--arch", MLA, "--reduced", "--device", "cpu",
                 "--requests", "3", "--concurrency", "2", "--prompt-len",
                 "12", "--gen", "4", "--hot-window", "4", "--dtype",
                 "float32", "--chunk-tokens", "5"])
    assert len(done) == 3 and all(r.n_generated == 4 for r in done)
    assert "tok/J" in capsys.readouterr().out


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


def test_serve_cli_shared_prefix_and_weight_stream_on_cpu(tmp_path, capsys):
    """A shared image + system prompt through the prefix cache, with the
    weights streamed: the prefix-cache line, the weight-stream note and
    a ledger that reconciles EXACTLY with simulated_efficiency."""
    prom = tmp_path / "metrics.prom"
    done = main(["--arch", "fastvlm-1.7b", "--reduced", "--device", "cpu",
                 "--requests", "5", "--concurrency", "2", "--prompt-len",
                 "12", "--gen", "4", "--image-every", "1", "--hot-window",
                 "4", "--dtype", "float32", "--shared-prefix", "8",
                 "--prefix-cache", "--weight-stream", "1",
                 "--metrics-out", str(prom)])
    out = capsys.readouterr().out
    assert len(done) == 5 and all(r.n_generated == 4 for r in done)
    assert "[serve] prefix cache:" in out and "CoW copies" in out
    assert any(r.prefix_hit > 0 for r in done)
    assert "[weight stream W=1:" in out and "streamed from RRAM]" in out
    assert "(reconciles with simulated_efficiency: EXACT)" in out
