"""PyTorch port: the mobilevlm-3b serving paths against the JAX
reference on the CPU — mobilevlm-3b cut to test size (MHA, G = 1; no
bias; untied head) on path A, the DRAM-only arm (flat store, fused
paged decode) and path B, the CHIME mapping (tiered store, int8 "RRAM"
FFN weights) — and the fused-decode / sparse-read knobs, read as the
reference reads them.

Tolerances: logits 1e-4 max-abs (f32 reassociation over two layers);
greedy tokens identical.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.models import Model as RefModel
from repro.serving import Engine as RefEngine
from repro.serving import LocalBackend as RefBackend
from repro.serving import Request as RefRequest
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving import Engine, LocalBackend, Request
from test_torch_config import build_pair

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4
# path -> (kv_policy, ffn_weight_store, fused_decode)
PATHS = {"A": ("flat", "native", True), "B": ("tiered", "int8", False)}
FUSED_ENV = ("REPRO_SERVE_FUSED_DECODE", "REPRO_SERVE_SPARSE_READ")


def _pair(path: str):
    policy, store, _ = PATHS[path]
    return build_pair("mobilevlm-small", kv_policy=policy, hot_window=8,
                      ffn_weight_store=store)


def _stream(cfg, seed: int):
    """Mixed VQA + text: ragged prompts, long enough for cold pages."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        patches = None
        if i % 2 == 0:
            patches = rng.standard_normal(
                (cfg.frontend.num_tokens, cfg.frontend.frontend_dim)
            ).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 20))).astype(np.int32)
        out.append((toks, patches, int(rng.integers(4, 10))))
    return out


def _requests(stream, cls):
    return [cls(rid=i, tokens=t, max_new_tokens=g, patches=p)
            for i, (t, p, g) in enumerate(stream)]


@pytest.fixture
def no_env(monkeypatch):
    for k in FUSED_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# paths A and B: logits and engine tokens against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["A", "B"])
def test_mobilevlm_prefill_logits_match_reference(path, no_env):
    _, rmodel, rparams, pc, model, params = _pair(path)
    toks, patches, _ = _stream(pc, seed=1)[0]
    batch = {"tokens": toks[None], "patches": patches[None]}
    rl, _ = rmodel.prefill(rparams, batch, 48)
    pl, _ = model.prefill(params, batch, 48)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("path", ["A", "B"])
def test_mobilevlm_engine_matches_reference_engine(path, no_env):
    """Port and reference engines on one mixed stream, 2 slots: identical
    token streams. Path A resolves fused decode on through the backend
    argument and decodes through `paged_decode_flat`; path B through
    `paged_decode_tiered` with live cold pages and the int8 FFN."""
    _, rmodel, rparams, pc, model, params = _pair(path)
    fused = PATHS[path][2]
    calls = {"flat": 0, "int8": 0}
    for name, key in (("paged_decode_flat", "flat"),
                      ("ffn_act_int8", "int8")):
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        no_env.setattr(ops, name, spy)
    stream = _stream(pc, seed=2)
    be = LocalBackend(model, params, 2, 48, device="cpu",
                      fused_decode=fused)
    assert be.fused_decode == be.model.cfg.fused_decode == fused
    eng = Engine(be)
    reng = RefEngine(RefBackend(rmodel, rparams, 2, 48, fused_decode=fused))
    done = eng.run(_requests(stream, Request))
    rdone = reng.run(_requests(stream, RefRequest))
    assert [r.generated for r in sorted(done, key=lambda r: r.rid)] == \
        [r.generated for r in sorted(rdone, key=lambda r: r.rid)]
    assert (calls["flat"] > 0) == (path == "A")
    assert (calls["int8"] > 0) == (path == "B")
    if path == "B":
        rep = eng.endurance_report()
        assert rep["write_once_ok"] and rep["total_cold_writes"] > 0


# ---------------------------------------------------------------------------
# knobs: explicit arg > cfg > env, as the reference's backend
# ---------------------------------------------------------------------------
def test_backend_knob_precedence(no_env):
    *_, model, params = build_pair("granite-3-2b")
    monkeypatch = no_env
    off = LocalBackend(model, params, 2, 24, device="cpu")
    assert not off.fused_decode and off.sparse_read_tau == 0.0
    assert off.model is model                     # nothing to rewrite
    monkeypatch.setenv("REPRO_SERVE_FUSED_DECODE", "1")
    monkeypatch.setenv("REPRO_SERVE_SPARSE_READ", "0.01")
    be = LocalBackend(model, params, 2, 24, device="cpu")
    assert be.fused_decode and be.sparse_read_tau == 0.01
    assert be.model.cfg.fused_decode and be.model.cfg.sparse_read_tau == 0.01
    # explicit arg beats the env; the sparse read is gated on fused
    be_off = LocalBackend(model, params, 2, 24, device="cpu",
                          fused_decode=False)
    assert not be_off.fused_decode and be_off.sparse_read_tau == 0.0
    assert LocalBackend(model, params, 2, 24, device="cpu",
                        sparse_read=0.5).sparse_read_tau == 0.5
    # the cfg flag beats the env
    m2 = Model(model.cfg.replace(fused_decode=True, sparse_read_tau=1e-3))
    assert LocalBackend(m2, params, 2, 24,
                        device="cpu").sparse_read_tau == 1e-3
    monkeypatch.delenv("REPRO_SERVE_FUSED_DECODE")
    m3 = Model(model.cfg.replace(fused_decode=True))
    be3 = LocalBackend(m3, params, 2, 24, device="cpu")
    assert be3.fused_decode and be3.sparse_read_tau == 0.01
    # malformed or negative env values read as off, never wedge startup
    monkeypatch.setenv("REPRO_SERVE_FUSED_DECODE", "1")
    for bad in ("not-a-float", "-3"):
        monkeypatch.setenv("REPRO_SERVE_SPARSE_READ", bad)
        assert LocalBackend(model, params, 2, 24,
                            device="cpu").sparse_read_tau == 0.0
    monkeypatch.setenv("REPRO_SERVE_FUSED_DECODE", "0")
    assert not LocalBackend(model, params, 2, 24, device="cpu").fused_decode


def _decode_logits(model, params, toks, steps: int):
    """Prefill + greedy decode; the per-step last-row logits (numpy)."""
    logits, cache = model.prefill(params, {"tokens": toks}, 40)
    n = toks.shape[1]
    out = []
    for i in range(steps):
        tok = np.asarray(logits[:, -1].argmax(-1))[:, None].astype(np.int32)
        logits, cache = model.decode_step(params, tok, cache, n + i)
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out)


def test_model_reads_fused_decode_env_like_reference(no_env):
    """Under REPRO_SERVE_FUSED_DECODE=1 REPRO_SERVE_SPARSE_READ=<tau>
    the reference's model skips cold pages; the port's must too: decode
    logits within 1e-4 of the reference's, while the skip moves them far
    from the exact read."""
    _, rmodel, rparams, _, model, params = build_pair("granite-3-2b")
    toks = np.random.default_rng(0).integers(0, 256, 30).astype(
        np.int32)[None]
    exact = _decode_logits(rmodel, rparams, toks, 3)
    no_env.setenv("REPRO_SERVE_FUSED_DECODE", "1")
    no_env.setenv("REPRO_SERVE_SPARSE_READ", "1e6")
    want = _decode_logits(rmodel, rparams, toks, 3)
    got = _decode_logits(model, params, torch.from_numpy(toks), 3)
    assert np.abs(want - exact).max() > 1.0       # pages were skipped
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    # a malformed tau reads as off: the exact read
    no_env.setenv("REPRO_SERVE_SPARSE_READ", "not-a-float")
    np.testing.assert_allclose(
        _decode_logits(model, params, torch.from_numpy(toks), 3), exact,
        rtol=0, atol=LOGIT_TOL)


def test_backend_off_knob_under_env_still_skips_like_reference(no_env):
    """States a fault the port shares with the reference (ROADMAP Queue
    3): under REPRO_SERVE_FUSED_DECODE=1 REPRO_SERVE_SPARSE_READ=<tau>,
    ``LocalBackend(fused_decode=False)`` reports fused decode and the
    sparse read off, yet its model reads the env again on every layer
    and still skips cold pages. Both packages do so alike; a fix changes
    both and this test with them."""
    _, rmodel, rparams, _, model, params = build_pair("granite-3-2b")
    toks = np.random.default_rng(0).integers(0, 256, 30).astype(
        np.int32)[None]
    exact = _decode_logits(rmodel, rparams, toks, 3)
    no_env.setenv("REPRO_SERVE_FUSED_DECODE", "1")
    no_env.setenv("REPRO_SERVE_SPARSE_READ", "1e6")
    be = LocalBackend(model, params, 2, 24, device="cpu", fused_decode=False)
    rbe = RefBackend(rmodel, rparams, 2, 24, fused_decode=False)
    assert (be.fused_decode, be.sparse_read_tau) == (False, 0.0)
    assert (rbe.fused_decode, rbe.sparse_read_tau) == (False, 0.0)
    want = _decode_logits(rbe.model, rparams, toks, 3)
    got = _decode_logits(be.model, params, torch.from_numpy(toks), 3)
    assert np.abs(want - exact).max() > 1.0       # pages skipped all the same
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_serve_cli_flat_fused_decode_on_cpu(no_env):
    """The CLI's --fused-decode / --sparse-read reach the backend; on a
    flat store the sparse read (tiered-only) changes nothing."""
    from repro_torch.launch.serve import main
    done = main(["--arch", "mobilevlm-3b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--concurrency", "2", "--prompt-len",
                 "10", "--gen", "4", "--image-every", "2", "--kv-policy",
                 "flat", "--fused-decode", "--sparse-read", "0.1",
                 "--dtype", "float32"])
    assert len(done) == 3 and all(r.n_generated == 4 for r in done)
