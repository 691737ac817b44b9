"""PyTorch port: RRAM weight streaming, against the JAX reference.

* Streaming is accounting only, so it is bit-exact: a backend with
  ``weight_stream`` serves exactly the resident run's tokens,
  whole-prompt and chunked, and exactly the reference streamed engine's
  tokens, StepPlans, stats and endurance report.
* The knob is truthful: explicit arg > cfg flag >
  ``REPRO_SERVE_WEIGHT_STREAM``, 0 when nothing would stream, resolved
  as the reference resolves it.
* The split math is the reference's: `weight_stream_split`,
  `Model.streamed_units` and `streamed_unit_indices` agree with it on
  every config the port registers, at W 0-4.
* The ledger reconciles: the port's streamed ledger equals its
  `simulated_efficiency` and the reference's ledger (`==`), and
  streaming prices above resident.
* Admission charges weights: the nemotron-4-340b host arithmetic, the
  reduced nemotron decoding under a budget that denies its resident
  twin, and path B's full mobilevlm-3b under the CHIME budget (host
  arithmetic on the meta device).
The reference runs are memoized per session.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import counting as RC
from repro.serving import LocalBackend as RefBackend
from repro.serving import Telemetry as RefTelemetry
from repro.serving import simulated_efficiency as ref_sim_eff
from repro_torch.configs.base import get_config, list_archs
from repro_torch.launch.serve import generate
from repro_torch.models import Model
from repro_torch.models import counting as PC
from repro_torch.serving import (CapacityBudget, Engine,
                                 LocalBackend, Telemetry,
                                 simulated_efficiency)
from test_torch_config import build_pair
from test_torch_spill import assert_twins, make_requests, side, tokens

jax.config.update("jax_platform_name", "cpu")

# the reference suite's GQA serving shape
SPECS, MAX_LEN, CHUNK = [(16, 6), (13, 6), (8, 4)], 24, 5
MIB = 2 ** 20


def _served(s, W, chunk, telemetry=None):
    eng = s.Engine(s.backend(2, MAX_LEN, weight_stream=W),
                   chunk_tokens=chunk, telemetry=telemetry)
    reqs = make_requests(s, SPECS, seed=3)
    eng.run(reqs, max_steps=400)
    assert len(eng.finished) == len(SPECS)
    return eng, reqs


@functools.lru_cache(maxsize=None)
def _ref_served(arch, W, chunk):
    return _served(side(False, arch=arch), W, chunk)


# ---------------------------------------------------------------------------
# token parity: streamed == resident == the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "fastvlm-small"])
def test_streamed_matches_resident_and_reference(arch, chunk):
    s = side(True, arch=arch)
    eng, reqs = _served(s, 1, chunk)
    be = eng.backend
    assert be.weight_stream == 1 and be.model.cfg.weight_stream_layers == 1
    assert be.model.streamed_units() == (0,)
    assert_twins(eng, reqs, *_ref_served(arch, 1, chunk))
    resident, rreqs = _served(s, 0, chunk)
    assert resident.backend.model.streamed_units() == ()
    assert tokens(reqs) == tokens(rreqs)
    assert eng.plans == resident.plans


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunked"])
def test_streamed_matches_resident_and_reference_mla(chunk):
    """deepseek-v2-lite: the dense first layer is a unit of one and stays
    resident; the two MoE layers stream at W = 1. The streamed engine
    equals the reference's and the resident one, and its ledger equals
    simulated_efficiency and the reference's."""
    arch = "deepseek-v2-lite"
    s = side(True, arch=arch)
    eng, reqs = _served(s, 1, chunk, telemetry=Telemetry())
    be = eng.backend
    assert be.weight_stream == 1 and be.model.streamed_units() == (1,)
    assert_twins(eng, reqs, *_ref_served(arch, 1, chunk))
    resident, rreqs = _served(s, 0, chunk)
    assert resident.backend.model.streamed_units() == ()
    assert tokens(reqs) == tokens(rreqs)
    assert eng.plans == resident.plans
    led = eng.telemetry.ledger.totals()
    sim = simulated_efficiency(be.sim_context()[0], eng.finished,
                               weight_stream=True)
    for k in ("sim_energy_j", "sim_total_s", "sim_energy_split_j"):
        assert led[k] == sim[k], k
    rbe = _ref_served(arch, 1, chunk)[0].backend
    assert sim == ref_sim_eff(rbe.sim_context()[0],
                              _ref_served(arch, 1, chunk)[0].finished,
                              weight_stream=True)
    assert sim["sim_energy_split_j"].get("weight_stream", 0.0) > 0.0


def test_streamed_logits_bit_identical_to_resident():
    """A model whose config streams runs the resident loop: prefill,
    chunked extend and decode logits are equal bit for bit."""
    _, _, _, pc, model, params = build_pair("fastvlm-small")
    streamed = Model(pc.replace(weight_stream_layers=1))
    assert streamed.streamed_units() == (0,) and model.streamed_units() == ()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, pc.vocab_size, (1, 9)),
             "patches": rng.standard_normal(
                 (1, pc.frontend.num_tokens, pc.frontend.frontend_dim)
             ).astype(np.float32)}
    outs = []
    for m in (model, streamed):
        logits, cache = m.prefill(params, batch, 32)
        ext = m.init_extend_cache(1, 32)
        _, ext = m.extend(params, {"tokens": batch["tokens"][:, :5]}, ext,
                          0, 5)
        el, _ = m.extend(params, {"tokens": batch["tokens"][:, 5:]}, ext, 5,
                         4, commit=True)
        dl, _ = m.decode_step(params, torch.tensor([[3]]), cache, 17)
        outs.append((logits, el, dl))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# knob resolution: explicit arg > cfg flag > env, and always truthful
# ---------------------------------------------------------------------------
KNOB_CASES = {
    # case: (env value, cfg fields, explicit arg, resolved W)
    "env": ("1", {}, None, 1),
    "explicit-beats-env": ("1", {}, 0, 0),
    "garbage-env": ("not-an-int", {}, None, 0),
    "negative-env": ("-3", {}, None, 0),
    "cfg": (None, dict(weight_stream_layers=1), None, 1),
    "explicit-beats-cfg": (None, dict(weight_stream_layers=1), 0, 0),
    "deeper-than-every-unit": (None, {}, 999, 0),
    "unscanned": (None, dict(scan_layers=False, weight_stream_layers=1),
                  None, 0),
}


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_knob_resolves_as_reference(case, monkeypatch):
    env, fields, explicit, want = KNOB_CASES[case]
    if env is None:
        monkeypatch.delenv("REPRO_SERVE_WEIGHT_STREAM", raising=False)
    else:
        monkeypatch.setenv("REPRO_SERVE_WEIGHT_STREAM", env)
    rc, _, rparams, pc, _, params = build_pair()
    be = LocalBackend(Model(pc.replace(**fields)), params, 2, MAX_LEN,
                      device="cpu", weight_stream=explicit)
    ref = RefBackend(RefModel(rc.replace(**fields)), rparams, 2, MAX_LEN,
                     weight_stream=explicit)
    assert be.weight_stream == ref.weight_stream == want
    assert be.model.cfg.weight_stream_layers == \
        ref.model.cfg.weight_stream_layers == want
    assert be.model.streamed_units() == ref.model.streamed_units()
    assert be.weight_bytes() == ref.weight_bytes()
    if want == 0:
        dram, rram = be.weight_bytes()
        assert rram == 0 and dram == PC.count_params(pc) * \
            PC.param_dtype_bytes(pc)


# ---------------------------------------------------------------------------
# the working-set split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
def test_split_and_streamed_units_match_reference(arch):
    for reduced in (False, True):
        for scan in (True, False):
            for W in range(5):
                knobs = dict(weight_stream_layers=W, scan_layers=scan)
                pc = get_config(arch, reduced=reduced).replace(**knobs)
                rc = ref_get_config(arch, reduced=reduced).replace(**knobs)
                assert PC.weight_stream_split(pc) == \
                    RC.weight_stream_split(rc), (reduced, scan, W)
                units = Model(pc).streamed_units()
                assert units == RefModel(rc).streamed_units() == \
                    PC.streamed_unit_indices(pc), (reduced, scan, W)
                # a unit streams where it repeats more than W times:
                # full depth at every W >= 1, a 2-3 layer twin only below
                # its deepest unit (deepseek's dense first layer is a
                # unit of one)
                deepest = max(u.repeats for u in Model(pc).plan)
                assert bool(units) == (W > 0 and scan and deepest > W), (
                    reduced, scan, W)


def test_weight_stream_split_hand_math():
    cfg = get_config("nemotron-4-340b", reduced=True).replace(
        weight_stream_layers=1)
    (mixer, mlp, d_ff, r), = PC.weight_units(cfg)
    assert r == 3 and PC.streamed_unit_indices(cfg) == (0,)
    ib = PC.param_dtype_bytes(cfg)
    lb = PC.layer_weight_elems(cfg, mixer, mlp, d_ff) * ib
    total = PC.count_params(cfg) * ib
    win = PC.stream_window_repeats(cfg, r)
    assert win == 2                      # the double-buffer floor beats W=1
    assert PC.weight_stream_split(cfg) == (total - (r - win) * lb, r * lb)
    assert PC.weight_stream_split(cfg.replace(weight_stream_layers=0)) == \
        (total, 0)


# ---------------------------------------------------------------------------
# the ledger: streamed == simulated_efficiency == the reference's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ledger(port: bool, W: int):
    s = side(port)
    tel = (Telemetry if port else RefTelemetry)()
    eng, _ = _served(s, W, None, telemetry=tel)
    be = eng.backend
    sim = (simulated_efficiency if port else ref_sim_eff)(
        be.sim_context()[0], eng.finished,
        weight_stream=bool(be.weight_stream))
    return tel.ledger.totals(), sim, tel.ledger.steps


def test_streamed_ledger_reconciles_with_reference():
    led, sim, steps = _ledger(True, 1)
    rled, rsim, rsteps = _ledger(False, 1)
    for k in ("sim_energy_j", "sim_total_s", "sim_energy_split_j"):
        assert led[k] == sim[k], k
    assert sim["sim_weight_stream"]
    assert led["weight_stream_bytes"] > 0.0
    assert sim["sim_energy_split_j"].get("weight_stream", 0.0) > 0.0
    assert led == rled and sim == rsim and steps == rsteps


def test_streaming_prices_strictly_above_resident():
    led_r, sim_r, _ = _ledger(True, 0)
    led_s, _, _ = _ledger(True, 1)
    assert led_r["sim_energy_j"] == sim_r["sim_energy_j"]
    assert not sim_r["sim_weight_stream"]
    assert led_r["weight_stream_bytes"] == 0.0
    assert led_s["sim_energy_j"] > led_r["sim_energy_j"]


# ---------------------------------------------------------------------------
# the DRAM admission gate charges the weight working set
# ---------------------------------------------------------------------------
def test_full_nemotron_admission_analytic():
    """Host arithmetic only (the full 340B config is never built): under
    a DRAM budget of a tenth of the param bytes the resident model never
    admits ("dram_weights"), its streamed twin does."""
    cfg = get_config("nemotron-4-340b")
    total = PC.count_params(cfg) * PC.param_dtype_bytes(cfg)
    assert total > 500e9
    dram_w, rram_w = PC.weight_stream_split(cfg.replace(
        weight_stream_layers=1))
    assert (dram_w, rram_w) == RC.weight_stream_split(
        ref_get_config("nemotron-4-340b").replace(weight_stream_layers=1))
    assert dram_w + rram_w > total       # window slices counted twice
    budget = CapacityBudget(dram_bytes=0.1 * total,
                            rram_bytes=rram_w + 2 ** 34)
    hot, cold = 2 ** 20, 2 ** 20
    assert dram_w < budget.dram_bytes < total
    assert budget.deny_reason(0, hot, cold, weight_bytes=total) == \
        "dram_weights"
    assert budget.max_concurrent(hot, cold, weight_bytes=total) == 0
    assert budget.deny_reason(0, hot, cold, weight_bytes=dram_w) is None
    assert budget.max_concurrent(hot, cold, weight_bytes=dram_w) >= 1
    assert budget.deny_reason_bytes(hot, cold, weight_bytes=total) == \
        "dram_weights"
    assert budget.deny_reason_bytes(hot, cold, weight_bytes=dram_w) is None


def test_streamed_decodes_under_budget_that_denies_resident():
    """Reduced nemotron: a DRAM budget of exactly the resident weight
    bytes refuses the resident engine at construction; the streamed
    twin serves every request with `generate`'s and the reference
    engine's tokens."""
    rc, rmodel, rparams, pc, model, params = build_pair("nemotron-4-340b")

    def run(s):
        be_res = s.backend(2, MAX_LEN, weight_stream=0)
        be_str = s.backend(2, MAX_LEN, weight_stream=1)
        wb_res, dram_w = be_res.weight_bytes()[0], be_str.weight_bytes()[0]
        hot_b, cold_b = be_res.slot_kv_bytes()
        assert dram_w + hot_b <= wb_res
        budget = s.CapacityBudget(float(wb_res), 1e15)
        with pytest.raises(ValueError, match="weight working set"):
            s.Engine(be_res, scheduler=s.FCFSScheduler(budget, hot_b,
                                                       cold_b),
                     charge_weights=True)
        eng = s.Engine(be_str, scheduler=s.FCFSScheduler(budget, hot_b,
                                                         cold_b),
                       charge_weights=True)
        assert eng.charge_weights and eng.scheduler.weight_bytes == dram_w
        reqs = make_requests(s, [(8, 4), (6, 4)], seed=7)
        eng.run(reqs, max_steps=200)
        assert len(eng.finished) == len(reqs)
        return eng, reqs

    eng, reqs = run(side(True, arch="nemotron-4-340b"))
    assert_twins(eng, reqs, *run(side(False, arch="nemotron-4-340b")))
    for r in reqs:
        want, _ = generate(model, params, {"tokens": r.tokens[None]},
                           r.prompt_len, r.max_new_tokens, device="cpu")
        assert r.generated == want[0].tolist()


def test_charge_weights_env_knob(monkeypatch):
    monkeypatch.delenv("REPRO_SERVE_CHARGE_WEIGHTS", raising=False)
    _, _, _, _, model, params = build_pair()
    be = LocalBackend(model, params, 2, MAX_LEN, device="cpu",
                      weight_stream=0)
    assert not Engine(be).charge_weights
    monkeypatch.setenv("REPRO_SERVE_CHARGE_WEIGHTS", "1")
    eng = Engine(be)
    assert eng.charge_weights
    assert eng.scheduler.weight_bytes == be.weight_bytes()[0]
    assert not Engine(be, charge_weights=False).charge_weights
    monkeypatch.delenv("REPRO_SERVE_CHARGE_WEIGHTS")
    be_s = LocalBackend(model, params, 2, MAX_LEN, device="cpu",
                        weight_stream=1)
    assert Engine(be_s).charge_weights


@pytest.mark.parametrize("arch,split_mib", [
    ("mobilevlm-3b", (632.5, 4840.0)), ("fastvlm-1.7b", (637.125, 2499.0))])
def test_full_width_weight_charge_under_chime_budget(arch, split_mib):
    """The full configs' byte arithmetic, on the meta device (no weights
    are built): bf16, tiered, hot window 128, 4 slots, max_len 512, the
    default CHIME budget. At W = 2 the DRAM working set admits all 4
    slots; resident mobilevlm-3b (5,170 MiB) charged for its weights is
    refused at construction."""
    cfg = get_config(arch).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16",
        kv_policy="tiered", kv_hot_window=128, ffn_weight_store="native")
    resident = LocalBackend(Model(cfg), {}, 4, 512, device="meta")
    streamed = LocalBackend(Model(cfg), {}, 4, 512, device="meta",
                            weight_stream=2)
    assert streamed.weight_stream == 2
    got = streamed.weight_bytes()
    assert tuple(b / MIB for b in got) == split_mib
    assert got == RC.weight_stream_split(ref_get_config(arch).replace(
        param_dtype="bfloat16", weight_stream_layers=2))
    eng = Engine(streamed)
    assert eng.charge_weights and eng.scheduler.max_concurrent >= 4
    if arch == "mobilevlm-3b":
        assert resident.weight_bytes()[0] / MIB == 5170.0
        with pytest.raises(ValueError, match="weight working set"):
            Engine(resident, charge_weights=True)
        assert not Engine(resident).charge_weights
