"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, everything else of a run driven
at the CPU's size, once for each fault a cell can have (a step that
returns its state unchanged; half of the batch left out; a token altered
where it is produced). One card: no exchange between chips to leave
out."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from chipbench import program, run, serve
from chipbench.tests import small
from chipbench.tests.test_chipbench_control import STEADY_HERE, _assert_sound


def _serve_fault(kind: str):
    def wrap(decode_step, state0):
        calls = {"n": 0}

        def broken(toks, state, pos, active):
            ntoks, new = decode_step(toks, state, pos, active)
            calls["n"] += 1
            ntoks = np.array(ntoks)
            if kind == "unchanged":
                return ntoks, state
            if kind == "half":
                n = len(ntoks)
                ntoks[n // 2:] = ntoks[:n - n // 2]
            if kind == "token" and calls["n"] % 3 == 0:
                ntoks = (ntoks + 1) % 256
            return ntoks, new
        return broken
    return wrap


@pytest.mark.parametrize("kind", ["unchanged", "half", "token"])
def test_serving_fault_is_caught(monkeypatch, kind):
    make = program.engine

    def engine(*a, **k):
        eng = make(*a, **k)
        be = eng.backend
        be.decode_step = _serve_fault(kind)(be.decode_step, None)
        return eng
    monkeypatch.setattr(program, "engine", engine)
    small.fixed_clock(monkeypatch)
    out = run.run_cell(small.cell("stablelm-code"), 31, 0.5, False, "cpu",
                       time.perf_counter())
    assert not out["result"]["correct"], out["result"]["checks"]
    assert _fails_a_steady_number(out), out["result"]["checks"]


def test_sound_serving_run_is_correct(monkeypatch):
    small.fixed_clock(monkeypatch)
    out = run.run_cell(small.cell("stablelm-code"), 31, 0.5, False, "cpu",
                       time.perf_counter())
    assert out["result"]["correct"], out["result"]["checks"]


def _train_fault(kind: str, monkeypatch):
    steps, _ = program.train_modules()
    if kind == "unchanged":
        monkeypatch.setattr(steps, "adamw_update", lambda state, grads, cfg:
                            (state, {"grad_norm": torch.tensor(0.0),
                                     "lr": torch.tensor(0.0)}))
        return
    make = program.train_step

    def train_step(mdl, opt):
        step, cfg, init = make(mdl, opt)

        def broken(state, batch):
            batch = dict(batch)
            if kind == "half":
                n = batch["tokens"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
            else:
                toks = batch["tokens"].clone()
                toks[0, 1] = (toks[0, 1] + 1) % mdl.cfg.vocab_size
                batch["tokens"] = toks
            return step(state, batch)
        return broken, cfg, init
    monkeypatch.setattr(program, "train_step", train_step)


def _fails_a_steady_number(out) -> bool:
    checks = out["result"]["checks"]
    return any(v["value"] is None or v["value"] > v["limit"]
               for k, v in checks.items() if k in STEADY_HERE)


def test_sound_training_run_passes_the_steady_numbers(monkeypatch):
    small.fixed_clock(monkeypatch)
    cell = small.cell("fastvlm-train")
    out = run.run_cell(cell, 41, 0.2, False, "cpu", time.perf_counter())
    _assert_sound(cell, out["numbers"])


@pytest.mark.parametrize("kind", ["unchanged", "half", "token"])
def test_training_fault_is_caught(monkeypatch, kind):
    _train_fault(kind, monkeypatch)
    small.fixed_clock(monkeypatch)
    out = run.run_cell(small.cell("fastvlm-train"), 41, 0.2, False, "cpu",
                       time.perf_counter())
    assert not out["result"]["correct"], out["result"]["checks"]
    assert _fails_a_steady_number(out), out["result"]["checks"]


def test_the_check_samples_a_request_of_every_slot():
    class Req:
        def __init__(self, rid, n):
            self.rid, self.generated = rid, [0] * n
    recs = {rid: {"done": 1.0, "slot": rid % 4,
                  "req": Req(rid, 40 if rid == 5 else 10)}
            for rid in range(12)}
    recs[12] = {"done": 9.0, "slot": 0, "req": Req(12, 99)}   # after close
    loop = type("L", (), {"recs": recs})
    got = serve.sample(loop, 0.0, 2.0, 7, tokens=20)
    # the longest first, then one of every other slot past the tokens
    assert got[0]["req"].rid == 5
    assert sorted(r["slot"] for r in got) == [0, 1, 2, 3]
    more = serve.sample(loop, 0.0, 2.0, 7, tokens=80)
    assert len(more) == 5 and more[:4] == got
    assert [r["req"].rid for r in serve.sample(loop, 0.0, 2.0, 8, 80)] \
        != [r["req"].rid for r in more]
