"""The port's three examples (examples/*_torch.py) on the CPU, each run
through its ``main`` with ``--device cpu`` at its reduced size:

* quickstart_torch.py: its CHIME mapping-plan lines equal those the
  reference quickstart prints (pure Python in both packages: the
  planner's placements, cut points and cross-domain bytes), and it
  decodes 5 tokens;
* serve_vlm_torch.py: its own checks pass (flat and tiered agree, the
  cold tier is written once, chat tokens flow while a long VQA prompt
  prefills, paged answers equal the slot pool's with prefix hits);
* train_lm_torch.py: the ~100M granite model trains 2 steps of 1 x 16
  with a checkpoint in ``--ckpt-dir``, finite losses.
"""

from __future__ import annotations

import contextlib
import io
import math
import pathlib
import runpy

import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.core.planner import plan_for as ref_plan_for
from repro_torch.configs import base as CB

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(name: str, argv: list):
    """(examples/<name>'s main(argv), what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = runpy.run_path(str(EXAMPLES / name),
                             run_name="example")["main"](argv)
    return got, buf.getvalue()


def test_quickstart_plan_lines_equal_reference():
    toks, out = _main("quickstart_torch.py", ["--device", "cpu"])
    cfg = ref_get_config("fastvlm-0.6b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="none",
        kv_policy="tiered", kv_hot_window=16)
    plan = ref_plan_for(cfg)
    want = ["== CHIME mapping plan =="]
    for lp in plan.layers:
        ops = " -> ".join(f"{p.op}@{p.domain}" for p in lp.placements)
        want.append(f"  [{lp.mixer} x{lp.repeats}] {ops}  "
                    f"cuts={lp.cut_points}")
    want.append(f"  cross-domain bytes/token: "
                f"{plan.cross_domain_bytes_per_token(cfg)}")
    assert out.splitlines()[:len(want)] == want
    assert len(toks) == 5 and out.rstrip().endswith("done.")


def test_serve_vlm_runs_its_checks():
    got, out = _main("serve_vlm_torch.py", ["--device", "cpu"])
    assert got["agreement"] >= 0.5
    assert got["max_writes_per_block"] is not None
    assert got["write_once_ok"] and "write-once OK" in out
    assert got["overlap_steps"] > 0 and got["prefix_hits"] > 0
    assert "answers identical to the unshared slot pool" in out


def test_train_lm_trains_and_checkpoints(tmp_path, monkeypatch):
    # the example registers its config, as the reference's does: undone
    monkeypatch.setattr(CB, "_REGISTRY", dict(CB._REGISTRY))
    monkeypatch.setattr(CB, "_REDUCED", dict(CB._REDUCED))
    losses, out = _main("train_lm_torch.py", [
        "--device", "cpu", "--steps", "2", "--batch", "1", "--seq", "16",
        "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert "[train] 2 steps in" in out
    assert any(tmp_path.iterdir())
