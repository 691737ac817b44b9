"""`run.py` as the driver calls it: no result and a code other than 0
where the checkout lacks the program, or where there is no card."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from chipbench import spec

ARGS = ["--workload", "stablelm-code", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, "chipbench/run.py", *ARGS],
                          capture_output=True, text=True, timeout=120,
                          cwd=root)


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "lacks" in out.stderr


def test_no_card_gives_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    out = _run(spec.CHECKOUT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
