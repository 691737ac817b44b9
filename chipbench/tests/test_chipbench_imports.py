"""Nothing a benchmark run loads is JAX or the JAX package: the harness's
sources name neither, and a whole run (at the CPU's size) in a fresh
process leaves no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (``repro_torch`` is the program: top-level names
are compared whole)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from chipbench import run, spec

ROOT = spec.CHECKOUT


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_harness_sources_import_no_jax():
    for f in spec.HERE.rglob("*.py"):
        assert not _imports(f) & set(run.BANNED), f


def test_banned_names_are_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_like"] = sys
        before = run.banned_modules()
        sys.modules["repro.sub"] = sys
        assert run.banned_modules() == sorted(set(before) | {"repro"})
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


CHILD = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}]
from chipbench import run
run.prepare_env(run.CHECKOUT)
from chipbench.tests import small
for name in ("stablelm-code", "fastvlm-train"):
    run.run_cell(small.cell(name), 3, 0.2, True, "cpu", time.perf_counter())
print("BANNED", run.banned_modules())
"""


def test_a_run_loads_no_jax():
    code = CHILD.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BANNED []" in out.stdout, out.stdout[-2000:]
