"""`BENCHMARK.json` against the benchmark's contract, and every file a
cell and a metric are found by."""

from __future__ import annotations

import json
import re

import pytest

from chipbench import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTH = re.compile(r".*(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    assert all(_one_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])


def test_paths_hold_the_benchmark_only(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.fullmatch(p) and not p.endswith("_torch")
        assert (spec.CHECKOUT / p).is_dir()
    # the command names no file of the repo outside the paths
    files = [w for w in bench["command"] if "/" in w]
    assert all(any(f.startswith(p + "/") for p in bench["paths"])
               for f in files)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_valid_and_unique(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_metric_names_unique_across_sections(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_entries(bench, section):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if section == "end_to_end" else {"layer", "moves"}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench[section]:
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25
        else:
            assert _one_line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split(
                ".")[0]:
            assert m["unit"] == "%"


def test_per_layer_moves_a_metric_its_cells_report(bench):
    for m in bench["per_layer"]:
        for cell in m.get("workloads", []):
            e2e, _ = spec.metrics_of(bench, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_layer_names_are_consistent(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(_one_line(x) for x in layers)


def test_setup_s_everywhere_and_bounded(bench):
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(bench, cell):
    e2e, per = spec.metrics_of(bench, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per


def test_workload_entries(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    assert 1 <= len(bench["workloads"]) <= 24


def test_config_entries(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _one_line(c["source"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) and not WIDTH.match(k)
                   for k in c["reduced"])
        body = spec.load(spec.CHECKOUT / c["file"])
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.cell(cell)
    assert c.setup["kind"] in ("serve", "train")
    assert c.traffic["kind"] in ("closed_loop", "train_rows")
    assert c.config["hidden_size"] > 0
    assert c.setup["limits"]


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for f in (spec.CHECKOUT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(spec.CHECKOUT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
