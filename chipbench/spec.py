"""`BENCHMARK.json` and the files it names, found by name.

A cell ``<cell>`` of the benchmark's ``workloads`` is three data files:
its configuration (the ``file`` of its ``config`` entry), its traffic
(``traffic/<traffic>.json``) and its set-up (``workloads/<cell>.json``:
dtype, KV store, slots, the profiled window, the correctness sample and
the limits). Each metric ``<metric>`` is read by
``metrics/<metric>.py``. A later change adds a cell or a metric by
adding files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    setup: dict
    end_to_end: list
    per_layer: list


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = CHECKOUT) -> dict:
    return load(root / "BENCHMARK.json")


def metrics_of(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries a cell reports: a metric
    with a ``workloads`` key in the cells it lists, else an end-to-end
    metric everywhere and a per-layer one wherever the metric it moves
    is reported."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def cell(name: str, root: pathlib.Path = CHECKOUT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e, per = metrics_of(bench, name)
    return Cell(name=name, chips=entry["chips"],
                config=load(root / conf["file"]),
                traffic=load(HERE / "traffic" / f"{entry['traffic']}.json"),
                setup=load(HERE / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def reader(metric: str):
    """The ``read(rec)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "chipbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
