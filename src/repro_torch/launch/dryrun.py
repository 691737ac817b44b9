"""Multi-pod dry run: walk every (architecture x input-shape) cell's step
on the production meshes and derive the roofline terms (port of the
reference's `launch/dryrun.py`).

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
    python -m repro_torch.launch.dryrun --all --both-meshes  # every cell
    python -m repro_torch.launch.dryrun --list

The reference lowers and compiles each cell for 256 / 512 fake host
devices and reads the compiled artifact. The port places nothing on a
device either: the mesh is abstract (`launch.mesh.abstract_mesh`: axis
names and sizes, no process group), every tensor is a meta tensor
(shape and dtype, no storage) at rank 0's local shape, and each
collective returns its result's shape without moving anything
(`sharding`). `walk_cell` runs the cell's train, prefill or decode step
once under `hlo_analysis.analyze`; `run_cell` writes the reference's
JSON keys to experiments/dryrun_torch/<arch>@<shape>@<mesh>.json.
Every figure is analytic: per device, from shapes, against the H100
constants of `hlo_analysis`; none is a measurement.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch import sharding as S
from repro_torch.configs.base import shape_by_name
from repro_torch.launch import hlo_analysis
from repro_torch.launch.cells import (all_cells, cell_config,
                                      grad_accum_dtype, input_specs,
                                      runnable_cells, train_microbatches)
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import (abstract_train_state, batch_shardings,
                                      make_train_step, train_state_shardings)
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, TrainState
from repro_torch.sharding import ShardingRules
from repro_torch.tree import tree_map

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


def _local(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Rank 0's block of ``t`` as a meta tensor."""
    return torch.empty(S.local_shape(spec, tuple(t.shape), mesh),
                       dtype=t.dtype, device="meta")


def cell_step(arch: str, shape_name: str, multi_pod: bool,
              overrides: dict | None = None) -> dict:
    """One cell's step on rank 0 of the abstract production mesh, ready
    to walk: {"model", "shape", "mesh", "step", "args", "kwargs",
    "inputs"}. ``inputs`` are rank 0's local arguments (the state or
    params, the batch, the cache); a train step is handed the global
    batch and takes its block itself. ``overrides`` may include the
    step-level key "microbatches"."""
    shape = shape_by_name(shape_name)
    overrides = dict(overrides or {})
    mb_override = overrides.pop("microbatches", None)
    cfg = cell_config(arch, shape, **overrides)
    mesh = abstract_mesh("multipod" if multi_pod else "production")
    rules = ShardingRules(mesh)
    model = Model(cfg).place(mesh, rules)
    specs = input_specs(cfg, shape)
    b_sh = batch_shardings(cfg, shape, rules, specs)
    batch = {k: _local(t, b_sh[k], mesh) for k, t in specs.items()}
    kwargs = {}
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            state_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
            else "float32")
        step = make_train_step(
            model, opt_cfg,
            microbatches=(mb_override if mb_override is not None
                          else train_microbatches(arch, shape)),
            grad_accum_dtype=grad_accum_dtype(arch))
        full = abstract_train_state(model, opt_cfg)
        sh = train_state_shardings(model, rules, opt_cfg)
        state = TrainState(*(tree_map(lambda t, s: _local(t, s, mesh),
                                      getattr(full, f), getattr(sh, f))
                             for f in ("params", "mu", "nu", "step")))
        inputs, args = (state, batch), (state, specs)
    else:
        p_full, _ = model.abstract_params()
        params = tree_map(lambda t, s: _local(t, s, mesh), p_full,
                          model.param_shardings(rules))
        if shape.kind == "prefill":
            step = model.prefill
            inputs, args = (params, batch), (params, batch, shape.seq_len)
        else:
            B, L = shape.global_batch, shape.seq_len
            c_full, _ = model.cache_spec(B, L)
            c_sh = model.cache_shardings(rules, B, L)
            cache = tree_map(lambda t, s: _local(t, s, mesh), c_full, c_sh)
            step, kwargs = model.decode_step, {"specs": c_sh}
            inputs = (params, batch, cache)
            args = (params, batch["tokens"], cache, L - 1)
    return {"model": model, "shape": shape, "mesh": mesh, "step": step,
            "args": args, "kwargs": kwargs, "inputs": inputs}


def walk_cell(arch: str, shape_name: str, multi_pod: bool,
              overrides: dict | None = None) -> dict:
    """`cell_step` walked once under `hlo_analysis.analyze`: its result
    plus "analysis" and "argument_bytes" (Σ of the local inputs'
    bytes)."""
    c = cell_step(arch, shape_name, multi_pod, overrides)
    return dict(c, analysis=hlo_analysis.analyze(c["step"], *c["args"],
                                                 **c["kwargs"]),
                argument_bytes=hlo_analysis.nbytes(c["inputs"]))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None, tag: str = "") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}@{shape_name}@{mesh_name}" + (f"@{tag}" if tag else "")
    t0 = time.time()
    w = walk_cell(arch, shape_name, multi_pod, overrides)
    t_walk = time.time() - t0
    a, model = w["analysis"], w["model"]

    result = {
        "cell": name,
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": w["mesh"].size,
        "compile_s": round(t_walk, 1),
        "memory": {
            "argument_bytes": w["argument_bytes"],
            "output_bytes": a["output_bytes"],
            "temp_bytes": a["temp_bytes"],
            "peak_bytes": a["temp_bytes"] + w["argument_bytes"],
        },
        "cost": {
            "flops_per_device": a["flops"],
            "bytes_accessed_per_device": a["bytes"],
        },
        "collectives": hlo_analysis.collective_bytes(a),
        "params": model.cfg.param_count(),
        "active_params": model.cfg.active_param_count(),
        "padded_vocab": model.padded_vocab,
        "analytic": True,
    }
    roof = hlo_analysis.roofline_terms(result, w["shape"])
    result["roofline"] = roof
    print(f"[dryrun] {name}: walk={t_walk:.1f}s "
          f"peak={result['memory']['peak_bytes'] / 1e9:.2f}GB/dev "
          f"dominant={roof['dominant']} (analytic)")
    return result


def save_result(res: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / (res["cell"].replace("/", "_") + ".json")
    path.write_text(json.dumps(res, indent=2, default=str))
    return path


def parse_overrides(args) -> dict:
    overrides = {}
    if args.kv_policy:
        overrides["kv_policy"] = args.kv_policy
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--kv-policy", default=None,
                    help="override kv policy (flat|tiered)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable), e.g. "
                         "--set mla_absorbed=true --set kv_hot_window=4096")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    if args.list:
        for c in all_cells():
            status = f"SKIP({c.skip_reason})" if c.skip_reason else "RUN"
            print(f"{c.name:45s} {status}")
        return

    overrides = parse_overrides(args)
    if args.all:
        ok, fail = 0, 0
        for c in runnable_cells():
            for mp in ((False, True) if args.both_meshes else (False,)):
                try:
                    res = run_cell(c.arch, c.shape.name, mp, overrides,
                                   args.tag)
                    save_result(res)
                    ok += 1
                except Exception as e:  # noqa: BLE001
                    fail += 1
                    print(f"[dryrun] FAIL {c.name} multi_pod={mp}: {e}")
                    traceback.print_exc()
        print(f"[dryrun] done: {ok} ok, {fail} failed")
        sys.exit(1 if fail else 0)

    meshes = ((False, True) if args.both_meshes
              else ((args.multi_pod,)))
    for mp in meshes:
        res = run_cell(args.arch, args.shape, mp, overrides, args.tag)
        path = save_result(res)
        print(f"[dryrun] wrote {path}")


if __name__ == "__main__":
    main()
