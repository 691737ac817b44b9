"""Run one cell of the benchmark once, on the card, and print its result.

    python chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, ``chipbench/``
and the program (``src/repro_torch``). The cell's files are found by
name (`spec`). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared, with its limit, which also close
standard error.

Exit codes: 2 when the checkout lacks the program or the card (no
result is printed), 3 when a module of JAX or of the JAX package was
loaded in this process (no result). Every cache and build directory of
the program lies in the checkout's ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# run as a script, this file's directory heads sys.path, where its
# sibling modules would shadow top-level ones (``profile``)
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
BANNED = ("jax", "jaxlib", "flax", "repro")


def prepare_env(root: pathlib.Path) -> None:
    """The program's build and cache directories at fixed paths in the
    checkout; its serving knobs left to the cell (no REPRO_SERVE_*)."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for k in list(os.environ):
        if k.startswith("REPRO_SERVE_"):
            del os.environ[k]
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def metrics(cell, rec: dict, trace: bool) -> dict:
    from chipbench import spec
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, **control) -> dict:
    """One run of a cell on ``device``: the result object (the contract's
    keys) and the run's record. ``control`` reaches the cell's loop (a
    control's precision or a planted fault)."""
    from chipbench import check, serve, train
    kind = cell.setup["kind"]
    out = (serve if kind == "serve" else train).run(
        cell, seed, seconds, trace, device, t_start, **control)
    ok, checks = check.judge(out["numbers"], cell.setup["limits"])
    rec = out["rec"]
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": device, "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if device == "cuda":
        import torch
        dev["kind"] = torch.cuda.get_device_name()
    result = {"correct": bool(ok), "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": metrics(cell, rec, trace), "device": dev}
    prof = rec.get("profile")
    if trace and prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in checks.items()}
    return {"result": result, "rec": rec, "numbers": out["numbers"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None,
                    help="also write the run's record (JSON) to this path")
    args = ap.parse_args(argv)
    root = CHECKOUT
    if not (root / "BENCHMARK.json").is_file() \
            or not (root / "src" / "repro_torch").is_dir():
        print("[chipbench] the checkout lacks BENCHMARK.json or the program "
              "(src/repro_torch): nothing to run", file=sys.stderr)
        return 2
    prepare_env(root)
    from chipbench import spec
    cell = spec.cell(args.workload, root)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"[chipbench] the cell needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    gc.collect()
    found = banned_modules()
    if found:
        print(f"[chipbench] modules of JAX or of the JAX package were loaded "
              f"in this process: {found}; no result", file=sys.stderr)
        return 3
    res = out["result"]
    if args.record:
        with open(args.record, "w") as f:
            json.dump({"result": res, "numbers": out["numbers"],
                       "rec": out["rec"]}, f, default=str)
    print(json.dumps(res), flush=True)
    for k, v in res["checks"].items():
        print(f"[check] {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
