"""Readings that the limits of ``correct`` are set from, for one cell:
the program's numbers on each seed and, at the same seeds and sizes, a
control's (the reference in a lower precision put in the program's
place) or a planted fault's. Not part of a benchmark run.

    python chipbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--control fp8|tf32] [--fault half|token]

One process, on the card, runs the seeds one after another (each a full
run of the cell with a short window) and writes a JSON line a seed to
standard output and to ``chiprun_out/chipbench/control-<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent)] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]

from chipbench import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.prepare_env(run.CHECKOUT)
    cell = spec.cell(args.workload, run.CHECKOUT)
    out_dir = run.CHECKOUT / "chiprun_out" / "chipbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    kw = {}
    if args.control:
        kw["arith"] = args.control
    if args.fault:
        kw["fault"] = args.fault
    with open(out_dir / f"control-{args.workload}.jsonl", "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = run.run_cell(cell, seed, args.seconds, False, args.device,
                               t0, **kw)
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "control": args.control, "fault": args.fault,
                               "numbers": out["numbers"],
                               "metrics": out["result"]["metrics"],
                               "run_s": time.perf_counter() - t0})
            print(line, flush=True)
            f.write(line + "\n")
            del out
            gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
