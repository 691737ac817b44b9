"""End-to-end training driver (the reference's `repro/launch/train.py`),
on the card unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --device cpu --steps 50 --batch 8 --seq 64

Model (f32 params and compute, no remat, as the reference trains) ->
AdamW -> the synthetic pipeline -> the fault-tolerant loop with
checkpoints, resuming from the latest one in ``--ckpt-dir``. One device:
``--production-mesh`` raises until multi-device work (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: ROADMAP Queue 1 item 10b (multi-device "
            "training)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced).replace(
        param_dtype="float32", compute_dtype="float32", remat="none")
    model = Model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    pipe = SyntheticPipeline(cfg, DataConfig(args.batch, args.seq,
                                             seed=args.seed))
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, args.microbatches)

    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    loop = FaultTolerantLoop(step_fn, ckpt,
                             FaultPolicy(checkpoint_every=args.ckpt_every))
    state, start = loop.resume_or_init(state)
    if start:
        print(f"[train] resumed from checkpoint at step {start}")

    losses = []

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0 or step == start:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")

    t0 = time.time()
    state, end = loop.run(state, pipe.host_slice, start, args.steps,
                          on_metrics)
    dt = time.time() - t0
    tput = args.steps * args.batch * args.seq / max(dt, 1e-9)
    print(f"[train] {args.steps} steps in {dt:.1f}s on {dev} "
          f"({tput:,.0f} tok/s), loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
