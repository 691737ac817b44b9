"""End-to-end training driver (the reference's `repro/launch/train.py`),
on the card unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --device cpu --steps 50 --batch 8 --seq 64

As the reference, it always trains through a mesh: `make_local_mesh`
(1 x 1) by default, `make_production_mesh` (data 16 x model 16: 256
ranks, e.g. ``torchrun --nnodes 32 --nproc-per-node 8 -m
repro_torch.launch.train --production-mesh``) with ``--production-mesh``;
`run` trains on any mesh it is given (e.g. ``get_mesh("1x2", "cpu")`` in
each of 2 ranks under torchrun). Model (f32 params and compute, no
remat, as the reference trains) placed on the mesh -> each rank's
parameter and AdamW shards (`train_state_shardings`) -> the sharded
train step -> the synthetic pipeline (every rank draws the global
batch, host 0 of 1, and the step takes its block) -> the fault-tolerant
loop, with checkpoints resuming from the latest one in ``--ckpt-dir``.
Rank 0 alone prints and writes checkpoints.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.bridge import shard_params
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step, train_state_shardings
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.fault import FaultPolicy, FaultTolerantLoop
from repro_torch.sharding import ShardingRules, rank


def parse_args(argv=None) -> argparse.Namespace:
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
    return ap.parse_args(argv)


def run(args: argparse.Namespace, mesh, step_hook=None, ckpt=None) -> dict:
    """Train ``args.steps`` steps on ``mesh`` (this rank's share of it):
    {"losses", "grad_norms", "seconds", "state", "model"}. ``step_hook``
    wraps the step function (it receives the step and returns the one
    the loop runs); ``ckpt`` replaces the checkpoint manager."""
    cfg = get_config(args.arch, reduced=args.reduced).replace(
        param_dtype="float32", compute_dtype="float32", remat="none")
    rules = ShardingRules(mesh)
    model = Model(cfg).place(mesh, rules)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    pipe = SyntheticPipeline(cfg, DataConfig(args.batch, args.seq,
                                             seed=args.seed))
    # every rank draws the same whole tree and keeps its shards
    full = model.init(torch.Generator(device=mesh.device)
                      .manual_seed(args.seed))
    params = shard_params(full, model.placement.pspec, mesh)
    del full
    state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, args.microbatches)
    if step_hook is not None:
        step_fn = step_hook(step_fn)
    if ckpt is None:
        ckpt = CheckpointManager(
            args.ckpt_dir, keep=2, mesh=mesh,
            shardings=train_state_shardings(model, rules, opt_cfg))
    loop = FaultTolerantLoop(step_fn, ckpt,
                             FaultPolicy(checkpoint_every=args.ckpt_every))
    state, start = loop.resume_or_init(state)
    lead = rank() == 0
    if start and lead:
        print(f"[train] resumed from checkpoint at step {start}")

    losses, gnorms = [], []

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        if lead and (step % 10 == 0 or step == start):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"lr {float(metrics['lr']):.2e}")

    t0 = time.time()
    state, _ = loop.run(state, pipe.host_slice, start, args.steps,
                        on_metrics)
    dt = time.time() - t0
    if lead:
        tput = args.steps * args.batch * args.seq / max(dt, 1e-9)
        print(f"[train] {args.steps} steps in {dt:.1f}s on {mesh} "
              f"({mesh.device}, {tput:,.0f} tok/s), loss {losses[0]:.4f} "
              f"-> {losses[-1]:.4f}")
    return {"losses": losses, "grad_norms": gnorms, "seconds": dt,
            "state": state, "model": model}


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh = (make_production_mesh(device=dev) if args.production_mesh
            else make_local_mesh(dev))
    return run(args, mesh)["losses"]


if __name__ == "__main__":
    main()
