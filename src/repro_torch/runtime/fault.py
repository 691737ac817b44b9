"""Fault tolerance, straggler mitigation and elastic re-meshing (the
reference's `repro/runtime/fault.py`).

  (a) crash     -> CheckpointManager (atomic publish) + the seekable data
                   pipeline: a restart replays from the last step exactly.
  (b) straggler -> a per-step deadline; a step over it is reported as a
                   trip and counted in ``trips`` (by step); a failing
                   step is retried, and past ``max_retries_per_step``
                   the loop restores the last checkpoint and resumes
                   after it. ``suspect_threshold`` is the reference's
                   field, which it declares and never reads: neither
                   package evicts a host.
  (c) elastic   -> `shrink_mesh_axes` picks the smaller mesh after a pod
                   drops (the decision only); a checkpoint saved on one
                   mesh restores onto another (`CheckpointManager` with
                   the new mesh's shardings).

One difference on a mesh. The reference's step is one SPMD program: a
fault fails it on every device at once, and every device retries. On a
torch mesh each rank runs its own loop; a rank whose step raises alone
retries while its peers wait in the step's next collective until the
process group's timeout. The retry is right only where every rank
raises (e.g. one input fault every rank sees); a rank-local fault ends
in that timeout, and the job restarts from the last checkpoint.

The loop runs in-process; on a cluster the same state machine runs in
the job coordinator. A retried step must find the state as the failed
attempt found it: the port's train step (`launch.steps.make_train_step`)
computes the loss and every gradient before `adamw_update` writes the
state in place. A failure once that write has begun raises
`PartialUpdateError`; the state is then neither the old one nor the new
one, so the loop does not retry the step but restores the last
checkpoint at once (and re-raises where there is none).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import PartialUpdateError


@dataclasses.dataclass
class FaultPolicy:
    step_deadline_s: float = 300.0      # straggler trip wire
    max_retries_per_step: int = 2       # then restore the last checkpoint
    checkpoint_every: int = 50
    suspect_threshold: int = 3          # trips before a host is suspect


@dataclasses.dataclass
class StepReport:
    step: int
    duration_s: float
    retries: int
    deadline_trip: bool


class FaultTolerantLoop:
    """Wraps a step callable with the deadline, checkpoint and resume
    logic."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 policy: FaultPolicy = FaultPolicy()):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.policy = policy
        self.trips: dict[int, int] = {}
        self.reports: list[StepReport] = []

    def resume_or_init(self, state):
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        state, step = self.ckpt.restore(state, latest)
        return state, step + 1

    def run(self, state, batches: Callable[[int], dict], start_step: int,
            num_steps: int, on_metrics: Callable | None = None):
        step = start_step
        end = start_step + num_steps
        while step < end:
            t0 = time.time()
            retries = 0
            while True:
                try:
                    state, metrics = self.step_fn(state, batches(step))
                    break
                except PartialUpdateError:
                    # half written: a retry would apply the update twice
                    # to the leaves already written
                    if self.ckpt.latest_step() is None:
                        raise
                    state, ck_step = self.ckpt.restore(state)
                    step = ck_step + 1
                    retries = 0
                except Exception:  # noqa: BLE001 — host fault surface
                    retries += 1
                    if retries > self.policy.max_retries_per_step:
                        # escalate: restore the last checkpoint (the
                        # re-mesh entry point on a cluster)
                        state, ck_step = self.ckpt.restore(state)
                        step = ck_step + 1
                        retries = 0
            dur = time.time() - t0
            trip = dur > self.policy.step_deadline_s
            if trip:
                self.trips[step] = self.trips.get(step, 0) + 1
            self.reports.append(StepReport(step, dur, retries, trip))
            if on_metrics is not None:
                on_metrics(step, metrics)
            if (step + 1) % self.policy.checkpoint_every == 0:
                self.ckpt.save(state, step)
            step += 1
        self.ckpt.save(state, step - 1)
        return state, step


def shrink_mesh_axes(n_pods_alive: int, multi_pod_shape=(2, 16, 16)):
    """Elastic re-mesh decision: drop the dead pod(s), keep (data, model)
    intact so only the batch section changes. Returns the new mesh shape
    and its axis names."""
    pod, data, model = multi_pod_shape
    alive = max(1, min(n_pods_alive, pod))
    if alive == 1:
        return (data, model), ("data", "model")
    return (alive, data, model), ("pod", "data", "model")
