"""The training cells: the port's train step, fed from the seed.

Set-up (``setup_s``): the kernels built or loaded, the float32 weights
drawn on the card, AdamW's state, and the first three steps, which go
through the window's own call and feed on rows that all differ: their
losses, the first step's gradients as the optimizer took them (worked
out from its first moment: mu = (1 - b1) g after one step) and each
leaf's change after the three (against the initial leaf, drawn again
from the seed) are kept for the check before step 4 writes over them.
TF32 is off, as the configuration states float32.

The window: steps 4, 5, ... on fresh rows for ``seconds``; the host
queues them as fast as the card takes them, and the window closes when
the card has finished the step that crossed ``seconds``. Its rate counts
every position of every row of those steps.

With ``--trace 1`` a profiled window of ``profile_steps`` further steps
follows. Then ``correct``: the program's state is freed and the plain
reference (`reference.train`) takes the same three steps from the same
weights and rows (`check.train_numbers`).
"""

from __future__ import annotations

import gc
import math
import sys
import time

from chipbench import check, generate, profiling, program, weights, work
from chipbench.reference import train as reftrain
from chipbench.serve import Phases

CLOCK = time.perf_counter
CHECKED_STEPS = 3


def spans(d: work.Dims, rows: int, pk: dict) -> profiling.Spans:
    """The training ranges: forward and backward, the optimizer, and the
    forward FFN (its products against the TF32 rate)."""
    steps, fusion = program.train_modules()
    sp = profiling.Spans()
    sp.add(steps, "_value_and_grad", "forward_backward")
    sp.add(steps, "adamw_update", "optimizer")
    sp.add(fusion, "apply_ffn", "ffn.train",
           lambda *a, **k: work.bound_s(work.ffn_flops(d, rows),
                                        work.ffn_bytes(d, rows, 4), pk,
                                        "float32"))
    return sp


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, arith: str | None = None, fault: str | None = None
        ) -> dict:
    """One run of a training cell. ``arith`` (a control) and ``fault``
    ("half": the mean over half of each batch; "token": one token of
    each batch altered) put the reference, so changed, in the program's
    place and read its numbers beside the program's."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup, traffic, config = cell.setup, cell.traffic, cell.config
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    d = work.dims(config)
    phases = Phases(t_start, sync)
    built = program.build_kernels() if cuda else []
    phases.mark("kernels")
    mdl = program.model(program.port_config(config, setup))
    step_fn, ocfg, adamw_init = program.train_step(mdl, setup["adamw"])
    state = adamw_init(weights.make(mdl, d.V, seed, device), ocfg)
    phases.mark("weights and state")

    def feed(t):
        return generate.train_batch(traffic, d.V, d.Fv, seed, t, device)
    losses = []
    state, m = step_fn(state, feed(0))
    losses.append(float(m["loss"]))
    grads = {p: float(mu.norm()) / (1 - ocfg.b1)
             for p, mu in weights.flatten(state.mu).items()}
    for t in range(1, CHECKED_STEPS):
        state, m = step_fn(state, feed(t))
        losses.append(float(m["loss"]))
    now = weights.flatten(state.params)
    with torch.no_grad():
        change = {p: float((now[p] - p0).norm())
                  for p, p0 in weights.leaves(mdl, d.V, seed, device)}
    del now
    prog = {"losses": losses, "grad_norms": grads, "change_norms": change}
    phases.mark("checked steps")
    open_t = CLOCK()
    setup_s = open_t - t_start
    t, window_losses = CHECKED_STEPS, []
    while True:
        state, m = step_fn(state, feed(t))
        window_losses.append(m["loss"])
        t += 1
        if CLOCK() - open_t >= seconds:
            break
    sync()
    close_t = CLOCK()
    n_steps = t - CHECKED_STEPS
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    B, S, Tv = traffic["batch"], traffic["seq"], traffic["image_tokens"]
    pk = work.peaks(torch.cuda.get_device_name() if cuda else "")
    prof = None
    if trace and cuda:
        sp = spans(d, B * S, pk)

        def run_steps():
            nonlocal state, t
            for _ in range(setup["profile_steps"]):
                with torch.profiler.record_function(profiling.PREFIX + "step"):
                    state, _ = step_fn(state, feed(t))
                t += 1
            return {"steps": setup["profile_steps"]}
        prof = profiling.window(run_steps, sp, program.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = {"kind": "train", "setup_s": setup_s, "window_s": close_t - open_t,
           "built": built, "setup_phases": phases.seconds,
           "train_steps": n_steps,
           "train_tokens": n_steps * B * S,
           "work_flops": n_steps * work.train_step_flops(d, B, S, Tv),
           "peak_flops": pk["float32"], "profile": prof}
    del state, m, step_fn, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = CLOCK()
    batches = [feed(i) for i in range(CHECKED_STEPS)]

    def reference(ar="float32", batch_fn=None):
        bs = batches if batch_fn is None else [batch_fn(b) for b in batches]
        out = reftrain.steps(
            weights.make(mdl, d.V, seed, device), config, bs,
            setup["adamw"], lambda: weights.leaves(mdl, d.V, seed, device),
            ar)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return out
    ref = reference()
    numbers = check.train_numbers(prog, ref)
    if arith:
        numbers.update({f"control_{k}": v for k, v in check.train_numbers(
            reference(arith), ref).items()})
    if fault:
        numbers.update({f"{fault}_{k}": v for k, v in check.train_numbers(
            reference(batch_fn=lambda b: FAULTS[fault](b, d.V)),
            ref).items()})
    sync()
    print(f"[chipbench] reference: {CHECKED_STEPS} steps in "
          f"{CLOCK() - t_ref:.1f} s", file=sys.stderr)
    return {"rec": rec, "numbers": numbers, "attempted": n_steps,
            "failed": failed, "memory_peak_bytes": peak}


def _half(batch: dict, vocab: int) -> dict:
    """The first half of the batch's rows: the mean taken over them."""
    n = batch["tokens"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def _token(batch: dict, vocab: int) -> dict:
    """One text token of the batch altered where it is fed."""
    out = dict(batch)
    toks = batch["tokens"].clone()
    toks[0, 1] = (toks[0, 1] + 1) % vocab
    out["tokens"] = toks
    return out


FAULTS = {"half": _half, "token": _token}
