"""Rank side of the port's multi-rank tests (test_torch_sharded_serving,
test_torch_dataflow): gloo ranks on the CPU.

`spawn` starts ``world`` processes with the *spawn* start method (never
fork: the parent holds JAX threads), each joining a `FileStore` group
under the caller's temporary directory (xdist workers would collide on
TCP ports) with one intra-op thread. Each rank builds its mesh, runs
``job`` on the payload the parent pickled, and writes its result (or its
traceback) to a file of its own. The join has one deadline; ranks still
alive at it are killed, so a hung rendezvous fails the test instead of
running the suite into its time limit. This module imports torch and the
port only.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch


def spawn(job: str, payload: dict, shape: tuple[int, ...], tmp,
          timeout: float = 240.0) -> list:
    """Run ``job`` (a function of this module) on every rank of a
    (data, model) mesh of ``shape``; returns each rank's result."""
    return join(start(job, payload, shape, tmp, timeout))


def start(job: str, payload: dict, shape: tuple[int, ...], tmp,
          timeout: float = 240.0):
    """`spawn` without the wait: the ranks run while the caller works;
    `join` collects their results."""
    import multiprocessing as mp

    world = int(np.prod(shape))
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    pay = os.path.join(tmp, f"payload_{job}.pkl")
    with open(pay, "wb") as f:
        pickle.dump(payload, f)
    store = os.path.join(tmp, f"store_{job}_{'x'.join(map(str, shape))}")
    outs = [os.path.join(tmp, f"out_{job}_{r}.pkl") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, tuple(shape), job, pay, store,
                               outs[r]), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs, tuple(shape), time.monotonic() + timeout


def join(handle) -> list:
    """Each rank's result of a `start`ed job (its traceback raised)."""
    procs, outs, shape, deadline = handle
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {shape} wrote no result "
                               f"({'hung' if r in hung else 'died'})")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if isinstance(res, str):
            raise RuntimeError(f"rank {r} of {shape} failed:\n{res}")
        results.append(res)
    return results


def _rank_main(rank, world, shape, job, payload_path, store, out):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        mesh = make_mesh(shape, names, device="cpu")
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        res = globals()[job](mesh, payload)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        res = traceback.format_exc()
    with open(out, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# serving cases
# ---------------------------------------------------------------------------
def port_model(arch: str, kv_policy: str = "tiered", hot_window: int = 8,
               experts: int | None = None):
    """The reduced float32 config of the reference's serving tests;
    ``experts`` sets a MoE config's number of routed experts."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import Model

    cfg = get_config(arch, reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="none",
        kv_policy=kv_policy, kv_hot_window=hot_window)
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=experts))
    return cfg, Model(cfg)


def requests(specs: list[dict]):
    from repro_torch.serving import Request

    return [Request(rid=s["rid"], tokens=np.asarray(s["tokens"], np.int32),
                    max_new_tokens=s["max_new_tokens"],
                    patches=s["patches"], priority=s["priority"])
            for s in specs]


def generated(done) -> list:
    return [list(r.generated) for r in sorted(done, key=lambda r: r.rid)]


def _pool_shapes_ok(backend) -> bool:
    """Every pool leaf has the local shape its resolved spec gives."""
    from repro_torch.sharding import local_shape
    from repro_torch.tree import tree_leaves

    shapes, _ = backend.model.cache_spec(backend.num_slots, backend.max_len)
    state = backend.init_pool()
    leaves = tree_leaves(state.cache)
    specs = tree_leaves(backend._pool_specs)
    full = tree_leaves(shapes)
    return len(leaves) == len(specs) == len(full) and all(
        tuple(t.shape) == local_shape(s, tuple(f.shape), backend.mesh)
        for t, s, f in zip(leaves, specs, full))


def _preempted(backend, low, high, chunk):
    """A DRAM budget of exactly two residents, both slots decoding
    low-priority work when the priority-1 intruder lands (as the
    reference's preemption test drives it)."""
    from repro_torch.serving import CapacityBudget, Engine, FCFSScheduler

    hot_b, cold_b = backend.slot_kv_bytes()
    sched = FCFSScheduler(CapacityBudget(2 * hot_b, 1e15), hot_b, cold_b,
                          oversubscribe=1.0)
    eng = Engine(backend, scheduler=sched, chunk_tokens=chunk)
    for r in low:
        eng.submit(r)
    guard = 0
    while not (eng.pool.active_slots == 2 and eng._inflight is None):
        eng.step()
        guard += 1
        assert guard < 60, "victims never reached steady decode"
    eng.step()
    eng.submit(high)
    eng.run(max_steps=400)
    return eng


def _offloaded(backend, reqs, chunk, idle_steps=2):
    from repro_torch.serving import CapacityBudget, Engine, FCFSScheduler

    hot_b, cold_b = backend.slot_kv_bytes()
    sched = FCFSScheduler(CapacityBudget(2 * hot_b, 1e15), hot_b, cold_b,
                          oversubscribe=1.0, idle_offload_steps=idle_steps,
                          lane_bytes=backend.spill_lane_bytes())
    eng = Engine(backend, scheduler=sched, chunk_tokens=chunk)
    eng.run(reqs, max_steps=500)
    return eng


def _drain_warm(engine, reqs):
    engine.submit(reqs[0])
    while not engine.idle:
        engine.step()
    for r in reqs[1:]:
        engine.submit(r)
    while not engine.idle:
        engine.step()
    return [list(r.generated) for r in sorted(engine.finished,
                                              key=lambda r: r.rid)]


def serving(mesh, payload: dict) -> dict:
    """Every case of the payload on the port's ShardedBackend: tokens,
    the endurance audit, the pool's local shapes, the engine's stats."""
    from repro_torch import sharding as S
    from repro_torch.bridge import params_from_jax
    from repro_torch.serving import Engine, make_backend

    params = {a: params_from_jax(p) for a, p in payload["params"].items()}
    out = {}
    for name, case in payload["cases"].items():
        cfg, model = port_model(case["arch"], case.get("kv_policy",
                                                       "tiered"),
                                experts=case.get("experts"))
        kw = case.get("backend", {})
        be = make_backend("sharded", model, params[case["weights"]],
                          num_slots=case["slots"], max_len=case["max_len"],
                          device="cpu", mesh=mesh, **kw)
        res = {"pool_shapes_ok": _pool_shapes_ok(be)}
        S.reset_counts()
        kind, chunk = case["kind"], case.get("chunk")
        if kind == "preempt":
            reqs = requests(case["requests"])
            eng = _preempted(be, reqs[:-1], reqs[-1], chunk)
            toks = generated(eng.finished)
        elif kind == "offload":
            eng = _offloaded(be, requests(case["requests"]), chunk)
            toks = generated(eng.finished)
        elif kind == "paged":
            eng = Engine(be, chunk_tokens=chunk, paged=True)
            toks = _drain_warm(eng, requests(case["requests"]))
            res["prefix_hits"] = eng.stats["prefix_hits"]
        else:
            eng = Engine(be, chunk_tokens=chunk)
            toks = generated(eng.run(requests(case["requests"]),
                                     max_steps=900))
        res.update(tokens=toks, stats=dict(eng.stats),
                   endurance=eng.endurance_report(),
                   weight_stream=be.weight_stream,
                   collectives=S.counts_by_kind())
        out[name] = res
    return out


def serve_cli(mesh, payload: dict) -> dict:
    """The serve CLI on the rank's group: what it printed and the tokens
    it generated."""
    import contextlib
    import io

    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = main(payload["argv"])
    return {"printed": buf.getvalue(), "tokens": generated(done)}


# ---------------------------------------------------------------------------
# dataflow audit
# ---------------------------------------------------------------------------
def dataflow(mesh, payload: dict) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.core.dataflow import (audit_decode_collectives,
                                           audit_layer_collectives)

    out = {}
    for arch, over in payload["configs"].items():
        cfg = get_config(arch, reduced=True).replace(**over)
        out[arch] = {"forward": audit_layer_collectives(cfg, mesh,
                                                        batch=4, seq=32),
                     "decode": audit_decode_collectives(
                         cfg.replace(kv_policy="tiered"), mesh)}
    return out


# ---------------------------------------------------------------------------
# training cases
# ---------------------------------------------------------------------------
def _whole(tree, specs, mesh):
    """A tree of rank shards -> the whole tensors, as numpy."""
    import torch

    from repro_torch import sharding as S
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.tree import tree_map

    with torch.no_grad():
        return tree_to_numpy(tree_map(lambda t, s: S.unshard(t, s, mesh),
                                      tree, specs))


def _state_whole(state, pspec, mesh) -> dict:
    return {"params": _whole(state.params, pspec, mesh),
            "mu": _whole(state.mu, pspec, mesh),
            "nu": _whole(state.nu, pspec, mesh), "step": int(state.step)}


def train(mesh, payload: dict) -> dict:
    """Each case's sharded train steps from the payload's weights: the
    step-1 gradients as AdamW receives them (whole), every step's loss /
    grad norm / lr, the whole state after the last step and the first
    step's collectives by kind. A case with ``save_dir`` checkpoints the
    state after step 1 there (this mesh's shardings); ``resume``
    restores that checkpoint on this mesh and runs the next step."""
    from repro_torch import sharding as S
    from repro_torch.bridge import params_from_jax, shard_params
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps as ST
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init

    out = {}
    real = ST.adamw_update
    for name, case in payload["cases"].items():
        model = Model(case["cfg"]).place(mesh)
        pl = model.placement
        opt = AdamWConfig(**case["opt"])
        state = adamw_init(shard_params(params_from_jax(case["weights"]),
                                        pl.pspec, mesh), opt)
        shardings = ST.train_state_shardings(model, pl.rules, opt)
        ckpt = CheckpointManager(case.get("save_dir") or case.get(
            "resume_dir") or ".", keep=2, mesh=mesh, shardings=shardings)
        first = 0
        if case.get("resume_dir"):
            state, first = ckpt.restore(state)
            first += 1
        seen = {}

        def spy(st, grads, ocfg, *a):
            if "grads" not in seen:       # gathers not charged to the step
                counts = S.COUNTS.copy()
                seen["grads"] = _whole(grads, pl.pspec, mesh)
                S.COUNTS.clear()
                S.COUNTS.update(counts)
            return real(st, grads, ocfg, *a)
        step = ST.make_train_step(model, opt, case.get("microbatches", 1))
        res = {"metrics": []}
        ST.adamw_update = spy
        try:
            for i in range(first, len(case["batches"])):
                S.reset_counts()
                state, m = step(state, case["batches"][i])
                res.setdefault("collectives", S.counts_by_kind())
                res["metrics"].append({k: float(v) for k, v in m.items()})
                if case.get("save_dir") and i == 0:
                    ckpt.save(state, i)
        finally:
            ST.adamw_update = real
        res["grads"] = seen.get("grads")
        res["state"] = _state_whole(state, pl.pspec, mesh)
        out[name] = res
    if "cli" in payload:
        import contextlib
        import io

        from repro_torch.launch import train as cli
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = cli.run(cli.parse_args(payload["cli"]), mesh)
        out["cli"] = {"printed": buf.getvalue(), "losses": got["losses"]}
    return out


def pod_allreduce(mesh, payload: dict):
    """`compressed_pod_allreduce` of this pod's gradient (``payload``'s
    row at the rank's 'pod' coordinate) over a (pod, 1, 1) mesh."""
    import torch

    from repro_torch import sharding as S
    from repro_torch.runtime.overlap import compressed_pod_allreduce

    g = torch.from_numpy(payload["grads"][mesh.coord("pod")])
    S.reset_counts()
    out = compressed_pod_allreduce({"w": g}, mesh)["w"]
    return {"out": out.numpy(), "collectives": S.counts_by_kind()}
