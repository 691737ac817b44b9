"""The port's sharded train step on real splits: gloo ranks at meshes
(data 1, model 2), (2, 1) and (2, 2), held to the reference's unsharded
`make_train_step` on the same global batch and weights.

The parent builds each case's reduced float32 config (the training
suites' cuts), draws the port's seed-0 weights and runs the reference's
train step (jitted on one CPU device, `FAST_COMPILE`) over two batches:
loss, grad norm, lr and the state after each step. The gradient AdamW
received at step t is read back from that state, exactly as AdamW
wrote it: mu_t = b1 mu_{t-1} + (1 - b1) g_t s_t, where s_t = min(1,
clip / grad norm_t) is the clipping scale (no second compile of the
loss's gradient). One spawn a mesh runs every case on every rank
(`torch_sharded_worker.train`): the rank's parameter and AdamW shards,
its block of the global batch, the step-1 gradients gathered whole, each
step's metrics and the state after two steps gathered whole.

Cases: granite-3-2b with its kv heads split over 'model' and, at one kv
head, replicated (the K/V projections then inside the attention's TP
region); fastvlm-1.7b's bias + tied-head twin (VLM patches, QKV bias, a
vocab-split tied head); deepseek-v2-lite cut to its dense layer and one
MoE layer (MLA, expert parallel MoE, the load-balancing term, a batch
whose repeated tokens overflow an expert in the capacity-dropping
forward, so rank-local dropping would differ); granite with
``fsdp=True`` (d_model dims over 'data'); granite at 2 microbatches with
a non-uniform loss mask; rwkv6-7b cut to one layer (the time mix's
heads split: r / k / v and the decay enter the split) and zamba2-1.2b's
cut (Mamba2 gathered and replicated, the shared attention block applied
twice). Besides: a checkpoint saved on (2, 2) after
step 1, restored on (1, 2) for step 2; one (2, 2) step's collectives by
kind, which the analytic walk of the same step on an abstract (2, 2)
mesh (meta tensors) must count alike, calls and bytes; the train CLI's
mesh function on (1, 2) against the CLI on 1 x 1.

Tolerances (f32), the training suites': loss and grad norm 1e-5
relative (`LOSS_RTOL`), each gradient leaf 1e-4 of its largest element
(`GRAD_TOL`), mu and nu after two steps 1e-4 of each leaf's largest
element (they are the gradients' moments). A parameter after two steps
is held to 1e-4 of its leaf's largest element (`PARAM_TOL`) where its
gradient in both steps is at least 1e-3 of the leaf's largest gradient;
below that, Adam's direction for the element rests on the rounding of a
near-zero gradient (the two frameworks differ by ~1e-6 of the leaf's
largest gradient). Such an element is held to a fraction of the steps'
own bound (each step moves it by at most lr (1 + wd |p|), so two runs
differ by at most twice the sum): `SMALL_GRAD_FRAC` = 0.1 of it, 3.9x
the largest fraction measured. The largest error of these elements a
case and mesh, as a fraction of the bound (this suite, on the CPU):

    case                    (1, 2)    (2, 1)    (2, 2)
    granite                1.07e-2   1.04e-2   8.88e-3
    granite_kv_replicated  5.12e-3   2.65e-3   4.98e-3
    fastvlm                7.99e-3   7.67e-3   8.11e-3
    deepseek               2.54e-2   1.16e-2   2.52e-2
    fsdp                   1.07e-2   1.04e-2   8.88e-3
    microbatches           1.26e-2   7.53e-3   1.20e-2
    rwkv6                  1.05e-3   7.75e-4   1.06e-3
    zamba2                 9.26e-3   1.03e-2   9.44e-3
    (resume on (1, 2): 8.88e-3)

Besides, every element whose reference update (after two steps, from
the initial weights) is larger than the element's tolerance moves the
same way in the port (the sign check).
"""

from __future__ import annotations

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_sharded_worker import join, start

from repro.launch.steps import make_train_step as ref_train_step
from repro.models import Model as RefModel
from repro.optim import adamw as RA
from repro_torch import bridge
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves_with_path
from test_torch_config import F32, _configs
from test_torch_train import (CUTS, FAST_COMPILE, GRAD_TOL, LOSS_RTOL,
                              train_batch)

jax.config.update("jax_platform_name", "cpu")

PARAM_TOL = 1e-4
MOMENT_TOL = 1e-4
WELL_POSED = 1e-3         # of a leaf's largest gradient, in both steps
SMALL_GRAD_FRAC = 0.1     # of Adam's two-step bound, below WELL_POSED
MESHES = [(1, 2), (2, 1), (2, 2)]
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=4)
B, S = 4, 24

# name -> (arch as the training suites name it, config overrides,
# microbatches); "fsdp" shares granite's reference (the flag places
# leaves, it changes nothing the loss computes)
CASES = {
    "granite": ("granite-3-2b", {}, 1),
    "granite_kv_replicated": ("granite-3-2b", {"num_kv_heads": 1}, 1),
    "fastvlm": ("fastvlm-small", {}, 1),
    "deepseek": ("deepseek-v2-lite", {}, 1),
    "fsdp": ("granite-3-2b", {"fsdp": True}, 1),
    "microbatches": ("granite-3-2b", {}, 2),
    "rwkv6": ("rwkv6-7b", {}, 1),
    "zamba2": ("zamba2-1.2b", {}, 1),
}


def _cfgs(name: str):
    arch, over, _ = CASES[name]
    rc, pc = _configs(arch)
    if arch in CUTS:
        from repro.configs import base as RB
        from repro_torch.configs import base as PB
        rc, pc = rc.replace(**CUTS[arch](RB)), pc.replace(**CUTS[arch](PB))
    return rc.replace(**F32, **over), pc.replace(**F32, **over)


def _batches(pc) -> list[dict]:
    return [train_batch(pc, B, S, seed=5), train_batch(pc, B, S, seed=6)]


def _flat(tree) -> dict:
    return {tuple(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _weights(name: str):
    _, pc = _cfgs(name)
    return bridge.tree_to_numpy(Model(pc).init(
        torch.Generator().manual_seed(0), device="cpu"))


@functools.lru_cache(maxsize=None)
def _oracle(name: str) -> dict:
    """The reference's metrics, states and AdamW gradients a step."""
    if name == "fsdp":
        return _oracle("granite")
    rc, pc = _cfgs(name)
    cfg = RA.AdamWConfig(**OPT)
    rstep = jax.jit(ref_train_step(RefModel(rc), cfg, CASES[name][2]),
                    compiler_options=FAST_COMPILE)
    state = RA.adamw_init(jax.tree.map(jnp.asarray, _weights(name)), cfg)
    out = {"metrics": [], "states": [], "grads": []}
    mu = {k: 0.0 for k in _flat(state.mu)}
    for batch in _batches(pc):
        state, m = rstep(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append({f: _flat(getattr(state, f))
                              for f in ("params", "mu", "nu")})
        scale = min(1.0, cfg.clip_norm / max(out["metrics"][-1]["grad_norm"],
                                             1e-9))
        new = out["states"][-1]["mu"]
        out["grads"].append({k: (new[k] - cfg.b1 * mu[k])
                             / ((1 - cfg.b1) * scale) for k in new})
        mu = new
    return out


def _payload() -> dict:
    cases = {}
    for name, (_, _, mb) in CASES.items():
        _, pc = _cfgs(name)
        cases[name] = dict(cfg=pc, weights=_weights(name), microbatches=mb,
                           batches=_batches(pc), opt=OPT)
    return cases


_RUNS: dict = {}


def _run(shape):
    """Every rank's results on ``shape``. The three meshes run once, the
    ranks of (2, 2) and (2, 1) while the parent computes the reference's
    steps; (2, 2) also checkpoints granite after step 1, which (1, 2)
    then restores."""
    if not _RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            payload = {"cases": _payload()}
            both = dict(payload, cases=dict(
                payload["cases"], ckpt=dict(payload["cases"]["granite"],
                                            save_dir=f"{tmp}/ckpt")))
            running = {s: start("train", p, s, f"{tmp}/{s[0]}{s[1]}")
                       for s, p in (((2, 2), both), ((2, 1), payload))}
            for name in CASES:
                _oracle(name)
            _RUNS[(2, 2)] = join(running.pop((2, 2)))
            last = dict(payload, cli=_cli_args() + ["--ckpt-dir",
                                                    f"{tmp}/cli"],
                        cases=dict(payload["cases"], resume=dict(
                            payload["cases"]["granite"],
                            resume_dir=f"{tmp}/ckpt")))
            running[(1, 2)] = start("train", last, (1, 2), f"{tmp}/12")
            for s in ((2, 1), (1, 2)):
                _RUNS[s] = join(running.pop(s))
    return _RUNS[shape]


def _scalar(got: float, want: float, tol: float = LOSS_RTOL):
    assert abs(got - want) <= tol * abs(want), (got, want)


def _leaves_close(got: dict, want: dict, tol: float, what):
    got = dict(tree_leaves_with_path(got))
    assert got.keys() == want.keys(), what
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (what, path, err)


def _params_close(got: dict, oracle: dict, init: dict, what):
    """Each parameter after two steps against the reference's, from the
    initial weights ``init`` (see the module docstring for the two
    regimes and the sign check)."""
    got = dict(tree_leaves_with_path(got))
    want = oracle["states"][-1]["params"]
    init = _flat(init)
    lrs = [m["lr"] for m in oracle["metrics"]]
    for path, w in want.items():
        err = np.abs(got[path] - w)
        posed = np.ones(w.shape, bool)
        for g in oracle["grads"]:
            g = np.abs(g[path])
            posed &= g >= WELL_POSED * g.max()
        bound = 2 * sum(lrs) * (1 + OPT_WD * np.abs(w).max())
        tol = np.where(posed, PARAM_TOL * np.abs(w).max(),
                       SMALL_GRAD_FRAC * bound)
        assert err[posed].max(initial=0) <= PARAM_TOL * np.abs(w).max(), \
            (what, path, err[posed].max())
        assert err[~posed].max(initial=0) <= SMALL_GRAD_FRAC * bound, \
            (what, path, err[~posed].max(), SMALL_GRAD_FRAC * bound)
        moved, ref = got[path] - init[path], w - init[path]
        assert err.max() <= bound, (what, path, err.max(), bound)
        sure = np.abs(ref) > tol
        assert np.array_equal(np.sign(moved[sure]), np.sign(ref[sure])), \
            (what, path, "an update of the wrong sign")


OPT_WD = RA.AdamWConfig().weight_decay


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_train_matches_reference(shape, case):
    """Every rank: each step's loss, grad norm and lr, the step-1
    gradients AdamW receives (whole), and params / mu / nu after two
    steps equal the reference's unsharded step."""
    oracle = _oracle(case)
    for rank, res in enumerate(_run(shape)):
        got = res[case]
        what = (case, shape, rank)
        for m, want in zip(got["metrics"], oracle["metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                _scalar(m[k], want[k])
        _leaves_close(got["grads"], oracle["grads"][0], GRAD_TOL, what)
        assert got["state"]["step"] == 2
        for f in ("mu", "nu"):
            _leaves_close(got["state"][f], oracle["states"][-1][f],
                          MOMENT_TOL, what + (f,))
        _params_close(got["state"]["params"], oracle, _weights(case),
                      what)


def test_checkpoint_saved_on_2x2_restores_on_1x2():
    """Granite's state after step 1 checkpointed on (2, 2) (rank 0
    writes whole leaves), restored on (1, 2) (each rank keeps its
    block), then step 2: its metrics and state are the uninterrupted
    reference's."""
    oracle = _oracle("granite")
    for rank, res in enumerate(_run((1, 2))):
        got = res["resume"]
        assert got["state"]["step"] == 2 and len(got["metrics"]) == 1
        for k in ("loss", "grad_norm", "lr"):
            _scalar(got["metrics"][0][k], oracle["metrics"][1][k])
        for f in ("mu", "nu"):
            _leaves_close(got["state"][f], oracle["states"][-1][f],
                          MOMENT_TOL, ("resume", rank, f))
        _params_close(got["state"]["params"], oracle, _weights("granite"),
                      ("resume", rank))


def test_collectives_of_one_2x2_step(capsys):
    """One (2, 2) step's collectives by kind (printed; PERF.md records
    them): every case all-reduces (the TP exits, the loss's global sums,
    the data-parallel gradient sums); FSDP reduce-scatters its gathered
    leaves' gradients; the capacity MoE all-gathers its expert counts;
    every rank issues the same."""
    runs = _run((2, 2))
    for case in CASES:
        c = runs[0][case]["collectives"]
        print(f"[collectives 2x2] {case}: {c}")
        assert all(r[case]["collectives"] == c for r in runs), case
        assert c.get("all-reduce", 0) > 0, (case, c)
    assert runs[0]["fsdp"]["collectives"].get("reduce-scatter", 0) > 0
    assert "reduce-scatter" not in runs[0]["granite"]["collectives"]
    assert (runs[0]["deepseek"]["collectives"]["all-gather"]
            > runs[0]["granite"]["collectives"]["all-gather"])
    assert "[collectives 2x2] granite" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["granite", "deepseek"])
def test_abstract_walk_collectives_equal_live_2x2(case):
    """The analytic walk (`launch.hlo_analysis.analyze`) of the case's
    train step on meta tensors over an abstract (2, 2) mesh, at rank 0's
    local state shapes: its collective counts and bytes by kind equal
    those the live (2, 2) gloo ranks counted in their first step."""
    from repro_torch import sharding as S
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.launch.steps import (abstract_train_state,
                                          make_train_step,
                                          train_state_shardings)
    from repro_torch.optim import AdamWConfig, TrainState
    from repro_torch.tree import tree_map

    live = _run((2, 2))[0][case]
    _, pc = _cfgs(case)
    mesh = abstract_mesh("2x2")
    model = Model(pc).place(mesh)
    opt = AdamWConfig(**OPT)
    full = abstract_train_state(model, opt)
    specs = train_state_shardings(model, model.placement.rules, opt)

    def local(t, spec):
        return torch.empty(S.local_shape(spec, tuple(t.shape), mesh),
                           dtype=t.dtype, device="meta")
    state = TrainState(*(tree_map(local, getattr(full, f), getattr(specs, f))
                         for f in ("params", "mu", "nu", "step")))
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in _batches(pc)[0].items()}
    a = hlo_analysis.analyze(make_train_step(model, opt, CASES[case][2]),
                             state, batch)
    assert a["collective_counts"] == live["collectives"], case
    moved = {k: v for k, v in a["collective_bytes"].items() if v}
    assert moved == {k: float(v) for k, v in
                     live["collective_bytes"].items()}, case
    assert a["collective_op_count"] == sum(live["collectives"].values())


def test_deepseek_batch_overflows_an_expert(monkeypatch):
    """The deepseek case's batch overflows an expert of its MoE layer in
    the global batch (its rows past the capacity drop), so a rank that
    dropped by its own rows' positions would differ."""
    _, pc = _cfgs("deepseek")
    seen = []
    real = L.moe_aux_loss

    def spy(p, cfg, x, dp=None):
        T = x.shape[0] * x.shape[1]
        top = torch.softmax(x.reshape(T, -1) @ p["router"], -1).topk(
            cfg.moe.top_k).indices
        seen.append((int(torch.bincount(top.reshape(-1)).max()),
                     L.moe_capacity(cfg, T, False)))
        return real(p, cfg, x, dp)
    monkeypatch.setattr(L, "moe_aux_loss", spy)
    params = bridge.params_from_jax(_weights("deepseek"))
    with torch.no_grad():
        Model(pc).loss(params, _batches(pc)[0])
    assert seen and any(n > cap for n, cap in seen), seen


def _cli_args() -> list[str]:
    return ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "4", "--seq", "16",
            "--ckpt-every", "100"]


def test_train_cli_mesh_function_on_1x2(tmp_path):
    """`launch.train.run` on the (1, 2) gloo mesh: both ranks' losses
    equal the CLI's on the default 1 x 1 mesh, and rank 0 alone
    prints."""
    r0, r1 = _run((1, 2))
    want = train_cli.main(_cli_args() + ["--ckpt-dir", str(tmp_path)])
    for r in (r0, r1):
        assert len(r["cli"]["losses"]) == 4
        for got, w in zip(r["cli"]["losses"], want):
            _scalar(got, w)
    assert "[train] step     0 loss" in r0["cli"]["printed"]
    assert r1["cli"]["printed"] == ""
