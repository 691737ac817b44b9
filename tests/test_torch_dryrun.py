"""The port's analytic dry run (`launch/hlo_analysis.py`, `launch/dryrun.py`)
against the reference's, on the CPU.

* `model_flops` equals the reference's for every runnable cell, and
  `roofline_terms` returns the reference's dict on the same results once
  the reference's three constants are set to the port's (H100) values.
* The walk's FLOPs less its recompute FLOPs (`KernelGrad`'s rerun of the
  plain twins' forward, which the reference's gradient does not do) equal
  the reference's `hlo_analysis.analyze` of the compiled step's HLO
  exactly, for reduced granite-3-2b and the fastvlm-1.7b twin (bias,
  tied head, patches), f32, one device: prefill, decode and train steps.
* The argument bytes of every runnable cell on both production meshes
  equal the bytes the reference's specs imply on a
  `jax.sharding.AbstractMesh` (16 x 16 and 2 x 16 x 16): params + AdamW
  state + step + batch for a train cell, params + batch for a prefill
  cell, params + cache + tokens for a decode cell, each at rank 0's
  local shape. Both sides from shapes only: nothing is walked or
  allocated (the reference's cache shapes come from `jax.eval_shape`).
* The CLI writes one cell's JSON with the reference's keys; `--list`
  prints the reference's grid; importing the dry run leaves JAX out.

The walk's collectives on an abstract (2, 2) mesh are held to the live
gloo ranks' in tests/test_torch_sharded_train.py, whose spawned ranks
count them.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import shape_by_name as ref_shape_by_name
from repro.launch import cells as RC
from repro.launch import hlo_analysis as RH
from repro.launch import steps as RS
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.sharding import ShardingRules as RefRules
from repro.sharding import tree_shardings as ref_tree_shardings
from repro_torch.configs.base import shape_by_name
from repro_torch.launch import cells as PC
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as PH
from repro_torch.launch import steps as PS
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from test_torch_config import F32, _configs

jax.config.update("jax_platform_name", "cpu")

CELLS = [c.name for c in PC.runnable_cells()]
REF_MESHES = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def test_grid_equals_reference():
    """40 cells, 31 runnable, the same names and skips."""
    got = [(c.name, c.skip_reason) for c in PC.all_cells()]
    want = [(c.name, c.skip_reason) for c in RC.all_cells()]
    assert got == want and len(got) == 40 and len(CELLS) == 31


@pytest.mark.parametrize("cell", CELLS)
def test_model_flops_equal_reference(cell):
    arch, shape = cell.split("@")
    pc = PC.cell_config(arch, shape_by_name(shape))
    rc = RC.cell_config(arch, ref_shape_by_name(shape))
    assert pc.active_param_count() == rc.active_param_count()
    assert PH.model_flops(pc.active_param_count(), shape_by_name(shape)) \
        == RH.model_flops(rc.active_param_count(), ref_shape_by_name(shape))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_roofline_terms_equal_reference(shape, monkeypatch):
    """Every key and value of the reference's dict, on results whose
    compute, memory and collective terms each dominate once (and one
    with no walk figures, read from ``cost``)."""
    monkeypatch.setattr(RH, "PEAK_FLOPS", PH.PEAK_FLOPS)
    monkeypatch.setattr(RH, "HBM_BW", PH.HBM_BW)
    monkeypatch.setattr(RH, "ICI_BW", PH.NVLINK_BW)
    for flops, nbytes, coll in ((9e15, 1e9, 1e8), (1e12, 5e12, 1e9),
                                (1e12, 1e9, 4e11), (0.0, 0.0, 3e9)):
        res = {"n_chips": 256, "active_params": 2_500_000_000,
               "cost": {"flops_per_device": 2e12,
                        "bytes_accessed_per_device": 3e10},
               "collectives": {"hlo_flops": flops, "hlo_bytes": nbytes,
                               "total": coll}}
        got = PH.roofline_terms(res, shape_by_name(shape))
        want = RH.roofline_terms(res, ref_shape_by_name(shape))
        assert got == want


# ---------------------------------------------------------------------------
# the walk against the reference's HLO walk, one device
# ---------------------------------------------------------------------------
B, S = 2, 32


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _steps(arch: str, kind: str):
    """(the port's step and meta arguments, the reference's jitted step
    and ShapeDtypeStruct arguments) of reduced ``arch`` in f32."""
    rc, pc = _configs(arch)
    rc, pc = rc.replace(**F32), pc.replace(**F32)
    model, rmodel = Model(pc), RefModel(rc)
    sds = jax.ShapeDtypeStruct
    tv = pc.frontend.num_tokens if pc.frontend is not None else 0
    batch = {"tokens": _meta((B, S - tv), torch.int32)}
    rbatch = {"tokens": sds((B, S - tv), jnp.int32)}
    if tv:
        fd = pc.frontend.frontend_dim
        batch["patches"] = _meta((B, tv, fd), torch.float32)
        rbatch["patches"] = sds((B, tv, fd), jnp.float32)
    if kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
        rbatch["labels"] = sds((B, S), jnp.int32)
        opt = AdamWConfig()
        return ((PS.make_train_step(model, opt),
                 (PS.abstract_train_state(model, opt), batch)),
                (jax.jit(RS.make_train_step(rmodel, RefAdamWConfig())),
                 (RS.abstract_train_state(rmodel, RefAdamWConfig()),
                  rbatch)))
    params, _ = model.abstract_params()
    rparams, _ = rmodel.abstract_params()
    if kind == "prefill":
        return ((PS.make_prefill_step(model, S), (params, batch)),
                (jax.jit(RS.make_prefill_step(rmodel, S)),
                 (rparams, rbatch)))
    cache, _ = model.cache_spec(B, S)
    rcache = jax.eval_shape(lambda: _zeros(rmodel.cache_spec(B, S)[0]))
    return ((PS.make_serve_step(model),
             (params, _meta((B, 1), torch.int32), cache, S - 1)),
            (jax.jit(RS.make_serve_step(rmodel)),
             (rparams, sds((B, 1), jnp.int32), rcache,
              sds((), jnp.int32))))


def _zeros(shapes):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "fastvlm-small"])
def test_walk_flops_equal_reference_hlo(arch, kind):
    (step, args), (rstep, rargs) = _steps(arch, kind)
    a = PH.analyze(step, *args)
    want = RH.analyze(rstep.lower(*rargs).compile().as_text())["flops"]
    assert want > 0
    assert a["flops"] - a["recompute_flops"] == want, (a, want)
    # only the training step's backward reruns the kernels' twins
    assert (a["recompute_flops"] > 0) == (kind == "train")
    assert a["temp_bytes"] > 0 and a["bytes"] > 0
    assert a["collective_op_count"] == 0


def test_walk_counts_kernel_sites_by_operands():
    """A kernel wrapper's call is one call site: its bytes are its
    operands and outputs, not the twin's temporaries, and the temporaries
    are not live memory; the same twin called outside a site is counted
    op by op."""
    from repro_torch.kernels import ops

    q = _meta((1, 64, 2, 16), torch.float32)
    site = PH.analyze(lambda: ops.attn_stream(q, q, q))
    io_bytes = 4 * q.numel() * q.element_size()
    assert site["bytes"] == io_bytes
    assert site["temp_bytes"] == q.numel() * q.element_size()
    plain = PH.analyze(lambda: ops._attn_plain(q, q, q, True))
    assert plain["flops"] == site["flops"] > 0
    assert plain["bytes"] > site["bytes"]
    assert plain["temp_bytes"] > site["temp_bytes"]


# ---------------------------------------------------------------------------
# argument bytes against the reference's specs, both production meshes
# ---------------------------------------------------------------------------
def _local_bytes(sds, sharding) -> int:
    return (math.prod(sharding.shard_shape(tuple(sds.shape)))
            * jnp.dtype(sds.dtype).itemsize)


def _ref_argument_bytes(arch: str, shape_name: str, multi_pod: bool) -> int:
    shape = ref_shape_by_name(shape_name)
    cfg = RC.cell_config(arch, shape)
    rules = RefRules(AbstractMesh(*REF_MESHES[multi_pod]))
    model = RefModel(cfg, rules)
    specs = RC.input_specs(cfg, shape)
    b_sh = RS.batch_shardings(cfg, shape, rules, specs)
    leaves = [_local_bytes(specs[k], b_sh[k]) for k in specs]
    if shape.kind == "train":
        opt = RefAdamWConfig(state_dtype="bfloat16"
                             if cfg.param_dtype == "bfloat16"
                             else "float32")
        leaves += jax.tree.leaves(jax.tree.map(
            _local_bytes, RS.abstract_train_state(model, opt),
            RS.train_state_shardings(model, rules, opt)))
        return sum(leaves)
    p, _ = model.abstract_params()
    leaves += jax.tree.leaves(jax.tree.map(_local_bytes, p,
                                           model.param_shardings(rules)))
    if shape.kind == "decode":
        # the cache's shapes traced, never allocated
        box = {}

        def spec():
            shp, box["logical"] = model.cache_spec(shape.global_batch,
                                                   shape.seq_len)
            return _zeros(shp)
        shp = jax.eval_shape(spec)
        leaves += jax.tree.leaves(jax.tree.map(
            _local_bytes, shp, ref_tree_shardings(rules, box["logical"],
                                                  shp)))
    return sum(leaves)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_reference_specs(cell, multi_pod):
    arch, shape = cell.split("@")
    got = PH.nbytes(dryrun.cell_step(arch, shape, multi_pod)["inputs"])
    assert got == _ref_argument_bytes(arch, shape, multi_pod) > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_writes_one_cell_with_reference_keys(tmp_path, monkeypatch):
    """`python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
    decode_32k` (its `main`): one JSON with the reference's keys at every
    level, the port's own beside them."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k"])
    path = tmp_path / "granite-3-2b@decode_32k@pod16x16.json"
    assert f"[dryrun] wrote {path}" in buf.getvalue()
    res = json.loads(path.read_text())
    want = {"cell", "arch", "shape", "mesh", "n_chips", "compile_s",
            "memory", "cost", "collectives", "params", "active_params",
            "padded_vocab", "roofline"}
    assert want <= set(res)
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "peak_bytes"} <= set(res["memory"])
    assert {"flops_per_device", "bytes_accessed_per_device"} \
        <= set(res["cost"])
    assert {"ops", "by_kind", "total", "hlo_flops", "hlo_bytes",
            "recompute_flops"} <= set(res["collectives"])
    assert set(RH._COLLECTIVES) <= set(res["collectives"]["by_kind"])
    assert {"compute_s", "memory_s", "collective_s", "dominant", "bound_s",
            "model_flops", "hlo_flops_total", "useful_flops_ratio",
            "roofline_fraction"} == set(res["roofline"])
    mem = res["memory"]
    assert (res["mesh"], res["n_chips"]) == ("pod16x16", 256)
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] == _ref_argument_bytes(
        "granite-3-2b", "decode_32k", False)
    assert res["collectives"]["total"] == sum(
        res["collectives"]["by_kind"].values()) > 0
    assert res["collectives"]["recompute_flops"] == 0


def test_cli_list_prints_the_grid():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(["--list"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 40
    assert sum(ln.rstrip().endswith("RUN") for ln in lines) == 31


def test_dryrun_import_leaves_jax_out():
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.launch.hlo_analysis; "
            "print('jax' in sys.modules)")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("arch", ["granite-3-2b", "fastvlm-small",
                                  "deepseek-v2-lite", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_placed_steps_walk_on_an_abstract_2x2_mesh(arch):
    """Every mixer's prefill, decode and train step on a model placed on
    an abstract (2, 2) mesh walks at rank 0's local shapes (the dry run's
    path at test size), with the collectives the placement issues; an
    RWKV6 prefill starts its state at the rank's heads."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.optim import TrainState
    from repro_torch.sharding import local_shape
    from repro_torch.tree import tree_map

    _, pc = _configs(arch)
    pc = pc.replace(**F32)
    mesh = abstract_mesh("2x2")
    model = Model(pc).place(mesh)
    rules = model.placement.rules

    def local(t, spec):
        return _meta(local_shape(spec, tuple(t.shape), mesh), t.dtype)
    p_full, _ = model.abstract_params()
    params = tree_map(local, p_full, model.param_shardings(rules))
    toks = _meta((4, S), torch.int32)
    batch = {"tokens": toks}
    if pc.frontend is not None:
        tv = pc.frontend.num_tokens
        batch = {"tokens": _meta((4, S - tv), torch.int32),
                 "patches": _meta((4, tv, pc.frontend.frontend_dim),
                                  torch.float32)}
    pre = PH.analyze(model.prefill, params, batch, S)
    c_full, _ = model.cache_spec(4, S)
    c_sh = model.cache_shardings(rules, 4, S)
    dec = PH.analyze(model.decode_step, params, _meta((2, 1), torch.int32),
                     tree_map(local, c_full, c_sh), S - 1, specs=c_sh)
    opt = AdamWConfig()
    full = PS.abstract_train_state(model, opt)
    sh = PS.train_state_shardings(model, rules, opt)
    state = TrainState(*(tree_map(local, getattr(full, f), getattr(sh, f))
                         for f in ("params", "mu", "nu", "step")))
    tr = PH.analyze(PS.make_train_step(model, opt), state,
                    dict(batch, labels=_meta((4, S), torch.int32)))
    for a in (pre, dec, tr):
        assert a["flops"] > 0 and a["collective_op_count"] > 0, arch
