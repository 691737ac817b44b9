"""The port's evaluation grid (`launch/cells.py`), train-state and batch
shardings (`launch/steps.py`), `runtime/overlap.py` and the fault
policy's fields, against the reference's.

For every assigned arch: the cells (names, skip reasons), the runnable
ones, each cell's config field by field, its gradient-accumulation
factor and dtype, the batch's logical axes and the input stand-ins'
shapes and dtypes (meta tensors in the port). The train-state and batch
specs of every assigned arch's train cell equal the reference's
`NamedSharding` specs on the six abstract meshes of the sharding suite.
`compressed_pod_allreduce` on two gloo ranks of a (pod 2) mesh, with the
reference suite's two pods of gradients, equals the reference body's
math on one device (the shared max scale, both pods quantized on it,
the int32 sum dequantized, over 2), and passes a mesh without 'pod'
through untouched; `unrolled_scan` equals `jax.lax.scan`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from test_torch_sharding import MESHES
from test_weight_stream import _G0, _G1
from torch_sharded_worker import spawn

from repro.configs.base import ASSIGNED_ARCHS as REF_ARCHS
from repro.core import quant as RQ
from repro.launch import cells as RC
from repro.launch import steps as RS
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.runtime import fault as RF
from repro.runtime import overlap as RO
from repro.sharding import ShardingRules as RefRules
from repro_torch.configs.base import ASSIGNED_ARCHS
from repro_torch.launch import cells as C
from repro_torch.launch import steps as ST
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import fault as F
from repro_torch.runtime.overlap import (compressed_pod_allreduce,
                                         straggler_allreduce_timeout_stub,
                                         unrolled_scan)
from repro_torch.sharding import AbstractMesh, ShardingRules
from repro_torch.tree import tree_leaves_with_path

jax.config.update("jax_platform_name", "cpu")

TORCH_DTYPE = {torch.int32: "int32", torch.float32: "float32"}


def _cells(mod, arch):
    return [(c.name, c.skip_reason) for c in mod.all_cells()
            if c.arch == arch]


def _flat_specs(tree) -> dict:
    """{leaf path: spec tuple} of a reference tree of NamedShardings."""
    return {tuple(k.key for k in path): tuple(v.spec) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_assigned_archs_and_cell_count():
    assert ASSIGNED_ARCHS == REF_ARCHS
    assert [(c.name, c.skip_reason) for c in C.all_cells()] == \
        [(c.name, c.skip_reason) for c in RC.all_cells()]
    assert len(C.all_cells()) == 40
    assert [c.name for c in C.runnable_cells()] == \
        [c.name for c in RC.runnable_cells()]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cells_equal_reference(arch):
    """Cells, skips, configs, microbatches, accumulation dtype, batch
    logical axes and input stand-ins of ``arch``'s four shapes."""
    assert _cells(C, arch) == _cells(RC, arch)
    for cell, rcell in zip([c for c in C.all_cells() if c.arch == arch],
                           [c for c in RC.all_cells() if c.arch == arch]):
        assert cell.shape.name == rcell.shape.name
        cfg = C.cell_config(arch, cell.shape)
        rcfg = RC.cell_config(arch, rcell.shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg), cell
        over = C.cell_config(arch, cell.shape, kv_policy="tiered")
        assert over.kv_policy == "tiered"
        assert C.train_microbatches(arch, cell.shape) == \
            RC.train_microbatches(arch, rcell.shape)
        assert C.grad_accum_dtype(arch) == RC.grad_accum_dtype(arch)
        assert C.batch_logical(cfg, cell.shape) == \
            RC.batch_logical(rcfg, rcell.shape)
        got = C.input_specs(cfg, cell.shape)
        want = RC.input_specs(rcfg, rcell.shape)
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.is_meta
            assert tuple(t.shape) == tuple(want[k].shape), (cell.name, k)
            assert TORCH_DTYPE[t.dtype] == str(want[k].dtype), (cell.name, k)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_train_state_and_batch_shardings_equal_reference(arch):
    """The train cell's state specs (params, mu, nu: the params'; step
    replicated) and batch specs on the sharding suite's abstract
    meshes; the abstract state's shapes and dtypes."""
    shape = next(c.shape for c in C.all_cells()
                 if c.arch == arch and c.shape.kind == "train")
    cfg, rcfg = C.cell_config(arch, shape), RC.cell_config(arch, shape)
    opt, ropt = AdamWConfig(state_dtype="bfloat16"), \
        RefAdamWConfig(state_dtype="bfloat16")
    model = Model(cfg)
    abstract = ST.abstract_train_state(model, opt)
    rabstract = RS.abstract_train_state(RefModel(rcfg), ropt)
    for f in ("params", "mu", "nu"):
        got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in tree_leaves_with_path(getattr(abstract, f))}
        want = {tuple(k.key for k in path): (tuple(v.shape), str(v.dtype))
                for path, v in jax.tree_util.tree_flatten_with_path(
                    getattr(rabstract, f))[0]}
        assert got == want, f
    assert abstract.step.is_meta and abstract.step.dtype == torch.int32
    for mshape, names in MESHES:
        rules = ShardingRules(AbstractMesh(mshape, names))
        rrules = RefRules(JAbstractMesh(mshape, names))
        st = ST.train_state_shardings(model, rules, opt)
        rst = RS.train_state_shardings(RefModel(rcfg, rrules), rrules, ropt)
        for f in ("params", "mu", "nu"):
            assert dict(tree_leaves_with_path(getattr(st, f))) == \
                _flat_specs(getattr(rst, f)), (f, mshape)
        assert st.step == tuple(rst.step.spec) == ()
        assert ST.replicated(rules) == tuple(RS.replicated(rrules).spec)
        specs = C.input_specs(cfg, shape)
        rspecs = RC.input_specs(rcfg, shape)
        got = ST.batch_shardings(cfg, shape, rules, specs)
        want = RS.batch_shardings(rcfg, shape, rrules, rspecs)
        assert got == {k: tuple(v.spec) for k, v in want.items()}, mshape


def _pod_reference(g0, g1):
    """The reference body on one device: the pods' max scale, each pod
    quantized on it, the int32 payloads summed, dequantized, over 2."""
    a, b = jnp.asarray(g0), jnp.asarray(g1)
    shared = jnp.maximum(RQ.grad_scale(a), RQ.grad_scale(b))
    qa, _ = RQ.compress_grad(a, scale=shared)
    qb, _ = RQ.compress_grad(b, scale=shared)
    qsum = qa.astype(jnp.int32) + qb.astype(jnp.int32)
    return np.asarray(RQ.decompress_grad(qsum, shared, a.dtype) / 2)


def test_compressed_pod_allreduce_equals_reference_body(tmp_path):
    grads = np.stack([_G0, _G1])
    outs = spawn("pod_allreduce", {"grads": grads}, (2, 1, 1), tmp_path)
    want = _pod_reference(_G0, _G1)
    for r in outs:
        np.testing.assert_array_equal(r["out"], want)
        # one max of the scales, one sum of the payloads
        assert r["collectives"] == {"all-reduce": 2}
    # the shared grid is what makes it right (pod 0's tiny payload kept)
    np.testing.assert_allclose(want, (_G0 + _G1) / 2,
                               atol=np.abs(grads).max() / 127 / 2 + 1e-7)


def test_compressed_pod_allreduce_passthrough_and_stub():
    grads = {"w": torch.ones(3)}
    for shape, names in MESHES[:5]:          # no 'pod' axis
        assert compressed_pod_allreduce(
            grads, AbstractMesh(shape, names)) is grads
    x = torch.arange(4.0)
    assert straggler_allreduce_timeout_stub(x) is x
    assert np.array_equal(np.asarray(RO.straggler_allreduce_timeout_stub(
        jnp.arange(4.0))), x.numpy())


@pytest.mark.parametrize("unroll", [1, 2])
def test_unrolled_scan_equals_reference(unroll):
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)

    def body_t(c, x):
        c = c * 0.5 + x
        return c, c.sum()

    def body_j(c, x):
        c = c * 0.5 + x
        return c, c.sum()
    carry, ys = unrolled_scan(body_t, torch.zeros(2), torch.from_numpy(xs),
                              unroll)
    rcarry, rys = RO.unrolled_scan(body_j, jnp.zeros(2), jnp.asarray(xs),
                                   unroll)
    np.testing.assert_allclose(carry.numpy(), np.asarray(rcarry))
    np.testing.assert_allclose(ys.numpy(), np.asarray(rys))
    total, none = unrolled_scan(lambda c, x: (c + x["a"], None), 0.0,
                                {"a": torch.ones(3)}, unroll)
    assert float(total) == 3.0 and none is None
    with pytest.raises(ValueError):
        unrolled_scan(body_t, torch.zeros(2), torch.from_numpy(xs), 0)


def test_fault_policy_fields_equal_reference():
    got = {f.name: f.default for f in dataclasses.fields(F.FaultPolicy)}
    want = {f.name: f.default for f in dataclasses.fields(RF.FaultPolicy)}
    assert got == want and got["suspect_threshold"] == 3
    assert [f.name for f in dataclasses.fields(F.StepReport)] == \
        [f.name for f in dataclasses.fields(RF.StepReport)]
