"""PyTorch port (`repro_torch`): import hygiene, config parity, the
parameter bridge — and the shared, memoized reference/port model pairs
the other `test_torch_*` files import.

The reference side (JAX on the CPU) is built once per session and
arch, like `tests/conftest.py::build_model`; the port side gets the
reference's own `Model.init(PRNGKey(0))` weights through
`repro_torch.bridge.params_from_jax`, so both sides run identical
parameters.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.configs.base import get_config as ref_get_config
from repro.models import Model as RefModel
from repro_torch import bridge
from repro_torch.configs import base as PB
from repro_torch.configs.base import get_config
from repro_torch.models import Model

jax.config.update("jax_platform_name", "cpu")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_SRC = REPO / "src" / "repro_torch"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")

# the bias + tied-head fastvlm twin: the FULL config cut to test size
# (the registered reduced twins drop use_attn_bias / tie_embeddings)
FASTVLM_SMALL = dict(segments=(), num_layers=2, d_model=64, num_heads=6,
                     num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
# the MHA (G = 1), bias-free, untied-head mobilevlm-3b, cut the same way
MOBILEVLM_SMALL = dict(segments=(), num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
SMALL = {"fastvlm-small": ("fastvlm-1.7b", FASTVLM_SMALL),
         "mobilevlm-small": ("mobilevlm-3b", MOBILEVLM_SMALL)}
ARCHS = ("granite-3-2b", "fastvlm-small")


def _configs(arch: str):
    if arch in SMALL:
        full, cut = SMALL[arch]
        return (ref_get_config(full).replace(
                    frontend=RB.FrontendConfig("vision", 32, 8), **cut),
                get_config(full).replace(
                    frontend=PB.FrontendConfig("vision", 32, 8), **cut))
    return ref_get_config(arch, reduced=True), get_config(arch, reduced=True)


@functools.lru_cache(maxsize=None)
def build_pair(arch: str = "granite-3-2b", kv_policy: str = "tiered",
               hot_window: int = 8, ffn_weight_store: str = "native"):
    """(ref_cfg, ref_model, ref_params, cfg, model, params): the f32
    reference model and its port twin with the same weights. Memoized;
    treat both parameter trees as read-only."""
    rc, pc = _configs(arch)
    knobs = dict(F32, kv_policy=kv_policy, kv_hot_window=hot_window,
                 ffn_weight_store=ffn_weight_store)
    rc, pc = rc.replace(**knobs), pc.replace(**knobs)
    rmodel = RefModel(rc)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, rparams))
    return rc, rmodel, rparams, pc, Model(pc), params


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------
def test_import_leaves_jax_and_repro_out():
    """Importing the port and every submodule pulls in neither jax nor
    the reference package."""
    mods = []
    for f in sorted(PORT_SRC.rglob("*.py")):
        parts = f.relative_to(PORT_SRC.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 20


def test_no_port_file_imports_jax_or_repro():
    files = list(PORT_SRC.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, i, s)
            assert not s.startswith(("from repro.", "import repro.",
                                     "from repro import")), (f, i, s)


def test_nothing_builds_at_import():
    """Kernel libraries build at first CUDA use, never at import: the
    modules are importable where there is no nvcc."""
    from repro_torch.kernels import build
    assert build._loaded == {}
    lib = build.library_path("ffn_act")
    assert lib.parent == build.build_dir() and lib.name.startswith(
        "libffn_act-")


# ---------------------------------------------------------------------------
# config parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["fastvlm-1.7b", "mobilevlm-1.7b",
                                  "granite-3-2b", "nemotron-4-340b",
                                  "deepseek-v2-lite", "stablelm-12b",
                                  "starcoder2-7b", "paligemma-3b",
                                  "rwkv6-7b", "zamba2-1.2b",
                                  "hubert-xlarge", "llama4-maverick-400b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_field_by_field(arch, reduced):
    assert as_dict(get_config(arch, reduced=reduced)) == as_dict(
        ref_get_config(arch, reduced=reduced))


def test_registry_constants_match():
    assert PB.ASSIGNED_ARCHS == RB.ASSIGNED_ARCHS
    assert PB.PAPER_MODELS == RB.PAPER_MODELS
    assert [dataclasses.astuple(s) for s in PB.LM_SHAPES] == \
        [dataclasses.astuple(s) for s in RB.LM_SHAPES]
    # the port registers every arch of the reference
    assert set(PB.list_archs()) == set(RB.list_archs()) == {
        *PB.ASSIGNED_ARCHS, *PB.PAPER_MODELS}
    for arch in PB.list_archs():
        assert get_config(arch).param_count() == \
            ref_get_config(arch).param_count()


def test_small_fastvlm_keeps_bias_and_tied_head():
    rc, _, rparams, pc, _, params = build_pair("fastvlm-small")
    assert as_dict(pc) == as_dict(rc)
    assert pc.use_attn_bias and pc.tie_embeddings
    assert "bq" in params["units"]["u0"]["mixer"]
    assert "lm_head" not in params


def test_small_mobilevlm_is_mha_without_bias_with_untied_head():
    rc, _, rparams, pc, _, params = build_pair("mobilevlm-small")
    assert as_dict(pc) == as_dict(rc)
    assert pc.num_kv_heads == pc.num_heads
    assert not (pc.use_attn_bias or pc.use_mlp_bias or pc.tie_embeddings)
    assert "bq" not in params["units"]["u0"]["mixer"]
    assert params["lm_head"].shape == (pc.d_model, 256)


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ("deepseek-v2-lite",
                                          "hubert-xlarge",
                                          "llama4-maverick-400b"))
def test_bridge_maps_every_leaf_exactly(arch):
    _, rmodel, rparams, _, model, params = build_pair(arch)
    flat_ref = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(rparams)[0]}
    back = bridge.tree_to_numpy(params)
    flat_back = {jax.tree_util.keystr(p): v for p, v in
                 jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_ref.keys() == flat_back.keys()
    for k in flat_ref:
        np.testing.assert_array_equal(flat_back[k], flat_ref[k], err_msg=k)
    # the port's own init draws the same tree shape and dtypes
    own = model.init(torch.Generator().manual_seed(0))
    own_flat = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(
                    bridge.tree_to_numpy(own))[0]}
    assert {k: (v.shape, v.dtype) for k, v in own_flat.items()} == \
        {k: (v.shape, v.dtype) for k, v in flat_ref.items()}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bridge_carries_int8_ffn_tree_as_is():
    """The int8 "RRAM" FFN store crosses the bridge leaf for leaf: the
    same paths, int8 payloads and f32 scales, equal values; the port's
    own init draws the reference's leaves, dtypes and scale values."""
    _, _, rparams, pc, model, params = build_pair(
        "mobilevlm-small", ffn_weight_store="int8")
    ref, port = _flat(rparams), _flat(bridge.tree_to_numpy(params))
    assert ref.keys() == port.keys()
    mlp = [k for k in ref if "['mlp']" in k]
    assert {k.rsplit("[", 1)[1] for k in mlp} == {
        "'w_up_q']", "'w_up_scale']", "'w_gate_q']", "'w_gate_scale']",
        "'w_down_q']", "'w_down_scale']"}
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert all(ref[k].dtype == (np.int8 if k.endswith("_q']")
                                else np.float32) for k in mlp)
    own = _flat(bridge.tree_to_numpy(
        model.init(torch.Generator().manual_seed(0))))
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in ref.items()}
    for k in mlp:
        if k.endswith("_scale']"):
            np.testing.assert_array_equal(own[k], ref[k], err_msg=k)
        else:
            assert np.abs(own[k].astype(int)).max() <= 127


def test_bridge_bfloat16_round_trip_is_exact():
    import ml_dtypes
    a = np.random.default_rng(0).standard_normal((5, 7)).astype(
        ml_dtypes.bfloat16)
    t = bridge.array_to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    back = bridge.tensor_to_array(t)
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
