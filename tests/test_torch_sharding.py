"""The port's sharding resolver and logical-axis trees against the
reference's.

Every case of tests/test_sharding.py restated against
`repro_torch.sharding.ShardingRules` (same expected specs, the same
hypothesis properties), then the resolved spec of every parameter, cache
(tiered and flat, 4 slots, max_len 512), extend and prefix leaf of every
registered config (full size on the meta device, and the reduced twins)
held equal to the reference's on six abstract meshes. No process is
spawned; the reference's shape and logical trees are built once per
config.
"""

import functools

import jax
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.sharding import ShardingRules as RefRules  # noqa: E402

from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import (DEFAULT_RULES, AbstractMesh,  # noqa: E402
                                  ShardingRules, local_shape)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def mesh():
    return AbstractMesh((16, 16), ("data", "model"))


@pytest.fixture(scope="module")
def rules(mesh):
    return ShardingRules(mesh)


def test_divisible_dims_bind(rules):
    spec = rules.spec(("batch", None, "vocab"), (256, 4096, 49408))
    assert spec == ("data", None, "model")


def test_indivisible_dims_replicate(rules):
    # 36 heads % 16 != 0 -> replicate that dim
    spec = rules.spec(("batch", None, "heads", None), (256, 128, 36, 128))
    assert spec == ("data", None, None, None)


def test_axis_conflict_falls_through(rules):
    # batch takes 'data'; kv_seq_shard then takes 'model'; kv_heads (8)
    # can neither divide nor reuse 'model' -> replicated
    spec = rules.spec(("batch", "kv_seq_shard", "kv_heads", None),
                      (128, 32768, 8, 128))
    assert spec == ("data", "model", None, None)


def test_long_context_batch1_seq_shards(rules):
    # batch=1 can't shard -> kv_seq takes 'data', heads take 'model'
    spec = rules.spec(("batch", "kv_seq_shard", "kv_heads", None),
                      (1, 524288, 32, 64))
    assert spec == (None, "data", "model", None)


def test_multipod_batch():
    rules3 = ShardingRules(AbstractMesh((2, 16, 16),
                                        ("pod", "data", "model")))
    spec = rules3.spec(("batch", None), (256, 4096))
    assert spec == (("pod", "data"), None)


def test_fsdp_embed_binds_data(rules):
    spec = rules.spec(("fsdp_embed", "mlp"), (18432, 73728))
    assert spec == ("data", "model")


def test_unknown_logical_axis_raises(rules):
    with pytest.raises(KeyError):
        rules.spec(("nonsense",), (8,))


def test_with_overrides_and_local_shape(mesh):
    r = ShardingRules(mesh).with_overrides(kv_seq_shard=(("model",), ()))
    spec = r.spec(("batch", "kv_seq_shard", "kv_heads", None),
                  (1, 4096, 32, 64))
    assert spec == (None, "model", None, None)
    assert local_shape(spec, (1, 4096, 32, 64), mesh) == (1, 256, 32, 64)
    assert DEFAULT_RULES["batch"] == (("pod", "data"), ("data",))


def test_abstract_mesh_names():
    assert abstract_mesh("production").shape == {"data": 16, "model": 16}
    assert abstract_mesh("multipod").shape == {"pod": 2, "data": 16,
                                               "model": 16}
    assert abstract_mesh("2x4").shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="unknown mesh"):
        abstract_mesh("sideways")


# ---------------------------------------------------------------------------
# property tests
# ---------------------------------------------------------------------------
LOGICAL = st.sampled_from(list(DEFAULT_RULES.keys()))
DIMS = st.integers(min_value=1, max_value=2 ** 20)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(LOGICAL, DIMS), min_size=1, max_size=5))
def test_spec_resolution_total_and_divisible(entries):
    """For ANY combination of logical axes and dim sizes the resolver must
    (a) never raise, (b) only bind mesh axes whose product divides the dim,
    (c) never bind one mesh axis to two dims — and agree with the
    reference's resolver."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    logical = tuple(e[0] for e in entries)
    shape = tuple(e[1] for e in entries)
    spec = ShardingRules(mesh).spec(logical, shape)
    used = []
    for dim, binding in zip(shape, spec):
        if binding is None:
            continue
        axes = binding if isinstance(binding, tuple) else (binding,)
        prod = 1
        for a in axes:
            prod *= mesh.shape[a]
            used.append(a)
        assert dim % prod == 0, (logical, shape, spec)
    assert len(used) == len(set(used)), (logical, shape, spec)
    ref = RefRules(JAbstractMesh((16, 16), ("data", "model")))
    assert spec == tuple(ref.spec(logical, shape))


@settings(max_examples=100, deadline=None)
@given(DIMS, DIMS)
def test_batch_vocab_consistency(b, v):
    rules = ShardingRules(AbstractMesh((16, 16), ("data", "model")))
    spec = rules.spec(("batch", "vocab"), (b, v))
    if b % 16 == 0:
        assert spec[0] == "data"
    if v % 16 == 0:
        assert spec[1] == "model"


# ---------------------------------------------------------------------------
# every leaf of every registered config against the reference
# ---------------------------------------------------------------------------
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
SLOTS, MAX_LEN = 4, 512
PREFIX_BLOCKS, BLOCK_TOKENS = 16, 128


def _is_lg(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict whose leaves are tuples / arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _ref_trees(arch: str, reduced: bool, policy: str):
    """The reference's {kind: {path: (shape, logical)}}, built once."""
    cfg = ref_get_config(arch, reduced=reduced).replace(kv_policy=policy)
    m = RefModel(cfg)
    trees = {}
    parts = {"params": m.abstract_params(),
             "cache": m.cache_spec(SLOTS, MAX_LEN),
             "extend": m.extend_spec(1, MAX_LEN),
             "prefix": m.extend_spec(PREFIX_BLOCKS, BLOCK_TOKENS)}
    for kind, (shapes, logical) in parts.items():
        sh = _flat(jax.tree.map(lambda s: tuple(s.shape), shapes))
        lg = {p: v for p, v in _flat_lg(logical).items()}
        trees[kind] = {p: (sh[p], lg[p]) for p in sh}
    return trees


def _flat_lg(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_lg(v, prefix + (k,)))
        return out
    assert _is_lg(tree), (prefix, tree)
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str, reduced: bool, policy: str):
    cfg = get_config(arch, reduced=reduced).replace(kv_policy=policy)
    m = Model(cfg)
    trees = {}
    parts = {"params": m.abstract_params(),
             "cache": m.cache_spec(SLOTS, MAX_LEN),
             "extend": m.extend_spec(1, MAX_LEN),
             "prefix": m.extend_spec(PREFIX_BLOCKS, BLOCK_TOKENS)}
    for kind, (shapes, logical) in parts.items():
        sh = {p: tuple(t.shape) for p, t in tree_leaves_with_path(shapes)}
        lg = _flat_lg(logical)
        trees[kind] = {p: (sh[p], lg[p]) for p in sh}
    return trees


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_resolved_specs_equal_reference(arch, reduced):
    """Same leaves, shapes and logical axes, and on every mesh the same
    resolved spec per leaf (params; tiered and flat caches; extend;
    prefix blocks)."""
    jmeshes = [JAbstractMesh(s, n) for s, n in MESHES]
    pmeshes = [AbstractMesh(s, n) for s, n in MESHES]
    for policy in ("tiered", "flat"):
        ref = _ref_trees(arch, reduced, policy)
        mine = _port_trees(arch, reduced, policy)
        for kind in ref:
            if kind == "params" and policy == "flat":
                continue
            assert set(mine[kind]) == set(ref[kind]), (kind, arch)
            for path, (shape, lg) in ref[kind].items():
                assert mine[kind][path] == (shape, lg), (kind, path)
            for jm, pm in zip(jmeshes, pmeshes):
                rr, pr = RefRules(jm), ShardingRules(pm)
                for path, (shape, lg) in ref[kind].items():
                    assert pr.spec(lg, shape) == tuple(rr.spec(lg, shape)), \
                        (arch, kind, path, pm)


def test_param_and_cache_shardings_trees():
    """`param_shardings` / `cache_shardings` / `extend_shardings` return
    one spec per leaf, in the leaves' tree."""
    cfg = get_config("fastvlm-1.7b").replace(kv_policy="tiered")
    m = Model(cfg)
    rules = ShardingRules(AbstractMesh((1, 2), ("data", "model")))
    ps = m.param_shardings(rules)
    assert ps["units"]["u0"]["mixer"]["wq"] == (None, None, "model", None)
    assert ps["embed"]["table"] == ("model", None)
    cs = m.cache_shardings(rules, SLOTS, MAX_LEN)
    assert cs["u0"]["k"]["cold_q"] == (None, "data", "model", None, None)
    assert cs["u0"]["k"]["hot"] == (None, "data", None, "model", None)
    es = m.extend_shardings(rules, 1, MAX_LEN)
    assert es["u0"]["k_ws"] == (None, "data", "model", None, None)


def test_live_mesh_world_one_and_counted_collectives():
    """A world-1 gloo mesh (the FileStore group `make_local_mesh` makes
    when none exists); a mesh larger than the world raises, naming both
    sizes; each collective wrapper counts one call by its kind, in the
    innermost scope."""
    import torch

    from repro_torch import sharding as S
    from repro_torch.launch.mesh import get_mesh
    mesh = get_mesh("1x1", device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.is_abstract
    assert mesh.coord("model") == 0 and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="2 devices, the world size is 1"):
        get_mesh("1x2", device="cpu")
    S.reset_counts()
    t = torch.arange(6.0).reshape(2, 3)
    with S.scope("u0"):
        assert torch.equal(S.all_reduce(t.clone(), mesh, "model"), t)
        assert torch.equal(S.all_gather(t, mesh, "model", dim=1), t)
        assert torch.equal(S.reduce_scatter(t, mesh, "data", dim=0), t)
        assert torch.equal(S.broadcast(t.clone(), mesh, "data", 0), t)
    assert S.counts_by_kind("u") == {"all-reduce": 1, "all-gather": 1,
                                     "reduce-scatter": 1, "broadcast": 1}
    spec = ("data", None, "model")
    assert torch.equal(S.unshard(S.shard(t[None], spec, mesh), spec, mesh),
                       t[None])


def test_logical_helpers_equal_reference():
    """The per-store logical trees are the reference's, helper by
    helper."""
    from repro.core import kv_tiers as RKT
    from repro.models import attention as RA
    from repro.models import ssm as RS
    from repro_torch.core import kv_tiers as KT
    from repro_torch.models import attention as A
    from repro_torch.models import ssm as SSM
    for inner in (("kv_heads", None), (None,)):
        assert KT.tiered_logical(inner) == RKT.tiered_logical(inner)
        for pol in ("flat", "tiered"):
            assert KT.store_logical(inner, pol) == \
                RKT.store_logical(inner, pol)
    assert A.flat_cache_logical() == RA.flat_cache_logical()
    assert A.mla_cache_logical() == RA.mla_cache_logical()
    assert SSM.rwkv6_state_logical() == RS.rwkv6_state_logical()
    assert SSM.mamba2_state_logical() == RS.mamba2_state_logical()
