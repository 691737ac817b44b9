"""The port's ShardedBackend on real splits: gloo ranks at meshes
(data 1, model 2), (2, 1) and (2, 2), each running the reference's
sharded serving cases, held token for token to the reference's
`LocalBackend` engine on the same weights and requests.

The parent builds the reference's reduced float32 models (the serving
suites' `conftest.build_model`), runs the reference engine for every
case once (the oracle), and hands the ranks the reference's own weights
(numpy, through a file) and the request streams. One spawn a mesh runs
every case (`torch_sharded_worker.serving`): GQA tiered with padded
buckets and slot recycling, MLA + MoE, the flat policy, a VLM mixed
stream (test_serving_sharded.py), MLA + MoE with three routed experts
(replicated over a 2-way model axis) beside a split shared expert,
chunked granite and zamba2
(test_serving_chunked.py), a preemption and an idle offload through
the spill lanes (test_serving_preempt.py / test_serving_spill.py), the
paged prefix pool (test_serving_paged.py) and weight streaming
(test_weight_stream.py). Every case also checks that each rank's pool
leaves have the local shapes of the port's `cache_shardings`, that
those specs equal the reference's, and the endurance audit.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
from conftest import build_model, make_requests
from jax.sharding import AbstractMesh as JAbstractMesh
from torch_sharded_worker import port_model, spawn

from repro.serving import Engine as RefEngine
from repro.serving import LocalBackend as RefLocal
from repro.serving import make_synthetic_requests as ref_synthetic
from repro.sharding import ShardingRules as RefRules
from repro_torch.sharding import AbstractMesh, ShardingRules
from repro_torch.tree import tree_leaves_with_path

jax.config.update("jax_platform_name", "cpu")

GRANITE, DEEPSEEK, ZAMBA2 = "granite-3-2b", "deepseek-v2-lite", "zamba2-1.2b"
MESHES = [(1, 2), (2, 1), (2, 2)]


def _paged_requests(cfg, head=12, tails=(4, 1, 4), gen=5, seed=3):
    """test_serving_paged's shared-head stream."""
    from repro.serving import Request
    rng = np.random.default_rng(seed)
    head_toks = rng.integers(0, cfg.vocab_size, head).astype(np.int32)
    out = []
    for i, tail in enumerate(tails):
        toks = head_toks if tail == 0 else np.concatenate(
            [head_toks, rng.integers(0, cfg.vocab_size, tail)
             .astype(np.int32)])
        out.append(Request(rid=i, tokens=np.asarray(toks, np.int32),
                           max_new_tokens=gen))
    return out


# name -> (arch, kv_policy, slots, max_len, kind, request maker, extra)
CASES = {
    "gqa_tiered": (GRANITE, "tiered", 4, 24, "engine", lambda c: make_requests(
        c, [(16, 8), (13, 8), (8, 6), (16, 4), (13, 6), (8, 8)], seed=3),
        {}),
    "mla_moe": (DEEPSEEK, "tiered", 4, 24, "engine", lambda c: make_requests(
        c, [(16, 6), (13, 6), (16, 4), (8, 6)], seed=3), {}),
    # 3 experts do not divide model 2 (replicated), the shared F 64 does
    # (split): only the shared output may enter the all-reduce
    "moe_shared_split": (DEEPSEEK, "tiered", 4, 24, "engine",
                         lambda c: make_requests(
                             c, [(16, 6), (13, 6), (16, 4), (8, 6)], seed=3),
                         {"experts": 3}),
    "flat": (GRANITE, "flat", 4, 24, "engine", lambda c: make_requests(
        c, [(16, 6), (13, 6), (8, 4), (16, 4)], seed=3), {}),
    "vlm": ("mobilevlm-1.7b", "tiered", 2, 32, "engine",
            lambda c: ref_synthetic(c, 3, prompt_len=20, gen_len=4, seed=2,
                                    image_every=2), {}),
    "chunked_granite": (GRANITE, "tiered", 2, 24, "engine",
                        lambda c: make_requests(
                            c, [(16, 6), (13, 6), (8, 4), (16, 4)], seed=3),
                        {"chunk": 5}),
    "chunked_zamba2": (ZAMBA2, "tiered", 2, 48, "engine",
                       lambda c: make_requests(c, [(40, 6), (24, 4)],
                                               seed=3), {"chunk": 16}),
    "preempt": (GRANITE, "tiered", 2, 32, "preempt", lambda c: make_requests(
        c, [(12, 10), (12, 10), (8, 4)], seed=3, priorities=[0, 0, 1]),
        {"chunk": 5}),
    "offload": (GRANITE, "tiered", 2, 32, "offload", lambda c: make_requests(
        c, [(12, 10), (12, 10), (8, 6)], seed=3),
        {"backend": {"spill_compress": False}}),
    "paged": (GRANITE, "tiered", 2, 24, "paged", _paged_requests,
              {"chunk": 6, "backend": {"block_tokens": 4}}),
    "weight_stream": (GRANITE, "tiered", 2, 24, "engine",
                      lambda c: make_requests(
                          c, [(16, 6), (13, 6), (8, 4)], seed=3),
                      {"chunk": 5, "backend": {"weight_stream": 1}}),
}


def _spec(r) -> dict:
    return {"rid": r.rid, "tokens": np.asarray(r.tokens),
            "max_new_tokens": r.max_new_tokens, "priority": r.priority,
            "patches": None if r.patches is None else np.asarray(r.patches)}


@functools.lru_cache(maxsize=None)
def _ref_model(arch: str, pol: str, experts: int | None = None):
    """The reference's (cfg, model, params) of a case: `build_model`'s,
    with ``experts`` routed experts where a case sets them."""
    if experts is None:
        return build_model(arch, kv_policy=pol)
    from repro.models import Model as RefModel
    cfg, _, _ = build_model(arch, kv_policy=pol)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=experts))
    model = RefModel(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _oracle_and_payload():
    """(the reference LocalBackend engine's tokens a case, the ranks'
    payload), built once."""
    oracle, cases, params = {}, {}, {}
    for name, (arch, pol, slots, max_len, kind, make, extra) in \
            CASES.items():
        experts = extra.get("experts")
        cfg, model, p = _ref_model(arch, pol, experts)
        weights = arch if experts is None else f"{arch}/E{experts}"
        params[weights] = jax.tree.map(np.asarray, p)
        eng = RefEngine(RefLocal(model, p, slots, max_len))
        done = eng.run(make(cfg), max_steps=400)
        oracle[name] = [list(r.generated)
                        for r in sorted(done, key=lambda r: r.rid)]
        cases[name] = dict(arch=arch, kv_policy=pol, slots=slots,
                           max_len=max_len, kind=kind, weights=weights,
                           requests=[_spec(r) for r in make(cfg)], **extra)
    return oracle, {"cases": cases, "params": params}


_RUNS: dict = {}


def _run(shape):
    if shape not in _RUNS:
        import tempfile
        _, payload = _oracle_and_payload()
        with tempfile.TemporaryDirectory() as tmp:
            _RUNS[shape] = spawn("serving", payload, shape, tmp)
    return _RUNS[shape]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_matches_reference_local(shape, case):
    """Every rank's token streams == the reference LocalBackend's; the
    rank's pool leaves at their local shapes; write-once endurance; and
    what the case drives really happened (chunks, an eviction, an idle
    offload, prefix hits, a streamed unit)."""
    oracle, payload = _oracle_and_payload()
    runs = _run(shape)
    arch, pol, slots, max_len, kind, _, extra = CASES[case]
    for rank, res in enumerate(runs):
        got = res[case]
        assert got["tokens"] == oracle[case], (case, shape, rank)
        assert got["pool_shapes_ok"], (case, shape, rank)
        if pol == "tiered":
            assert got["endurance"]["write_once_ok"], (case, rank)
    stats = runs[0][case]["stats"]
    if extra.get("chunk") and kind == "engine":
        assert stats["prefill_chunks"] > len(oracle[case])
    if kind == "preempt":
        assert stats["evictions"] >= 1
        assert stats["restores"] == stats["evictions"]
    if kind == "offload":
        assert stats["idle_offloads"] >= 1
        assert stats["restores"] == stats["idle_offloads"]
    if kind == "paged":
        assert runs[0][case]["prefix_hits"] == 2
    if case == "weight_stream":
        assert runs[0][case]["weight_stream"] == 1
    if shape[1] > 1:              # a model split really communicates
        assert runs[0][case]["collectives"].get("all-reduce", 0) > 0
    if shape[0] > 1 and slots % shape[0] == 0:
        assert runs[0][case]["collectives"].get("all-gather", 0) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_pool_specs_equal_reference(case):
    """The port's resolved pool / extend specs for the case's config equal
    the reference's on every mesh the ranks run."""
    from repro.models import Model as RefModel
    arch, pol, slots, max_len, _, _, extra = CASES[case]
    rcfg, _, _ = _ref_model(arch, pol, extra.get("experts"))
    rm = RefModel(rcfg)
    _, pm = port_model(arch, pol, experts=extra.get("experts"))
    for shape in MESHES:
        rr = RefRules(JAbstractMesh(shape, ("data", "model")))
        pr = ShardingRules(AbstractMesh(shape, ("data", "model")))
        for kind, (ref, mine) in {
                "cache": (rm.cache_spec(slots, max_len),
                          pm.cache_shardings(pr, slots, max_len)),
                "extend": (rm.extend_spec(1, max_len),
                           pm.extend_shardings(pr, 1, max_len))}.items():
            shapes, logical = ref
            want = jax.tree.map(
                lambda lg, sd: tuple(rr.spec(lg, sd.shape)), logical, shapes,
                is_leaf=lambda x: isinstance(x, tuple) and all(
                    isinstance(e, (str, type(None))) for e in x))
            got = dict(tree_leaves_with_path(mine))
            flat = {tuple(k.key for k in path): v for path, v in
                    jax.tree_util.tree_flatten_with_path(
                        want, is_leaf=lambda x: isinstance(x, tuple))[0]}
            assert got == flat, (case, kind, shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_shared_split_case_replicates_experts(shape):
    """The moe_shared_split case is the mesh kind it is there for: every
    MoE layer's routed experts resolve replicated and its shared
    expert's F to 'model', in the port's specs, which equal the
    reference's."""
    from repro.models import Model as RefModel
    _, pm = port_model(DEEPSEEK, experts=3)
    rcfg, _, _ = _ref_model(DEEPSEEK, "tiered", 3)
    rr = RefRules(JAbstractMesh(shape, ("data", "model")))
    shapes, logical = RefModel(rcfg).abstract_params()
    want = jax.tree.map(
        lambda lg, sd: tuple(rr.spec(lg, sd.shape)), logical, shapes,
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    want = {tuple(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = dict(tree_leaves_with_path(pm.param_shardings(
        ShardingRules(AbstractMesh(shape, ("data", "model"))))))
    assert got == want
    routed = [k for k in got if k[-1] == "w_up" and "shared" not in k
              and k[:-1] + ("shared", "w_up") in got]
    assert routed
    for k in routed:
        assert got[k][-3] is None, (k, got[k])
        assert got[k[:-1] + ("shared", "w_up")][-1] == "model", k


def test_serve_cli_sharded_rank0_alone_prints_and_writes(tmp_path):
    """`serve --backend sharded --mesh 1x2` on two gloo ranks: both
    generate the same tokens, only rank 0 prints, and the JSONL
    snapshots come from rank 0 alone (one line a step, in order)."""
    import json
    snaps = tmp_path / "snaps.jsonl"
    argv = ["--arch", GRANITE, "--reduced", "--device", "cpu",
            "--dtype", "float32", "--backend", "sharded", "--mesh", "1x2",
            "--requests", "3", "--concurrency", "2", "--prompt-len", "8",
            "--gen", "4", "--stats-every", "1",
            "--snapshots-out", str(snaps)]
    r0, r1 = spawn("serve_cli", {"argv": argv}, (1, 2), tmp_path)
    assert r0["tokens"] == r1["tokens"] and r0["tokens"]
    assert "[serve]" in r0["printed"] and r1["printed"] == ""
    steps = [json.loads(line)["step"]
             for line in snaps.read_text().splitlines()]
    assert len(steps) >= 2 and steps == sorted(set(steps)), steps
