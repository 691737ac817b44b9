"""PyTorch port: the RWKV6 and Mamba2 mixers (`models/ssm.py`), the RWKV6
channel mix, and the two models that run them — rwkv6-7b (attention
free) and zamba2-1.2b (Mamba2 with one shared attention block) — against
the live JAX reference on the CPU, reduced configs in f32.

The same numpy-made inputs go through both packages: the chunked WKV6
and SSD scans with S off the chunk grid and a carried state, both mixers
over a sequence and at S = 1 from a carried state (Mamba2 also with a
dt_bias past `F.softplus`'s linear threshold), the channel mix with and
without ``x_prev``, and the models' prefill, chunk-aligned extend and
batched decode logits (flat, and zamba2 over the tiered store too).
Within the port, chunked prefill equals whole prefill bit for bit.

Tolerances: 1e-4 max-abs on logits (f32 sums in another order), 2e-5 on
a single mixer's outputs and states, plus 1e-5 relative on the mixers'
(a dt near 25 scales the SSD state by 25). The batched decode runs both rows
in one call at their own positions, each step from the reference's own
cache carried over leaf by leaf: over the tiered store an f32 rounding
difference in K or V may round an int8 cold entry one step the other
way (prefill's cold tier is held to one step, as in
`test_torch_serving.py`), so each decode step is held on the same
inputs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.serving import LocalBackend as RefBackend
from repro.serving import slot_kv_bytes as ref_slot_kv_bytes
from repro.serving import spill_lane_bytes as ref_spill_lane_bytes
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.core import fusion as PF
from repro_torch.launch.serve import generate, main
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.serving import (Engine, LocalBackend, Request,
                                 slot_kv_bytes, spill_lane_bytes)
from repro_torch.serving.kv_pool import batch_axes
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map
from test_torch_config import build_pair

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("rwkv6-7b", "zamba2-1.2b")
LOGIT_TOL = 1e-4
TOL = 2e-5
RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=LOGIT_TOL, rtol=0.0):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), rtol=rtol, atol=tol)


def _layer(arch: str, ui: int = 0):
    """(ref cfg, port cfg, ref block params, port block params) of unit
    ``ui``'s first layer."""
    rc, _, rparams, pc, _, params = build_pair(arch)
    rp = jax.tree.map(lambda a: np.asarray(a)[0], rparams["units"][f"u{ui}"])
    pp = tree_map(lambda a: a[0], params["units"][f"u{ui}"])
    return rc, pc, rp, pp


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the chunked scans, S off the chunk grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S_,chunk", [(45, 16), (16, 16), (7, 7)])
def test_wkv6_chunked_matches_reference(S_, chunk):
    rng = np.random.default_rng(1)
    B, H, K = 2, 3, 8
    r, k, v = (_randn(rng, B, S_, H, K) for _ in range(3))
    logw = -np.exp(_randn(rng, B, S_, H, K, scale=0.5))
    u = _randn(rng, H, K, scale=0.3)
    s0 = _randn(rng, B, H, K, K, scale=0.2)
    want_y, want_s = RS.wkv6_chunked(*map(jnp.asarray, (r, k, v, logw, u,
                                                        s0)), chunk)
    y, s = S.wkv6_chunked(*map(_t, (r, k, v, logw, u, s0)), chunk)
    assert y.shape == (B, S_, H, K) and y.dtype == torch.float32
    _close(y, want_y, TOL)
    _close(s, want_s, TOL)


@pytest.mark.parametrize("S_,chunk", [(45, 16), (16, 16), (7, 7)])
def test_ssd_chunked_matches_reference(S_, chunk):
    rng = np.random.default_rng(2)
    B, H, P, n = 2, 3, 8, 5
    xh = _randn(rng, B, S_, H, P)
    Bm, Cm = _randn(rng, B, S_, n), _randn(rng, B, S_, n)
    dt = np.log1p(np.exp(_randn(rng, B, S_, H)))
    a_log = _randn(rng, H, scale=0.5)
    s0 = _randn(rng, B, H, P, n, scale=0.2)
    want_y, want_s = RS.ssd_chunked(*map(jnp.asarray, (xh, Bm, Cm, dt, a_log,
                                                       s0)), chunk)
    y, s = S.ssd_chunked(*map(_t, (xh, Bm, Cm, dt, a_log, s0)), chunk)
    assert y.shape == (B, S_, H, P)
    _close(y, want_y, TOL)
    _close(s, want_s, TOL)


def test_softplus_has_no_linear_branch():
    """`jax.nn.softplus` is logaddexp(x, 0) everywhere; `F.softplus`
    returns x itself above 20. The port's follows the reference."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.5, 25.0, 60.0], np.float32)
    got = S.softplus(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))


# ---------------------------------------------------------------------------
# the mixers: a sequence from a fresh / carried state, and S = 1
# ---------------------------------------------------------------------------
def _state_pair(rng, shapes):
    """(ref state, port state) with the same random values."""
    tree = {k: _randn(rng, *v, scale=0.3) for k, v in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in tree.items()},
            {k: _t(a) for k, a in tree.items()})


def _mixer_case(arch, S_, carried, dt_bias=None):
    rc, pc, rp, pp = _layer(arch)
    rp, pp = dict(rp["mixer"]), dict(pp["mixer"])
    rng = np.random.default_rng(3 + S_)
    x = _randn(rng, 2, S_, pc.d_model)
    if arch == "rwkv6-7b":
        shapes = {"s": (2, pc.num_heads, pc.head_dim, pc.head_dim),
                  "x_prev": (2, pc.d_model)}
        apply_ref, apply = RS.apply_rwkv6, S.apply_rwkv6
        # nonzero data-dependent terms: the bases and the bonus are zeros
        # at init
        for k in ("mu_x", "mu", "decay_base", "bonus_u"):
            a = _randn(rng, *rp[k].shape, scale=0.3)
            rp[k], pp[k] = a, _t(a)
    else:
        d_inner, H, n = S._m2_dims(pc)
        shapes = {"conv": (2, pc.ssm.conv_width - 1, d_inner + 2 * n),
                  "ssm": (2, H, pc.ssm.head_dim, n)}
        apply_ref, apply = RS.apply_mamba2, S.apply_mamba2
        for k in ("a_log", "conv_b"):
            a = _randn(rng, *rp[k].shape, scale=0.3)
            rp[k], pp[k] = a, _t(a)
        if dt_bias is not None:
            a = np.full(rp["dt_bias"].shape, dt_bias, np.float32)
            rp["dt_bias"], pp["dt_bias"] = a, _t(a)
    rstate, state = (_state_pair(rng, shapes) if carried
                     else (None, None))
    want, want_state = apply_ref(jax.tree.map(jnp.asarray, rp), rc,
                                 jnp.asarray(x), rstate)
    got, got_state = apply(pp, pc, _t(x), state)
    _close(got, want, TOL, RTOL)
    for k in want_state:
        _close(got_state[k], want_state[k], TOL, RTOL)
        assert got_state[k].dtype == bridge.array_to_tensor(
            np.asarray(want_state[k])).dtype, k


@pytest.mark.parametrize("S_,carried", [(40, False), (40, True), (1, True),
                                        (1, False)])
def test_apply_rwkv6_matches_reference(S_, carried):
    _mixer_case("rwkv6-7b", S_, carried)


@pytest.mark.parametrize("S_,carried,dt_bias", [
    (40, False, None), (40, True, None), (1, True, None), (1, False, None),
    (40, True, 25.0), (1, True, 25.0)])
def test_apply_mamba2_matches_reference(S_, carried, dt_bias):
    _mixer_case("zamba2-1.2b", S_, carried, dt_bias)


@pytest.mark.parametrize("S_,with_prev", [(9, False), (9, True), (1, True)])
def test_apply_rwkv_cm_matches_reference(S_, with_prev):
    rc, pc, rp, pp = _layer("rwkv6-7b")
    rp, pp = dict(rp["mlp"]), dict(pp["mlp"])
    rng = np.random.default_rng(7)
    for k in ("mu_k", "mu_r"):
        a = _randn(rng, pc.d_model, scale=0.4)
        rp[k], pp[k] = a, _t(a)
    x = _randn(rng, 2, S_, pc.d_model)
    prev = _randn(rng, 2, pc.d_model) if with_prev else None
    want, want_prev = RL.apply_rwkv_cm(
        jax.tree.map(jnp.asarray, rp), rc, jnp.asarray(x), None,
        None if prev is None else jnp.asarray(prev))
    got, got_prev = L.apply_rwkv_cm(pp, pc, _t(x),
                                    None if prev is None else _t(prev))
    _close(got, want, TOL)
    _close(got_prev, want_prev, 0.0)


def test_rwkv_cm_is_handled_by_the_block_not_apply_ffn():
    _, pc, _, pp = _layer("rwkv6-7b")
    with pytest.raises(ValueError, match="stateful"):
        PF.apply_ffn(pp["mlp"], pc, torch.zeros(1, 2, pc.d_model),
                     mlp_type="rwkv_cm")


# ---------------------------------------------------------------------------
# the models: prefill, chunk-aligned extend, batched decode
# ---------------------------------------------------------------------------
MAX_LEN = 56
DECODE_STEPS = 3
MODEL_CASES = [("rwkv6-7b", "flat"), ("zamba2-1.2b", "flat"),
               ("zamba2-1.2b", "tiered")]


def _prompts(cfg):
    """A 40-token prompt (off both reduced chunk grids, past the hot
    window of 8) and a 21-token one."""
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (40, 21)]


def _grid_chunks(n, unit):
    """Chunk-aligned (start, stop) pairs covering n tokens."""
    edges = list(range(0, n, unit)) + [n]
    return list(zip(edges[:-1], edges[1:]))


def _cat_rows(model, caches):
    """Per-row caches joined on the batch axis (axis 1 under a stacked
    unit's repeats)."""
    return {f"u{i}": tree_map(
        lambda *a, ax=int(u.repeats > 1): torch.cat(a, dim=ax),
        *[c[f"u{i}"] for c in caches]) for i, u in enumerate(model.plan)}


@functools.lru_cache(maxsize=None)
def _ref_run(arch: str, kv_policy: str):
    """The reference (memoized): each prompt's prefill logits and cache,
    DECODE_STEPS greedy decode steps a row at a time (logits, the cache
    each step starts from, its token), and the first prompt's extend
    over its chunk grid."""
    _, rmodel, rparams, pc, _, _ = build_pair(arch, kv_policy)
    decode = jax.jit(rmodel.decode_step)
    out = {"prefill": [], "steps": []}
    for toks in _prompts(pc):
        rl, rcache = rmodel.prefill(rparams, {"tokens": toks[None]},
                                    MAX_LEN)
        out["prefill"].append((np.asarray(rl),
                               jax.tree.map(np.asarray, rcache)))
        pos, tok, steps = len(toks), int(np.asarray(rl)[0, -1].argmax()), []
        for _ in range(DECODE_STEPS):
            c_in = jax.tree.map(np.asarray, rcache)
            rl, rcache = decode(rparams, np.array([[tok]], np.int32),
                                rcache, jnp.int32(pos))
            steps.append((np.asarray(rl), c_in, tok, pos,
                          jax.tree.map(np.asarray, rcache)))
            tok, pos = int(np.asarray(rl)[0, -1].argmax()), pos + 1
        out["steps"].append(steps)
    toks = _prompts(pc)[0]
    ext = rmodel.init_extend_cache(1, MAX_LEN)
    chunks = _grid_chunks(len(toks), pc.ssm.chunk_size)
    for a, b in chunks:
        rl, ext = rmodel.extend(rparams, {"tokens": toks[None, a:b]}, ext, a,
                                b - a, commit=b == len(toks))
    out["extend"] = np.asarray(rl)
    return out


def _recurrent_leaves(tree):
    return [(p, t) for p, t in tree_leaves_with_path(tree)
            if p[-1] in ("s", "x_prev", "cm_x_prev", "conv", "ssm")]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,kv_policy", MODEL_CASES)
def test_model_logits_match_reference(arch, kv_policy):
    """Prefill of both prompts (logits and recurrent states; the tiered
    cold tier within one int8 step), the 40-token prompt's extend over
    its chunk grid (committed), and DECODE_STEPS decode steps of BOTH
    rows in one batched call at their own positions, from the
    reference's caches: every logit within 1e-4 of the reference's."""
    _, _, _, pc, model, params = build_pair(arch, kv_policy)
    ref = _ref_run(arch, kv_policy)
    for i, toks in enumerate(_prompts(pc)):
        pl, cache = model.prefill(params, {"tokens": toks[None]}, MAX_LEN)
        want_l, want_c = ref["prefill"][i]
        _close(pl, want_l)
        for path, t in _recurrent_leaves(cache):
            _close(t, _leaf(want_c, path), TOL)
        for path, t in tree_leaves_with_path(cache):
            if path[-1] == "cold_q":
                d = t.int() - _t(_leaf(want_c, path)).int()
                assert d.abs().max() <= 1, path
    for step in range(DECODE_STEPS):
        rows = [ref["steps"][b][step] for b in range(2)]
        cache = _cat_rows(model, [bridge.params_from_jax(r[1])
                                  for r in rows])
        tok = torch.tensor([[r[2]] for r in rows])
        pos = torch.tensor([r[3] for r in rows])
        pl, new = model.decode_step(params, tok, cache, pos)
        axes = batch_axes(model, new)
        for b, r in enumerate(rows):
            _close(pl[b:b + 1], r[0])
            for path, t in _recurrent_leaves(new):
                _close(t.narrow(_leaf(axes, path), b, 1), _leaf(r[4], path),
                       TOL)
    toks = _prompts(pc)[0]
    ext = model.init_extend_cache(1, MAX_LEN)
    for a, b in _grid_chunks(len(toks), pc.ssm.chunk_size):
        pl, ext = model.extend(params, {"tokens": toks[None, a:b]}, ext, a,
                               b - a, commit=b == len(toks))
    _close(pl, ref["extend"])
    _close(pl, ref["prefill"][0][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_whole_bit_for_bit(arch):
    """Extend over the chunk grid (the engine's chunk_unit) runs whole
    prefill's op sequence: the logits and every recurrent state are
    equal under torch.equal, and a zamba2 attention store's hot ring
    too."""
    _, _, _, pc, model, params = build_pair(arch, "tiered")
    toks = _prompts(pc)[0]
    whole, wcache = model.prefill(params, {"tokens": toks[None]}, MAX_LEN)
    ext = model.init_extend_cache(1, MAX_LEN)
    for a, b in _grid_chunks(len(toks), pc.ssm.chunk_size):
        logits, ext = model.extend(params, {"tokens": toks[None, a:b]}, ext,
                                   a, b - a, commit=b == len(toks))
    assert torch.equal(logits, whole)
    leaves = _recurrent_leaves(ext)
    assert leaves and all(torch.equal(t, _leaf(wcache, p))
                          for p, t in leaves)
    for p, t in tree_leaves_with_path(ext):
        if p[-1] == "hot":
            assert torch.equal(t, _leaf(wcache, p)), p


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    _, rmodel, rparams, pc, model, params = build_pair(arch)
    toks = _prompts(pc)[1]
    want, _ = ref_generate(rmodel, rparams, {"tokens": toks[None]},
                           len(toks), 10)
    got, _ = generate(model, params, {"tokens": toks[None]}, len(toks), 10,
                      device="cpu")
    assert got[0].tolist() == np.asarray(want)[0].tolist()


# ---------------------------------------------------------------------------
# structure: the bridge, the caches, the backend's flags and charges
# ---------------------------------------------------------------------------
def test_bridge_carries_shared_attn_and_3d_leaves():
    """zamba2's shared block is one top-level weight set (no unit holds
    its parameters, the bridge does not stack it); rwkv6's w_r / w_k /
    w_v (D, H, K) and w_o (H, K, D) arrive unchanged. Leaf by leaf, the
    port's tree equals the reference's: same paths, shapes, values."""
    for arch in ARCHS:
        _, rmodel, rparams, pc, model, params = build_pair(arch)
        ref = {p: np.asarray(a) for p, a in tree_leaves_with_path(
            jax.tree.map(np.asarray, rparams))}
        mine = dict(tree_leaves_with_path(params))
        assert set(mine) == set(ref)
        for p, t in mine.items():
            assert tuple(t.shape) == ref[p].shape, p
            assert np.array_equal(t.numpy(), ref[p]), p
        # a fresh port init has the reference's tree too
        fresh = Model(pc).init(torch.Generator().manual_seed(0))
        assert {p: tuple(t.shape) for p, t in tree_leaves_with_path(
            fresh)} == {p: a.shape for p, a in ref.items()}
    _, _, rparams, pc, model, params = build_pair("zamba2-1.2b")
    shared = [ui for ui, u in enumerate(model.plan)
              if u.block.mixer == "attn_shared"]
    assert shared and all(f"u{ui}" not in params["units"] for ui in shared)
    # one weight set, no repeat axis: (D, H, Dh)
    assert tuple(params["shared_attn"]["mixer"]["wq"].shape) == (
        pc.d_model, pc.num_heads, pc.head_dim)
    _, _, _, pc, _, params = build_pair("rwkv6-7b")
    D, H, K = pc.d_model, pc.num_heads, pc.head_dim
    mix = params["units"]["u0"]["mixer"]
    for k in ("w_r", "w_k", "w_v"):
        assert tuple(mix[k].shape) == (pc.num_layers, D, H, K)
    assert tuple(mix["w_o"].shape) == (pc.num_layers, H, K, D)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_reference_layout(arch):
    """Decode and extend caches: the reference's paths, shapes and
    dtypes (recurrent states f32, the shift / conv history in the
    compute dtype, one K/V store per shared-attention application)."""
    _, rmodel, _, _, model, _ = build_pair(arch)
    for (mine, _), (ref, _) in ((model.cache_spec(3, 24),
                            rmodel.cache_spec(3, 24)),
                           (model.extend_spec(1, 24),
                            rmodel.extend_spec(1, 24))):
        ref = dict(tree_leaves_with_path(ref))
        got = dict(tree_leaves_with_path(mine))
        assert set(got) == set(ref)
        for p, t in got.items():
            assert tuple(t.shape) == tuple(ref[p].shape), p
            assert str(t.dtype).split(".")[-1] == str(ref[p].dtype), p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("block_tokens", [None, 40])
def test_backend_flags_match_reference(arch, block_tokens):
    """`requires_exact_prefill`, `chunk_unit`, `block_tokens` (rounded
    to the chunk grid) and `has_prefix_ws` as the reference backend
    reports them; at full width too."""
    _, rmodel, rparams, _, model, params = build_pair(arch)
    be = LocalBackend(model, params, 2, 48, device="cpu",
                      block_tokens=block_tokens)
    rbe = RefBackend(rmodel, rparams, 2, 48, block_tokens=block_tokens)
    for k in ("requires_exact_prefill", "chunk_unit", "block_tokens",
              "prefix_blocks", "has_prefix_ws"):
        assert getattr(be, k) == getattr(rbe, k), k
    assert be.requires_exact_prefill
    assert be.has_prefix_ws == (arch == "zamba2-1.2b")
    full = Model(get_config(arch))
    assert full.cfg.ssm.chunk_size == 128
    assert {u.block.mixer for u in full.plan} == (
        {"rwkv6"} if arch == "rwkv6-7b" else {"mamba2", "attn_shared"})
    assert get_config(arch).param_count() == \
        ref_get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
def test_slot_and_lane_bytes_match_reference(arch, kv_policy):
    """The recurrent states are charged as per-slot DRAM state beside the
    stores: the reference's slot and lane bytes, both lane forms."""
    _, rmodel, _, _, model, _ = build_pair(arch, kv_policy)
    state = sum(t.numel() * t.element_size()
                for _, t in _recurrent_leaves(model.cache_spec(1, 48)[0]))
    assert state > 0
    assert slot_kv_bytes(model, 48) == ref_slot_kv_bytes(rmodel, 48)
    assert slot_kv_bytes(model, 48)[0] >= state
    for comp in (False, True):
        assert spill_lane_bytes(model, 48, comp) == \
            ref_spill_lane_bytes(rmodel, 48, comp)
    if arch == "rwkv6-7b":
        assert slot_kv_bytes(model, 48) == (state, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_decode_keeps_inactive_recurrent_states(arch):
    """One batched decode call advances every row's state; the backend
    puts the inactive slots' states back verbatim (the reference's
    per-slot decode never advances them)."""
    _, _, _, pc, model, params = build_pair(arch)
    be = LocalBackend(model, params, 3, 24, device="cpu")
    pool = be.make_pool()
    rng = np.random.default_rng(5)
    cache = tree_map(lambda t: (torch.from_numpy(rng.standard_normal(
        t.shape).astype(np.float32)).to(t.dtype) if t.is_floating_point()
        else t), pool.state.cache)
    state = pool.state.__class__(cache=cache, axes=pool.state.axes)
    toks = np.array([[3], [4], [5]], np.int32)
    active = np.array([True, False, True])
    _, new = be.decode_step(toks, state, np.array([0, 5, 9], np.int32),
                            active)
    leaves = _recurrent_leaves(new.cache)
    assert leaves
    for path, t in leaves:
        old = _leaf(cache, path)
        ax = _leaf(pool.state.axes, path)
        assert torch.equal(t.narrow(ax, 1, 1), old.narrow(ax, 1, 1)), path
        assert not torch.equal(t.narrow(ax, 0, 1), old.narrow(ax, 0, 1)), \
            path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    done = main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "3", "--concurrency", "2", "--prompt-len",
                 "20", "--gen", "4", "--dtype", "float32",
                 "--chunk-tokens", "16"])
    assert len(done) == 3 and all(r.n_generated == 4 for r in done)
    assert "tok/J" in capsys.readouterr().out


def test_fresh_init_serves_in_bf16():
    """The port's own random init in the configs' bf16: every request of
    a zamba2 stream finishes with in-vocabulary tokens, and the states
    keep their dtypes."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    be = LocalBackend(model, params, 2, 40, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=4)
            for i, n in enumerate((20, 33, 9))]
    done = Engine(be, chunk_tokens=16).run(reqs)
    assert all(r.n_generated == 4 and max(r.generated) < cfg.vocab_size
               for r in done)
    dts = {p[-1]: t.dtype for p, t in tree_leaves_with_path(be.init_pool()
                                                           .cache)}
    assert dts["ssm"] == torch.float32 and dts["conv"] == torch.bfloat16
    assert all(torch.isfinite(t).all() for t in tree_leaves(params)
               if t.is_floating_point())
