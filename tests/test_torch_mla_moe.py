"""PyTorch port: MLA and the dropless MoE (deepseek-v2-lite, reduced, f32)
against the live JAX reference on the CPU.

Every function of the slice runs on the same numpy-made inputs through
the reference and the port: the MLA latents and queries (both query
branches), `mla_attention` in its expanded and absorbed forms, the tiered
latent decode at ragged per-row positions (the port decodes every row in
one call; the reference one row at a time), the dropless MoE, the
1-D-inner latent stores and their spill codec, and the model's prefill,
chunked extend and batched decode logits over flat and tiered stores.
Layer 0's dense FFN is held against the reference's Pallas `ffn_act` in
interpret mode. The planner, the simulator and the ledger price
deepseek-v2-lite exactly as the reference does.

Tolerances: 1e-4 max-abs on logits and layer outputs (f32 sums in
another order over three layers); stores, plans and prices exact.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.core import fusion as RF
from repro.core import kv_tiers as RKT
from repro.core.planner import plan_for as ref_plan_for
from repro.models import attention as RA
from repro.models import layers as RL
from repro.serving import Request as RefRequest
from repro.serving import simulated_efficiency as ref_sim_eff
from repro.simulator import chime_sim as RS
from repro.simulator import hardware as RH
from repro_torch import bridge
from repro_torch.configs.base import MLAConfig, get_config
from repro_torch.core import fusion as PF
from repro_torch.core import kv_tiers as KT
from repro_torch.core.planner import plan_for
from repro_torch.models import Model
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.serving import Request, simulated_efficiency
from repro_torch.simulator import chime_sim as S
from repro_torch.simulator import hardware as H
from repro_torch.tree import tree_leaves_with_path, tree_map
from test_torch_config import build_pair

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v2-lite"
LOGIT_TOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np_params(shapes: dict, seed: int) -> dict:
    """Random f32 leaves (std fan_in**-0.5; ``*scale`` leaves near 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in shapes.items():
        if k.endswith("scale"):
            out[k] = (1 + 0.1 * rng.standard_normal(shp)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(shp) * shp[0] ** -0.5).astype(
                np.float32)
    return out


def _mla_shapes(cfg) -> dict:
    m, H_, D = cfg.mla, cfg.num_heads, cfg.d_model
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    shp = {"wkv_a": (D, m.kv_lora_rank), "kv_norm_scale": (m.kv_lora_rank,),
           "wk_rope": (D, m.qk_rope_head_dim),
           "wk_b": (m.kv_lora_rank, H_, m.qk_nope_head_dim),
           "wv_b": (m.kv_lora_rank, H_, m.v_head_dim),
           "wo": (H_, m.v_head_dim, D)}
    if m.q_lora_rank:
        shp.update(wq_a=(D, m.q_lora_rank), q_norm_scale=(m.q_lora_rank,),
                   wq_b=(m.q_lora_rank, H_, qk))
    else:
        shp["wq"] = (D, H_, qk)
    return shp


def _cfgs(q_lora_rank: int = 0, **knobs):
    """(reference, port) reduced f32 deepseek configs, equal fields."""
    rc, _, _, pc, _, _ = build_pair(ARCH)
    if q_lora_rank:
        m = dataclasses.asdict(pc.mla) | {"q_lora_rank": q_lora_rank}
        rc = rc.replace(mla=type(rc.mla)(**m))
        pc = pc.replace(mla=MLAConfig(**m))
    return rc.replace(**knobs), pc.replace(**knobs)


def _assert_close(got: torch.Tensor, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# MLA pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_lora_rank", [0, 16], ids=["wq", "q_lora"])
def test_mla_latents_and_queries_match_reference(q_lora_rank):
    rc, pc = _cfgs(q_lora_rank)
    p = _np_params(_mla_shapes(pc), seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, pc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    pp = {k: _t(v) for k, v in p.items()}
    for ref, mine in ((RA.mla_latents(rp, rc, jnp.asarray(x), pos),
                       A.mla_latents(pp, pc, _t(x), _t(pos))),
                      (RA.mla_queries(rp, rc, jnp.asarray(x), pos),
                       A.mla_queries(pp, pc, _t(x), _t(pos)))):
        for r, m in zip(ref, mine):
            assert m.shape == r.shape
            _assert_close(m, r, 2e-5)


@functools.lru_cache(maxsize=None)
def _mla_inputs(seed: int = 3, B: int = 2, S: int = 6, Lk: int = 11):
    _, pc = _cfgs()
    m = pc.mla
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    H_ = pc.num_heads
    return (_np_params(_mla_shapes(pc), seed), f(B, S, H_, m.qk_nope_head_dim),
            f(B, S, H_, m.qk_rope_head_dim), f(B, Lk, m.kv_lora_rank),
            f(B, Lk, m.qk_rope_head_dim))


@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_mla_attention_matches_reference(absorbed):
    rc, pc = _cfgs()
    p, qn, qr, c, r = _mla_inputs()
    S, Lk = qn.shape[1], c.shape[1]
    mask = np.arange(Lk)[None, :] <= np.arange(S)[:, None] + (Lk - S)
    ref = RA.mla_attention({k: jnp.asarray(v) for k, v in p.items()}, rc,
                           qn, qr, c, r, jnp.asarray(mask)[None, None],
                           absorbed)
    pp = {k: _t(v) for k, v in p.items()}
    mine = A.mla_attention(pp, pc, _t(qn), _t(qr), _t(c), _t(r),
                           _t(mask)[None, None], absorbed)
    _assert_close(mine, ref)
    # the two forms are one function
    other = A.mla_attention(pp, pc, _t(qn), _t(qr), _t(c), _t(r),
                            _t(mask)[None, None], not absorbed)
    _assert_close(mine, other.numpy())


def _latent_stores(pc, lengths, max_len, policy, seed=4):
    """Per-row latent stores built by prefill (one row at a time: each
    row's own valid length) and stacked into one batch, as the serving
    pool holds them; also the per-row full latents."""
    m = pc.mla
    rng = np.random.default_rng(seed)
    rows, fulls = [], []
    for n in lengths:
        c = rng.standard_normal((1, n, m.kv_lora_rank)).astype(np.float32)
        r = rng.standard_normal((1, n, m.qk_rope_head_dim)).astype(
            np.float32)
        fulls.append((c, r))
        rows.append({k: KT.store_from_full(_t(v), policy,
                                           pc.kv_hot_window, n, max_len)
                     for k, v in (("c_kv", c), ("k_rope", r))})
    batch = tree_map(lambda *a: torch.cat(a), *rows)
    return batch, fulls


def test_mla_attend_tiered_at_ragged_rows_matches_reference():
    """One batched call at per-row positions (short of, at and past the
    hot window of 8, cold pages live) equals the reference row by row,
    and the flat-store decode of the same latents (the absorbed
    `mla_attention` over `store_read`)."""
    rc, pc = _cfgs()
    p, qn, qr, _, _ = _mla_inputs(seed=5, B=4, S=1, Lk=1)
    pp = {k: _t(v) for k, v in p.items()}
    lengths, max_len = (3, 8, 9, 21), 24
    tiered, fulls = _latent_stores(pc, lengths, max_len, "tiered")
    pos = torch.tensor(lengths) - 1
    mine = A.mla_attend_tiered(pp, pc, _t(qn), _t(qr), tiered["c_kv"],
                               tiered["k_rope"], pos)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    for b, n in enumerate(lengths):
        rs = {k: RKT.store_from_full(jnp.asarray(fulls[b][i]), "tiered",
                                     rc.kv_hot_window, n, max_len)
              for i, k in enumerate(("c_kv", "k_rope"))}
        ref = RA.mla_attend_tiered(rp, rc, qn[b:b + 1], qr[b:b + 1],
                                   rs["c_kv"], rs["k_rope"], n - 1)
        _assert_close(mine[b:b + 1], ref)
    flat, _ = _latent_stores(pc, lengths, max_len, "flat")
    c_all, valid = KT.store_read(flat["c_kv"], pos, torch.float32)
    r_all, _ = KT.store_read(flat["k_rope"], pos, torch.float32)
    dense = A.mla_attention(pp, pc, _t(qn), _t(qr), c_all, r_all,
                            valid[:, None, None, :], absorbed=True)
    # the cold tier's int8 rounding is the only difference
    assert float((mine - dense).abs().max()) < 0.1


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_params(cfg, seed: int) -> dict:
    m, D = cfg.moe, cfg.d_model
    p = _np_params({"router": (D, m.num_experts),
                    "w_up": (m.num_experts, D, m.d_ff_expert),
                    "w_gate": (m.num_experts, D, m.d_ff_expert),
                    "w_down": (m.num_experts, m.d_ff_expert, D)}, seed)
    p["shared"] = _np_params({"w_up": (D, m.d_ff_shared),
                              "w_gate": (D, m.d_ff_shared),
                              "w_down": (m.d_ff_shared, D)}, seed + 1)
    return p


@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (3, 7)])
def test_apply_moe_dropless_matches_reference(shape):
    """Top-2 of 4 experts over 1 to 21 tokens: with more tokens than
    experts, tokens share experts (checked), and each expert's rows keep
    their sorted order through the (E, T, D) buffer."""
    rc, pc = _cfgs()
    p = _moe_params(pc, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape + (pc.d_model,)).astype(np.float32)
    ref = RL.apply_moe(jax.tree.map(jnp.asarray, p), rc, jnp.asarray(x),
                       None, dropless=True)
    pp = tree_map(_t, p)
    mine = L.apply_moe(pp, pc, _t(x))
    assert mine.shape == x.shape
    _assert_close(mine, ref)
    T = shape[0] * shape[1]
    probs = torch.softmax(_t(x).reshape(T, -1) @ pp["router"], -1)
    top = probs.topk(pc.moe.top_k, -1).indices.reshape(-1)
    if T > pc.moe.num_experts:
        assert int(torch.bincount(top).max()) >= 2     # shared experts
    # dispatch through apply_ffn is the same function
    _assert_close(PF.apply_ffn(pp, pc, _t(x), mlp_type="moe"), mine.numpy(),
                  0.0)


def test_moe_training_paths_raise():
    """The training paths of the MoE: the load-balancing loss (ported
    with training, item 9) equals the reference's on 2 x 9 alike tokens,
    which overflow an expert's capacity in the full-sequence forward's
    capacity-dropping path, whose dropped output equals the reference's
    (dropless=False), apart from the dropless one."""
    rc, pc = _cfgs()
    p = _moe_params(pc, seed=6)
    pp = tree_map(_t, p)
    x = np.random.default_rng(8).standard_normal(
        (2, 9, pc.d_model)).astype(np.float32)
    x[:, 2:] = x[:, 2:3]
    np.testing.assert_allclose(
        float(L.moe_aux_loss(pp, pc, _t(x))),
        float(RL.moe_aux_loss(jax.tree.map(jnp.asarray, p), rc,
                              jnp.asarray(x))), rtol=1e-6)
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(_t(x).reshape(T, -1) @ pp["router"], -1)
    top = probs.topk(pc.moe.top_k, -1).indices.reshape(-1)
    assert int(torch.bincount(top).max()) > L.moe_capacity(pc, T, False)
    ref = RL.apply_moe(jax.tree.map(jnp.asarray, p), rc, jnp.asarray(x),
                       None, dropless=False)
    mine = L.apply_moe(pp, pc, _t(x), dropless=False)
    _assert_close(mine, ref)
    assert not torch.allclose(mine, L.apply_moe(pp, pc, _t(x)), atol=1e-3)


# ---------------------------------------------------------------------------
# the 1-D-inner latent stores
# ---------------------------------------------------------------------------
def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("policy", ["tiered", "flat"])
def test_latent_store_functions_match_reference(policy):
    """store_from_full (one scale per token: (B, L, 1)), store_append at a
    batched pos (per row in the reference), store_read, the spill codec
    and the endurance report: equal to the reference, payloads exact."""
    W, max_len, R = 4, 300, 32
    rng = np.random.default_rng(8)
    lengths = (2, 5, 133)
    full = rng.standard_normal((3, 140, R)).astype(np.float32)
    store = tree_map(lambda *a: torch.cat(a), *[
        KT.store_from_full(_t(full[b:b + 1]), policy, W, n, max_len)
        for b, n in enumerate(lengths)])
    refs = [RKT.store_from_full(jnp.asarray(full[b:b + 1]), policy, W, n,
                                max_len) for b, n in enumerate(lengths)]
    if policy == "tiered":
        assert store["cold_scale"].shape == (3, max_len, 1)
    new = rng.standard_normal((3, 1, R)).astype(np.float32)
    pos = torch.tensor(lengths)
    store = KT.store_append(store, _t(new), pos)
    refs = [RKT.store_append(r, jnp.asarray(new[b:b + 1]), n)
            for b, (r, n) in enumerate(zip(refs, lengths))]
    for b, r in enumerate(refs):
        for k, v in _np_tree(r).items():
            np.testing.assert_array_equal(store[k][b:b + 1].numpy(), v,
                                          err_msg=k)
        vals, valid = KT.store_read(store, pos, torch.float32)
        rv, rvalid = RKT.store_read(r, lengths[b], jnp.float32)
        np.testing.assert_array_equal(vals[b:b + 1].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(rvalid))
    if policy == "flat":
        return
    comp = KT.spill_store_compress(store)
    back = KT.spill_store_decompress(comp, torch.float32)
    assert set(KT.spill_store_meta(store)) == set(comp) == set(
        KT.spill_store_template(store))
    for b, r in enumerate(refs):
        rcomp = RKT.spill_store_compress(r)
        for k, v in _np_tree(rcomp).items():
            np.testing.assert_array_equal(comp[k][b:b + 1].numpy(), v,
                                          err_msg=k)
        np.testing.assert_array_equal(
            back["hot"][b:b + 1].numpy(),
            np.asarray(RKT.spill_store_decompress(rcomp, jnp.float32)["hot"]))
    rep = KT.endurance_report(store)
    rwrites = np.concatenate([np.asarray(r["writes"]) for r in refs])
    rrep = RKT.endurance_report({"writes": jnp.asarray(rwrites)})
    for k in rep:
        np.testing.assert_array_equal(rep[k].numpy(), np.asarray(rrep[k]))
    assert int(rep["max_writes_per_block"]) == 1


# ---------------------------------------------------------------------------
# the model: prefill, chunked extend, batched decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_model_run(kv_policy: str, absorbed: bool):
    """The reference's logits on the stream of `test_model_logits`:
    whole prefill, chunked extend and per-row decode (memoized)."""
    rc, rmodel, rparams, _, _, _ = build_pair(ARCH, kv_policy)
    rmodel = type(rmodel)(rc.replace(mla_absorbed=absorbed))
    toks, max_len = _model_stream()
    out = {"prefill": [], "extend": None, "decode": []}
    decode = jax.jit(rmodel.decode_step)      # pos traced: one compile
    for t in toks:
        rl, rcache = rmodel.prefill(rparams, {"tokens": t[None]}, max_len)
        out["prefill"].append(np.asarray(rl))
        pos, tok = len(t), np.asarray(rl)[0, -1].argmax()
        steps = []
        for _ in range(DECODE_STEPS):
            rl, rcache = decode(rparams, np.array([[tok]], np.int32),
                                rcache, jnp.int32(pos))
            steps.append(np.asarray(rl))
            tok, pos = np.asarray(rl)[0, -1].argmax(), pos + 1
        out["decode"].append(steps)
    ext = rmodel.init_extend_cache(1, max_len)
    p = 0
    t = toks[-1]
    for n, valid, commit in _CHUNKS:
        chunk = np.zeros((1, n), np.int32)
        chunk[0, :valid] = t[p:p + valid]
        rl, ext = rmodel.extend(rparams, {"tokens": chunk}, ext, p, valid,
                                commit=commit)
        p += valid
    out["extend"] = np.asarray(rl)
    return out


_CHUNKS = ((5, 5, False), (5, 5, False), (8, 6, True))
DECODE_STEPS = 4     # the 5-token row's pos 8 evicts into the cold tier


def _model_stream():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, n).astype(np.int32) for n in (5, 16)], 32


@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
def test_model_logits_match_reference(kv_policy, absorbed):
    """Prefill of two prompts (5 and 16 tokens: short of and past the hot
    window of 8), the longer one's chunked extend (5 + 5 + a padded 6 of
    8, committed), and four greedy decode steps of BOTH rows in one
    batched call at their own positions: every logit within 1e-4 of the
    reference's (whose decode runs one row at a time)."""
    _, _, _, pc, model, params = build_pair(ARCH, kv_policy)
    model = Model(pc.replace(mla_absorbed=absorbed))
    ref = _ref_model_run(kv_policy, absorbed)
    toks, max_len = _model_stream()
    caches, last = [], []
    for i, t in enumerate(toks):
        pl, cache = model.prefill(params, {"tokens": t[None]}, max_len)
        _assert_close(pl, ref["prefill"][i])
        caches.append(cache)
        last.append(int(pl[0, -1].argmax()))
    # rows join on the batch axis: axis 1 under a stacked unit's repeats
    cache = {f"u{i}": tree_map(
        lambda *a, ax=int(u.repeats > 1): torch.cat(a, dim=ax),
        *[c[f"u{i}"] for c in caches]) for i, u in enumerate(model.plan)}
    pos = torch.tensor([len(t) for t in toks])
    tok = torch.tensor(last)[:, None]
    for step in range(DECODE_STEPS):
        pl, cache = model.decode_step(params, tok, cache, pos)
        for b in range(len(toks)):
            _assert_close(pl[b:b + 1], ref["decode"][b][step])
        tok, pos = pl[:, -1].argmax(-1)[:, None], pos + 1
    ext = model.init_extend_cache(1, max_len)
    p, t = 0, toks[-1]
    for n, valid, commit in _CHUNKS:
        chunk = np.zeros((1, n), np.int32)
        chunk[0, :valid] = t[p:p + valid]
        pl, ext = model.extend(params, {"tokens": chunk}, ext, p, valid,
                               commit=commit)
        p += valid
    _assert_close(pl, ref["extend"])
    _assert_close(pl, ref["prefill"][-1])
    assert set(ext["u1"]) == {"c_kv", "k_rope"}


def test_dense_first_ffn_matches_pallas_reference(monkeypatch):
    """Layer 0's FFN (dense-first: silu_gated at moe.d_ff_dense) through
    the port's `apply_ffn` (ffn_act's plain twin on the CPU) against the
    reference's `apply_ffn` through its Pallas ffn_act in interpret
    mode."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    rc, _, rparams, pc, model, params = build_pair(ARCH)
    assert model.plan[0].block.mlp == "dense_first"
    rc = rc.replace(use_pallas_kernels=True)
    x = np.random.default_rng(10).standard_normal(
        (1, 12, pc.d_model)).astype(np.float32)
    rp = rparams["units"]["u0"]["mlp"]
    assert rp["w_up"].shape == (pc.d_model, pc.moe.d_ff_dense)
    ref = RF.apply_ffn(rp, rc, jnp.asarray(x), None, mlp_type="silu_gated",
                       d_ff=rc.moe.d_ff_dense)
    mine = PF.apply_ffn(params["units"]["u0"]["mlp"], pc, _t(x),
                        mlp_type="silu_gated")
    _assert_close(mine, ref)


# ---------------------------------------------------------------------------
# parameters: the plan, the leaves and the stacked init
# ---------------------------------------------------------------------------
def test_plan_and_leaves_match_reference():
    rc, rmodel, rparams, pc, model, params = build_pair(ARCH)
    assert [(u.block.mixer, u.block.mlp, u.repeats) for u in model.plan] \
        == [("mla", "dense_first", 1), ("mla", "moe", 2)] \
        == [(u.block.mixer, u.block.mlp, u.repeats) for u in rmodel.plan]
    ref = {p: np.asarray(v) for p, v in tree_leaves_with_path(
        jax.tree.map(np.asarray, rparams))}
    own = {p: v.numpy() for p, v in tree_leaves_with_path(
        model.init(torch.Generator().manual_seed(0)))}
    assert {p: (v.shape, v.dtype) for p, v in own.items()} == \
        {p: (v.shape, v.dtype) for p, v in ref.items()}
    assert ("units", "u1", "mlp", "shared", "w_gate") in own
    assert get_config(ARCH).param_count() == 15_706_357_760 == \
        ref_get_config(ARCH).param_count()


@pytest.mark.parametrize("arch", ["granite-3-2b", ARCH])
def test_init_fills_stacked_leaves_like_stacking(arch):
    """`Model.init` fills each repeated unit's stacked leaves layer by
    layer; the values equal drawing every layer in turn and stacking."""
    _, _, _, pc, model, _ = build_pair(arch)
    got = model.init(torch.Generator().manual_seed(3))
    b = L.ParamInit(torch.Generator().manual_seed(3), torch.float32, "cpu")
    want = {"embed": {"table": b.normal((model.padded_vocab, pc.d_model),
                                        scale=1.0)}, "units": {}}
    for ui, unit in enumerate(model.plan):
        layers = [model._init_block(b, unit.block)
                  for _ in range(unit.repeats)]
        want["units"][f"u{ui}"] = (layers[0] if unit.repeats == 1 else
                                   tree_map(lambda *a: torch.stack(a),
                                            *layers))
    want["final_norm"] = L.init_norm(b, pc)
    if not pc.tie_embeddings:
        want["lm_head"] = b.normal((pc.d_model, model.padded_vocab),
                                   scale=pc.d_model ** -0.5)
    assert [p for p, _ in tree_leaves_with_path(got)] == \
        [p for p, _ in tree_leaves_with_path(want)]
    for (path, g), (_, w) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(want)):
        assert torch.equal(g, w), path
    assert any(u.repeats > 1 for u in model.plan)


# ---------------------------------------------------------------------------
# planner, simulator and ledger at deepseek-v2-lite's published widths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
def test_plan_sim_and_ledger_match_reference(kv_policy):
    knobs = dict(kv_policy=kv_policy, kv_hot_window=128)
    rc, pc = ref_get_config(ARCH).replace(**knobs), get_config(ARCH).replace(
        **knobs)
    ref, mine = ref_plan_for(rc), plan_for(pc)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    mine.audit()
    for plat in ("CHIME", "DRAM_ONLY"):
        wl = (256, 64, False)
        assert dataclasses.asdict(S.simulate(pc, getattr(H, plat),
                                             S.Workload(*wl))) == \
            dataclasses.asdict(RS.simulate(rc, getattr(RH, plat),
                                           RS.Workload(*wl)))
        pl, rl = S.cost_layers(pc), RS.cost_layers(rc)
        assert pl == rl
        for ctx in (1, 127, 128, 129, 511):
            assert S.decode_token_terms(pc, getattr(H, plat), ctx, pl) == \
                RS.decode_token_terms(rc, getattr(RH, plat), ctx, rl)

    def finished(cls):
        out = []
        for i, (n, g, ev) in enumerate(((256, 64, []), (200, 3, [230]),
                                        (17, 0, []))):
            r = cls(rid=i, tokens=np.zeros(n, np.int32), max_new_tokens=g)
            r.generated, r.evict_ctx = [1] * g, ev
            out.append(r)
        return out
    for comp in (False, True):
        mine = simulated_efficiency(pc, finished(Request),
                                    spill_compressed=comp)
        assert mine == ref_sim_eff(rc, finished(RefRequest),
                                   spill_compressed=comp)
        assert mine["sim_tokens_per_j"] > 0 and mine["sim_spills"] == 1
