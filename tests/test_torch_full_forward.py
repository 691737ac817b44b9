"""PyTorch port: the full-sequence forward (`Model.forward`) against the
live JAX reference on the CPU, and hubert-xlarge, the encoder it serves.

`forward` is the reference's full mode: logits for every position, no
cache, attention causal unless the config is an encoder, recurrences
from a zero state, the MoE capacity-dropping (rows past an expert's
capacity contribute zero, the gates not renormalised). Every registered
reduced config runs in f32 against the reference's `forward` on the
same weights (the port's draw, carried across by the bridge; 1e-4
max-abs): this
holds the capacity-dropping MoE (deepseek-v2-lite, llama4, on a batch
where some expert overflows), the zero-state recurrences (rwkv6,
zamba2) and hubert's frames, learned positions and non-causal attention.

Besides: the MoE's fixed-order combine against a per-token loop
(`torch.equal`), its capacity rounding, the in-place parameter draw,
`ffn_act`'s plain twin at hubert's ungated GELU against the Pallas
kernel (interpret mode), the FFN and projection planners at hubert's
width and M, and the reference's refusals of an encoder
(`LocalBackend`, `extend`, `decode_step`: ValueError).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ffn_act as RFF
from repro.models import Model as RefModel
from repro_torch import bridge
from repro_torch.configs.base import get_config, list_archs
from repro_torch.kernels import ffn_act as FF
from repro_torch.kernels import qkv_proj as QK
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models.model import MAX_LEARNED_POS
from repro_torch.serving import LocalBackend
from test_torch_config import F32, _configs

jax.config.update("jax_platform_name", "cpu")

ARCHS = tuple(list_archs())
LOGIT_TOL = 1e-4
N_SMS = 132


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _full_batch(cfg) -> dict:
    """Two rows of 24 positions: hubert's frames, a VLM's patches then
    text (the reduced configs have 8 patches), else text. The text
    repeats one token over its last 16 positions, so the MoE routes
    those rows alike and an expert overflows its capacity."""
    rng = np.random.default_rng(11)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (2, 24, cfg.frontend.frontend_dim)).astype(np.float32)}
    toks = np.concatenate([rng.integers(0, cfg.vocab_size, (2, 8)),
                           np.full((2, 16), 3)], 1).astype(np.int32)
    if cfg.frontend is None:
        return {"tokens": toks}
    f = cfg.frontend
    return {"patches": rng.standard_normal(
                (2, f.num_tokens, f.frontend_dim)).astype(np.float32),
            "tokens": toks[:, :24 - f.num_tokens]}


@functools.lru_cache(maxsize=None)
def _port_pair(arch: str):
    """(cfg, Model, params, the reference's logits): the port draws the
    weights (f32, seed 0) and the reference's `forward` runs on the same
    leaves through the bridge, sparing the reference's own init."""
    rc, pc = _configs(arch)
    rc, pc = rc.replace(**F32), pc.replace(**F32)
    model = Model(pc)
    params = model.init(torch.Generator().manual_seed(0))
    rparams = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(params))
    want = np.asarray(RefModel(rc).forward(rparams, _full_batch(pc)))
    return pc, model, params, want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, monkeypatch):
    """Every position's logits within 1e-4 of the reference's full mode;
    on the MoE archs the capacity path ran and dropped rows."""
    pc, model, params, want = _port_pair(arch)
    overflow = []
    if pc.moe is not None:
        moe = L.apply_moe

        def watched(p, cfg, x, dropless=True, tp=None):
            T = x.shape[0] * x.shape[1]
            idx = torch.softmax(x.reshape(T, -1).float() @ p["router"], -1
                                ).topk(cfg.moe.top_k, -1).indices
            counts = torch.bincount(idx.reshape(-1),
                                    minlength=cfg.moe.num_experts)
            overflow.append((dropless, int(counts.max()),
                             L.moe_capacity(cfg, T, dropless)))
            return moe(p, cfg, x, dropless, tp=tp)
        monkeypatch.setattr(L, "apply_moe", watched)
    logits = model.forward(params, _full_batch(pc))
    assert logits.shape == want.shape
    assert logits.shape[:2] == (2, 24) and not logits.requires_grad
    _close(logits, want)
    if pc.moe is not None:
        assert overflow and not any(d for d, _, _ in overflow)
        assert any(n > cap for _, n, cap in overflow), overflow


# ---------------------------------------------------------------------------
# the MoE: the fixed-order combine and the capacity-dropping layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 6])
def test_moe_combine_equals_per_token_loop(k):
    """The combine sums each token's k rows, choice 0 first; a loop over
    tokens doing the same additions gives the same bits."""
    T, D, E = 13, 24, 8
    g = torch.Generator().manual_seed(k)
    expert = torch.stack([torch.randperm(E, generator=g)[:k]
                          for _ in range(T)]).reshape(-1)
    order = torch.argsort(expert, stable=True)
    contrib = torch.randn(T * k, D, generator=g).to(torch.bfloat16)
    got = L.moe_combine(contrib, order, k)
    token_rows = contrib[torch.argsort(order)]      # token-major again
    want = torch.empty_like(got)
    for t in range(T):
        acc = token_rows[t * k]
        for i in range(1, k):
            acc = acc + token_rows[t * k + i]
        want[t] = acc
    assert torch.equal(got, want)


def test_moe_capacity_rounds_like_reference():
    cfg = get_config("llama4-maverick-400b")       # E 128, top-1, cf 1.25
    assert [L.moe_capacity(cfg, T, False) for T in (1, 100, 8192, 20000)] \
        == [1, 1, 80, 256]
    ds = get_config("deepseek-v2-lite")             # E 64, top-6
    assert [L.moe_capacity(ds, T, False) for T in (1000, 1200)] \
        == [117, 256]
    assert L.moe_capacity(ds, 1000, True) == 1000


# ---------------------------------------------------------------------------
# the in-place parameter draw
# ---------------------------------------------------------------------------
def test_param_init_draws_large_leaves_in_chunks(monkeypatch):
    """A leaf above CHUNK_ELEMS is drawn straight into its destination in
    chunks along its leading axis (each chunk one `randn` of the stream);
    a smaller one whole, as `randn * std` cast to the parameter dtype."""
    g, want_g = torch.Generator(), torch.Generator()
    b = L.ParamInit(g.manual_seed(4), torch.bfloat16, "cpu")
    small = b.normal((6, 10))
    want = (torch.randn((6, 10), generator=want_g.manual_seed(4))
            * 6 ** -0.5).to(torch.bfloat16)
    assert torch.equal(small, want)
    monkeypatch.setattr(L, "CHUNK_ELEMS", 100)
    big = b.normal((7, 30), scale=0.5)
    parts = [torch.randn((n, 30), generator=want_g) for n in (3, 3, 1)]
    assert torch.equal(big, (torch.cat(parts) * 0.5).to(torch.bfloat16))
    dest = torch.zeros(2, 7, 30)
    b2 = L.ParamInit(g.manual_seed(9), torch.float32, "cpu",
                     out=iter([dest[1]]))
    assert b2.normal((7, 30)).data_ptr() == dest[1].data_ptr()
    assert dest[0].abs().sum() == 0 and dest[1].abs().sum() > 0


# ---------------------------------------------------------------------------
# hubert-xlarge: the encoder
# ---------------------------------------------------------------------------
def test_hubert_builds_and_refuses_a_cache_like_reference():
    """hubert builds (no embedding table, a learned position table, the
    linear connector); serving and extending it raise the reference's
    ValueErrors."""
    pc, model, params, _ = _port_pair("hubert-xlarge")
    ref_leaves, _ = RefModel(_configs("hubert-xlarge")[0]).abstract_params()
    assert pc.is_encoder and pc.pos_emb == "learned"
    assert "embed" not in params and "embed" not in ref_leaves
    assert ref_leaves["pos_emb"].shape == (MAX_LEARNED_POS, pc.d_model)
    assert params["pos_emb"].shape == (MAX_LEARNED_POS, pc.d_model)
    assert set(params["frontend"]) == {"w1", "b1"}
    with pytest.raises(ValueError, match="encoder-only model cannot be "
                                         "served"):
        LocalBackend(model, params, 2, 16, device="cpu")
    frames = np.zeros((1, 3, pc.frontend.frontend_dim), np.float32)
    with pytest.raises(ValueError, match="encoder-only model cannot "
                                         "extend"):
        model.extend(params, {"frames": frames},
                     model.init_extend_cache(1, 16), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(params, np.zeros((1, 1), np.int32),
                          model.init_cache(1, 16), 0)


def test_hubert_attends_both_ways_and_clamps_positions():
    """Non-causal: a change to the last frame moves the first frame's
    logits. Positions past the table read its last row."""
    pc, model, params, _ = _port_pair("hubert-xlarge")
    frames = _full_batch(pc)["frames"][:1]
    base = model.forward(params, {"frames": frames})
    moved = frames.copy()
    moved[0, -1] += 1.0
    assert (model.forward(params, {"frames": moved})[0, 0]
            - base[0, 0]).abs().max() > 1e-4
    # four alike frames from position MAX_LEARNED_POS - 2 on: the last
    # three read the table's last row
    alike = {"frames": np.repeat(frames[:, :1], 4, axis=1)}
    x, pos = model._embed(params, alike, MAX_LEARNED_POS - 2, ramp=True)
    assert pos[0].tolist() == [MAX_LEARNED_POS - 2 + i for i in range(4)]
    assert not torch.equal(x[0, 0], x[0, 1])
    assert torch.equal(x[0, 1], x[0, 2]) and torch.equal(x[0, 1], x[0, 3])


def test_ffn_act_twin_matches_pallas_at_hubert_gelu():
    """hubert's FFN: ungated tanh GELU at d_model 1280, F 5120."""
    rng = np.random.default_rng(12)
    M, D, Fd = 16, 1280, 5120
    x = rng.standard_normal((M, D)).astype(np.float32)
    wu = (rng.standard_normal((D, Fd)) * D ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((Fd, D)) * Fd ** -0.5).astype(np.float32)
    want = RFF.ffn_act(jnp.asarray(x), jnp.asarray(wu), None,
                       jnp.asarray(wd), "gelu", interpret=True)
    got = FF.ffn_act(_t(x), _t(wu), None, _t(wd), "gelu")
    _close(got, want, tol=2e-5)


def test_hubert_plans_at_full_width():
    """At hubert's width and its 4 x 500-frame batch (M 2000, a multiple
    of neither 64 nor 128): the wgmma FFN's F split covers F 5120, the
    projection GEMM takes one of its instances, the bf16 forms are the
    tensor-core ones, and the full config's parameters equal the
    reference's count."""
    cfg = get_config("hubert-xlarge")
    D, F_, M = cfg.d_model, cfg.d_ff, 4 * 500
    assert (D, F_, cfg.num_layers, cfg.head_dim) == (1280, 5120, 48, 80)
    assert M % 64 and M % 128
    wgs, ks, k_chunk = FF.wgmma_plan(M, D, F_, N_SMS)
    assert (ks - 1) * k_chunk < F_ <= ks * k_chunk
    assert FF.kernel_variant(M, torch.bfloat16, True) == "wgmma"
    assert QK.kernel_variant(M, torch.bfloat16) == "wgmma"
    assert QK.gemm_warpgroups(M, (D, D, D), N_SMS) in (1, 2)
