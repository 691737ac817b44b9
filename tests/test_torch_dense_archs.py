"""PyTorch port: the three dense attention archs of the tenth slice —
stablelm-12b (LayerNorm, head dim 160, d_model 5120), starcoder2-7b
(LayerNorm, QKV and MLP bias, ungated GELU, G = 9) and paligemma-3b (the
MLLM: 256 image tokens through the MLP connector, MQA, head dim 256,
gated GELU, tied head) — against the live JAX reference on the CPU, and
the kernels' plain twins and shape functions at the widths they bring.

Every model case runs the registered reduced config in f32 with the
reference's own `Model.init(PRNGKey(0))` weights (`build_pair`): prefill,
chunked extend and batched decode logits over the flat and tiered stores
(1e-4 max-abs, f32 sums in another order over two layers), `generate`
tokens, and the port's Engine against the reference Engine (plans,
tokens, stats and endurance identical; paligemma with VQA requests).

`ffn_act`'s plain twin holds the Pallas kernel (interpret mode) at
d_model 5120 with a small F (2e-5, f32 in another order); the other
twins' cases at head dims 160 / 256 and G 9 are rows of their tests in
`test_torch_kernels.py`. The CUDA kernels run only on the card
(`chip_smoke.py`); their Python mirrors are checked here at the full
widths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ffn_act as RFF
from repro.launch.serve import generate as ref_generate
from repro.serving import Engine as RefEngine
from repro.serving import LocalBackend as RefBackend
from repro.serving import Request as RefRequest
from repro_torch.configs.base import Segment, get_config
from repro_torch.kernels import attn_stream as AS
from repro_torch.kernels import ffn_act as FF
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import qkv_proj as QK
from repro_torch.launch.serve import generate, main
from repro_torch.models import Model
from repro_torch.serving import Engine, LocalBackend, Request
from repro_torch.tree import tree_map
from test_torch_config import build_pair
from test_torch_serving import _batch, _record_plans, _requests, _stream

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("stablelm-12b", "starcoder2-7b", "paligemma-3b")
LOGIT_TOL = 1e-4
TOL = dict(rtol=2e-5, atol=2e-5)
SMEM_SM = 233_472          # shared memory of a Hopper SM
N_SMS = 132


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# the model: prefill, chunked extend, batched decode
# ---------------------------------------------------------------------------
_CHUNKS = ((5, 5, False), (5, 5, False), (8, 6, True))
DECODE_STEPS = 4
MAX_LEN = 48


def _prompts(cfg):
    """Two prompts: 5 tokens (with an image on the VLM: its 16 reduced
    patches first) and 16 tokens, short of and past the hot window of
    8; -> [(tokens, patches or None)]."""
    rng = np.random.default_rng(9)
    f = cfg.frontend
    img = (rng.standard_normal((f.num_tokens, f.frontend_dim))
           .astype(np.float32) if f is not None else None)
    return [(rng.integers(0, cfg.vocab_size, 5).astype(np.int32), img),
            (rng.integers(0, cfg.vocab_size, 16).astype(np.int32), None)]


@functools.lru_cache(maxsize=None)
def _ref_run(arch: str, kv_policy: str):
    """The reference's logits (memoized): each prompt's prefill and
    DECODE_STEPS greedy decode steps one row at a time, and the text
    prompt's chunked extend."""
    _, rmodel, rparams, pc, _, _ = build_pair(arch, kv_policy)
    out = {"prefill": [], "decode": []}
    decode = jax.jit(rmodel.decode_step)      # pos traced: one compile
    for toks, patches in _prompts(pc):
        rl, rcache = rmodel.prefill(rparams, _batch(toks, patches), MAX_LEN)
        out["prefill"].append(np.asarray(rl))
        pos = len(toks) + (0 if patches is None else len(patches))
        tok, steps = np.asarray(rl)[0, -1].argmax(), []
        for _ in range(DECODE_STEPS):
            rl, rcache = decode(rparams, np.array([[tok]], np.int32),
                                rcache, jnp.int32(pos))
            steps.append(np.asarray(rl))
            tok, pos = np.asarray(rl)[0, -1].argmax(), pos + 1
        out["decode"].append(steps)
    ext, p = rmodel.init_extend_cache(1, MAX_LEN), 0
    toks = _prompts(pc)[1][0]
    for n, valid, commit in _CHUNKS:
        chunk = np.zeros((1, n), np.int32)
        chunk[0, :valid] = toks[p:p + valid]
        rl, ext = rmodel.extend(rparams, {"tokens": chunk}, ext, p, valid,
                                commit=commit)
        p += valid
    out["extend"] = np.asarray(rl)
    return out


@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match_reference(arch, kv_policy):
    """Prefill of both prompts, the text prompt's chunked extend (5 + 5 +
    a padded 6 of 8, committed) and DECODE_STEPS greedy decode steps of
    BOTH rows in one batched call at their own positions: every logit
    within 1e-4 of the reference's (whose decode runs a row at a
    time)."""
    check_model_logits(arch, kv_policy)


def check_model_logits(arch: str, kv_policy: str) -> None:
    """The body of `test_model_logits_match_reference`, for any arch."""
    _, _, _, pc, model, params = build_pair(arch, kv_policy)
    ref = _ref_run(arch, kv_policy)
    caches, last, pos = [], [], []
    for i, (toks, patches) in enumerate(_prompts(pc)):
        pl, cache = model.prefill(params, _batch(toks, patches), MAX_LEN)
        _close(pl, ref["prefill"][i])
        caches.append(cache)
        last.append(int(pl[0, -1].argmax()))
        pos.append(len(toks) + (0 if patches is None else len(patches)))
    # rows join on the batch axis: axis 1 under a stacked unit's repeats
    cache = {f"u{i}": tree_map(
        lambda *a, ax=int(u.repeats > 1): torch.cat(a, dim=ax),
        *[c[f"u{i}"] for c in caches]) for i, u in enumerate(model.plan)}
    pos, tok = torch.tensor(pos), torch.tensor(last)[:, None]
    for step in range(DECODE_STEPS):
        pl, cache = model.decode_step(params, tok, cache, pos)
        for b in range(len(last)):
            _close(pl[b:b + 1], ref["decode"][b][step])
        tok, pos = pl[:, -1].argmax(-1)[:, None], pos + 1
    ext, p = model.init_extend_cache(1, MAX_LEN), 0
    toks = _prompts(pc)[1][0]
    for n, valid, commit in _CHUNKS:
        chunk = np.zeros((1, n), np.int32)
        chunk[0, :valid] = toks[p:p + valid]
        pl, ext = model.extend(params, {"tokens": chunk}, ext, p, valid,
                               commit=commit)
        p += valid
    _close(pl, ref["extend"])
    _close(pl, ref["prefill"][1])


def test_configs_bring_the_features_of_the_slice():
    """What each config exercises: stablelm's and starcoder2's LayerNorm
    with bias, starcoder2's QKV and MLP biases (its FFN takes the plain
    path, as in the reference), paligemma's vision frontend and tied
    head; at full width the head dims and groups the kernels were
    widened to."""
    for arch, (hd, G, D) in {"stablelm-12b": (160, 4, 5120),
                             "starcoder2-7b": (128, 9, 4608),
                             "paligemma-3b": (256, 8, 2048)}.items():
        full = get_config(arch)
        assert (full.head_dim, full.num_heads // full.num_kv_heads,
                full.d_model) == (hd, G, D)
    _, _, _, sc, _, params = build_pair("starcoder2-7b")
    assert sc.norm_type == "layernorm" and sc.use_mlp_bias
    unit = params["units"]["u0"]
    assert "bq" in unit["mixer"] and "b_up" in unit["mlp"]
    _, _, _, pg, _, params = build_pair("paligemma-3b")
    assert pg.frontend is not None and pg.tie_embeddings
    assert "lm_head" not in params


# ---------------------------------------------------------------------------
# generate and the serving engine (`test_torch_serving`'s mixed stream:
# five requests, every other one VQA where the config has a frontend)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    _, rmodel, rparams, pc, model, params = build_pair(arch)
    toks, patches, _ = _stream(pc, seed=2)[0]
    n = len(toks) + (0 if patches is None else len(patches))
    want, _ = ref_generate(rmodel, rparams, _batch(toks, patches), n, 10)
    got, _ = generate(model, params, _batch(toks, patches), n, 10,
                      device="cpu")
    assert got[0].tolist() == np.asarray(want)[0].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch):
    """Port and reference engines on the same stream (VQA and text on
    paligemma), 2 slots over the tiered store: identical StepPlans,
    token streams, stats and endurance reports."""
    check_engine(arch)


def check_engine(arch: str) -> None:
    """The body of `test_engine_matches_reference_engine`, for any arch."""
    _, rmodel, rparams, pc, model, params = build_pair(arch)
    stream = _stream(pc, seed=5)
    eng = Engine(LocalBackend(model, params, 2, 40, device="cpu"))
    reng = RefEngine(RefBackend(rmodel, rparams, 2, 40))
    plans, rplans = _record_plans(eng), _record_plans(reng)
    done = eng.run(_requests(stream, Request))
    rdone = reng.run(_requests(stream, RefRequest))
    assert plans == rplans and len(plans) > len(stream)
    assert [r.generated for r in sorted(done, key=lambda r: r.rid)] == \
        [r.generated for r in sorted(rdone, key=lambda r: r.rid)]
    assert eng.endurance_report() == reng.endurance_report()
    assert eng.stats == reng.stats
    assert eng.endurance_report()["write_once_ok"]
    if pc.frontend is not None:
        assert any(p is not None for _, p, _ in stream)


def test_serve_cli_paligemma_with_images_on_cpu(capsys):
    done = main(["--arch", "paligemma-3b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--concurrency", "2", "--prompt-len",
                 "12", "--gen", "4", "--image-every", "2", "--hot-window",
                 "4", "--dtype", "float32"])
    assert len(done) == 3 and all(r.n_generated == 4 for r in done)
    assert sum(r.patches is not None for r in done) == 2
    assert "tok/J" in capsys.readouterr().out


def test_waiting_mixers_still_raise():
    """Every mixer and config shape is ported: rwkv6 and mamba2 build, and
    so do an encoder-only config and learned position embeddings
    (hubert-xlarge's shape). What an encoder cannot do raises the
    reference's ValueErrors: it cannot be served or extend a cache."""
    cfg = get_config("stablelm-12b", reduced=True)
    for mixer in ("rwkv6", "mamba2"):
        Model(cfg.replace(segments=(Segment((mixer,), 2),)))
    Model(cfg.replace(pos_emb="learned"))
    enc = Model(cfg.replace(is_encoder=True))
    params = enc.init(device="cpu")
    with pytest.raises(ValueError, match="cannot be served"):
        LocalBackend(enc, params, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="cannot extend a cache"):
        enc.extend(params, {"tokens": np.zeros((1, 2), np.int32)},
                   enc.init_extend_cache(1, 16), 0)


# ---------------------------------------------------------------------------
# ffn_act's plain twin at stablelm-12b's d_model, against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["silu_gated", "gelu"])
def test_ffn_act_twin_matches_pallas_at_d_model_5120(kind):
    rng = np.random.default_rng(24)
    M, D, Fd = 8, 5120, 64
    x = rng.standard_normal((M, D)).astype(np.float32)
    wu = (rng.standard_normal((D, Fd)) * D ** -0.5).astype(np.float32)
    wg = ((rng.standard_normal((D, Fd)) * D ** -0.5).astype(np.float32)
          if kind.endswith("gated") else None)
    wd = (rng.standard_normal((Fd, D)) * Fd ** -0.5).astype(np.float32)
    want = RFF.ffn_act(jnp.asarray(x), jnp.asarray(wu),
                       None if wg is None else jnp.asarray(wg),
                       jnp.asarray(wd), kind, interpret=True)
    got = FF.ffn_act(_t(x), _t(wu), None if wg is None else _t(wg), _t(wd),
                     kind)
    _close(got, want, tol=TOL["atol"])


# ---------------------------------------------------------------------------
# the kernels' shape functions at the full widths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_attention_mirrors_fit_at_full_width(arch):
    """At the arch's head dim and group: both paged decodes' shared
    memory (max_len 512, 4 pages; and a 32k-token table) fits a block
    and, by shared memory, the planner's two blocks an SM in both
    dtypes; the tensor-core tiered tiles hold the 8 keys an mma takes;
    the bf16 attention kernel's tiles fit a block (one an SM at Dh 256)."""
    cfg = get_config(arch)
    D, G = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    assert D in PD.HEAD_DIMS and D in AS.HEAD_DIMS
    assert G <= PD.max_group(D)
    for dt in (torch.bfloat16, torch.float32):
        tk = PD.tiered_tile_keys(D, dt, G)
        assert tk >= 1 and (dt != torch.bfloat16 or G < 2 or tk % 8 == 0)
        for n_pages in (4, 32768 // 128):
            for b in (PD.tiered_smem_bytes(n_pages, D, G, dt),
                      PD.flat_smem_bytes(n_pages)):
                assert b <= PD.SMEM_LIMIT
        for b in (PD.tiered_smem_bytes(4, D, G, dt), PD.flat_smem_bytes(4)):
            assert SMEM_SM // (b + 2048) >= PD.FLAT_BLOCKS_PER_SM
        assert PD.flat_tile_keys(D, dt) >= 1
    need = AS.wgmma_smem_bytes(D)
    assert need <= AS.SMEM_LIMIT
    assert need == 5 * 64 * 2 * D + 1024
    assert (2 * need <= AS.SMEM_LIMIT) == (D <= 160)


@pytest.mark.parametrize("D,F_", [(5120, 13824), (4608, 18432),
                                  (2048, 16384)])
def test_ffn_plans_cover_f_at_full_width(D, F_):
    """The FFN's planners at the three archs' widths: the stream form's
    slices cover F and its shared memory fits a block at decode (M 4)
    and at its largest M (8); the wgmma form's F split covers F; the fma
    form's bands of FMA_BAND columns cover D and its F chunks cover F,
    the grid within one chunk of BLOCKS_PER_SM blocks an SM."""
    ds, cl, nb = FF.stream_plan(F_, N_SMS)
    assert (nb // ds) * FF.STREAM_SLICE >= F_ and nb % cl == 0
    for M in (4, FF.STREAM_MAX_M):
        assert FF.stream_smem_bytes(M, D, ds) <= FF.SMEM_LIMIT
    for M in (64, 256, 320):
        wgs, ks, k_chunk = FF.wgmma_plan(M, D, F_, N_SMS)
        assert (ks - 1) * k_chunk < F_ <= ks * k_chunk
    bands = -(-D // FF.FMA_BAND)
    assert bands * FF.FMA_BAND >= D and (bands - 1) * FF.FMA_BAND < D
    assert bands == (2 if D > 3072 else 1)
    for M in (4, 256):
        per, n = FF.f_chunking(M, F_, N_SMS, D)
        assert per % FF.BF == 0 and (n - 1) * per < F_ <= n * per
        n_mt = -(-M // FF.FMA_ROWS) * bands
        assert n_mt * (n - 1) < max(FF.BLOCKS_PER_SM * N_SMS, n_mt)


@pytest.mark.parametrize("D,ns,bias", [
    (5120, (5120, 1280, 1280), False),     # stablelm-12b
    (4608, (4608, 512, 512), True),        # starcoder2-7b
    (2048, (2048, 256, 256), False)])      # paligemma-3b
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qkv_proj_split_fits_at_full_width(D, ns, bias, dtype):
    """The decode GEMV's D split covers D in whole row groups within a
    portable cluster, and its x chunk fits shared memory; the prefill
    GEMM's warpgroups are one of its two instances."""
    for M in (1, 4):
        n_split, d_chunk = QK.gemv_split(M, D, ns, N_SMS, dtype)
        assert 1 <= n_split <= QK.GEMV_MAX_SPLIT and d_chunk % 32 == 0
        assert (n_split - 1) * d_chunk < D <= n_split * d_chunk
        assert QK.gemv_smem_bytes(M, d_chunk, dtype) <= QK.SMEM_LIMIT
    assert QK.gemm_warpgroups(256, ns, N_SMS) in (1, 2)
    assert QK.kernel_variant(4, dtype) == "gemv"


def test_widths_no_kernel_takes_still_raise():
    """What no kernel takes raises before anything launches: a head dim
    outside the widened set, a group above 8 at head dim 256, a stream
    FFN whose x rows and partial overflow a block."""
    for hd in (48, 192, 320):
        with pytest.raises(ValueError):
            AS.kernel_variant(torch.bfloat16, hd)
        q = torch.zeros(1, 1, 2, hd)
        with pytest.raises(ValueError, match="head dims"):
            PD._check("paged_decode_flat", q, {})
    with pytest.raises(ValueError, match="<= 8 at 256"):
        PD._check("paged_decode_tiered", torch.zeros(1, 1, 9, 256), {})
    PD._check("paged_decode_flat", torch.zeros(1, 1, 9, 160), {})
    assert FF.stream_smem_bytes(8, 6144, 1) > FF.SMEM_LIMIT
