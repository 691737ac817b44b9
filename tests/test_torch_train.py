"""PyTorch port: the training loss and its gradients against the live JAX
reference on the CPU.

`Model.loss` (the full forward, the f32 logsumexp cross-entropy under
``loss_mask``, plus 0.01 x the MoE load-balancing terms) and its
gradients, by autograd, against `jax.value_and_grad` of the reference's
`Model.loss` on the same weights (the port's draw, carried across by the
bridge) and the same numpy batch: text (granite-3-2b), VQA with a loss
mask (fastvlm-1.7b), MLA with the capacity-dropping MoE and its aux term
(deepseek-v2-lite, on a batch where an expert overflows), RWKV6, Mamba2
with the shared attention block, and audio frames (hubert-xlarge), on
the reduced configs (three cut shallower still: `CUTS`). The
loss is held to 1e-5 relative, each gradient leaf to 1e-4 of its largest
element (f32; the two frameworks sum in other orders).

Besides: the three remat settings give equal gradients (and "none"
recomputes nothing), `moe_aux_loss` against the reference's, each kernel
Function's gradients against autograd through the plain twin, the
model's gradients with every kernel made opaque to autograd (as a ctypes
launch is on the card), the int8 FFN store refused by both packages,
and `Model.init`'s default device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.models import Model as RefModel
from repro.models import layers as RL
from repro_torch import bridge
from repro_torch.configs import base as PB
from repro_torch.kernels import attn_stream as AT
from repro_torch.kernels import ffn_act as FF
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import ops
from repro_torch.kernels import qkv_proj as QK
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map
from test_torch_config import F32, _configs

jax.config.update("jax_platform_name", "cpu")

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest element
# the reference's jitted functions compile at XLA's lowest optimization
# level: half the compile time, the same function
FAST_COMPILE = {"xla_backend_optimization_level": 0}
ARCHS = ("granite-3-2b", "fastvlm-1.7b", "deepseek-v2-lite", "rwkv6-7b",
         "zamba2-1.2b", "hubert-xlarge")
# depth cuts below the registered reduced configs (the reference unrolls
# its layers, and each costs a gradient compile): deepseek keeps its
# dense layer and one MoE layer, rwkv6 one layer, zamba2 the shared
# attention block applied twice over a stacked unit
CUTS = {"deepseek-v2-lite": lambda B: dict(
            num_layers=2, segments=(B.Segment(("mla",), 2),)),
        "rwkv6-7b": lambda B: dict(
            num_layers=1, segments=(B.Segment(("rwkv6",), 1),)),
        "zamba2-1.2b": lambda B: dict(
            num_layers=4, segments=(B.Segment(("mamba2", "attn_shared"),
                                              2),))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the host's cores, and torch's intra-op threads
    oversubscribe them (the 20-step CLI run took 84 s in each of six
    concurrent processes of 8 threads, 1.5 s with one thread each); these
    tensors are small, so one thread a worker loses nothing here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_batch(cfg, B: int = 2, S: int = 24, seed: int = 5) -> dict:
    """A numpy batch in the pipeline's layouts: frames + labels (audio);
    patches, text, labels and a loss mask that zeroes the visual rows
    and a few text rows (VLM); else text, labels and a mask. The text
    repeats one token over its last 12 positions, so the MoE routes
    those rows alike and an expert overflows its capacity."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
                    (B, S, cfg.frontend.frontend_dim)).astype(np.float32),
                "labels": labels}
    toks = np.concatenate([rng.integers(0, cfg.vocab_size, (B, S - 12)),
                           np.full((B, 12), 3)], 1).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    if cfg.frontend is None:
        return {"tokens": toks, "labels": labels, "loss_mask": mask}
    tv = cfg.frontend.num_tokens
    mask[:, :tv] = 0.0
    return {"patches": rng.standard_normal(
                (B, tv, cfg.frontend.frontend_dim)).astype(np.float32),
            "tokens": toks[:, :S - tv], "labels": labels, "loss_mask": mask}


def train_configs(arch: str):
    """(reference cfg, port cfg): the reduced config, cut as `CUTS` says."""
    rc, pc = _configs(arch)
    if arch in CUTS:
        rc, pc = rc.replace(**CUTS[arch](RB)), pc.replace(**CUTS[arch](PB))
    return rc, pc


def port_model(arch: str, **knobs):
    """(cfg, Model, params): the cut f32 config, weights from seed 0."""
    _, pc = train_configs(arch)
    pc = pc.replace(**{**F32, **knobs})
    model = Model(pc)
    return pc, model, model.init(torch.Generator().manual_seed(0))


def grads_of(model, params, batch):
    """(loss, {leaf path: gradient}) by autograd."""
    paths = [p for p, _ in tree_leaves_with_path(params)]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), params)
    loss = model.loss(tree, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(paths, grads))


@functools.lru_cache(maxsize=None)
def reference_grads(arch: str):
    """The reference's (loss, {leaf path: gradient}) on the port's
    weights and `train_batch`, by jitted `jax.value_and_grad`
    (`FAST_COMPILE`)."""
    rc, _ = train_configs(arch)
    pc, _, params = port_model(arch)
    rparams = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(params))
    loss, g = jax.jit(jax.value_and_grad(RefModel(rc.replace(**F32)).loss),
                      compiler_options=FAST_COMPILE)(rparams, train_batch(pc))
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return float(loss), {tuple(k.key for k in path): np.asarray(v)
                         for path, v in flat}


def assert_grads_close(got: dict, want: dict, tol: float = GRAD_TOL):
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path].detach().float().numpy()
        scale = np.abs(w).max()
        assert scale > 0, path
        err = np.abs(g - w).max()
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    pc, model, params = port_model(arch)
    want_loss, want = reference_grads(arch)
    loss, got = grads_of(model, params, train_batch(pc))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert_grads_close(got, want)


def test_moe_layers_add_aux_and_drop_rows():
    """deepseek's loss carries 0.01 x the aux terms: without them it is
    the masked cross-entropy alone, and the batch overflows an expert."""
    pc, model, params = port_model("deepseek-v2-lite")
    batch = train_batch(pc)
    aux = []
    real = L.moe_aux_loss

    def keep(p, cfg, x):
        aux.append(real(p, cfg, x))
        T = x.shape[0] * x.shape[1]
        top = torch.softmax(x.reshape(T, -1) @ p["router"], -1).topk(
            cfg.moe.top_k).indices
        aux[-1] = (aux[-1], int(torch.bincount(top.reshape(-1)).max()),
                   L.moe_capacity(cfg, T, False))
        return aux[-1][0]
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "moe_aux_loss", keep)
        loss = model.loss(params, batch)
    n_moe = sum(u.repeats for u in model.plan if u.block.mlp == "moe")
    assert len(aux) == n_moe > 0
    assert any(n > cap for _, n, cap in aux)
    logits = model.forward(params, batch)
    lf = logits.float()
    ll = (lf.gather(-1, torch.as_tensor(batch["labels"]).long()[..., None])
          [..., 0] - torch.logsumexp(lf, -1))
    mask = torch.as_tensor(batch["loss_mask"])
    ce = -(ll * mask).sum() / mask.sum()
    torch.testing.assert_close(loss, ce + 0.01 * sum(a for a, _, _ in aux),
                               rtol=0, atol=1e-6)


def test_moe_aux_loss_matches_reference():
    pc, _, params = port_model("deepseek-v2-lite")
    mlp = next(u["mlp"] for u in params["units"].values()
               if "router" in u["mlp"])
    if mlp["router"].dim() == 3:                  # a stacked unit
        mlp = tree_map(lambda a: a[0], mlp)
    x = np.random.default_rng(2).standard_normal(
        (2, 24, pc.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(RL.moe_aux_loss, cfg=pc),
                   compiler_options=FAST_COMPILE)(
        jax.tree.map(jnp.asarray, bridge.tree_to_numpy(mlp)),
        x=jnp.asarray(x))
    got = L.moe_aux_loss(mlp, pc, torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["fastvlm-1.7b", "deepseek-v2-lite"])
def test_remat_settings_give_equal_grads(arch, monkeypatch):
    """"none", "full" and "save_dots" give the same loss and gradients;
    "none" recomputes nothing, "full" reruns every block's norms in
    backward, "save_dots" saves the matmul products."""
    calls, saved = [], []
    norm = FN.fused_norm
    monkeypatch.setattr(FN, "fused_norm",
                        lambda *a, **k: calls.append(1) or norm(*a, **k))
    policy = M._save_dots

    def watch(ctx, op, *a, **k):
        out = policy(ctx, op, *a, **k)
        saved.append(out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE)
        return out
    monkeypatch.setattr(M, "_save_dots", watch)
    runs = {}
    for remat in ("none", "full", "save_dots"):
        pc, model, params = port_model(arch, remat=remat)
        calls.clear()
        runs[remat] = grads_of(model, params, train_batch(pc))
        n_blocks = sum(u.repeats for u in model.plan)
        assert len(calls) == (2 * n_blocks + 1) * (1 if remat == "none"
                                                    else 2) - (remat != "none")
    assert any(saved) and not all(saved)
    for remat in ("full", "save_dots"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        for path, g in runs["none"][1].items():
            assert torch.equal(runs[remat][1][path], g), (remat, path)


# ---------------------------------------------------------------------------
# the kernel Functions
# ---------------------------------------------------------------------------
def _kernel_cases():
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = t(2, 5, 16)
    def rows(plain, x, *rest, **kw):    # a twin over x's rows, x's layout
        return plain(x.reshape(-1, 16), *rest, **kw).reshape(x.shape)

    def qkv_plain(*a):                  # the twin in the model's layout
        return ops._qkv_call(QK.qkv_proj_plain, *a, *(None,) * (7 - len(a)))
    x = t(2, 5, 16)
    cases = {
        "fused_norm-rms": (lambda x, s: ops.fused_norm(x, s, None, "rms"),
                           lambda x, s: rows(FN.fused_norm_plain, x, s, None,
                                             "rms"),
                           (x, t(16))),
        "fused_norm-layer": (lambda x, s, b: ops.fused_norm(x, s, b, "layer"),
                             lambda x, s, b: rows(FN.fused_norm_plain, x, s,
                                                  b, "layer"),
                             (x, t(16), t(16))),
        "qkv_proj-bias": (ops.qkv_proj, qkv_plain,
                          (x, t(16, 4, 8), t(16, 2, 8), t(16, 2, 8), t(4, 8),
                           t(2, 8), t(2, 8))),
        "qkv_proj": (ops.qkv_proj, qkv_plain,
                     (x, t(16, 4, 8), t(16, 2, 8), t(16, 2, 8))),
        "attn_stream": (ops.attn_stream,
                        functools.partial(ops._attn_plain, causal=True),
                        (t(2, 7, 6, 8), t(2, 7, 2, 8), t(2, 7, 2, 8))),
    }
    for kind in FF.ACTS:
        gated = kind.endswith("gated")
        cases[f"ffn_act-{kind}"] = (
            functools.partial(lambda kind, x, *w: ops.ffn_act(x, *w, kind),
                              kind),
            functools.partial(lambda kind, x, *w: rows(
                FF.ffn_act_plain, x, *w, kind=kind), kind),
            (x, t(16, 24), t(16, 24) if gated else None, t(24, 16)))
    return cases


KERNEL_CASES = _kernel_cases()


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_function_grads_match_twin(name):
    """Each kernel Function's output and every input gradient against
    autograd through the plain twin on the same inputs; without a
    gradient the wrapper runs bare (nothing saved)."""
    fn, plain, inputs = KERNEL_CASES[name]
    xs = [None if a is None else a.clone().requires_grad_(True)
          for a in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(type(o.grad_fn).__name__ == "KernelGradBackward"
               for o in outs)
    cot = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        o.shape).astype(np.float32)) for i, o in enumerate(outs)]
    live = [a for a in xs if a is not None]
    got = torch.autograd.grad(outs, live, cot)
    ys = [None if a is None else a.clone().requires_grad_(True)
          for a in inputs]
    ref = plain(*ys)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        assert torch.equal(o.detach(), r.detach())
    want = torch.autograd.grad(refs, [a for a in ys if a is not None], cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    with torch.no_grad():
        bare = fn(*xs)
    assert all(o.grad_fn is None for o in
               (bare if isinstance(bare, tuple) else (bare,)))


def test_grads_reach_through_opaque_kernels(monkeypatch):
    """On the card a kernel launch is invisible to autograd. With every
    training-path wrapper made opaque the same way (its twin under
    `no_grad`, the result detached), the model's loss and every gradient
    leaf are unchanged: the backward comes from the kernel Functions."""
    pc, model, params = port_model("fastvlm-1.7b")
    batch = train_batch(pc)
    want_loss, want = grads_of(model, params, batch)

    def opaque(plain):
        def run(*a, **k):
            with torch.no_grad():
                return plain(*a, **k)
        return run

    def opaque_attn(q, k, v, causal=True, scale=None, out=None):
        with torch.no_grad():
            out.copy_(AT.attn_stream_plain(q, k, v, causal, scale))
        return out
    monkeypatch.setattr(FN, "fused_norm", opaque(FN.fused_norm_plain))
    monkeypatch.setattr(QK, "qkv_proj", opaque(QK.qkv_proj_plain))
    monkeypatch.setattr(FF, "ffn_act", opaque(FF.ffn_act_plain))
    monkeypatch.setattr(AT, "attn_stream", opaque_attn)
    loss, got = grads_of(model, params, batch)
    assert torch.equal(loss, want_loss)
    for path, g in want.items():
        assert torch.equal(got[path], g), path
        assert bool(g.abs().max() > 0), path


def test_int8_ffn_store_refused_by_both_packages():
    """The int8 store's integer leaves take no gradient: the reference's
    `jax.value_and_grad` raises TypeError, and so do the port's
    `Model.loss` (where autograd records) and its train step."""
    rc, _ = train_configs("granite-3-2b")
    pc, model, params = port_model("granite-3-2b", ffn_weight_store="int8")
    assert any(t.dtype == torch.int8 for t in tree_leaves(params))
    batch = train_batch(pc)
    rparams = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(params))
    ref = RefModel(rc.replace(**F32, ffn_weight_store="int8"))
    with pytest.raises(TypeError):
        jax.value_and_grad(ref.loss)(rparams, batch)
    with pytest.raises(TypeError, match="int8"):
        model.loss(params, batch)
    opt = AdamWConfig()
    step = make_train_step(model, opt)
    with pytest.raises(TypeError, match="int8"):
        step(adamw_init(params, opt), batch)
    with torch.no_grad():               # evaluation needs no gradient
        assert torch.isfinite(model.loss(params, batch))


def test_model_init_defaults_to_the_card():
    """`Model.init()` with no device draws on the card, or raises where
    there is none; a generator's device is taken when one is passed."""
    pc, model, _ = port_model("granite-3-2b")
    if torch.cuda.is_available():
        assert tree_leaves(model.init())[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init()
    assert tree_leaves(model.init(torch.Generator()))[0].device.type == "cpu"
