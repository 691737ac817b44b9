"""PyTorch port: the training loop around `Model.loss`, on the CPU.

Against the live JAX reference, on the same numpy inputs: `adamw_update`
over three steps (f32 and bf16 optimizer state), `lr_schedule`,
`clip_by_global_norm`, `make_train_step` over three steps with one and
two microbatches (loss, grad norm, lr, every parameter leaf),
`shrink_mesh_axes`, the blockwise `QTensor` and the gradient codec (bit
for bit), and a checkpoint written by the reference restored by the
port.

The port's own contracts: the synthetic pipeline (deterministic,
seekable, host-sharded, the Markov rule, the VLM and audio layouts; its
torch random stream differs from the reference's threefry by design),
checkpoint round trips (a bf16 leaf included), integrity and shape
errors, keep-N retention, the fault-tolerant loop's retry / restore /
resume (on two gloo ranks too: a fault on one rank is agreed on and
retried by both), and the train CLI on the CPU.

Tolerances (f32): the loss, the grad norm and the lr 1e-5 relative; an
optimizer state after three updates 1e-6 of each leaf's largest
element, and the parameters of a whole train step 1e-4 of it: Adam
divides each gradient element by its own running magnitude, so an
element whose gradient is near 0 carries the frameworks' 1e-6 rounding
differences into a step of up to lr.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.core import quant as RQ
from repro.launch.steps import make_train_step as ref_train_step
from repro.models import Model as RefModel
from repro.optim import adamw as RA
from repro.runtime.fault import shrink_mesh_axes as ref_shrink
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import quant as Q
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.data.pipeline import MARKOV_NOISE
from repro_torch.launch import train as train_cli
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import Model
from repro_torch.optim import (AdamWConfig, PartialUpdateError, TrainState,
                               adamw_init, adamw_update, clip_by_global_norm,
                               lr_schedule)
from repro_torch.runtime.fault import (FaultPolicy, FaultTolerantLoop,
                                       shrink_mesh_axes)
from repro_torch.tree import sorted_leaves, tree_leaves, tree_map
from test_torch_config import F32, _configs
from test_torch_train import FAST_COMPILE

jax.config.update("jax_platform_name", "cpu")

RTOL = 1e-5
STATE_TOL = 1e-6
PARAM_TOL = 1e-4
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20)


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


def _tree(seed: int = 0, scale: float = 1.0) -> dict:
    """A small parameter-like tree, keys out of sorted order."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": (rng.standard_normal((8, 16)) * scale)
                  .astype(np.float32)},
            "a": (rng.standard_normal((5,)) * scale).astype(np.float32),
            "c": {"z": (rng.standard_normal((3, 4, 2)) * scale)
                  .astype(np.float32)}}


def _close_rel(got, want, tol):
    """Every leaf of ``got`` (port) within tol x the largest element of
    the same leaf of ``want`` (reference), matched by path."""
    for g, w in zip(sorted_leaves(got), jax.tree.leaves(want)):
        g = bridge.tensor_to_array(g).astype(np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


def _scalar_close(got, want, rtol=RTOL):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


# ---------------------------------------------------------------------------
# the optimizer against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              state_dtype=state_dtype)
    params = _tree()
    rstate = RA.adamw_init(jax.tree.map(jnp.asarray, params),
                           RA.AdamWConfig(**kw))
    rupdate = jax.jit(RA.adamw_update, static_argnums=2,
                      compiler_options=FAST_COMPILE)
    state = adamw_init(bridge.params_from_jax(params), AdamWConfig(**kw))
    for i, scale in enumerate((0.1, 3.0, 0.5)):   # clipped at step 2
        g = _tree(10 + i, scale)
        rstate, rm = rupdate(rstate, jax.tree.map(jnp.asarray, g),
                             RA.AdamWConfig(**kw))
        state, m = adamw_update(state, bridge.params_from_jax(g),
                                AdamWConfig(**kw))
        _scalar_close(m["grad_norm"], rm["grad_norm"])
        _scalar_close(m["lr"], rm["lr"])
    assert int(state.step) == int(rstate.step) == 3
    assert state.step.dtype == torch.int32
    for f in ("params", "mu", "nu"):
        _close_rel(getattr(state, f), getattr(rstate, f), STATE_TOL)
    want = torch.float32 if state_dtype == "float32" else torch.bfloat16
    assert all(t.dtype == want for t in sorted_leaves(state.mu))


def test_lr_schedule_and_clip_match_reference():
    cfg = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    rcfg = RA.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=40)
    rsched = jax.jit(RA.lr_schedule, static_argnums=0,
                     compiler_options=FAST_COMPILE)
    for s in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        _scalar_close(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)),
                      rsched(rcfg, jnp.int32(s)))
    rclip = jax.jit(RA.clip_by_global_norm, static_argnums=1,
                    compiler_options=FAST_COMPILE)
    for max_norm in (0.5, 1e3):                     # clipped, untouched
        g = _tree(3)
        got, gn = clip_by_global_norm(bridge.params_from_jax(g), max_norm)
        want, rgn = rclip(jax.tree.map(jnp.asarray, g), max_norm)
        _scalar_close(gn, rgn)
        _close_rel(got, want, STATE_TOL)


@functools.lru_cache(maxsize=None)
def _granite():
    """(reference cfg, port cfg, the port's seed-0 weights as numpy)."""
    rc, pc = _configs("granite-3-2b")
    rc, pc = rc.replace(**F32), pc.replace(**F32)
    params = Model(pc).init(torch.Generator().manual_seed(0))
    return rc, pc, bridge.tree_to_numpy(params)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    rc, pc, weights = _granite()
    rstep = jax.jit(ref_train_step(RefModel(rc), RA.AdamWConfig(**OPT),
                                   microbatches),
                    compiler_options=FAST_COMPILE)
    rstate = RA.adamw_init(jax.tree.map(jnp.asarray, weights),
                           RA.AdamWConfig(**OPT))
    model = Model(pc)
    state = adamw_init(bridge.params_from_jax(weights), AdamWConfig(**OPT))
    step = make_train_step(model, AdamWConfig(**OPT), microbatches)
    pipe = SyntheticPipeline(pc, DataConfig(4, 32))
    for t in range(3):
        batch = {k: v.numpy() for k, v in pipe.host_slice(t).items()}
        rstate, rm = rstep(rstate, batch)
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            _scalar_close(m[k], rm[k])
    assert int(state.step) == 3
    _close_rel(state.params, rstate.params, PARAM_TOL)


# ---------------------------------------------------------------------------
# codecs: bit for bit
# ---------------------------------------------------------------------------
# The reference compiled as its eager calls run it: XLA's algebraic
# simplifier would multiply by a reciprocal where the code divides (one
# ulp apart); without that pass the compiled function equals the eager
# one bit for bit, at one compile a case instead of one an operation.
AS_WRITTEN = dict(FAST_COMPILE, xla_disable_hlo_passes="algsimp")


@pytest.mark.parametrize("shape,block,bits", [((4, 512), 256, 8),
                                              ((3, 5, 96), 256, 8),
                                              ((6, 256), 64, 4)])
def test_qtensor_bit_exact(shape, block, bits):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[0] = 0.0                                       # an all-zero block

    def ref(x):
        q = RQ.quantize(x, bits=bits, block=block)
        return q, RQ.dequantize(q, jnp.float32), RQ.dequantize(q, jnp.bfloat16)
    want, *wdeq = jax.jit(ref, compiler_options=AS_WRITTEN)(jnp.asarray(x))
    got = Q.quantize(torch.from_numpy(x), bits=bits, block=block)
    assert got.bits == want.bits
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    for dt, w in zip((torch.float32, torch.bfloat16), wdeq):
        np.testing.assert_array_equal(
            bridge.tensor_to_array(Q.dequantize(got, dt)), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_codec_bit_exact(dtype):
    g = (np.random.default_rng(2).standard_normal((7, 33)) * 1e-3
         ).astype(np.float32)
    gj = jnp.asarray(g).astype(dtype)
    gt = bridge.array_to_tensor(np.asarray(gj))

    def ref(g, shared):
        out = []
        for scale in (None, shared):                 # own / shared grid
            rq, rs = RQ.compress_grad(g, scale)
            out.append((rq, rs, RQ.decompress_grad(rq, rs)))
        return out, RQ.grad_scale(jnp.zeros(4))
    want, zero_scale = jax.jit(ref, compiler_options=AS_WRITTEN)(
        gj, jnp.asarray(2e-5, gj.dtype))
    for scale, (rq, rs, rdec) in zip((None, 2e-5), want):
        q, s = Q.compress_grad(gt, None if scale is None
                               else torch.tensor(scale, dtype=gt.dtype))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(bridge.tensor_to_array(s),
                                      np.asarray(rs))
        np.testing.assert_array_equal(Q.decompress_grad(q, s).numpy(),
                                      np.asarray(rdec))
    assert float(Q.grad_scale(torch.zeros(4))) == 1.0 == float(zero_scale)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
def test_pipeline_deterministic_seekable_host_sharded():
    _, pc = _configs("granite-3-2b")
    pipe = SyntheticPipeline(pc, DataConfig(8, 32, seed=3))
    b5 = pipe.host_slice(5)
    again = SyntheticPipeline(pc, DataConfig(8, 32, seed=3))
    assert all(torch.equal(b5[k], again.host_slice(5)[k]) for k in b5)
    it = iter(again)
    for _ in range(5):
        next(it)
    assert torch.equal(next(it)["tokens"], b5["tokens"])      # seekable
    assert not torch.equal(pipe.host_slice(6)["tokens"], b5["tokens"])
    other = SyntheticPipeline(pc, DataConfig(8, 32, seed=4)).host_slice(5)
    assert not torch.equal(other["tokens"], b5["tokens"])
    hosts = [SyntheticPipeline(pc, DataConfig(8, 32, seed=3), h, 2)
             for h in range(2)]
    h0, h1 = (h.host_slice(5) for h in hosts)
    assert h0["tokens"].shape == (4, 32) and not torch.equal(h0["tokens"],
                                                             h1["tokens"])
    with pytest.raises(ValueError):
        SyntheticPipeline(pc, DataConfig(6, 32), 0, 4)
    # text layout and the Markov rule
    toks, labels, mask = b5["tokens"].long(), b5["labels"], b5["loss_mask"]
    assert b5["tokens"].dtype == labels.dtype == torch.int32
    assert int(toks.max()) < pc.vocab_size and int(toks.min()) >= 0
    n = (toks[:, 1:] - toks[:, :-1] * 31 - 7) % pc.vocab_size
    assert int(n.min()) >= 0 and int(n.max()) < MARKOV_NOISE
    assert torch.equal(labels[:, :-1], b5["tokens"][:, 1:])
    assert torch.equal(mask[:, -1], torch.zeros(8))
    assert float(mask[:, :-1].min()) == 1.0


def test_pipeline_vlm_and_audio_layouts():
    _, vlm = _configs("fastvlm-1.7b")
    b = SyntheticPipeline(vlm, DataConfig(2, 24)).host_slice(0)
    tv = vlm.frontend.num_tokens
    assert b["patches"].shape == (2, tv, vlm.frontend.frontend_dim)
    assert b["tokens"].shape == (2, 24 - tv)
    assert torch.equal(b["labels"][:, :tv], torch.zeros((2, tv),
                                                       dtype=torch.int32))
    assert torch.equal(b["labels"][:, tv:],
                       torch.roll(b["tokens"], -1, dims=1))
    assert torch.equal(b["loss_mask"], torch.cat(
        [torch.zeros((2, tv)), torch.ones((2, 24 - tv))], 1))
    _, audio = _configs("hubert-xlarge")
    a = SyntheticPipeline(audio, DataConfig(2, 24)).host_slice(0)
    assert set(a) == {"frames", "labels"}
    assert a["frames"].shape == (2, 24, audio.frontend.frontend_dim)
    assert a["labels"].shape == (2, 24) and int(a["labels"].max()) < \
        audio.vocab_size


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state(seed: int = 0, state_dtype: str = "float32") -> TrainState:
    st = adamw_init(bridge.params_from_jax(_tree(seed)),
                    AdamWConfig(state_dtype=state_dtype))
    st, _ = adamw_update(st, bridge.params_from_jax(_tree(seed + 1)),
                         AdamWConfig(state_dtype=state_dtype))
    return st


def _equal_states(a: TrainState, b: TrainState) -> bool:
    la, lb = sorted_leaves(a), sorted_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip_with_bf16(tmp_path):
    st = _state(state_dtype="bfloat16")
    ck = CheckpointManager(tmp_path / "ck", keep=2)
    path = ck.save(st, 7)
    assert path.name == "step_0000000007" and ck.latest_step() == 7
    import json
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]].count("bfloat16") == 6
    assert all(len(m["sha"]) == 16 for m in manifest["leaves"])
    back, step = ck.restore(_state(5, "bfloat16"))
    assert step == 7 and _equal_states(back, st)
    assert list(back.params) == list(st.params)        # key order kept


def test_checkpoint_integrity_shape_and_retention(tmp_path):
    st = _state()
    ck = CheckpointManager(tmp_path / "ck", keep=2)
    for s in range(5):
        ck.save(st, s)
    assert ck.all_steps() == [3, 4]
    assert not list((tmp_path / "ck").glob(".tmp_*"))
    leaf = tmp_path / "ck" / "step_0000000004" / "leaf_00001.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        ck.restore(st)
    bigger = dataclasses.replace(st, params=dict(st.params,
                                                 a=torch.zeros(6)))
    with pytest.raises(ValueError):
        ck.restore(bigger, 3)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(st)


def test_reference_checkpoint_restores_in_port(tmp_path):
    """An f32 `TrainState` saved by the reference's manager restores leaf
    for leaf into the port's structure (the same flattening order)."""
    params = _tree()
    rstate = RA.adamw_init(jax.tree.map(jnp.asarray, params),
                           RA.AdamWConfig())
    rstate, _ = jax.jit(RA.adamw_update, static_argnums=2,
                        compiler_options=FAST_COMPILE)(
        rstate, jax.tree.map(jnp.asarray, _tree(1)), RA.AdamWConfig())
    RefCheckpointManager(tmp_path / "ck").save(rstate, 11)
    like = adamw_init(bridge.params_from_jax(_tree(9)), AdamWConfig())
    got, step = CheckpointManager(tmp_path / "ck").restore(like)
    assert step == 11 and int(got.step) == 1
    want = bridge.state_from_numpy(
        {f: jax.tree.map(np.asarray, getattr(rstate, f))
         for f in ("params", "mu", "nu", "step")})
    assert _equal_states(got, want)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------
def _tiny_run():
    """A two-layer granite step, its fresh state and batches."""
    _, pc, weights = _granite()
    model = Model(pc)
    opt = AdamWConfig(**OPT)
    pipe = SyntheticPipeline(pc, DataConfig(2, 16))

    def fresh():
        return adamw_init(bridge.params_from_jax(weights), opt)
    return make_train_step(model, opt), fresh, pipe.host_slice


def test_fault_loop_recovers_and_resumes_exactly(tmp_path):
    step_fn, fresh, batches = _tiny_run()
    want, _ = FaultTolerantLoop(
        step_fn, CheckpointManager(tmp_path / "a")).run(fresh(), batches,
                                                        0, 4)
    # a transient failure (retried) at step 1 and a persistent one at
    # step 3 (past the retries: restore step 1's checkpoint, redo 2-3)
    fails, seen = {1: 1, 3: 2}, []

    def flaky(state, batch):
        s = int(state.step)
        seen.append(s)
        if fails.get(s, 0) > seen.count(s) - 1:
            raise RuntimeError("injected step failure")
        return step_fn(state, batch)
    ck = CheckpointManager(tmp_path / "b", keep=3)
    loop = FaultTolerantLoop(flaky, ck, FaultPolicy(checkpoint_every=2,
                                                    max_retries_per_step=1))
    got, end = loop.run(fresh(), batches, 0, 4)
    assert end == 4 and _equal_states(got, want)
    assert [(r.step, r.retries) for r in loop.reports] == [
        (0, 0), (1, 1), (2, 0), (2, 0), (3, 0)]
    # a restart: 3 steps, then a new process resumes from the checkpoint
    ck_c = CheckpointManager(tmp_path / "c")
    FaultTolerantLoop(step_fn, ck_c).run(fresh(), batches, 0, 3)
    loop_c = FaultTolerantLoop(step_fn, ck_c)
    state, start = loop_c.resume_or_init(fresh())
    assert start == 3
    got, _ = loop_c.run(state, batches, start, 1)
    assert _equal_states(got, want)


def _bad_second_leaf(grads):
    """``grads`` with its second leaf (in `adamw_update`'s order) of a
    shape no parameter broadcasts to: the first leaf's update is written,
    the second's raises."""
    n = iter(range(len(tree_leaves(grads))))
    return tree_map(lambda g: torch.zeros(g.numel() + 1) if next(n) == 1
                    else g, grads)


def test_adamw_failure_mid_update_is_partial():
    st = _state()
    before = [t.clone() for t in tree_leaves(st.params)]
    with pytest.raises(PartialUpdateError):
        adamw_update(st, _bad_second_leaf(bridge.params_from_jax(_tree(4))),
                     AdamWConfig())
    after = tree_leaves(st.params)
    assert not torch.equal(after[0], before[0])          # written
    assert all(torch.equal(x, y) for x, y in zip(after[1:], before[1:]))
    assert int(st.step) == 1                             # not advanced


def test_fault_loop_restores_after_partial_update(tmp_path, monkeypatch):
    """A failure inside `adamw_update` (after the first leaf is written)
    is not retried on the half-written state: the loop restores the last
    checkpoint at once, and the run ends equal to an uninterrupted one;
    with no checkpoint to restore, the error propagates."""
    step_fn, fresh, batches = _tiny_run()
    want, _ = FaultTolerantLoop(
        step_fn, CheckpointManager(tmp_path / "a")).run(fresh(), batches,
                                                        0, 4)
    real, planted = steps_mod.adamw_update, []

    def update(state, grads, cfg):
        if int(state.step) in (0, 3) and int(state.step) not in planted:
            planted.append(int(state.step))
            grads = _bad_second_leaf(grads)
        return real(state, grads, cfg)
    monkeypatch.setattr(steps_mod, "adamw_update", update)
    with pytest.raises(PartialUpdateError):
        FaultTolerantLoop(step_fn, CheckpointManager(tmp_path / "b")).run(
            fresh(), batches, 0, 4)
    loop = FaultTolerantLoop(step_fn, CheckpointManager(tmp_path / "c"),
                             FaultPolicy(checkpoint_every=2))
    got, end = loop.run(fresh(), batches, 0, 4)
    assert planted == [0, 3]
    assert end == 4 and _equal_states(got, want)
    assert [(r.step, r.retries) for r in loop.reports] == [
        (0, 0), (1, 0), (2, 0), (2, 0), (3, 0)]


def test_fault_loop_on_two_ranks_retries_together(tmp_path):
    """Two gloo ranks of a (1, 2) mesh run reduced granite through
    `FaultTolerantLoop` for 3 steps, with step 1's batch fetch raising
    once on rank 1 only. Both ranks agree on the failure and retry step
    1 together (each reports one retry), issue the same agreements (two
    a fetched attempt, one after the failed fetch: 7), and end
    `torch.equal` to an unfaulted run. The ranks' group times out after
    60 s and the join after 150 s, so a loop that stalls fails."""
    import time

    from torch_sharded_worker import spawn

    t0 = time.monotonic()
    res = spawn("fault", {"arch": "granite-3-2b", "steps": 3, "rank": 1,
                          "step": 1, "dir": str(tmp_path / "ck")},
                (1, 2), tmp_path, timeout=150.0, pg_timeout=60.0)
    assert time.monotonic() - t0 < 150.0
    for r in res:
        assert r["clean"]["reports"] == [(0, 0), (1, 0), (2, 0)]
        assert r["faulted"]["reports"] == [(0, 0), (1, 1), (2, 0)]
        assert r["faulted"]["end"] == r["clean"]["end"] == 3
        assert r["faulted"]["agreements"] == {"all-reduce": 7}
        assert r["clean"]["agreements"] == {"all-reduce": 6}
        got, want = r["faulted"]["state"], r["clean"]["state"]
        assert got["step"] == want["step"] == 3
        for f in ("params", "mu", "nu"):
            a, b = got[f], want[f]
            pairs = list(zip(sorted_leaves(a), sorted_leaves(b)))
            assert pairs and all(np.array_equal(x, y) for x, y in pairs), f


def test_prefill_and_serve_steps_call_the_model():
    """`make_prefill_step` / `make_serve_step` are `Model.prefill` and
    `Model.decode_step` with the step's arguments."""
    _, pc, weights = _granite()
    model, params = Model(pc), bridge.params_from_jax(weights)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, pc.vocab_size, (2, 8)).astype(np.int32))
    with torch.no_grad():
        logits, cache = make_prefill_step(model, 16)(params,
                                                     {"tokens": tokens})
        want, want_cache = model.prefill(params, {"tokens": tokens}, 16)
        assert torch.equal(logits, want)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        got = make_serve_step(model)(params, nxt, cache, 8)
        ref = model.decode_step(params, nxt, want_cache, 8)
    assert torch.equal(got[0], ref[0])
    assert got[0].shape == (2, 1, pc.vocab_size)
    for x, y in zip(tree_leaves(got[1]), tree_leaves(ref[1])):
        assert torch.equal(x, y)


def test_shrink_mesh_axes_matches_reference():
    for alive in (0, 1, 2, 3):
        assert shrink_mesh_axes(alive) == ref_shrink(alive)
    assert shrink_mesh_axes(3, (4, 8, 2)) == ref_shrink(3, (4, 8, 2))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------
def test_train_cli_reduces_loss_and_resumes(tmp_path, capsys):
    args = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--steps", "20", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "ck")]
    losses = train_cli.main(args)
    assert len(losses) == 20 and losses[-1] < 0.8 * losses[0], losses
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "tok/s" in out
    more = train_cli.main(args[:5] + ["--steps", "2"] + args[7:])
    assert len(more) == 2
    assert "resumed from checkpoint at step 20" in capsys.readouterr().out


def test_train_cli_production_mesh_raises():
    """--production-mesh builds the (data 16, model 16) mesh: 256 ranks,
    which a one-process world cannot hold (torchrun with 256 ranks
    can); the mesh module's ValueError names both sizes."""
    with pytest.raises(ValueError, match="has 256 devices, the world size "
                                         "is 1"):
        train_cli.main(["--reduced", "--device", "cpu", "--production-mesh"])
