"""PyTorch port: the program's spans and counters (`runtime.trace`).

Off (the default), a span is the one shared no-op object and no
"repro::" range reaches the profiler around an engine step or a train
step; the account stays empty. On, an engine step and a train step open
exactly the documented names (PERF.md, section 3) with the documented
nesting, the kernels' backward opens "grad.<wrapper>" (on the card, on
the autograd engine's own thread: the one `cuda`-marked test), the
engine's phases still reach an attached telemetry hub, and the KV copy
counters equal the arithmetic of the stores' shapes for each site.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import trace
from repro_torch.serving import Engine, LocalBackend, Request, Telemetry
from repro_torch.serving.telemetry import PHASES

SLOTS, MAX_LEN, HOT, CHUNK = 2, 32, 8, 8

# each span name -> the names of the spans it may open inside of (None:
# outermost); serving
SERVE_TREE = {
    "step": {None},
    "plan": {"step"}, "evict": {"step"}, "idle-offload": {"step"},
    "restore": {"step"}, "chunk-prefill": {"step"}, "decode": {"step"},
    "commit": {"chunk-prefill"},
    "backend.extend": {"chunk-prefill"},
    "backend.decode": {"decode"},
    "decode.inputs": {"backend.decode"}, "decode.model": {"backend.decode"},
    "decode.sample": {"backend.decode"}, "decode.select": {"backend.decode"},
    "embed": {"backend.extend", "decode.model"},
    "restack": {"backend.extend", "decode.model"},
    "head": {"backend.extend", "decode.model"},
    "ffn": {"backend.extend", "decode.model"},
    "attn.extend": {"backend.extend"},
    "attn.decode": {"decode.model"},
    "attn.qkv": {"attn.extend", "attn.decode"},
    "attn.kernel": {"attn.extend", "attn.decode"},
    "attn.out": {"attn.extend", "attn.decode"},
    "attn.workspace": {"attn.extend"},
    "attn.commit": {"attn.extend"},
    "attn.append": {"attn.decode"},
    "paged_decode.operands": {"attn.kernel"},
}
# training (the backward's spans open on the autograd engine's thread;
# on a CPU tensor that engine runs the backward on the caller's thread)
WRAPPERS = ("attn_stream", "ffn_act", "fused_norm", "qkv_proj")
TRAIN_TREE = {
    "train.forward": {None}, "train.backward": {None},
    "train.optimizer": {None}, "train.clip": {"train.optimizer"},
    "embed": {"train.forward"}, "head": {"train.forward"},
    "ffn": {"train.forward"},
    **{f"grad.{w}": {"train.backward"} for w in WRAPPERS},
}
COPY_SITES = ("append", "restack", "select", "insert", "workspace")


@pytest.fixture
def spans_on():
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _cfg(**kw):
    return get_config("granite-3-2b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", kv_policy="tiered",
        kv_hot_window=HOT, **kw)


def _model(cfg=None):
    m = Model(cfg or _cfg())
    return m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _engine(telemetry=None):
    m, params = _model()
    be = LocalBackend(m, params, SLOTS, MAX_LEN, n_spill=0, device="cpu")
    eng = Engine(be, chunk_tokens=CHUNK, telemetry=telemetry)
    rng = np.random.default_rng(0)
    for i, n in enumerate((12, 20)):
        eng.submit(Request(rid=i, tokens=rng.integers(
            0, m.cfg.vocab_size, n).astype(np.int32), max_new_tokens=4))
    return eng


def _drain(eng):
    while not eng.idle:
        eng.step()


def _train_step(device="cpu"):
    """One train step of a one-layer model with no recompute (a remat
    setting reruns the block's forward, its spans too, in the
    backward)."""
    m = Model(_cfg(num_layers=1, segments=(), remat="none"))
    params = m.init(torch.Generator(device=device).manual_seed(0),
                    device=device)
    step = make_train_step(m, AdamWConfig(lr=1e-3))
    state = adamw_init(params, AdamWConfig(lr=1e-3))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, m.cfg.vocab_size, (2, 8), generator=g).to(device)
    return lambda: step(state, {"tokens": toks,
                                "labels": torch.roll(toks, -1, 1)})


def _ranges(prof) -> list:
    return [(e.time_range.start, e.time_range.end,
             e.name[len(trace.PREFIX):], e.thread)
            for e in prof.events() if e.name.startswith(trace.PREFIX)]


def _parents(rs: list) -> dict:
    """Each span name -> the names of the innermost spans it opened
    inside of, on its own thread (None: none)."""
    out: dict = {}
    for s, e, n, th in rs:
        around = [r for r in rs if r[3] == th and r[0] <= s and e <= r[1]
                  and (r[0], r[1]) != (s, e)]
        p = max(around, key=lambda r: (r[0], -r[1]))[2] if around else None
        out.setdefault(n, set()).add(p)
    return out


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------
def test_off_span_is_one_shared_no_op():
    assert not trace.enabled()
    a, b = trace.span("x"), trace.span("y")
    assert a is b
    with a:
        trace.count("c", 3)
        trace.count_bytes("d", torch.zeros(4))
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_off_reaches_no_profiler_and_counts_nothing():
    trace.reset()
    eng = _engine()
    train = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drain(eng)
        train()
    assert not _ranges(prof)
    assert trace.snapshot() == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------
def test_engine_step_opens_the_documented_spans(spans_on):
    eng = _engine()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drain(eng)
    parents = _parents(_ranges(prof))
    assert set(parents) == set(SERVE_TREE)
    for name, ps in parents.items():
        assert ps <= SERVE_TREE[name], (name, ps)
    snap = trace.snapshot()
    assert set(snap["spans"]) == set(SERVE_TREE)
    assert snap["spans"]["step"]["calls"] == eng.stats["steps"]
    assert snap["spans"]["decode"]["calls"] == eng.stats["decode_steps"] \
        == snap["counters"]["decode.phases"]
    assert snap["spans"]["backend.extend"]["calls"] \
        == eng.stats["extend_calls"]
    assert all(v["host_s"] > 0 for v in snap["spans"].values())


def test_train_step_opens_the_documented_spans(spans_on):
    train = _train_step()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train()
    rs = _ranges(prof)
    parents = _parents(rs)
    assert set(parents) == set(TRAIN_TREE)
    for name, ps in parents.items():
        assert ps <= TRAIN_TREE[name], (name, ps)
    snap = trace.snapshot()["spans"]
    assert set(snap) == set(TRAIN_TREE)
    assert snap["grad.fused_norm"]["calls"] == 3     # ln1, ln2, final


@pytest.mark.cuda
def test_grad_spans_open_on_the_autograd_thread():
    """On the card the autograd engine runs the backward on its own
    device thread: the "grad.<wrapper>" spans open there, every one of
    them, and the step's other spans on the caller's thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    train = _train_step("cuda")
    train()
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            train()
            torch.cuda.synchronize()
    finally:
        trace.disable()
        trace.reset()
    rs = _ranges(prof)
    main = {r[3] for r in rs if not r[2].startswith("grad.")}
    grads = {r[3] for r in rs if r[2].startswith("grad.")}
    assert len(main) == 1 and grads and not grads & main
    assert {r[2] for r in rs if r[2].startswith("grad.")} \
        == {f"grad.{w}" for w in WRAPPERS}


def test_phases_reach_the_telemetry_hub_once(spans_on):
    tel = Telemetry()
    eng = _engine(telemetry=tel)
    _drain(eng)
    snap = trace.snapshot()["spans"]
    assert set(tel.phase_s) <= set(PHASES)
    # the hub elides an empty evict / restore; every phase is a span
    for ph in ("plan", "chunk-prefill", "commit", "decode"):
        assert ph in tel.phase_s and ph in snap
    assert snap["commit"]["calls"] == 2


def _store_bytes(cfg, batch: int) -> int:
    """One tiered K or V store of ``batch`` slots: int8 cold tier, f32
    scale a position and kv head, the hot ring, int32 endurance counts."""
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    item = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    blocks = -(-MAX_LEN // 128)
    return batch * (MAX_LEN * Hkv * Dh + MAX_LEN * Hkv * 4
                    + HOT * Hkv * Dh * item + blocks * 4)


def test_kv_copy_counters_equal_the_shape_arithmetic(spans_on):
    eng = _engine()
    _drain(eng)
    cfg, L = eng.backend.model.cfg, eng.backend.model.cfg.num_layers
    c = trace.snapshot()["counters"]
    assert set(c) == {"decode.phases"} | {f"kv.copy_bytes.{s}"
                                          for s in COPY_SITES}
    pool = 2 * L * _store_bytes(cfg, SLOTS)
    phases, calls = eng.stats["decode_steps"], eng.stats["extend_calls"]
    commits = len(eng.finished)
    assert c["decode.phases"] == phases > 0
    # a decode step: the append's clones, the layers' restack, the
    # select over every slot: each the whole pool
    for site in ("append", "restack", "select"):
        assert c[f"kv.copy_bytes.{site}"] == phases * pool, site
    # a commit inserts the request's stores into a copy of the pool
    assert c["kv.copy_bytes.insert"] == commits * pool
    # a chunk clones its K and V workspace and restacks it; a committing
    # chunk restacks the one-slot stores built from it instead
    item = torch.empty((), dtype=torch.float32).element_size()
    ws = 2 * L * MAX_LEN * cfg.num_kv_heads * cfg.head_dim * item
    one = 2 * L * _store_bytes(cfg, 1)
    assert c["kv.copy_bytes.workspace"] \
        == calls * ws + (calls - commits) * ws + commits * one


def test_traced_decorator_reads_the_flag_at_call_time(spans_on):
    @trace.traced("deco")
    def f(x):
        return x + 1
    trace.disable()
    assert f(1) == 2 and trace.snapshot()["spans"] == {}
    trace.enable()
    assert f(2) == 3
    assert trace.snapshot()["spans"]["deco"]["calls"] == 1
    assert f.__name__ == "f"


def test_counts_from_threads_are_not_lost(spans_on):
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                trace.count("n")
                with trace.span("s"):
                    pass
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert snap["counters"]["n"] == 16000
    assert snap["spans"]["s"]["calls"] == 16000


def test_reset_zeroes_and_keeps_the_flag(spans_on):
    with trace.span("a"):
        trace.count("b", 2)
    trace.reset()
    assert trace.enabled()
    assert trace.snapshot() == {"spans": {}, "counters": {}}
