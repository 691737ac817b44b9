"""The serving cells: a closed loop of clients over the port's `Engine`.

Set-up (``setup_s``, from process start): the kernels built or loaded,
the weights drawn on the card, the engine made, every prefill shape the
traffic can ask for warmed by a handful of warm-up requests, the pool of
requests drawn, and the loop filled: every client sends, and
``fill_steps`` steps run with the clients sending as their answers end.

The window: `Engine.step()` in a loop for ``seconds``; a client whose
request ends at a step's return sends its next one at that moment. A
request's time to first token runs from its sending to the return of the
step that delivered its first token, on this module's clock. The window
closes at the first step return past ``seconds``: the rate counts every
token delivered by then over the whole window. After it the clients stop
sending and the engine runs on until every request sent in the window has
its first token (at most a minute: one that never comes has failed).

With ``--trace 1`` a profiled window of ``profile_steps`` further steps
(the clients still sending) follows the measured window, and the per-
layer metrics read both.

Then ``correct``: a sample of the requests the window finished, drawn
from the seed with the longest among them, is run through the plain
reference once the program's state is freed (`check.served_gap`).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from chipbench import check, generate, profiling, program, weights, work
from chipbench.reference import decoder

CLOCK = time.perf_counter
DRAIN_S = 60.0
WARM_RID = 1 << 40


class Phases:
    """Set-up's phases on the host clock, from process start (stderr)."""

    def __init__(self, t_start: float, sync):
        self.last, self.sync, self.seconds = t_start, sync, {}

    def mark(self, name: str) -> None:
        self.sync()
        now = CLOCK()
        self.seconds[name] = now - self.last
        self.last = now
        print(f"[chipbench] set-up: {name} {self.seconds[name]:.2f} s",
              file=sys.stderr)


class Loop:
    """The closed loop's clients and their requests' records."""

    def __init__(self, eng, specs: list[dict]):
        self.eng = eng
        self.specs = specs
        self.sent = 0
        self.sending = True
        self.recs: dict[int, dict] = {}

    def send(self, now: float) -> None:
        rid = self.sent
        spec = self.specs[rid % len(self.specs)]
        self.sent += 1
        self.recs[rid] = {"spec": spec, "sent": now, "first": None,
                          "done": None, "slot": None, "req": self.eng.submit(
                              program.request(rid, spec))}

    def step(self) -> dict:
        st = self.eng.stats
        p0 = st["prefill_chunks"]
        t0 = CLOCK()
        events = self.eng.step()
        t1 = CLOCK()
        n = 0
        for rid, _, done in events:
            r = self.recs.get(rid)
            if r is None:
                continue
            n += 1
            if r["first"] is None:
                r["first"] = t1
            if r["slot"] is None and r["req"].slot >= 0:
                r["slot"] = r["req"].slot
            if done:
                r["done"] = t1
                if self.sending:
                    self.send(t1)
        return {"t0": t0, "t1": t1, "tokens": n,
                "prefill": st["prefill_chunks"] > p0}


def warm_lengths(spec: dict, chunk: int | None) -> list[int]:
    """Text lengths whose prefills take every chunk shape the traffic
    can: whole prompts pad to powers of two, so one length per power of
    two in range and the ends; chunked prompts run chunks of one width,
    so the shortest and the longest."""
    lo, hi = spec["min"], spec["max"]
    if chunk:
        return sorted({lo, hi})
    out = {lo, hi}
    p = 1
    while p < hi:
        if p > lo:
            out.add(p)
        p *= 2
    return sorted(out)


def warm(eng, traffic: dict, setup: dict, vocab: int, image) -> None:
    """Warm-up requests (two tokens each) over every prefill shape."""
    rng = np.random.default_rng(0)
    rid = WARM_RID
    for n in warm_lengths(traffic["prompt_tokens"], setup.get("chunk_tokens")):
        patches = (None if not traffic.get("image_every") or image is None
                   else np.zeros(image, np.float32))
        eng.submit(program.request(rid, {
            "tokens": rng.integers(0, vocab, n).astype(np.int32),
            "patches": patches, "answer": 2}))
        rid += 1
    while not eng.idle:
        eng.step()


def book(eng, ledger: list) -> None:
    """Record every extend and decode call's shape (for the window's
    FLOP count), by instance attributes over the backend's methods."""
    be = eng.backend
    ext, dec = be.extend_step, be.decode_step

    def extend_step(batch, state, ext_state, slot, pos, length, commit):
        ledger.append(("extend", int(length), int(pos), "patches" in batch,
                       bool(commit)))
        return ext(batch, state, ext_state, slot, pos, length, commit)

    def decode_step(toks, state, pos, active):
        a = np.asarray(active)
        ledger.append(("decode", [int(p) + 1 for p in np.asarray(pos)[a]]))
        return dec(toks, state, pos, active)
    be.extend_step, be.decode_step = extend_step, decode_step


def ledger_flops(d: work.Dims, entries) -> int:
    total = 0
    for e in entries:
        if e[0] == "extend":
            total += work.chunk_flops(d, e[1], e[2], e[3], e[4])
        else:
            total += work.decode_flops(d, e[1])
    return total


def spans(eng, d: work.Dims, W: int | None, dtype: str, pk: dict
          ) -> profiling.Spans:
    """The serving ranges: each extend and decode call, and inside them
    the attention blocks (`apply_attention_extend` / `_decode`) and the
    FFN (`apply_ffn`, named by the phase it runs in), each with its work."""
    ab = 2 if dtype == "bfloat16" else 4
    ctx: dict = {}
    be = eng.backend
    sp = profiling.Spans()

    def extend_name(batch, state, ext, slot, pos, length, commit):
        ctx.update(phase="extend", rows=int(length), pos=int(pos),
                   commit=bool(commit))
        return "extend"

    def decode_name(toks, state, pos, active):
        a = np.asarray(active)
        lens = [int(p) + 1 for p in np.asarray(pos)[a]]
        ctx.update(phase="decode", rows=len(lens), lengths=lens)
        return "decode"

    def bound(fb):
        return work.bound_s(fb[0], fb[1], pk, dtype)
    sp.add(be, "extend_step", extend_name)
    sp.add(be, "decode_step", decode_name)
    fusion = program.fusion()
    Wk = W or 0
    sp.add(fusion, "apply_attention_extend", "attn_extend",
           lambda *a, **k: bound(work.attn_extend_work(
               d, ctx["rows"], ctx["pos"], ctx["commit"], Wk, ab)))
    sp.add(fusion, "apply_attention_decode", "attn_decode",
           lambda *a, **k: bound(work.attn_decode_work(
               d, ctx["lengths"], Wk, ab)))
    sp.add(fusion, "apply_ffn", lambda *a, **k: "ffn." + ctx["phase"],
           lambda *a, **k: bound((work.ffn_flops(d, ctx["rows"]),
                                  work.ffn_bytes(d, ctx["rows"], ab))))
    return sp


def sample(loop: Loop, lo: float, hi: float, seed: int, tokens: int
           ) -> list[dict]:
    """Requests finished in [lo, hi]: the longest, then one from each
    other slot that served one, then others, each in an order drawn from
    the seed, until ``tokens`` served tokens (every slot's one counts)."""
    done = [r for r in loop.recs.values()
            if r["done"] is not None and lo <= r["done"] <= hi]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r["req"].generated), r["req"].rid))
    order = np.random.default_rng(generate._mix(seed, 4)).permutation(
        len(done) - 1)
    drawn = [done[0]] + [done[1 + i] for i in order]
    slots, first, later = set(), [], []
    for r in drawn:
        (later if r["slot"] in slots else first).append(r)
        slots.add(r["slot"])
    out, n = first, sum(len(r["req"].generated) for r in first)
    for r in later:
        if n >= tokens:
            break
        out.append(r)
        n += len(r["req"].generated)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, arith: str | None = None) -> dict:
    """One run of a serving cell; returns the record the metrics read,
    the numbers compared and the run's counts. ``arith`` (the control)
    also reads the control's gap, computed in that precision."""
    import torch
    setup, traffic, config = cell.setup, cell.traffic, cell.config
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    d = work.dims(config)
    phases = Phases(t_start, sync)
    built = program.build_kernels() if cuda else []
    phases.mark("kernels")
    cfg = program.port_config(config, setup)
    mdl = program.model(cfg)
    params = weights.make(mdl, d.V, seed, device)
    phases.mark("weights")
    eng = program.engine(mdl, params, setup, device)
    del params
    phases.mark("engine")
    image = ((config["image_tokens"], config["mm_hidden_size"])
             if "mm_hidden_size" in config else None)
    warm(eng, traffic, setup, d.V, image)
    phases.mark("warm-up")
    specs = generate.serve_requests(traffic, d.V, image, seed)
    phases.mark("requests")
    loop = Loop(eng, specs)
    ledger: list = []
    if trace:
        book(eng, ledger)
    t = CLOCK()
    for _ in range(traffic["clients"]):
        loop.send(t)
    for _ in range(setup["fill_steps"]):
        loop.step()
    phases.mark("fill")
    open_t = CLOCK()
    setup_s = open_t - t_start
    n_ledger = len(ledger)
    steps = []
    while True:
        steps.append(loop.step())
        if steps[-1]["t1"] - open_t >= seconds:
            break
    close_t = steps[-1]["t1"]
    window_flops = ledger_flops(d, ledger[n_ledger:])
    pk = work.peaks(torch.cuda.get_device_name() if cuda else "")
    prof = None
    if trace and cuda:
        sp = spans(eng, d, setup.get("kv_hot_window"), setup["dtype"], pk)

        def run_steps():
            s0 = dict(eng.stats)
            for _ in range(setup["profile_steps"]):
                with torch.profiler.record_function(profiling.PREFIX + "step"):
                    loop.step()
            return {"steps": setup["profile_steps"],
                    "decode_steps": eng.stats["decode_steps"]
                    - s0["decode_steps"],
                    "prefill_chunks": eng.stats["prefill_chunks"]
                    - s0["prefill_chunks"]}
        prof = profiling.window(run_steps, sp, program.launch_counts)
    loop.sending = False
    in_window = [r for r in loop.recs.values()
                 if open_t <= r["sent"] <= close_t]
    t_drain = CLOCK()
    while any(r["first"] is None for r in in_window) \
            and CLOCK() - t_drain < DRAIN_S:
        loop.step()
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    chosen = sample(loop, open_t, close_t, seed, setup["sample_tokens"])
    seqs = [{"tokens": r["spec"]["tokens"], "patches": r["spec"]["patches"],
             "served": list(r["req"].generated)} for r in chosen]
    rec = {"kind": "serve", "setup_s": setup_s, "window_s": close_t - open_t,
           "built": built, "setup_phases": phases.seconds,
           "tokens_in_window": sum(s["tokens"] for s in steps),
           "steps": [{k: s[k] for k in ("t0", "t1", "prefill")}
                     for s in steps],
           "requests": [{"sent": r["sent"], "first": r["first"],
                         "done": r["done"]} for r in in_window],
           "work_flops": window_flops, "peak_flops": pk[setup["dtype"]],
           "profile": prof}
    failed = sum(r["first"] is None for r in in_window)
    # the program's state is freed before the reference runs
    del loop, eng, in_window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = CLOCK()
    hot = setup.get("kv_hot_window") if setup.get("kv_policy") == "tiered" \
        else None
    ref_params = weights.make(mdl, d.V, seed, device)
    ref = decoder.served_logits(ref_params, config, seqs, hot)
    numbers = check.served_gap(ref, [s["served"] for s in seqs])
    numbers["unanswered"] = failed
    if arith:
        ctl = decoder.served_logits(ref_params, config, seqs, hot, arith)
        numbers["control_gap_std"] = check.control_gap(ref, ctl)["gap_std"]
        del ctl
    del ref, ref_params
    sync()
    print(f"[chipbench] reference over {len(seqs)} requests, "
          f"{numbers['tokens']} served tokens: {CLOCK() - t_ref:.1f} s",
          file=sys.stderr)
    return {"rec": rec, "numbers": numbers, "attempted": len(rec["requests"]),
            "failed": failed, "memory_peak_bytes": peak}
