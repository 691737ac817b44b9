"""End-to-end VQA serving (the paper's workload) on the PyTorch port, the
port of `examples/serve_vlm.py`, step by step:

1. the single-batch reference path (flat vs CHIME-tiered KV agreement +
   write-once endurance check),
2. the continuous-batching engine serving a MIXED stream of image+text
   requests through a shared multi-request tiered KV pool (VQA requests
   carry visual patches, chat requests are text-only; the scheduler
   admits them FCFS under the DRAM/RRAM byte budgets),
3. chunked prefill on a long-vision-prompt mixed stream: a large VQA
   prompt streams into its pool slot in fixed-size chunks while chat
   requests already running keep emitting tokens between chunks, and
4. prefix sharing on the paged pool: many questions about ONE camera
   frame; later requests adopt the first one's cached block chain by
   reference and prefill only their question tail, token-identical to
   the unshared slot pool.

It runs on the card unless ``--device`` says otherwise; inputs come from
seeded `torch.Generator`s.

    PYTHONPATH=src python examples/serve_vlm_torch.py               # card
    PYTHONPATH=src python examples/serve_vlm_torch.py --device cpu
"""

import argparse
import copy
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import kv_tiers as KT
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import Model
from repro_torch.serving import (Engine, LocalBackend, Request,
                                 aggregate_metrics, make_synthetic_requests,
                                 simulated_efficiency)


def make_cfg(kv_policy: str):
    return get_config("mobilevlm-1.7b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="none",
        kv_policy=kv_policy, kv_hot_window=16)


def _params(model, dev):
    return model.init(torch.Generator(device=dev).manual_seed(0))


def run(kv_policy: str, dev, batch_size: int = 4, prompt: int = 32,
        gen: int = 12):
    cfg = make_cfg(kv_policy)
    model = Model(cfg)
    params = _params(model, dev)
    g = torch.Generator().manual_seed(0)
    tv = cfg.frontend.num_tokens
    batch = {
        "patches": torch.randn((batch_size, tv, cfg.frontend.frontend_dim),
                               generator=g).to(dev),
        "tokens": torch.randint(0, cfg.vocab_size, (batch_size, prompt - tv),
                                generator=g, dtype=torch.int32).to(dev),
    }
    t0 = time.time()
    toks, cache = generate(model, params, batch, prompt, gen, device=dev)
    dt = time.time() - t0
    print(f"[{kv_policy:6s}] {batch_size} requests x {gen} tokens "
          f"in {dt:.2f}s; first answer ids: {toks[0, :8].tolist()}")
    return toks, cache


def serve_mixed_stream(dev, n_requests: int = 8, concurrency: int = 4,
                       prompt: int = 24, gen: int = 10):
    """Continuous batching over a mixed image+text request stream."""
    cfg = make_cfg("tiered")
    model = Model(cfg)
    params = _params(model, dev)
    backend = LocalBackend(model, params, num_slots=concurrency,
                           max_len=prompt + gen + 8, device=dev)
    engine = Engine(backend)
    # every 2nd request is VQA (patches + text tail), the rest pure text,
    # with prompt-length jitter to exercise the admission buckets
    reqs = make_synthetic_requests(cfg, n_requests, prompt, gen, seed=7,
                                   image_every=2, jitter=4)
    streamed = []
    for r in reqs:
        r.on_token = lambda req, tok: streamed.append((req.rid, tok))
    t0 = time.time()
    done = engine.run(reqs)
    wall = time.time() - t0
    m = aggregate_metrics(done, wall)
    n_img = sum(1 for r in done if r.has_image)
    print(f"[engine] {m['requests']} requests ({n_img} VQA, "
          f"{m['requests'] - n_img} text) on {concurrency} slots: "
          f"{m['total_tokens']} tokens in {wall:.2f}s "
          f"({m['tok_per_s']:.1f} tok/s incl. warm-up, "
          f"mean ttft {m.get('mean_ttft_s', 0.0) * 1e3:.0f} ms)")
    rep = engine.endurance_report()
    print(f"[engine] endurance after recycling: max writes/cold-slot="
          f"{rep['max_writes_per_cold_slot']:.2f} "
          f"(write-once {'OK' if rep['write_once_ok'] else 'VIOLATED'})")
    sim = simulated_efficiency(cfg, done)
    print(f"[engine] simulated on {sim['platform']}: "
          f"{sim['sim_tokens_per_j']:.1f} tok/J")
    print(f"[engine] streamed {len(streamed)} token events; first 6: "
          f"{streamed[:6]}")
    return rep


def serve_chunked_long_vqa(dev, chunk_tokens: int = 8, gen: int = 12):
    """Chunked prefill keeping decode slots live: short chat requests are
    already decoding when a LONG VQA prompt (full visual span + text
    tail) arrives; chunked, the big prompt streams into its pool slot a
    few positions per step and the chat requests keep emitting tokens
    between chunks, as the per-step trace below shows."""
    cfg = make_cfg("tiered")
    model = Model(cfg)
    params = _params(model, dev)
    tv = cfg.frontend.num_tokens
    long_prompt = tv + 16                       # visual span + text tail
    backend = LocalBackend(model, params, num_slots=3,
                           max_len=long_prompt + gen, device=dev)
    engine = Engine(backend, chunk_tokens=chunk_tokens)
    g = torch.Generator().manual_seed(5)
    chats = [Request(rid=i, tokens=torch.randint(
        0, cfg.vocab_size, (6,), generator=g, dtype=torch.int32).numpy(),
        max_new_tokens=gen) for i in range(2)]
    vqa = Request(
        rid=9, max_new_tokens=gen,
        tokens=torch.randint(0, cfg.vocab_size, (16,), generator=g,
                             dtype=torch.int32).numpy(),
        patches=torch.randn((tv, cfg.frontend.frontend_dim),
                            generator=g).numpy())
    for r in chats:
        engine.submit(r)
    engine.step()                               # chats admitted + decoding
    engine.submit(vqa)                          # long prompt arrives
    overlap_steps = 0
    while not engine.idle:
        before = engine.stats["prefill_chunks"]
        events = engine.step()
        chunked = engine.stats["prefill_chunks"] > before
        decode_evs = [e for e in events if e[0] != vqa.rid]
        if chunked and decode_evs:
            overlap_steps += 1
        if chunked or decode_evs:
            print(f"[chunked] step {engine.stats['steps']:3d}: "
                  f"prefill@{9 if chunked else '-'} "
                  f"decode events {decode_evs[:4]}")
    print(f"[chunked] {overlap_steps} steps decoded chat tokens WHILE the "
          f"{long_prompt}-position VQA prompt prefilled "
          f"({engine.stats['prefill_chunks']} chunks of <= {chunk_tokens})")
    assert overlap_steps > 0
    assert all(r.n_generated == gen for r in engine.finished)
    return overlap_steps


def serve_shared_prefix(dev, n_requests: int = 6, prompt: int = 24,
                        gen: int = 10, shared: int = 20):
    """Prefix sharing over the paged pool: every request opens with the
    same system prompt + image (the multi-turn VQA shape: one camera
    frame, many questions). The first request pays the cold prefill and
    registers its block chain in the prefix index; every later request
    hashes to the cached chain, adopts the shared blocks by reference
    (refcount, not copy) and prefills only its own question tail:
    answers stay token-identical to the unshared slot-pool engine."""
    cfg = make_cfg("tiered")
    model = Model(cfg)
    params = _params(model, dev)
    reqs = make_synthetic_requests(cfg, n_requests, prompt, gen, seed=11,
                                   image_every=1, shared_prefix=shared)

    def drain(paged):
        backend = LocalBackend(model, params, num_slots=2,
                               max_len=prompt + gen, block_tokens=4,
                               device=dev)
        engine = Engine(backend, paged=paged)
        # submit one request per step-wave so each admission can see the
        # chain its predecessor registered (a single up-front burst would
        # cold-prefill the whole first wave side by side)
        for r in copy.deepcopy(reqs):
            engine.submit(r)
            engine.step()
        while not engine.idle:
            engine.step()
        return engine, {r.rid: list(r.generated) for r in engine.finished}

    slot_eng, slot_toks = drain(False)
    paged_eng, paged_toks = drain(True)
    assert slot_toks == paged_toks, "paged answers diverged from slot pool"
    bp = paged_eng.block_pool
    s = paged_eng.stats
    print(f"[prefix] {n_requests} VQA turns over one shared "
          f"{shared}-token system prompt + image: {s['prefix_hits']} "
          f"prefix hits skipped {s['prefix_hit_tokens']} prompt "
          f"positions, {bp.stats['cow_copies']} CoW copies, max "
          f"refcount {max(1, bp.max_refcount)}, answers identical to "
          f"the unshared slot pool")
    writes = bp.block_writes
    print(f"[prefix] endurance: shared blocks written "
          f"{int(writes.max()) if writes.size else 0}x max despite "
          f"{n_requests}-way reuse (write-once preserved)")
    return s["prefix_hits"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    toks_flat, _ = run("flat", dev)
    toks_tier, cache = run("tiered", dev)
    # tiered decoding should agree with flat decoding on most tokens (the
    # int8 cold tier approximates only tokens older than the hot window)
    agree = float((toks_flat == toks_tier).float().mean())
    print(f"flat-vs-tiered token agreement: {agree:.2%}")
    # endurance discipline: cold slots written once
    writes = None
    for store in cache.values():
        store = store.get("k") if isinstance(store, dict) else None
        if isinstance(store, dict) and "hot" in store:
            rep = KT.endurance_report(store)
            writes = int(rep["max_writes_per_block"])
            print(f"cold-tier writes: {int(rep['total_cold_writes'])}, "
                  f"max per block {writes}")
            break
    rep = serve_mixed_stream(dev)
    overlap = serve_chunked_long_vqa(dev)
    hits = serve_shared_prefix(dev)
    return {"agreement": agree, "max_writes_per_block": writes,
            "write_once_ok": rep["write_once_ok"], "overlap_steps": overlap,
            "prefix_hits": hits}


if __name__ == "__main__":
    main()
