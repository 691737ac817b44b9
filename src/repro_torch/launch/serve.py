"""Serving CLI of the port: a thin front-end over the continuous-batching
engine, on the card unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch fastvlm-1.7b \
        --requests 8 --concurrency 4 --prompt-len 256 --gen 64 \
        --kv-policy tiered --hot-window 128 --max-len 512 --image-every 2

    # preemption under priority traffic, int8 spill lanes, telemetry
    PYTHONPATH=src python -m repro_torch.launch.serve --arch fastvlm-1.7b \
        --reduced --device cpu --requests 6 --priority-every 2 \
        --spill-compress --chunk-tokens 8 --trace-out trace.json \
        --metrics-out metrics.prom

    # many questions about one frame: a shared image + system prompt in
    # the paged prefix pool, weights streamed from the (simulated) RRAM
    PYTHONPATH=src python -m repro_torch.launch.serve --arch fastvlm-1.7b \
        --reduced --device cpu --requests 6 --image-every 1 \
        --shared-prefix 8 --prefix-cache --weight-stream 1

    # the sharded executor on a 1 x 1 mesh (NCCL, world size 1), and over
    # N ranks under torchrun (one card a rank; --mesh DxM with D * M = N)
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sharded \
        --mesh 1x1
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --backend sharded --mesh 1x4

Weights are random, drawn from ``--seed`` at the config's published
widths (``--reduced`` for the tiny test twins); under ``--backend
sharded`` every rank draws the same full tree and keeps its shards, and
only rank 0 prints. `generate` below is the
single-request oracle (prefill + greedy decode steps); the engine's
batched decode is held to it token for token.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.tree import tree_leaves


@torch.no_grad()
def generate(model: Model, params: dict, batch: dict, prompt_len: int,
             gen_len: int, *, device=None, return_logits: bool = False):
    """Prefill then greedy decode; returns (tokens (B, gen_len), cache),
    plus the per-step last-row logits (B, gen_len, V) with
    ``return_logits``. ``params`` must live on ``device`` (default
    "cuda")."""
    dev = resolve_device(device)
    pdev = tree_leaves(params)[0].device
    if pdev != dev and not (pdev.type == dev.type == "cuda"
                            and dev.index is None):
        raise ValueError(f"params live on {pdev}, not on {dev}")
    max_len = prompt_len + gen_len
    logits, cache = model.prefill(params, batch, max_len)
    tok = logits[:, -1].argmax(-1)[:, None]
    toks, steps = [tok], [logits[:, -1]]
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, tok, cache, prompt_len + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        toks.append(tok)
        steps.append(logits[:, -1])
    out = torch.cat(toks, dim=1)
    if return_logits:
        return out, cache, torch.stack(steps, dim=1)
    return out, cache


def main(argv=None):
    from repro_torch.serving import (Engine, Telemetry, aggregate_metrics,
                                     make_backend, make_synthetic_requests,
                                     simulated_efficiency)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fastvlm-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=4,
                    help="decode slots (continuous-batching width)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-policy", default="tiered",
                    choices=["flat", "tiered"])
    ap.add_argument("--hot-window", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="KV pool length per slot (0 = prompt+gen)")
    ap.add_argument("--image-every", type=int, default=0,
                    help="every k-th request is a VQA request (0 = none)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="every request opens with the same N-token "
                         "system prompt (VQA requests also share one "
                         "image) — the stream shape --prefix-cache "
                         "exists for (0 = fully distinct prompts)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    ap.add_argument("--backend", default="local",
                    choices=["local", "sharded"],
                    help="executor: one device, or the sharded backend "
                         "over --mesh (NCCL on cuda, gloo on cpu)")
    ap.add_argument("--mesh", default="local",
                    help="mesh of the sharded backend: local | production "
                         "| multipod | DxM (D * M ranks; under torchrun "
                         "the launched group)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="param and compute dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and request stream")
    ap.add_argument("--fused-decode", action="store_true", default=None,
                    help="fused paged-decode attention over the flat store "
                         "too (the tiered store always runs its kernel; "
                         "default: consult REPRO_SERVE_FUSED_DECODE)")
    ap.add_argument("--sparse-read", type=float, default=None,
                    metavar="TAU",
                    help="SLIM-style adaptive-threshold sparse read "
                         "inside the fused tiered kernel: skip cold pages "
                         "whose score upper bound is < running-max + "
                         "log(TAU) (0 = exact; needs --fused-decode; "
                         "default: consult REPRO_SERVE_SPARSE_READ)")
    ap.add_argument("--weight-stream", type=int, default=None,
                    metavar="W",
                    help="RRAM weight streaming (simulated): charge a "
                         "W-repeat DRAM window per scanned unit and price "
                         "the other per-layer slices as RRAM reads (0 = "
                         "off even under REPRO_SERVE_WEIGHT_STREAM; "
                         "default: consult the env knob)")
    ap.add_argument("--paged", action="store_true", default=None,
                    help="charge the admission gate per live KV block "
                         "instead of per worst-case slot (default: "
                         "consult REPRO_SERVE_PAGED; implies "
                         "--prefix-cache)")
    ap.add_argument("--prefix-cache", action="store_true", default=None,
                    help="hash-indexed prefix reuse over the paged pool: "
                         "admissions whose prompt head matches a cached "
                         "block chain skip prefill for the hit blocks "
                         "(default: on whenever paged)")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill: cap a prefill chunk at this "
                         "many tokens (0 = whole-prompt chunks, even if "
                         "REPRO_SERVE_CHUNK_TOKENS is set; default: "
                         "consult the env knob)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-step token budget split between decode "
                         "slots and prefill chunks (0 = unbounded; "
                         "default: consult REPRO_SERVE_TOKEN_BUDGET, "
                         "else chunk+slots when chunking)")
    ap.add_argument("--oversubscribe", type=float, default=None,
                    help="relax the DRAM admission gate by this factor "
                         "(>= 1), spill-lane-backed (0 = off even under "
                         "REPRO_SERVE_OVERSUBSCRIBE; default: consult "
                         "the env knob)")
    ap.add_argument("--priority-every", type=int, default=0,
                    help="every k-th request is priority-1 interactive "
                         "traffic, submitted mid-run so it preempts "
                         "(0 = uniform priority)")
    ap.add_argument("--spill-lanes", type=int, default=None,
                    help="RRAM spill lanes for preempted slots "
                         "(default: one per decode slot; 0 disables "
                         "preemption)")
    ap.add_argument("--spill-compress", action="store_true", default=None,
                    help="int8-compress the hot ring in spill lanes "
                         "(bounded-error restore; a parked image then "
                         "costs ~the cold tier's RRAM bytes; default: "
                         "consult REPRO_SERVE_SPILL_COMPRESS)")
    ap.add_argument("--idle-offload-steps", type=int, default=None,
                    help="proactively offload a runner resident >= this "
                         "many decode steps to an RRAM lane when an "
                         "equal-or-higher-priority waiter is blocked "
                         "(0 = off even under "
                         "REPRO_SERVE_IDLE_OFFLOAD_STEPS; default: "
                         "consult the env knob)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON timeline "
                         "(open in ui.perfetto.dev) — enables telemetry")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text exposition at the end "
                         "of the run — enables telemetry")
    ap.add_argument("--snapshots-out", default=None, metavar="PATH",
                    help="append JSONL telemetry snapshots every "
                         "--stats-every steps — enables telemetry")
    ap.add_argument("--stats-every", type=int, default=0,
                    help="print (and --snapshots-out: persist) a "
                         "telemetry snapshot every N engine steps "
                         "(0 = only at exit) — enables telemetry")
    args = ap.parse_args(argv)

    mesh = None
    if args.backend == "sharded":
        import torch.distributed as dist

        from repro_torch.launch.mesh import get_mesh
        mesh = get_mesh(args.mesh, device=args.device)
        dev = mesh.device
        rank0 = dist.get_rank() == 0
    else:
        dev = resolve_device(args.device)
        rank0 = True
    say = print if rank0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, reduced=args.reduced)
    dtype = args.dtype or cfg.compute_dtype
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype, remat="none",
                      kv_policy=args.kv_policy, kv_hot_window=args.hot_window)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, device=dev)
    vis = (cfg.frontend.num_tokens
           if args.image_every and cfg.frontend is not None else 0)
    max_len = args.max_len or (max(args.prompt_len, vis + 1) + args.gen)
    backend = make_backend(args.backend, model, params,
                           num_slots=args.concurrency, max_len=max_len,
                           device=dev, mesh=mesh, n_spill=args.spill_lanes,
                           spill_compress=args.spill_compress,
                           fused_decode=args.fused_decode,
                           sparse_read=args.sparse_read,
                           weight_stream=args.weight_stream)
    # telemetry is opt-in: any export flag (or --stats-every) turns the
    # hub on; otherwise the Engine installs the no-op NullTelemetry
    want_tel = (args.trace_out or args.metrics_out or args.snapshots_out
                or args.stats_every)
    # every rank keeps its hub (the engines stay identical); only rank 0
    # persists the snapshots, so ranks do not interleave lines in one file
    tel = Telemetry(stats_every=args.stats_every,
                    snapshot_path=args.snapshots_out if rank0 else None,
                    printer=say) if want_tel else None
    # None consults the env knobs, an explicit 0 disables
    engine = Engine(backend, chunk_tokens=args.chunk_tokens,
                    token_budget=args.token_budget,
                    oversubscribe=args.oversubscribe,
                    idle_offload_steps=args.idle_offload_steps,
                    paged=args.paged, prefix_cache=args.prefix_cache,
                    telemetry=tel)
    reqs = make_synthetic_requests(cfg, args.requests, args.prompt_len,
                                   args.gen, seed=args.seed,
                                   image_every=args.image_every,
                                   priority_every=args.priority_every,
                                   shared_prefix=args.shared_prefix)
    t0 = time.time()
    if args.priority_every:
        # interactive traffic lands mid-run: batch work first, then the
        # priority-1 requests once the slots are saturated
        for r in reqs:
            if r.priority == 0:
                engine.submit(r)
        for _ in range(3):
            engine.step()
        engine.run([r for r in reqs if r.priority > 0])
        done = engine.finished
    else:
        done = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    m = aggregate_metrics(done, wall)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    on = "" if mesh is None else f" mesh={mesh.shape} (sharded)"
    say(f"[serve] arch={args.arch} kv={args.kv_policy} dtype={dtype} "
          f"device={where}{on} slots={args.concurrency}: {m['requests']} "
          f"requests, {m['total_tokens']} tokens in {wall:.2f}s "
          f"({m['tok_per_s']:.1f} tok/s incl. kernel build; "
          f"ttft p95 {m.get('ttft_p95_s', 0.0) * 1e3:.0f} ms, "
          f"tbt p95 {m.get('tbt_p95_s', 0.0) * 1e3:.0f} ms)"
          + (f" [fused decode, sparse tau={backend.sparse_read_tau:g}]"
             if backend.fused_decode else ""))
    s = engine.stats
    if args.chunk_tokens:
        say(f"[serve] chunked prefill: {s['prefill_chunks']} chunks / "
              f"{s['extend_calls']} extend calls over {s['steps']} steps")
    if s["evictions"] or s["idle_offloads"]:
        lane_kind = ("int8-compressed" if backend.spill_compress
                     else "verbatim")
        say(f"[serve] spill ({lane_kind} lanes, "
              f"{backend.spill_lane_bytes():,} B each): "
              f"{s['evictions']} preemptions / {s['idle_offloads']} idle "
              f"offloads / {s['restores']} restores (restore latency p95 "
              f"{m.get('restore_latency_p95_s', 0.0) * 1e3:.1f} ms)")
    if engine.block_pool is not None:
        bp = engine.block_pool
        say(f"[serve] prefix cache: {m.get('prefix_hits', 0)} hits / "
              f"{m.get('prefix_hit_tokens', 0)} tokens skipped "
              f"(hit rate {m.get('prefix_hit_rate', 0.0):.2f}); "
              f"{bp.stats['cow_copies']} CoW copies, "
              f"{bp.used_blocks}/{bp.num_blocks} blocks live")
    if args.kv_policy == "tiered":
        rep = engine.endurance_report()
        say(f"[serve] endurance: max writes/cold-slot="
              f"{rep['max_writes_per_cold_slot']:.2f} (write-once "
              f"{'OK' if rep['write_once_ok'] else 'VIOLATED'})")
    # priced with the backend's resolved config and knobs: the CHIME
    # platform's analytic figures, not a measurement of this device
    sim_cfg, spill_comp = backend.sim_context()
    sim = simulated_efficiency(sim_cfg, done, spill_compressed=spill_comp,
                               fused_decode=backend.fused_decode,
                               sparse_read_tau=backend.sparse_read_tau,
                               weight_stream=bool(backend.weight_stream))
    note = ""
    if backend.weight_stream:
        dram_w, rram_w = backend.weight_bytes()
        note = (f" [weight stream W={backend.weight_stream}: "
                f"{dram_w / 2**20:.1f} MiB DRAM working set, "
                f"{rram_w / 2**20:.1f} MiB streamed from RRAM]")
    say(f"[serve] simulated on {sim['platform']}: "
          f"{sim['sim_tokens_per_j']:.1f} tok/J, "
          f"{sim['sim_energy_j']:.3f} J total{note}")
    if tel is not None and rank0:
        if args.trace_out:
            tel.write_chrome_trace(args.trace_out)
            say(f"[serve] telemetry: Perfetto trace -> {args.trace_out}")
        if args.metrics_out:
            tel.write_prometheus(args.metrics_out)
            say(f"[serve] telemetry: Prometheus exposition -> "
                  f"{args.metrics_out}")
        if args.snapshots_out:
            say(f"[serve] telemetry: JSONL snapshots -> "
                  f"{args.snapshots_out}")
        led = tel.ledger.totals() if tel.ledger is not None else {}
        if led:
            split = led["sim_energy_split_j"]
            drift = abs(led["sim_energy_j"] - sim["sim_energy_j"])
            say(f"[serve] ledger: dram={split.get('dram', 0.0):.4g} J "
                  f"rram={split.get('rram', 0.0):.4g} J "
                  f"compute={split.get('compute', 0.0):.4g} J "
                  f"(reconciles with simulated_efficiency: "
                  f"{'EXACT' if drift == 0.0 else f'drift {drift:.3g} J'})")
    if tel is not None:
        tel.close()
    say("[serve] sample token ids:", done[0].generated[:12])
    return done


if __name__ == "__main__":
    main()
