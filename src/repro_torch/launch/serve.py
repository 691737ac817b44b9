"""Serving CLI of the port: a thin front-end over the continuous-batching
engine, on the card unless ``--device`` says otherwise.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch fastvlm-1.7b \
        --requests 8 --concurrency 4 --prompt-len 256 --gen 64 \
        --kv-policy tiered --hot-window 128 --max-len 512 --image-every 2

Weights are random, drawn from ``--seed`` at the config's published
widths (``--reduced`` for the tiny test twins). `generate` below is the
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
    from repro_torch.serving import (Engine, aggregate_metrics,
                                     make_backend, make_synthetic_requests)

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
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
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
    backend = make_backend("local", model, params,
                           num_slots=args.concurrency, max_len=max_len,
                           device=dev, fused_decode=args.fused_decode,
                           sparse_read=args.sparse_read)
    engine = Engine(backend)
    reqs = make_synthetic_requests(cfg, args.requests, args.prompt_len,
                                   args.gen, seed=args.seed,
                                   image_every=args.image_every)
    t0 = time.time()
    done = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    m = aggregate_metrics(done, wall)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"[serve] arch={args.arch} kv={args.kv_policy} dtype={dtype} "
          f"device={where} slots={args.concurrency}: {m['requests']} "
          f"requests, {m['total_tokens']} tokens in {wall:.2f}s "
          f"({m['tok_per_s']:.1f} tok/s incl. kernel build; "
          f"ttft p95 {m.get('ttft_p95_s', 0.0) * 1e3:.0f} ms, "
          f"tbt p95 {m.get('tbt_p95_s', 0.0) * 1e3:.0f} ms)"
          + (f" [fused decode, sparse tau={backend.sparse_read_tau:g}]"
             if backend.fused_decode else ""))
    if args.kv_policy == "tiered":
        rep = engine.endurance_report()
        print(f"[serve] endurance: max writes/cold-slot="
              f"{rep['max_writes_per_cold_slot']:.2f} (write-once "
              f"{'OK' if rep['write_once_ok'] else 'VIOLATED'})")
    print("[serve] sample token ids:", done[0].generated[:12])
    return done


if __name__ == "__main__":
    main()
