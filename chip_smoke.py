#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # all phases, one CUDA card

Run from the repository root on a machine with an NVIDIA H100. It builds
the six kernel libraries from `src/repro_torch/kernels/csrc` (one nvcc per
source, all started together; seven kernels), then:

  1. kernels — each kernel against its plain PyTorch twin on the card, in
     f32 (TF32 off) and bf16: the fastvlm-1.7b path's four at its
     serving shapes (d_model 1536, F 8960, H 12, Hkv 2, Dh 128; decode
     M = 4, prefill M = 320, attention S = L = 320, paged decode B = 4,
     W = 128, max_len 512), and the mobilevlm-3b shapes (d_model 2560,
     F 6912, H = Hkv = 20, G = 1, Dh 128): qkv_proj, ffn_act_int8,
     ffn_act and fused_norm at decode M = 4 and prefill M = 256,
     paged_decode_flat and paged_decode_tiered at B = 4 slots,
     attn_stream at S = L = 256; qkv_proj at M = 1, 3, 4 (the GEMV),
     5 (the first GEMM row count) and prefill, at both models (fastvlm
     with bias); attn_stream also on an extend chunk (S = 64 at q_offset
     256 over a strided slice of the (1, 512, Hkv, 128) workspace), at
     ragged S = L = 200 and at fastvlm-0.6b's Dh 64; fused_norm at M = 1,
     4, 320 and D 1536, 2560, 1000 and 1001 (the scalar kernel),
     LayerNorm with bias, a scale in the other type and strided rows
     (pitch 1544: vector kernel; pitch 1542 or a base one element in:
     scalar kernel); paged_decode_flat at lengths 0, 1, 127, 128, with a
     slot's last live page dead, at max_len 500 (ragged tail page), at
     every head dim, at G 1 to 16 and at B * Hkv = 160 (no key split);
     paged_decode_tiered at lengths 0, 1, W - 1, W, W + 1 and max_len - 1,
     with dead pages (a slot's last live one, a slot with none), at G 1,
     2, 3, 4, 6, 8 and 16, every head dim, B * Hkv = 160, and the sparse
     read (tau = 1e-3, split 1) against the twin at the same tau, once on
     inputs where it really skips pages; its fastvlm (Hkv 2, G 6) and
     mobilevlm-3b (Hkv 20, G 1) shapes are timed beside their bound, the
     device time also from CUDA events (`event_ms`);
     ffn_act and ffn_act_int8 in every form, the one that ran asserted:
     in bf16 the stream form at M 1, 3, 4 and 5 (each beside the bound
     of its 16-bit rounding of h) and the wgmma form at M 63, 65, 256,
     257 and 320, the FMA tiles in f32 at every M, at D 320 (a ragged
     k-tile), F 1000 / 1024, every activation, int8 gated and not, and
     the FMA tiles for rows that are not whole 16-byte vectors (int8 F
     1000 or D 200, bf16 F 1004); the FFN's decode and prefill shapes of
     both models are timed beside their bound and, as a yardstick only,
     the cuBLAS chain mm, mm, silu * mul, mm (a chain of kernels, not
     one call);
     plus ragged, dead-page, unaligned-row and sparse-read cases.
     The banner prints the tensor-core kernels', the FFN forms' and the
     paged decodes' tiles and plans (the decodes' planned splits too)
     from their Python mirrors and holds each mirrored shared-memory size
     against the built library's; the SASS of the tensor-core libraries
     (attn_stream, qkv_proj, ffn_act, ffn_act_int8) must hold HGMMA and
     LDGSTS, and every instance of the paged decode library's two kernel
     functions LDGSTS (their cp.async key rings); every tiered instance
     must leave room for the planner's 2 blocks an SM. Tolerances:
     max-abs error <= 1e-4 in f32 (f32 sums in another order) and <= 2e-2
     in bf16 (inputs are scaled so outputs stay below magnitude 2, where
     one bf16 rounding step is <= 7.8e-3); the paged decodes, whose
     outputs are softmax means of V rows (1e-2 to 1 here), are held to
     the same numbers times each (slot, kv head)'s largest output, and
     the sparse case's skip must move the output by more than twice
     that. Call times are the median of
     25 CUDA-event timed calls after warm-up, device times the
     profiler's kernel time a call, for the kernels and for the library
     call beside them (SDPA; torch.addmm at decode and prefill;
     F.rms_norm; SDPA with a boolean length mask beside the flat decode),
     with the device kernels each library call launches;
  2. parity — f32 at full width and depth, the serving Engine's tokens
     against `generate` on 2 VQA + 2 text requests, for fastvlm-1.7b over
     the tiered store, for mobilevlm-3b on path A (flat store, fused
     decode in the Engine, the unfused store_read + softmax decode in
     `generate`) and on path B (tiered store, hot window 64, int8 FFN
     weights); a differing token passes only where `generate`'s top-2
     logit margin at that step is below 1e-3 (a tie); and path B
     preempted: 2 slots, 2 verbatim spill lanes, 2 priority-0 VQA
     requests, then after 3 steps a priority-1 text request that evicts
     one; its tokens against the same requests on an unpressured Engine
     (same tie rule);
  3. serving — three bf16 runs through the Engine at full width and
     depth, each the main path of its configuration: the kernels' launch
     counters are zeroed just before each run and read just after, and
     each run must launch its own set of kernels exactly once per layer
     per model call:
       * fastvlm-1.7b, tiered store (hot window 128, max_len 512): 8
         requests (4 VQA with 64 visual + 192 text tokens, 4 text with
         256) at concurrency 4, 64 new tokens each;
       * A, the DRAM-only arm: mobilevlm-3b, flat store, fused decode
         resolved on through the backend knob (paged_decode_flat);
       * B, the CHIME mapping: mobilevlm-3b, tiered store (hot window
         128) with int8 FFN weights (ffn_act_int8);
     A and B serve 8 requests (4 VQA with 144 visual + 112 text tokens,
     4 text with 256) at concurrency 4, max_len 512, 64 new tokens each.
     Each run is priced by chime_sim on the CHIME platform (and on the
     M3D-DRAM-only one) from its served trace, after the timed window:
     analytic tok/J and J with the per-domain split, not a measurement
     of the card. A decode-step profile and a whole-prompt prefill
     profile (torch.profiler) follow each run; in each, every kernel's
     launches in the profile are compared with its launch counter over
     the same window (a mismatch is printed), and the run's paged decode
     is timed alone on its last call's operands (profiler and CUDA
     events). Then path B under priority traffic, 4 slots and 4 RRAM
     spill lanes, with a Telemetry hub: 8 priority-0 requests (as
     above), 3 engine steps, then 4 priority-1 text requests (64-token
     prompts, 16 new tokens) that preempt runners:
       * B-preempt: verbatim lanes;
       * B-offload: int8-compressed lanes and idle offload after 16
         resident decode steps.
     Each must finish every request with evictions (and idle offloads)
     > 0 and every parked request restored, exact launch counts,
     write-once on the cold tier, the lanes' RRAM counters equal to
     `expected_spill_block_writes` over the eviction contexts, the
     ledger equal to `simulated_efficiency` (==), and a valid Perfetto
     trace and Prometheus exposition (written to chiprun_out/); it
     prints lane bytes (verbatim and compressed) and one evict_slot and
     one restore_slot's device time (CUDA events, median of 5) beside
     the bound of their bytes.

It prints the card (name, power limit), the kernel build time, the
phases' results, then one JSON line {"kernels": [...]} (launches summed
over the five serving runs; host_ms is call ms minus device ms) and,
last, the device JSON line. It fails
(non-zero exit, no result lines) without a card, outside the repository,
or when any check fails. `--phases` selects a subset (e.g. `--phases
kernels` for a quick compile check).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# fastvlm-1.7b serving shapes
D_MODEL, D_FF, HEADS, KV_HEADS, HEAD_DIM = 1536, 8960, 12, 2, 128
# mobilevlm-3b serving shapes (MHA: G = 1)
D3, F3, H3 = 2560, 6912, 20
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

REPLACES = {
    "fused_norm": "src/repro/kernels/fused_norm.py:35",
    "attn_stream": "src/repro/kernels/attn_stream.py:90",
    "ffn_act": "src/repro/kernels/ffn_act.py:71",
    "ffn_act_int8": "src/repro/kernels/ffn_act.py:148",
    "qkv_proj": "src/repro/kernels/qkv_proj.py:36",
    "paged_decode_tiered": "src/repro/kernels/paged_decode.py:147",
    "paged_decode_flat": "src/repro/kernels/paged_decode.py:267",
}
SOURCES = {
    "fused_norm": "src/repro_torch/kernels/csrc/fused_norm.cu",
    "attn_stream": "src/repro_torch/kernels/csrc/attn_stream.cu",
    "ffn_act": "src/repro_torch/kernels/csrc/ffn_act.cu",
    "ffn_act_int8": "src/repro_torch/kernels/csrc/ffn_act_int8.cu",
    "qkv_proj": "src/repro_torch/kernels/csrc/qkv_proj.cu",
    "paged_decode_tiered": "src/repro_torch/kernels/csrc/paged_decode.cu",
    "paged_decode_flat": "src/repro_torch/kernels/csrc/paged_decode.cu",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets)."""
    if "PCIe" in name:
        return {"bw": 2.0e12, "bfloat16": 756e12, "float32": 51e12}
    if "NVL" in name:
        return {"bw": 3.9e12, "bfloat16": 835e12, "float32": 60e12}
    return {"bw": 3.35e12, "bfloat16": 989e12, "float32": 67e12}  # SXM


def bound(pk: dict, nbytes: float, flops: float, dtype: str):
    t_b, t_f = nbytes / pk["bw"], flops / pk[dtype]
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of one call, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: the summed time of the device events
    (kernels, copies) that ``reps`` calls launch, per call, from
    torch.profiler — the wrapper's host time excluded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / reps


def event_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one call from CUDA events: ``n`` calls enqueued
    behind a `torch.cuda._sleep` of ~5 ms, so the host has queued them all
    before the first runs and the events bracket the kernels back to back
    (launch gaps on the card included, the host's excluded); the median
    of ``reps`` such runs, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        torch.cuda._sleep(10_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / n)
    return statistics.median(ts)


def device_kernels(fn, reps: int = 10) -> dict:
    """Device kernels (and copies) one call of ``fn`` launches, by name,
    from torch.profiler: how many kernels a library call is."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.count / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def require(cond, msg) -> None:
    """A check of this script; unlike ``assert`` it survives ``-O``."""
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# what the SASS of each library must hold: the bf16 tensor-core kernels
# warpgroup MMAs (HGMMA) over shared-memory tiles filled by cp.async
# (LDGSTS; the FFN's stream form fills its ring with it too); the paged
# decode library's two split-K kernels their cp.async key rings, counted
# in every instance of each kernel function
SASS_NEEDS = {"attn_stream": ("HGMMA", "LDGSTS"),
              "qkv_proj": ("HGMMA", "LDGSTS"),
              "ffn_act": ("HGMMA", "LDGSTS"),
              "ffn_act_int8": ("HGMMA", "LDGSTS"),
              "paged_decode": ("LDGSTS",)}
SASS_PER_FUNCTION = {"paged_decode": ("paged_decode_tiered_kernel",
                                      "paged_decode_flat_kernel")}


def sass_functions(sass: str) -> dict:
    """cuobjdump -sass text -> {kernel function (mangled): its SASS}."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def sass_check() -> dict:
    """Count HGMMA and LDGSTS instructions in the built libraries of
    SASS_NEEDS with cuobjdump (beside nvcc) and require what each
    needs; for SASS_PER_FUNCTION also LDGSTS in every instance of each
    named kernel function."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for name, needs in SASS_NEEDS.items():
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        out[name] = {"HGMMA": sass.count("HGMMA"),
                     "LDGSTS": sass.count("LDGSTS")}
        print(f"[sass] {name}: {out[name]['HGMMA']} HGMMA, "
              f"{out[name]['LDGSTS']} LDGSTS instructions")
        for op in needs:
            require(out[name][op] > 0,
                    f"{name}: no {op} instruction in the built library")
        funcs = sass_functions(sass)
        for kern in SASS_PER_FUNCTION.get(name, ()):
            counts = [f.count("LDGSTS") for k, f in funcs.items()
                      if kern in k]
            out[name][kern] = {"instances": len(counts),
                               "LDGSTS_min": min(counts, default=0),
                               "LDGSTS_max": max(counts, default=0)}
            print(f"[sass]   {kern}: {len(counts)} instances, LDGSTS "
                  f"{min(counts, default=0)}-{max(counts, default=0)} "
                  f"each")
            require(counts and min(counts) > 0,
                    f"{name}: an instance of {kern} has no LDGSTS")
    return out


def tile_banner(dev: str = "cuda") -> dict:
    """Print the bf16 tensor-core kernels' and the paged decodes' tiles and
    planned splits from their Python mirrors (the constants the CPU tests check
    against Hopper's shared memory) and, on the card, hold each mirrored
    shared-memory size against the one the built library reports, so a
    drift between the two shows."""
    import ctypes

    import torch

    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import build
    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import qkv_proj as QK

    # the FFN's mirrors: the stream form at its row counts, both models'
    # widths and every D split; the GEMM phases at both warpgroup counts,
    # per weight size (2: bf16, 1: int8)
    stream_at = [(m, d, ds) for m in (1, 4, 8) for d in (D_MODEL, D3)
                 for ds in (1, 2, 4, 8)]
    ffn_stream = {f"w{es} M{m} D{d} ds{ds}":
                  FF.stream_smem_bytes(m, d, ds, es == 1)
                  for es in (2, 1) for (m, d, ds) in stream_at}
    ffn_tc = {f"w{es} phase{ph} wgs{w}": FF.wgmma_smem_bytes(ph, es, w)
              for es in (2, 1) for ph in (1, 2) for w in (1, 2)}
    # the tiered decode's instances (table entries, dtype code, head dim,
    # G): every dtype, head dim and G form at 4 pages, 1 and 5 pages at
    # fastvlm-1.7b's (bf16, 128, G 6 -> 8)
    tiered_at = {f"{n}p {dt} D{hd} G{g}": (n, code, hd, g)
                 for (code, dt) in ((0, "float32"), (1, "bfloat16"))
                 for hd in PD.HEAD_DIMS for g in (1, 2, 4, 8, 16)
                 for n in ((1, 4, 5) if (dt, hd, g) == ("bfloat16", 128, 8)
                           else (4,))}
    tiles = {"ffn_act": {
                 "stream_threads": FF.STREAM_THREADS,
                 "stream_slice": FF.STREAM_SLICE,
                 "stream_stages": FF.STREAM_STAGES,
                 "stream_stage_bytes": [FF.STREAM_STAGE_BYTES,
                                        FF.STREAM_INT8_STAGE_BYTES],
                 "stream_max_m": FF.STREAM_MAX_M,
                 "stream_plans (ds, cluster, blocks)": {
                     f"F{f}": FF.stream_plan(f, 132) for f in (D_FF, F3)},
                 "wgmma_plans (wgs, ks, k_chunk)": {
                     f"M{m} D{d} F{f}": FF.wgmma_plan(m, d, f, 132)
                     for (m, d, f) in ((320, D_MODEL, D_FF),
                                       (256, D3, F3))},
                 "wgmma_tile": [128, FF.WGMMA_BN, FF.WGMMA_BK],
                 "wgmma_stages": {f"w{es} phase{ph} wgs{w}": FF.wgmma_stages(
                     es, 64 * w, 3 - ph)[0] for es in (2, 1)
                     for ph in (1, 2) for w in (1, 2)},
                 "stream_smem": ffn_stream, "wgmma_smem": ffn_tc},
             "attn_stream": {
                 "BQ": AS.WGMMA_BQ, "BK": AS.WGMMA_BK,
                 "stages": AS.WGMMA_STAGES,
                 "smem": {hd: AS.wgmma_smem_bytes(hd)
                          for hd in AS.HEAD_DIMS}},
             "qkv_proj": {
                 "BM": [64, 128], "BN": QK.WGMMA_BN, "BK": QK.WGMMA_BK,
                 "stages": [QK.wgmma_stages(w) for w in (1, 2)],
                 "smem": [QK.wgmma_smem_bytes(w) for w in (1, 2)],
                 "gemv_threads": QK.GEMV_THREADS,
                 "gemv_blocks_per_sm": QK.GEMV_BLOCKS_PER_SM,
                 "gemv_max_split": QK.GEMV_MAX_SPLIT},
             "paged_decode_flat": {
                 "warps": PD.FLAT_WARPS, "stages": PD.FLAT_STAGES,
                 "stage_bytes": PD.FLAT_STAGE_BYTES,
                 "max_split": PD.FLAT_MAX_SPLIT,
                 "tile_keys_bf16_d128": PD.flat_tile_keys(128,
                                                          torch.bfloat16),
                 "smem": {n: PD.flat_smem_bytes(n) for n in (1, 4, 5)},
                 "splits (B, Hkv)": {f"{b} {h}": PD.flat_split(b, h, 132)
                                     for (b, h) in ((4, 20), (8, 20))}},
             "paged_decode_tiered": {
                 "features_a_lane": PD.TIERED_FEATURES,
                 "tile_keys_d128 (bf16, f32)": [
                     PD.tiered_tile_keys(128, torch.bfloat16),
                     PD.tiered_tile_keys(128, torch.float32)],
                 "smem": {k: PD.tiered_smem_bytes(
                     n, hd, g, torch.float32 if code == 0 else torch.bfloat16)
                     for k, (n, code, hd, g) in tiered_at.items()},
                 "splits (B, Hkv, sparse)": {
                     f"{b} {h} {sp}": PD.tiered_split(b, h, 132, sp)
                     for (b, h) in ((4, 2), (4, 20), (8, 20))
                     for sp in (False, True)}}}
    print(f"[kernels] tiles {json.dumps(tiles)}")
    if dev != "cuda":
        return tiles
    la, lq = build.load("attn_stream"), build.load("qkv_proj")
    lp = build.load("paged_decode")
    for fn in (la.attn_stream_smem_bytes, lq.qkv_proj_smem_bytes,
               lp.paged_decode_flat_smem_bytes):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for fn in (lp.paged_decode_tiered_smem_bytes,
               lp.paged_decode_tiered_blocks_per_sm):
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    for n, want in tiles["paged_decode_flat"]["smem"].items():
        got = lp.paged_decode_flat_smem_bytes(n)
        require(got == want, f"paged_decode_flat smem at {n} pages: library "
                             f"{got}, mirror {want}")
    occupancy = {}
    for k, args in tiered_at.items():
        got = lp.paged_decode_tiered_smem_bytes(*args)
        want = tiles["paged_decode_tiered"]["smem"][k]
        require(got == want, f"paged_decode_tiered smem at {k}: library "
                             f"{got}, mirror {want}")
        if args[0] == 4:
            occupancy[k[3:]] = lp.paged_decode_tiered_blocks_per_sm(*args)
    # the planner's grid target (FLAT_BLOCKS_PER_SM blocks an SM) has to
    # be resident at once: registers, static and dynamic shared memory
    print(f"[kernels] paged_decode_tiered blocks an SM holds at 4 pages: "
          f"{json.dumps(occupancy)}")
    tiles["paged_decode_tiered"]["blocks_per_sm"] = occupancy
    low = {k: v for k, v in occupancy.items() if v < PD.FLAT_BLOCKS_PER_SM}
    require(not low, f"paged_decode_tiered instances below the planner's "
                     f"{PD.FLAT_BLOCKS_PER_SM} blocks an SM: {low}")
    for hd, want in tiles["attn_stream"]["smem"].items():
        got = la.attn_stream_smem_bytes(hd)
        require(got == want, f"attn_stream smem at Dh {hd}: library {got}, "
                             f"mirror {want}")
    for wgs in (1, 2):
        got, want = lq.qkv_proj_smem_bytes(10 + wgs), QK.wgmma_smem_bytes(wgs)
        require(got == want, f"qkv_proj GEMM smem at {wgs} warpgroups: "
                             f"library {got}, mirror {want}")
    for code, dt in ((1, "float32"), (2, "bfloat16")):
        want = QK.gemv_smem_bytes(0, 0, getattr(torch, dt))
        require(lq.qkv_proj_smem_bytes(code) == want,
                f"qkv_proj GEMV {dt} static smem: library "
                f"{lq.qkv_proj_smem_bytes(code)}, mirror {want}")
    for lib_name in ("ffn_act", "ffn_act_int8"):
        lf = build.load(lib_name)
        lf.ffn_smem_bytes.argtypes = [ctypes.c_int] * 4
        lf.ffn_smem_bytes.restype = ctypes.c_int
        es = 2 if lib_name == "ffn_act" else 1
        for (m, d, ds) in stream_at:
            got = lf.ffn_smem_bytes(0, m, d, ds)
            want = ffn_stream[f"w{es} M{m} D{d} ds{ds}"]
            require(got == want, f"{lib_name} stream smem at M {m} D {d} "
                                 f"D split {ds}: library {got}, mirror "
                                 f"{want}")
        for ph in (1, 2):
            for w in (1, 2):
                got = lf.ffn_smem_bytes(ph, w, 0, 0)
                want = ffn_tc[f"w{es} phase{ph} wgs{w}"]
                require(got == want, f"{lib_name} phase-{ph} smem at wgs "
                                     f"{w}: library {got}, mirror {want}")
    print("[kernels] tile mirrors match the built libraries")
    return tiles


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain twins
# ---------------------------------------------------------------------------
def kernel_phase(pk: dict, dev: str = "cuda", timer=time_ms,
                 dev_timer=device_ms, lib_kernels=device_kernels,
                 ev_timer=event_ms) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.core import kv_tiers as KT
    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import build
    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import qkv_proj as QK

    tiles = tile_banner(dev)
    dev = torch.device(dev)
    sms = build.sm_count(0) if dev.type == "cuda" else 132
    time_ms, dev_ms = timer, dev_timer
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results: dict[str, dict] = {"tiles": tiles, "extra_rows": []}
    cases: dict[str, list] = {k: [] for k in REPLACES}

    def timed(fn, reps=25):
        """(call ms, device ms) of ``fn``: CUDA events around the call,
        and the profiler's device time of what it launches."""
        return time_ms(fn, reps=reps), dev_ms(fn)

    def record(name, label, dtype, err, main=None, extra=None, rel=None):
        """One case: ``err`` (max-abs) is held to the dtype's limit, or,
        where ``rel`` is given (the paged decodes), ``rel`` is."""
        tol = TOL[dtype]
        ok = (err if rel is None else rel) <= tol
        cases[name].append({"case": label, "dtype": dtype,
                            "max_abs_err": err, "tol": tol, "ok": ok,
                            **({} if rel is None else {"rel_err": rel}),
                            **(extra or {})})
        more = "".join(f" {k}={v:.3e}" for k, v in (extra or {}).items())
        held = (f"(tol {tol:g})" if rel is None
                else f"rel {rel:.3e} (tol {tol:g} rel)")
        print(f"[kernels] {name:20s} {label:34s} {dtype:8s} "
              f"max|err|={err:.3e} {held}{more} {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {label} {dtype}: {err if rel is None else rel} "
                    f"> {tol}")
        if main is not None:
            results[name] = dict(main, max_abs_err=err, dtype=dtype)

    def decode_errs(got, want):
        """(max-abs error, error relative to each (slot, kv head)'s largest
        output) of a paged decode. Its outputs are softmax means of V
        rows, small (1e-2 to 1 here) and far apart from slot to slot, so
        each (slot, kv head) is held to the limit times its own largest
        output; one with no attendable key must give exactly 0."""
        e = (got.float() - want.float()).abs().flatten(2).amax(-1)
        w = want.float().abs().flatten(2).amax(-1)
        return float(e.max()), float((e / w.clamp_min(1e-30)).max())

    def norm_row(x, sc, es):
        """The bf16 rms fused_norm's times beside its twin and F.rms_norm
        (call and device time, and the kernels that call launches)."""
        M, D_ = x.shape
        ms, dms = timed(lambda: FN.fused_norm(x, sc, None, "rms"))
        lib = lib_dev = lib_k = None
        if hasattr(F, "rms_norm"):
            def call():
                return F.rms_norm(x, (D_,), sc, 1e-6)
            lib, lib_dev = timed(call)
            lib_k = lib_kernels(call)
        b_ms, b_by = bound(pk, (2 * M * D_ + D_) * es, 0, "bfloat16")
        return {"shape": f"x ({M}, {D_}) rms", "ms": ms, "device_ms": dms,
                "plain_ms": time_ms(lambda: FN.fused_norm_plain(
                    x, sc, None, "rms")),
                "library_ms": lib, "library_device_ms": lib_dev,
                "library_kernels": lib_k, "bound_ms": b_ms,
                "bound_by": b_by}

    results["ffn_rows"] = []

    def ffn_case(name, x, w, kind, dt, label, want_variant, row=None,
                 is_main=False):
        """One FFN case: ``name`` on x and its weight operands ``w``
        against its plain twin, the form that ran asserted. A stream case
        also records the bound of its 16-bit rounding of h, u * max_md
        sum_f |h_mf w_fd| (u = 2^-9 for bf16 h, 2^-11 for the fp16 h of
        int8 weights). With ``row`` = (weight bytes, chain) in bf16 also
        its times beside its bound and, as a yardstick only, the device
        time of ``chain``, the cuBLAS chain mm, mm, silu * mul, mm on the
        same (int8: pre-dequantized bf16) weights."""
        kern, twin = getattr(FF, name), getattr(FF, f"{name}_plain")

        def fn():
            return kern(x, *w, kind)

        def ref():
            return twin(x, *w, kind)
        err = max_err(fn(), ref())
        got = kern.variant
        require(got == want_variant, f"{name} {label} {dt}: ran the {got} "
                                     f"form, expected {want_variant}")
        extra = None
        if got == "stream":
            int8 = name == "ffn_act_int8"
            wu, wg, wd = ([None if w[i] is None else
                           FF.dequantize(w[i], w[i + 1]) for i in (0, 2, 4)]
                          if int8 else [None if t is None else t.float()
                                        for t in w])
            h = FF.activation(x.float() @ wu, kind)
            if wg is not None:
                h = h * (x.float() @ wg)
            extra = {"h_round_bound": 2.0 ** (-11 if int8 else -9) * float(
                (h.abs() @ wd.abs()).max())}
        main = None
        if row is not None:
            (M, D_), F_ = x.shape, w[0].shape[1]
            w_bytes, chain = row
            ms, dms = timed(fn)
            c_ms, c_dms = timed(chain)
            c_k = lib_kernels(chain)
            b_ms, b_by = bound(pk, 4 * M * D_ + w_bytes, 6 * M * D_ * F_,
                               "bfloat16")
            main = {"shape": f"x ({M}, {D_}), F {F_}, {label}", "ms": ms,
                    "device_ms": dms, "plain_ms": time_ms(ref),
                    "library_ms": None, "variant": got,
                    "chain_ms": c_ms, "chain_device_ms": c_dms,
                    "chain_kernels": c_k,
                    "chain": f"cuBLAS chain of {round(sum(c_k.values()))} "
                             f"kernels (mm, mm, silu * mul, mm), not one "
                             f"call", "bound_ms": b_ms, "bound_by": b_by}
            results["ffn_rows"].append(dict(main, name=name,
                                            max_abs_err=err, **(extra or {})))
            print(f"[kernels]   {name} {main['shape']} ({got}): "
                  f"{1e3 * dms:.2f} us device, {ms:.4f} ms call; "
                  f"{main['chain']} {1e3 * c_dms:.2f} us device; bound "
                  f"{1e3 * b_ms:.2f} us ({b_by})")
        record(name, f"{label} ({got})", dt, err, main if is_main else None,
               extra)

    def ffn_form(M, dt):
        """The FFN form expected for M rows of ``dt`` x, rows aligned."""
        if dt == "float32":
            return "fma"
        return "stream" if M <= FF.STREAM_MAX_M else "wgmma"

    def chain_of(x, wu, wg, wd):
        def call():
            return (F.silu(x @ wu) * (x @ wg)) @ wd
        return call

    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        es = torch.tensor([], dtype=tdt).element_size()
        # ---- fused_norm: rms at decode M = 1, 4 and prefill M = 320, at
        # fastvlm-1.7b's D 1536, mobilevlm-3b's 2560 and ragged D 1000
        # (whole 16-byte vectors, a ragged warp) and 1001 (the scalar
        # kernel). In bf16 at M = 4 the kernel, its twin and F.rms_norm
        # are timed at both models' widths
        for D_ in (D_MODEL, D3, 1000, 1001):
            sc = (0.25 + 0.1 * torch.rand(D_, generator=gen,
                                          device=dev)).to(tdt)
            for M in (1, 4, 320):
                x = randn(M, D_, dtype=tdt)
                out = FN.fused_norm(x, sc, None, "rms")
                err = max_err(out, FN.fused_norm_plain(x, sc, None, "rms"))
                main = None
                if M == 4 and dt == "bfloat16" and D_ in (D_MODEL, D3):
                    main = norm_row(x, sc, es)
                    print(f"[kernels]   fused_norm x ({M}, {D_}): "
                          f"{1e3 * main['device_ms']:.2f} us device, "
                          f"{main['ms']:.4f} ms call; F.rms_norm (ms) "
                          f"{main['library_device_ms']} device, "
                          f"{main['library_ms']} call, kernels "
                          f"{main['library_kernels']}")
                    if D_ == D3:
                        results["fused_norm_mobilevlm"], main = main, None
                record("fused_norm", f"rms M={M}" if D_ == D_MODEL
                       else f"rms M={M} D={D_}", dt, err, main)
        # LayerNorm with bias; scale in the other type; strided rows: pitch
        # 1544 (whole vectors: the vector kernel), pitch 1542 and a base
        # one element in (the scalar kernel)
        for (M, D_) in ((4, D_MODEL), (320, 1000), (3, 1001)):
            x = randn(M, D_, dtype=tdt)
            sl, bl = randn(D_, dtype=tdt, std=0.3), randn(D_, dtype=tdt,
                                                          std=0.3)
            record("fused_norm", f"layer + bias M={M} D={D_}", dt,
                   max_err(FN.fused_norm(x, sl, bl, "layer"),
                           FN.fused_norm_plain(x, sl, bl, "layer")))
        other = "float32" if dt == "bfloat16" else "bfloat16"
        x = randn(4, D3, dtype=tdt)
        so = (0.25 + 0.1 * torch.rand(D3, generator=gen, device=dev)).to(
            getattr(torch, other))
        record("fused_norm", f"rms M=4 D={D3} {other} scale", dt,
               max_err(FN.fused_norm(x, so, None, "rms"),
                       FN.fused_norm_plain(x, so, None, "rms")))
        sc = (0.25 + 0.1 * torch.rand(D_MODEL, generator=gen,
                                      device=dev)).to(tdt)
        for (pitch, off, want) in ((1544, 0, "vector"), (1542, 0, "scalar"),
                                   (1544, 1, "scalar")):
            x = randn(320, pitch, dtype=tdt)[:, off:off + D_MODEL]
            got = FN.variant(D_MODEL, x.stride(0), es,
                             x.data_ptr() | sc.data_ptr())
            require(got == want, f"fused_norm on pitch {pitch} offset {off}: "
                                 f"{got} kernel, expected {want}")
            record("fused_norm", f"rms M=320 pitch {pitch} offset {off} "
                                 f"({got})", dt,
                   max_err(FN.fused_norm(x, sc, None, "rms"),
                           FN.fused_norm_plain(x, sc, None, "rms")))
        # ---- ffn_act: decode M=4 (stream) and prefill M=320 (wgmma in
        # bf16, the FMA tiles in f32), silu_gated; bf16 rows timed
        w_up = randn(D_MODEL, D_FF, dtype=tdt, std=0.5 * D_MODEL ** -0.5)
        w_gate = randn(D_MODEL, D_FF, dtype=tdt, std=0.5 * D_MODEL ** -0.5)
        w_down = randn(D_FF, D_MODEL, dtype=tdt, std=D_FF ** -0.5)
        for M in (4, 320):
            x = randn(M, D_MODEL, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * D_MODEL * D_FF * es,
                       chain_of(x, w_up, w_gate, w_down))
            ffn_case("ffn_act", x, (w_up, w_gate, w_down), "silu_gated", dt,
                     f"silu_gated M={M}", ffn_form(M, dt), row, M == 4)
        del w_up, w_gate, w_down
        # ---- attn_stream: prefill S = L = 320 causal --------------------
        S = L = 320
        q = randn(1, HEADS, S, HEAD_DIM, dtype=tdt)
        k = randn(1, KV_HEADS, L, HEAD_DIM, dtype=tdt)
        v = randn(1, KV_HEADS, L, HEAD_DIM, dtype=tdt, std=0.4)
        out = AS.attn_stream(q, k, v, causal=True)
        err = max_err(out, AS.attn_stream_plain(q, k, v, True))
        main = None
        if dt == "bfloat16":
            ms = time_ms(lambda: AS.attn_stream(q, k, v, causal=True))
            plain = time_ms(lambda: AS.attn_stream_plain(q, k, v, True))
            if tuple(int(p) for p in torch.__version__.split(".")[:2]) \
                    >= (2, 5):
                lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
            else:
                ke = k.repeat_interleave(HEADS // KV_HEADS, 1)
                ve = v.repeat_interleave(HEADS // KV_HEADS, 1)
                lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, is_causal=True))
            pairs = S * (S + 1) // 2
            nbytes = (2 * HEADS * S + 2 * KV_HEADS * L) * HEAD_DIM * es
            b_ms, b_by = bound(pk, nbytes, 4 * HEADS * HEAD_DIM * pairs, dt)
            main = {"shape": f"q (1, {HEADS}, {S}, {HEAD_DIM}), kv heads "
                             f"{KV_HEADS}, causal", "ms": ms,
                    "device_ms": dev_ms(lambda: AS.attn_stream(
                        q, k, v, causal=True)),
                    "plain_ms": plain, "library_ms": lib,
                    "library_device_ms": lib_dev, "bound_ms": b_ms,
                    "bound_by": b_by}
        record("attn_stream", "causal S=L=320", dt, err, main)
        # an extend chunk: 64 queries at pos 256 over the first 320 rows of
        # the (1, 512, Hkv, Dh) workspace, sliced as core/fusion.py passes
        # it (strided K/V views, model-layout q and output)
        k_ws = randn(1, 512, KV_HEADS, HEAD_DIM, dtype=tdt)
        v_ws = randn(1, 512, KV_HEADS, HEAD_DIM, dtype=tdt, std=0.4)
        qx = randn(1, 64, HEADS, HEAD_DIM, dtype=tdt)
        kx, vx = k_ws[:, :320], v_ws[:, :320]
        record("attn_stream", "extend S=64 L=320 workspace slice", dt,
               max_err(ops.attn_stream(qx, kx, vx, causal=True),
                       AS.attn_stream_plain(
                           qx.transpose(1, 2), kx.transpose(1, 2),
                           vx.transpose(1, 2), True).transpose(1, 2)))
        del k_ws, v_ws
        # ragged S = L = 200 (not a multiple of the 64-row tiles)
        q = randn(1, HEADS, 200, HEAD_DIM, dtype=tdt)
        k = randn(1, KV_HEADS, 200, HEAD_DIM, dtype=tdt)
        v = randn(1, KV_HEADS, 200, HEAD_DIM, dtype=tdt, std=0.4)
        record("attn_stream", "ragged causal S=L=200", dt,
               max_err(AS.attn_stream(q, k, v, causal=True),
                       AS.attn_stream_plain(q, k, v, True)))
        # fastvlm-0.6b's heads: H 14, Hkv 2, Dh 64
        q = randn(1, 14, 320, 64, dtype=tdt)
        k = randn(1, 2, 320, 64, dtype=tdt)
        v = randn(1, 2, 320, 64, dtype=tdt, std=0.4)
        record("attn_stream", "H=14 Hkv=2 Dh=64 causal S=L=320", dt,
               max_err(AS.attn_stream(q, k, v, causal=True),
                       AS.attn_stream_plain(q, k, v, True)))
        # ---- paged_decode_tiered: hot window 128, max_len 512, 128-token
        # pages; cold int8 with scales in 0.002-0.008
        B, W, ML, G = 4, 128, 512, HEADS // KV_HEADS

        def tiered_args(Bt, hkv, g, Dt, lens, dead=(), skew=False):
            """Operands of one tiered call. ``skew`` (for tau = 1e-3, whose
            skip threshold is m + ln(1e-3) = m - 6.91): one query row over
            the group; hot slot 0 along sign(q) with score 12, the running
            max; every cold key along sign(q) too, so a page's score equals
            its bound, 127 * k-scale * scale * ||q||_1: 12 - 7.2 on pages 0
            and 2+ (0.3 under the threshold: skipped, yet 7.5e-4 of slot
            0's weight a key) and 12 - 6 on page 1 (read). Skipping nothing,
            or page 1 too, moves some (slot, kv head)'s output by over a
            tenth of its largest value."""
            qd = randn(Bt, hkv, g, Dt, dtype=tdt)
            if skew:
                qd = qd[:, :, :1].expand(Bt, hkv, g, Dt).contiguous()
            hk = randn(Bt, W, hkv, Dt, dtype=tdt)
            hv = randn(Bt, W, hkv, Dt, dtype=tdt, std=0.3)
            ck, cv = (torch.randint(-127, 128, (Bt, ML, hkv, Dt),
                                    generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            ks, vs = (0.002 + 0.006 * torch.rand(Bt, ML, hkv, 1,
                                                 generator=gen, device=dev)
                      for _ in range(2))
            if skew:
                sgn = torch.sign(qd[:, :, 0].float())          # (Bt, hkv, Dt)
                unit = Dt ** -0.5 * qd[:, :, 0].float().abs().sum(-1)
                hk[:, 0] = (12.0 / unit[..., None] * sgn).to(tdt)
                ck[:] = (127 * sgn).to(torch.int8)[:, None]
                score = torch.full((ML,), 12.0 - 7.2, device=dev)
                score[128:256] = 12.0 - 6.0
                ks = (score[None, :, None] / (127 * unit[:, None])
                      )[..., None].contiguous()
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            tab = KT.cold_page_table(lt, W, ML, 128).clone()
            for (b_, j_) in dead:
                tab[b_, j_] = -1
            return (qd, hk, hv, ck, ks, cv, vs, lt, tab)

        def tiered_row(targs, label):
            """Times of one bf16 tiered call beside its bound (the live hot
            slots and cold rows + scales, each read once; q read, out
            written) and its twin's."""
            qd, hk, lt = targs[0], targs[1], targs[7]
            _, hkv, g, Dt = qd.shape
            n_hot = sum(min(int(p) + 1, W) for p in lt)
            n_cold = sum(max(int(p) - W + 1, 0) for p in lt)
            nbytes = (2 * qd.numel() * es + 2 * n_hot * hkv * Dt * es
                      + 2 * n_cold * hkv * (Dt + 4)
                      + lt.numel() * 4 + targs[8].numel() * 4)
            b_ms, b_by = bound(pk, nbytes, 4 * g * Dt * hkv
                               * (n_hot + n_cold), dt)
            split = PD.tiered_split(qd.shape[0], hkv, sms, False)
            ms, dms = timed(lambda: PD.paged_decode_tiered(*targs))
            row = {"shape": f"{label}, split {split}", "ms": ms,
                   "device_ms": dms,
                   "event_ms": ev_timer(lambda: PD.paged_decode_tiered(
                       *targs)),
                   "plain_ms": time_ms(lambda: PD.paged_decode_tiered_plain(
                       *targs)),
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            print(f"[kernels]   paged_decode_tiered {row['shape']}: "
                  f"{1e3 * dms:.2f} us device (profiler), "
                  f"{1e3 * row['event_ms']:.2f} us (CUDA events), "
                  f"{ms:.4f} ms call; bound {1e3 * b_ms:.2f} us ({b_by}); "
                  f"plain {row['plain_ms']:.3f} ms")
            return row

        args = tiered_args(B, KV_HEADS, G, HEAD_DIM, (ML - 1,) * B)
        err, rel = decode_errs(PD.paged_decode_tiered(*args),
                               PD.paged_decode_tiered_plain(*args))
        main = None
        if dt == "bfloat16":
            main = tiered_row(args, f"B {B}, Hkv {KV_HEADS}, G {G}, W {W}, "
                                    f"max_len {ML}, {ML - W} cold tokens/slot")
        record("paged_decode_tiered", "B=4 W=128 384 cold/slot", dt, err,
               main, rel=rel)
        # mobilevlm-3b (path B): Hkv 20, G 1, ctx 257-318, timed in bf16
        args3 = tiered_args(B, H3, 1, HEAD_DIM, (318, 300, 257, 290))
        err, rel = decode_errs(PD.paged_decode_tiered(*args3),
                               PD.paged_decode_tiered_plain(*args3))
        record("paged_decode_tiered", "Hkv=20 G=1 ctx~300", dt, err, rel=rel)
        if dt == "bfloat16":
            results["extra_rows"].append(dict(
                tiered_row(args3, f"B {B}, Hkv {H3}, G 1, W {W}, max_len "
                                  f"{ML}, ctx [318, 300, 257, 290]"),
                name="paged_decode_tiered"))
        del args3
        # around the hot window and the pages: lengths 0, 1, W - 1, W,
        # W + 1 and max_len - 1; dead pages (a slot's last live one, and a
        # slot left with no live page); every G form (1, 2, 4, 8, 16) and
        # every head dim (bf16 G >= 2: the tensor-core scores); the sparse
        # read, with pages really skipped, held against the twin at the
        # same tau; B * Hkv >= 132 (no split)
        for (label, Bt, hkv, g, Dt, lens, dead, tau, skew) in (
                ("lengths 0,1,W-1,W", 4, KV_HEADS, 6, HEAD_DIM,
                 (0, 1, W - 1, W), (), 0.0, False),
                ("lengths W+1,max_len-1,255,256, dead pages", 4, KV_HEADS,
                 6, HEAD_DIM, (W + 1, ML - 1, 255, 256),
                 ((1, 0), (1, 2), (2, 0)), 0.0, False),
                ("ragged + dead page", 4, KV_HEADS, 6, HEAD_DIM,
                 (ML - 1, 300, 129, 20), ((0, 1),), 0.0, False),
                ("ragged + dead page, tau=1e-3", 4, KV_HEADS, 6, HEAD_DIM,
                 (ML - 1, 300, 129, 20), ((0, 1),), 1e-3, False),
                ("pages skipped, tau=1e-3", 4, KV_HEADS, 6, HEAD_DIM,
                 (ML - 1, 400, 300, 200), (), 1e-3, True),
                ("Hkv=20 G=1 D=128, tau=1e-3", 4, H3, 1, HEAD_DIM,
                 (318, 0, 127, 511), ((3, 1),), 1e-3, False),
                ("Hkv=20 G=1 D=64", 4, H3, 1, 64, (318, 0, 127, 511), (),
                 0.0, False),
                ("Hkv=4 G=2 D=64", 4, 4, 2, 64, (300, 129, 64, 511),
                 ((0, 1),), 0.0, False),
                ("Hkv=2 G=8 D=64", 2, 2, 8, 64, (400, 200), (), 0.0, False),
                ("Hkv=2 G=4 D=32", 2, 2, 4, 32, (300, 64), ((0, 0),), 0.0,
                 False),
                ("Hkv=1 G=3 D=16", 2, 1, 3, 16, (511, 129), (), 0.0, False),
                ("Hkv=1 G=16 D=128", 2, 1, 16, HEAD_DIM, (ML - 1, 130),
                 ((0, 3),), 0.0, False),
                ("Hkv=1 G=16 D=64, tau=1e-3", 2, 1, 16, 64, (ML - 1, 130),
                 (), 1e-3, False),
                ("B=8 Hkv=20 (B*Hkv=160)", 8, H3, 1, HEAD_DIM,
                 (318, 300, 257, 290, 511, 0, 128, 200), (), 0.0, False)):
            targs = tiered_args(Bt, hkv, g, Dt, lens, dead, skew)
            want = PD.paged_decode_tiered_plain(*targs, tau=tau)
            extra = None
            if tau:     # does the twin's skip rule fire on these inputs?
                moved, moved_rel = decode_errs(
                    want, PD.paged_decode_tiered_plain(*targs))
                extra = {"skip_changed_output": moved,
                         "skip_changed_rel": moved_rel}
                # twice the limit: a kernel within it of the skipping
                # twin is out of it of the twin that skips nothing
                if skew:
                    require(moved_rel > 2 * TOL[dt],
                            f"paged_decode_tiered {label}: skipping moves "
                            f"the output by {moved_rel:.3e} of its largest "
                            f"value, not over twice the limit {TOL[dt]}")
            split = PD.tiered_split(Bt, hkv, sms, tau > 0)
            err, rel = decode_errs(PD.paged_decode_tiered(*targs, tau=tau),
                                   want)
            record("paged_decode_tiered", f"{label}, split {split}", dt, err,
                   extra=extra, rel=rel)
            del targs
        # ---- paged_decode_flat: mobilevlm-3b B=4, Hkv 20, G 1, ctx ~300 -
        q3 = randn(B, H3, 1, HEAD_DIM, dtype=tdt)
        lengths3 = torch.tensor([318, 300, 257, 290], dtype=torch.int32,
                                device=dev)
        kf = randn(B, ML, H3, HEAD_DIM, dtype=tdt)
        vf = randn(B, ML, H3, HEAD_DIM, dtype=tdt, std=0.3)
        tab3 = KT.cold_page_table(lengths3, 0, ML, 128)
        fargs = (q3, kf, vf, lengths3, tab3)
        out = PD.paged_decode_flat(*fargs)
        err, rel = decode_errs(out, PD.paged_decode_flat_plain(*fargs))
        main = None
        if dt == "bfloat16":
            plain = time_ms(lambda: PD.paged_decode_flat_plain(*fargs))
            q4 = q3.reshape(B, H3, 1, HEAD_DIM)
            kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
            live = (torch.arange(ML, device=dev)[None]
                    <= lengths3[:, None].long())[:, None, None]

            def sdpa():
                return F.scaled_dot_product_attention(q4, kt, vt,
                                                      attn_mask=live)
            lib, lib_dev = timed(sdpa)
            n_tok = int((lengths3.long() + 1).sum())
            nbytes = (2 * q3.numel() * es + 2 * n_tok * H3 * HEAD_DIM * es
                      + lengths3.numel() * 4 + tab3.numel() * 4)
            b_ms, b_by = bound(pk, nbytes, 4 * HEAD_DIM * H3 * n_tok, dt)
            ms, dms = timed(lambda: PD.paged_decode_flat(*fargs))
            main = {"shape": f"B {B}, Hkv {H3}, G 1, max_len {ML}, ctx "
                             f"{lengths3.tolist()}, split "
                             f"{PD.flat_split(B, H3, sms)}",
                    "ms": ms, "plain_ms": plain, "library_ms": lib,
                    "library_device_ms": lib_dev,
                    "library_kernels": lib_kernels(sdpa),
                    "device_ms": dms, "bound_ms": b_ms, "bound_by": b_by}
            print(f"[kernels]   paged_decode_flat {main['shape']}: "
                  f"{1e3 * dms:.2f} us device, {ms:.4f} ms call; masked "
                  f"SDPA {1e3 * lib_dev:.2f} us device, {lib:.4f} ms call, "
                  f"kernels {main['library_kernels']}; bound "
                  f"{1e3 * b_ms:.2f} us")
        record("paged_decode_flat", "B=4 Hkv=20 G=1 ctx~300", dt, err, main,
               rel=rel)
        # ragged lengths, a dead page and a ragged tail page (max_len 500)
        for (hkv, g) in ((H3, 1), (KV_HEADS, HEADS // KV_HEADS)):
            ML5 = 500
            qr = randn(B, hkv, g, HEAD_DIM, dtype=tdt)
            kr = randn(B, ML5, hkv, HEAD_DIM, dtype=tdt)
            vr = randn(B, ML5, hkv, HEAD_DIM, dtype=tdt, std=0.3)
            lr = torch.tensor([ML5 - 1, 300, 129, 20], dtype=torch.int32,
                              device=dev)
            tr = KT.cold_page_table(lr, 0, ML5, 128).clone()
            tr[0, 1] = -1
            rargs = (qr, kr, vr, lr, tr)
            err, rel = decode_errs(PD.paged_decode_flat(*rargs),
                                   PD.paged_decode_flat_plain(*rargs))
            record("paged_decode_flat",
                   f"Hkv={hkv} G={g} ragged, dead page, max_len {ML5}", dt,
                   err, rel=rel)
        # positions 0 and 1 and both sides of a page edge; a slot whose
        # last live page is dead (and one with no live page: zeros); every
        # head dim; G up to 16; B * Hkv >= 132 (no split)
        for (label, Bf, hkv, g, Df, MLf, lens, dead) in (
                ("lengths 0,1,127,128", 4, H3, 1, HEAD_DIM, ML,
                 (0, 1, 127, 128), ()),
                ("last live page dead", 4, H3, 1, HEAD_DIM, ML,
                 (300, 200, 260, 129), ((0, 2), (3, 1))),
                ("Hkv=2 G=6 D=64", 4, KV_HEADS, 6, 64, ML,
                 (318, 300, 257, 290), ()),
                ("Hkv=20 G=1 D=64", 4, H3, 1, 64, ML, (318, 0, 127, 511),
                 ()),
                ("Hkv=2 G=7 D=32 max_len 200", 2, 2, 7, 32, 200, (199, 64),
                 ()),
                ("Hkv=1 G=16 D=16, no live page", 2, 1, 16, 16, 100,
                 (99, 31), ((1, 0),)),
                ("B=8 Hkv=20 (B*Hkv=160)", 8, H3, 1, HEAD_DIM, ML,
                 (318, 300, 257, 290, 511, 0, 128, 200), ())):
            qr = randn(Bf, hkv, g, Df, dtype=tdt)
            kr = randn(Bf, MLf, hkv, Df, dtype=tdt)
            vr = randn(Bf, MLf, hkv, Df, dtype=tdt, std=0.3)
            lr = torch.tensor(lens, dtype=torch.int32, device=dev)
            tr = KT.cold_page_table(lr, 0, MLf, 128).clone()
            for (b_, j_) in dead:
                tr[b_, j_] = -1
            rargs = (qr, kr, vr, lr, tr)
            err, rel = decode_errs(PD.paged_decode_flat(*rargs),
                                   PD.paged_decode_flat_plain(*rargs))
            record("paged_decode_flat",
                   f"{label}, split {PD.flat_split(Bf, hkv, sms)}", dt, err,
                   rel=rel)
        del kf, vf, fargs
        # ---- qkv_proj: mobilevlm-3b (MHA, no bias) and fastvlm-1.7b (GQA
        # with bias): decode M = 1, 3, 4 (the GEMV), M = 5 (the first
        # GEMM row count) and prefill M = 256 / 320. In bf16 the kernel,
        # its twin and torch.addmm over the concatenated weight are timed
        # at decode M = 4 and at prefill
        for (tag, D_, ns, bias, M_pre) in (
                ("mobilevlm", D3, (H3 * HEAD_DIM,) * 3, False, 256),
                ("fastvlm", D_MODEL, (HEADS * HEAD_DIM, KV_HEADS * HEAD_DIM,
                                      KV_HEADS * HEAD_DIM), True, 320)):
            wq3 = [randn(D_, n, dtype=tdt, std=0.5 * D_ ** -0.5) for n in ns]
            bq3 = ([randn(n, dtype=tdt, std=0.1) for n in ns] if bias
                   else [None] * 3)
            wcat = torch.cat(wq3, 1)
            bcat = (torch.cat(bq3) if bias else
                    torch.zeros(wcat.shape[1], dtype=tdt, device=dev))
            N = sum(ns)
            for M in (1, 3, 4, 5, M_pre):
                x = randn(M, D_, dtype=tdt)
                err = max(max_err(a, b) for a, b in zip(
                    QK.qkv_proj(x, *wq3, *bq3),
                    QK.qkv_proj_plain(x, *wq3, *bq3)))
                main = None
                if dt == "bfloat16" and M in (4, M_pre):
                    ms, dms = timed(lambda: QK.qkv_proj(x, *wq3, *bq3))
                    lib, lib_dev = timed(lambda: torch.addmm(bcat, x, wcat))
                    b_ms, b_by = bound(
                        pk, (M * D_ + D_ * N + M * N + (N if bias else 0))
                        * es, 2 * M * D_ * N, dt)
                    where = "decode" if M == 4 else "prefill"
                    plain = time_ms(lambda: QK.qkv_proj_plain(x, *wq3, *bq3))
                    results[f"qkv_proj_{tag}_{where}"] = {
                        "M": M, "ms": ms, "device_ms": dms,
                        "plain_ms": plain, "library_ms": lib,
                        "library_device_ms": lib_dev, "bound_ms": b_ms,
                        "bound_by": b_by}
                    if tag == "mobilevlm" and M == 4:
                        main = {"shape": f"x ({M}, {D_}), N 3 x {ns[0]}, "
                                         f"no bias", "ms": ms,
                                "plain_ms": plain, "library_ms": lib,
                                "library_device_ms": lib_dev,
                                "bound_ms": b_ms, "bound_by": b_by,
                                "device_ms": dms}
                    print(f"[kernels]   qkv_proj {tag} {where} M={M}: "
                          f"{1e3 * dms:.1f} us device, {ms:.3f} ms call, "
                          f"plain {plain:.3f} ms; "
                          f"torch.addmm {1e3 * lib_dev:.1f} us device, "
                          f"{lib:.3f} ms call; bound {1e3 * b_ms:.1f} us")
                record("qkv_proj", f"{tag}{' bias' if bias else ''} M={M}",
                       dt, err, main)
            del wq3, wcat
        # ---- ffn_act_int8: mobilevlm-3b silu_gated M=4 and M=256 --------
        def int8w(k, n):
            return torch.randint(-127, 128, (k, n), generator=gen,
                                 device=dev, dtype=torch.int8)
        s_up = torch.full((F3,), D3 ** -0.5 / 127, device=dev)
        s_dn = torch.full((D3,), F3 ** -0.5 / 127, device=dev)
        wq8 = (int8w(D3, F3), s_up, int8w(D3, F3), s_up.clone(),
               int8w(F3, D3), s_dn)
        deq = [FF.dequantize(wq8[i], wq8[i + 1]).bfloat16()
               for i in (0, 2, 4)]
        for M in (4, 256):
            x = randn(M, D3, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * D3 * F3 + 4 * (2 * F3 + D3), chain_of(x, *deq))
            ffn_case("ffn_act_int8", x, wq8, "silu_gated", dt,
                     f"silu_gated M={M}", ffn_form(M, dt), row, M == 4)
        del wq8, deq
        # ---- ffn_act and fused_norm at mobilevlm-3b (path A's shapes) ---
        w3 = (randn(D3, F3, dtype=tdt, std=0.5 * D3 ** -0.5),
              randn(D3, F3, dtype=tdt, std=0.5 * D3 ** -0.5),
              randn(F3, D3, dtype=tdt, std=F3 ** -0.5))
        sc3 = (0.25 + 0.1 * torch.rand(D3, generator=gen, device=dev)).to(tdt)
        for M in (4, 256):
            x = randn(M, D3, dtype=tdt)
            row = None
            if dt == "bfloat16":
                row = (3 * D3 * F3 * es, chain_of(x, *w3))
            ffn_case("ffn_act", x, w3, "silu_gated", dt,
                     f"mobilevlm silu_gated M={M}", ffn_form(M, dt), row)
            record("fused_norm", f"mobilevlm rms M={M}", dt,
                   max_err(FN.fused_norm(x, sc3, None, "rms"),
                           FN.fused_norm_plain(x, sc3, None, "rms")))
        del w3
        # ---- attn_stream at mobilevlm-3b: G = 1, S = L = 256 ------------
        q = randn(1, H3, 256, HEAD_DIM, dtype=tdt)
        k = randn(1, H3, 256, HEAD_DIM, dtype=tdt)
        v = randn(1, H3, 256, HEAD_DIM, dtype=tdt, std=0.4)
        record("attn_stream", "Hkv=20 G=1 causal S=L=256", dt,
               max_err(AS.attn_stream(q, k, v, causal=True),
                       AS.attn_stream_plain(q, k, v, True)))

    # ragged / odd shapes, f32
    tdt = torch.float32
    x = randn(7, 200, dtype=tdt)
    sc, bi = randn(200, dtype=tdt, std=0.3), randn(200, dtype=tdt, std=0.3)
    record("fused_norm", "layer M=7 D=200", "float32",
           max_err(FN.fused_norm(x, sc, bi, "layer"),
                   FN.fused_norm_plain(x, sc, bi, "layer")))
    # attention at every head dim (bf16: the 32- and 64-byte swizzles at
    # Dh 16 and 32), ragged and GQA, causal S < L and not causal
    for dt in ("float32", "bfloat16"):
        for (S, L, causal, Dh) in ((100, 333, True, 128),
                                   (77, 77, False, 64), (5, 40, True, 16),
                                   (40, 72, True, 32)):
            q = randn(2, 6, S, Dh, dtype=getattr(torch, dt))
            k = randn(2, 3, L, Dh, dtype=getattr(torch, dt))
            v = randn(2, 3, L, Dh, dtype=getattr(torch, dt), std=0.4)
            record("attn_stream", f"S={S} L={L} causal={causal} D={Dh}",
                   dt, max_err(AS.attn_stream(q, k, v, causal=causal),
                               AS.attn_stream_plain(q, k, v, causal)))
    # the FFN forms on ragged shapes, f32 and bf16: M 1, 3, 5 (the stream
    # form), 63, 65, 257 (wgmma in bf16, the FMA tiles in f32); D 320 (a
    # ragged last 64-deep tile); F 1000 with weights in the model's type
    # (every activation) and F 1024 with int8 weights (gated and not).
    # Rows that are not whole 16-byte vectors take the FMA tiles at any M:
    # int8 at F 1000 or D 200, bf16 at F 1004
    def int8_ffn(D, F_, gated):
        def q8(*shape):
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)
        su = (0.5 + torch.rand(F_, generator=gen, device=dev)) / (
            127 * D ** 0.5)
        sd = (0.5 + torch.rand(D, generator=gen, device=dev)) / (
            127 * F_ ** 0.5)
        return (q8(D, F_), su, q8(D, F_) if gated else None,
                su.flip(0).contiguous() if gated else None, q8(F_, D), sd)

    for dt in ("float32", "bfloat16"):
        tq = getattr(torch, dt)
        for i, M in enumerate((1, 3, 5, 63, 65, 257)):
            x = randn(M, 320, dtype=tq)
            for kind in ("silu_gated", "gelu", "gelu_gated", "relu2"):
                wu = randn(320, 1000, dtype=tq, std=0.5 * 320 ** -0.5)
                wg = (randn(320, 1000, dtype=tq, std=0.5 * 320 ** -0.5)
                      if kind.endswith("gated") else None)
                wd = randn(1000, 320, dtype=tq, std=1000 ** -0.5)
                ffn_case("ffn_act", x, (wu, wg, wd), kind, dt,
                         f"{kind} M={M} D=320 F=1000", ffn_form(M, dt))
            for gated in (True, False):
                kind = "silu_gated" if gated else ("gelu", "relu2")[i % 2]
                ffn_case("ffn_act_int8", x, int8_ffn(320, 1024, gated), kind,
                         dt, f"{kind} M={M} D=320 F=1024", ffn_form(M, dt))
        for (M, D, F_, kind) in ((5, 320, 1000, "gelu"),
                                 (65, 320, 1000, "relu2"),
                                 (3, 200, 1000, "silu_gated")):
            ffn_case("ffn_act_int8", randn(M, D, dtype=tq),
                     int8_ffn(D, F_, kind == "silu_gated"), kind, dt,
                     f"{kind} M={M} D={D} F={F_} unaligned rows", "fma")
        if dt == "bfloat16":
            for M in (3, 65):
                wu, wg = (randn(320, 1004, dtype=tq, std=0.5 * 320 ** -0.5)
                          for _ in range(2))
                wd = randn(1004, 320, dtype=tq, std=1004 ** -0.5)
                ffn_case("ffn_act", randn(M, 320, dtype=tq), (wu, wg, wd),
                         "silu_gated", dt,
                         f"silu_gated M={M} F=1004 unaligned rows", "fma")
    # ragged rows and column tiles (N = 96 is 3/4 of a 128-wide GEMM tile)
    for dt in ("float32", "bfloat16"):
        tq = getattr(torch, dt)
        for M in (3, 77):
            x = randn(M, 320, dtype=tq)
            ws = [randn(320, n, dtype=tq, std=0.5 * 320 ** -0.5)
                  for n in (96, 32, 32)]
            bs = [randn(n, dtype=tq, std=0.1) for n in (96, 32, 32)]
            record("qkv_proj", f"ragged M={M} N=96/32/32 bias", dt,
                   max(max_err(a, b) for a, b in zip(
                       QK.qkv_proj(x, *ws, *bs),
                       QK.qkv_proj_plain(x, *ws, *bs))))
    results["cases"] = cases
    return results


# ---------------------------------------------------------------------------
# phases 2 and 3: the model through the serving engine
# ---------------------------------------------------------------------------
def _model(arch: str, dtype: str, dev: str = "cuda", **knobs):
    """(cfg, Model, random params from seed 0) at the config's published
    widths; ``knobs`` set config fields (kv_policy, kv_hot_window,
    ffn_weight_store, ...)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import Model

    cfg = get_config(arch).replace(param_dtype=dtype, compute_dtype=dtype,
                                   **knobs)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, model, model.init(gen, device=dev)


# the three serving configurations: (label, arch, config knobs, backend
# knobs, text tokens of a VQA request, kernels the run must launch)
RUNS = (
    ("fastvlm-1.7b tiered", "fastvlm-1.7b",
     dict(kv_policy="tiered", kv_hot_window=128), {}, 192,
     ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
      "paged_decode_tiered")),
    ("A: mobilevlm-3b flat, fused decode", "mobilevlm-3b",
     dict(kv_policy="flat"), dict(fused_decode=True), 112,
     ("fused_norm", "qkv_proj", "attn_stream", "ffn_act",
      "paged_decode_flat")),
    ("B: mobilevlm-3b tiered, int8 FFN", "mobilevlm-3b",
     dict(kv_policy="tiered", kv_hot_window=128, ffn_weight_store="int8"),
     {}, 112,
     ("fused_norm", "qkv_proj", "attn_stream", "ffn_act_int8",
      "paged_decode_tiered")),
)


def _requests(cfg, n_vqa: int, n_text: int, text_with_image: int,
              text_len: int, gen_len: int, seed: int):
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    f = cfg.frontend
    reqs = []
    for i in range(n_vqa + n_text):
        vqa = i % 2 == 0 and i // 2 < n_vqa
        patches = (rng.standard_normal((f.num_tokens, f.frontend_dim))
                   .astype(np.float32) if vqa else None)
        toks = rng.integers(0, cfg.vocab_size,
                            text_with_image if vqa else text_len)
        reqs.append(Request(rid=i, tokens=toks.astype(np.int32),
                            max_new_tokens=gen_len, patches=patches))
    return reqs


def parity_phase(dev: str = "cuda") -> dict:
    """f32 Engine == generate, tie-aware: fastvlm-1.7b over the tiered
    store (hot window 64), mobilevlm-3b on path A (flat store, fused
    decode through the backend knob; `generate` runs the unfused model)
    and on path B (tiered store, hot window 64, int8 FFN weights: the
    tiered decode at G = 1 and `ffn_act_int8` in f32)."""
    out = {}
    for label, arch, knobs, bknobs in (
            ("fastvlm-1.7b tiered", "fastvlm-1.7b",
             dict(kv_policy="tiered", kv_hot_window=64), {}),
            ("A: mobilevlm-3b flat, fused decode", "mobilevlm-3b",
             dict(kv_policy="flat"), dict(fused_decode=True)),
            ("B: mobilevlm-3b tiered, int8 FFN", "mobilevlm-3b",
             dict(kv_policy="tiered", kv_hot_window=64,
                  ffn_weight_store="int8"), {})):
        out[label] = _parity(label, arch, knobs, bknobs, dev)
    out["B preempted"] = _parity_preempt(dev)
    return out


def _parity_preempt(dev) -> dict:
    """f32, path B (hot window 64, int8 FFN), 2 slots and 2 verbatim
    spill lanes: 2 priority-0 VQA requests, then after 3 steps a
    priority-1 text request that preempts one of them. The preempted
    Engine's tokens against the same requests served by an unpressured
    Engine (same backend, equal priorities: nobody is evicted); the
    decode batch is the 2 slots in both, so a verbatim restore should
    give the same tokens bit for bit. A differing token passes only at a
    tie of `generate`'s logits (top-2 margin < 1e-3)."""
    import copy

    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.serving import Engine, LocalBackend

    label = "B preempted"
    cfg, model, params = _model("mobilevlm-3b", "float32", dev,
                                kv_policy="tiered", kv_hot_window=64,
                                ffn_weight_store="int8")
    reqs = _requests(cfg, n_vqa=2, n_text=1, text_with_image=64,
                     text_len=128, gen_len=16, seed=1)
    calm_reqs = copy.deepcopy(reqs)
    (text,) = [r for r in reqs if r.patches is None]
    text.priority = 1
    backend = LocalBackend(model, params, 2, 224, device=dev, n_spill=2,
                           spill_compress=False)
    engine = Engine(backend)
    for r in reqs:
        if r is not text:
            engine.submit(r)
    for _ in range(3):
        engine.step()
    engine.run([text])
    st = engine.stats
    require(st["evictions"] > 0 and st["restores"] == st["evictions"],
            f"{label}: the priority-1 request preempted nothing: {st}")
    calm = Engine(backend)
    calm.run(calm_reqs)
    require(calm.stats["evictions"] == 0, f"{label}: unpressured run "
            f"evicted: {calm.stats}")
    want = {r.rid: r.generated for r in calm.finished}
    ties = 0
    for r in sorted(engine.finished, key=lambda r: r.rid):
        got, ref = r.generated, want[r.rid]
        require(len(got) == len(ref) == r.max_new_tokens,
                f"{label} request {r.rid}: token counts {len(got)}, "
                f"{len(ref)}")
        for t, (a, b) in enumerate(zip(got, ref)):
            if a == b:
                continue
            batch = {"tokens": r.tokens[None]}
            if r.patches is not None:
                batch["patches"] = r.patches[None]
            _, _, logits = generate(model, params, batch, r.prompt_len,
                                    r.max_new_tokens, device=dev,
                                    return_logits=True)
            top2 = logits[0, t].float().topk(2).values
            margin = float(top2[0] - top2[1])
            require(margin < 1e-3,
                    f"{label} request {r.rid} step {t}: preempted token "
                    f"{a} != unpressured {b} with top-2 margin "
                    f"{margin:.3e} (not a tie)")
            ties += 1
            break
        print(f"[parity] {label}: request {r.rid} (priority {r.priority}, "
              f"{r.n_evictions} evictions, prompt {r.prompt_len}): "
              f"preempted == unpressured "
              f"{'(tie-broken)' if got != ref else ''}: {got[:8]}...")
    del engine, calm, backend, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"requests": len(reqs), "tie_breaks": ties,
            "evictions": st["evictions"]}


def _parity(label, arch, knobs, bknobs, dev) -> dict:
    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.serving import Engine, LocalBackend

    cfg, model, params = _model(arch, "float32", dev, **knobs)
    reqs = _requests(cfg, n_vqa=2, n_text=2, text_with_image=64,
                     text_len=128, gen_len=16, seed=1)
    backend = LocalBackend(model, params, 4, 224, device=dev, **bknobs)
    for k, v in bknobs.items():
        require(getattr(backend, k) == v, f"{label}: backend {k} != {v}")
    engine = Engine(backend)
    done = {r.rid: r.generated for r in engine.run(reqs)}
    ties = 0
    for r in reqs:
        batch = {"tokens": r.tokens[None]}
        if r.patches is not None:
            batch["patches"] = r.patches[None]
        # the unfused model: on path A its flat decode is store_read +
        # softmax, so the parity also holds paged_decode_flat against a
        # path that does not run it
        toks, _, logits = generate(model, params, batch,
                                   r.prompt_len, r.max_new_tokens,
                                   device=dev, return_logits=True)
        ref = toks[0].tolist()
        got = done[r.rid]
        require(len(got) == len(ref) == r.max_new_tokens,
                f"{label} request {r.rid}: token counts {len(got)}, "
                f"{len(ref)}")
        for t, (a, b) in enumerate(zip(got, ref)):
            if a == b:
                continue
            top2 = logits[0, t].float().topk(2).values
            margin = float(top2[0] - top2[1])
            require(margin < 1e-3,
                    f"{label} request {r.rid} step {t}: engine token {a} "
                    f"!= generate {b} with top-2 margin {margin:.3e} "
                    f"(not a tie)")
            ties += 1
            break           # the streams legitimately diverge after a tie
        print(f"[parity] {label}: request {r.rid} "
              f"({'VQA' if r.patches is not None else 'text'}, prompt "
              f"{r.prompt_len}): engine == generate "
              f"{'(tie-broken)' if got != ref else ''}: {got[:8]}...")
    del engine, backend, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"requests": len(reqs), "tie_breaks": ties}


def serving_phase(pk: dict, dev: str = "cuda") -> dict:
    """The three bf16 serving runs of RUNS, each with its launch check
    and its chime_sim price, then path B under preemption (PREEMPT_RUNS)."""
    import torch
    out = {}
    for run in RUNS:
        out[run[0]] = serve_run(*run, dev=dev)
        if dev == "cuda":
            torch.cuda.empty_cache()
    a, b = (out[RUNS[i][0]] for i in (1, 2))
    b_chime = b["sim"]["sim_tokens_per_j"]
    print(f"[sim] chime_sim analytic, on the traces this card served: B "
          f"(CHIME mapping) on CHIME {b_chime:.2f} tok/J vs A (flat "
          f"store) on the M3D-DRAM-only platform "
          f"{a['sim_dram_only']['sim_tokens_per_j']:.2f} tok/J (= "
          f"{b_chime / a['sim_dram_only']['sim_tokens_per_j']:.3f}x) and "
          f"on CHIME {a['sim']['sim_tokens_per_j']:.2f} tok/J")
    _, arch, knobs, _, _, _ = RUNS[2]
    built = _model(arch, "bfloat16", dev, **knobs)    # shared by both
    for label, bknobs, eknobs in PREEMPT_RUNS:
        out[label] = preempt_run(label, bknobs, eknobs, pk, built, dev=dev)
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


# path B under priority traffic: (label, backend knobs, engine knobs)
PREEMPT_RUNS = (
    ("B-preempt", dict(spill_compress=False), {}),
    ("B-offload", dict(spill_compress=True), dict(idle_offload_steps=16)),
)


def preempt_run(label, bknobs, eknobs, pk: dict, built,
                dev: str = "cuda") -> dict:
    """Path B at full width and depth, 4 slots and 4 RRAM spill lanes:
    8 priority-0 requests (4 VQA, 4 text; 64 new tokens each), 3 engine
    steps, then 4 priority-1 text requests (64-token prompts, 16 new
    tokens) that preempt runners (the serve CLI's --priority-every
    order). A Telemetry hub records the run; its ledger must reconcile
    exactly with simulated_efficiency, its trace and exposition must
    parse, and the spill lanes' RRAM counters must equal their oracle.
    ``built``: path B's (cfg, Model, params) from `_model`."""
    import json as _json

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import kv_tiers as KT
    from repro_torch.serving import (LocalBackend, Request, Telemetry,
                                     parse_prometheus, slot_kv_bytes,
                                     spill_lane_bytes,
                                     validate_chrome_trace)

    text_with_image, needs = RUNS[2][4:]
    cfg, model, params = built
    max_len = 512
    low = _requests(cfg, n_vqa=4, n_text=4, text_with_image=text_with_image,
                    text_len=256, gen_len=64, seed=2)
    rng = np.random.default_rng(3)
    high = [Request(rid=100 + i, priority=1, max_new_tokens=16,
                    tokens=rng.integers(0, cfg.vocab_size, 64)
                    .astype(np.int32)) for i in range(4)]
    backend = LocalBackend(model, params, 4, max_len, device=dev, n_spill=4,
                           **bknobs)
    require(backend.spill_compress == bknobs["spill_compress"]
            and backend.n_spill == 4, f"{label}: spill knobs not resolved")
    tel = Telemetry()
    engine, step_s, sync = timed_engine(backend, dev, telemetry=tel,
                                        **eknobs)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for r in low:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    engine.run(high)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    done = engine.finished
    res = check_run(label, cfg, model, engine, done, len(low) + len(high),
                    counts, needs)
    st = dict(engine.stats)
    require(st["evictions"] > 0, f"{label}: nothing was preempted: {st}")
    if eknobs.get("idle_offload_steps"):
        require(st["idle_offloads"] > 0,
                f"{label}: no idle offload happened: {st}")
    require(st["restores"] == st["evictions"] + st["idle_offloads"]
            and not engine._spilled
            and all(len(r.evict_times) == len(r.restore_times)
                    for r in done),
            f"{label}: a parked request was not restored: {st}")
    # the lanes' cumulative RRAM counters against their oracle
    sw = engine.pool.state.spill_writes.cpu()
    ctxs = [c for r in done for c in r.evict_ctx]
    require(len(ctxs) == st["evictions"] + st["idle_offloads"]
            and sw.sum(dim=0).tolist() == KT.expected_spill_block_writes(
                sw.shape[1], ctxs).tolist(),
            f"{label}: spill counters {sw.tolist()} != oracle over {ctxs}")
    rep = engine.endurance_report()
    require(rep["total_spill_writes"] == int(sw.sum()),
            f"{label}: endurance report misses spill writes: {rep}")
    timing(label, done, wall, step_s, max_len, res)
    # the ledger, priced live, against the end-of-run price: the same
    # floats (fsum over the same term multiset)
    sim = sim_ledger(label, backend, done)
    led = tel.ledger.totals()
    for k in ("sim_energy_j", "sim_total_s", "sim_spill_energy_j",
              "sim_spill_s", "sim_energy_split_j"):
        require(led[k] == sim[k], f"{label}: ledger {k} {led[k]!r} != "
                f"simulated_efficiency {sim[k]!r}")
    OUT.mkdir(parents=True, exist_ok=True)
    trace = tel.chrome_trace()
    info = validate_chrome_trace(trace)
    require({"evict", "restore", "decode"} <= set(info["phases"]),
            f"{label}: trace phases {info['phases']}")
    (OUT / f"trace_{label}.json").write_text(_json.dumps(trace))
    prom = tel.prometheus()
    samples = parse_prometheus(prom)
    require(samples, f"{label}: empty Prometheus exposition")
    (OUT / f"metrics_{label}.prom").write_text(prom)
    print(f"[spill] {label}: {st['evictions']} preemptions, "
          f"{st['idle_offloads']} idle offloads, {st['restores']} restores "
          f"of {len(done)} requests; spill writes {int(sw.sum())} == "
          f"oracle; write-once OK; ledger reconciles with "
          f"simulated_efficiency: EXACT (dram "
          f"{led['sim_energy_split_j'].get('dram', 0.0):.4g} J, rram "
          f"{led['sim_energy_split_j'].get('rram', 0.0):.4g} J, spill "
          f"{led['sim_spill_energy_j']:.4g} J); trace {info['spans']} "
          f"spans / {info['counters']} counters valid, exposition "
          f"{len(samples)} samples valid")
    # one evict and one restore on the card, beside the least time their
    # bytes need: the slot image read once and the lane written once
    # (evict), the lane read once and the slot written once (restore)
    verbatim = spill_lane_bytes(model, max_len, False)
    compressed = spill_lane_bytes(model, max_len, True)
    require(compressed < verbatim, f"{label}: compressed lane not smaller")
    slot_b = sum(slot_kv_bytes(model, max_len))
    lane_b = backend.spill_lane_bytes()
    state = engine.pool.state
    bound_ms = (slot_b + lane_b) / pk["bw"] * 1e3
    if dev == "cuda":
        ev_ms = event_ms(lambda: backend.evict_slot(state, 0, 0, max_len - 1),
                         n=1, reps=5)
        rs_ms = event_ms(lambda: backend.restore_slot(state, 0, 0),
                         n=1, reps=5)
    else:
        ev_ms = rs_ms = float("nan")
    print(f"[spill] {label}: lane bytes verbatim {verbatim} / compressed "
          f"{compressed} (this run's lanes: {lane_b}); evict_slot "
          f"{ev_ms:.4f} ms, restore_slot {rs_ms:.4f} ms device time "
          f"(CUDA events, median of 5) beside a bound of {bound_ms:.4f} ms "
          f"({slot_b} + {lane_b} bytes at {pk['bw'] / 1e12:.2f} TB/s)")
    res.update({"stats": st, "sim": sim, "spill_writes": int(sw.sum()),
                "lane_bytes_verbatim": verbatim,
                "lane_bytes_compressed": compressed,
                "evict_ms": ev_ms, "restore_ms": rs_ms,
                "spill_bound_ms": bound_ms,
                "trace": {k: info[k] for k in ("spans", "counters")},
                "prometheus_samples": len(samples)})
    return res


def timed_engine(backend, dev: str, **engine_kw):
    """(Engine over ``backend``, list of host-timed decode steps in s,
    sync): each batched decode step timed from a synchronized start to
    its host tokens."""
    import torch

    from repro_torch.serving import Engine

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    step_s = []
    decode = backend.decode_step

    def timed_decode(*a):
        sync()
        t0 = time.perf_counter()
        res = decode(*a)          # returns host tokens: synchronizes
        step_s.append(time.perf_counter() - t0)
        return res

    backend.decode_step = timed_decode
    return Engine(backend, **engine_kw), step_s, sync


def check_run(label, cfg, model, engine, done, n_reqs, counts,
              needs) -> dict:
    """Every request finished with all its tokens, in the vocabulary;
    every layer of every model call launched each of the run's kernels
    once (norms: two a layer and the final one) and nothing else
    launched; on the tiered store a cold page was live and every cold
    slot was written at most once."""
    require(len(done) == n_reqs, f"{label}: not every request finished")
    for r in done:
        require(r.n_generated == r.max_new_tokens,
                f"{label}: request {r.rid} made {r.n_generated} tokens")
        require(all(0 <= t < model.padded_vocab for t in r.generated),
                f"{label}: request {r.rid}: token id out of range")
    n_layers = cfg.num_layers
    ext, dec = engine.stats["extend_calls"], engine.stats["decode_steps"]
    want = {"fused_norm": (2 * n_layers + 1) * (ext + dec),
            "qkv_proj": n_layers * (ext + dec),
            "attn_stream": n_layers * ext,
            "ffn_act": n_layers * (ext + dec),
            "ffn_act_int8": n_layers * (ext + dec),
            "paged_decode_tiered": n_layers * dec,
            "paged_decode_flat": n_layers * dec}
    for k, n in counts.items():
        expect = want[k] if k in needs else 0
        require(n == expect and (k not in needs or n > 0),
                f"{label}: {k} launched {n} times on the main path, "
                f"expected {expect}")
    ctx = max(r.prompt_len + r.n_generated - 1 for r in done)
    res = {"requests": len(done), "max_context": ctx, "launches": counts,
           "extend_calls": ext, "decode_steps_engine": dec}
    if cfg.kv_policy == "tiered":
        rep = engine.endurance_report()
        require(ctx > cfg.kv_hot_window and rep["total_cold_writes"] > 0,
                f"{label}: no cold page was live")
        require(rep["write_once_ok"], f"{label}: endurance violated: {rep}")
        res["cold_writes"] = rep["total_cold_writes"]
    return res


def timing(label, done, wall, step_s, max_len, res) -> None:
    """Step p50/p95 and TTFT of a drained run, into ``res`` and printed."""
    import numpy as np

    from repro_torch.serving import aggregate_metrics

    m = aggregate_metrics(done, wall)
    dec_ms = 1e3 * np.asarray(step_s)
    res.update({"tokens": m["total_tokens"], "wall_s": wall,
                "tok_per_s": m["tok_per_s"],
                "ttft_p50_ms": 1e3 * m["ttft_p50_s"],
                "ttft_p95_ms": 1e3 * m["ttft_p95_s"],
                "decode_step_p50_ms": float(np.percentile(dec_ms, 50)),
                "decode_step_p95_ms": float(np.percentile(dec_ms, 95)),
                "decode_steps": int(dec_ms.size)})
    print(f"[serving] {label} bf16 max_len={max_len}: {res['requests']} "
          f"requests, {res['tokens']} tokens in {wall:.2f} s = "
          f"{res['tok_per_s']:.1f} tok/s; TTFT p50 "
          f"{res['ttft_p50_ms']:.1f} ms p95 {res['ttft_p95_ms']:.1f} ms; "
          f"decode step p50 {res['decode_step_p50_ms']:.2f} ms p95 "
          f"{res['decode_step_p95_ms']:.2f} ms over {res['decode_steps']} "
          f"steps; context {res['max_context']}; launches "
          f"{res['launches']}")


def sim_ledger(label, backend, done, platform=None) -> dict:
    """chime_sim's analytic price of the served trace on ``platform``
    (default CHIME; host arithmetic after the run, nothing measured)."""
    from repro_torch.serving import simulated_efficiency
    from repro_torch.simulator import CHIME

    cfg, comp = backend.sim_context()
    sim = simulated_efficiency(cfg, done, platform or CHIME,
                               spill_compressed=comp,
                               fused_decode=backend.fused_decode,
                               sparse_read_tau=backend.sparse_read_tau)
    split = sim["sim_energy_split_j"]
    print(f"[sim] {label}: chime_sim analytic figure for the "
          f"{sim['platform']} platform (not measured on this card), "
          f"priced on the served trace: {sim['sim_tokens_per_j']:.2f} "
          f"tok/J, {sim['sim_energy_j']:.4f} J, "
          f"{sim['sim_total_s']:.4f} s; split "
          + ", ".join(f"{d} {v:.4g} J" for d, v in split.items())
          + (f"; {sim['sim_spills']} spills, "
             f"{sim['sim_spill_energy_j']:.4g} J" if sim["sim_spills"]
             else ""))
    return sim


def serve_run(label, arch, knobs, bknobs, text_with_image, needs,
              dev: str = "cuda") -> dict:
    from repro_torch import kernels
    from repro_torch.serving import LocalBackend
    from repro_torch.simulator import DRAM_ONLY

    cfg, model, params = _model(arch, "bfloat16", dev, **knobs)
    max_len, gen_len = 512, 64
    reqs = _requests(cfg, n_vqa=4, n_text=4,
                     text_with_image=text_with_image, text_len=256,
                     gen_len=gen_len, seed=2)
    backend = LocalBackend(model, params, 4, max_len, device=dev, **bknobs)
    for k, v in bknobs.items():
        require(getattr(backend, k) == v, f"{label}: backend {k} != {v}")
    engine, step_s, sync = timed_engine(backend, dev)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = check_run(label, cfg, model, engine, done, len(reqs), counts,
                    needs)
    timing(label, done, wall, step_s, max_len, res)
    res["sim"] = sim_ledger(label, backend, done)
    res["sim_dram_only"] = sim_ledger(label, backend, done, DRAM_ONLY)
    if dev == "cuda":
        res["profile"] = profile_decode(label, model, params, cfg,
                                        text_with_image, bknobs, dev)
        res["prefill_profile"] = profile_prefill(label, model, params, cfg,
                                                 bknobs, dev)
    del engine, backend, params
    return res


# the device kernels of each wrapper of which one call launches exactly
# one (the FFN's second kernel, its reduction or phase 2, is not counted);
# the two FFN wrappers share their kernels' names
HEAD_KERNELS = {
    ("fused_norm",): ("fused_norm_kernel",),
    ("qkv_proj",): ("qkv_gemv_kernel", "qkv_wgmma_kernel", "qkv_fma_kernel"),
    ("attn_stream",): ("attn_wgmma_kernel", "attn_fma_kernel"),
    ("ffn_act", "ffn_act_int8"): ("ffn_stream_mma_kernel", "ffn_up_kernel",
                                  "ffn_act_kernel"),
    ("paged_decode_tiered",): ("paged_decode_tiered_kernel",),
    ("paged_decode_flat",): ("paged_decode_flat_kernel",)}


def profile_launch_check(label, what, rows, counts) -> dict:
    """Each wrapper's launches in a profile (its head kernels' counts in
    ``rows``) against its Python launch counter over the same window
    (``counts``); a mismatch is printed and recorded, not fatal: the
    counters are the record, the profile's times rest on its counts."""
    out = {}
    for wrappers, names in HEAD_KERNELS.items():
        want = sum(counts[w] for w in wrappers)
        got = sum(c for k, c, _ in rows if any(n in k for n in names))
        out["+".join(wrappers)] = {"counter": want, "profile": got}
        if got != want:
            print(f"[profile] {label} {what}: MISMATCH {'+'.join(wrappers)} "
                  f"launched {want} times (counter), {got} in the profile")
    if all(v["counter"] == v["profile"] for v in out.values()):
        print(f"[profile] {label} {what}: every kernel's launches in the "
              f"profile equal its counter")
    return out


def lead_in() -> None:
    """The start of a profiled window, before its measured work: a ~0.5 ms
    spin kernel, synchronized. The profiler's device tracing starts a
    little after the window opens and may drop the first kernels
    launched in it (the first layer's norm and projection); the spin
    kernel takes that place and is left out of the rows
    (`device_rows`)."""
    import torch
    torch.cuda._sleep(1_000_000)
    torch.cuda.synchronize()


def device_rows(prof) -> list:
    """(kernel, launches, device ms) of a profiled window: device-side
    events only (kernels, memcpy, memset; the aten ops that launched them
    carry the same device time again), the lead-in's spin kernel left
    out, longest first."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin_kernel" not in e.key]
    return sorted(rows, key=lambda r: -r[2])


def profile_decode(label, model, params, cfg, text_with_image, bknobs,
                   dev: str = "cuda", n_steps: int = 8) -> dict:
    """Device time by kernel over ``n_steps`` steady decode steps of 4
    slots (prompts of 256, max_len 512), from torch.profiler; the idle
    share is 1 - kernel time / wall time of the window. Runs after the
    main path's launch counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.serving import Engine, LocalBackend

    reqs = _requests(cfg, n_vqa=2, n_text=2,
                     text_with_image=text_with_image, text_len=256,
                     gen_len=4 * n_steps, seed=3)
    engine = Engine(LocalBackend(model, params, 4, 512, device=dev,
                                 **bknobs))
    for r in reqs:
        engine.submit(r)
    while engine._inflight is not None or engine.scheduler.pending \
            or int(engine._active.sum()) < len(reqs):
        engine.step()
    for _ in range(2):
        engine.step()                      # steady state: decode only
    torch.cuda.synchronize()
    # the run's paged decode: its last call at the ops layer (the model
    # layout's adapter, which counts nothing; the kernel's wrapper is left
    # as it is) is kept, to time the kernel alone at this decode shape
    # after the window
    kern_name = ("paged_decode_tiered" if cfg.kv_policy == "tiered"
                 else "paged_decode_flat")
    adapter, seen = getattr(ops, kern_name), {}

    def keep(q, k_store, v_store, pos, **kw):
        seen["call"] = (q, k_store, v_store,
                        pos.clone() if torch.is_tensor(pos) else pos, kw)
        return adapter(q, k_store, v_store, pos, **kw)
    kernels.reset_launch_counts()
    setattr(ops, kern_name, keep)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        setattr(ops, kern_name, adapter)
    counts = kernels.launch_counts()
    rows = device_rows(prof)
    dev_ms = sum(r[2] for r in rows)
    launch_check = profile_launch_check(label, "decode", rows, counts)
    q, k_store, v_store, pos, kw = seen["call"]
    a, kw = getattr(ops, f"{kern_name}_operands")(q, k_store, v_store, pos,
                                                  **kw)
    kern = getattr(PD, kern_name)
    hits = [(c, t) for k, c, t in rows if f"{kern_name}_kernel" in k]
    alone = {"kernel": kern_name,
             "shape": f"q {tuple(a[0].shape)}, lengths {a[-2].tolist()}",
             "profile_us_per_launch": 1e3 * sum(t for _, t in hits)
             / max(sum(c for c, _ in hits), 1),
             "device_us": 1e3 * device_ms(lambda: kern(*a, **kw)),
             "event_us": 1e3 * event_ms(lambda: kern(*a, **kw))}
    print(f"[profile] {label}: {kern_name} at the decode shape "
          f"({alone['shape']}): {alone['profile_us_per_launch']:.2f} us a "
          f"launch in the profile; alone {alone['device_us']:.2f} us "
          f"(profiler), {alone['event_us']:.2f} us (CUDA events)")
    name = label.split(":")[0].replace(" ", "_")
    (OUT / f"decode_profile_{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=80))
    out = {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": dev_ms / n_steps,
           "device_launches_per_step": sum(r[1] for r in rows) / n_steps,
           "idle_share": 1 - dev_ms / wall_ms if wall_ms else None,
           "launch_check": launch_check, "decode_kernel_alone": alone,
           "top": [{"kernel": k[:90], "launches_per_step": c / n_steps,
                    "ms_per_step": t / n_steps} for k, c, t in rows[:14]]}
    print(f"[profile] {label}: decode step (4 slots, ctx ~256-290): wall "
          f"{out['wall_ms_per_step']:.2f} ms, device busy "
          f"{out['device_ms_per_step']:.2f} ms in "
          f"{out['device_launches_per_step']:.0f} launches, idle share "
          f"{out['idle_share']:.3f}")
    for r in out["top"]:
        print(f"[profile]   {r['ms_per_step']:8.3f} ms/step "
              f"{r['launches_per_step']:6.1f} launches/step  {r['kernel']}")
    return out


def profile_prefill(label, model, params, cfg, bknobs, dev: str = "cuda",
                    prompt: int = 256) -> dict:
    """Device time by kernel of one whole-prompt extend (a 256-token text
    prompt, committed into slot 0 of a fresh 4-slot pool, max_len 512)
    under torch.profiler, after one warm-up call; the busy share is
    kernel time / wall time of the call. Runs after the main path's
    launch counts were read."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.serving import LocalBackend

    backend = LocalBackend(model, params, 4, 512, device=dev, **bknobs)
    state = backend.init_pool()
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, prompt)
    batch = {"tokens": toks.astype(np.int32)[None]}

    def call():
        return backend.extend_step(batch, state, backend.fresh_extend(), 0,
                                   0, prompt, True)
    call()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = kernels.launch_counts()
    rows = device_rows(prof)
    dev_ms = sum(r[2] for r in rows)
    launch_check = profile_launch_check(label, "prefill", rows, counts)
    name = label.split(":")[0].replace(" ", "_")
    (OUT / f"prefill_profile_{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=80))
    out = {"prompt": prompt, "wall_ms": wall_ms, "device_ms": dev_ms,
           "launch_check": launch_check,
           "device_launches": sum(r[1] for r in rows),
           "busy_share": dev_ms / wall_ms if wall_ms else None,
           "top": [{"kernel": k[:90], "launches": c, "ms": t}
                   for k, c, t in rows[:14]]}
    print(f"[profile] {label}: prefill extend ({prompt} tokens): wall "
          f"{wall_ms:.2f} ms, device busy {dev_ms:.2f} ms in "
          f"{out['device_launches']} launches, busy share "
          f"{out['busy_share']:.3f}")
    for r in out["top"]:
        print(f"[profile]   {r['ms']:8.3f} ms {r['launches']:5d} launches  "
              f"{r['kernel']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,parity,serving")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    # f32 references are full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    pk = peaks(name)
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(built)} kernel libraries built in {build_s:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "kernel_build.log").write_text(
        "\n".join(f"=== {k}\n{v}" for k, v in build.build_logs.items()))
    for k, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"[ptxas] {k}: {line.strip()}")

    report = {"card": card, "build_s": build_s, "phase_s": {}}
    kern = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        report["phase_s"][name] = time.perf_counter() - t
        print(f"[time] {name} phase: {report['phase_s'][name]:.1f} s")
        return out

    if "kernels" in phases:
        report["sass"] = sass_check()
        kern = timed("kernels", kernel_phase, pk)
    if "parity" in phases:
        report["parity"] = timed("parity", parity_phase)
    if "serving" in phases:
        report["serving"] = timed("serving", serving_phase, pk)
    launches = {k: sum(run["launches"].get(k, 0)
                       for run in report.get("serving", {}).values())
                for k in REPLACES}
    rows = []
    for k in REPLACES:
        if k not in kern:
            continue
        r = kern[k]
        rows.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "tpu_kernel": REPLACES[k],
            "launches": launches.get(k, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"],
            "device_ms": r["device_ms"], "host_ms": r["ms"] - r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "library_kernels": r.get("library_kernels"),
            "shape": r["shape"], "dtype": r["dtype"]})
        # the FFN's other timed shapes (decode at the other model, the
        # prefill tiles), each beside its bound and the cuBLAS chain
        rows[-1]["forms"] = [
            {f: fr[f] for f in ("shape", "variant", "device_ms", "ms",
                                "bound_ms", "bound_by", "chain_device_ms",
                                "chain")}
            for fr in kern.get("ffn_rows", []) if fr["name"] == k] + [
            {f: fr[f] for f in ("shape", "device_ms", "event_ms", "ms",
                                "plain_ms", "bound_ms", "bound_by")}
            for fr in kern.get("extra_rows", []) if fr["name"] == k]
        if "event_ms" in r:
            rows[-1]["event_ms"] = r["event_ms"]
    report["kernels"] = rows
    report["kernel_cases"] = kern.get("cases", {})
    for k in ("ffn_rows", "extra_rows", "tiles", "fused_norm_mobilevlm",
              *(f"qkv_proj_{t}_{w}" for t in ("mobilevlm", "fastvlm")
                for w in ("decode", "prefill"))):
        report[k] = kern.get(k)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
