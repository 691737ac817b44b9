#!/usr/bin/env python3
"""Sweep the launch choices of the port's bf16 kernels on the card.

    python3 kernel_sweep.py          # one CUDA card, from the repository root
    python3 kernel_sweep.py --only flat,norm,host
    python3 kernel_sweep.py --only ffn
    python3 kernel_sweep.py --only tiered
    python3 kernel_sweep.py --only host --src OTHER/src   # another tree's
                                                          # fused_norm wrapper

The planners in `src/repro_torch/kernels` pick, per call, how
`attn_stream` splits a query tile's key tiles over a cluster
(`attn_stream.kv_split`), how the decode GEMV of `qkv_proj` splits D
(`qkv_proj.gemv_split`) and how many warpgroups a block of its prefill
GEMM has (`qkv_proj.gemm_warpgroups`). This script times every choice at
the serving shapes of fastvlm-1.7b and mobilevlm-3b, with the library
call computing the same function beside it (SDPA with GQA; torch.addmm
over the concatenated weight), and checks each choice against the plain
twin (bf16, 2e-2). Device times are torch.profiler kernel time a call
(`chip_smoke.device_ms`). The GEMV is timed warm (the same weights every
call, which then sit in the 50 MB L2) and cold (four weight sets in
turn, 157 MB at mobilevlm-3b: each call reads its weights from HBM, as
a decode step does).

It also times every key split (`paged_decode.flat_split`) of the flat
paged decode at mobilevlm-3b's decode shape (B 4, Hkv 20, G 1, ctx
257-318, a full 511-token context, and one key a slot: the kernel's
fixed cost; warm, and cold over four stores) beside SDPA with a boolean
length mask; every key split (`paged_decode.tiered_split`) of the
tiered paged decode at both tiered decode shapes (fastvlm-1.7b: B 4, Hkv
2, G 6; mobilevlm-3b path B: B 4, Hkv 20, G 1; hot window 128, ctx
257-318 and a full 511-token context; warm, and cold over four stores);
every threads-a-row choice (`fused_norm.threads_per_row`)
of `fused_norm` at D 1536 and 2560 beside `F.rms_norm`; and where
`fused_norm`'s host time goes: host µs a call over back-to-back calls
(time.perf_counter_ns; the card keeps up), for the wrapper,
`F.rms_norm`, and each part of the wrapper. With ``--src`` the host
section times that tree's `repro_torch` wrapper instead (the parent's,
to compare).

The ffn section times every plan of the FFN kernels (`ffn_act`,
`ffn_act_int8`) at fastvlm-1.7b (D 1536, F 8960) and mobilevlm-3b (D
2560, F 6912), bf16 and int8 weights: the decode stream form at M 4 for
every D split x cluster size (`ffn_act.stream_plan`), warm and cold
(four weight sets in turn: each call reads its weights from HBM, as a
decode step does), and the prefill wgmma form at M 256 (and 320 at
fastvlm) for every tile height x phase-2 F split (`ffn_act.wgmma_plan`),
beside the cuBLAS chain mm, mm, silu * mul, mm on the same (int8:
pre-dequantized) weights -- a chain of kernels, not one call. The host
section also breaks down the host time of an `ffn_act` / `ffn_act_int8`
call at decode (x (4, D), a narrow F so the card keeps up).

The tf32 section times the f32 forms of `attn_stream`, then those of
`ffn_act` and `qkv_proj`. `attn_stream`: "fma" against "tf32x3" (each
forced by swapping `attn_stream.TF32X3_HEAD_DIMS`, the form that ran
asserted, each within 1e-4 of the largest element of the plain twin)
over S from 1 to 512 query rows at Dh 128 (H 12, Hkv 2), Dh 64 (H 14,
Hkv 2) and Dh 160 (stablelm-12b: H 32, Hkv 8), causal, as a prefill (L
= S) and as an extend over 256 cached keys (L = S + 256); for each, the
calls where fma was the faster and by how much (the f32 dispatch takes
tf32x3 at every S of these head dims); and at the training shape (8, 12, 256, 128), 2 kv heads, both forms' device and
CUDA-event µs and the µs of each kernel of a call (the split, the
attention), beside SDPA in f32 (TF32 off) and the bounds at the f32
CUDA-core and 3xTF32 rates. `ffn_act` and `qkv_proj` at fastvlm-1.7b's
widths (D 1536, F 8960; N 1536 / 256 / 256 with bias) over M from 16 to
the training path's 2048 rows: the CUDA-core "fma" form and the 3xTF32
tensor-core "tf32x3" form at every M (each forced by swapping the
module's TF32X3_MIN_M, the form that ran asserted), each checked
against its plain twin (f32, TF32 off, 1e-4 of the largest element),
beside the cuBLAS chain / torch.addmm x 3; the crossing sets
`TF32X3_MIN_M`; at M 2048 the device µs of each kernel of a call (the
split, the GEMMs). Then every phase-2 F split of the FFN's tf32x3 form
(`ffn_act.tf32x3_plan`) at M 2048 and 320, and ptxas's registers,
spills and injected waits (C7517) for the tf32 kernel functions of all
three libraries.

It prints the card's name and power limit first and writes
chiprun_out/kernel_sweep.json (kernel_sweep_host.json for ``--only
host``, kernel_sweep_tf32.json for ``--only tf32``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SECTIONS = ("attn", "qkv", "flat", "tiered", "norm", "host", "ffn",
            "tf32")


@contextlib.contextmanager
def swapped(module, name: str, planner):
    """``module.name`` replaced by ``planner`` inside the block. The
    module's cached wrapper plan (`_plan`, where it is an lru_cache) is
    cleared on entry and on exit, so each call plans anew."""
    old = getattr(module, name)
    clear = getattr(getattr(module, "_plan", None), "cache_clear",
                    lambda: None)
    setattr(module, name, planner)
    clear()
    try:
        yield
    finally:
        setattr(module, name, old)
        clear()


def host_us(fn, n: int = 3000) -> float:
    """Host µs a call: ``n`` calls back to back, then one synchronize.
    Every call here launches at most one kernel of a few µs, so the card
    keeps up and the time is the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return t / n / 1e3


def norm_host_breakdown(FN, build, x, sc) -> dict:
    """Where the host time of one rms `fused_norm(x, sc)` call goes. The
    parts of the wrapper are timed alone; "rest" is the wrapper less
    their sum (the calls between them, the launch counter). A tree whose
    wrapper has no `_plan` (the parent's) gets its own statements timed:
    the ctypes call and launch are then its rest."""
    import torch
    import torch.nn.functional as F
    M, D = x.shape
    out = {"shape": f"x ({M}, {D}) {x.dtype}",
           "wrapper_us": host_us(lambda: FN.fused_norm(x, sc, None)),
           "rms_norm_us": host_us(lambda: F.rms_norm(x, (D,), sc, 1e-6))}
    parts = {}
    if hasattr(FN, "_plan"):
        px, ps, pb, M_, D_, xs, mode, dev = FN._plan(x, sc, None, 0)
        o = torch.empty_like(x)
        stream = torch._C._cuda_getCurrentRawStream(dev)
        parts["plan: checks, variant, threads"] = host_us(
            lambda: FN._plan(x, sc, None, 0))
        parts["torch.empty_like"] = host_us(lambda: torch.empty_like(x))
        parts["current stream"] = host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev))
        parts["C entry: ctypes call + launch"] = host_us(
            lambda: FN._entry(px, ps, pb, o.data_ptr(), M, D, xs, 1e-6, mode,
                              stream))
    else:
        parts["checks: torch.device, shape, contiguity"] = host_us(
            lambda: (sc.device != x.device, sc.shape != (D,),
                     sc.is_contiguous(), x.stride(-1) != 1))
        parts["build.bind lookup"] = host_us(
            lambda: build.bind("fused_norm", "fused_norm", FN.ARGTYPES))
        parts["torch.empty(dtype=, device=)"] = host_us(
            lambda: torch.empty((M, D), dtype=x.dtype, device=x.device))
        parts["args: ptrs, strides, dtype codes, stream"] = host_us(
            lambda: (build.ptr(x), build.ptr(sc), build.ptr(x), x.stride(0),
                     x.stride(0), build.dtype_code(x.dtype),
                     build.dtype_code(sc.dtype),
                     build.stream_ptr(x.device)))
    out["parts_us"] = parts
    out["rest_us"] = out["wrapper_us"] - sum(parts.values())
    return out


def ffn_host_breakdown(FF, build, x, w, int8: bool) -> dict:
    """Where the host time of one silu_gated `ffn_act` (``int8``:
    `ffn_act_int8`) call on x and the weight operands ``w`` goes, as
    `norm_host_breakdown` does for `fused_norm`. A tree whose wrapper has
    no `_pointers` (the parent's) gets its own statements timed: the
    ctypes call and launches are then its rest."""
    import torch
    name = "ffn_act_int8" if int8 else "ffn_act"
    kern = getattr(FF, name)
    M, D = x.shape
    F_ = w[0].shape[1]
    out = {"shape": f"{name} x ({M}, {D}) {x.dtype}, F {F_}",
           "wrapper_us": host_us(lambda: kern(x, *w, "silu_gated"))}
    if int8:
        i8, f32 = torch.int8, torch.float32
        ops = (("w_up_q", w[0], (D, F_), i8), ("w_up_scale", w[1], (F_,), f32),
               ("w_gate_q", w[2], (D, F_), i8),
               ("w_gate_scale", w[3], (F_,), f32),
               ("w_down_q", w[4], (F_, D), i8),
               ("w_down_scale", w[5], (D,), f32))
    else:
        ops = (("w_up", w[0], (D, F_), x.dtype),
               ("w_gate", w[1], (D, F_), x.dtype),
               ("w_down", w[2], (F_, D), x.dtype))
    parts = {}
    if hasattr(FF, "_pointers"):
        dev = x.get_device()
        ptrs = FF._pointers(name, dev, ops)
        code, _, plan, shape, sdt = FF._plan(M, D, F_, True, 3, True, dev)
        scratch, o = x.new_empty(shape, dtype=sdt), torch.empty_like(x)
        fn = FF._entry(name, FF.INT8_ARGTYPES if int8 else FF.ARGTYPES)
        stream = torch._C._cuda_getCurrentRawStream(dev)
        parts["checks + addresses (_pointers)"] = host_us(
            lambda: FF._pointers(name, dev, ops))
        parts["plan (cached)"] = host_us(
            lambda: FF._plan(M, D, F_, True, 3, True, dev))
        parts["scratch + out: new_empty, empty_like"] = host_us(
            lambda: (x.new_empty(shape, dtype=sdt), torch.empty_like(x)))
        parts["current stream"] = host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev))
        parts["C entry: ctypes call + launches"] = host_us(
            lambda: fn(x.data_ptr(), *ptrs, scratch.data_ptr(), o.data_ptr(),
                       M, D, F_, 0, 1, code, *plan, stream))
    else:
        parts["require_operands"] = host_us(
            lambda: build.require_operands(name, x.device, {
                n: (t, sh, dt) for (n, t, sh, dt) in ops}))
        parts["f_chunking + sm_count"] = host_us(
            lambda: FF.f_chunking(M, F_, build.sm_count(x.device.index),
                                 D))
        parts["2 x torch.empty(dtype=, device=)"] = host_us(
            lambda: (torch.empty((8, M, D), dtype=torch.float32,
                                 device=x.device),
                     torch.empty((M, D), dtype=x.dtype, device=x.device)))
        parts["build.bind lookup"] = host_us(
            lambda: build.bind(name, name, FF.INT8_ARGTYPES if int8
                               else FF.ARGTYPES))
    out["parts_us"] = parts
    out["rest_us"] = out["wrapper_us"] - sum(parts.values())
    return out


def host_section(res: dict, build) -> None:
    """The host breakdowns of `fused_norm` and the FFN wrappers at decode
    (x (4, D) bf16; the FFN at F 1024, narrow enough that the card keeps
    up with back-to-back calls) into res["fused_norm_host"] and
    res["ffn_host"]."""
    import torch

    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import fused_norm as FN
    g = torch.Generator(device="cuda").manual_seed(0)
    for D in (1536, 2560):
        x = torch.randn(4, D, generator=g, device="cuda").bfloat16()
        sc = torch.rand(D, generator=g, device="cuda").bfloat16()
        res["fused_norm_host"].append(norm_host_breakdown(FN, build, x, sc))
        print(f"[sweep] fused_norm host {res['fused_norm_host'][-1]}",
              flush=True)
    F_ = 1024
    for (D, int8) in ((1536, False), (2560, True)):
        x = torch.randn(4, D, generator=g, device="cuda").bfloat16()
        if int8:
            def q8(*s_):
                return torch.randint(-127, 128, s_, generator=g,
                                     device="cuda", dtype=torch.int8)
            su = torch.full((F_,), D ** -0.5 / 127, device="cuda")
            w = (q8(D, F_), su, q8(D, F_), su.clone(), q8(F_, D),
                 torch.full((D,), F_ ** -0.5 / 127, device="cuda"))
        else:
            w = tuple((torch.randn(*sh, generator=g, device="cuda")
                       * 0.02).bfloat16() for sh in ((D, F_), (D, F_),
                                                     (F_, D)))
        res["ffn_host"].append(ffn_host_breakdown(FF, build, x, w, int8))
        print(f"[sweep] ffn host {res['ffn_host'][-1]}", flush=True)


def kernel_us(fn, reps: int = 10) -> dict:
    """Device µs a call of each kernel ``fn`` launches (torch.profiler,
    ``reps`` calls between chip_smoke's spin kernels)."""
    import torch
    from torch.autograd import DeviceType

    import chip_smoke as CS
    fn()
    torch.cuda.synchronize()
    with CS.device_profile() as prof:
        CS.lead_in()
        for _ in range(reps):
            fn()
        CS.lead_out()
    return {e.key[:60]: e.self_device_time_total / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count
            and "spin_kernel" not in e.key}


def attn_tf32_section(out: dict, CS, save) -> None:
    """attn_stream's f32 forms (see the module docstring), into
    out["attn_tf32"]: fma against tf32x3 over S at Dh 128, 64 and 160,
    where fma wins, and the training shape."""
    import torch

    from repro_torch.kernels import attn_stream as AS
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    res = out.setdefault("attn_tf32", {"rows": [], "fma_wins": {}})
    forms = {"fma": (), "tf32x3": AS.TF32X3_HEAD_DIMS}
    for Dh, H, Hkv in ((128, 12, 2), (64, 14, 2), (160, 32, 8)):
        for mode, extra in (("prefill", 0), ("extend", 256)):
            times = {}
            for S in (1, 8, 16, 32, 48, 63, 64, 96, 128, 192, 256, 320,
                      512):
                L = S + extra
                q, k = rn(1, H, S, Dh), rn(1, Hkv, L, Dh)
                v = rn(1, Hkv, L, Dh, std=0.4)
                ref = AS.attn_stream_plain(q, k, v, True)
                row = {"Dh": Dh, "H": H, "Hkv": Hkv, "S": S, "L": L}
                for form, lim in forms.items():
                    with swapped(AS, "TF32X3_HEAD_DIMS", lim):
                        err = rel(AS.attn_stream(q, k, v, causal=True), ref)
                        CS.require(AS.attn_stream.variant == form,
                                   f"attn_stream S {S}: ran "
                                   f"{AS.attn_stream.variant}")
                        CS.require(err <= 1e-4, f"attn_stream {form} Dh "
                                   f"{Dh} S {S} L {L} off its twin: {err}")
                        row[f"{form}_err"] = err
                        row[f"{form}_us"] = 1e3 * CS.device_ms(
                            lambda: AS.attn_stream(q, k, v, causal=True))
                times[S] = (row["fma_us"], row["tf32x3_us"])
                res["rows"].append(row)
                save()
                print(f"[sweep] attn tf32 {row}", flush=True)
            # the calls fma ran faster, with its lead in µs
            res["fma_wins"][f"Dh{Dh} {mode}"] = {
                S: t - f for S, (f, t) in times.items() if f < t}
    print(f"[sweep] attn tf32 calls where fma wins (S: µs ahead): "
          f"{res['fma_wins']}", flush=True)
    # the training shape: both forms, SDPA in f32 (TF32 off), the bound
    B, H, Hkv, S, Dh = 8, 12, 2, 256, 128
    q, k, v = rn(B, H, S, Dh), rn(B, Hkv, S, Dh), rn(B, Hkv, S, Dh)
    ref = AS.attn_stream_plain(q, k, v, True)
    pk = CS.peaks(CS.card_line())
    nbytes = 2 * B * (H + Hkv) * S * Dh * 4
    flops = 4 * B * H * Dh * S * (S + 1) // 2
    row = {"shape": f"q ({B}, {H}, {S}, {Dh}), kv heads {Hkv}, causal",
           "bound_us_cuda_cores": 1e3 * CS.bound(pk, nbytes, flops,
                                                 "float32")[0],
           "bound_us_tf32x3": 1e3 * CS.bound(pk, nbytes, flops,
                                             "tf32x3")[0]}
    sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    row["sdpa_us"] = 1e3 * CS.device_ms(sdpa)
    row["sdpa_event_us"] = 1e3 * CS.event_ms(sdpa)
    for form, lim in forms.items():
        with swapped(AS, "TF32X3_HEAD_DIMS", lim):
            def call():
                return AS.attn_stream(q, k, v, causal=True)
            row[f"{form}_err"] = rel(call(), ref)
            CS.require(AS.attn_stream.variant == form
                       and row[f"{form}_err"] <= 1e-4,
                       f"attn_stream training shape {form}: {row}")
            row[f"{form}_us"] = 1e3 * CS.device_ms(call)
            row[f"{form}_event_us"] = 1e3 * CS.event_ms(call)
            row[f"{form}_kernels_us"] = kernel_us(call)
    res["training"] = row
    save()
    print(f"[sweep] attn tf32 training shape {row}", flush=True)


def tf32_section(out: dict, CS, build, save) -> None:
    """The f32 forms' crossing and the tf32x3 form's phase-2 split (see
    the module docstring), into out["tf32"]."""
    import torch

    from repro_torch.kernels import ffn_act as FF
    from repro_torch.kernels import qkv_proj as QK
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    D, F_, ns = 1536, 8960, (1536, 256, 256)

    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std
    wf = (rn(D, F_, std=D ** -0.5), rn(D, F_, std=D ** -0.5),
          rn(F_, D, std=F_ ** -0.5))
    wq = [rn(D, n, std=D ** -0.5) for n in ns]
    bq = [rn(n, std=0.1) for n in ns]
    wcat, bcat = torch.cat(wq, 1), torch.cat(bq)
    rows = out.setdefault("tf32", [])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    forms = {"fma": 10 ** 9, "tf32x3": 1}
    for M in (16, 32, 48, 64, 96, 128, 192, 256, 320, 2048):
        x = rn(M, D)
        ref_f = FF.ffn_act_plain(x, *wf)
        ref_q = QK.qkv_proj_plain(x, *wq, *bq)
        row = {"M": M, "ffn_chain_us": 1e3 * CS.device_ms(
                   lambda: (torch.nn.functional.silu(x @ wf[0])
                            * (x @ wf[1])) @ wf[2]),
               "qkv_addmm_us": 1e3 * CS.device_ms(
                   lambda: [torch.addmm(b, x, w) for w, b in zip(wq, bq)]),
               "qkv_split_bound": 3 * 2.0 ** -22 * float(
                   (x.abs() @ wcat.abs()).max()
                   / torch.addmm(bcat, x, wcat).abs().max())}
        for form, lim in forms.items():
            with swapped(FF, "TF32X3_MIN_M", lim), \
                    swapped(QK, "TF32X3_MIN_M", lim):
                e_f = rel(FF.ffn_act(x, *wf), ref_f)
                CS.require(FF.ffn_act.variant == form,
                           f"ffn_act M {M}: ran {FF.ffn_act.variant}")
                e_q = max(rel(a, b) for a, b in zip(
                    QK.qkv_proj(x, *wq, *bq), ref_q))
                CS.require(QK.qkv_proj.variant == form,
                           f"qkv_proj M {M}: ran {QK.qkv_proj.variant}")
                row[f"ffn_{form}_err"], row[f"qkv_{form}_err"] = e_f, e_q
                row[f"ffn_{form}_us"] = 1e3 * CS.device_ms(
                    lambda: FF.ffn_act(x, *wf))
                row[f"qkv_{form}_us"] = 1e3 * CS.device_ms(
                    lambda: QK.qkv_proj(x, *wq, *bq))
        if M == 2048:
            row["ffn_tf32x3_kernels_us"] = kernel_us(
                lambda: FF.ffn_act(x, *wf))
            row["qkv_tf32x3_kernels_us"] = kernel_us(
                lambda: QK.qkv_proj(x, *wq, *bq))
        rows.append(row)
        save()
        print(f"[sweep] tf32 {row}", flush=True)
        CS.require(max(v for k, v in row.items() if k.endswith("_err"))
                   <= 1e-4, f"f32 forms at M {M} off their twins: {row}")
    for M in (320, 2048):
        x = rn(M, D)
        ref_f = FF.ffn_act_plain(x, *wf)
        row = {"M": M, "planned (ks, k_chunk)":
               FF.tf32x3_plan(M, D, F_, build.sm_count(0))[:2]}
        steps = -(-F_ // FF.TF32_BK)
        for ks in (1, 2, 3, 4, 6, 8):
            kc = -(-steps // ks) * FF.TF32_BK
            if -(-F_ // kc) != ks:
                continue
            with swapped(FF, "tf32x3_plan", lambda *a, _p=(ks, kc, 0): _p):
                err = rel(FF.ffn_act(x, *wf), ref_f)
                row[f"ks{ks}_us"] = (1e3 * CS.device_ms(
                    lambda: FF.ffn_act(x, *wf)) if err <= 1e-4
                    else f"error {err}")
        rows.append(row)
        save()
        print(f"[sweep] tf32 ffn phase-2 split {row}", flush=True)
    for name in ("attn_stream", "ffn_act", "qkv_proj"):
        lines = build.build_logs.get(name, "").splitlines()
        for i, line in enumerate(lines):
            if "tf32" in line and "Compiling entry" in line:
                print(f"[sweep] ptxas {name}: {line.strip()} :: "
                      + " | ".join(v.strip() for v in lines[i + 1:i + 4]))
            elif "C7517" in line and "tf32" in line:
                print(f"[sweep] ptxas {name}: {line.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help=f"sections to run, of {SECTIONS}")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is imported")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device; this sweep runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import build

    print(CS.card_line())
    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)
    if only == {"host"}:
        build.build_all(("fused_norm", "ffn_act", "ffn_act_int8"))
        res = {"card": CS.card_line(), "src": args.src,
               "fused_norm_host": [], "ffn_host": []}
        host_section(res, build)
        (dst / "kernel_sweep_host.json").write_text(json.dumps(res,
                                                               indent=1))
        return 0
    if only == {"tf32"}:
        build.build_all(("attn_stream", "ffn_act", "qkv_proj"))
        res = {"card": CS.card_line()}

        def save_tf32():
            (dst / "kernel_sweep_tf32.json").write_text(json.dumps(
                res, indent=1))
        attn_tf32_section(res, CS, save_tf32)
        tf32_section(res, CS, build, save_tf32)
        return 0
    from repro_torch.core import kv_tiers as KT
    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import qkv_proj as QK
    build.build_all(("attn_stream", "qkv_proj", "paged_decode",
                     "fused_norm", "ffn_act", "ffn_act_int8"))
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf)

    def us(fn):
        return 1e3 * CS.device_ms(fn)

    def save():
        (dst / "kernel_sweep.json").write_text(json.dumps(out, indent=1))

    def timed(row, key, run, twin):
        """Check ``run`` against ``twin`` (bf16, 2e-2) and time it into
        row[key]; a choice the kernel refuses is recorded, not fatal."""
        try:
            err = max(CS.max_err(a, b) for a, b in zip(run(), twin()))
            row[key] = us(run) if err <= 2e-2 else f"error {err}"
        except RuntimeError as e:
            row[key] = f"refused: {e}"

    out = {"card": CS.card_line(), "attn_stream": [], "qkv_gemv": [],
           "qkv_gemm": [], "paged_decode_flat": [],
           "paged_decode_tiered": [], "fused_norm": [],
           "fused_norm_host": [], "ffn_host": [], "ffn_stream": [],
           "ffn_wgmma": []}
    plan_kv = AS.kv_split
    for (H, Hkv, S, L) in ((12, 2, 320, 320), (20, 20, 256, 256),
                           (12, 2, 64, 320), (14, 2, 320, 320)) \
            if "attn" in only else ():
        Dh = 64 if H == 14 else 128
        q, k = rn(1, H, S, Dh), rn(1, Hkv, L, Dh)
        v = rn(1, Hkv, L, Dh, std=0.4)
        row = {"shape": f"q (1,{H},{S},{Dh}), kv heads {Hkv}, L {L}",
               "planned_split": plan_kv(1, H, S, L, sms),
               "sdpa_us": us(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=S == L, enable_gqa=True))}
        for split in range(1, AS.WGMMA_MAX_SPLIT + 1):
            AS.kv_split = lambda *a, _s=split: _s
            timed(row, f"split{split}_us",
                  lambda: [AS.attn_stream(q, k, v)],
                  lambda: [AS.attn_stream_plain(q, k, v)])
        AS.kv_split = plan_kv
        out["attn_stream"].append(row)
        save()
        print(f"[sweep] attn_stream {row}", flush=True)

    plan_gemv, plan_wgs = QK.gemv_split, QK.gemm_warpgroups
    for (tag, D, ns) in (("mobilevlm-3b", 2560, (2560,) * 3),
                         ("fastvlm-1.7b", 1536, (1536, 256, 256))) \
            if "qkv" in only else ():
        sets = [[rn(D, n, std=0.5 * D ** -0.5) for n in ns]
                for _ in range(4)]
        cats = [torch.cat(w, 1) for w in sets]
        bias = torch.zeros(cats[0].shape[1], dtype=bf, device=dev)
        x = rn(4, D)
        turn = [0]

        def cold(fn):
            def call():
                turn[0] += 1
                return fn(turn[0] % 4)
            return call
        row = {"shape": f"{tag} x (4, {D}), N {ns}",
               "planned_split": plan_gemv(4, D, ns, sms, bf),
               "addmm_warm_us": us(lambda: torch.addmm(bias, x, cats[0])),
               "addmm_cold_us": us(cold(
                   lambda i: torch.addmm(bias, x, cats[i])))}
        for n_split in range(1, QK.GEMV_MAX_SPLIT + 1):
            d_chunk = -(-(-(-D // n_split)) // 32) * 32
            if -(-D // d_chunk) != n_split:
                continue
            QK.gemv_split = lambda *a, _p=(n_split, d_chunk): _p
            timed(row, f"split{n_split}_warm_us",
                  lambda: QK.qkv_proj(x, *sets[0]),
                  lambda: QK.qkv_proj_plain(x, *sets[0]))
            if isinstance(row[f"split{n_split}_warm_us"], float):
                row[f"split{n_split}_cold_us"] = us(cold(
                    lambda i: QK.qkv_proj(x, *sets[i])))
        QK.gemv_split = plan_gemv
        out["qkv_gemv"].append(row)
        save()
        print(f"[sweep] qkv_proj decode {row}", flush=True)
        del sets, cats

    for (tag, M, D, ns) in (("mobilevlm-3b", 256, 2560, (2560,) * 3),
                            ("fastvlm-1.7b", 320, 1536, (1536, 256, 256))) \
            if "qkv" in only else ():
        w = [rn(D, n, std=0.5 * D ** -0.5) for n in ns]
        cat = torch.cat(w, 1)
        bias = torch.zeros(cat.shape[1], dtype=bf, device=dev)
        x = rn(M, D)
        row = {"shape": f"{tag} x ({M}, {D}), N {ns}",
               "planned_warpgroups": plan_wgs(M, ns, sms),
               "addmm_us": us(lambda: torch.addmm(bias, x, cat))}
        for wgs in (1, 2):
            QK.gemm_warpgroups = lambda *a, _w=wgs: _w
            timed(row, f"wgs{wgs}_us", lambda: QK.qkv_proj(x, *w),
                  lambda: QK.qkv_proj_plain(x, *w))
        QK.gemm_warpgroups = plan_wgs
        out["qkv_gemm"].append(row)
        save()
        print(f"[sweep] qkv_proj prefill {row}", flush=True)

    # the flat paged decode's key split at mobilevlm-3b's decode heads,
    # warm (one store) and cold (four stores in turn, 168 MB: each call
    # reads its keys from HBM, as a decode step does)
    plan_flat = PD.flat_split
    B, Hkv, ML, Dh = 4, 20, 512, 128
    for lens in ((318, 300, 257, 290), (511,) * 4, (0,) * 4) \
            if "flat" in only else ():
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        table = KT.cold_page_table(lengths, 0, ML, 128)
        q = rn(B, Hkv, 1, Dh)
        stores = [(rn(B, ML, Hkv, Dh), rn(B, ML, Hkv, Dh, std=0.3))
                  for _ in range(4)]
        live = (torch.arange(ML, device=dev)[None]
                <= lengths[:, None].long())[:, None, None]
        turn = [0]

        def cold(fn):
            def call():
                turn[0] += 1
                return fn(*stores[turn[0] % 4])
            return call

        def sdpa(k, v):
            return F.scaled_dot_product_attention(
                q.reshape(B, Hkv, 1, Dh), k.transpose(1, 2),
                v.transpose(1, 2), attn_mask=live)

        def flat(k, v):
            return PD.paged_decode_flat(q, k, v, lengths, table)
        row = {"shape": f"B {B}, Hkv {Hkv}, G 1, D {Dh}, ctx {list(lens)}",
               "planned_split": plan_flat(B, Hkv, sms),
               "sdpa_warm_us": us(lambda: sdpa(*stores[0])),
               "sdpa_cold_us": us(cold(sdpa))}
        for split in range(1, PD.FLAT_MAX_SPLIT + 1):
            PD.flat_split = lambda *a, _s=split: _s
            timed(row, f"split{split}_warm_us",
                  lambda: [flat(*stores[0])],
                  lambda: [PD.paged_decode_flat_plain(q, *stores[0],
                                                      lengths, table)])
            if isinstance(row[f"split{split}_warm_us"], float):
                row[f"split{split}_cold_us"] = us(cold(flat))
        PD.flat_split = plan_flat
        out["paged_decode_flat"].append(row)
        save()
        print(f"[sweep] paged_decode_flat {row}", flush=True)
        del stores

    # the tiered paged decode's key split at both tiered decode shapes,
    # warm (one store) and cold (four stores in turn: 35 MB at mobilevlm-3b,
    # so each call reads most of its keys from HBM, as a decode step does)
    plan_tiered = PD.tiered_split
    W, ML = 128, 512
    for (tag, Hkv, G, lens) in (
            ("fastvlm-1.7b", 2, 6, (318, 300, 257, 290)),
            ("fastvlm-1.7b", 2, 6, (511,) * 4),
            ("mobilevlm-3b B", 20, 1, (318, 300, 257, 290)),
            ("mobilevlm-3b B", 20, 1, (511,) * 4)) \
            if "tiered" in only else ():
        B, Dh = 4, 128
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        table = KT.cold_page_table(lengths, W, ML, 128)
        q = rn(B, Hkv, G, Dh)

        def store():
            ck, cv = (torch.randint(-127, 128, (B, ML, Hkv, Dh), generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (0.002 + 0.006 * torch.rand(B, ML, Hkv, 1, generator=g,
                                                 device=dev)
                      for _ in range(2))
            return (rn(B, W, Hkv, Dh), rn(B, W, Hkv, Dh, std=0.3), ck, ks,
                    cv, vs)
        stores = [store() for _ in range(4)]
        turn = [0]

        def tiered(*st):
            return PD.paged_decode_tiered(q, *st, lengths, table)

        def cold_tiered():
            turn[0] += 1
            return tiered(*stores[turn[0] % 4])
        row = {"shape": f"{tag}: B {B}, Hkv {Hkv}, G {G}, D {Dh}, W {W}, "
                        f"ctx {list(lens)}",
               "planned_split": plan_tiered(B, Hkv, sms, False)}
        for split in range(1, PD.FLAT_MAX_SPLIT + 1):
            PD.tiered_split = lambda *a, _s=split: _s
            timed(row, f"split{split}_warm_us",
                  lambda: [tiered(*stores[0])],
                  lambda: [PD.paged_decode_tiered_plain(q, *stores[0],
                                                        lengths, table)])
            if isinstance(row[f"split{split}_warm_us"], float):
                row[f"split{split}_cold_us"] = us(cold_tiered)
        PD.tiered_split = plan_tiered
        out["paged_decode_tiered"].append(row)
        save()
        print(f"[sweep] paged_decode_tiered {row}", flush=True)
        del stores

    # the FFN: the stream form's slice x cluster at decode, the wgmma
    # form's tiles x F split at prefill, beside the cuBLAS chain
    from repro_torch.kernels import ffn_act as FF
    plan_st, plan_tc = FF.stream_plan, FF.wgmma_plan
    fs = FF.STREAM_SLICE

    def ffn_sets(D, F_, int8, n):
        def one():
            if int8:
                def q8(*s_):
                    return torch.randint(-127, 128, s_, generator=g,
                                         device=dev, dtype=torch.int8)
                su = torch.full((F_,), D ** -0.5 / 127, device=dev)
                sd = torch.full((D,), F_ ** -0.5 / 127, device=dev)
                return (q8(D, F_), su, q8(D, F_), su.clone(), q8(F_, D), sd)
            return (rn(D, F_, std=0.5 * D ** -0.5),
                    rn(D, F_, std=0.5 * D ** -0.5), rn(F_, D, std=F_ ** -0.5))
        return [one() for _ in range(n)]

    def ffn_fns(int8):
        if int8:
            return (lambda x, w: FF.ffn_act_int8(x, *w),
                    lambda x, w: FF.ffn_act_int8_plain(x, *w),
                    lambda w: [FF.dequantize(w[i], w[i + 1]).to(bf)
                               for i in (0, 2, 4)])
        return (lambda x, w: FF.ffn_act(x, *w),
                lambda x, w: FF.ffn_act_plain(x, *w), lambda w: list(w))

    def chain(x, wu, wg, wd):
        return (F.silu(x @ wu) * (x @ wg)) @ wd

    for (tag, D, F_, int8) in (("fastvlm-1.7b bf16", 1536, 8960, False),
                               ("mobilevlm-3b bf16", 2560, 6912, False),
                               ("mobilevlm-3b int8", 2560, 6912, True)) \
            if "ffn" in only else ():
        run, twin, dense = ffn_fns(int8)
        sets = ffn_sets(D, F_, int8, 4)
        chains = [dense(w) for w in sets]
        x = rn(4, D)
        turn = [0]

        def cold(fn, pool):
            def call():
                turn[0] += 1
                return fn(pool[turn[0] % 4])
            return call
        row = {"shape": f"{tag} x (4, {D}), F {F_}",
               "planned (ds, cluster, blocks)": plan_st(F_, sms),
               "chain_cold_us": us(cold(lambda w: chain(x, *w), chains)),
               "chain_kernels": CS.device_kernels(
                   lambda: chain(x, *chains[0]))}
        del chains
        for (ds, cl) in ((ds, cl) for ds in (1, 2, 4, 8)
                         for cl in (1, 2, 4, 8) if cl % ds == 0):
            n = -(-(-(-F_ // fs)) // (cl // ds)) * cl
            key = f"ds{ds}_cl{cl}"
            with swapped(FF, "stream_plan", lambda *a, _p=(ds, cl, n): _p):
                timed(row, f"{key}_warm_us", lambda: [run(x, sets[0])],
                      lambda: [twin(x, sets[0])])
                if isinstance(row[f"{key}_warm_us"], float):
                    row[f"{key}_cold_us"] = us(cold(lambda w: run(x, w),
                                                    sets))
        out["ffn_stream"].append(row)
        save()
        print(f"[sweep] ffn decode {row}", flush=True)
        del sets
        for M in ((256, 320) if D == 1536 else (256,)):
            w = ffn_sets(D, F_, int8, 1)[0]
            wd = dense(w)
            x = rn(M, D)
            ref = twin(x, w)
            row = {"shape": f"{tag} x ({M}, {D}), F {F_}",
                   "planned (wgs, ks, k_chunk)": plan_tc(M, D, F_, sms),
                   "chain_us": us(lambda: chain(x, *wd))}
            steps = -(-F_ // FF.WGMMA_BK)
            for wgs in (1, 2):
                for ks in (1, 2, 3, 4, 6, 8):
                    kc = -(-steps // ks) * FF.WGMMA_BK
                    if -(-F_ // kc) != ks:
                        continue
                    with swapped(FF, "wgmma_plan",
                                 lambda *a, _p=(wgs, ks, kc): _p):
                        timed(row, f"wgs{wgs}_ks{ks}_us",
                              lambda: [run(x, w)], lambda: [ref])
            out["ffn_wgmma"].append(row)
            save()
            print(f"[sweep] ffn prefill {row}", flush=True)

    # fused_norm's threads a row at decode and prefill, beside F.rms_norm
    plan_tpr = FN.threads_per_row
    for (M, D) in ((4, 1536), (4, 2560), (320, 1536), (256, 2560)) \
            if "norm" in only else ():
        x = rn(M, D)
        sc = (0.25 + 0.1 * torch.rand(D, generator=g, device=dev)).to(bf)
        units = D // 8
        row = {"shape": f"x ({M}, {D}) rms", "planned_threads":
               plan_tpr(units),
               "rms_norm_us": us(lambda: F.rms_norm(x, (D,), sc, 1e-6))}
        for tpr in (32, 64, 96, 128, 160, 192, 256, 320, 384, 512, 1024):
            if units > FN.MAX_UNITS * tpr or tpr >= 2 * units + 32:
                continue
            FN.threads_per_row = lambda u, _t=tpr: _t
            timed(row, f"threads{tpr}_us",
                  lambda: [FN.fused_norm(x, sc, None)],
                  lambda: [FN.fused_norm_plain(x, sc, None)])
        FN.threads_per_row = plan_tpr
        out["fused_norm"].append(row)
        save()
        print(f"[sweep] fused_norm {row}", flush=True)
    if "host" in only:
        host_section(out, build)
        save()
    if "tf32" in only:
        attn_tf32_section(out, CS, save)
        tf32_section(out, CS, build, save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
