#!/usr/bin/env python3
"""Sweep the launch choices of the bf16 tensor-core kernels on the card.

    python3 kernel_sweep.py          # one CUDA card, from the repository root

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
a decode step does). It prints the card's name and power limit first and
writes chiprun_out/kernel_sweep.json.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device; this sweep runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import attn_stream as AS
    from repro_torch.kernels import build
    from repro_torch.kernels import qkv_proj as QK

    print(CS.card_line())
    build.build_all(("attn_stream", "qkv_proj"))
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf)

    def us(fn):
        return 1e3 * CS.device_ms(fn)

    dst = ROOT / "chiprun_out"
    dst.mkdir(exist_ok=True)

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
           "qkv_gemm": []}
    plan_kv = AS.kv_split
    for (H, Hkv, S, L) in ((12, 2, 320, 320), (20, 20, 256, 256),
                           (12, 2, 64, 320), (14, 2, 320, 320)):
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
                         ("fastvlm-1.7b", 1536, (1536, 256, 256))):
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
                            ("fastvlm-1.7b", 320, 1536, (1536, 256, 256))):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
