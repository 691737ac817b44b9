"""Quickstart on the PyTorch port: build a CHIME-mapped model, inspect its
mapping plan, run a prefill and a few decode steps with the tiered KV
cache. The port of `examples/quickstart.py`; it runs on the card unless
``--device`` says otherwise.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.planner import plan_for
from repro_torch.device import resolve_device
from repro_torch.models import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    # the paper's smallest evaluated model (reduced)
    cfg = get_config("fastvlm-0.6b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", remat="none",
        kv_policy="tiered", kv_hot_window=16)
    model = Model(cfg)

    # 1. the CHIME mapping framework: where does every operator live?
    plan = plan_for(cfg)
    plan.audit()  # two-cut-point invariant
    print("== CHIME mapping plan ==")
    for lp in plan.layers:
        ops = " -> ".join(f"{p.op}@{p.domain}" for p in lp.placements)
        print(f"  [{lp.mixer} x{lp.repeats}] {ops}  cuts={lp.cut_points}")
    print(f"  cross-domain bytes/token: "
          f"{plan.cross_domain_bytes_per_token(cfg)}")

    # 2. run it: prefill a VQA-style prompt (image patches + text)
    gen = torch.Generator().manual_seed(0)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tv = cfg.frontend.num_tokens
    batch = {
        "patches": torch.randn((1, tv, cfg.frontend.frontend_dim),
                               generator=gen).to(dev),
        "tokens": torch.randint(0, cfg.vocab_size, (1, 24), generator=gen,
                                dtype=torch.int32).to(dev),
    }
    prompt_len = tv + 24
    logits, cache = model.prefill(params, batch, max_len=prompt_len + 8)
    print(f"\n== prefill == logits {tuple(logits.shape)}")

    # 3. decode with the tiered cache (hot full-precision window / int8
    # cold tier)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    out = []
    with torch.no_grad():
        for i in range(5):
            logits, cache = model.decode_step(params, tok, cache,
                                              prompt_len + i)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
            print(f"  step {i}: token {out[-1]}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
