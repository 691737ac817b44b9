"""The benchmark's frozen FLOP formulas against the program's analytic
walk (`launch/hlo_analysis.analyze`, meta tensors) at a reduced size.
The comparison lives here only; a benchmark run never calls the walk.
The walk counts what the plain twins compute, which is dense attention
(every query against every key, masked after): the formulas are given
those pairs for the comparison and count causal pairs in a run."""

from __future__ import annotations

import torch

from chipbench import program, work
from chipbench.tests import small


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _setup():
    cell = small.cell("fastvlm-train")
    d = work.dims(cell.config)
    mdl = program.model(program.port_config(cell.config, cell.setup))
    B, S, Tv = 2, 24, cell.config["image_tokens"]
    batch = {"tokens": _meta((B, S - Tv), torch.int64),
             "patches": _meta((B, Tv, d.Fv), torch.float32),
             "labels": _meta((B, S), torch.int64),
             "loss_mask": _meta((B, S), torch.float32)}
    return d, mdl, batch, (B, S, Tv)


def test_forward_flops_equal_the_walk():
    from repro_torch.launch import hlo_analysis
    d, mdl, batch, (B, S, Tv) = _setup()
    params, _ = mdl.abstract_params()
    walk = hlo_analysis.analyze(lambda: mdl.forward(params, batch))
    assert walk["flops"] == work.forward_flops(d, B, S, Tv, pairs=S * S)


def test_train_step_flops_equal_the_walk():
    from repro_torch.launch import hlo_analysis, steps
    from repro_torch.optim import AdamWConfig
    d, mdl, batch, (B, S, Tv) = _setup()
    opt = AdamWConfig()
    walk = hlo_analysis.analyze(steps.make_train_step(mdl, opt),
                                steps.abstract_train_state(mdl, opt), batch)
    assert walk["flops"] - walk["recompute_flops"] \
        == work.train_step_flops(d, B, S, Tv, pairs=S * S)


def test_causal_pairs_and_chunks_add_up():
    d = work.Dims(D=64, H=4, Hkv=2, Dh=16, F=128, V=256, L=2, gated=True,
                  qkv_bias=True, Fv=32)
    assert work.causal_pairs(0, 4) == 10
    assert work.causal_pairs(3, 2) == 4 + 5
    whole = work.chunk_flops(d, 20, 0, False, True)
    parts = work.chunk_flops(d, 12, 0, False, False) \
        + work.chunk_flops(d, 8, 12, False, True)
    assert whole == parts
    # a decode step of one slot at context n+1 is the chunk's next row
    assert work.decode_flops(d, [21]) == work.chunk_flops(
        d, 1, 20, False, True)


def test_rooflines_take_the_larger_bound():
    pk = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.bound_s(989e12, 0.0, pk, "bfloat16") == 1.0
    assert work.bound_s(0.0, 3.35e12, pk, "bfloat16") == 1.0
    assert work.peaks("NVIDIA H100 PCIe")["bw"] == 2.0e12
