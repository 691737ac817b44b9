"""The plain reference against the program (``repro_torch``) at reduced
sizes in float32: prefill and decode logits through the tiered store
(the int8 cold tier and the hot ring, worked out again by the
reference), and the training loss and gradients."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench import generate, program, weights
from chipbench.reference import decoder
from chipbench.reference import train as reftrain
from chipbench.tests import small

W = 8


def _build(name: str, dtype: str = "float32", kv: bool = True):
    cell = small.cell(name, dtype)
    setup = dict(cell.setup, kv_policy="tiered", kv_hot_window=W) \
        if kv else cell.setup
    cfg = program.port_config(cell.config, setup)
    mdl = program.model(cfg)
    params = weights.make(mdl, cell.config["vocab_size"], 1234, "cpu")
    return cell, mdl, params


def _program_logits(mdl, params, seq: dict, max_len: int) -> torch.Tensor:
    """Logits of every served position: the prompt in two chunks through
    the extend workspace, then one decode step a served token."""
    ext = mdl.init_extend_cache(1, max_len, "cpu")
    pos = 0
    if seq["patches"] is not None:
        pt = seq["patches"][None]
        _, ext = mdl.extend(params, {"patches": pt}, ext, 0, pt.shape[1])
        pos = pt.shape[1]
    toks = np.asarray(seq["tokens"], np.int64)
    half = len(toks) // 2
    _, ext = mdl.extend(params, {"tokens": toks[None, :half]}, ext, pos,
                        half)
    logits, cache = mdl.extend(params, {"tokens": toks[None, half:]}, ext,
                               pos + half, len(toks) - half, commit=True)
    out = [logits[0, -1]]
    p = pos + len(toks)
    for t in seq["served"][:-1]:
        logits, cache = mdl.decode_step(
            params, torch.tensor([[t]]), cache, torch.tensor([p]))
        out.append(logits[0, -1])
        p += 1
    V = mdl.cfg.vocab_size
    return torch.stack(out)[:, :V].float()


@pytest.mark.parametrize("name", ["fastvlm-train", "stablelm-code"])
def test_reference_matches_the_program_through_the_tiered_store(name):
    cell, mdl, params = _build(name)
    c = cell.config
    rng = np.random.default_rng(5)
    image = ((c["image_tokens"], c["mm_hidden_size"])
             if "mm_hidden_size" in c else None)
    seq = {"tokens": rng.integers(0, c["vocab_size"], 13),
           "patches": (None if image is None else
                       rng.standard_normal(image).astype(np.float32)),
           "served": rng.integers(0, c["vocab_size"], 20).tolist()}
    got = _program_logits(mdl, params, seq, 64)
    ref = decoder.served_logits(params, c, [seq], W)[0]
    flat = decoder.served_logits(params, c, [seq], None)[0]
    sd = ref.std(dim=-1, keepdim=True)
    err = ((got - ref).abs() / sd).max().item()
    assert err < 2e-4, err
    # the cold tier's int8 round trip shows: without it the reference
    # departs from the program on the positions that read cold keys
    n_cold = len(seq["served"]) - W
    assert ((flat - ref)[-n_cold:].abs() / sd[-n_cold:]).max() > 10 * err


def test_reference_loss_and_gradients_match_the_program():
    cell, mdl, params = _build("fastvlm-train", kv=False)
    c = cell.config
    t = cell.traffic
    batch = generate.train_batch(t, c["vocab_size"], c["mm_hidden_size"], 9,
                                 0, "cpu")
    flat = weights.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss = mdl.loss(params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    ref_params = weights.make(mdl, c["vocab_size"], 1234, "cpu")
    rflat = weights.flatten(ref_params)
    for p in rflat.values():
        p.requires_grad_(True)
    rloss = decoder.loss(ref_params, c, batch)
    rgrads = torch.autograd.grad(rloss, list(rflat.values()))
    assert abs(loss.item() - rloss.item()) <= 1e-5 * abs(rloss.item())
    for path, g, rg in zip(flat, grads, rgrads):
        rel = ((g - rg).norm() / rg.norm().clamp_min(1e-30)).item()
        assert rel < 1e-4, (path, rel)


def test_adamw_reference_schedule():
    opt = {"lr": 1.0, "warmup_steps": 10, "total_steps": 110}
    assert reftrain.lr_at(opt, 5) == pytest.approx(0.5)
    assert reftrain.lr_at(opt, 10) == pytest.approx(1.0)
    assert reftrain.lr_at(opt, 60) == pytest.approx(0.5)
    assert reftrain.lr_at(opt, 200) == pytest.approx(0.0)


def test_int8_round_trip_is_the_cold_tiers_codec():
    x = torch.randn(5, 3, 16)
    y = decoder.int8_round_trip(x)
    scale = x.abs().amax(-1, keepdim=True) / 127
    assert torch.allclose(y, torch.round(x / scale) * scale)
    assert decoder.int8_round_trip(torch.zeros(2, 4)).abs().max() == 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    y = decoder.tf32_round(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
