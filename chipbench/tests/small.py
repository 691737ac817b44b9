"""Cells at a size the CPU holds, for the tests: the cells' own files
with every size cut down (the widths too), and short traffic."""

from __future__ import annotations

import copy

import itertools

from chipbench import serve, spec, train

SMALL = {
    "fastvlm-1.7b": dict(hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, vocab_size=256,
                         mm_hidden_size=32, image_tokens=8),
    "stablelm-12b": dict(hidden_size=64, intermediate_size=160,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=16, vocab_size=256),
}
TRAFFIC = {
    "closed_loop": dict(pool=24, round=4),
    "train_rows": dict(batch=4, seq=24, image_tokens=8),
}
LENGTHS = {
    "stablelm-code": ({"dist": "lognormal", "median": 30, "sigma": 0.7,
                       "min": 8, "max": 50},
                      {"dist": "lognormal", "median": 3, "sigma": 1.0,
                       "min": 2, "max": 8}, 3),
}
SETUP = {
    "stablelm-code": dict(slots=3, max_len=64, kv_hot_window=8,
                          chunk_tokens=16, admit_slots=3, fill_steps=4,
                          sample_tokens=10 ** 6),
    "fastvlm-train": dict(),
}


def cell(name: str, dtype: str | None = None) -> spec.Cell:
    """The cell ``name`` cut to the CPU's size; ``dtype`` overrides its
    precision (the tests run the program in float32 where they compare
    it with the reference)."""
    c = copy.deepcopy(spec.cell(name))
    c.config.update(SMALL[c.config["name"]])
    c.traffic.update(TRAFFIC[c.traffic["kind"]])
    if name in LENGTHS:
        p, a, clients = LENGTHS[name]
        c.traffic.update(prompt_tokens=p, answer_tokens=a, clients=clients)
    c.setup.update(SETUP[name])
    if dtype:
        c.setup["dtype"] = dtype
    return c


def fixed_clock(monkeypatch, tick: float = 0.005) -> None:
    """The harness's clocks advance ``tick`` seconds a reading, so a
    window of the CPU tests holds the same steps however busy the
    machine is."""
    count = itertools.count()

    def clock():
        return tick * next(count)
    monkeypatch.setattr(serve, "CLOCK", clock)
    monkeypatch.setattr(train, "CLOCK", clock)
