"""The traffic generator: the same seed gives the same inputs, another
seed other inputs, and every seed the same sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench import generate, spec

BIG = 2 ** 31 + 12345            # seeds run past 32 signed bits


def test_lengths_are_a_fixed_multiset_in_range():
    t = spec.load(spec.HERE / "traffic" / "code-closed16.json")
    assert t["pool"] % t["round"] == 0
    for key in ("prompt_tokens", "answer_tokens"):
        ls = generate.lengths(t[key], t["round"])
        assert len(ls) == t["round"]
        assert min(ls) >= t[key]["min"] and max(ls) <= t[key]["max"]
        assert ls == sorted(ls)


def _serve(seed, image=(4, 8)):
    t = dict(spec.load(spec.HERE / "traffic" / "code-closed16.json"),
             pool=40, round=8, image_every=1)
    return generate.serve_requests(t, 1000, image, seed)


def test_every_round_holds_the_same_sizes():
    a, b = _serve(BIG), _serve(BIG + 7)
    for r in range(0, 40, 8):
        for key in ("tokens", "answer"):
            def size(x):
                return len(x["tokens"]) if key == "tokens" else x["answer"]
            assert sorted(size(x) for x in a[r:r + 8]) \
                == sorted(size(y) for y in b[r:r + 8])


def test_requests_repeat_per_seed():
    a, b = _serve(BIG), _serve(BIG)
    for x, y in zip(a, b):
        assert np.array_equal(x["tokens"], y["tokens"])
        assert np.array_equal(x["patches"], y["patches"])
        assert x["answer"] == y["answer"]


def test_requests_differ_across_seeds_with_the_same_sizes():
    a, b = _serve(BIG), _serve(BIG + 1)
    assert any(not np.array_equal(x["tokens"][:4], y["tokens"][:4])
               for x, y in zip(a, b))
    assert sorted(len(x["tokens"]) for x in a) \
        == sorted(len(y["tokens"]) for y in b)
    assert sorted(x["answer"] for x in a) == sorted(y["answer"] for y in b)
    assert [len(x["tokens"]) for x in a] != [len(y["tokens"]) for y in b]


def test_every_request_has_an_image_where_the_traffic_says():
    reqs = _serve(3)
    assert all(r["patches"].shape == (4, 8) for r in reqs)
    assert all(r["patches"] is None for r in _serve(3, image=None))


def test_train_batches_repeat_per_seed_and_differ_across_steps():
    t = {"batch": 3, "seq": 12, "image_tokens": 4}
    a = generate.train_batch(t, 50, 8, BIG, 0, "cpu")
    b = generate.train_batch(t, 50, 8, BIG, 0, "cpu")
    c = generate.train_batch(t, 50, 8, BIG, 1, "cpu")
    d = generate.train_batch(t, 50, 8, BIG + 1, 0, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["patches"], d["patches"])
    assert a["tokens"].shape == (3, 8) and a["patches"].shape == (3, 4, 8)
    # next-token labels on the text, no loss on the visual positions
    assert torch.equal(a["labels"][:, 4:11], a["tokens"][:, 1:])
    assert a["loss_mask"][:, :4].sum() == 0
    assert a["loss_mask"][:, -1].sum() == 0
    assert a["loss_mask"][:, 4:11].min() == 1
