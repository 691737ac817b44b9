"""The weights both sides are handed, made on the device from the seed.

The tree's layout (leaf paths, shapes, dtypes) is the program's
parameter tree, read as shapes only (meta tensors); every value is the
benchmark's. Each leaf is one draw from its own generator, seeded from
(seed, the leaf's index), so the whole tree is a few large calls and any
leaf can be drawn again alone, bit for bit (`leaf`):

- norm scales ("scale"): 1 + N(0, 0.02^2);
- biases ("bias", "b*"): N(0, 0.02^2);
- the embedding table: N(0, 1 / hidden size), its rows past the
  published vocabulary zero (the program pads the vocabulary; the
  published model has no such rows), and so are ``lm_head``'s columns;
- every other weight: N(0, 1 / fan-in), the fan-in being the leading
  axis of one layer's leaf (the two leading axes of the output
  projection "wo", (heads, head size, hidden)).
"""

from __future__ import annotations

import re

from chipbench import generate

BIAS = re.compile(r"bias|b[a-z0-9_]*")


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a tree of dicts, in sorted key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _stacked(path: str, repeats: dict) -> bool:
    parts = path.split("/")
    return parts[0] == "units" and repeats.get(parts[1], 1) > 1


def leaf(path: str, index: int, shape, dtype, stacked: bool, vocab: int,
         seed: int, device):
    """Leaf ``index`` of the tree (at ``path``), drawn on ``device``."""
    import torch
    g = torch.Generator(device=device).manual_seed(
        generate._mix(seed, 3, index))
    t = torch.empty(shape, dtype=dtype, device=device)
    key = path.rsplit("/", 1)[-1]
    one = shape[1:] if stacked else shape
    if key == "scale":
        return t.normal_(1.0, 0.02, generator=g)
    if BIAS.fullmatch(key):
        return t.normal_(0.0, 0.02, generator=g)
    if key == "table":
        t.normal_(0.0, shape[-1] ** -0.5, generator=g)
        t[vocab:] = 0
        return t
    fan_in = one[0] * one[1] if key == "wo" else one[0]
    t.normal_(0.0, fan_in ** -0.5, generator=g)
    if path == "lm_head":
        t[:, vocab:] = 0
    return t


def layout(model) -> tuple[dict, dict]:
    """({path: meta leaf}, {unit name: repeats}) of the program's tree."""
    shapes, _ = model.abstract_params()
    repeats = {f"u{i}": u.repeats for i, u in enumerate(model.plan)}
    return flatten(shapes), repeats


def make(model, vocab: int, seed: int, device) -> dict:
    """The whole tree, as the program takes it."""
    flat, repeats = layout(model)
    return unflatten({
        p: leaf(p, i, m.shape, m.dtype, _stacked(p, repeats), vocab, seed,
                device)
        for i, (p, m) in enumerate(flat.items())})


def leaves(model, vocab: int, seed: int, device):
    """(path, leaf) of the tree one at a time, each drawn as `make` draws
    it (the memory holds one leaf)."""
    flat, repeats = layout(model)
    for i, (p, m) in enumerate(flat.items()):
        yield p, leaf(p, i, m.shape, m.dtype, _stacked(p, repeats), vocab,
                      seed, device)
