"""Carry parameter and cache trees between the reference and the port.

`params_from_jax` maps a reference parameter tree (nested dicts of numpy
arrays — the caller does the jax -> numpy step, e.g. with
``jax.tree.map(np.asarray, params)``) onto port tensors leaf path by leaf
path, with no renaming: the port keeps the reference's tree layout.
`tree_to_numpy` maps a port cache or parameter tree (any tensor tree)
back to numpy so the two packages' trees can be compared leaf by leaf,
or handed to the reference; `state_from_numpy` makes a port optimizer
`TrainState` from a reference state's fields; `shard_params` cuts a full
parameter tree to one rank's shards of a mesh.

bfloat16 arrays arrive as ``ml_dtypes.bfloat16``, which `torch.from_numpy`
rejects; they travel as their uint16 bit pattern and are viewed back, so
the conversion is exact. This module imports numpy and ml_dtypes, never
jax.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import torch

from repro_torch.optim import TrainState
from repro_torch.sharding import shard
from repro_torch.tree import tree_map


def array_to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device="cpu") -> dict:
    """Reference parameter tree (numpy leaves) -> port parameter tree."""
    return tree_map(lambda a: array_to_tensor(a, device), tree)


def tree_to_numpy(tree) -> dict:
    """Port tensor tree -> the same tree with numpy leaves."""
    return tree_map(tensor_to_array, tree)


def state_from_numpy(fields: dict, device="cpu"):
    """{"params", "mu", "nu", "step"} with numpy leaves (e.g. a reference
    `TrainState`'s fields) -> a port `TrainState` on ``device``."""
    return TrainState(*(params_from_jax(fields[k], device)
                        for k in ("params", "mu", "nu")),
                      step=array_to_tensor(fields["step"], device))


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """A full parameter tree -> this rank's contiguous block of every
    leaf under ``specs`` (`Model.param_shardings(rules)`) on ``mesh``;
    a leaf the specs replicate is kept as it is (no copy)."""
    return tree_map(lambda t, s: shard(t, s, mesh).contiguous(), params,
                    specs)
