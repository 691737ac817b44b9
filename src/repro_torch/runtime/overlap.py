"""Compressed cross-pod gradient exchange and the scan-unroll knob, port
of the reference's `runtime/overlap.py`.

``compressed_pod_allreduce`` is the int8-compressed mean of a gradient
tree over the mesh's 'pod' axis: every pod quantizes onto one shared
grid (the max of the pods' `grad_scale`s), the int32 payloads are
summed, and the sum is dequantized at that scale and divided by the pod
count. Summing payloads quantized at different scales and dequantizing
at their mean would be wrong wherever the pods' magnitudes differ. As
in the reference, the train step does not call it: the step's gradient
reduction is the plain sum (`launch.steps`).

``unrolled_scan`` is `jax.lax.scan`'s contract as a loop (the unroll
factor is the reference's latency-hiding window; a Python loop has none
to give, so it is accepted and checked only). The straggler stub is the
reference's documented integration point for bounded-staleness
collectives, the identity.
"""

from __future__ import annotations

import torch

from repro_torch import sharding as S
from repro_torch.core.quant import compress_grad, decompress_grad, grad_scale
from repro_torch.tree import tree_map


@torch.no_grad()
def compressed_pod_allreduce(grads, mesh: S.Mesh):
    """The int8-compressed mean of ``grads`` (a tree of this rank's
    gradient tensors) over 'pod'; ``grads`` itself where the mesh has
    no 'pod' axis. Each leaf's layout inside the pod is untouched."""
    if "pod" not in mesh.shape:
        return grads
    npods = mesh.shape["pod"]

    def one(g):
        # the max of scales held in g's type is exact through f32
        shared = S.all_reduce(grad_scale(g).float().reshape(1), mesh, "pod",
                              op="max")[0].to(g.dtype)
        q, _ = compress_grad(g, scale=shared)
        qsum = S.all_reduce(q.to(torch.int32), mesh, "pod")
        return decompress_grad(qsum, shared, g.dtype) / npods

    return tree_map(one, grads)


def unrolled_scan(body, carry, xs, unroll: int = 2):
    """``(carry, ys)`` of ``body(carry, x) -> (carry, y)`` over the
    leading axis of ``xs`` (a tensor, or a dict of tensors of one
    length), the ys stacked along a new leading axis (None where the
    body returns None), as `jax.lax.scan`."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    n = (len(next(iter(xs.values()))) if isinstance(xs, dict)
         else len(xs))
    ys = []
    for i in range(n):
        x = ({k: v[i] for k, v in xs.items()} if isinstance(xs, dict)
             else xs[i])
        carry, y = body(carry, x)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    if isinstance(ys[0], dict):
        return carry, {k: torch.stack([y[k] for y in ys]) for k in ys[0]}
    return carry, torch.stack(ys)


def straggler_allreduce_timeout_stub(x, axis: str = "pod"):
    """The integration point for collectives that go on without a late
    pod; none exists, and the fault loop is the recovery path: ``x``."""
    return x
