"""Fault-tolerant checkpointing, in the reference's format
(`repro/checkpoint/manager.py`):

  * atomic publish: write to a temp dir, fsync, rename; a crash mid-write
    never corrupts the latest checkpoint;
  * keep-N retention over ``step_{:010d}`` directories;
  * one ``leaf_{:05d}.npy`` a leaf and a ``MANIFEST.json`` with each
    leaf's shape, dtype and a 16-character sha256 of its file, checked on
    restore (IOError on a mismatch, ValueError on a shape mismatch);
  * restore() returns (state, step), so the loop and the seekable data
    pipeline resume exactly.

On a mesh (``mesh`` and ``shardings``, a tree of specs shaped like the
state: `launch.steps.train_state_shardings`) a leaf is a rank's shard.
`save` gathers every leaf whole and rank 0 alone writes it; `restore`
reads whole leaves and keeps the rank's block of each. The files are a
one-device checkpoint's, so a checkpoint saved on one mesh restores
onto another (the reference's "resharded on restore").

Leaves are flattened in `jax.tree.flatten`'s order (`tree.sorted_leaves`:
dict keys sorted; a `TrainState` as params, mu, nu, step), so an f32 checkpoint
written by the reference restores here leaf for leaf. numpy has no
bfloat16: a bf16 leaf is stored as its uint16 bit pattern and recorded as
"bfloat16" in the manifest.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch import sharding as S
from repro_torch.tree import sorted_leaves, sorted_unflatten

BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 mesh=None, shardings=None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mesh = mesh
        self.shardings = shardings

    def _specs(self, n: int) -> list:
        """Each leaf's spec in `sorted_leaves` order (None: one device)."""
        if self.shardings is None:
            return [None] * n
        specs = sorted_leaves(self.shardings)
        if len(specs) != n:
            raise ValueError(f"{len(specs)} specs for {n} leaves")
        return specs

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "MANIFEST.json").exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, state, step: int) -> pathlib.Path:
        leaves = sorted_leaves(state)
        specs = self._specs(len(leaves))
        final = self._step_dir(step)
        write = self.mesh is None or S.rank() == 0
        tmp = self.dir / f".tmp_step_{step:010d}"
        if write:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": f"{len(leaves)} leaves",
                    "leaves": []}
        for i, (leaf, spec) in enumerate(zip(leaves, specs)):
            if spec is not None:        # every rank joins the gathers
                with torch.no_grad():
                    leaf = S.unshard(leaf, spec, self.mesh)
            if not write:
                continue
            arr, dtype = _to_numpy(leaf)
            path = tmp / f"leaf_{i:05d}.npy"
            np.save(path, arr)
            digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
            manifest["leaves"].append({"shape": list(arr.shape),
                                       "dtype": dtype, "sha": digest})
        if write:
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
            self._gc()
        if self.mesh is not None:       # published before any rank reads
            S.barrier(self.mesh)
        return final

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, state_like, step: int | None = None):
        """Restore into the structure of ``state_like``, each leaf on its
        counterpart's device. Returns (state, step). Raises IOError on an
        integrity mismatch, ValueError on a leaf count or shape
        mismatch."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "MANIFEST.json").read_text())
        like = sorted_leaves(state_like)
        specs = self._specs(len(like))
        if len(like) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(like)}")
        leaves = []
        for i, (ref, meta, spec) in enumerate(zip(like, manifest["leaves"],
                                                  specs)):
            path = d / f"leaf_{i:05d}.npy"
            digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
            if digest != meta["sha"]:
                raise IOError(f"integrity failure in {path.name}")
            arr = np.load(path)
            want = (tuple(ref.shape) if spec is None else
                    S.full_shape(spec, tuple(ref.shape), self.mesh))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i}: shape {arr.shape} != {want}")
            t = _to_tensor(arr, meta["dtype"], "cpu")
            if spec is not None:
                t = S.shard(t, spec, self.mesh).contiguous()
            leaves.append(t.to(ref.device))
        return sorted_unflatten(state_like, leaves), step
