"""Deterministic, resumable synthetic data pipeline (the reference's
`repro/data/pipeline.py`).

  * host-sharded: each data-parallel host materializes only its slice of
    the global batch (``host_slice``);
  * deterministic and seekable: batch t is a pure function of (seed, t,
    host index), so a restart from a checkpoint replays the exact stream
    (the checkpoint stores only the step counter);
  * modality-aware: token LM batches, VQA batches (patches + tokens, the
    visual rows masked out of the loss) for VLM archs, and frame batches
    for audio archs.

The layouts and the Markov rule are the reference's. The random stream
is not: the port draws from an explicit `torch.Generator` seeded from
(seed, step, host index) and cannot replay `jax.random`'s threefry bits,
so the two packages give different batches for one seed (a difference by
design; parity tests hand both packages the same numpy batch). Batches
are made on the CPU; the model moves them to the params' device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

MARKOV_NOISE = 17          # next = (tok * 31 + 7 + n) % V, n in [0, 17)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


def _generator(seed: int, step: int, host_index: int) -> torch.Generator:
    """A generator whose stream is a function of (seed, step, host) only
    (a splitmix64-style mix of the three)."""
    h = 0
    for v in (seed, step, host_index):
        h = (h ^ (v & (2 ** 64 - 1))) * 0x9E3779B97F4A7C15 % 2 ** 64
        h ^= h >> 31
    return torch.Generator().manual_seed(h)


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig,
                 host_index: int = 0, host_count: int = 1):
        if dcfg.global_batch % host_count:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.dcfg = dcfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = dcfg.global_batch // host_count

    def host_slice(self, step: int) -> dict:
        """Batch ``step`` for this host: a pure function of (seed, step,
        host index)."""
        gen = _generator(self.dcfg.seed, step, self.host_index)
        B, S = self.local_batch, self.dcfg.seq_len
        cfg = self.cfg
        if cfg.family == "audio":
            frames = torch.randn((B, S, cfg.frontend.frontend_dim),
                                 generator=gen)
            labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   dtype=torch.int32)
            return {"frames": frames, "labels": labels}
        tokens = self._markov_tokens(gen, B, S)
        if cfg.frontend is not None:
            tv = cfg.frontend.num_tokens
            patches = torch.randn((B, tv, cfg.frontend.frontend_dim),
                                  generator=gen)
            text = tokens[:, :S - tv]
            labels = torch.cat([torch.zeros((B, tv), dtype=torch.int32),
                                torch.roll(text, -1, dims=1)], dim=1)
            mask = torch.cat([torch.zeros((B, tv)),
                              torch.ones((B, S - tv))], dim=1)
            return {"tokens": text, "patches": patches, "labels": labels,
                    "loss_mask": mask}
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones((B, S))
        mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def _markov_tokens(self, gen: torch.Generator, B: int, S: int
                       ) -> torch.Tensor:
        """Learnable synthetic text: token_{t+1} = f(token_t) + noise, so
        a model that trains reduces the loss below uniform entropy."""
        V = self.cfg.vocab_size
        tok = torch.randint(0, V, (B,), generator=gen)
        noise = torch.randint(0, MARKOV_NOISE, (B, S), generator=gen)
        toks = torch.empty((B, S), dtype=torch.int64)
        for t in range(S):
            tok = (tok * 31 + 7 + noise[:, t]) % V
            toks[:, t] = tok
        return toks.to(torch.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.host_slice(step)
            step += 1
