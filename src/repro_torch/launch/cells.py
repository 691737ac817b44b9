"""The (architecture x input-shape) evaluation grid, port of the
reference's `launch/cells.py`: 10 archs x 4 shapes = 40 cells, with the
reference's skips:

* long_500k needs sub-quadratic sequence mixing: only rwkv6-7b (ssm) and
  zamba2-1.2b (hybrid) run it; the full-attention archs skip;
* an encoder-only arch (hubert-xlarge) has no decode step: decode
  shapes skip.

Also ``input_specs``: shape-and-dtype stand-ins for every model input
(meta-device tensors, where the reference has `ShapeDtypeStruct`s), and
the per-arch overrides of a cell's config (FSDP + bf16 optimizer state
for the >100B models).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import (ASSIGNED_ARCHS, LM_SHAPES, ModelConfig,
                                      ShapeSpec, get_config)

SUBQUADRATIC = ("rwkv6-7b", "zamba2-1.2b")
ENCODER_ONLY = ("hubert-xlarge",)

# archs whose params + optimizer state need FSDP and low-precision state
HUGE = ("nemotron-4-340b", "llama4-maverick-400b")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeSpec
    skip_reason: str | None = None

    @property
    def name(self) -> str:
        return f"{self.arch}@{self.shape.name}"


def all_cells() -> list[Cell]:
    cells = []
    for arch in ASSIGNED_ARCHS:
        for shape in LM_SHAPES:
            skip = None
            if shape.name == "long_500k" and arch not in SUBQUADRATIC:
                skip = ("full-attention at 524k context is out of scope "
                        "(sub-quadratic archs only per assignment)")
            if arch in ENCODER_ONLY and shape.kind == "decode":
                skip = "encoder-only arch has no decode step"
            cells.append(Cell(arch, shape, skip))
    return cells


def runnable_cells() -> list[Cell]:
    return [c for c in all_cells() if c.skip_reason is None]


def cell_config(arch: str, shape: ShapeSpec, **overrides) -> ModelConfig:
    """One cell's config: a train cell FSDP with full remat (bf16 params
    and sequence sharding on the huge archs), a serving cell bf16 with
    no remat (FSDP on the huge archs), a decode cell on the flat cache
    unless ``overrides`` say otherwise."""
    cfg = get_config(arch)
    kw: dict = {}
    if shape.kind == "train":
        kw.update(param_dtype="float32", compute_dtype="bfloat16",
                  remat="full", fsdp=True)
        if arch in HUGE:
            kw.update(param_dtype="bfloat16", seq_sharding=True)
    else:
        kw.update(param_dtype="bfloat16", compute_dtype="bfloat16",
                  remat="none")
        if arch in HUGE:
            kw.update(fsdp=True)
    if shape.kind == "decode":
        kw.setdefault("kv_policy", "flat")
    kw.update(overrides)
    return cfg.replace(**kw)


def train_microbatches(arch: str, shape: ShapeSpec) -> int:
    """Gradient-accumulation factor of a cell: 16 on the huge archs, 4
    on the others, 1 off training."""
    if shape.kind != "train":
        return 1
    return 16 if arch in HUGE else 4


def grad_accum_dtype(arch: str) -> str:
    return "bfloat16" if arch in HUGE else "float32"


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors (shape and dtype, no storage) for the step function's
    batch argument; caches and the train state come from `launch.steps`."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), i32)}
    if cfg.family == "audio":
        batch = {"frames": _spec((B, S, cfg.frontend.frontend_dim), f32)}
        if shape.kind == "train":
            batch["labels"] = _spec((B, S), i32)
        return batch
    if cfg.frontend is not None:
        tv = cfg.frontend.num_tokens
        batch = {"tokens": _spec((B, S - tv), i32),
                 "patches": _spec((B, tv, cfg.frontend.frontend_dim), f32)}
        if shape.kind == "train":
            batch["labels"] = _spec((B, S), i32)
        return batch
    batch = {"tokens": _spec((B, S), i32)}
    if shape.kind == "train":
        batch["labels"] = _spec((B, S), i32)
    return batch


def batch_logical(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Each batch input's logical axes: its rows on "batch"."""
    return {k: ("batch",) + (None,) * (t.dim() - 1)
            for k, t in input_specs(cfg, shape).items()}
