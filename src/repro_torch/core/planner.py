"""CHIME mapping framework (paper §III-C): workload-aware data layout.

Assigns every operator class of a model to a memory domain and emits the
execution plan the runtime and the analytical simulator share:

  DRAM domain ("latency-critical"): image preprocessing/connector, QKV
    projection, attention, KV cache, norms — everything except the FFN.
  RRAM domain ("dense read-mostly storage"): FFN weights + the fused FFN
    kernel; MoE expert banks; the frozen (write-once) cold KV tier.

The plan records the two cut points per layer (AttnOut ->, <- FFNOut) and
the fused-kernel choice per op, and computes the per-step cross-domain
traffic — the quantity CHIME minimizes. ``audit`` verifies the two-cut-point
invariant against the model structure.

Port of the reference's `core/planner.py`, built on the port's own
`models.model.build_plan`.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_plan

Domain = Literal["dram", "rram"]


@dataclasses.dataclass(frozen=True)
class OpPlacement:
    op: str                    # e.g. "attn", "ffn", "norm", "connector"
    domain: Domain
    fused_kernel: str | None   # Table I kernel implementing it


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str
    placements: tuple[OpPlacement, ...]
    cut_points: tuple[str, ...]          # activation tensors crossing domains
    repeats: int


@dataclasses.dataclass(frozen=True)
class MappingPlan:
    arch: str
    layers: tuple[LayerPlan, ...]
    kv_tiering: bool                     # technique T2 applicable?
    kv_policy: str
    notes: tuple[str, ...]

    def cross_domain_tensors_per_layer(self) -> dict[str, int]:
        return {f"{lp.mixer}x{lp.repeats}": len(lp.cut_points)
                for lp in self.layers}

    def cross_domain_bytes_per_token(self, cfg: ModelConfig,
                                     dtype_bytes: int = 2) -> int:
        """AttnOut + FFNOut bytes per generated token across all layers —
        the UCIe traffic CHIME's layout minimizes."""
        total = 0
        for lp in self.layers:
            total += len(lp.cut_points) * cfg.d_model * dtype_bytes \
                * lp.repeats
        return total

    def audit(self) -> None:
        """The paper's invariant: <= 2 activation-only cross-domain
        transfers per layer, and fusion boundaries never split a kernel."""
        for lp in self.layers:
            if len(lp.cut_points) > 2:
                raise AssertionError(
                    f"{lp.mixer}: {len(lp.cut_points)} cut points > 2")
            domains = [p.domain for p in lp.placements]
            # cut points must equal the number of domain switches in the
            # op sequence (fusion boundaries == domain boundaries)
            switches = sum(1 for a, b in zip(domains, domains[1:])
                           if a != b)
            # closing the loop back to DRAM for the next layer
            if domains and domains[-1] != domains[0]:
                switches += 1
            if switches != len(lp.cut_points):
                raise AssertionError(
                    f"{lp.mixer}: {switches} domain switches vs "
                    f"{len(lp.cut_points)} declared cut points")


def plan_for(cfg: ModelConfig) -> MappingPlan:
    """Derive the CHIME mapping for any model config (paper Fig. 5(b))."""
    notes: list[str] = []
    layers: list[LayerPlan] = []
    for unit in build_plan(cfg):
        b = unit.block
        placements: list[OpPlacement] = []
        cuts: list[str] = []
        placements.append(OpPlacement("norm", "dram", "FUSED_NORM"))
        if b.mixer in ("attn", "attn_shared"):
            placements.append(
                OpPlacement("qkv_proj", "dram", "FUSED_QKV_PROJ"))
            placements.append(
                OpPlacement("attention", "dram", "FUSED_ATTN_STREAM"))
        elif b.mixer == "mla":
            placements.append(
                OpPlacement("mla_latents", "dram", "FUSED_QKV_PROJ"))
            placements.append(
                OpPlacement("mla_attention", "dram", "FUSED_ATTN_STREAM"))
        elif b.mixer == "rwkv6":
            placements.append(OpPlacement("rwkv6_timemix", "dram", None))
        elif b.mixer == "mamba2":
            placements.append(OpPlacement("mamba2_ssd", "dram", None))
        if b.mlp is not None:
            placements.append(OpPlacement("norm2", "dram", "FUSED_NORM"))
            if b.mlp == "moe":
                placements.append(
                    OpPlacement("moe_ffn", "rram", "FUSED_FFN_ACT"))
            elif b.mlp == "rwkv_cm":
                placements.append(
                    OpPlacement("channel_mix", "rram", "FUSED_FFN_ACT"))
            else:
                placements.append(
                    OpPlacement("ffn", "rram", "FUSED_FFN_ACT"))
            cuts = ["AttnOut", "FFNOut"]
        else:
            notes.append(f"{b.mixer}: mixer-only block — no FFN, no "
                         "cross-domain transfer (stays in DRAM domain)")
        layers.append(LayerPlan(b.mixer, tuple(placements), tuple(cuts),
                                unit.repeats))

    has_kv = any(u.block.mixer in ("attn", "attn_shared", "mla")
                 for u in build_plan(cfg))
    if not has_kv:
        notes.append("attention-free: KV tiering (T2) inapplicable; "
                     "recurrent state is Tier-0-resident by construction")
    if cfg.is_encoder:
        notes.append("encoder-only: no autoregressive cache; KV tiering "
                     "inapplicable")
    return MappingPlan(
        arch=cfg.name,
        layers=tuple(layers),
        kv_tiering=has_kv and not cfg.is_encoder,
        kv_policy=cfg.kv_policy,
        notes=tuple(notes),
    )
