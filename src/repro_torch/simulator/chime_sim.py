"""CHIME analytical simulator — the paper-fidelity instrument (§IV).

Simulates end-to-end VQA inference (image -> visual tokens -> prefill ->
decode) per platform, at the granularity of the fused kernels in Table I,
with operator placement taken from the SAME MappingPlan the runtime
executes (core/planner.py). Per kernel:

    t = max(flops / domain.peak_flops, bytes / domain.internal_bw)
    e = bytes * read_pj_bit + flops * pj_flop (+ write energy for KV/cut
        tensors, + UCIe energy at the two cut points)

Decode is sequential per the paper's dataflow: attention(t+1) waits for
FFN(t); exactly AttnOut/FFNOut cross UCIe per layer.

Port of the reference's `simulator/chime_sim.py`, line for line: pure
Python over the port's config, planner and counting modules. The term
order and the `math.fsum` folds are kept exactly, so every total equals
the reference's bit for bit on the same config and trace.
"""

from __future__ import annotations

import dataclasses
import math
import typing

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner import plan_for
from repro_torch.models.counting import (kv_bytes_per_token, param_dtype_bytes,
                                   streamed_unit_indices)
from repro_torch.simulator.hardware import CHIME, Platform


@dataclasses.dataclass
class Workload:
    text_tokens: int = 128
    output_tokens: int = 488
    image: bool = True            # 512x512 astronaut (paper default)


@dataclasses.dataclass
class SimResult:
    platform: str
    model: str
    prefill_s: float
    decode_s: float
    total_s: float
    energy_j: float
    tps: float                    # output tokens / total time
    tokens_per_j: float
    avg_power_w: float
    breakdown: dict


def _layer_kernels(cfg: ModelConfig) -> list[dict]:
    """Per-layer fused kernels with per-token flops/bytes (decode GEMV).
    Layers of a streamed scan unit (``cfg.weight_stream_layers``) carry
    ``streamed=True`` so the weight-stream pricing knows whose projection
    weights live in the RRAM tier."""
    D = cfg.d_model
    streamed = set(streamed_unit_indices(cfg))
    out = []
    for uidx, unit_plan in enumerate(plan_for(cfg).layers):
        for _ in range(unit_plan.repeats):
            kerns = []
            if unit_plan.mixer in ("attn", "attn_shared"):
                qkv = D * (cfg.num_heads + 2 * cfg.num_kv_heads) \
                    * cfg.head_dim
                o = cfg.num_heads * cfg.head_dim * D
                kerns.append(("FUSED_QKV_PROJ", "dram", 2 * qkv, 2 * qkv))
                kerns.append(("ATTN_OUT_PROJ", "dram", 2 * o, 2 * o))
                kerns.append(("FUSED_ATTN_STREAM", "dram", 0, 0))  # KV below
            elif unit_plan.mixer == "mla":
                m = cfg.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                w = (D * cfg.num_heads * qk + D * m.kv_lora_rank
                     + D * m.qk_rope_head_dim
                     + m.kv_lora_rank * cfg.num_heads
                     * (m.qk_nope_head_dim + m.v_head_dim)
                     + cfg.num_heads * m.v_head_dim * D)
                kerns.append(("MLA_PROJ", "dram", 2 * w, 2 * w))
                kerns.append(("FUSED_ATTN_STREAM", "dram", 0, 0))
            elif unit_plan.mixer == "rwkv6":
                w = 3 * D * D + D * D + D * D
                kerns.append(("RWKV6_TIMEMIX", "dram", 2 * w, 2 * w))
            elif unit_plan.mixer == "mamba2":
                d_inner = cfg.ssm.expand * D
                w = D * (2 * d_inner + 2 * cfg.ssm.state_dim) + d_inner * D
                kerns.append(("MAMBA2_SSD", "dram", 2 * w, 2 * w))
            blk = unit_plan
            has_ffn = any(p.op in ("ffn", "moe_ffn", "channel_mix")
                          for p in blk.placements)
            if has_ffn:
                if cfg.mlp_type == "moe" and cfg.moe:
                    m = cfg.moe
                    w = m.top_k * 3 * D * m.d_ff_expert \
                        + m.num_shared_experts * 3 * D * (
                            m.d_ff_shared or m.d_ff_expert)
                elif cfg.mlp_type in ("silu_gated", "gelu_gated"):
                    w = 3 * D * cfg.d_ff
                elif cfg.mlp_type == "rwkv_cm":
                    w = 2 * D * cfg.d_ff + D * D
                else:
                    w = 2 * D * cfg.d_ff
                kerns.append(("FUSED_FFN_ACT", "rram", 2 * w, 2 * w))
            out.append({"kernels": kerns,
                        "has_attn": unit_plan.mixer in (
                            "attn", "attn_shared", "mla"),
                        "has_ffn": has_ffn,
                        "streamed": uidx in streamed})
    return out


def _kernel_time_energy(domain, flops: float, bytes_r: float,
                        pj_flop: float, weight_dtype_bytes: float = 2.0
                        ) -> tuple[float, float]:
    """Time/energy of one kernel on ``domain``. The kernel table's static
    byte counts assume bf16 weights; ``weight_dtype_bytes`` rescales them
    to the stored dtype (1.0 for int8, 4.0 for f32) before pricing."""
    bytes_r = bytes_r * (weight_dtype_bytes / 2.0)
    t = max(flops / domain.peak_flops, bytes_r / domain.internal_bw)
    e = bytes_r * 8 * domain.read_energy_pj_bit * 1e-12 \
        + flops * pj_flop * 1e-12
    return t, e


def visual_tokens(cfg: ModelConfig) -> int:
    return cfg.frontend.num_tokens if cfg.frontend else 0


class CostTerm(typing.NamedTuple):
    """One atomic priced event: a kernel's memory stream, its MACs, a UCIe
    cut, a KV append write, a spill transfer, or a closing static-power
    charge. Every simulated cost in this module decomposes into a flat
    list of these, and every aggregate is a `math.fsum` over them — fsum
    is correctly rounded and therefore order-independent, so two code
    paths that price the SAME multiset of terms (e.g. the serving
    telemetry ledger step-by-step vs. `simulated_efficiency` end-of-run)
    produce bitwise-identical totals."""

    name: str
    domain: str        # dram|rram|compute|ucie|kv_write|overhead|encoder
    #                  # |spill|prefix|static|skipped|weight_stream
    time_s: float
    energy_j: float
    bytes_moved: float


# Deterministic priced skip fraction of the cold-tier read under the
# SLIM-style sparse read (sparse_tau > 0). The kernel's measured skip rate
# is data-dependent (it compares per-page score upper bounds against the
# live running max), which an analytical cost model cannot see; the ledger
# and `simulated_efficiency` both price this MODELED fraction of the cold
# bytes as skipped (zero time, zero energy, bytes under the `skipped`
# domain) so the two stay reconciled bit-for-bit. Benchmarks report the
# modeled figure — README documents the contract.
SPARSE_READ_PRICED_SKIP = 0.5


def _hot_itemsize(cfg: ModelConfig) -> int:
    """Bytes per hot-ring element (the telemetry ledger's accounting)."""
    if cfg.compute_dtype == "bfloat16":
        return 2
    import numpy as np
    return int(np.dtype(cfg.compute_dtype).itemsize)


def cost_layers(cfg: ModelConfig) -> list[dict]:
    """Public handle on the per-layer fused-kernel table so callers that
    price many events (the telemetry ledger, `simulated_efficiency`) can
    plan once and share."""
    return _layer_kernels(cfg)


def _kernel_terms(name: str, dom_name: str, dom, flops: float,
                  bytes_r: float, pj_flop: float) -> list[CostTerm]:
    """A fused kernel as two terms: the near-memory stream (carries the
    kernel's time and byte energy on its home domain) and the MACs
    (energy only, attributed to `compute`)."""
    t = max(flops / dom.peak_flops, bytes_r / dom.internal_bw)
    return [
        CostTerm(name, dom_name, t,
                 bytes_r * 8 * dom.read_energy_pj_bit * 1e-12,
                 float(bytes_r)),
        CostTerm(name + "/mac", "compute", 0.0,
                 flops * pj_flop * 1e-12, 0.0),
    ]


def _layer_weight_raw_bytes(lay: dict) -> float:
    """One layer's static projection-weight bytes as the kernel table
    states them (bf16): the DRAM-domain weight kernels. FFN weights are
    excluded — they already live beside the RRAM near-memory compute and
    never cross a tier. The attention KV stream is not a weight read."""
    return float(sum(b for (name, dom, _f, b) in lay["kernels"]
                     if dom == "dram" and name != "FUSED_ATTN_STREAM"))


def layer_stream_bytes(cfg: ModelConfig, lay: dict) -> float:
    """Dtype-correct bytes of ONE streamed layer's RRAM weight read,
    rescaled from the kernel table's bf16 assumption to the stored
    param dtype."""
    return _layer_weight_raw_bytes(lay) * (param_dtype_bytes(cfg) / 2.0)


def weight_stream_layer_terms(cfg: ModelConfig, platform: Platform,
                              lay: dict, hide_s: float) -> list[CostTerm]:
    """The weight-stream cost of ONE streamed layer in one step: the RRAM
    read of the layer's projection-weight slice (dtype-correct via the
    honored `_kernel_time_energy`) plus its UCIe hop into the DRAM
    prefetch window. The layer-ahead prefetch overlaps the fetch with the
    layer's own compute/stream time (``hide_s``), so only the residual
    stall carries time; the read/transfer ENERGY is paid in full —
    overlap hides latency, not joules. The UCIe term carries zero bytes
    (the read term already counts the slice once — the spill ``/ucie``
    convention)."""
    rram = platform.domains.get("rram", platform.domains["dram"])
    raw = _layer_weight_raw_bytes(lay)
    wdt = float(param_dtype_bytes(cfg))
    rt, re = _kernel_time_energy(rram, 0.0, raw, platform.compute_pj_flop,
                                 weight_dtype_bytes=wdt)
    wb = raw * (wdt / 2.0)
    hop_t = hop_e = 0.0
    if platform.cross_domain_bw:
        hop_t = wb / platform.cross_domain_bw
        hop_e = wb * 8 * platform.cross_domain_pj_bit * 1e-12
    stall = max(0.0, rt + hop_t - hide_s)
    terms = [CostTerm("WEIGHT_STREAM", "weight_stream", stall, re, wb)]
    if hop_e:
        terms.append(CostTerm("WEIGHT_STREAM/ucie", "weight_stream",
                              0.0, hop_e, 0.0))
    return terms


def decode_token_terms(cfg: ModelConfig, platform: Platform, ctx: int,
                       layers: list[dict] | None = None,
                       fused: bool = False,
                       sparse_tau: float = 0.0,
                       weight_stream: bool = False) -> list[CostTerm]:
    """The cost terms of ONE decode step at context length ``ctx``.

    ``fused`` prices the fused paged-decode kernel over a tiered store:
    the hot ring streams full-precision from DRAM while the cold pages
    stream int8 (+ f32 scales) from the RRAM tier — exactly the byte
    split the telemetry ledger's hot/cold row counters report, so the
    two reconcile. With ``sparse_tau`` > 0 the modeled
    `SPARSE_READ_PRICED_SKIP` fraction of the cold bytes moves to a
    zero-cost `skipped` term. A fused FLAT store touches the same bytes
    as the unfused path and is priced identically.

    ``weight_stream`` adds, per layer flagged ``streamed`` in the table,
    the RRAM weight-read + UCIe terms of `weight_stream_layer_terms` —
    the projection-weight slice fetched into the DRAM window every step
    (the window is transit storage, so a streamed unit refetches all its
    repeats per token). The resident kernels are left untouched: the
    compute side still reads the staged slice from DRAM exactly as the
    resident model does, so streamed pricing is resident + fetch."""
    if layers is None:
        layers = _layer_kernels(cfg)
    n_layers = len(layers)
    dram = platform.domains["dram"]
    rram = platform.domains["rram"] if "rram" in platform.domains else dram
    D = cfg.d_model
    ucie_t_per_cut = (2 * D / platform.cross_domain_bw
                      if platform.cross_domain_bw else 0.0)
    ucie_e_per_cut = (2 * D * 8 * platform.cross_domain_pj_bit * 1e-12
                      if platform.cross_domain_bw else 0.0)
    kv_tok = kv_bytes_per_token(cfg)
    n_attn = max(sum(1 for l in layers if l["has_attn"]), 1)
    fused_tiered = fused and cfg.kv_policy == "tiered"
    if fused_tiered:
        from repro_torch.models.counting import (kv_elems_per_token,
                                           kv_scale_elems_per_token)
        W = cfg.kv_hot_window
        hot_b = kv_elems_per_token(cfg) * min(ctx, W) * _hot_itemsize(cfg)
        cold_b = max(ctx - W, 0) * (kv_elems_per_token(cfg)
                                    + 4 * kv_scale_elems_per_token(cfg))
        skip_b = cold_b * SPARSE_READ_PRICED_SKIP if sparse_tau > 0 else 0.0
        touched_b = cold_b - skip_b
    terms: list[CostTerm] = []
    for lay in layers:
        lay_start = len(terms)
        for name, dom_name, flops, bytes_r in lay["kernels"]:
            dom = dram if dom_name == "dram" else rram
            if name == "FUSED_ATTN_STREAM":
                if fused_tiered:
                    hb, cb, sb = (hot_b / n_attn, touched_b / n_attn,
                                  skip_b / n_attn)
                    terms += _kernel_terms(
                        "FUSED_PAGED_DECODE", "dram", dram, hb, hb,
                        platform.compute_pj_flop)
                    terms += _kernel_terms(
                        "FUSED_PAGED_DECODE/cold", "rram", rram, cb, cb,
                        platform.compute_pj_flop)
                    if sb:
                        terms.append(CostTerm(
                            "FUSED_PAGED_DECODE/skip", "skipped",
                            0.0, 0.0, sb))
                    continue
                # stream the KV cache for this layer
                bytes_r = kv_tok / n_attn * ctx
                flops = bytes_r  # ~1 MAC per cached byte at fp16
            terms += _kernel_terms(name, dom_name, dom, flops, bytes_r,
                                   platform.compute_pj_flop)
        if lay["has_ffn"]:
            # AttnOut -> RRAM and FFNOut -> DRAM cross UCIe (2 cuts)
            terms.append(CostTerm(
                "UCIE_CUT", "ucie", 2 * ucie_t_per_cut, 2 * ucie_e_per_cut,
                2 * 2 * D if platform.cross_domain_bw else 0.0))
        # KV append write energy (DRAM tier-0; write-once discipline)
        terms.append(CostTerm(
            "KV_APPEND", "kv_write", 0.0,
            kv_tok / max(n_layers, 1) * 8
            * dram.write_energy_pj_bit * 1e-12,
            kv_tok / max(n_layers, 1)))
        if weight_stream and lay.get("streamed"):
            hide = math.fsum(t.time_s for t in terms[lay_start:])
            terms += weight_stream_layer_terms(cfg, platform, lay, hide)
    terms.append(CostTerm(
        "STEP_OVERHEAD", "overhead",
        platform.layer_overhead_s * n_layers
        + platform.fixed_token_overhead_s, 0.0, 0.0))
    return terms


def prefill_terms(cfg: ModelConfig, platform: Platform, text_tokens: int,
                  image: bool,
                  layers: list[dict] | None = None,
                  cached_prefix: int = 0,
                  weight_stream: bool = False) -> list[CostTerm]:
    """The cost terms of one whole-prompt prefill (weights read once per
    layer and reused across prompt tokens; compute scales with prompt).

    ``cached_prefix`` > 0 prices a prefix-cache hit: only the
    ``prompt - cached_prefix`` tail tokens run through the projection /
    mixer kernels (the hit positions' KV is adopted from the shared
    block store — priced separately by `prefix_adopt_terms`), while the
    attention stream still reads the FULL prompt's KV for the tail's
    attention. ``cached_prefix=0`` is term-for-term identical to the
    historical whole-prompt pricing.

    ``weight_stream`` adds one `weight_stream_layer_terms` fetch per
    streamed layer (weights cross the tier once per prefill, whatever
    the prompt length — the same read-once shape as the resident
    kernels). Chunked prefills are priced whole-prompt at commit, so the
    fetch is charged exactly once per request either way."""
    if layers is None:
        layers = _layer_kernels(cfg)
    n_layers = len(layers)
    dram = platform.domains["dram"]
    rram = platform.domains["rram"] if "rram" in platform.domains else dram
    D = cfg.d_model
    vis = visual_tokens(cfg) if image else 0
    prompt = vis + text_tokens
    cached = min(max(int(cached_prefix), 0), prompt)
    tail = prompt - cached
    kv_tok = kv_bytes_per_token(cfg)
    terms: list[CostTerm] = []
    for lay in layers:
        lay_start = len(terms)
        for name, dom_name, flops, bytes_r in lay["kernels"]:
            dom = dram if dom_name == "dram" else rram
            if name == "FUSED_ATTN_STREAM":
                flops = 2.0 * tail * prompt * D
                bytes_r = prompt * kv_tok / max(n_layers, 1)
            else:
                flops = flops * tail
            terms += _kernel_terms(name, dom_name, dom, flops, bytes_r,
                                   platform.compute_pj_flop)
        if weight_stream and lay.get("streamed"):
            hide = math.fsum(t.time_s for t in terms[lay_start:])
            terms += weight_stream_layer_terms(cfg, platform, lay, hide)
    # vision encoder stub cost: FastViT/ViT on 512^2 ~ 10-40 GFLOP.
    # A cache hit covering the whole visual span skips the encoder —
    # the shared image was encoded when its blocks were registered.
    if image and cfg.frontend is not None and cached < vis:
        enc_flops = 20e9
        terms.append(CostTerm(
            "VISION_ENCODER", "encoder", enc_flops / dram.peak_flops,
            enc_flops * platform.compute_pj_flop * 1e-12, 0.0))
    terms.append(CostTerm(
        "PREFILL_OVERHEAD", "overhead",
        platform.layer_overhead_s * n_layers
        + platform.fixed_token_overhead_s, 0.0, 0.0))
    return terms


def spill_terms(cfg: ModelConfig, platform: Platform, ctx: int,
                restore: bool = False,
                compressed: bool = False) -> list[CostTerm]:
    """The cost terms of moving ONE request's ``ctx``-token KV image
    between the DRAM stack and the RRAM spill store across UCIe — the
    RRAM write (spill) or read (restore) plus the UCIe transfer, both
    under the `spill` domain so spill traffic stays separable from model
    compute in every energy split."""
    per_tok = kv_bytes_per_token(cfg)
    if compressed and cfg.kv_policy == "tiered":
        from repro_torch.models.counting import (kv_elems_per_token,
                                           kv_scale_elems_per_token)
        per_tok = kv_elems_per_token(cfg) \
            + 4 * kv_scale_elems_per_token(cfg)
    kv_bytes = per_tok * max(ctx, 0)
    rram = platform.domains.get("rram", platform.domains["dram"])
    bw = rram.internal_bw
    ucie_e = 0.0
    if platform.cross_domain_bw:
        bw = min(bw, platform.cross_domain_bw)
        ucie_e = kv_bytes * 8 * platform.cross_domain_pj_bit * 1e-12
    pj_bit = (rram.read_energy_pj_bit if restore
              else rram.write_energy_pj_bit)
    name = "KV_RESTORE" if restore else "KV_SPILL"
    terms = [CostTerm(name, "spill", kv_bytes / bw if bw else 0.0,
                      kv_bytes * 8 * pj_bit * 1e-12, float(kv_bytes))]
    if ucie_e:
        terms.append(CostTerm(name + "/ucie", "spill", 0.0, ucie_e, 0.0))
    return terms


def prefix_adopt_terms(cfg: ModelConfig, platform: Platform,
                       tokens: int) -> list[CostTerm]:
    """The cost terms of gathering ``tokens`` cached prefix positions
    from the shared RRAM-resident block store into a fresh prefill
    workspace on admission — the traffic a prefix-cache hit pays INSTEAD
    of recomputing those positions. Priced like a spill restore (RRAM
    read + UCIe transfer, bounded by the slower link) but under its own
    ``prefix`` domain so skipped-prefill traffic stays separable in
    every energy split."""
    kv_bytes = kv_bytes_per_token(cfg) * max(int(tokens), 0)
    rram = platform.domains.get("rram", platform.domains["dram"])
    bw = rram.internal_bw
    ucie_e = 0.0
    if platform.cross_domain_bw:
        bw = min(bw, platform.cross_domain_bw)
        ucie_e = kv_bytes * 8 * platform.cross_domain_pj_bit * 1e-12
    terms = [CostTerm("PREFIX_ADOPT", "prefix",
                      kv_bytes / bw if bw else 0.0,
                      kv_bytes * 8 * rram.read_energy_pj_bit * 1e-12,
                      float(kv_bytes))]
    if ucie_e:
        terms.append(CostTerm("PREFIX_ADOPT/ucie", "prefix", 0.0,
                              ucie_e, 0.0))
    return terms


def closing_terms(platform: Platform,
                  terms: list[CostTerm]) -> list[CostTerm]:
    """Static/uncore power charges that close out a priced term stream.

    Monolithic platforms (``power_w`` set) charge board power over the
    whole busy wall; the chiplet platform duty-cycles NMP static power
    over each domain's busy time plus the always-on uncore (paper Fig. 7:
    ~1 W). Spill- and prefix-domain terms are excluded — that traffic
    happens off the critical decode path and `simulated_efficiency` has
    always priced it additively, outside the per-request closing
    charge."""
    total = math.fsum(t.time_s for t in terms
                      if t.domain not in ("spill", "prefix"))
    if platform.power_w is not None:
        return [CostTerm("BOARD_STATIC", "static", 0.0,
                         platform.power_w * total, 0.0)]
    from repro_torch.simulator.hardware import CHIME_UNCORE_W
    dram = platform.domains["dram"]
    rram = platform.domains.get("rram", dram)
    busy_d = math.fsum(t.time_s for t in terms if t.domain == "dram")
    busy_r = math.fsum(t.time_s for t in terms if t.domain == "rram")
    return [
        CostTerm("DRAM_STATIC", "static", 0.0,
                 dram.static_power_w * busy_d, 0.0),
        CostTerm("RRAM_STATIC", "static", 0.0,
                 rram.static_power_w * busy_r, 0.0),
        CostTerm("UNCORE", "static", 0.0, CHIME_UNCORE_W * total, 0.0),
    ]


def request_terms(cfg: ModelConfig, platform: Platform, text_tokens: int,
                  output_tokens: int, image: bool,
                  layers: list[dict] | None = None,
                  cached_prefix: int = 0,
                  fused: bool = False,
                  sparse_tau: float = 0.0,
                  weight_stream: bool = False) -> list[CostTerm]:
    """Every cost term of one served request: prefill (tail-only when
    ``cached_prefix`` positions came from the shared prefix store, plus
    the adoption transfer), each decode step at its growing context, and
    the closing static charge — the unit `simulated_efficiency` and the
    telemetry ledger both sum. ``fused``/``sparse_tau`` select the fused
    paged-decode pricing for the decode steps (see `decode_token_terms`);
    ``weight_stream`` adds the RRAM weight-fetch terms of the streamed
    layers to prefill and every decode step."""
    if layers is None:
        layers = _layer_kernels(cfg)
    terms = prefill_terms(cfg, platform, text_tokens, image, layers,
                          cached_prefix=cached_prefix,
                          weight_stream=weight_stream)
    if cached_prefix > 0:
        terms += prefix_adopt_terms(cfg, platform, cached_prefix)
    prompt = (visual_tokens(cfg) if image else 0) + text_tokens
    for step in range(output_tokens):
        terms += decode_token_terms(cfg, platform, prompt + step, layers,
                                    fused=fused, sparse_tau=sparse_tau,
                                    weight_stream=weight_stream)
    terms += closing_terms(platform, terms)
    return terms


def sum_terms(terms: list[CostTerm]) -> dict:
    """Order-independent aggregate of a term stream: total simulated
    energy/time, the spill share, and the per-domain energy split. Both
    `simulated_efficiency` and the telemetry `TierLedger` report THIS —
    identical term multisets reconcile bit-for-bit."""
    split: dict[str, list[float]] = {}
    for tm in terms:
        split.setdefault(tm.domain, []).append(tm.energy_j)
    return {
        "sim_energy_j": math.fsum(tm.energy_j for tm in terms),
        "sim_total_s": math.fsum(tm.time_s for tm in terms),
        "sim_spill_energy_j": math.fsum(split.get("spill", ())),
        "sim_spill_s": math.fsum(tm.time_s for tm in terms
                                 if tm.domain == "spill"),
        "sim_energy_split_j": {d: math.fsum(v)
                               for d, v in sorted(split.items())},
    }


def decode_token_cost(cfg: ModelConfig, platform: Platform, ctx: int,
                      layers: list[dict] | None = None
                      ) -> tuple[float, float, dict]:
    """Analytical (time_s, energy_j, breakdown) of ONE decode step at
    context length ``ctx`` — the per-step cost term. `simulate` sums it
    over a growing context; the serving metrics feed it measured per-slot
    step counts instead. Backed by `decode_token_terms` — same multiset
    of priced events, folded into the legacy breakdown shape."""
    terms = decode_token_terms(cfg, platform, ctx, layers)
    tok_t = energy = 0.0
    br = {"dram_s": 0.0, "rram_s": 0.0, "attn_kv_s": 0.0, "ucie_s": 0.0,
          "busy_dram": 0.0, "busy_rram": 0.0}
    for tm in terms:
        tok_t += tm.time_s
        energy += tm.energy_j
        if tm.domain in ("dram", "rram"):
            br["busy_" + tm.domain] += tm.time_s
            if tm.name == "FUSED_ATTN_STREAM":
                br["attn_kv_s"] += tm.time_s
            elif tm.domain == "dram":
                br["dram_s"] += tm.time_s
            else:
                br["rram_s"] += tm.time_s
        elif tm.domain == "ucie":
            br["ucie_s"] += tm.time_s
    return tok_t, energy, br


def kv_spill_cost(cfg: ModelConfig, platform: Platform, ctx: int,
                  restore: bool = False,
                  compressed: bool = False) -> tuple[float, float]:
    """Analytical (time_s, energy_j) of moving ONE request's ``ctx``-token
    KV image between the DRAM stack and the RRAM spill store across UCIe
    — the per-event cost of a serving preemption or idle offload.
    Mirrors `decode_token_cost`'s terms: bytes from the same
    `kv_bytes_per_token` the capacity admission uses, time bounded by the
    slower of the UCIe link and the RRAM interface, energy from the RRAM
    write (spill) or read (restore) energy plus the UCIe transfer.
    ``compressed`` prices the int8 spill-lane codec instead: one byte per
    cached element plus the f32 per-(token, head) scales — the same byte
    math `serving.kv_pool.spill_lane_bytes` charges the RRAM budget. A
    flat (untiered) cache has no hot ring to compress, so its lanes are
    always verbatim and the flag is ignored (mirroring the backend).
    Backed by `spill_terms` — same priced events, folded to a pair."""
    terms = spill_terms(cfg, platform, ctx, restore=restore,
                        compressed=compressed)
    return (math.fsum(tm.time_s for tm in terms),
            math.fsum(tm.energy_j for tm in terms))


def simulate(cfg: ModelConfig, platform: Platform = CHIME,
             wl: Workload = Workload()) -> SimResult:
    layers = _layer_kernels(cfg)
    n_layers = len(layers)
    prompt = (visual_tokens(cfg) if wl.image else 0) + wl.text_tokens

    dram = platform.domains["dram"]
    rram = platform.domains["rram"] if "rram" in platform.domains else dram

    # ---- decode: per output token t (context grows) -------------------
    decode_s = 0.0
    energy = 0.0
    t_dram = t_rram = t_ucie = t_attn_kv = 0.0
    busy = {"dram": 0.0, "rram": 0.0}
    for step in range(wl.output_tokens):
        tok_t, tok_e, br = decode_token_cost(cfg, platform, prompt + step,
                                             layers)
        decode_s += tok_t
        energy += tok_e
        t_dram += br["dram_s"]
        t_rram += br["rram_s"]
        t_attn_kv += br["attn_kv_s"]
        t_ucie += br["ucie_s"]
        busy["dram"] += br["busy_dram"]
        busy["rram"] += br["busy_rram"]

    # ---- prefill (+ encoder/connector, paper: <15% of runtime) --------
    # weights read once per layer, reused across prompt tokens (batched
    # GEMM); compute scales with prompt length — priced by the same
    # `prefill_terms` the serving telemetry ledger records
    pre = prefill_terms(cfg, platform, wl.text_tokens, wl.image, layers)
    prefill_s = math.fsum(tm.time_s for tm in pre)
    energy += math.fsum(tm.energy_j for tm in pre)
    busy["dram"] += math.fsum(tm.time_s for tm in pre
                              if tm.domain == "dram")
    busy["rram"] += math.fsum(tm.time_s for tm in pre
                              if tm.domain == "rram")

    total = prefill_s + decode_s
    if platform.power_w is not None:
        # monolithic platform (GPU): board power over wall time
        energy += platform.power_w * total
    else:
        # chiplet platform: NMP dies power-gate when idle (duty-cycled
        # static power) + always-on uncore/UCIe (paper Fig. 7: ~1 W)
        from repro_torch.simulator.hardware import CHIME_UNCORE_W
        energy += dram.static_power_w * busy["dram"] \
            + rram.static_power_w * busy["rram"] \
            + CHIME_UNCORE_W * total
    tps = wl.output_tokens / total
    return SimResult(
        platform=platform.name,
        model=cfg.name,
        prefill_s=prefill_s,
        decode_s=decode_s,
        total_s=total,
        energy_j=energy,
        tps=tps,
        tokens_per_j=wl.output_tokens / energy,
        avg_power_w=energy / total,
        breakdown={"dram_s": t_dram, "rram_s": t_rram,
                   "attn_kv_s": t_attn_kv, "ucie_s": t_ucie,
                   "overhead_s": platform.layer_overhead_s * n_layers
                   * wl.output_tokens
                   + platform.fixed_token_overhead_s * wl.output_tokens},
    )
