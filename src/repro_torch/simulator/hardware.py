"""Hardware models for the CHIME analytical simulator (paper §IV-A2).

Device parameters are from Tables III/IV of the paper. Two constants are
*calibrated* (the paper's in-house simulator is not public):

* ``internal_bw`` — near-memory streaming bandwidth seen by the NMP.
  For M3D DRAM the paper exposes 16 channels x 16 banks with 32 Kb row
  buffers over dense MIVs; we model 1.6 TB/s aggregate (≈100 GB/s/channel
  via vertical MIV stitching — the M3D selling point vs ~8 GB/s/channel
  external DDR pins). For M3D RRAM the 512 GB/s figure in Table III is the
  controller interface; per-tile H-trees (64 per tile, 256 macros) feed
  the PU cluster at an aggregate we model as 1.28 TB/s.
* ``layer_overhead_s`` — per-transformer-layer serialization residual
  (row-activation chains, tier access latency 3+0.8L ns, SFPE softmax
  serialization, UCIe hop). Calibrated at 45 µs so absolute TPS for the
  4 evaluated models lands in the paper's reported 233-533 tok/s band;
  the *relative* trends (model scaling, heterogeneous-vs-DRAM-only,
  sequence-length linearity) come out of the first-principles terms.

Energy: DRAM 0.429 pJ/bit R/W (Table IV); RRAM 0.4 pJ/bit read, 1.33 pJ/bit
write (Table III); UCIe 0.6 pJ/bit [ISSCC'25 ref 23]; compute 0.3 pJ/FLOP
at 7 nm FP16; static = peak power of each NMP die.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MemoryDomain:
    name: str
    internal_bw: float          # B/s seen by near-memory compute
    peak_flops: float           # NMP FLOP/s
    read_energy_pj_bit: float
    write_energy_pj_bit: float
    static_power_w: float
    capacity_bytes: float


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    domains: dict[str, MemoryDomain]
    cross_domain_bw: float      # UCIe B/s (0 => single domain)
    cross_domain_pj_bit: float
    layer_overhead_s: float
    compute_pj_flop: float
    # for monolithic (GPU-style) platforms
    fixed_token_overhead_s: float = 0.0
    power_w: float | None = None


M3D_DRAM = MemoryDomain(
    name="m3d_dram",
    internal_bw=1.6e12,
    peak_flops=2e12,            # Table IV: 2 TFLOPS FP16
    read_energy_pj_bit=0.429,   # Table IV
    write_energy_pj_bit=0.429,
    static_power_w=0.671,       # Table IV peak power
    capacity_bytes=6.25e9,      # 5 tiers x 1.25 GB
)

M3D_RRAM = MemoryDomain(
    name="m3d_rram",
    internal_bw=1.6e12,
    peak_flops=32e12,           # Table III: 32 TFLOPS
    read_energy_pj_bit=0.4,     # Table III
    write_energy_pj_bit=1.33,
    static_power_w=2.584,       # Table III peak power
    capacity_bytes=2e9,
)

CHIME = Platform(
    name="CHIME",
    domains={"dram": M3D_DRAM, "rram": M3D_RRAM},
    cross_domain_bw=128e9,      # UCIe x64 @ 32 GT/s [23]
    cross_domain_pj_bit=0.6,    # [23]
    layer_overhead_s=45e-6,     # calibrated — see module docstring
    compute_pj_flop=0.3,
)

# Fig. 9 ablation: FFN lives in (a second) M3D DRAM stack; attention and
# FFN contend for DRAM bandwidth and the FFN runs on the 2 TFLOPS DRAM NMP.
DRAM_ONLY = Platform(
    name="M3D-DRAM-only",
    domains={"dram": dataclasses.replace(
                 M3D_DRAM, internal_bw=0.8e12),
             "rram": dataclasses.replace(
                 M3D_DRAM, name="m3d_dram_ffn",
                 # FFN shares the one stack: attention traffic contends
                 # (both kernel classes see ~half the stream bandwidth),
                 # and the FFN weights spill to the upper, slower tiers of
                 # the 200-layer stack (read latency 3+0.8L ns/row) —
                 # paper: "FFN weights overwhelm DRAM-centric M3D DRAM".
                 internal_bw=0.4e12, peak_flops=2e12)},
    cross_domain_bw=0.0,
    cross_domain_pj_bit=0.0,
    layer_overhead_s=45e-6,
    compute_pj_flop=0.3,
)

JETSON_ORIN_NX = Platform(
    name="Jetson Orin NX",
    domains={"dram": MemoryDomain(
        name="lpddr5",
        internal_bw=102.4e9 * 0.85,   # datasheet BW x streaming util
        peak_flops=17e12,             # FP16 dense
        read_energy_pj_bit=18.0,      # off-chip LPDDR5 access
        write_energy_pj_bit=18.0,
        static_power_w=8.0,
        capacity_bytes=16e9,
    )},
    cross_domain_bw=0.0,
    cross_domain_pj_bit=0.0,
    layer_overhead_s=0.0,
    compute_pj_flop=1.3,              # 8 nm GPU
    # measured edge-stack dispatch/graph-launch overhead per token
    # (calibrated so TPS spans the paper's narrow 7.4-11 band across
    # 0.6B-3B — small models are overhead-bound on Jetson, which is
    # exactly the paper's motivation)
    fixed_token_overhead_s=80e-3,
    power_w=10.0,
)

# background controller + UCIe PHY power while the accelerator is active
# (paper Fig. 7: "the UCIe link draws about 1 W")
CHIME_UNCORE_W = 1.0

# FACIL [30] is compared via its published Table V numbers, not simulated.
FACIL = {
    "name": "FACIL",
    "throughput_tps": (7.7, 19.3),
    "power_w": (5.7, 38.5),
    "energy_token_j": (0.50, 1.35),
    "die_area_mm2": 200.0,
}

# Table V context rows
TABLE_V_STATIC = {
    "Jetson Orin NX": {"node_nm": 8, "freq_ghz": 0.92, "area_mm2": 200.0,
                       "power_w": (10, 40), "tps": (7.4, 11),
                       "tok_per_j": (0.28, 0.74)},
    "FACIL": {"node_nm": 15, "freq_ghz": 3.2, "area_mm2": 200.0,
              "power_w": (5.7, 38.5), "tps": (7.7, 19.3),
              "tok_per_j": (0.50, 1.35)},
    "CHIME (paper)": {"node_nm": (28, 35), "freq_ghz": 1.0,
                      "area_mm2": (28.71, 24.85), "power_w": 2.0,
                      "tps": (233, 533), "tok_per_j": (116.5, 266.5)},
}
