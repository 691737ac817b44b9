"""The benchmark's own work formulas and the table of the card's peaks.

Every count here is taken from a configuration file's sizes, never from
the program, so a later change to the program cannot change what a
roofline share or a `mfu` is measured against. FLOPs count 2 per
multiply-add and only the products (norms, rotary, softmax and the
activations are left out). Bytes count each input read once and each
output written once, at the width the cell serves in.

A roofline's least time is max(FLOPs / peak FLOP/s, bytes / peak B/s),
summed over the calls of a range; its share is that least time over the
device time the range's kernels took.
"""

from __future__ import annotations

import dataclasses

# Published dense peaks of one card (NVIDIA data sheets, no sparsity),
# picked by the name `torch.cuda.get_device_name()` gives. "tf32" is the
# TF32 tensor cores' rate, the highest an f32-accurate product can use.
PEAKS = {
    "sxm": {"bw": 3.35e12, "bfloat16": 989e12, "float32": 495e12},
    "pcie": {"bw": 2.0e12, "bfloat16": 756e12, "float32": 378e12},
    "nvl": {"bw": 3.9e12, "bfloat16": 835e12, "float32": 417.5e12},
}


def peaks(device_name: str) -> dict:
    """The peak table of an H100 by its name (SXM unless PCIe or NVL)."""
    if "PCIe" in device_name:
        return PEAKS["pcie"]
    if "NVL" in device_name:
        return PEAKS["nvl"]
    return PEAKS["sxm"]


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of a dense GQA decoder that the formulas read."""
    D: int           # hidden size
    H: int           # query heads
    Hkv: int         # key / value heads
    Dh: int          # head size
    F: int           # FFN width
    V: int           # vocabulary
    L: int           # layers
    gated: bool      # gated FFN: three weight matrices, else two
    qkv_bias: bool
    Fv: int = 0      # width of the visual features (0: text only)


def dims(config: dict) -> Dims:
    """`Dims` of a configuration file."""
    D, H = config["hidden_size"], config["num_attention_heads"]
    return Dims(D=D, H=H, Hkv=config["num_key_value_heads"],
                Dh=config.get("head_dim", D // H),
                F=config["intermediate_size"], V=config["vocab_size"],
                L=config["num_hidden_layers"],
                gated=config["hidden_act"] in ("silu", "gelu_gated"),
                qkv_bias=bool(config.get("qkv_bias",
                                         config.get("use_qkv_bias", False))),
                Fv=config.get("mm_hidden_size", 0))


def bound_s(flops: float, nbytes: float, pk: dict, dtype: str) -> float:
    """The least time of a piece of work on the card."""
    return max(flops / pk[dtype], nbytes / pk["bw"])


# ---------------------------------------------------------------------------
# pieces of one layer
# ---------------------------------------------------------------------------
def attn_weights(d: Dims) -> int:
    """Elements of the attention block's weights (and biases)."""
    n = d.D * (d.H + 2 * d.Hkv) * d.Dh + d.H * d.Dh * d.D
    if d.qkv_bias:
        n += (d.H + 2 * d.Hkv) * d.Dh + d.D
    return n


def ffn_weights(d: Dims) -> int:
    return (3 if d.gated else 2) * d.D * d.F


def causal_pairs(pos: int, rows: int) -> int:
    """(query, key) pairs of ``rows`` queries at positions pos.. that each
    see every key up to their own position."""
    return rows * pos + rows * (rows + 1) // 2


def attn_core_flops(d: Dims, pairs: int) -> int:
    """Scores and the weighted sum of values over ``pairs`` pairs."""
    return 4 * d.H * d.Dh * pairs


def qkv_out_flops(d: Dims, rows: int) -> int:
    return 2 * rows * (d.D * (d.H + 2 * d.Hkv) * d.Dh + d.H * d.Dh * d.D)


def ffn_flops(d: Dims, rows: int) -> int:
    return 2 * rows * ffn_weights(d)


def ffn_bytes(d: Dims, rows: int, wbytes: int) -> int:
    """The FFN's weights read once, its rows in and out."""
    return ffn_weights(d) * wbytes + 2 * rows * d.D * wbytes


def layer_matmul_params(d: Dims) -> int:
    return d.D * (d.H + 2 * d.Hkv) * d.Dh + d.H * d.Dh * d.D \
        + ffn_weights(d)


def head_flops(d: Dims, rows: int) -> int:
    return 2 * rows * d.D * d.V


def connector_flops(d: Dims, rows: int) -> int:
    """The two-layer MLP connector over ``rows`` visual features."""
    return 2 * rows * (d.Fv * d.D + d.D * d.D)


# ---------------------------------------------------------------------------
# the tiered KV store (a bf16 hot ring of W positions, an int8 cold tier
# with one f32 scale per (position, kv head))
# ---------------------------------------------------------------------------
def kv_read_bytes(d: Dims, length: int, W: int, abytes: int) -> int:
    """K and V of one slot's ``length`` live positions, as the tiered
    store holds them: the newest min(length, W) in the hot ring, the rest
    as int8 with their scales."""
    hot = min(length, W)
    cold = length - hot
    return 2 * d.Hkv * (hot * d.Dh * abytes + cold * (d.Dh + 4))


def kv_commit_bytes(d: Dims, length: int, W: int, abytes: int) -> int:
    """Folding a prompt of ``length`` positions from the full-precision
    workspace into the store: the workspace read, every position written
    to the cold tier with its scale, the last W to the hot ring."""
    per = d.Hkv * d.Dh
    return 2 * (length * per * abytes + length * d.Hkv * (d.Dh + 4)
                + min(length, W) * per * abytes)


# ---------------------------------------------------------------------------
# ranges of the serving path (one layer's call)
# ---------------------------------------------------------------------------
def attn_extend_work(d: Dims, rows: int, pos: int, commit: bool, W: int,
                     abytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one layer's attention block over a prefill chunk
    of ``rows`` valid rows at positions pos..: Q/K/V, causal attention
    over every earlier position, the output projection, and on the last
    chunk the fold into the tiered store."""
    flops = qkv_out_flops(d, rows) \
        + attn_core_flops(d, causal_pairs(pos, rows))
    kv = d.Hkv * d.Dh * abytes
    nbytes = (attn_weights(d) * abytes + 2 * rows * d.D * abytes
              + 2 * rows * kv + 2 * (pos + rows) * kv)
    if commit:
        nbytes += kv_commit_bytes(d, pos + rows, W, abytes)
    return flops, nbytes


def attn_decode_work(d: Dims, lengths: list[int], W: int,
                     abytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one layer's attention block in a decode step of
    the active slots, whose contexts (the new token included) are
    ``lengths``: Q/K/V and the output projection for one row each, the
    new row written to the hot ring (and the row it evicts to the cold
    tier), and attention over each slot's live positions in the store."""
    rows = len(lengths)
    flops = qkv_out_flops(d, rows) + attn_core_flops(d, sum(lengths))
    nbytes = attn_weights(d) * abytes + 2 * rows * d.D * abytes
    for n in lengths:
        nbytes += kv_read_bytes(d, n, W, abytes)
        nbytes += 2 * d.Hkv * d.Dh * abytes
        if n > W:
            nbytes += 2 * d.Hkv * (d.Dh + 4)
    return flops, nbytes


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------
def chunk_flops(d: Dims, rows: int, pos: int, visual: bool,
                commit: bool) -> int:
    """One prefill chunk of ``rows`` valid rows at positions pos.. through
    the whole model: the connector on visual rows, every layer, and the
    head on the prompt's last row when the chunk commits."""
    f = d.L * (2 * rows * layer_matmul_params(d)
               + attn_core_flops(d, causal_pairs(pos, rows)))
    if visual:
        f += connector_flops(d, rows)
    if commit:
        f += head_flops(d, 1)
    return f


def decode_flops(d: Dims, lengths: list[int]) -> int:
    """One decode step of the active slots (contexts ``lengths``, the new
    token included): every layer and the head, one row a slot."""
    rows = len(lengths)
    return d.L * (2 * rows * layer_matmul_params(d)
                  + attn_core_flops(d, sum(lengths))) + head_flops(d, rows)


def forward_flops(d: Dims, batch: int, seq: int, visual_rows: int,
                  pairs: int | None = None) -> int:
    """A full-sequence forward of ``batch`` rows of ``seq`` positions, the
    first ``visual_rows`` of each from the connector, logits at every
    position. ``pairs`` a row defaults to the causal count."""
    pairs = causal_pairs(0, seq) if pairs is None else pairs
    return batch * (d.L * (2 * seq * layer_matmul_params(d)
                           + attn_core_flops(d, pairs))
                    + head_flops(d, seq)
                    + connector_flops(d, visual_rows))


def train_step_flops(d: Dims, batch: int, seq: int, visual_rows: int,
                     pairs: int | None = None) -> int:
    """A training step: the forward and twice its products backward,
    less the gradient of the visual features, which nothing needs."""
    return 3 * forward_flops(d, batch, seq, visual_rows, pairs) \
        - 2 * batch * visual_rows * d.Fv * d.D
