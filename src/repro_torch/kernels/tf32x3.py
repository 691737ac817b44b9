"""The 3xTF32 pair-plane format shared by the f32 tensor-core forms of
`ffn_act`, `qkv_proj` and `attn_stream` (mirror of `csrc/tf32x3.cuh`:
TF_PB, `tf_pair_ld`). A pair plane stores each row of K f32 columns as
blocks of TF32_PAIR hi values (the TF32 rounding of each value), each
followed by its TF32_PAIR lo values (the TF32 rounding of the rest)."""

from __future__ import annotations

TF32_PAIR = 16           # a pair block: 16 hi values, then their 16 lo


def tf32x3_pair_ld(K: int) -> int:
    """f32 elements a row of K columns takes in a pair plane: K rounded up
    to whole pair blocks, twice."""
    return -(-K // TF32_PAIR) * 2 * TF32_PAIR
