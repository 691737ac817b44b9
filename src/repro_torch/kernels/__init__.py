"""Hand-written Hopper kernels of the port, each with its plain PyTorch
twin. `launch_counts` / `reset_launch_counts` read and zero the per-wrapper
launch counters (incremented only where a wrapper launches its kernel)."""

from repro_torch.kernels import attn_stream as _attn
from repro_torch.kernels import ffn_act as _ffn
from repro_torch.kernels import fused_norm as _norm
from repro_torch.kernels import paged_decode as _paged
from repro_torch.kernels import qkv_proj as _qkv

WRAPPERS = {"fused_norm": _norm.fused_norm,
            "attn_stream": _attn.attn_stream,
            "ffn_act": _ffn.ffn_act,
            "ffn_act_int8": _ffn.ffn_act_int8,
            "qkv_proj": _qkv.qkv_proj,
            "paged_decode_tiered": _paged.paged_decode_tiered,
            "paged_decode_flat": _paged.paged_decode_flat}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
