"""Plain PyTorch oracles of the ported kernels, under the reference's
`kernels/ref.py` names. Each is the plain twin that lives beside its
kernel wrapper; the CPU tests hold them against the JAX Pallas kernels
and `chip_smoke.py` holds the CUDA kernels against them."""

from repro_torch.kernels.attn_stream import attn_stream_plain as attn_stream_ref  # noqa: F401
from repro_torch.kernels.ffn_act import ffn_act_plain as ffn_act_ref  # noqa: F401
from repro_torch.kernels.fused_norm import fused_norm_plain as fused_norm_ref  # noqa: F401
from repro_torch.kernels.paged_decode import (  # noqa: F401
    paged_decode_tiered_plain as paged_decode_tiered_ref)
from repro_torch.kernels.qkv_proj import qkv_proj_plain as qkv_proj_ref  # noqa: F401
