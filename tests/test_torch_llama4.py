"""PyTorch port: llama4-maverick-400b (GQA 40 / 8 heads x 128, G 5;
d_model 5120; a top-1 dropless MoE over 128 experts of F 8192 plus one
shared expert, every layer) against the live JAX reference on the CPU.

The reduced config (2 layers, 8 experts top-1, G 2) runs in f32 with the
reference's own weights (`build_pair`): prefill, chunked extend and
batched decode logits over the tiered and flat stores (1e-4), and the
port's Engine against the reference Engine (plans, tokens, stats,
endurance identical), through the same checks as the dense archs
(`test_torch_dense_archs.check_model_logits` / `check_engine`). At the
full width: the config's sizes, the one- and two-layer cuts one card
holds, and the kernels' planners and shared-memory mirrors at G 5.
"""

from __future__ import annotations

import jax
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro_torch.configs.base import get_config
from repro_torch.kernels import attn_stream as AS
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import qkv_proj as QK
from repro_torch.models import Model
from test_torch_config import build_pair
from test_torch_dense_archs import check_engine, check_model_logits

jax.config.update("jax_platform_name", "cpu")

ARCH = "llama4-maverick-400b"
N_SMS = 132
SMEM_SM = 233_472          # shared memory of a Hopper SM


@pytest.mark.parametrize("kv_policy", ["tiered", "flat"])
def test_model_logits_match_reference(kv_policy):
    check_model_logits(ARCH, kv_policy)


def test_engine_matches_reference_engine():
    check_engine(ARCH)


def test_plan_is_moe_in_every_layer():
    _, rmodel, _, pc, model, params = build_pair(ARCH)
    assert [(u.block.mixer, u.block.mlp, u.repeats) for u in model.plan] \
        == [("attn", "moe", 2)] \
        == [(u.block.mixer, u.block.mlp, u.repeats) for u in rmodel.plan]
    mlp = params["units"]["u0"]["mlp"]
    m = pc.moe
    assert mlp["w_up"].shape == (2, m.num_experts, pc.d_model,
                                 m.d_ff_expert)
    assert set(mlp["shared"]) == {"w_up", "w_gate", "w_down"}


def test_full_config_and_the_layer_cuts():
    """The full config: G 5, top-1 of 128 experts of F 8192 and one
    shared expert, 16.1 B expert parameters a layer (32.2 GB in bf16), the
    reference's parameter count; one H100 (80 GB) holds a 2-layer cut in
    bf16 and a 1-layer cut in f32, the embedding table and head
    included."""
    cfg = get_config(ARCH)
    m = cfg.moe
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_model) == (40, 8, 128, 5120)
    assert (m.num_experts, m.top_k, m.d_ff_expert, m.num_shared_experts,
            m.first_dense_layers) == (128, 1, 8192, 1, 0)
    assert cfg.param_count() == ref_get_config(ARCH).param_count()
    experts = 3 * m.num_experts * cfg.d_model * m.d_ff_expert
    assert experts == 16_106_127_360
    model = Model(cfg)
    head = 2 * model.padded_vocab * cfg.d_model           # embed + head
    per_layer = experts + 3 * cfg.d_model * m.d_ff_shared \
        + cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        * cfg.head_dim + cfg.num_heads * cfg.head_dim * cfg.d_model
    card = 80e9
    assert 2 * (2 * per_layer + head) < card < 2 * (3 * per_layer + head)
    assert 4 * (per_layer + head) < card < 4 * (2 * per_layer + head)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_mirrors_fit_at_g5(dtype):
    """G 5 at Dh 128 takes the G 8 instances: both paged decodes' shared
    memory (max_len 512 and a 32k-token table) fits a block and two an
    SM; the projection's GEMV split covers d_model 5120 for N 5120 /
    1024 / 1024; attention's planner splits the 40-head prefill."""
    cfg = get_config(ARCH)
    D, G = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    assert G == 5 and G <= PD.max_group(D)
    assert D in PD.HEAD_DIMS and D in AS.HEAD_DIMS
    for n_pages in (4, 32768 // 128):
        for b in (PD.tiered_smem_bytes(n_pages, D, G, dtype),
                  PD.flat_smem_bytes(n_pages)):
            assert b <= PD.SMEM_LIMIT
    assert SMEM_SM // (PD.tiered_smem_bytes(4, D, G, dtype) + 2048) >= 2
    ns = (cfg.num_heads * D, cfg.num_kv_heads * D, cfg.num_kv_heads * D)
    for M in (1, 4):
        n_split, d_chunk = QK.gemv_split(M, cfg.d_model, ns, N_SMS, dtype)
        assert (n_split - 1) * d_chunk < cfg.d_model <= n_split * d_chunk
        assert QK.gemv_smem_bytes(M, d_chunk, dtype) <= QK.SMEM_LIMIT
    assert QK.gemm_warpgroups(256, ns, N_SMS) in (1, 2)
    assert 1 <= AS.kv_split(1, cfg.num_heads, 256, 256, N_SMS) <= 8
