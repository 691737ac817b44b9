"""The system under test, as the benchmark builds it: the port's
configuration from a configuration file and a cell, its `Model`, the
serving `Engine` over a `LocalBackend`, and the training step. This is
the only module that imports the program (``repro_torch``); it imports
it inside its functions, after `run.py` has put the checkout's ``src``
on the path.
"""

from __future__ import annotations

def port_config(config: dict, setup: dict):
    """The port's `ModelConfig` for a configuration file's sizes and a
    cell's dtype and KV store: the registry's entry for
    ``config["port_arch"]``, every size replaced by the file's."""
    from repro_torch.configs.base import FrontendConfig, get_config
    D, H = config["hidden_size"], config["num_attention_heads"]
    kw = dict(num_layers=config["num_hidden_layers"], segments=(),
              d_model=D, num_heads=H,
              num_kv_heads=config["num_key_value_heads"],
              head_dim=config.get("head_dim", D // H),
              d_ff=config["intermediate_size"],
              vocab_size=config["vocab_size"],
              rope_theta=float(config["rope_theta"]),
              tie_embeddings=bool(config["tie_word_embeddings"]),
              use_attn_bias=bool(config.get("qkv_bias",
                                            config.get("use_qkv_bias",
                                                       False))),
              norm_type=("rmsnorm" if "rms_norm_eps" in config
                         else "layernorm"),
              mlp_type="silu_gated",
              param_dtype=setup["dtype"], compute_dtype=setup["dtype"],
              remat="none")
    if "mm_hidden_size" in config:
        kw["frontend"] = FrontendConfig(
            kind="vision", frontend_dim=config["mm_hidden_size"],
            num_tokens=config["image_tokens"], connector="mlp")
    if "kv_policy" in setup:
        kw.update(kv_policy=setup["kv_policy"],
                  kv_hot_window=setup["kv_hot_window"])
    return get_config(config["port_arch"]).replace(**kw)


def model(cfg):
    from repro_torch.models import Model
    return Model(cfg)


def build_kernels() -> list[str]:
    """Build (first run in a checkout) and load nothing yet: the kernels
    load at their first launch. Returns the libraries built now."""
    from repro_torch.kernels import build
    return build.build_all()


def fusion():
    """The module whose attention and FFN entry points the model calls
    (`core/fusion.py`)."""
    from repro_torch.core import fusion as mod
    return mod


def train_modules():
    """(`launch/steps.py`, `core/fusion.py`): the modules whose functions
    the train step looks up at call time."""
    from repro_torch.launch import steps
    return steps, fusion()


def launch_counts() -> dict:
    from repro_torch import kernels
    return kernels.launch_counts()


def engine(mdl, params, setup: dict, device):
    """The serving engine of a cell: ``slots`` decode slots of
    ``max_len`` positions; whole-prompt prefill, or chunks of
    ``chunk_tokens``; the scheduler's CHIME byte budgets, or a budget
    that admits exactly ``admit_slots`` slots where the cell states one.
    No spill lanes: the closed loop never oversubscribes."""
    from repro_torch.serving import (CapacityBudget, Engine, FCFSScheduler,
                                     LocalBackend)
    backend = LocalBackend(mdl, params, setup["slots"], setup["max_len"],
                           device=device, n_spill=0)
    chunk = setup.get("chunk_tokens")
    sched = None
    if setup.get("admit_slots"):
        hot, cold = backend.slot_kv_bytes()
        n = setup["admit_slots"]
        sched = FCFSScheduler(CapacityBudget(hot * n, cold * n), hot, cold,
                              chunk_tokens=chunk,
                              token_budget=(chunk + setup["slots"]
                                            if chunk else None))
    eng = Engine(backend, scheduler=sched, chunk_tokens=chunk,
                 token_budget=None if chunk else 0)
    if eng.scheduler.max_concurrent < setup["slots"]:
        raise RuntimeError(
            f"the scheduler admits {eng.scheduler.max_concurrent} of the "
            f"cell's {setup['slots']} slots")
    return eng


def request(rid: int, spec: dict):
    from repro_torch.serving import Request
    return Request(rid=rid, tokens=spec["tokens"],
                   max_new_tokens=spec["answer"], patches=spec["patches"])


def train_step(mdl, opt: dict):
    """(the port's train step, its AdamW config, `adamw_init`): the
    local step of `launch/steps.py` with the cell's AdamW numbers."""
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = AdamWConfig(**opt)
    return steps.make_train_step(mdl, cfg), cfg, adamw_init
