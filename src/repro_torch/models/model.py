"""Config-driven model, PyTorch port of the reference's `models/model.py`.

Every mixer of the reference runs: GQA attention (the paper's
FastVLM/MobileVLM backbones, granite-3-2b, the dense archs, llama4's
MoE layers and hubert-xlarge's non-causal encoder), MLA with the MoE
(deepseek-v2-lite), RWKV6 with its channel mix (rwkv6-7b) and Mamba2
with one shared attention block (zamba2-1.2b: a single weight set under
the top-level ``shared_attn``, applied by every ``attn_shared`` unit,
each with its own KV store). Parameters are a nested dict with the
reference's leaf paths, so `bridge.params_from_jax` maps one tree onto
the other; layers of a repeated unit stay stacked on a leading
``repeats`` axis and run in a Python loop where the reference scans.
Modes:

  * full    — whole sequence, no caches, logits for every position
              (`forward`: encoder inference; `loss`: training);
              causal unless the config is an encoder, recurrences from
              a zero state, the MoE capacity-dropping with its
              load-balancing term
  * prefill — whole prompt; builds the flat/tiered KV stores
  * extend  — a chunk at absolute positions pos..pos+C-1 over the
              chunk-resumable workspace (``commit`` folds it into the
              stores); over committed stores with one token it is decode
  * decode  — one token per row; ``pos`` may be a (B,) tensor, so the
              serving backend decodes every slot in one call

An attention block picks its mode from its own cache's form; a recurrent
block (RWKV6 / Mamba2) takes its state in every mode but full, and its
extend state is its decode state. An encoder (hubert-xlarge: audio
frames through a linear connector, learned positions) has no cache to
extend: `extend` and `decode_step` raise the reference's ValueError.

Training (`loss`) differentiates the full forward with autograd; the
kernels run inside `kernels.ops.KernelGrad`, whose backward is their
plain twins' VJP. ``cfg.remat`` recomputes each block in backward
("full"), or all but its matmul products ("save_dots"), as the
reference's `jax.checkpoint` policies do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fusion, kv_tiers as KT
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import vision as V
from repro_torch.models.counting import streamed_unit_indices
from repro_torch.sharding import scope, tree_shardings
from repro_torch.tree import tree_leaves, tree_map


SSM_MIXERS = ("rwkv6", "mamba2")
# rows of the learned position table; later positions read its last row
MAX_LEARNED_POS = 32_768
# the matmul products "save_dots" keeps (jax's `checkpoint_dots`)
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str
    mlp: Optional[str]
    d_ff: int


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    block: BlockSpec
    repeats: int


def build_plan(cfg: ModelConfig) -> list[UnitSpec]:
    """Per-layer BlockSpecs compressed into runs of identical specs."""
    specs: list[BlockSpec] = []
    idx = 0
    for seg in cfg.segments:
        for _ in range(seg.repeats):
            for mixer in seg.pattern:
                if mixer == "mamba2" and cfg.family == "hybrid":
                    mlp = None
                elif mixer == "rwkv6":
                    mlp = "rwkv_cm"
                elif cfg.mlp_type == "moe":
                    if cfg.moe and idx < cfg.moe.first_dense_layers:
                        mlp = "dense_first"
                    else:
                        mlp = "moe"
                else:
                    mlp = cfg.mlp_type
                specs.append(BlockSpec(mixer, mlp, cfg.d_ff))
                idx += 1
    units: list[UnitSpec] = []
    for s in specs:
        if units and units[-1].block == s:
            units[-1] = UnitSpec(s, units[-1].repeats + 1)
        else:
            units.append(UnitSpec(s, 1))
    return units


def _device_of(params: dict) -> torch.device:
    return tree_leaves(params)[0].device


class Model:
    """Holds the config and plan; parameters and caches are passed in
    explicitly, as in the reference."""

    def __init__(self, cfg: ModelConfig, placement=None):
        self.cfg = cfg
        # a `models.tp.Placement`: this model is one rank's of a mesh,
        # its parameters and caches the rank's shards (`place`)
        self.placement = placement
        self.plan = build_plan(cfg)
        self.has_shared_attn = any(u.block.mixer == "attn_shared"
                                   for u in self.plan)
        m = cfg.vocab_pad_multiple
        self.padded_vocab = ((cfg.vocab_size + m - 1) // m) * m
        self.compute_dtype = L.torch_dtype(cfg.compute_dtype)

    def place(self, mesh, rules=None) -> "Model":
        """This model's twin on one rank of ``mesh``: it runs on the
        rank's parameter and cache shards (`bridge.shard_params`,
        `cache_shardings`), tensor parallel over 'model' (`models.tp`).
        Its `extend` / `decode_step` return the rank's vocab columns of
        the logits (`Placement.greedy` / `full_logits` read them);
        `forward` returns every column."""
        from repro_torch.models.tp import Placement
        return Model(self.cfg, Placement(self, mesh, rules))

    def streamed_units(self) -> tuple[int, ...]:
        """Plan-unit indices whose per-layer weight slices live in the
        simulated RRAM tier under ``cfg.weight_stream_layers`` (W),
        decided from the config alone by `counting.streamed_unit_indices`.
        Streaming is accounting only (the DRAM weight charge, the ledger's
        ``weight_stream`` domain): every unit runs the same loop, with its
        weights on the device, so streamed and resident tokens are equal
        by construction."""
        return streamed_unit_indices(self.cfg)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _init_block(self, b: L.ParamInit, spec: BlockSpec) -> dict:
        cfg = self.cfg
        init_mixer = {"attn": A.init_attn, "attn_shared": A.init_attn,
                      "mla": A.init_mla, "rwkv6": SSM.init_rwkv6,
                      "mamba2": SSM.init_mamba2}[spec.mixer]
        p = {"ln1": L.init_norm(b, cfg), "mixer": init_mixer(b, cfg)}
        if spec.mlp is not None:
            p["ln2"] = L.init_norm(b, cfg)
            if spec.mlp == "moe":
                p["mlp"] = L.init_moe(b, cfg)
            elif spec.mlp == "dense_first":
                p["mlp"] = L.init_mlp(b, cfg, d_ff=cfg.moe.d_ff_dense,
                                      mlp_type="silu_gated")
            elif spec.mlp == "rwkv_cm":
                p["mlp"] = L.init_rwkv_cm(b, cfg)
            else:
                p["mlp"] = L.init_mlp(b, cfg, mlp_type=spec.mlp)
        return p

    def _init_stacked(self, b: L.ParamInit, spec: BlockSpec,
                      repeats: int) -> dict:
        """A repeated unit's leaves, allocated stacked once; each layer
        is drawn straight into its slices, in the generator order of
        drawing each layer in turn (the peak is the stacked tree)."""
        shapes = L.ParamInit(None, b.dtype, "meta")
        layer = self._init_block(shapes, spec)
        bufs = [torch.empty((repeats,) + t.shape, dtype=t.dtype,
                            device=b.device) for t in shapes.drawn]
        index = {id(t): i for i, t in enumerate(shapes.drawn)}
        if b.device.type != "meta":
            for r in range(repeats):
                self._init_block(L.ParamInit(
                    b.gen, b.dtype, b.device,
                    out=iter([t[r] for t in bufs])), spec)
        for t in shapes.drawn:        # a stacked leaf: (None,) + its axes
            b.axes[id(bufs[index[id(t)]])] = (None,) + shapes.axes[id(t)]
        return tree_map(lambda t: bufs[index[id(t)]], layer)

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """Random parameters in the reference's shapes and scales (no
        embedding table on the audio family; the learned position table
        where ``pos_emb == "learned"``), on ``device``: by default the
        generator's, else the card (`resolve_device`). A repeated unit's
        leaves are filled in place (`_init_stacked`)."""
        cfg = self.cfg
        if device is None:
            device = (generator.device if generator is not None
                      else resolve_device(None))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        b = L.ParamInit(generator, L.torch_dtype(cfg.param_dtype), device)
        return self._build(b)

    def _build(self, b: L.ParamInit) -> dict:
        cfg = self.cfg
        e = L.embed_axis(cfg)
        params: dict = {}
        if cfg.family != "audio":
            params["embed"] = {"table": b.normal(
                (self.padded_vocab, cfg.d_model), ("vocab", e), scale=1.0)}
        if cfg.pos_emb == "learned":
            params["pos_emb"] = b.normal((MAX_LEARNED_POS, cfg.d_model),
                                         (None, e), scale=0.02)
        if cfg.frontend is not None:
            params["frontend"] = V.init_frontend(b, cfg)
        units = {}
        for ui, unit in enumerate(self.plan):
            if unit.block.mixer == "attn_shared":
                continue          # the shared weights live at the top level
            units[f"u{ui}"] = (self._init_block(b, unit.block)
                               if unit.repeats == 1 else
                               self._init_stacked(b, unit.block,
                                                  unit.repeats))
        params["units"] = units
        if self.has_shared_attn:
            params["shared_attn"] = self._init_block(
                b, BlockSpec("attn", cfg.mlp_type, cfg.d_ff))
        params["final_norm"] = L.init_norm(b, cfg)
        if not cfg.tie_embeddings:
            params["lm_head"] = b.normal((cfg.d_model, self.padded_vocab),
                                         (e, "vocab"),
                                         scale=cfg.d_model ** -0.5)
        return params

    def abstract_params(self) -> tuple[dict, dict]:
        """(meta-tensor tree, logical-axes tree) without allocation."""
        b = L.ParamInit(None, L.torch_dtype(self.cfg.param_dtype), "meta")
        params = self._build(b)
        return params, b.axes_tree(params)

    def param_shardings(self, rules) -> dict:
        """The resolved spec of every parameter leaf under ``rules``."""
        shapes, axes = self.abstract_params()
        return tree_shardings(rules, axes, shapes)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def _stacked(self, make) -> dict:
        """``make(spec)`` -> one block's tree, stacked per unit."""
        cache = {}
        for ui, unit in enumerate(self.plan):
            shp = make(unit.block)
            if unit.repeats > 1:
                shp = tree_map(lambda a: a[None].expand(
                    (unit.repeats,) + a.shape).clone(), shp)
            cache[f"u{ui}"] = shp
        return cache

    def _cache_inner(self, spec: BlockSpec) -> dict:
        """Per-token shape of each cached tensor of one block: K and V
        (Hkv, Dh) for attention, the latent (R,) and the RoPE key (rope,)
        for MLA; none for a recurrent block."""
        cfg = self.cfg
        if spec.mixer == "mla":
            return {"c_kv": (cfg.mla.kv_lora_rank,),
                    "k_rope": (cfg.mla.qk_rope_head_dim,)}
        if spec.mixer in ("attn", "attn_shared"):
            inner = (cfg.num_kv_heads, cfg.head_dim)
            return {"k": inner, "v": inner}
        return {}

    def _recurrent_state(self, spec: BlockSpec, batch: int, device) -> dict:
        """A recurrent block's fresh state, decode and extend alike: RWKV6
        {"tm": {"s", "x_prev"}, "cm_x_prev"}, Mamba2 {"conv", "ssm"}."""
        cfg = self.cfg
        if spec.mixer == "rwkv6":
            return {"tm": SSM.init_rwkv6_state(cfg, batch, device),
                    "cm_x_prev": torch.zeros((batch, cfg.d_model),
                                             dtype=self.compute_dtype,
                                             device=device)}
        return SSM.init_mamba2_state(cfg, batch, device)

    def _block_cache(self, spec: BlockSpec, batch: int, max_len: int,
                     device) -> dict:
        cfg = self.cfg
        if spec.mixer in SSM_MIXERS:
            return self._recurrent_state(spec, batch, device)
        return {k: KT.store_init(batch, max_len, inner, cfg.kv_policy,
                                 cfg.kv_hot_window, self.compute_dtype,
                                 device)
                for k, inner in self._cache_inner(spec).items()}

    def init_cache(self, batch: int, max_len: int, device="cpu") -> dict:
        return self._stacked(lambda spec: self._block_cache(
            spec, batch, max_len, device))

    def _block_cache_logical(self, spec: BlockSpec) -> dict:
        """One block's cache as logical-axes tuples (the reference's)."""
        pol = self.cfg.kv_policy
        if spec.mixer == "rwkv6":
            return {"tm": SSM.rwkv6_state_logical(),
                    "cm_x_prev": ("batch", None)}
        if spec.mixer == "mamba2":
            return SSM.mamba2_state_logical()
        inner = (None,) if spec.mixer == "mla" else ("kv_heads", None)
        return {k: KT.store_logical(inner, pol)
                for k in self._cache_inner(spec)}

    def _block_extend_logical(self, spec: BlockSpec) -> dict:
        if spec.mixer in SSM_MIXERS:
            return self._block_cache_logical(spec)
        inner = (None,) if spec.mixer == "mla" else ("kv_heads", None)
        return {f"{k}_ws": ("batch", "kv_seq_shard") + inner
                for k in self._cache_inner(spec)}

    def _stacked_logical(self, make) -> dict:
        """``make(spec)`` -> one block's logical tree, stacked per unit
        (a leading None for a repeated unit's layer axis)."""
        out = {}
        for ui, unit in enumerate(self.plan):
            lg = make(unit.block)
            if unit.repeats > 1:
                lg = tree_map(lambda ax: (None,) + ax, lg)
            out[f"u{ui}"] = lg
        return out

    def cache_spec(self, batch: int, max_len: int) -> tuple[dict, dict]:
        """(the decode cache as shape-and-dtype-only (meta) tensors, its
        logical-axes tree)."""
        return (self.init_cache(batch, max_len, device="meta"),
                self._stacked_logical(self._block_cache_logical))

    def cache_shardings(self, rules, batch: int, max_len: int) -> dict:
        """Resolved specs of a ``batch``-slot decode cache: the slot axis
        over 'data', the cold kv_seq / kv heads over 'model'
        (divisibility permitting) — the sharded backend's pool layout."""
        shapes, logical = self.cache_spec(batch, max_len)
        return tree_shardings(rules, logical, shapes)

    def _block_extend(self, spec: BlockSpec, batch: int, max_len: int,
                      device) -> dict:
        """The full-precision workspace of one block: {"k_ws", "v_ws"}
        or, for MLA, {"c_kv_ws", "k_rope_ws"}; a recurrent block's decode
        state is chunk-resumable as it is and is reused verbatim."""
        if spec.mixer in SSM_MIXERS:
            return self._recurrent_state(spec, batch, device)
        return {f"{k}_ws": torch.zeros((batch, max_len) + inner,
                                       dtype=self.compute_dtype,
                                       device=device)
                for k, inner in self._cache_inner(spec).items()}

    def init_extend_cache(self, batch: int, max_len: int,
                          device="cpu") -> dict:
        """Fresh (zero) chunk-resumable prefill state for `extend`."""
        return self._stacked(lambda spec: self._block_extend(
            spec, batch, max_len, device))

    def extend_spec(self, batch: int, max_len: int) -> tuple[dict, dict]:
        """(the extend state as meta tensors, its logical-axes tree)."""
        return (self.init_extend_cache(batch, max_len, device="meta"),
                self._stacked_logical(self._block_extend_logical))

    def extend_shardings(self, rules, batch: int, max_len: int) -> dict:
        """Resolved specs of the extend state (workspace kv_seq over
        'model' or 'data', divisibility permitting)."""
        shapes, logical = self.extend_spec(batch, max_len)
        return tree_shardings(rules, logical, shapes)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _embed(self, params: dict, batch: dict, pos, ramp: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        cd = self.compute_dtype
        dev = _device_of(params)

        def tokens():
            ids = torch.as_tensor(batch["tokens"], device=dev).long()
            if self.placement is not None:
                return self.placement.embed(params["embed"]["table"], ids,
                                            cd)
            return params["embed"]["table"][ids].to(cd)

        pl = self.placement

        def whole(name):          # a leaf tree computed replicated
            return (params[name] if pl is None
                    else pl.replicated(params[name], pl.pspec[name]))

        if cfg.family == "audio":
            frames = torch.as_tensor(batch["frames"], device=dev)
            x = V.apply_connector(whole("frontend"), cfg, frames)
        elif cfg.frontend is not None and "patches" in batch:
            patches = torch.as_tensor(batch["patches"], device=dev)
            x = V.apply_connector(whole("frontend"), cfg, patches)
            if "tokens" in batch:
                x = torch.cat([x, tokens()], dim=1)
        else:
            x = tokens()
        B, Sq = x.shape[:2]
        ar = torch.arange(Sq, device=dev)
        if pos is None:
            positions = ar[None].expand(B, Sq)
        else:
            p = KT.pos_rows(pos, B, dev)[:, None]
            positions = p + ar if ramp else p.expand(B, Sq)
        if cfg.pos_emb == "learned":
            x = x + whole("pos_emb")[
                positions.clamp_max(MAX_LEARNED_POS - 1)].to(cd)
        return x, positions

    def _run_block(self, spec: BlockSpec, bp: dict, x: torch.Tensor,
                   positions: torch.Tensor, bcache: dict, pos, mode: str,
                   plen=None, commit: bool = False, bspec=None
                   ) -> tuple[torch.Tensor, dict | None, torch.Tensor | float]:
        """(x, the block's new cache, its auxiliary loss: a MoE layer's
        load-balancing term in the full forward, else 0.0). On a placed
        model ``bspec`` is (the layer's parameter specs, its cache
        specs): the leaves are gathered for use (`Placement.block`,
        `cache_in`) and an extend / decode keeps the rank's block of
        the new cache; a committing extend returns it whole, for the
        slot's owner to store; and the batch's data split (a
        `models.tp.DP`, the full forward of the loss only)."""
        pl = self.placement
        if pl is None:
            return self._block(spec, bp, x, positions, bcache, pos, mode,
                               plen, commit, {})
        bp, tps, keep = pl.block(spec, bp, bspec[0])
        tps["dp"] = bspec[2]
        if bcache is not None and mode != "prefill":
            bcache = pl.cache_in(bcache, bspec[1], keep)
        x, nc, aux = self._block(spec, bp, x, positions, bcache, pos, mode,
                                 plen, commit, tps)
        if nc is not None and mode == "extend":
            nc = (pl.cache_whole(nc, keep) if commit
                  else pl.cache_out(nc, bspec[1], keep))
        return x, nc, aux

    def _block(self, spec: BlockSpec, bp: dict, x: torch.Tensor,
               positions: torch.Tensor, bcache: dict, pos, mode: str,
               plen, commit: bool, tps: dict
               ) -> tuple[torch.Tensor, dict | None, torch.Tensor | float]:
        cfg = self.cfg
        tp = tps.get("mixer")
        full = mode == "full"
        h = fusion.apply_norm(bp["ln1"], cfg, x)
        if spec.mixer in SSM_MIXERS:
            # the state rides in every mode but full: zeros at prefill,
            # the extend workspace's state, the committed one at decode;
            # the full forward starts from a zero state of its own, and
            # so does RWKV6's prefill (the same zeros, at the rank's
            # heads on a placed model, where the prefill's fresh cache
            # holds every head)
            if spec.mixer == "rwkv6":
                fresh = full or mode == "prefill"
                out, tm = SSM.apply_rwkv6(bp["mixer"], cfg, h,
                                          None if fresh else bcache["tm"],
                                          tp)
                new_cache = {"tm": tm}
            else:
                out, new_cache = SSM.apply_mamba2(bp["mixer"], cfg, h,
                                                  None if full else bcache)
            return self._mlp_half(spec, bp, x + out, bcache, new_cache,
                                  full, tps.get("mlp"), tps.get("dp"))
        mla = spec.mixer == "mla"
        first = next(iter(self._cache_inner(spec)))    # "k" or "c_kv"
        if mode in ("full", "prefill"):
            ml = 0
            if not full:
                st = bcache[first]
                ml = (st["flat"].shape[1] if "flat" in st
                      else st["cold_q"].shape[1])
            seq = fusion.apply_mla_seq if mla else fusion.apply_attention_seq
            out, new_cache = seq(bp["mixer"], cfg, h, positions,
                                 causal=not cfg.is_encoder,
                                 build_cache=not full, max_len=ml,
                                 length=plen, tp=tp)
        elif f"{first}_ws" in bcache:   # workspace form: chunked prefill
            ext = (fusion.apply_mla_extend if mla
                   else fusion.apply_attention_extend)
            out, new_cache = ext(bp["mixer"], cfg, h, positions, bcache, pos,
                                 plen, commit, tp)
        else:                           # committed stores: decode
            dec = (fusion.apply_mla_decode if mla
                   else fusion.apply_attention_decode)
            out, new_cache = dec(bp["mixer"], cfg, h, bcache, pos, tp)
        return self._mlp_half(spec, bp, x + out, bcache, new_cache, full,
                              tps.get("mlp"), tps.get("dp"))

    def _mlp_half(self, spec: BlockSpec, bp: dict, x: torch.Tensor,
                  bcache: dict, new_cache: dict | None, full: bool, tp=None,
                  dp=None
                  ) -> tuple[torch.Tensor, dict | None, torch.Tensor | float]:
        """The block's second half: pre-norm, the MLP, the residual."""
        cfg = self.cfg
        if spec.mlp is None:
            return x, new_cache, 0.0
        h2 = fusion.apply_norm(bp["ln2"], cfg, x)
        if spec.mlp == "rwkv_cm":
            # stateful: the channel mix's token shift carries its last row
            # (the full forward shifts in zeros, as at a fresh prefill)
            out, prev = L.apply_rwkv_cm(bp["mlp"], cfg, h2,
                                        None if full else bcache["cm_x_prev"],
                                        tp)
            if not full:
                new_cache["cm_x_prev"] = prev.to(self.compute_dtype)
            return x + out, new_cache, 0.0
        # a MoE model's dense first layers are gated FFNs of width
        # moe.d_ff_dense (their leaves say so), run by ffn_act; the MoE
        # drops past its capacity in the full forward only
        kind = "silu_gated" if spec.mlp == "dense_first" else spec.mlp
        aux = (L.moe_aux_loss(bp["mlp"], cfg, h2,
                              *(() if dp is None else (dp,)))
               if full and spec.mlp == "moe" else 0.0)
        return x + fusion.apply_ffn(bp["mlp"], cfg, h2, mlp_type=kind,
                                    dropless=not full, tp=tp,
                                    dp=dp), new_cache, aux

    def _block_fn(self, mode: str):
        """`_run_block`, checkpointed in the full forward where autograd
        records and ``cfg.remat`` asks: "full" recomputes the whole block
        in backward, "save_dots" all but its matmul products (the kernel
        Functions rerun in either)."""
        remat = self.cfg.remat
        if mode != "full" or remat == "none" or not torch.is_grad_enabled():
            return self._run_block
        kw = dict(use_reentrant=False)
        if remat == "save_dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: ckpt.checkpoint(self._run_block, *a, **kw)

    def _run_unit(self, ui: int, unit: UnitSpec, params: dict,
                  x: torch.Tensor, positions: torch.Tensor,
                  ucache: dict | None, pos, mode: str, plen=None,
                  commit: bool = False, uspec=None, dp=None
                  ) -> tuple[torch.Tensor, dict | None, torch.Tensor | float]:
        """One unit's layers in turn, and their auxiliary losses summed;
        ``ucache`` is None in the full forward, which makes and returns
        no cache. ``uspec`` (placed models) is the unit's cache specs,
        ``dp`` the batch's data split."""
        # a shared-attention unit applies the one top-level weight set
        shared = unit.block.mixer == "attn_shared"
        up = params["shared_attn"] if shared else params["units"][f"u{ui}"]
        block = self._block_fn(mode)
        bspec = None
        if self.placement is not None:
            ps = self.placement.pspec
            ps = ps["shared_attn"] if shared else ps["units"][f"u{ui}"]
            if unit.repeats > 1:          # a layer's specs: no repeat axis
                strip = lambda t: tree_map(lambda s: s[1:], t)  # noqa: E731
                ps = ps if shared else strip(ps)
                uspec = None if uspec is None else strip(uspec)
            bspec = (ps, uspec, dp)
        if unit.repeats == 1:
            return block(unit.block, up, x, positions, ucache, pos, mode,
                         plen, commit, bspec)
        # the stacked leaves split once: in backward, unbind's gradient is
        # one stack a leaf, where indexing each layer would add a zero
        # tensor of the whole stacked leaf a layer
        layers = up if shared else tree_map(torch.unbind, up)
        ncs, aux_t = [], 0.0
        for r in range(unit.repeats):
            bp = up if shared else tree_map(lambda a: a[r], layers)
            bc = None if ucache is None else tree_map(lambda a: a[r], ucache)
            x, nc, aux = block(unit.block, bp, x, positions, bc, pos, mode,
                               plen, commit, bspec)
            ncs.append(nc)
            aux_t = aux_t + aux
        if ucache is None:
            return x, None, aux_t
        return x, tree_map(lambda *a: torch.stack(a), *ncs), aux_t

    def _forward(self, params: dict, batch: dict, mode: str,
                 cache: dict | None, pos, plen=None, commit: bool = False,
                 specs: dict | None = None, dp=None
                 ) -> tuple[torch.Tensor, dict | None, torch.Tensor | float]:
        """``mode`` is "full" (every row's logits, no cache), "prefill"
        (whole prompt from position 0) or "extend" (rows at pos..); the
        last two return the last valid row's logits. The third result
        sums the MoE layers' load-balancing terms (full mode only)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch, pos,
                                   ramp=(mode == "extend"))
        new_cache = None if cache is None else {}
        aux_total = 0.0
        for ui, unit in enumerate(self.plan):
            with scope(f"u{ui}"):
                x, nc, aux = self._run_unit(
                    ui, unit, params, x, positions,
                    None if cache is None else cache[f"u{ui}"], pos, mode,
                    plen, commit,
                    None if specs is None else specs[f"u{ui}"], dp)
            aux_total = aux_total + aux
            if cache is not None:
                new_cache[f"u{ui}"] = nc
        x = fusion.apply_norm(params["final_norm"], cfg, x)
        if mode != "full":
            x = (x[:, -1:] if plen is None
                 else x[:, int(plen) - 1:int(plen)])
        pl = self.placement
        if pl is not None:            # the rank's vocab columns
            w, split = pl.head_weight(params)
            eq = "bsd,vd->bsv" if cfg.tie_embeddings else "bsd,dv->bsv"
            logits = torch.einsum(eq, pl.enter(x) if split else x,
                                  w.to(x.dtype))
            if mode == "full":
                logits = pl.full_logits(logits)
        elif cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x,
                                  params["embed"]["table"].to(x.dtype))
        else:
            logits = torch.einsum("bsd,dv->bsv", x,
                                  params["lm_head"].to(x.dtype))
        return logits, new_cache, aux_total

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """The full-sequence forward: logits (B, S, V) for every position
        of ``batch`` ("tokens", "patches" and / or "frames", as the
        config takes), with no cache; an encoder's only entry point."""
        return self._forward(params, batch, "full", None, None)[0]

    def loss(self, params: dict, batch: dict,
             batch_axes: tuple[str, ...] = ()) -> torch.Tensor:
        """Mean next-token cross-entropy over ``batch["labels"]`` (f32
        logsumexp), weighted by ``batch["loss_mask"]`` (default all ones)
        and divided by max(sum(mask), 1), plus 0.01 x the MoE layers'
        load-balancing terms. Differentiable: gradients reach every
        float leaf of ``params`` that requires them. Raises TypeError
        where autograd records and a leaf is not floating point (the
        int8 FFN store), as the reference's `jax.value_and_grad` does.

        On a placed model, ``batch_axes`` names the data axes the batch
        rows are split over (the rank holds its block; () when every
        rank holds the whole batch). The masked sum and the mask count
        are then summed over them, as are the load-balancing terms'
        means and the capacity MoE's row positions: the loss returned is
        the global batch's, the same on every rank, and each rank's
        gradient is its own rows' share (`launch.steps` sums the shares
        over the data axes)."""
        if torch.is_grad_enabled():
            bad = [t.dtype for t in tree_leaves(params)
                   if not t.is_floating_point()]
            if bad:
                raise TypeError(
                    f"loss: gradients need float parameters, got "
                    f"{sorted(set(map(str, bad)))} leaves (the int8 FFN "
                    f"store is not trainable)")
        dp = None
        if self.placement is not None:
            from repro_torch.models.tp import DP
            dp = DP(self.placement.mesh, tuple(batch_axes))
        logits, _, aux = self._forward(params, batch, "full", None, None,
                                       dp=dp)
        dev = logits.device
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        lf = logits.float()
        ll = (lf.gather(-1, labels[..., None])[..., 0]
              - torch.logsumexp(lf, dim=-1))
        mask = batch.get("loss_mask")
        mask = (torch.ones_like(ll) if mask is None else
                torch.as_tensor(mask, device=dev).to(ll.dtype))
        num, den = -(ll * mask).sum(), mask.sum()
        if dp is not None:
            num, den = dp.sum(num), dp.sum(den)
        return num / den.clamp_min(1.0) + 0.01 * aux

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict, max_len: int,
                length=None) -> tuple[torch.Tensor, dict]:
        """Last-token logits + filled caches; ``length`` counts the valid
        rows of a right-padded prompt (None: all of it)."""
        first = next(v for v in batch.values())
        cache = self.init_cache(len(first), max_len, _device_of(params))
        return self._forward(params, batch, "prefill", cache, None,
                             plen=length)[:2]

    @torch.no_grad()
    def extend(self, params: dict, batch: dict, cache: dict, pos,
               length=None, commit: bool = False, specs: dict | None = None
               ) -> tuple[torch.Tensor, dict]:
        """Multi-token cache extension, the serving entry point: a chunk
        at absolute positions pos.. over the workspace form (chunked
        prefill; ``commit`` on the final chunk), or one token over the
        committed stores (decode). Returns (logits of the last valid row
        (B,1,V), new cache). An encoder has no cache: ValueError. A
        placed model takes the resolved specs of ``cache`` (``specs``)."""
        if self.cfg.is_encoder:
            raise ValueError("encoder-only model cannot extend a cache")
        return self._forward(params, batch, "extend", cache, pos,
                             plen=length, commit=commit, specs=specs)[:2]

    def decode_step(self, params: dict, tokens, cache: dict, pos,
                    specs: dict | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B,1); ``pos`` (int or (B,) tensor) is
        the index each row's new token is written at."""
        return self.extend(params, {"tokens": tokens}, cache, pos,
                           length=1, specs=specs)
