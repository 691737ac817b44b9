"""CHIME KV-cache tiered store (paper §III-C ②), PyTorch port.

  Tier-0 (hot)    : the most recent ``hot_window`` tokens at full
                    precision in a ring (slot = position % W).
  Tiers 1-3 (cold): older tokens, int8 per-(token, head) quantized with
                    f32 scales (`core.quant`).
  Tier-4 (frozen) : cold slots are written exactly once, when a token
                    ages out of the hot window; per-(slot, block)
                    counters in ``writes`` audit that endurance rule.

Every update is functional (returns a new dict), like the reference, so
a caller can keep the old store — the serving backend relies on that to
leave inactive slots verbatim. Positions may be a Python int or a (B,)
tensor: the batched serving decode writes each slot at its own position,
with ring slot and evicted position computed per row by index ops.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import (compress_spill_hot, decompress_spill_hot,
                                    dequantize_per_token, quantize_per_token)

ENDURANCE_BLOCK = 128  # tokens per endurance-accounting block


def pos_rows(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or (B,) tensor) -> (B,) int64 tensor."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.long)
        return p.expand(batch) if p.dim() == 0 else p
    return torch.full((batch,), int(pos), dtype=torch.long, device=device)


def _is_vector(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def init_tiered(batch: int, max_len: int, inner: tuple[int, ...],
                hot_window: int, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """A tiered store for one cached tensor of per-token shape ``inner``."""
    W = min(hot_window, max_len)
    return {
        "hot": torch.zeros((batch, W) + inner, dtype=dtype, device=device),
        "cold_q": torch.zeros((batch, max_len) + inner, dtype=torch.int8,
                              device=device),
        "cold_scale": torch.ones((batch, max_len) + inner[:-1] + (1,),
                                 dtype=torch.float32, device=device),
        "writes": torch.zeros((batch, n_endurance_blocks(max_len)),
                              dtype=torch.int32, device=device),
    }


def n_endurance_blocks(max_len: int) -> int:
    return (max_len + ENDURANCE_BLOCK - 1) // ENDURANCE_BLOCK


def hot_window_of(cache: dict) -> int:
    return cache["hot"].shape[1]


def tiered_from_full(full: torch.Tensor, hot_window: int, length,
                     max_len: int) -> dict:
    """Prefill: build a tiered store from a (B, S, ...) tensor whose first
    ``length`` positions are valid. The cold prefix is quantized in one
    shot (each slot written once); the last W tokens land in the hot ring
    at slot p % W."""
    B, S = full.shape[:2]
    W = min(hot_window, max_len)
    assert S <= max_len
    dev = full.device
    length = int(length)
    q, scale = quantize_per_token(full)
    cold_q = torch.zeros((B, max_len) + full.shape[2:], dtype=torch.int8,
                         device=dev)
    cold_q[:, :S] = q
    cold_scale = torch.ones((B, max_len) + full.shape[2:-1] + (1,),
                            dtype=torch.float32, device=dev)
    cold_scale[:, :S] = scale
    # slot i holds the largest position p < length with p % W == i
    slots = torch.arange(W, device=dev)
    abs_pos = ((length - 1) - ((length - 1 - slots) % W)).clamp(0, S - 1)
    hot = full.index_select(1, abs_pos)
    n_cold_blocks = max(length - W, 0) // ENDURANCE_BLOCK
    blk = torch.arange(n_endurance_blocks(max_len), device=dev)
    writes = (blk < n_cold_blocks).to(torch.int32)[None].repeat(B, 1)
    return {"hot": hot, "cold_q": cold_q, "cold_scale": cold_scale,
            "writes": writes}


def tiered_append(cache: dict, new: torch.Tensor, pos) -> dict:
    """Decode step: write token ``pos`` (``new`` is (B, 1, ...)) into the
    hot ring; the evicted token (pos - W) is quantized into its cold slot,
    written exactly once in the cache's lifetime. ``pos`` may be a (B,)
    tensor: each row appends at its own position."""
    hot = cache["hot"]
    B, W = hot.shape[:2]
    rows = torch.arange(B, device=hot.device)
    p = pos_rows(pos, B, hot.device)
    slot = p % W
    evict_pos = p - W
    do_evict = evict_pos >= 0
    safe_evict = evict_pos.clamp_min(0)
    q, scale = quantize_per_token(hot[rows, slot])
    keep = do_evict.view((B,) + (1,) * (q.dim() - 1))
    cold_q = cache["cold_q"].clone()
    cold_q[rows, safe_evict] = torch.where(keep, q, cold_q[rows, safe_evict])
    cold_scale = cache["cold_scale"].clone()
    cold_scale[rows, safe_evict] = torch.where(
        keep, scale, cold_scale[rows, safe_evict])
    hot = hot.clone()
    hot[rows, slot] = new[:, 0].to(hot.dtype)
    writes = cache["writes"].clone()
    blk = safe_evict // ENDURANCE_BLOCK
    writes[rows, blk] += do_evict.to(torch.int32)
    return {"hot": hot, "cold_q": cold_q, "cold_scale": cold_scale,
            "writes": writes}


def tiered_read(cache: dict, pos, dtype=torch.bfloat16
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize the attendable store as (values, valid) along a
    combined length axis [cold(max_len) ++ hot(W)]. ``valid`` is (L',)
    for a scalar ``pos`` and (B, L') for a (B,) position vector."""
    W = hot_window_of(cache)
    max_len = cache["cold_q"].shape[1]
    dev = cache["hot"].device
    cold = dequantize_per_token(cache["cold_q"], cache["cold_scale"], dtype)
    p = pos if _is_vector(pos) else torch.as_tensor(int(pos), device=dev)
    p = p.to(device=dev, dtype=torch.long)
    cold_valid = torch.arange(max_len, device=dev) <= (p[..., None] - W)
    hot_pos = hot_ring_positions(p, W)
    hot_valid = (hot_pos >= 0) & (hot_pos <= p[..., None])
    values = torch.cat([cold, cache["hot"].to(dtype)], dim=1)
    valid = torch.cat([cold_valid, hot_valid], dim=-1)
    return values, valid


def n_cold_pages(max_len: int, block_k: int) -> int:
    """Table entries needed to cover a max_len cold tier in block_k pages."""
    return -(-max_len // block_k)


def cold_page_table(pos, hot_window: int, max_len: int,
                    block_k: int) -> torch.Tensor:
    """Identity block table for the paged-decode kernel: entry j maps
    logical cold page j (tokens [j*block_k, (j+1)*block_k)) to physical
    page j, or -1 when the page holds no attendable token. A token is
    attendable cold when its position <= pos - hot_window. (pages,) for
    an int ``pos``, (B, pages) for a (B,) position tensor."""
    dev = pos.device if isinstance(pos, torch.Tensor) else "cpu"
    j = torch.arange(n_cold_pages(max_len, block_k), dtype=torch.int32,
                     device=dev)
    p = pos if isinstance(pos, torch.Tensor) else torch.tensor(int(pos))
    live = j * block_k <= (p.to(dev)[..., None] - hot_window)
    return torch.where(live, j, torch.full_like(j, -1)).to(torch.int32)


def hot_ring_positions(pos, W: int) -> torch.Tensor:
    """Absolute position held by each hot slot, given current write pos:
    (W,) for a scalar, (B, W) for a (B,) position tensor."""
    p = pos if isinstance(pos, torch.Tensor) else torch.tensor(int(pos))
    i = torch.arange(W, device=p.device)
    p = p.to(torch.long)[..., None]
    return p - ((p - i) % W)


# ---------------------------------------------------------------------------
# generic cached-tensor store: {"flat": arr} or a tiered dict
# ---------------------------------------------------------------------------
def store_init(batch: int, max_len: int, inner: tuple[int, ...],
               policy: str, hot_window: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    if policy == "tiered":
        return init_tiered(batch, max_len, inner, hot_window, dtype, device)
    return {"flat": torch.zeros((batch, max_len) + inner, dtype=dtype,
                                device=device)}


def store_from_full(full: torch.Tensor, policy: str, hot_window: int,
                    length, max_len: int) -> dict:
    """Prefill: absorb a (B, S, ...) tensor (first ``length`` valid)."""
    if policy == "tiered":
        return tiered_from_full(full, hot_window, length, max_len)
    flat = torch.zeros((full.shape[0], max_len) + full.shape[2:],
                       dtype=full.dtype, device=full.device)
    flat[:, :full.shape[1]] = full
    return {"flat": flat}


def store_append(store: dict, new: torch.Tensor, pos) -> dict:
    if "hot" in store:
        return tiered_append(store, new, pos)
    flat = store["flat"].clone()
    B = flat.shape[0]
    rows = torch.arange(B, device=flat.device)
    flat[rows, pos_rows(pos, B, flat.device)] = new[:, 0].to(flat.dtype)
    return {"flat": flat}


def store_read(store: dict, pos, dtype=torch.bfloat16
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (values (B, L', ...), valid (L',) or (B, L')) where L' = max_len
    (flat) or max_len + W (tiered, [cold ++ hot])."""
    if "hot" in store:
        return tiered_read(store, pos, dtype)
    flat = store["flat"]
    p = pos if _is_vector(pos) else torch.as_tensor(int(pos))
    p = p.to(device=flat.device, dtype=torch.long)
    valid = torch.arange(flat.shape[1], device=flat.device) <= p[..., None]
    return flat.to(dtype), valid


# ---------------------------------------------------------------------------
# RRAM spill store accounting (serving preemption).
#
# A preempted (or idle-offloaded) slot's cache is packed into an RRAM
# spill lane. Like the one-shot `tiered_from_full` cold write, a spill is
# one front-to-back pass over the packed image: it writes every
# endurance block that holds a valid position exactly once. Lane
# counters are CUMULATIVE across spill events (RRAM wear does not reset
# when a lane is recycled).
# ---------------------------------------------------------------------------
def init_spill_writes(n_lanes: int, max_len: int,
                      device="cpu") -> torch.Tensor:
    """Per-(lane, block) RRAM write counters for a spill store."""
    return torch.zeros((n_lanes, n_endurance_blocks(max_len)),
                       dtype=torch.int32, device=device)


def spill_block_writes(n_blocks: int, length, device="cpu") -> torch.Tensor:
    """Per-block writes of ONE packed spill of a ``length``-token context:
    blocks [0, ceil(length / ENDURANCE_BLOCK)) are each written once (a
    partly filled tail block is still a physical block write)."""
    touched = (int(length) + ENDURANCE_BLOCK - 1) // ENDURANCE_BLOCK
    blk = torch.arange(n_blocks, device=device)
    return (blk < touched).to(torch.int32)


def bump_spill_writes(writes: torch.Tensor, lane, length) -> torch.Tensor:
    """Record one spill of a ``length``-token context into ``lane``, in
    place (the reference returns a new array); returns ``writes``."""
    writes[int(lane)] += spill_block_writes(writes.shape[1], length,
                                            writes.device)
    return writes


def expected_spill_block_writes(n_blocks: int, lengths) -> torch.Tensor:
    """Expected cumulative per-block writes of ONE lane that absorbed a
    sequence of spills with context lengths ``lengths`` (the oracle the
    endurance tests hold `bump_spill_writes` to exactly)."""
    out = torch.zeros((n_blocks,), dtype=torch.int32)
    for ln in lengths:
        out = out + spill_block_writes(n_blocks, ln)
    return out


# ---------------------------------------------------------------------------
# compressed spill lanes (opt-in, serving --spill-compress)
#
# A compressed lane stores the full-precision hot ring in the int8 codec
# form (`core.quant.compress_spill_hot`): "hot" becomes "hot_q" (int8,
# same shape) + "hot_scale" (f32, trailing axis 1). The cold tier, cold
# scales, endurance counters and flat stores ride verbatim, so only the
# hot window pays the bounded requantization error on restore.
# ---------------------------------------------------------------------------
def spill_store_compress(store: dict) -> dict:
    """Pack one tiered store into compressed-lane form."""
    out = {k: v for k, v in store.items() if k != "hot"}
    out["hot_q"], out["hot_scale"] = compress_spill_hot(store["hot"])
    return out


def spill_store_decompress(store: dict, dtype=torch.bfloat16) -> dict:
    """Restore a compressed-lane store to the cache layout."""
    out = {k: v for k, v in store.items()
           if k not in ("hot_q", "hot_scale")}
    out["hot"] = decompress_spill_hot(store["hot_q"], store["hot_scale"],
                                      dtype)
    return out


def spill_store_template(store: dict) -> dict:
    """Zero compressed-lane tensors shaped after a full-precision store
    (the lazy lane materialization)."""
    out = {k: v for k, v in store.items() if k != "hot"}
    hot = store["hot"]
    out["hot_q"] = torch.zeros(hot.shape, dtype=torch.int8,
                               device=hot.device)
    out["hot_scale"] = torch.ones(hot.shape[:-1] + (1,),
                                  dtype=torch.float32, device=hot.device)
    return out


def spill_store_meta(store: dict) -> dict:
    """Mirror per-leaf metadata (slot-axis indices) onto the compressed
    layout: the hot entry serves both hot_q and hot_scale."""
    out = {k: v for k, v in store.items() if k != "hot"}
    out["hot_q"] = store["hot"]
    out["hot_scale"] = store["hot"]
    return out


# ---------------------------------------------------------------------------
# endurance accounting
# ---------------------------------------------------------------------------
def endurance_report(cache: dict) -> dict:
    """Aggregate endurance counters. ``writes`` is (batch, n_blocks)."""
    w = cache["writes"]
    return {"max_writes_per_block": w.max(),
            "total_cold_writes": w.sum(),
            "per_slot_writes": w.sum(dim=tuple(range(1, w.dim())))}


def expected_block_writes(n_blocks: int, hot_window: int, prefill_len,
                          total_len) -> torch.Tensor:
    """Expected per-block write count for ONE sequence that absorbed
    ``prefill_len`` tokens via the one-shot cold write and then decoded up
    to ``total_len`` tokens via `tiered_append`: one per full cold block
    of the prefill, plus one per evicted position."""
    W = hot_window
    full_blocks = max(int(prefill_len) - W, 0) // ENDURANCE_BLOCK
    blk = torch.arange(n_blocks)
    lo, hi = blk * ENDURANCE_BLOCK, (blk + 1) * ENDURANCE_BLOCK
    ev_lo = max(int(prefill_len) - W, 0)
    ev_hi = max(int(total_len) - W, 0)
    appends = (torch.minimum(hi, torch.tensor(ev_hi))
               - torch.maximum(lo, torch.tensor(ev_lo))).clamp(
                   0, ENDURANCE_BLOCK)
    return ((blk < full_blocks).to(torch.int64) + appends).to(torch.int32)
