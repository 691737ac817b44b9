"""Paged one-token GQA decode over the CHIME tiered store and over a flat
store.

`paged_decode_tiered` replaces the TPU kernel
`repro/kernels/paged_decode.py::paged_decode_tiered`; `paged_decode_flat`
replaces `repro/kernels/paged_decode.py::paged_decode_flat`. The CUDA
kernels are in `csrc/paged_decode.cu`. Tiered: the G query rows of a kv
head against the hot ring (full precision) and the slot's cold pages
through its block table (-1 = dead) with int8 K/V and the f32 scales
factored out of both dots (see its header). Per-slot ``lengths`` are the
positions just written, so ragged slots share one launch.

SLIM sparse read (``tau`` > 0): a cold page is skipped when, for every
query row g, ``scale * 127 * max(page k-scales) * ||q_g||_1 < m_g +
log(tau)`` with m_g the running max so far; ``tau = 0`` is exact.

Layouts (store-native): q (B, Hkv, G, D) with head h = hkv*G + g; hot k/v
(B, W, Hkv, D); cold int8 (B, max_len, Hkv, D) with f32 scales
(B, max_len, Hkv, 1); lengths (B,) int32; table (B, num_pages) int32.

Flat: the same pages over a full-precision (B, max_len, Hkv, D) store
with no hot ring, no scales and no sparse read; a token is attendable iff
its position <= lengths[b]. The ragged tail page (max_len not a multiple
of ``block_k``) is masked, not padded.

Head dims 16 to 256: a key row is split over its 16-byte chunks (8
features a chunk in the tiered kernel) rounded up to a power of two lanes
(`row_lanes`), at most a warp; the lanes past a row's end (Dh 160) copy
zeros; past 32 chunks a lane holds two (f32 at Dh 160 / 256, flat).
Groups up to MAX_GROUP, 8 at Dh 256 (`max_group`: a warp's G x Dh
partial goes over its 12 KB ring).

Both kernels are split-K (flash-decoding): each (slot, kv head)'s live
key tiles are shared by the blocks of a thread-block cluster
(``tiered_split`` / ``flat_split``, from shapes and the SM count only),
which read lengths[b] themselves (the host never does) and take
contiguous runs of the tiles; a block's 4 warps stream their tiles
through cp.async rings, and the partials merge in a fixed order (a
block's warps, then the blocks in rank order through distributed shared
memory), in one launch. The tiered list is the hot
ring's tiles, then the live cold pages'; at ``tau`` > 0 the tiered
kernel runs one block a (slot, kv head) and walks the pages in order,
applying the skip test to the block-wide running max at each page.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
(`paged_decode_tiered_plain`: the two-segment merge of
`models.attention.attend_tiered` with the same page-skip rule;
`paged_decode_flat_plain`: `models.attention.attend_flat` read through the
block table) only for CPU tensors; ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 20
INT8_QMAX = 127.0
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
MAX_GROUP = 16
# mirror of the two kernels' shared constants in csrc/paged_decode.cu
# (FL_*); chip_smoke holds `flat_smem_bytes` and `tiered_smem_bytes`
# against the library's, and the tiered instances' blocks an SM against
# FLAT_BLOCKS_PER_SM
FLAT_WARPS = 4            # warps a block, each with its own key tiles
FLAT_STAGES = 3           # key tiles in a warp's cp.async ring
FLAT_STAGE_BYTES = 4096   # one warp's K and V tile
FLAT_MAX_SPLIT = 8        # blocks (a cluster) sharing a (slot, kv head)
FLAT_BLOCKS_PER_SM = 2    # grid target the split is sized for
TIERED_FEATURES = 8       # features of a key row a lane owns, both sources
SMEM_LIMIT = 232_448      # shared memory one block may use on Hopper


def row_lanes(chunks: int) -> int:
    """Lanes a key row of ``chunks`` chunks is split over: the chunks
    rounded up to a power of two, at most a warp (the kernels'
    `row_lanes`)."""
    return min(32, 1 << max(chunks - 1, 0).bit_length())


def max_group(head_dim: int) -> int:
    """The largest query group either kernel takes at ``head_dim``: a
    warp's partial (m, d and G x head_dim f32 accumulators) goes over its
    ring after the loop, 12 KB at 4 KB a stage."""
    return 8 if head_dim > 160 else MAX_GROUP


def _es(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def flat_smem_bytes(n_pages: int) -> int:
    """Dynamic shared memory of a flat-kernel block: the warps' rings
    (their partials reuse them) and the slot's block table."""
    return (FLAT_WARPS * FLAT_STAGES * FLAT_STAGE_BYTES
            + (4 * n_pages + 15) // 16 * 16)


def tiered_stage_bytes(head_dim: int, G: int, dtype: torch.dtype) -> int:
    """One warp's ring stage in the tiered kernel: FLAT_STAGE_BYTES, or
    twice that where the scores are tensor-core products (bf16, G >= 2)
    and a key row takes a whole warp (head dims 160, 256), so that a tile
    holds the 8 keys an mma takes."""
    mma = dtype == torch.bfloat16 and G >= 2
    lanes = row_lanes(head_dim // TIERED_FEATURES)
    return FLAT_STAGE_BYTES * (2 if mma and lanes == 32 else 1)


def tiered_smem_bytes(n_pages: int, head_dim: int, G: int,
                      dtype: torch.dtype) -> int:
    """Dynamic shared memory of a tiered-kernel block: the warps' rings
    (`tiered_stage_bytes` a stage) and the block table, then, where the
    scores are tensor-core products (bf16, G >= 2), each warp's scratch
    of a tile's weights (tile keys x GM) and 3 x GM row sums, GM the
    group rounded up to 1/2/4/8/16 (the kernel's template)."""
    gm = 1 << max(G - 1, 0).bit_length()
    scratch = 0
    if dtype == torch.bfloat16 and gm >= 2:
        scratch = gm * (tiered_tile_keys(head_dim, dtype, gm) + 3)
    return (FLAT_WARPS * FLAT_STAGES * tiered_stage_bytes(head_dim, gm, dtype)
            + (4 * n_pages + 15) // 16 * 16 + 4 * FLAT_WARPS * scratch)


def flat_tile_keys(head_dim: int, dtype: torch.dtype) -> int:
    """Keys in one of the flat kernel's tiles: a row's 16-byte chunks
    over `row_lanes` lanes (two chunks a lane past 32), four chunks a
    lane a tile, K and V together FLAT_STAGE_BYTES."""
    chunks = head_dim * _es(dtype) // 16
    lanes = row_lanes(chunks)
    per_lane = -(-chunks // lanes)
    return 32 // lanes * (4 // per_lane)


def tiered_tile_keys(head_dim: int, dtype: torch.dtype, G: int = 1) -> int:
    """Keys in one of the tiered kernel's tiles, hot or cold: a lane owns
    TIERED_FEATURES features of a row, so a warp step covers 32 /
    `row_lanes`(head_dim / 8) keys, and a hot tile's K and V rows in
    ``dtype`` fill a stage (`tiered_stage_bytes`; its int8 cold tile,
    with scales, fits in less)."""
    keys_a_step = 32 // row_lanes(head_dim // TIERED_FEATURES)
    steps = tiered_stage_bytes(head_dim, G, dtype) // (
        2 * 32 * TIERED_FEATURES * _es(dtype))
    return keys_a_step * steps


@functools.lru_cache(maxsize=256)
def flat_split(B: int, Hkv: int, n_sms: int) -> int:
    """Blocks (one cluster) that share a (slot, kv head)'s live keys,
    from shapes and the SM count only (never from lengths): 1 where B *
    Hkv blocks already fill the card; else enough that the grid gives
    every SM FLAT_BLOCKS_PER_SM blocks (shared memory fits four), at most
    FLAT_MAX_SPLIT. At mobilevlm-3b's decode (80 (slot, kv head) pairs)
    that is 4: kernel_sweep.py timed splits 3-4 best at ctx 257-318 and
    4 best at ctx 511. A rank whose share of a short slot is empty reads
    nothing."""
    if B * Hkv >= n_sms:
        return 1
    return min(FLAT_MAX_SPLIT, -(-FLAT_BLOCKS_PER_SM * n_sms // (B * Hkv)))


@functools.lru_cache(maxsize=256)
def tiered_split(B: int, Hkv: int, n_sms: int, sparse: bool) -> int:
    """Blocks (one cluster) that share a (slot, kv head)'s tile list, by
    the flat kernel's rule (`flat_split`): 8 at fastvlm-1.7b's decode (8
    pairs), 4 at mobilevlm-3b's (80), 1 where B * Hkv fills the card.
    At mobilevlm-3b kernel_sweep.py times split 5 faster than 4 at the
    contexts of the serving runs (~300) and 4 faster at 511; the split
    comes from shapes alone and serves every context a slot grows to,
    up to max_len, so 4 is kept. ``sparse`` (tau > 0): 1, since the
    skip rule is a chain in page order that one block walks."""
    return 1 if sparse else flat_split(B, Hkv, n_sms)


def _segment(qf, k, v, valid, scale, k_scale=None, v_scale=None):
    """Flash partials of one segment. qf (B,Hkv,G,D) f32; k,v (B,L,Hkv,D)
    (int8 with scales (B,L,Hkv,1) for the cold tier); valid (B, L).
    -> m, d (B,Hkv,G,1) and acc (B,Hkv,G,D), f32."""
    s = torch.einsum("bhgd,blhd->bhgl", qf, k.float()) * scale
    if k_scale is not None:
        s = s * k_scale[..., 0].transpose(1, 2)[:, :, None, :]
    live = valid[:, None, None, :]
    s = torch.where(live, s, torch.tensor(NEG_INF, device=s.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * live     # a masked key weighs exactly 0
    d = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[..., 0].transpose(1, 2)[:, :, None, :]
    acc = torch.einsum("bhgl,blhd->bhgd", p, v.float())
    return m, d, acc


def _merge(state, part, take=None):
    """Online-softmax merge of ``part`` into ``state``; rows where
    ``take`` (B,Hkv,1,1) is False keep ``state``."""
    m0, d0, a0 = state
    m1, d1, a1 = part
    m = torch.maximum(m0, m1)
    w0, w1 = torch.exp(m0 - m), torch.exp(m1 - m)
    new = (m, d0 * w0 + d1 * w1, a0 * w0 + a1 * w1)
    if take is None:
        return new
    return tuple(torch.where(take, n, o) for n, o in zip(new, state))


def _page_rows(table, last, block_k: int, max_len: int):
    """Per page of ``table`` (B, P): the physical rows (B, P, block_k),
    clamped into the store, and which of them are attendable — a live
    entry, logical position <= ``last`` (B,), a row inside the store."""
    dev = last.device
    tab = table.to(device=dev, dtype=torch.long)
    i = torch.arange(block_k, device=dev)
    rows = tab.clamp_min(0)[:, :, None] * block_k + i
    tok = torch.arange(tab.shape[1], device=dev)[None, :, None] * block_k + i
    valid = ((tab >= 0)[:, :, None] & (tok <= last[:, None, None])
             & (rows < max_len))
    return rows.clamp_max(max_len - 1), valid


def _gather(t, rows):
    """Rows (B, ...) of a (B, L, Hkv, D') store -> (B, n, Hkv, D')."""
    B = t.shape[0]
    return torch.take_along_dim(t, rows.reshape(B, -1)[:, :, None, None],
                                dim=1)


def paged_decode_tiered_plain(q, hot_k, hot_v, cold_kq, cold_ks, cold_vq,
                              cold_vs, lengths, table, *, scale=None,
                              block_k: int = 128, tau: float = 0.0):
    """Plain PyTorch twin of the kernel: hot segment, then the cold pages
    read through ``table`` (physical page rows, logical-position masks),
    merged online; with ``tau`` > 0 pages are skipped by the kernel's
    rule in the kernel's order."""
    B, Hkv, G, D = q.shape
    W = hot_k.shape[1]
    max_len = cold_kq.shape[1]
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qf = q.float()
    pos = lengths.to(device=dev, dtype=torch.long)
    slots = torch.arange(W, device=dev)
    hot_valid = (pos[:, None] - ((pos[:, None] - slots) % W)) >= 0
    state = _segment(qf, hot_k, hot_v, hot_valid, scale)
    n_pages = table.shape[1]
    rows, valid = _page_rows(table, pos - W, block_k, max_len)

    if tau <= 0.0:
        r = rows.reshape(B, -1)
        part = _segment(qf, _gather(cold_kq, r), _gather(cold_vq, r),
                        valid.reshape(B, -1), scale, _gather(cold_ks, r),
                        _gather(cold_vs, r))
        m, d, acc = _merge(state, part)
    else:
        q_l1 = qf.abs().sum(-1, keepdim=True)                  # (B,Hkv,G,1)
        log_tau = math.log(tau)
        for j in range(n_pages):
            r = rows[:, j]
            ks = _gather(cold_ks, r)                           # (B,bk,Hkv,1)
            live_page = valid[:, j].any(-1)                    # (B,)
            max_ks = torch.where(valid[:, j][:, :, None], ks[..., 0],
                                 torch.zeros((), device=dev)).amax(1)
            ub = scale * INT8_QMAX * max_ks[:, :, None, None] * q_l1
            live = (ub >= state[0] + log_tau).any(2, keepdim=True)
            live = live & live_page[:, None, None, None]
            part = _segment(qf, _gather(cold_kq, r), _gather(cold_vq, r),
                            valid[:, j], scale, ks, _gather(cold_vs, r))
            state = _merge(state, part, live)
        m, d, acc = state
    return (acc / d.clamp_min(1e-30)).to(q.dtype)


def paged_decode_flat_plain(q, k, v, lengths, table, *, scale=None,
                            block_k: int = 128):
    """Plain PyTorch twin of the flat kernel: the pages of ``table`` read
    from the (B, max_len, Hkv, D) store, one softmax over their
    attendable tokens (position <= lengths[b])."""
    B, Hkv, G, D = q.shape
    max_len = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    pos = lengths.to(device=q.device, dtype=torch.long)
    rows, valid = _page_rows(table, pos, block_k, max_len)
    m, d, acc = _segment(q.float(), _gather(k, rows), _gather(v, rows),
                         valid.reshape(B, -1), scale)
    return (acc / d.clamp_min(1e-30)).to(q.dtype)


def _check(kernel: str, q, expect: dict) -> None:
    """Raise unless q and every ``expect`` entry (tensor, shape, dtype)
    is contiguous, of that shape and dtype, on q's device, with the K/V
    stores 16-byte aligned for the kernel's row loads."""
    B, Hkv, G, D = q.shape
    if D not in HEAD_DIMS or G > max_group(D):
        raise ValueError(f"{kernel} kernel supports head dims {HEAD_DIMS} "
                         f"and groups <= {MAX_GROUP} (<= 8 at 256), got "
                         f"D={D}, G={G}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"{kernel}: q must be contiguous and start 16-byte "
                         f"aligned")
    build.require_operands(kernel, q.device, expect)
    for name, (t, shape, _) in expect.items():
        if len(shape) == 4 and shape[-1] == D and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start 16-byte aligned "
                             f"(the kernel loads 16-byte rows)")


ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]
FLAT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def paged_decode_tiered(q, hot_k, hot_v, cold_kq, cold_ks, cold_vq, cold_vs,
                        lengths, table, *, scale: float | None = None,
                        block_k: int = 128, tau: float = 0.0
                        ) -> torch.Tensor:
    """-> (B, Hkv, G, D) in q.dtype. See the module docstring."""
    if not q.is_cuda:
        return paged_decode_tiered_plain(
            q, hot_k, hot_v, cold_kq, cold_ks, cold_vq, cold_vs, lengths,
            table, scale=scale, block_k=block_k, tau=tau)
    B, Hkv, G, D = q.shape
    W = hot_k.shape[1]
    max_len = cold_kq.shape[1]
    n_pages = -(-max_len // block_k)
    _check("paged_decode_tiered", q, {
        "hot_k": (hot_k, (B, W, Hkv, D), q.dtype),
        "hot_v": (hot_v, (B, W, Hkv, D), q.dtype),
        "cold_kq": (cold_kq, (B, max_len, Hkv, D), torch.int8),
        "cold_vq": (cold_vq, (B, max_len, Hkv, D), torch.int8),
        "cold_ks": (cold_ks, (B, max_len, Hkv, 1), torch.float32),
        "cold_vs": (cold_vs, (B, max_len, Hkv, 1), torch.float32),
        "lengths": (lengths, (B,), torch.int32),
        "table": (table, (B, n_pages), torch.int32),
    })
    if tiered_smem_bytes(n_pages, D, G, q.dtype) > SMEM_LIMIT:
        raise ValueError(f"paged_decode_tiered: {n_pages} pages do not fit "
                         f"the block table in shared memory")
    scale = scale if scale is not None else D ** -0.5
    split = tiered_split(B, Hkv, build.sm_count(q.device.index), tau > 0)
    out = torch.empty_like(q)
    lib, fn = build.bind("paged_decode", "paged_decode_tiered", ARGTYPES)
    err = fn(
        build.ptr(q), build.ptr(hot_k), build.ptr(hot_v), build.ptr(cold_kq),
        build.ptr(cold_ks), build.ptr(cold_vq), build.ptr(cold_vs),
        build.ptr(lengths), build.ptr(table), build.ptr(out), B, Hkv, G, D,
        W, max_len, n_pages, block_k, scale,
        math.log(tau) if tau > 0 else 0.0, int(tau > 0),
        build.dtype_code(q.dtype), split, build.stream_ptr(q.device))
    build.check(lib, err, "paged_decode_tiered")
    paged_decode_tiered.launches += 1
    return out


paged_decode_tiered.launches = 0


def paged_decode_flat(q, k, v, lengths, table, *, scale: float | None = None,
                      block_k: int = 128) -> torch.Tensor:
    """q (B, Hkv, G, D); k, v (B, max_len, Hkv, D); lengths (B,) int32;
    table (B, ceil(max_len / block_k)) int32, -1 = dead -> (B, Hkv, G, D)
    in q.dtype. See the module docstring."""
    if not q.is_cuda:
        return paged_decode_flat_plain(q, k, v, lengths, table, scale=scale,
                                       block_k=block_k)
    B, Hkv, G, D = q.shape
    max_len = k.shape[1]
    n_pages = -(-max_len // block_k)
    _check("paged_decode_flat", q, {
        "k": (k, (B, max_len, Hkv, D), q.dtype),
        "v": (v, (B, max_len, Hkv, D), q.dtype),
        "lengths": (lengths, (B,), torch.int32),
        "table": (table, (B, n_pages), torch.int32),
    })
    if flat_smem_bytes(n_pages) > SMEM_LIMIT:
        raise ValueError(f"paged_decode_flat: {n_pages} pages do not fit "
                         f"the block table in shared memory")
    scale = scale if scale is not None else D ** -0.5
    split = flat_split(B, Hkv, build.sm_count(q.device.index))
    out = torch.empty_like(q)
    lib, fn = build.bind("paged_decode", "paged_decode_flat", FLAT_ARGTYPES)
    err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lengths),
             build.ptr(table), build.ptr(out), B, Hkv, G, D, max_len, n_pages,
             block_k, scale, build.dtype_code(q.dtype), split,
             build.stream_ptr(q.device))
    build.check(lib, err, "paged_decode_flat")
    paged_decode_flat.launches += 1
    return out


paged_decode_flat.launches = 0
