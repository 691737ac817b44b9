"""Paged prefix-sharing KV block pool: host-side block tables, a
content-hash prefix index, and copy-on-write bookkeeping.

CHIME's motivating workload — many concurrent VQA requests carrying the
same system prompt / few-shot header / image — pays the full prefill
(and full per-request KV bytes) for a prefix that is byte-identical
across requests. This module is the vLLM/SGLang-shaped answer scaled to
the tiered edge pool: the KV *prefix* space is carved into
``block_tokens``-granular pages (default `core.kv_tiers.ENDURANCE_BLOCK`
— the same granularity the RRAM endurance counters already use), and a
host-side `BlockPool` maintains

  * a free list + LRU reclamation over ``num_blocks`` physical block
    ids,
  * a radix-style prefix tree keyed on content (token ids; image
    patches by per-row digest) mapping prefixes -> chains of blocks,
  * per-block reference counts (a block referenced by an in-flight
    admission is never reclaimed) and write counters (a shared block is
    physically written ONCE regardless of how many requests later
    reference it — the write-once/read-many discipline that makes
    shared prefixes the ideal tenants of the dense RRAM tier).

The actual KV payload lives in the backend's prefix block store (see
`serving.backend`): full-precision *workspace-form* K/V rows per block
(exactly what `Model.extend` accumulates during chunked prefill), plus
recurrent-state snapshots for SSM architectures. Storing workspace rows
— not the quantized store form — is what makes a prefix hit *exact*:
admission seeds the hit rows into a fresh extend workspace and prefill
resumes at the hit position, so the committed cache is bit-identical to
a cold prefill by the same split-invariance the chunked-prefill parity
tests already establish.

Copy-on-write: a request whose keys diverge *inside* a shared block
still hits the longest common prefix (the matched rows seed the
workspace; the tail recomputes), and at registration the diverging span
is written to a FRESH block — the shared block is never mutated. The
prefix tree therefore only ever grows by appending children; eviction
removes unreferenced leaves in LRU order.

Everything here is host-side bookkeeping (pure Python + numpy); the
jitted block copies live in `serving.backend`.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.kv_tiers import ENDURANCE_BLOCK

__all__ = ["ENDURANCE_BLOCK", "BlockNode", "BlockPool", "PrefixHit",
           "request_prefix_keys"]


def request_prefix_keys(req) -> tuple:
    """Content keys of a request's prompt, one per backbone position.

    Text positions key on the token id; visual positions key on a
    per-patch-row sha1 digest of the raw float32 bytes (two requests
    share a visual prefix only if the patch rows are bit-identical —
    the only safe notion of "same image" for exact KV reuse). The tuple
    is cached on the request: admission probes and registration reuse
    it without re-hashing the image."""
    keys = getattr(req, "_prefix_keys", None)
    if keys is not None:
        return keys
    parts: list = []
    if req.patches is not None:
        rows = np.ascontiguousarray(np.asarray(req.patches, np.float32))
        parts.extend(hashlib.sha1(row.tobytes()).digest() for row in rows)
    parts.extend(int(t) for t in np.asarray(req.tokens).reshape(-1))
    keys = tuple(parts)
    try:
        req._prefix_keys = keys
    except AttributeError:
        pass                                  # __slots__ request: no cache
    return keys


def _lcp(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class BlockNode:
    """One block of the prefix tree: physical block ``bid`` holds the KV
    workspace rows for prompt positions [start, start + len(keys)).

    ``full`` nodes cover exactly ``block_tokens`` positions and may have
    children (the chain continues); partial nodes are terminal tails of
    a registered prompt (they enable exact-prompt-repeat hits) and never
    grow children. ``has_state`` marks a recurrent-state snapshot for
    the prefix ending at this node (SSM architectures can only resume
    from such a node). ``refcount`` counts in-flight admissions holding
    this block; ``pin_epoch`` protects nodes a same-step probe returned
    from same-step reclamation."""

    __slots__ = ("bid", "start", "keys", "parent", "full", "refcount",
                 "has_state", "tick", "pin_epoch", "children", "partials")

    def __init__(self, bid: int, start: int, keys: tuple,
                 parent: Optional["BlockNode"], full: bool):
        self.bid = bid
        self.start = start
        self.keys = keys
        self.parent = parent
        self.full = full
        self.refcount = 0
        self.has_state = False
        self.tick = 0
        self.pin_epoch = -1
        self.children: dict[tuple, BlockNode] = {}
        self.partials: list[BlockNode] = []

    @property
    def end(self) -> int:
        return self.start + len(self.keys)

    def __repr__(self):                        # pragma: no cover - debug
        return (f"BlockNode(bid={self.bid}, [{self.start},{self.end}), "
                f"full={self.full}, rc={self.refcount}, "
                f"state={self.has_state})")


class PrefixHit(NamedTuple):
    """A successful prefix probe: ``nodes`` is the root-to-deepest block
    chain whose stored rows seed the admission workspace, ``length`` the
    usable hit positions (prefill resumes there), and ``partial`` True
    when the request diverges strictly INSIDE the deepest block — the
    copy-on-write case (its tail recomputes and registers to a fresh
    block; the shared block is untouched)."""
    nodes: tuple
    length: int
    partial: bool


_EMPTY_HIT = PrefixHit((), 0, False)


class BlockPool:
    """Host-side paged prefix pool: free list, refcounts, prefix index.

    The pool never touches device arrays — `register`/`lookup` return
    block ids and chain nodes; the engine drives the backend's jitted
    block copies against them. Reclamation (`_alloc_block` with an empty
    free list) evicts the least-recently-used *leaf* whose refcount is
    zero and which was not pinned by a probe or registration this epoch
    — so a chain an admission is about to seed from can never be pulled
    out from under it within the step."""

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 1:
            raise ValueError(f"BlockPool needs num_blocks >= 1, got "
                             f"{num_blocks}")
        if block_tokens < 1:
            raise ValueError(f"BlockPool needs block_tokens >= 1, got "
                             f"{block_tokens}")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self._root = BlockNode(-1, 0, (), None, True)
        self._free = list(range(num_blocks))
        self._nodes: dict[int, BlockNode] = {}
        self._tick = 0
        self._epoch = 0
        # physical writes per block id: a shared block is written once at
        # registration no matter how many requests later reference it —
        # the RRAM write-once contract, auditable per block
        self.block_writes = np.zeros(num_blocks, np.int64)
        self.stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                      "cow_copies": 0, "blocks_registered": 0,
                      "blocks_evicted": 0, "block_writes": 0}

    # ---- views -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def pinned_blocks(self) -> int:
        """Blocks referenced by a live admission (refcount > 0). The
        used/pinned gap is reclaimable cache: evictable on demand, so
        capacity gates must not count it as occupied."""
        return sum(1 for n in self._nodes.values() if n.refcount > 0)

    @property
    def max_refcount(self) -> int:
        return max((n.refcount for n in self._nodes.values()), default=0)

    @property
    def total_refcount(self) -> int:
        return sum(n.refcount for n in self._nodes.values())

    def begin_epoch(self):
        """Start a new engine step: pins from previous steps expire."""
        self._epoch += 1

    def _touch(self, node: BlockNode):
        self._tick += 1
        node.tick = self._tick
        node.pin_epoch = self._epoch

    # ---- probe -------------------------------------------------------
    def lookup(self, keys: tuple, *, max_hit: int,
               require_state: bool = False, grid: int = 1) -> PrefixHit:
        """Longest usable cached prefix of ``keys``.

        ``max_hit`` caps the hit length (the engine passes
        ``prompt_len - 1``: at least one position must run through the
        model to produce the first-token logits). ``require_state``
        (recurrent architectures) restricts hits to nodes carrying a
        state snapshot whose end lands on the canonical ``grid``
        (`backend.chunk_unit`) — the only resume points that keep
        chunked prefill bit-identical to a whole-prompt run. Matched
        nodes are pinned for the current epoch (not refcounted — denied
        admissions must not leak references; `acquire` runs only when
        the admission chunk actually executes)."""
        self.stats["lookups"] += 1
        bt = self.block_tokens
        cur, nodes, pos = self._root, [], 0
        while pos + bt <= max_hit:
            child = cur.children.get(tuple(keys[pos:pos + bt]))
            if child is None:
                break
            nodes.append(child)
            cur = child
            pos += bt
        partial = False
        if require_state:
            # only a node.end with a snapshot ON the chunk grid can
            # resume an SSM prefill; a stored exact-tail partial node
            # (same prompt resubmitted) extends the chain when eligible
            best = None
            for cand in cur.partials:
                e = pos + len(cand.keys)
                if (cand.has_state and e <= max_hit and e % grid == 0
                        and tuple(keys[pos:e]) == cand.keys):
                    if best is None or e > best.end:
                        best = cand
            if best is not None:
                nodes.append(best)
                pos = best.end
            else:
                while nodes and not (nodes[-1].has_state
                                     and nodes[-1].end % grid == 0):
                    pos = nodes[-1].start
                    nodes.pop()
        else:
            # divergence INSIDE the next block still hits the longest
            # common prefix of a stored block (full child or partial
            # tail) — the rows [start, start+j) seed the workspace and
            # the tail recomputes (copy-on-write at registration)
            limit = min(max_hit - pos, bt)
            tail = tuple(keys[pos:pos + bt])
            best, best_j = None, 0
            for cand in list(cur.children.values()) + cur.partials:
                j = min(_lcp(cand.keys, tail), limit)
                if j > best_j:
                    best, best_j = cand, j
            if best is not None and best_j > 0:
                nodes.append(best)
                pos += best_j
                partial = best_j < len(best.keys)
        if pos == 0:
            return _EMPTY_HIT
        for n in nodes:
            self._touch(n)
        self.stats["hits"] += 1
        self.stats["hit_tokens"] += pos
        return PrefixHit(tuple(nodes), pos, partial)

    # ---- reference counting ------------------------------------------
    def acquire(self, hit: PrefixHit):
        """Pin a hit chain for the admit -> commit window: every node a
        seeding admission reads gains a reference, so reclamation can
        never free a block an in-flight prefill depends on."""
        for n in hit.nodes:
            n.refcount += 1

    def release(self, hit: PrefixHit):
        for n in hit.nodes:
            if n.refcount <= 0:
                raise AssertionError(
                    f"double release of block {n.bid} (refcount "
                    f"{n.refcount})")
            n.refcount -= 1

    # ---- registration -------------------------------------------------
    def register(self, keys: tuple, *, max_start: int
                 ) -> tuple[list[BlockNode], Optional[BlockNode]]:
        """Index a freshly prefilled prompt's prefix, deduplicating
        against everything already stored.

        Re-walks the tree from the root: existing full blocks are
        reused untouched (NO new physical write — this is the shared-
        block write-once contract), missing full blocks and the final
        partial tail allocate fresh block ids. Returns
        ``(new_nodes, terminal)``: the caller must physically write each
        new node's workspace rows into its block, and ``terminal`` is
        the node whose ``end`` equals ``len(keys)`` (the state-snapshot
        attach point for recurrent architectures) — None when the pool
        ran out of blocks mid-chain or the tail was not storable.

        ``max_start``: a block's rows are copied with a fixed
        ``block_tokens``-wide slice, so only start positions
        ``<= max_start`` (i.e. ``max_len - block_tokens``) are storable
        without the slice clamping out of the workspace."""
        bt = self.block_tokens
        cur, pos = self._root, 0
        new: list[BlockNode] = []
        while pos + bt <= len(keys):
            seg = tuple(keys[pos:pos + bt])
            child = cur.children.get(seg)
            if child is None:
                if pos > max_start:
                    return new, None
                bid = self._alloc_block()
                if bid is None:
                    return new, None          # pool exhausted: partial index
                child = BlockNode(bid, pos, seg, cur, True)
                cur.children[seg] = child
                self._nodes[bid] = child
                new.append(child)
                self.stats["blocks_registered"] += 1
            self._touch(child)
            cur = child
            pos += bt
        if pos == len(keys):
            return new, (cur if cur is not self._root else None)
        seg = tuple(keys[pos:])
        for cand in cur.partials:
            if cand.keys == seg:              # exact-tail dedup: repeated
                self._touch(cand)             # identical prompts write once
                return new, cand
        if pos > max_start:
            return new, None
        bid = self._alloc_block()
        if bid is None:
            return new, None
        node = BlockNode(bid, pos, seg, cur, False)
        cur.partials.append(node)
        self._nodes[bid] = node
        new.append(node)
        self.stats["blocks_registered"] += 1
        self._touch(node)
        return new, node

    def note_write(self, bid: int):
        """Record one physical write to block ``bid`` (workspace rows or
        a state snapshot) — the endurance ledger shared blocks are
        audited against."""
        self.block_writes[bid] += 1
        self.stats["block_writes"] += 1

    # ---- reclamation --------------------------------------------------
    def _alloc_block(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = None
        for node in self._nodes.values():
            if (node.refcount == 0 and not node.children
                    and not node.partials
                    and node.pin_epoch != self._epoch):
                if victim is None or node.tick < victim.tick:
                    victim = node
        if victim is None:
            return None
        self._evict_node(victim)
        return self._free.pop()

    def _evict_node(self, node: BlockNode):
        assert node.refcount == 0 and not node.children \
            and not node.partials
        if node.full:
            del node.parent.children[node.keys]
        else:
            node.parent.partials.remove(node)
        del self._nodes[node.bid]
        self._free.append(node.bid)
        self.stats["blocks_evicted"] += 1

    # ---- invariants (hypothesis harness hooks) ------------------------
    def check_invariants(self):
        """Structural audit: block-id conservation, linkage, refcounts.
        Raises AssertionError on violation (the property-test oracle)."""
        live = set(self._nodes)
        free = set(self._free)
        assert len(self._free) == len(free), "duplicate free block ids"
        assert not (live & free), f"block ids both live and free: " \
            f"{sorted(live & free)}"
        assert live | free == set(range(self.num_blocks)), \
            "block ids leaked or invented"
        seen: set[int] = set()
        stack = [self._root]
        while stack:
            node = stack.pop()
            for seg, child in node.children.items():
                assert node.full, "partial node grew children"
                assert child.parent is node and child.keys == seg
                assert child.full and len(child.keys) == self.block_tokens
                assert child.start == node.end
                assert child.refcount >= 0
                assert child.bid in live and child.bid not in seen
                seen.add(child.bid)
                stack.append(child)
            for child in node.partials:
                assert node.full, "partial node grew partials"
                assert child.parent is node and not child.full
                assert 0 < len(child.keys) < self.block_tokens
                assert child.start == node.end
                assert child.refcount >= 0
                assert child.bid in live and child.bid not in seen
                seen.add(child.bid)
        assert seen == live, "unreachable live blocks (tree/table drift)"
