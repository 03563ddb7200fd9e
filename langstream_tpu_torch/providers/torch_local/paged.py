"""Host-side accounting for the paged KV cache (``kv_layout="paged"``).

Port of ``langstream_tpu/providers/jax_local/paged.py``, pure Python, kept
whole (host tier and handoff hooks included) so that later slices keep
its schema. The rolling chain digest it keys the host tier by is copied
here from ``langstream_tpu/fleet/router.py``. :meth:`PagedKVManager.allocate`
holds the ``pool_exhausted`` fault point (``runtime/faults.py``).

The device side is a global block pool ``[layers, num_blocks, block_size,
kv_heads, head_dim]`` (``model.init_paged_cache``) addressed through
per-slot block tables; THIS module owns everything about which block
holds what:

- **Free-list allocation** with per-block refcounts (block 0 is the null
  block — padding rows and masked writes are routed there and its
  content is never read through a live length mask).
- **Prefix cache**: a persistent token-chunk → block map. Keys are
  ``(parent_block, chunk_tokens)`` — chaining through the parent block
  id makes the key collision-free without hashing the whole prefix
  (a chunk's KV depends on the entire token prefix, which the parent
  chain uniquely identifies), which is the AIBrix/vLLM hash-chain idea
  with Python dict identity instead of digests.
- **Refcounted sharing**: a published block may be referenced by any
  number of slot tables at once; it is freed only when its refcount is
  zero AND it has been evicted from the map.
- **LRU eviction**: when allocation runs dry, least-recently-touched
  cached blocks with refcount 0 are unpublished, leaf-first (a block
  with cached children is never evicted before them — a recycled parent
  id would otherwise let a *different* chain's key resolve to a stale
  child whose KV belongs to the old prefix).

Copy-on-write is decided here (:meth:`is_shared`); the engine's session
path executes it (a private copy of a shared block before a write into
it, ``engine._dispatch_block_copy``).

**Two tiers**: when a :class:`HostKVArena` is attached, eviction
*demotes* victim chains into bounded host RAM instead of dropping them,
and admission can *promote* them back (see
:meth:`PagedKVManager.host_match`). The host tier is keyed by the
rolling chain digest (:func:`prompt_digests`) rather than
``(parent_block, chunk)``: pool block ids recycle the moment a chain is
evicted, so a block-keyed host entry could resolve a recycled id to
another chain's rows — the digest encodes the whole token prefix and
never recycles. The engine attaches the tier with ``kv_host_blocks`` > 0
(``engine.DecodeEngine._demote_block_data`` is its data-plane hook), and
imports a prefill replica's handoff through :meth:`PagedKVManager.import_session`.
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from langstream_tpu_torch.runtime import faults

# the reserved null block: block tables point padding / masked writes
# here; attention never reads it through a live length mask
NULL_BLOCK = 0

_DIGEST_SIZE = 12  # bytes; 24 hex chars on the wire


def _chunk_digest(parent: bytes, chunk: Sequence[int]) -> bytes:
    data = ",".join(str(int(t)) for t in chunk).encode()
    return hashlib.blake2b(data, digest_size=_DIGEST_SIZE, key=parent).digest()


def prompt_digests(
    tokens: Sequence[int], block_size: int, limit: Optional[int] = None
) -> List[str]:
    """Rolling hash-chain digests for ``tokens``, one per FULL block
    (partial trailing blocks never match, mirroring the manager's
    block-granular admission). ``limit`` caps the chain length."""
    if block_size <= 0:
        return []
    out: List[str] = []
    parent = b""
    blocks = len(tokens) // block_size
    if limit is not None:
        blocks = min(blocks, limit)
    for i in range(blocks):
        parent = _chunk_digest(parent, tokens[i * block_size:(i + 1) * block_size])
        out.append(parent.hex())
    return out


class HostKVEntry:
    """One demoted block's worth of chain, keyed by the rolling chain
    digest of the token prefix it completes. ``data`` is the per-leaf
    host copy of the block's pool rows (``leaf -> [layers, block_size,
    kv_heads, head_dim]``, int8 pools carry their scale leaves too) —
    or None in accounting-only arenas (the fleet sim)."""

    __slots__ = ("digest", "parent_digest", "chunk", "data", "nbytes")

    def __init__(
        self,
        digest: str,
        parent_digest: str,
        chunk: Tuple[int, ...],
        data: Optional[Dict[str, object]],
        nbytes: int,
    ) -> None:
        self.digest = digest
        self.parent_digest = parent_digest  # "" = chain root
        self.chunk = chunk
        self.data = data
        self.nbytes = int(nbytes)


class HostKVArena:
    """Bounded pinned-host-RAM demotion tier below the HBM pool.

    Same LRU discipline as the HBM prefix cache, leaf-first by design:
    a parent entry is never evicted while a demoted child is resident,
    so the host tier's digest set stays ancestry-complete *within the
    tier* (an entry's missing ancestors are, by leaf-first HBM
    demotion order, still published in HBM) — the invariant heartbeat
    gossip relies on for leading-prefix scoring.

    Unlike :class:`PagedKVManager` (engine-thread-owned), this class IS
    thread-safe: the engine thread demotes/promotes while the gossip
    task snapshots :meth:`digests` for heartbeats, so every access
    holds ``_lock``.
    """

    def __init__(self, capacity_blocks: int) -> None:
        if capacity_blocks < 1:
            raise ValueError("host arena needs at least 1 block")
        self.capacity_blocks = int(capacity_blocks)
        self._lock = threading.Lock()
        self._entries: Dict[str, HostKVEntry] = {}  # guarded-by: _lock
        # digest -> count of RESIDENT children (incremented at child
        # put, decremented at child removal — a digest forest always
        # has a leaf, so eviction always progresses)
        self._children: Dict[str, int] = {}  # guarded-by: _lock
        self._lru: Dict[str, int] = {}  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock
        # called with each digest the LRU drops (under the lock, on the
        # thread that put): a tensor-parallel engine publishes it, so that
        # the followers' tiers hold what this one holds
        self.on_evict: Optional[Callable[[str], None]] = None
        self.stats: Dict[str, int] = {  # guarded-by: _lock
            "demoted_blocks": 0,   # entries accepted from the HBM tier
            "promoted_blocks": 0,  # entries scattered back to HBM
            "evictions": 0,        # entries dropped by host-tier LRU
            "demoted_bytes": 0,    # host bytes written by demotions
        }

    # requires-lock: _lock
    def _touch_locked(self, digest: str) -> None:
        self._tick += 1
        self._lru[digest] = self._tick

    # requires-lock: _lock
    def _remove_locked(self, digest: str) -> None:
        entry = self._entries.pop(digest)
        self._lru.pop(digest, None)
        self._children.pop(digest, None)
        parent = entry.parent_digest
        if parent:
            left = self._children.get(parent, 0) - 1
            if left > 0:
                self._children[parent] = left
            else:
                self._children.pop(parent, None)

    # requires-lock: _lock
    def _evict_locked(self) -> bool:
        """Drop the least-recently-used LEAF entry (no resident
        children). Leaf-first mirrors the HBM pool's discipline and
        keeps resident chains ancestry-complete."""
        for digest, _ in sorted(self._lru.items(), key=lambda kv: kv[1]):
            if self._children.get(digest, 0) == 0:
                self._remove_locked(digest)
                self.stats["evictions"] += 1
                if self.on_evict is not None:
                    self.on_evict(digest)
                return True
        return False

    @property
    def blocks_in_use(self) -> int:
        with self._lock:
            return len(self._entries)

    def has(self, digest: str) -> bool:
        with self._lock:
            return digest in self._entries

    def touch(self, digest: str) -> None:
        with self._lock:
            if digest in self._entries:
                self._touch_locked(digest)

    def lookup(self, digest: str) -> Optional[HostKVEntry]:
        """The resident entry for ``digest`` (LRU-touched), or None."""
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                self._touch_locked(digest)
            return entry

    def put(
        self,
        digest: str,
        parent_digest: str,
        chunk: Sequence[int],
        data: Optional[Dict[str, object]],
        nbytes: int,
    ) -> bool:
        """Admit one demoted block; capacity pressure evicts LRU leaves
        first. Idempotent per digest (a re-demotion of a promoted chain
        only refreshes the LRU tick). False when the arena refused the
        entry (already resident, or nothing evictable)."""
        with self._lock:
            if digest in self._entries:
                self._touch_locked(digest)
                return False
            while len(self._entries) >= self.capacity_blocks:
                if not self._evict_locked():
                    return False
            self._entries[digest] = HostKVEntry(
                digest, parent_digest, tuple(chunk), data, nbytes
            )
            if parent_digest:
                self._children[parent_digest] = (
                    self._children.get(parent_digest, 0) + 1
                )
            self._touch_locked(digest)
            self.stats["demoted_blocks"] += 1
            self.stats["demoted_bytes"] += int(nbytes)
            return True

    def note_promoted(self, blocks: int) -> None:
        with self._lock:
            self.stats["promoted_blocks"] += int(blocks)

    def digests(self) -> Set[str]:
        """Snapshot of resident digests — heartbeat gossip's host-tier
        tag (``host_chain_digests``); safe from any thread."""
        with self._lock:
            return set(self._entries)

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats)
            out["blocks_in_use"] = len(self._entries)
            return out


class PagedKVManager:
    """Block accounting for one engine's pool. NOT thread-safe by
    design: every call happens on the engine thread, like the slot
    bookkeeping it extends."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 2:
            raise ValueError("paged pool needs at least 2 blocks")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(1, num_blocks))
        self._refcount = [0] * num_blocks
        # prefix map: (parent block id | -1, tuple(chunk tokens)) -> block
        self._map: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._key_of: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._parent: Dict[int, int] = {}
        self._children: Dict[int, int] = {}
        self._lru: Dict[int, int] = {}  # cached block -> last-touch tick
        self._tick = 0
        # opaque per-published-block scratch for external digesters
        # (fleet/router.py:digests_from_keys memoizes its hash chains
        # here): entries live as long as the block stays published —
        # popped in _unpublish, and each entry additionally carries the
        # chain key it was computed for, so even a write-back racing an
        # eviction on another thread can never serve a recycled id a
        # stale digest (the key mismatch forces a recompute)
        self.digest_memo: Dict[int, object] = {}
        # host-DRAM demotion tier: when attached, _evict
        # demotes victim chains into the arena instead of dropping
        # them; _demote_data is the optional data-plane hook (the
        # engine's D2H gather — None keeps the arena accounting-only,
        # the fleet sim's mode)
        self.host: Optional[HostKVArena] = None
        self._demote_data: Optional[
            Callable[[int], Optional[Tuple[Dict[str, object], int]]]
        ] = None
        self._on_demoted: Optional[Callable[[int, str], None]] = None
        self.stats: Dict[str, int] = {
            "hit_tokens": 0,       # prompt tokens served from cached blocks
            "evictions": 0,        # cached blocks unpublished under pressure
            "cow_copies": 0,       # private copies made before a shared write
            "published_blocks": 0,
            "demotions": 0,        # victim blocks demoted to the host tier
        }

    # ------------------------------------------------------------------ #
    # pool state
    # ------------------------------------------------------------------ #
    @property
    def blocks_in_use(self) -> int:
        """Blocks either referenced by a slot table or held by the
        prefix cache (everything not on the free list, minus null)."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def blocks_cached(self) -> int:
        return len(self._key_of)

    def refcount(self, block: int) -> int:
        return self._refcount[block]

    def is_shared(self, block: int) -> bool:
        """True when writing this block in place would be visible to
        someone else: another slot's table, or the prefix map."""
        return self._refcount[block] > 1 or block in self._key_of

    # ------------------------------------------------------------------ #
    # allocation / refcounts
    # ------------------------------------------------------------------ #
    def allocate(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh blocks (refcount 1 each), evicting LRU
        cached chains if the free list is short. None when the pool
        genuinely cannot satisfy the request (every block referenced)."""
        if n <= 0:
            return []
        if faults.fire("pool_exhausted") is not None:
            # chaos (LANGSTREAM_FAULTS=pool_exhausted@...): report an
            # exhausted pool without touching real state
            return None
        if len(self._free) < n:
            self._evict(n - len(self._free))
        if len(self._free) < n:
            return None
        out = [self._free.popleft() for _ in range(n)]
        for block in out:
            self._refcount[block] = 1
        return out

    def ref(self, blocks: Sequence[int]) -> None:
        for block in blocks:
            self._refcount[block] += 1

    def unref(self, block: int) -> None:
        self._refcount[block] -= 1
        assert self._refcount[block] >= 0, f"refcount underflow on {block}"
        if self._refcount[block] == 0 and block not in self._key_of:
            self._free.append(block)

    def release(self, blocks: Sequence[int]) -> None:
        for block in blocks:
            self.unref(block)

    # ------------------------------------------------------------------ #
    # prefix cache
    # ------------------------------------------------------------------ #
    def _touch(self, block: int) -> None:
        self._tick += 1
        self._lru[block] = self._tick

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block chain covering a prefix of ``tokens``
        (block-granular — partial blocks never match). Returns
        (block ids, matched token count); refcounts are NOT taken —
        callers :meth:`ref` the chain once they commit to it."""
        size = self.block_size
        parent, chain = -1, []
        for i in range(len(tokens) // size):
            chunk = tuple(tokens[i * size:(i + 1) * size])
            block = self._map.get((parent, chunk))
            if block is None:
                break
            chain.append(block)
            parent = block
        for block in chain:
            self._touch(block)
        return chain, len(chain) * size

    def publish(self, tokens: Sequence[int], blocks: Sequence[int]) -> None:
        """Make the full blocks of ``tokens`` (held in ``blocks``)
        matchable by future admissions. Idempotent; an existing entry
        for a chunk wins (the canonical chain continues through it, so
        duplicates produced by concurrent identical prompts stay
        private and free normally)."""
        size = self.block_size
        parent = -1
        for i in range(len(tokens) // size):
            if i >= len(blocks):
                break
            block = blocks[i]
            chunk = tuple(tokens[i * size:(i + 1) * size])
            key = (parent, chunk)
            existing = self._map.get(key)
            if existing is not None:
                self._touch(existing)
                parent = existing
                continue
            if block in self._key_of:
                # already published (e.g. re-publish at finish of a
                # chain published at admission) — just walk through it
                parent = block
                continue
            self._map[key] = block
            self._key_of[block] = key
            self._parent[block] = parent
            if parent >= 0:
                self._children[parent] = self._children.get(parent, 0) + 1
            self._touch(block)
            self.stats["published_blocks"] += 1
            parent = block

    def published_keys(
        self, limit: Optional[int] = None
    ) -> Dict[int, Tuple[int, Tuple[int, ...]]]:
        """Snapshot of the published chain map ``block ->
        (parent_block, chunk_tokens)`` — the fleet router's raw
        material (``fleet/router.py:digests_from_keys`` turns it into
        pool-free hash-chain digests for heartbeat gossip).

        ``limit`` caps the snapshot for gossip budgets: the
        most-recently-touched blocks win, with their ancestor chains
        included (publish order + leaf-first eviction guarantee every
        published block's ancestors are published, and a digest set
        missing an ancestor could never match the chain below it)."""
        if limit is None or len(self._key_of) <= limit:
            return dict(self._key_of)
        out: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        by_recency = sorted(
            self._key_of, key=lambda b: self._lru.get(b, 0), reverse=True
        )
        for block in by_recency:
            if len(out) >= limit:
                break
            walk = block
            chain = []
            while walk >= 0 and walk not in out:
                key = self._key_of.get(walk)
                if key is None:
                    break
                chain.append((walk, key))
                walk = key[0]
            for b, key in chain:
                out[b] = key
        return out

    # ------------------------------------------------------------------ #
    # host-DRAM tier
    # ------------------------------------------------------------------ #
    def attach_host(
        self,
        arena: HostKVArena,
        demote_data: Optional[
            Callable[[int], Optional[Tuple[Dict[str, object], int]]]
        ] = None,
        on_demoted: Optional[Callable[[int, str], None]] = None,
    ) -> None:
        """Attach the host-DRAM demotion tier. ``demote_data(block)``
        is the data-plane hook — the engine's D2H gather of one
        block's pool rows, returning ``(leaf tree, nbytes)`` or None
        when the rows cannot be captured (the chain then drops exactly
        as an un-tiered eviction would). None keeps the arena
        accounting-only: entries carry no rows but matching, LRU and
        capacity backpressure behave identically (the fleet sim's
        mode). ``on_demoted(block, digest)`` is told of each block the
        arena took (a tensor-parallel engine publishes it)."""
        self.host = arena
        self._demote_data = demote_data
        self._on_demoted = on_demoted

    def chain_digest(self, block: int) -> Optional[str]:
        """Rolling chain digest (:func:`_chunk_digest`) of the token
        prefix ending at published ``block``, memoized into
        ``digest_memo`` under the same ``(key, digest)`` format the
        heartbeat digester writes — demotion-time digests and gossip
        digests can never disagree. None when the block (or an
        ancestor) is not published."""
        stack: List[Tuple[int, Tuple[int, Tuple[int, ...]]]] = []
        digest = b""
        walk = block
        while walk >= 0:
            key = self._key_of.get(walk)
            if key is None:
                return None
            memo = self.digest_memo.get(walk)
            if (
                isinstance(memo, tuple) and len(memo) == 2
                and memo[0] == key and isinstance(memo[1], bytes)
                and memo[1]
            ):
                digest = memo[1]
                break
            stack.append((walk, key))
            walk = key[0]
        for b, key in reversed(stack):
            digest = _chunk_digest(digest, key[1])
            self.digest_memo[b] = (key, digest)
        return digest.hex()

    def _demote(self, block: int) -> None:
        """Move a victim chain block into the host tier before it is
        unpublished. Digest-keyed on purpose: the HBM block id recycles
        the moment :meth:`_evict` frees it, so a host entry keyed by
        ``(parent_block, chunk)`` could later resolve a recycled id to
        another chain's rows — the digest encodes the whole token
        prefix and never recycles. Leaf-first eviction order means the
        victim's ancestors are still published here, so the digest walk
        always completes."""
        host = self.host
        if host is None:
            return
        key = self._key_of.get(block)
        if key is None:
            return
        digest = self.chain_digest(block)
        if digest is None:
            return
        if host.has(digest):
            # promoted-then-re-evicted chain: the host copy is bitwise
            # identical (published blocks are immutable), so refresh
            # the LRU tick and skip the D2H gather
            host.touch(digest)
            return
        parent_digest = ""
        if key[0] >= 0:
            parent_digest = self.chain_digest(key[0]) or ""
            if not parent_digest:
                return
        data: Optional[Dict[str, object]] = None
        nbytes = 0
        if self._demote_data is not None:
            fetched = self._demote_data(block)
            if fetched is None:
                return  # data plane unavailable: drop like an eviction
            data, nbytes = fetched
        if host.put(digest, parent_digest, key[1], data, nbytes):
            self.stats["demotions"] += 1
            if self._on_demoted is not None:
                self._on_demoted(block, digest)

    def host_match(self, tokens: Sequence[int], start_block: int) -> List[HostKVEntry]:
        """Consecutive host-tier entries continuing the HBM chain from
        full-block index ``start_block`` of ``tokens``. Digest-keyed, so
        a match proves the ENTIRE token prefix across both tiers; the
        caller promotes the returned entries (engine: H2D scatter +
        publish-at-commit) or treats them as accounting hits (sim)."""
        host = self.host
        if host is None:
            return []
        size = self.block_size
        full = len(tokens) // size
        if start_block >= full:
            return []
        digests = prompt_digests(tokens, size, limit=full)
        out: List[HostKVEntry] = []
        for i in range(start_block, full):
            entry = host.lookup(digests[i])
            if entry is None:
                break
            out.append(entry)
        return out

    # ------------------------------------------------------------------ #
    # KV handoff (prefill/decode disaggregation, fleet/handoff.py)
    # ------------------------------------------------------------------ #
    def export_session(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """The handoff export set: the longest published chain covering
        full blocks of ``tokens``. Unlike :meth:`match`, the chain IS
        refcounted — it must survive concurrent LRU eviction while the
        engine serializes the pool data behind it — so the caller
        :meth:`release`\\ s it once the chunks are on the wire."""
        chain, matched = self.match(tokens)
        self.ref(chain)
        return chain, matched

    def import_session(
        self, tokens: Sequence[int]
    ) -> Optional[Tuple[List[int], List[int]]]:
        """Worst-case reservation at import-admission: returns
        ``(local_chain, fresh_blocks)`` — the locally-published prefix
        (refcounted, its rows need no write) plus freshly allocated
        blocks for every remaining full block of ``tokens`` — or None
        when the pool cannot cover the import even after eviction (the
        caller aborts the handoff and falls back to recompute).

        Fresh blocks stay UNPUBLISHED (refcount 1) until
        :meth:`commit_import`: an aborted partial import releases them
        straight back to the free list, so a handoff torn mid-transfer
        can never leave half-written rows matchable under live chain
        keys before the block ids recycle."""
        size = self.block_size
        full = len(tokens) // size
        chain, matched = self.match(tokens)
        self.ref(chain)
        fresh = self.allocate(full - len(chain))
        if fresh is None:
            self.release(chain)
            return None
        return chain, fresh

    def commit_import(
        self, tokens: Sequence[int], blocks: Sequence[int]
    ) -> None:
        """Publish a completed import under the same collision-free
        ``(parent_block, chunk)`` chain keys a locally-built prefix
        gets — the imported chain gossips as affinity digests and
        matches future admissions like any other — then drop the import
        refs (cache-held, evictable under pressure like any published
        chain)."""
        size = self.block_size
        self.publish(tokens[: (len(tokens) // size) * size], blocks)
        self.release(blocks)

    def abort_import(self, blocks: Sequence[int]) -> None:
        """Unwind a torn import BEFORE any block id recycles: nothing
        was published, so releasing the refs frees the fresh blocks
        (and un-pins any locally-matched prefix) with no stale-chain
        hazard."""
        self.release(blocks)

    def _unpublish(self, block: int) -> None:
        key = self._key_of.pop(block)
        del self._map[key]
        self.digest_memo.pop(block, None)
        parent = self._parent.pop(block)
        if parent >= 0:
            self._children[parent] -= 1
        self._lru.pop(block, None)
        self._children.pop(block, None)

    def _evict(self, count: int) -> int:
        """Unpublish up to ``count`` least-recently-used cached blocks
        that no slot references and that have no cached children
        (leaf-first keeps parent ids from being recycled under live
        chain keys). One LRU-ordered pass per chain depth — evicting a
        leaf can turn its parent into a leaf, so passes repeat only
        while they make progress (NOT one full sort per block)."""
        evicted = 0
        while evicted < count:
            progress = False
            for block, _ in sorted(self._lru.items(), key=lambda kv: kv[1]):
                if evicted >= count:
                    break
                if (
                    self._refcount[block] == 0
                    and not self._children.get(block)
                ):
                    if self.host is not None:
                        self._demote(block)
                    self._unpublish(block)
                    self._free.append(block)
                    self.stats["evictions"] += 1
                    evicted += 1
                    progress = True
            if not progress:
                break
        return evicted

    def _evict_one(self) -> bool:
        return self._evict(1) == 1
