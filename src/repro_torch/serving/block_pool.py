"""Host-side KV block-pool allocator for the paged serving cache
(counterpart of ``repro/serving/block_pool.py``, a copy: its decisions,
the ids ``alloc`` returns, ``match`` results and the blake2b chunk keys,
are the reference's for the same sequence of calls).

The paged layout slices the KV cache into fixed ``block_size``-token
blocks drawn from a shared pool; a sequence owns ``ceil(len / bs)``
blocks instead of a full ``max_seq_len`` arena row, so the HBM budget
admits ~``max_len / mean_len`` times more concurrent sequences on
ragged traffic.  This module is the pure-Python bookkeeping half: the
device half (the pool tensors and the CUDA paged-attention kernels that
walk the per-slot block tables) lives in
:mod:`repro_torch.models.transformer` /
:mod:`repro_torch.kernels.paged_attention`.

Design notes:

- **Block 0 is the trash block.**  It is never handed out; block-table
  rows are padded with 0, so device-side writes that fall outside a
  slot's allocated prefix (bucket-padding garbage at admit, post-EOS
  decode writes before the slot is harvested) land in a block nobody
  reads.  This removes every bounds check from the decode hot loop.
  (When a finished slot's table is fully allocated, its clamped
  post-EOS writes wrap into its own last block instead — which is why
  the prefix cache never indexes the last block of a fully allocated
  table; every other full block is immutable once written.)
- **No external fragmentation.**  All blocks are the same size, the
  free list is a stack, and any free block satisfies any request —
  after arbitrary ragged alloc/free cycles an allocation succeeds iff
  ``available >= n``.  The only fragmentation is *internal*: the unused
  tail of each sequence's last block, bounded by ``block_size - 1``
  tokens per active sequence.
- **Reference counting.**  Every allocated block carries a refcount:
  ``alloc`` hands out blocks at ref 1, :meth:`match` maps an indexed
  block into another sequence's table by bumping its ref, and
  :meth:`free` decrements.  A block whose ref drops to 0 returns to the
  free list — unless it is indexed in the prefix cache, in which case
  it parks in an LRU of *cached* (unreferenced but intact) blocks.
  Invariant, checked by the property suite in
  ``tests/test_block_pool_properties.py`` (and, on this
  copy, ``tests/test_torch_paged.py``)::

      num_live + num_cached + num_free == capacity

- **Prefix cache (radix index).**  :meth:`insert` keys each *full*
  block of a token sequence by a content hash chained over every token
  before it (a radix-tree path, flattened: ``key_i =
  H(key_{i-1} || tokens[i*bs:(i+1)*bs])``), so a lookup of the i-th
  chunk implies every earlier chunk matched too.  :meth:`match` walks a
  prompt's chunks through the index and returns the longest cached
  prefix, reviving LRU-parked blocks and bumping refs.  Matching is
  capped at ``(len - 1) // block_size`` blocks so at least one prompt
  token is always left to prefill (its logits seed decode).  Partially
  filled tail blocks are **never shared** — the uncached suffix,
  including any partial tail chunk, is recomputed into freshly
  allocated private blocks (compute-side copy-on-write), so a shared
  block is immutable for its whole indexed lifetime: a sequence only
  writes KV rows at positions ``>= prompt_len``, which land strictly
  past its matched prefix.
- **Eviction before preemption.**  ``alloc`` pops the free list first
  and then evicts cached blocks in LRU order (index entry dropped,
  block recycled).  ``available = num_free + num_cached`` is the
  admission-control quantity: a pool full of unreferenced cached
  blocks is as good as empty, so enabling the cache never admits less
  — and the engine only preempts a running slot when even eviction
  cannot supply a block.
- **Watermark backpressure.**  ``can_admit`` additionally requires
  ``watermark`` blocks to stay *available* after the admission,
  reserving headroom for decode-time appends of the already-running
  slots so the scheduler rarely needs to preempt (the engine's
  preemption path is the hard no-deadlock guarantee; the watermark
  keeps it cold).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

TRASH_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV rows."""
    return -(-max(n_tokens, 0) // block_size)


def _chunk_key(parent: bytes, chunk) -> bytes:
    """Content-hash radix key of one full token chunk: digest of the
    parent chunk's key (i.e. of the whole preceding token prefix)
    followed by this chunk's tokens."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.ascontiguousarray(chunk, dtype=np.int32).tobytes())
    return h.digest()


class BlockAllocator:
    """Fixed-size KV block pool: ref-counted free-list alloc/free,
    watermark admission, and a content-hash prefix index with LRU
    eviction of unreferenced cached blocks.

    ``num_blocks`` counts the whole pool *including* the reserved trash
    block, so device pool arrays are shaped ``(num_blocks, block_size,
    ...)`` and ``capacity == num_blocks - 1`` blocks are allocatable.

    The prefix-cache machinery (:meth:`match` / :meth:`insert`) is
    inert until used: a caller that only ever allocs and frees sees the
    historical pure free-list behaviour, and ``available == num_free``.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 watermark: int = 0):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.watermark = max(0, int(watermark))
        # LIFO free list: recently freed (cache-warm) blocks reused first
        self._free: List[int] = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._free_set = set(self._free)
        self._ref = np.zeros(num_blocks, np.int32)
        self._key_of: Dict[int, bytes] = {}      # block id -> radix key
        self._index: Dict[bytes, int] = {}       # radix key -> block id
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref==0 cached
        self._hwm = 0                      # high-water mark of LIVE blocks
        # prefix-cache counters (block granularity)
        self.hit_blocks = 0
        self.miss_blocks = 0
        self.evictions = 0

    # -------------------------------------------------------------- #
    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Unreferenced blocks parked in the prefix cache (evictable)."""
        return len(self._lru)

    @property
    def num_live(self) -> int:
        """Blocks currently referenced by at least one slot."""
        return self.capacity - self.num_free - self.num_cached

    @property
    def available(self) -> int:
        """Blocks an allocation can draw on: free + evictable cached."""
        return self.num_free + self.num_cached

    @property
    def num_used(self) -> int:
        return self.capacity - self.num_free

    @property
    def high_water(self) -> int:
        return self._hwm

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    # -------------------------------------------------------------- #
    def fits(self, n_tokens: int) -> bool:
        """Whether a request of ``n_tokens`` total rows can EVER run
        (its worst-case block count fits the whole pool)."""
        return self.blocks_for(n_tokens) <= self.capacity

    def can_admit(self, n_prompt_tokens: int, *,
                  reserve: Optional[int] = None,
                  ignore_watermark: bool = False) -> bool:
        """Admission control: enough *available* blocks (free + cached
        evictable) for the prompt AND a reserve stays intact afterwards
        (``reserve`` overrides the constructed watermark — the engine
        passes a dynamic reserve scaled by the number of *running*
        slots).  The engine waives the reserve when nothing is running
        (an empty batch means it protects nobody and waiting would
        deadlock).  Deliberately conservative about prefix hits: a
        matched prefix only ever *reduces* the blocks actually drawn."""
        need = self.blocks_for(n_prompt_tokens)
        r = self.watermark if reserve is None else max(0, int(reserve))
        if ignore_watermark:
            r = 0
        return self.available - need >= r

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, evicting cached blocks (LRU
        first) if the free list runs short; None (and no change) if even
        eviction cannot supply ``n``."""
        if n < 0 or n > self.available:
            return None
        while len(self._free) < n:
            self._evict_lru()
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for b in out:
            self._ref[b] = 1
        # pool pressure = LIVE blocks (== num_used with the cache off);
        # counting LRU-parked cached blocks would saturate the stat at
        # capacity after a few harvests and mislead pool-size tuning
        self._hwm = max(self._hwm, self.num_live)
        return out

    def free(self, ids) -> None:
        """Drop one reference per listed block.  A block reaching ref 0
        parks in the cache LRU if it is indexed, else returns to the
        free list."""
        for i in ids:
            if i == TRASH_BLOCK:
                raise ValueError("freeing the trash block")
            if (not (0 < i < self.num_blocks) or i in self._free_set
                    or self._ref[i] <= 0):
                raise ValueError(f"double/invalid free of block {i}")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                if i in self._key_of:
                    self._lru[i] = None        # most-recently-used end
                else:
                    self._free.append(i)
                    self._free_set.add(i)

    def _evict_lru(self) -> None:
        b, _ = self._lru.popitem(last=False)   # least recently used
        del self._index[self._key_of.pop(b)]
        self._free.append(b)
        self._free_set.add(b)
        self.evictions += 1

    # -------------------------------------------------------------- #
    # prefix cache: content-hash radix index over full token blocks
    # -------------------------------------------------------------- #
    def chunk_keys(self, tokens, n_chunks: Optional[int] = None
                   ) -> List[bytes]:
        """Chain keys for the first ``n_chunks`` full blocks of
        ``tokens`` (default: every full block).  Callers that both
        :meth:`match` and :meth:`insert` the same prompt compute this
        once and pass it to both — the chain is a prefix hash, so one
        list serves any shorter cap."""
        bs = self.block_size
        if n_chunks is None:
            n_chunks = len(tokens) // bs
        keys, parent = [], b""
        for i in range(n_chunks):
            parent = _chunk_key(parent, tokens[i * bs:(i + 1) * bs])
            keys.append(parent)
        return keys

    def match(self, tokens, *, keys: Optional[List[bytes]] = None
              ) -> List[int]:
        """Longest cached prefix of ``tokens`` at full-block
        granularity, capped one token short of the prompt (decode needs
        the last token's logits, so at least one token always
        prefills).  Matched blocks are mapped into the caller's table:
        each gets a reference (revived from the LRU if it was parked
        there).  Returns the matched block ids in prefix order."""
        cap = (len(tokens) - 1) // self.block_size
        out: List[int] = []
        for key in (keys[:cap] if keys is not None
                    else self.chunk_keys(tokens, cap)):
            b = self._index.get(key)
            if b is None:
                break
            if self._ref[b] == 0:
                del self._lru[b]               # revive from the cache LRU
            self._ref[b] += 1
            out.append(b)
        self._hwm = max(self._hwm, self.num_live)
        # hit rate is over MATCHABLE blocks (the cap), not total blocks:
        # the structurally unmatchable tail would otherwise make a
        # perfectly cached workload read as < 100%
        self.hit_blocks += len(out)
        self.miss_blocks += cap - len(out)
        return out

    def insert(self, tokens, ids: Sequence[int], *,
               keys: Optional[List[bytes]] = None) -> int:
        """Index the full-block prefix of ``tokens`` held in ``ids``
        (``ids[i]`` stores tokens ``[i*bs, (i+1)*bs)``).  Only complete
        blocks are keyed — the partial tail is never indexed.  A block
        already indexed (a shared prefix hit) keeps its key; a key
        already mapping to a *different* block (duplicate content racing
        in) keeps the incumbent so readers of either stay valid.
        Returns the number of newly indexed blocks."""
        n = min(len(ids), len(tokens) // self.block_size)
        added = 0
        for i, key in enumerate(keys[:n] if keys is not None
                                else self.chunk_keys(tokens, n)):
            b = ids[i]
            if b in self._key_of:              # already indexed (same chain)
                continue
            if key in self._index:             # duplicate content: keep old
                continue
            self._index[key] = b
            self._key_of[b] = key
            added += 1
        return added

    def cache_stats(self) -> dict:
        total = self.hit_blocks + self.miss_blocks
        return {
            "prefix_hit_blocks": self.hit_blocks,
            "prefix_miss_blocks": self.miss_blocks,
            "prefix_hit_rate": self.hit_blocks / total if total else 0.0,
            "cache_evictions": self.evictions,
            "cached_blocks": self.num_cached,
            "indexed_blocks": len(self._index),
        }

    def check_invariants(self) -> None:
        """Assert the pool accounting invariants (test hook; cheap
        enough to call after every operation in the property suite)."""
        assert self.num_live + self.num_cached + self.num_free \
            == self.capacity, "block counts do not sum to capacity"
        assert self.num_live >= 0
        assert len(self._free) == len(self._free_set)
        for b in self._free:
            assert self._ref[b] == 0, f"free block {b} has refs"
            assert b not in self._lru, f"block {b} both free and cached"
        for b in self._lru:
            assert self._ref[b] == 0, f"cached block {b} has refs"
            assert b in self._key_of, f"cached block {b} not indexed"
        assert TRASH_BLOCK not in self._key_of
        for key, b in self._index.items():
            assert self._key_of.get(b) == key, "index/key_of disagree"


class BlockTables:
    """Per-slot block-table bookkeeping over a :class:`BlockAllocator`.

    The host-side source of truth for which pool blocks each KV slot
    owns: ``table`` is the dense ``(slots, nbmax)`` int32 array the
    serving engine uploads as the paged decode chunk's ``block_tables``
    argument (rows padded with :data:`TRASH_BLOCK`, which absorbs
    out-of-prefix writes), and ``blocks[slot]`` is the exact mapped
    prefix — shared (prefix-cache) blocks first, then the slot's
    private blocks.  All alloc/free traffic for slot lifetimes flows
    through :meth:`assign` / :meth:`grow` / :meth:`release`, so the
    allocator's refcounts and the device tables can never disagree.
    """

    def __init__(self, alloc: BlockAllocator, slots: int, nbmax: int):
        self.alloc = alloc
        self.nbmax = int(nbmax)
        self.table = np.full((slots, nbmax), TRASH_BLOCK, np.int32)
        self.blocks: List[List[int]] = [[] for _ in range(slots)]

    def num_blocks(self, slot: int) -> int:
        return len(self.blocks[slot])

    def assign(self, slot: int, ids: Sequence[int]) -> None:
        """Install a fresh admission's prompt blocks — shared prefix
        blocks plus newly allocated suffix blocks, in table order
        (replaces any previous row — the caller must have released it
        first)."""
        self.table[slot, :] = TRASH_BLOCK
        self.table[slot, :len(ids)] = ids
        self.blocks[slot] = list(ids)

    def grow(self, slot: int, want: int) -> bool:
        """Extend slot ``slot`` to at least ``want`` blocks.  All-or-
        nothing: returns False (and changes nothing) if the pool cannot
        supply the remainder even after evicting cached blocks — the
        engine then preempts and retries (eviction before preemption)."""
        need = want - len(self.blocks[slot])
        if need <= 0:
            return True
        got = self.alloc.alloc(need)
        if got is None:
            return False
        n0 = len(self.blocks[slot])
        self.table[slot, n0:n0 + len(got)] = got
        self.blocks[slot].extend(got)
        return True

    def release(self, slot: int) -> None:
        """Drop slot ``slot``'s reference on every block it maps and
        reset its table row to all-trash (idempotent).  Blocks shared
        with other slots — or parked in the prefix cache — survive; the
        rest return to the free list.  References drop in REVERSE table
        order so indexed blocks park in the cache LRU leaf-first: a
        radix chain is only matchable from its root, so eviction must
        consume the chain tail-first — parking root-first would evict
        the root ahead of its descendants, leaving them parked but
        unmatchable."""
        if self.blocks[slot]:
            self.alloc.free(reversed(self.blocks[slot]))
            self.blocks[slot] = []
        self.table[slot, :] = TRASH_BLOCK
