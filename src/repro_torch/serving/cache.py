"""The serving caches (counterpart of ``repro.serving.cache``): the
block-pool ``PagedKVCache`` with its block accounting, the row insert of
the contiguous cache, ``insert_rows``, and ``pad_cache``, which pads an
``lm_*`` prefill cache out to a decode capacity (whisper's decode loop
runs on it).

Every leaf of a paged engine cache is one of three layouts
(``common.paged.leaf_kind``; the reference classifies them by probing,
the port reads them off the layer spec):

  * 'paged' — a GQA layer's K and V pools, laid out as the reference
    lays them out: the dense cache's batch axis becomes the block axis,
    its sequence axis the in-block offset.  A PT model's pools are
    ``[R, D, n_tracks, num_blocks, block_size, KH, hd]`` (on a track
    rank, ``runtime.parallel``, its n_tracks / W tracks); an ``lm_*``
    model's are ``[num_blocks, block_size, KH, hd]`` per prefix / suffix
    layer and ``[R, num_blocks, block_size, KH, hd]`` per unit layer.
    An MLA layer's latents are pools too, with no KV-head axis:
    ``[num_blocks, block_size, kv_lora_rank]`` (c_kv) and
    ``[num_blocks, block_size, qk_rope_head_dim]`` (k_rope), stacked
    ``[R, ...]`` in the unit: (r + rope) values a token and layer (576
    at deepseek's widths) against GQA's 2 KH hd.
    All layers share one block table, so a slot costs ``ceil(tokens /
    block_size)`` blocks.  Block 0 is the trash block: table entries of
    unallocated regions and released slots point at it, so stray writes
    (padded prefill rows, idle decode lanes) never reach a block another
    request owns.
  * 'ring' — a sliding-window layer whose window W is shorter than the
    capacity: K and V as ``max_slots`` dense rows of W positions (slot =
    position % W), as the ``lm_*`` decoder's ``init_cache`` lays them
    out, under the same block accounting as the pools;
  * 'state' — the per-slot rows of a recurrent layer (Mamba: the conv
    window and h), ``max_slots`` rows as the ``lm_*`` decoder's
    ``init_cache`` lays them out.
Ring and state leaves are the cache's "row" leaves: a row belongs to
whichever request holds the slot.

A config may have no pageable leaf at all (falcon-mamba: every leaf a
state row).  The block table still exists and admission and reclamation
still meter blocks, which are then virtual: no pools, ``pool_bytes() ==
0``, and scheduling works the same for every architecture.

With ``kv_dtype="int8"`` the pools hold int8 payloads and ``scales``
holds one fp32 scale pool per pool, shaped like it with the last axis
collapsed to 1 (one scale per token per KV head, so a decode write
touches one row's scale and never re-quantizes a block); ``pool_bytes``
counts both.

Blocks are reference-counted, as in the reference: a block may sit in
several slots' tables (a prefix-cache hit, a fork), returns to the pool
only when its count drops to zero, and is copied before a write by any
slot that shares it (``ensure_writable`` names the (src, dst) pairs,
``copy_blocks`` copies pool and scale rows).  Full blocks whose token
ids are known are content-addressed by a sha256 chain hash (the parent
block's digest and the block's int64 token ids), so a prompt sharing a
block-aligned prefix with an earlier one shares its blocks; blocks at
refcount zero keep their hash in an LRU and are evicted only when a
fresh allocation finds the plain free list empty.  The host state is
the reference's op for op (tables, refcounts, copy pairs, free and LRU
order).  The prefix cache is honoured only when every leaf is a pool
leaf (``all_pageable``): a ring or state row is per slot, not content.

The contiguous cache is the model's own ``init_cache`` tree at
``max_slots`` rows of ``max_seq_len`` positions, with no block
accounting; ``insert_rows`` writes a prefill cache into it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.paged import PagedLeaf, leaf_kind, token_to_pool
from repro_torch.common.quant import quantize_rows
from repro_torch.common.types import ModelConfig
from repro_torch.core.track import pt_cache_shape
from repro_torch.models.decoder import layer_cache, map_layers, model_dtype
from repro_torch.runtime.parallel import NO_PARALLEL, Parallelism


def _leaves(tree: Any) -> List[Tuple[Any, int]]:
    """(leaf, batch axis) of every leaf of an engine or prefill cache
    tree, in order.  A PT tree {'blocks': (k, v)} has leaves [R, D, n,
    B, ...] (batch axis 3); an ``lm_*`` tree {'prefix', 'unit', 'suffix'}
    has leaves [B, ...], the unit's stacked [R, B, ...] (batch axis 1).
    A pool (``PagedLeaf``) counts as one leaf, its block axis in place of
    the batch axis."""
    if "blocks" in tree:
        return [(leaf, 3) for leaf in tree["blocks"]]
    out = []

    def walk(node, axis):
        if isinstance(node, tuple):
            for v in node:
                walk(v, axis)
        else:
            out.append((node, axis))

    for group in ("prefix", "unit", "suffix"):
        walk(tree[group], 1 if group == "unit" else 0)
    return out


def _padded(s: torch.Tensor, d: torch.Tensor, ax: int) -> torch.Tensor:
    """``s`` zero-padded past its batch axis ``ax`` to ``d``'s shape: a
    bucketed prefill covers positions [0, bucket) of [0, capacity), and a
    short cache padded to a ring of W rows is in ring order for every
    position < W, as the reference pads."""
    if s.shape[ax + 1:] == d.shape[ax + 1:]:
        return s
    full = s.new_zeros(s.shape[:ax + 1] + d.shape[ax + 1:])
    full[tuple(slice(0, k) for k in s.shape)] = s
    return full


def insert_rows(dst: Any, src: Any, slots: Sequence[int]) -> None:
    """Write the rows of a prefill cache ``src`` (``len(slots)`` rows on
    each leaf's batch axis) into rows ``slots`` of the contiguous engine
    cache ``dst``, in place, one ``index_copy_`` per leaf (the
    reference's ``insert_rows``), each zero-padded first (``_padded``)."""
    idx = None
    for (d, ax), (s, _) in zip(_leaves(dst), _leaves(src)):
        if idx is None:
            idx = torch.as_tensor(list(slots), dtype=torch.long,
                                  device=d.device)
        d.index_copy_(ax, idx, _padded(s, d, ax).to(d.dtype))


def _pad_seq(x: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """x zero-padded along ``axis`` to ``new_len`` (x itself when it is
    as long already)."""
    cur = x.shape[axis]
    if cur >= new_len:
        return x
    shape = list(x.shape)
    shape[axis] = new_len
    out = x.new_zeros(shape)
    out.narrow(axis, 0, cur).copy_(x)
    return out


def _pad_layer(cache: Any, spec, new_len: int) -> Any:
    """One layer's prefill cache (possibly [R]-stacked) padded to
    ``new_len`` positions: GQA K/V along their sequence axis (a window's
    to at most W rows; a ring already W rows long stays as it is), a
    cross-attending layer's own K/V only (the encoder's keep their
    rows), MLA latents along theirs; recurrent state rows unchanged."""
    if spec.mixer == "gqa":
        (k, v), enc = cache if spec.cross_attn else (cache, None)
        if spec.window is not None and k.shape[-3] >= spec.window:
            out = (k, v)                       # a ring: fixed size
        else:
            tgt = new_len if spec.window is None else min(new_len,
                                                          spec.window)
            out = (_pad_seq(k, -3, tgt), _pad_seq(v, -3, tgt))
        return (out, enc) if spec.cross_attn else out
    if spec.mixer == "mla":
        return tuple(_pad_seq(t, -2, new_len) for t in cache)
    return cache


def pad_cache(cache: Dict[str, Any], cfg: ModelConfig,
              new_len: int) -> Dict[str, Any]:
    """An ``lm_*`` prefill cache {"prefix", "unit", "suffix"} padded out
    to capacity ``new_len`` (the reference's ``pad_cache``): the
    contiguous cache that ``lm_decode_step`` / ``lm_chunk_step`` then
    write in place."""
    groups = {"prefix": cfg.pattern_prefix, "unit": cfg.pattern_unit,
              "suffix": cfg.pattern_suffix}
    return {g: tuple(_pad_layer(c, cfg.spec(nm), new_len)
                     for c, nm in zip(cache[g], names))
            for g, names in groups.items()}


_HASH_ROOT = b"pkv-root"           # chain-hash seed for position-0 blocks


def _chain_hash(parent: bytes, tokens: Sequence[int]) -> bytes:
    """Content-addressed chain hash of one full block: sha256 over the
    parent block's digest and the block's token ids as int64, so two
    prompts share a block only when they share the whole prefix."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PagedKVCache:
    """vLLM-style block pool with host-side block accounting, per-block
    reference counts, a content-addressed prefix cache and copy-on-write
    forking (the reference's ``PagedKVCache``, op for op).

      can_allocate(n, tokens=None) -> enough free blocks (prefix-aware)?
      allocate(slot, n, tokens=None) -> reserve blocks for [0, n); with
          ``tokens`` share the longest cached prefix, return its length
      append(slot, n)      -> grow the slot's allocation to [0, n)
      fork(src, dst)       -> dst shares src's committed blocks
      ensure_writable(slot, lo, hi) -> copy-on-write pairs [(src, dst)]
          to copy (``copy_blocks``) before writing positions [lo, hi)
      commit_tokens(slot, tokens) -> register newly full blocks
      match_prefix(tokens) -> (matched tokens, block ids), a peek
      free_slot(slot)      -> refcounts down; table row -> trash
      table() / table_rows(slots) -> device block-table views
      insert_prefill(src, slots, table_rows) -> a prefill cache's rows in
      copy_blocks(pairs) / copy_rows(src, dsts) -> pool blocks / ring
          and state rows copied on the device
      reset_slots(slots)   -> zero the ring and state rows of ``slots``
      utilization()        -> occupancy and prefix-cache counters
      check_invariants()   -> raise unless block accounting is consistent

    With ``fault_plan`` (``faults.FaultPlan``) ``allocate``, ``append``,
    ``fork`` and ``ensure_writable`` may raise an injected MemoryError
    before they change anything, at the reference's sites.
    """

    def __init__(self, cfg: ModelConfig, *, max_slots: int, max_seq_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 kv_dtype: Optional[str] = None, device: DeviceLike = None,
                 par: Parallelism = NO_PARALLEL, fault_plan: Any = None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(None or 'int8')")
        self.kv_dtype = kv_dtype
        self.faults = fault_plan        # a ``faults.FaultPlan``, or None
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.blocks_per_seq = -(-max_seq_len // block_size)
        if num_blocks is None:          # same capacity as contiguous
            num_blocks = max_slots * self.blocks_per_seq
        self.num_blocks = num_blocks + 1            # +1: trash block 0
        pools: List[torch.Tensor] = []
        scales: List[torch.Tensor] = []
        pool_dtype = torch.int8 if kv_dtype == "int8" else None

        def paged(kv: Tuple[torch.Tensor, torch.Tensor]):
            leaves = []
            for pool in kv:
                pools.append(pool)
                scale = None
                if kv_dtype == "int8":
                    scale = torch.zeros(pool.shape[:-1] + (1,),
                                        dtype=torch.float32,
                                        device=self.device)
                    scales.append(scale)
                leaves.append(PagedLeaf(pool, scale))
            return tuple(leaves)

        if cfg.pt is not None:
            shape = pt_cache_shape(cfg, self.num_blocks, block_size, par)
            dtype = pool_dtype or model_dtype(cfg)
            self.tree: Dict[str, Any] = {
                "blocks": paged(tuple(torch.zeros(shape, dtype=dtype,
                                                  device=self.device)
                                      for _ in range(2))),
                "tail": ()}
        else:
            if par.sharded:
                raise ValueError(f"{cfg.name} has no tracks to place on "
                                 "ranks")

            def entry(nm, lead):
                if leaf_kind(cfg.spec(nm), max_seq_len) == "paged":
                    return paged(layer_cache(cfg, nm, lead, self.num_blocks,
                                             block_size, self.device,
                                             kv_dtype=pool_dtype, pool=True))
                return layer_cache(cfg, nm, lead, max_slots, max_seq_len,
                                   self.device)

            self.tree = map_layers(cfg, entry)
        # the layout kind of every leaf, in the order of _leaves(tree)
        self._kinds: List[str] = (
            ["paged"] * 2 if cfg.pt is not None else
            [k for k, _ in _leaves(map_layers(cfg, lambda nm, lead: (
                leaf_kind(cfg.spec(nm), max_seq_len),) * 2))])
        if kv_dtype == "int8" and not pools:
            raise ValueError("int8 KV needs pageable leaves; this config "
                             "has none")
        self.data: Tuple[torch.Tensor, ...] = tuple(pools)
        self.scales: Optional[Tuple[torch.Tensor, ...]] = (
            tuple(scales) if scales else None)

        # a ring or state row belongs to its slot, not to a prefix: the
        # prefix cache needs every leaf to be a pool leaf
        self.prefix_cache = prefix_cache and self.all_pageable
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self._tokens: List[int] = [0] * max_slots
        self._ref: List[int] = [0] * self.num_blocks
        # the prefix cache: chain hash <-> block id, and the LRU of
        # refcount-zero blocks whose contents are still valid
        self._hash_to_block: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # per slot: tokens whose K/V is known written, and the chain
        # digests of the slot's full committed blocks
        self._committed: List[int] = [0] * max_slots
        self._chain: List[List[bytes]] = [[] for _ in range(max_slots)]
        self.prefix_queries = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.cow_copies = 0
        self.table_np = np.zeros((max_slots, self.blocks_per_seq), np.int32)
        self.version = 0          # bumped on every table change, so device
                                  # copies of the table can be cached

    # -- block accounting ----------------------------------------------
    def _maybe_inject_alloc(self) -> None:
        """The fault hook at the top of every allocating op (``allocate``,
        ``append``, ``fork``, ``ensure_writable``), before any accounting
        changes, as in the reference: an injected failure leaves the
        cache exactly as a real out-of-blocks MemoryError does."""
        if self.faults is not None and self.faults.take_alloc():
            raise MemoryError(
                "paged KV cache: injected allocation failure "
                f"(op {self.faults.alloc_calls - 1})")

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        """Blocks a fresh allocation can take: the plain free list and
        the refcount-zero cached blocks (evicted under pressure)."""
        return len(self._free) + len(self._cached_free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def committed(self, slot: int) -> int:
        """Tokens of ``slot`` whose K/V is known written (the prompt
        after its prefill, every emitted token but the last)."""
        return self._committed[slot]

    def fork_cost(self, src: int) -> int:
        """Fresh blocks one fork of ``src`` takes: those past its
        committed prefix (the rest is shared)."""
        n_share = min(self.blocks_for(self._committed[src]),
                      len(self._blocks[src]))
        return len(self._blocks[src]) - n_share

    def _take_block(self) -> int:
        """One block for a fresh allocation: the plain free list first;
        under pressure the least recently freed cached block, whose hash
        entry is dropped (its bytes are about to be overwritten)."""
        if self._free:
            return self._free.pop()
        if self._cached_free:
            b, _ = self._cached_free.popitem(last=False)
            self._uncache(b)
            return b
        raise MemoryError(
            f"paged KV cache out of blocks: free 0/{self.num_blocks - 1}")

    def _uncache(self, block: int) -> None:
        h = self._hash_of.pop(block, None)
        if h is not None and self._hash_to_block.get(h) == block:
            del self._hash_to_block[h]

    def _share(self, block: int) -> None:
        """One more reference; a cached block at zero leaves the LRU."""
        if self._ref[block] == 0:
            self._cached_free.pop(block, None)
        self._ref[block] += 1

    def _release(self, block: int) -> None:
        """One reference less; at zero the block goes to the LRU's most
        recent end if its hash entry still holds, else to the free
        list."""
        self._ref[block] -= 1
        if self._ref[block] < 0:
            raise AssertionError(f"refcount underflow on {block}")
        if self._ref[block] == 0:
            if block in self._hash_of:
                self._cached_free[block] = None
            else:
                self._free.append(block)

    # -- the prefix cache -----------------------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached block-aligned prefix of ``tokens`` (a peek: no
        refcount moves).  At least one token is left unmatched, so that
        the first token's logits have a position to come from."""
        bs = self.block_size
        blocks: List[int] = []
        if not self.prefix_cache or len(tokens) <= 1:
            return 0, blocks
        parent = _HASH_ROOT
        for k in range((len(tokens) - 1) // bs):
            parent = _chain_hash(parent, tokens[k * bs:(k + 1) * bs])
            b = self._hash_to_block.get(parent)
            if b is None:
                break
            blocks.append(b)
        return len(blocks) * bs, blocks

    def commit_tokens(self, slot: int, tokens: Sequence[int]) -> None:
        """Positions [0, len(tokens)) of ``slot`` hold the K/V of these
        token ids: register every newly full block (the first writer
        wins: a digest already mapped, or a block already hashed, is not
        registered again).  Only positions written and never rewritten
        are committed."""
        self._committed[slot] = max(self._committed[slot], len(tokens))
        if not self.prefix_cache:
            return
        bs = self.block_size
        chain = self._chain[slot]
        n_full = min(len(tokens) // bs, len(self._blocks[slot]))
        for k in range(len(chain), n_full):
            parent = chain[-1] if chain else _HASH_ROOT
            h = _chain_hash(parent, tokens[k * bs:(k + 1) * bs])
            chain.append(h)
            b = self._blocks[slot][k]
            if h not in self._hash_to_block and b not in self._hash_of:
                self._hash_to_block[h] = b
                self._hash_of[b] = h

    # -- allocation -----------------------------------------------------
    def can_allocate(self, n_tokens: int,
                     tokens: Optional[Sequence[int]] = None) -> bool:
        """Enough free blocks for ``n_tokens``?  With ``tokens``, matched
        blocks still referenced cost nothing; a matched block at
        refcount zero is counted inside ``free_blocks`` already."""
        need = self.blocks_for(n_tokens)
        if tokens is not None:
            _, blocks = self.match_prefix(tokens)
            need -= sum(1 for b in blocks if self._ref[b] > 0)
        return need <= self.free_blocks

    def allocate(self, slot: int, n_tokens: int,
                 tokens: Optional[Sequence[int]] = None) -> int:
        """Reserve blocks for positions [0, n_tokens) of ``slot``.  With
        ``tokens`` (the prompt's ids) the longest cached prefix is shared
        (refcounts up, no compute) and only the tail takes fresh blocks.
        Returns the number of prefix tokens served from the cache."""
        if self._blocks[slot]:
            raise ValueError(f"slot {slot} already allocated")
        self._maybe_inject_alloc()
        matched, mblocks = (self.match_prefix(tokens)
                            if tokens is not None else (0, []))
        if tokens is not None and self.prefix_cache:
            self.prefix_queries += 1
            self.prefix_lookup_tokens += len(tokens)
            self.prefix_hit_tokens += matched
        fresh = self.blocks_for(n_tokens) - len(mblocks)
        avail = (self.free_blocks
                 - sum(1 for b in mblocks if self._ref[b] == 0))
        if fresh > avail:
            raise MemoryError(
                f"paged KV cache out of blocks: need {fresh}, "
                f"free {avail}/{self.num_blocks - 1}")
        for k, b in enumerate(mblocks):
            self._share(b)
            self.table_np[slot, k] = b
            self._blocks[slot].append(b)
        self._chain[slot] = [self._hash_of[b] for b in mblocks]
        self._committed[slot] = matched
        if mblocks:
            self.version += 1
        self.append(slot, n_tokens)
        return matched

    def append(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s allocation to cover positions [0, n_tokens)
        with fresh blocks of its own."""
        if n_tokens > self.max_seq_len:
            raise ValueError(f"{n_tokens} tokens exceed capacity "
                             f"{self.max_seq_len}")
        need = self.blocks_for(n_tokens) - len(self._blocks[slot])
        if need > 0:
            self._maybe_inject_alloc()
        if need > self.free_blocks:
            raise MemoryError(
                f"paged KV cache out of blocks: need {need}, "
                f"free {self.free_blocks}/{self.num_blocks - 1}")
        for _ in range(max(0, need)):
            b = self._take_block()
            self._ref[b] = 1
            self.table_np[slot, len(self._blocks[slot])] = b
            self._blocks[slot].append(b)
        if need > 0:
            self.version += 1
        self._tokens[slot] = max(self._tokens[slot], n_tokens)

    # -- forking and copy-on-write --------------------------------------
    def fork(self, src: int, dst: int) -> None:
        """Point ``dst``'s table at ``src``'s blocks of the committed
        prefix (refcounts up, the trailing partial block included: the
        first divergent write copies it) and take fresh blocks for the
        rest of the reservation.  ``dst`` inherits the committed chain."""
        if self._blocks[dst]:
            raise ValueError(f"fork target slot {dst} already allocated")
        if not self._blocks[src]:
            raise ValueError(f"fork source slot {src} has no allocation")
        self._maybe_inject_alloc()
        n_share = min(self.blocks_for(self._committed[src]),
                      len(self._blocks[src]))
        n_fresh = len(self._blocks[src]) - n_share
        if n_fresh > self.free_blocks:
            raise MemoryError(
                f"paged KV cache out of blocks for fork: need {n_fresh}, "
                f"free {self.free_blocks}/{self.num_blocks - 1}")
        for k in range(n_share):
            b = self._blocks[src][k]
            self._share(b)
            self.table_np[dst, k] = b
            self._blocks[dst].append(b)
        for k in range(n_share, len(self._blocks[src])):
            b = self._take_block()
            self._ref[b] = 1
            self.table_np[dst, k] = b
            self._blocks[dst].append(b)
        self._tokens[dst] = self._tokens[src]
        self._committed[dst] = self._committed[src]
        self._chain[dst] = list(self._chain[src])
        self.version += 1

    def ensure_writable(self, slot: int, lo: int,
                        hi: int) -> List[Tuple[int, int]]:
        """Before ``slot`` writes positions [lo, hi): every touched block
        it shares (refcount > 1) is swapped for a fresh one in its table.
        Returns the (src, dst) pairs the caller copies on the device
        (``copy_blocks``) before the writes; positions past the
        allocation fall through to the trash block.  All or nothing: the
        demand is checked before any table changes, so a MemoryError
        leaves the cache as it was."""
        pairs: List[Tuple[int, int]] = []
        if hi <= lo:
            return pairs
        bs = self.block_size
        last = min((hi - 1) // bs, len(self._blocks[slot]) - 1)
        shared = [k for k in range(lo // bs, last + 1)
                  if self._ref[self._blocks[slot][k]] > 1]
        if not shared:
            return pairs
        self._maybe_inject_alloc()
        if len(shared) > self.free_blocks:
            raise MemoryError(
                f"paged KV cache out of blocks for copy-on-write: need "
                f"{len(shared)}, free {self.free_blocks}"
                f"/{self.num_blocks - 1}")
        for k in shared:
            b = self._blocks[slot][k]
            nb = self._take_block()
            self._ref[nb] = 1
            self._release(b)
            self._blocks[slot][k] = nb
            self.table_np[slot, k] = nb
            pairs.append((b, nb))
        self.cow_copies += len(pairs)
        self.version += 1
        return pairs

    def free_slot(self, slot: int) -> None:
        """Drop ``slot``'s references (a block returns to the pool at
        refcount zero: to the LRU when its contents are hashed) and point
        its table row at the trash block."""
        for b in reversed(self._blocks[slot]):
            self._release(b)
        self._blocks[slot] = []
        self._tokens[slot] = 0
        self._committed[slot] = 0
        self._chain[slot] = []
        self.table_np[slot, :] = 0
        self.version += 1

    # -- consistency ----------------------------------------------------
    def check_invariants(self) -> None:
        """Every non-trash block is in exactly one of referenced,
        cached-free and free; refcounts equal table occurrences; the
        table mirror matches the block lists; the hash index is a
        bijection onto live or cached blocks."""
        N = self.num_blocks
        occurrences = [0] * N
        for slot, blks in enumerate(self._blocks):
            assert 0 not in blks, f"slot {slot} references the trash block"
            row = self.table_np[slot]
            assert list(row[:len(blks)]) == blks, \
                f"table row {slot} disagrees with block list"
            assert not row[len(blks):].any(), \
                f"table row {slot} has stale entries past the allocation"
            for b in blks:
                occurrences[b] += 1
        assert self._ref[0] == 0 and 0 not in self._cached_free \
            and 0 not in self._free, "trash block left the reserve"
        free_set, cached_set = set(self._free), set(self._cached_free)
        assert len(free_set) == len(self._free), "block freed twice"
        assert not (free_set & cached_set), "block free and cached-free"
        for b in range(1, N):
            assert self._ref[b] == occurrences[b], \
                f"block {b}: ref {self._ref[b]} != occurrences {occurrences[b]}"
            states = ((self._ref[b] > 0) + (b in free_set)
                      + (b in cached_set))
            assert states == 1, f"block {b} in {states} states"
        for b, h in self._hash_of.items():
            assert self._ref[b] > 0 or b in cached_set, \
                f"hash entry for dead block {b}"
            assert self._hash_to_block.get(h) == b, \
                f"hash index not bijective at block {b}"
        assert len(self._hash_to_block) == len(self._hash_of)
        for slot, blks in enumerate(self._blocks):
            assert self._tokens[slot] <= len(blks) * self.block_size
            assert len(self._chain[slot]) <= len(blks)

    # -- layouts ----------------------------------------------------------
    def _row_leaves(self) -> List[Tuple[torch.Tensor, int]]:
        """(leaf, batch axis) of every ring and state leaf."""
        return [(leaf, ax) for leaf, ax in _leaves(self.tree)
                if not isinstance(leaf, PagedLeaf)]

    def leaf_kinds(self) -> Dict[str, int]:
        """Histogram of leaf layouts, e.g. {'paged': 2}, {'state': 2} or
        {'ring': 18, 'paged': 2}: one count per leaf of the tree, a K or
        V leaf of the unit (stacked over its R repeats) counted once, as
        the reference counts."""
        kinds: Dict[str, int] = {}
        for k in self._kinds:
            kinds[k] = kinds.get(k, 0) + 1
        return kinds

    @property
    def any_pageable(self) -> bool:
        return bool(self.data)

    @property
    def all_pageable(self) -> bool:
        """True when every leaf is a block-pool leaf (no ring or state
        rows)."""
        return set(self.leaf_kinds()) <= {"paged"}

    def engine_cache(self) -> Any:
        """The cache tree the model functions take: a PT model's
        ``{'blocks': (PagedLeaf k, PagedLeaf v), 'tail': ()}``, or the
        ``lm_*`` tree with (PagedLeaf k, PagedLeaf v) for each paged GQA
        layer, ring rows (k, v) for each ring layer and state rows for
        each Mamba layer (updated in place)."""
        return self.tree

    # -- row writes -----------------------------------------------------
    def insert_prefill(self, src: Any, slots: Sequence[int],
                       table_rows: torch.Tensor) -> None:
        """Write a prefill cache of ``len(slots)`` rows into the engine
        cache, as ``paged_insert_rows`` does: pool leaves take rows
        [0, bucket) of each request through its block-table row, one
        indexed write per pool (padded rows past the allocation resolve
        to the trash block; int8 pools take each row quantized, payload
        and scale); ring and state leaves take each request's row at its
        slot (``index_copy_``), a ring's zero-padded to its W rows when
        the bucket is shorter (``_padded``)."""
        n, bs = len(slots), self.block_size
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.device)
        rows_at: Dict[int, torch.Tensor] = {}     # bucket -> pool rows
        for (dst, ax), (rows, _) in zip(_leaves(self.tree), _leaves(src)):
            if not isinstance(dst, PagedLeaf):
                dst.index_copy_(ax, idx, _padded(rows, dst, ax).to(dst.dtype))
                continue
            bucket = rows.shape[ax + 1]
            if bucket not in rows_at:
                pos = torch.arange(bucket, device=self.device).expand(
                    n, bucket)
                rows_at[bucket] = token_to_pool(table_rows, pos,
                                                bs).reshape(-1)
            at = (slice(None),) * ax + (rows_at[bucket],)
            rows = rows.reshape(*rows.shape[:ax], n * bucket,
                                *rows.shape[ax + 2:])
            parts = ((dst.pool, rows),) if dst.scale is None else tuple(
                zip((dst.pool, dst.scale), quantize_rows(rows.float())))
            for pool, r in parts:
                flat = pool.view(*pool.shape[:ax], -1, *pool.shape[ax + 2:])
                flat[at] = r.to(pool.dtype)

    def reset_slots(self, slots: Sequence[int]) -> None:
        """Zero the ring and state rows of ``slots``: a chunked admission
        appends to its rows, so the previous tenant's state must not seed
        it (a ring's stale rows are masked anyway).  Pool leaves need
        nothing: the block table isolates them."""
        state = self._row_leaves()
        if not state or not slots:
            return
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.device)
        for leaf, axis in state:
            leaf.index_fill_(axis, idx, 0)

    def copy_blocks(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """The device half of ``ensure_writable``: pool[dst] = pool[src]
        for every pair, in every pool and its int8 scale pool (the scale
        rows move with their payloads, or a copy would dequantize under
        the wrong scales).  Every source block is gathered before any
        write, so one block can fan out to many copies in one call."""
        if not pairs or not self.data:
            return
        src = torch.as_tensor([p[0] for p in pairs], dtype=torch.long,
                              device=self.device)
        dst = torch.as_tensor([p[1] for p in pairs], dtype=torch.long,
                              device=self.device)
        for leaf, ax in _leaves(self.tree):
            if not isinstance(leaf, PagedLeaf):
                continue
            for t in (leaf.pool, leaf.scale):
                if t is not None:
                    t.index_copy_(ax, dst, t.index_select(ax, src))

    def copy_rows(self, src: int, dsts: Sequence[int]) -> None:
        """Copy the ring and state rows of slot ``src`` into slots
        ``dsts`` (a fork: the block table shares pool leaves only)."""
        state = self._row_leaves()
        if not state or not dsts:
            return
        idx = torch.as_tensor(list(dsts), dtype=torch.long,
                              device=self.device)
        at = torch.full((len(dsts),), src, dtype=torch.long,
                        device=self.device)
        for leaf, axis in state:
            leaf.index_copy_(axis, idx, leaf.index_select(axis, at))

    # -- device views ---------------------------------------------------
    def table(self) -> torch.Tensor:
        return torch.as_tensor(self.table_np).to(self.device)

    def table_rows(self, slots: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(self.table_np[list(slots)]).to(self.device)

    # -- stats ----------------------------------------------------------
    def pool_bytes(self) -> int:
        """Device bytes of the pools, int8 payloads and their fp32 scale
        pools both (0 when every leaf is a state row)."""
        return sum(t.numel() * t.element_size()
                   for t in self.data + (self.scales or ()))

    def state_bytes(self) -> int:
        """Device bytes of the per-slot ring and state rows."""
        return sum(t.numel() * t.element_size()
                   for t, _ in self._row_leaves())

    def bytes_per_block(self) -> int:
        return self.pool_bytes() // self.num_blocks

    def utilization(self) -> Dict[str, Any]:
        used = sum(1 for r in self._ref[1:] if r > 0)
        tokens = sum(self._tokens)
        bpb = self.bytes_per_block()
        return {
            "num_blocks": self.num_blocks - 1,
            "leaf_kinds": self.leaf_kinds(),
            "used_blocks": used,
            "block_utilization": used / max(1, self.num_blocks - 1),
            "tokens_stored": tokens,
            "token_utilization": (tokens / (used * self.block_size)
                                  if used else 0.0),
            "kv_dtype": self.kv_dtype or "float32",
            "pool_bytes": self.pool_bytes(),
            "bytes_per_block": bpb,
            "used_bytes": used * bpb,
            "cached_free_blocks": len(self._cached_free),
            "prefix_queries": self.prefix_queries,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "cow_copies": self.cow_copies,
        }
