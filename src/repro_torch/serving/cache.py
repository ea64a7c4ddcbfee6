"""The serving caches (counterpart of ``repro.serving.cache``): the
block-pool ``PagedKVCache`` with its block accounting, and the row
insert of the contiguous cache, ``insert_rows``.

Every leaf of a paged engine cache is one of two layouts (the reference
classifies them by probing; the port knows them from the config):

  * 'paged' — a GQA layer's K and V pools, laid out as the reference
    lays them out: the dense cache's batch axis becomes the block axis,
    its sequence axis the in-block offset.  A PT model's pools are
    ``[R, D, n_tracks, num_blocks, block_size, KH, hd]`` (on a track
    rank, ``runtime.parallel``, its n_tracks / W tracks); an ``lm_*``
    model's are ``[num_blocks, block_size, KH, hd]`` per prefix / suffix
    layer and ``[R, num_blocks, block_size, KH, hd]`` per unit layer.
    All layers share one block table, so a slot costs ``ceil(tokens /
    block_size)`` blocks.  Block 0 is the trash block: table entries of
    unallocated regions and released slots point at it, so stray writes
    (padded prefill rows, idle decode lanes) never reach a block another
    request owns.
  * 'state' — the per-slot rows of a recurrent layer (Mamba: the conv
    window and h), ``max_slots`` rows as the ``lm_*`` decoder's
    ``init_cache`` lays them out; a row belongs to whichever request
    holds the slot.

A config may have no pageable leaf at all (falcon-mamba: every leaf a
state row).  The block table still exists and admission and reclamation
still meter blocks, which are then virtual: no pools, ``pool_bytes() ==
0``, and scheduling works the same for every architecture.

With ``kv_dtype="int8"`` the pools hold int8 payloads and ``scales``
holds one fp32 scale pool per pool, shaped like it with the last axis
collapsed to 1 (one scale per token per KV head, so a decode write
touches one row's scale and never re-quantizes a block); ``pool_bytes``
counts both.

The contiguous cache is the model's own ``init_cache`` tree at
``max_slots`` rows of ``max_seq_len`` positions, with no block
accounting; ``insert_rows`` writes a prefill cache into it.

Not ported yet: the content-addressed prefix cache, ``fork`` and
copy-on-write (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.paged import PagedLeaf, token_to_pool
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


def insert_rows(dst: Any, src: Any, slots: Sequence[int]) -> None:
    """Write the rows of a prefill cache ``src`` (``len(slots)`` rows on
    each leaf's batch axis) into rows ``slots`` of the contiguous engine
    cache ``dst``, in place, one ``index_copy_`` per leaf (the
    reference's ``insert_rows``).  A leaf of ``src`` shorter than ``dst``
    past its batch axis (a bucketed prefill covers positions [0, bucket)
    of [0, capacity)) is zero-padded first, as the reference pads."""
    idx = None
    for (d, ax), (s, _) in zip(_leaves(dst), _leaves(src)):
        if idx is None:
            idx = torch.as_tensor(list(slots), dtype=torch.long,
                                  device=d.device)
        if s.shape[ax + 1:] != d.shape[ax + 1:]:
            full = s.new_zeros(s.shape[:ax + 1] + d.shape[ax + 1:])
            full[tuple(slice(0, k) for k in s.shape)] = s
            s = full
        d.index_copy_(ax, idx, s.to(d.dtype))


class PagedKVCache:
    """vLLM-style block pool with host-side block accounting.

      can_allocate(n)      -> enough free blocks for n tokens?
      allocate(slot, n)    -> reserve blocks for positions [0, n)
      append(slot, n)      -> grow the slot's allocation to [0, n)
      free_slot(slot)      -> blocks back to the pool; table row -> trash
      table() / table_rows(slots) -> device block-table views
      insert_prefill(src, slots, table_rows) -> a prefill cache's rows in
      reset_slots(slots)   -> zero the state rows of ``slots``
      check_invariants()   -> raise unless block accounting is consistent
    """

    def __init__(self, cfg: ModelConfig, *, max_slots: int, max_seq_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None, device: DeviceLike = None,
                 par: Parallelism = NO_PARALLEL):
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported "
                                      "(ROADMAP queue 1, item 5)")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(None or 'int8')")
        self.kv_dtype = kv_dtype
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
                if cfg.spec(nm).mixer == "gqa":
                    return paged(layer_cache(cfg, nm, lead, self.num_blocks,
                                             block_size, self.device,
                                             kv_dtype=pool_dtype))
                return layer_cache(cfg, nm, lead, max_slots, max_seq_len,
                                   self.device)

            self.tree = map_layers(cfg, entry)
        if kv_dtype == "int8" and not pools:
            raise ValueError("int8 KV needs pageable leaves; this config "
                             "has none")
        self.data: Tuple[torch.Tensor, ...] = tuple(pools)
        self.scales: Optional[Tuple[torch.Tensor, ...]] = (
            tuple(scales) if scales else None)

        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self._tokens: List[int] = [0] * max_slots
        self._ref: List[int] = [0] * self.num_blocks
        self.table_np = np.zeros((max_slots, self.blocks_per_seq), np.int32)
        self.version = 0          # bumped on every table change, so device
                                  # copies of the table can be cached

    # -- block accounting ----------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.free_blocks

    def allocate(self, slot: int, n_tokens: int) -> None:
        """Reserve blocks for positions [0, n_tokens) of ``slot``."""
        if self._blocks[slot]:
            raise ValueError(f"slot {slot} already allocated")
        self.append(slot, n_tokens)

    def append(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s allocation to cover positions [0, n_tokens)."""
        if n_tokens > self.max_seq_len:
            raise ValueError(f"{n_tokens} tokens exceed capacity "
                             f"{self.max_seq_len}")
        need = self.blocks_for(n_tokens) - len(self._blocks[slot])
        if need > self.free_blocks:
            raise MemoryError(
                f"paged KV cache out of blocks: need {need}, "
                f"free {self.free_blocks}/{self.num_blocks - 1}")
        for _ in range(max(0, need)):
            b = self._free.pop()
            self._ref[b] = 1
            self.table_np[slot, len(self._blocks[slot])] = b
            self._blocks[slot].append(b)
        if need > 0:
            self.version += 1
        self._tokens[slot] = max(self._tokens[slot], n_tokens)

    def free_slot(self, slot: int) -> None:
        """Return ``slot``'s blocks to the pool and point its table row at
        the trash block."""
        for b in reversed(self._blocks[slot]):
            self._ref[b] -= 1
            if self._ref[b] < 0:
                raise AssertionError(f"refcount underflow on {b}")
            if self._ref[b] == 0:
                self._free.append(b)
        self._blocks[slot] = []
        self._tokens[slot] = 0
        self.table_np[slot, :] = 0
        self.version += 1

    # -- consistency ----------------------------------------------------
    def check_invariants(self) -> None:
        """Every non-trash block is either referenced or free (never
        both); refcounts equal table occurrences; the table mirror
        matches the block lists."""
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
        assert self._ref[0] == 0 and 0 not in self._free, \
            "trash block left the reserve"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "block freed twice"
        for b in range(1, N):
            assert self._ref[b] == occurrences[b], \
                f"block {b}: ref {self._ref[b]} != occurrences {occurrences[b]}"
            assert (self._ref[b] > 0) + (b in free_set) == 1, \
                f"block {b} is neither referenced nor free, or both"
        for slot, blks in enumerate(self._blocks):
            assert self._tokens[slot] <= len(blks) * self.block_size

    # -- layouts ----------------------------------------------------------
    def _state_leaves(self) -> List[Tuple[torch.Tensor, int]]:
        return [(leaf, ax) for leaf, ax in _leaves(self.tree)
                if not isinstance(leaf, PagedLeaf)]

    def leaf_kinds(self) -> Dict[str, int]:
        """Histogram of leaf layouts, e.g. {'paged': 2} or {'state': 2}."""
        kinds = {}
        if self.data:
            kinds["paged"] = len(self.data)
        if self._state_leaves():
            kinds["state"] = len(self._state_leaves())
        return kinds

    @property
    def any_pageable(self) -> bool:
        return bool(self.data)

    @property
    def all_pageable(self) -> bool:
        """True when every leaf is a block-pool leaf (no state rows)."""
        return "state" not in self.leaf_kinds()

    def engine_cache(self) -> Any:
        """The cache tree the model functions take: a PT model's
        ``{'blocks': (PagedLeaf k, PagedLeaf v), 'tail': ()}``, or the
        ``lm_*`` tree with (PagedLeaf k, PagedLeaf v) for each GQA layer
        and state rows for each Mamba layer (updated in place)."""
        return self.tree

    # -- row writes -----------------------------------------------------
    def insert_prefill(self, src: Any, slots: Sequence[int],
                       table_rows: torch.Tensor) -> None:
        """Write a prefill cache of ``len(slots)`` rows into the engine
        cache, as ``paged_insert_rows`` does: pool leaves take rows
        [0, bucket) of each request through its block-table row, one
        indexed write per pool (padded rows past the allocation resolve
        to the trash block; int8 pools take each row quantized, payload
        and scale); state leaves take each request's row at its slot
        (``index_copy_``)."""
        n, bs = len(slots), self.block_size
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.device)
        rows_at: Dict[int, torch.Tensor] = {}     # bucket -> pool rows
        for (dst, ax), (rows, _) in zip(_leaves(self.tree), _leaves(src)):
            if not isinstance(dst, PagedLeaf):
                dst.index_copy_(ax, idx, rows.to(dst.dtype))
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
        """Zero the state rows of ``slots``: a chunked admission appends to
        its rows, so the previous tenant's state must not seed it.  Pool
        leaves need nothing: the block table isolates them."""
        state = self._state_leaves()
        if not state or not slots:
            return
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.device)
        for leaf, axis in state:
            leaf.index_fill_(axis, idx, 0)

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
        """Device bytes of the per-slot state rows."""
        return sum(t.numel() * t.element_size()
                   for t, _ in self._state_leaves())

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
        }
