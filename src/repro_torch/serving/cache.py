"""The block-pool paged K/V cache (counterpart of
``repro.serving.cache.PagedKVCache``), block accounting only.

The K and V pools are laid out as the reference lays out a PT model's
pools: ``[R, D, n_tracks, num_blocks, block_size, KH, hd]`` (the dense
cache's batch axis becomes the block axis, its sequence axis the
in-block offset).  All layers share one block table, so a slot costs
``ceil(tokens / block_size)`` blocks.  Block 0 is the trash block:
table entries of unallocated regions and released slots point at it,
so stray writes (padded prefill rows, idle decode lanes) never reach a
block another request owns.

With ``kv_dtype="int8"`` the pools hold int8 payloads and ``scales``
holds one fp32 scale pool per pool, ``[R, D, n, num_blocks, block_size,
KH, 1]`` (one scale per token per KV head, so a decode write touches one
row's scale and never re-quantizes a block); ``pool_bytes`` counts both.

Not ported yet: the content-addressed prefix cache, ``fork`` and
copy-on-write (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.types import ModelConfig
from repro_torch.core.track import pt_cache_shape
from repro_torch.models.decoder import model_dtype


class PagedKVCache:
    """vLLM-style block pool with host-side block accounting.

      can_allocate(n)      -> enough free blocks for n tokens?
      allocate(slot, n)    -> reserve blocks for positions [0, n)
      append(slot, n)      -> grow the slot's allocation to [0, n)
      free_slot(slot)      -> blocks back to the pool; table row -> trash
      table() / table_rows(slots) -> device block-table views
      check_invariants()   -> raise unless block accounting is consistent
    """

    def __init__(self, cfg: ModelConfig, *, max_slots: int, max_seq_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None, device: DeviceLike = None):
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported "
                                      "(ROADMAP queue 1, item 3)")
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
        shape = pt_cache_shape(cfg, self.num_blocks, block_size)
        dtype = torch.int8 if kv_dtype == "int8" else model_dtype(cfg)
        self.data = (torch.zeros(shape, dtype=dtype, device=self.device),
                     torch.zeros(shape, dtype=dtype, device=self.device))
        self.scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if kv_dtype == "int8":
            sshape = shape[:-1] + (1,)
            self.scales = tuple(torch.zeros(sshape, dtype=torch.float32,
                                            device=self.device)
                                for _ in range(2))

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

    # -- device views ---------------------------------------------------
    def table(self) -> torch.Tensor:
        return torch.as_tensor(self.table_np).to(self.device)

    def table_rows(self, slots: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(self.table_np[list(slots)]).to(self.device)

    # -- stats ----------------------------------------------------------
    def pool_bytes(self) -> int:
        """Device bytes of the pools, int8 payloads and their fp32 scale
        pools both."""
        return sum(t.numel() * t.element_size()
                   for t in self.data + (self.scales or ()))

    def bytes_per_block(self) -> int:
        return self.pool_bytes() // self.num_blocks

    def utilization(self) -> Dict[str, Any]:
        used = sum(1 for r in self._ref[1:] if r > 0)
        tokens = sum(self._tokens)
        bpb = self.bytes_per_block()
        return {
            "num_blocks": self.num_blocks - 1,
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
