"""Paged KV-cache leaf marker and block-table address arithmetic
(counterpart of ``repro.common.paged``).

A paged engine cache replaces every full-length K/V leaf with a block
pool ``[..., num_blocks, block_size, KH, hd]`` shared by all slots and
indexed through a per-slot block table.  Block 0 is the trash block:
unallocated table entries point at it.  An int8 pool carries its fp32
per-token-per-head scale pool beside it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


class PagedLeaf:
    """Marks a cache leaf as a block pool (block axis where the dense
    layout has batch, block-size axis where it has sequence).

    An int8 pool also carries ``scale``: its fp32 per-token-per-head
    scale pool, shaped like ``pool`` with the last axis collapsed to 1,
    written and read through the same indices as the payload."""

    def __init__(self, pool: torch.Tensor,
                 scale: Optional[torch.Tensor] = None):
        self.pool = pool
        self.scale = scale

    def __getitem__(self, idx) -> "PagedLeaf":
        """Index the leading (layer, track) dims of pool and scale."""
        return PagedLeaf(self.pool[idx],
                         None if self.scale is None else self.scale[idx])

    def __repr__(self) -> str:
        if self.scale is None:
            return f"PagedLeaf({tuple(self.pool.shape)})"
        return (f"PagedLeaf({tuple(self.pool.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def is_paged(leaf: Any) -> bool:
    return isinstance(leaf, PagedLeaf)


def token_to_pool(table_rows: torch.Tensor, positions: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """Map token positions to flat pool row indices through a block table.

    table_rows: [..., max_blocks_per_seq] int32 block ids;
    positions:  [...] int token positions (same leading dims).
    Returns int64 flat indices into a [num_blocks * block_size] row
    space.  Positions past the table width resolve to the trash block 0,
    never to a live block.
    """
    nmax = table_rows.shape[-1]
    bidx = positions.long() // block_size
    blk = torch.gather(table_rows.long(), -1, bidx.clamp(0, nmax - 1))
    blk = torch.where(bidx < nmax, blk, torch.zeros_like(blk))
    return blk * block_size + positions.long() % block_size
