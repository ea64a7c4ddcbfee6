"""Rotary position embeddings, "half rotation" layout, in fp32: standard
RoPE and Qwen2-VL's M-RoPE (counterpart of ``repro.models.rope``)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] (fp32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> cos, sin [..., head_dim // 2] fp32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., n_heads, head_dim] in fp32; cos/sin broadcast to
    [..., 1, head_dim // 2] (a heads axis is inserted here)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.  positions [3, ...] int: the (temporal,
    height, width) streams; ``sections`` the number of frequency pairs
    each stream takes, in order, summing to head_dim // 2.  Frequency
    slot i takes the stream of its section.  Returns cos, sin
    [..., head_dim // 2] fp32."""
    if sum(sections) != head_dim // 2:
        raise ValueError("mrope sections must sum to head_dim // 2")
    inv = rope_freqs(head_dim, theta, positions.device)
    pos = positions.to(torch.float32)
    # the stream of each slot, section by section: no host-built index
    # (a step program captured in a CUDA graph copies nothing from the host)
    per_slot = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], n)
                          for i, n in enumerate(sections)], dim=-1)
    ang = per_slot * inv
    return torch.cos(ang), torch.sin(ang)


def positions_default(batch: int, seq: int, offset=0,
                      device: Optional[torch.device] = None
                      ) -> torch.Tensor:
    """[B, S] int32 positions starting at offset (int or [B] tensor)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, int):
        return (pos + offset).expand(batch, seq)
    return pos + offset.to(torch.int32)[:, None]


def mrope_positions_default(batch: int, seq: int, offset=0,
                            device: Optional[torch.device] = None
                            ) -> torch.Tensor:
    """Text-only M-RoPE positions: the three streams equal, [3, B, S]."""
    p = positions_default(batch, seq, offset, device)
    return p[None].expand(3, batch, seq)
