"""Rotary position embeddings, "half rotation" layout, in fp32
(counterpart of ``repro.models.rope``; M-RoPE is not ported)."""
from __future__ import annotations

from typing import Optional, Tuple

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


def positions_default(batch: int, seq: int, offset=0,
                      device: Optional[torch.device] = None
                      ) -> torch.Tensor:
    """[B, S] int32 positions starting at offset (int or [B] tensor)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    if isinstance(offset, int):
        return (pos + offset).expand(batch, seq)
    return pos + offset.to(torch.int32)[:, None]
