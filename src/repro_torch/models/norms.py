"""RMSNorm (counterpart of ``repro.models.norms``): gemma-style
``(1 + scale)`` weight, fp32 math, routed through the RMSNorm kernel
wrapper so every track of a layer is normalised in one launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] with scale [d], or x [n, ..., d] with per-track scale
    [n, d].  Computed in fp32, cast back to x's dtype."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def apply_norm(kind: str, params, x: torch.Tensor, *,
               eps: float) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r} is not ported (ROADMAP queue 1, item 3)")
    return rmsnorm(params, x, eps=eps)
