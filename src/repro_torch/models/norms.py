"""RMSNorm (counterpart of ``repro.models.norms``): gemma-style
``(1 + scale)`` weight, fp32 math, routed through the RMSNorm kernel
wrapper so every track of a layer is normalised in one launch.  The
residual add before a norm, and at a track-block boundary the fusion
mean, go into the same launch (``add_norm``, ``fuse_norm``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def _rms_only(kind: str) -> None:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r} is not ported (ROADMAP queue 1, item 3)")


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] with scale [d], or x [n, ..., d] with per-track scale
    [n, d].  Computed in fp32, cast back to x's dtype."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def apply_norm(kind: str, params, x: torch.Tensor, *,
               eps: float) -> torch.Tensor:
    _rms_only(kind)
    return rmsnorm(params, x, eps=eps)


def add_norm(kind: str, params, x: torch.Tensor, delta: torch.Tensor, *,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm of its result: (x + delta,
    norm(x + delta)), the sum rounded to x's dtype first."""
    _rms_only(kind)
    return ops.add_rmsnorm(x, delta, params["scale"], eps=eps)


def fuse_norm(kind: str, params, x: torch.Tensor,
              delta: Optional[torch.Tensor], *, eps: float,
              fusion_op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A track-block boundary: x, delta [n, ..., d] -> (f, norm(f)) with f
    [..., d] the fusion of x + delta over the tracks (of x alone when
    delta is None: a track rank's gathered rows); the norm under the next
    layer's per-track scale [k, d] (y [k, ..., d]; k = n, or a rank's
    n/W tracks) or the final scale [d] (y [..., d])."""
    _rms_only(kind)
    return ops.fuse_rmsnorm(x, delta, params["scale"], eps=eps,
                            fusion_op=fusion_op)
