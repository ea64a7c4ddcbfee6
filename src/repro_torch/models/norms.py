"""RMSNorm and LayerNorm (counterpart of ``repro.models.norms``).

RMSNorm: gemma-style ``(1 + scale)`` weight, fp32 math, routed through
the RMSNorm kernel wrapper so every track of a layer is normalised in
one launch.  The residual add before a norm, and at a track-block
boundary the fusion mean, go into the same launch (``add_norm``,
``fuse_norm``).

LayerNorm (nemotron-4-15b): ``scale`` and ``bias``, fp32 statistics
(population variance), plain PyTorch: the reference has no Pallas
kernel for it, and the RMSNorm kernel does not compute it.  Its residual
add is the same add in x's dtype, then the norm.  Track fusion is a PT
boundary and PT models use RMSNorm only.

``plain_norm`` is the reference's jnp norm as written, with no kernel
wrapper: the train mode runs it (the reference's ``layers._norm``), so
autograd differentiates plain PyTorch ops."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


NORMS = ("rmsnorm", "layernorm")


def _known(kind: str) -> None:
    if kind not in NORMS:
        raise ValueError(f"unknown norm {kind!r}")


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] with scale [d], or x [n, ..., d] with per-track scale
    [n, d].  Computed in fp32, cast back to x's dtype."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def layernorm(params, x: torch.Tensor, *, eps: float = 1e-5
              ) -> torch.Tensor:
    """x [..., d] with scale and bias [d], or x [n, ..., d] with
    per-track rows [n, d]: (x - mean) * rsqrt(var + eps) * scale + bias
    in fp32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    w = _rows(params["scale"].float(), x)
    b = _rows(params["bias"].float(), x)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-track scale row [n, d] viewed against x [n, ..., d]."""
    if w.dim() == 2 and x.dim() > 2:
        return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])
    return w


def plain_rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The reference's jnp ``rmsnorm``, op for op: x * rsqrt(mean(x^2) +
    eps) in fp32, times (1 + scale), cast back to x's dtype.  Scale [d],
    or per-track [n, d] with x [n, ..., d]."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = 1.0 + _rows(params["scale"].float(), x)
    return (xf * w).to(x.dtype)


def plain_norm(kind: str, params, x: torch.Tensor, *,
               eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm in plain PyTorch (train mode)."""
    _known(kind)
    if kind == "layernorm":
        return layernorm(params, x, eps=eps)
    return plain_rmsnorm(params, x, eps=eps)


def apply_norm(kind: str, params, x: torch.Tensor, *,
               eps: float) -> torch.Tensor:
    _known(kind)
    if kind == "layernorm":
        return layernorm(params, x, eps=eps)
    return rmsnorm(params, x, eps=eps)


def add_norm(kind: str, params, x: torch.Tensor, delta: torch.Tensor, *,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm of its result: (x + delta,
    norm(x + delta)), the sum rounded to x's dtype first."""
    _known(kind)
    if kind == "layernorm":
        x = x + delta
        return x, layernorm(params, x, eps=eps)
    return ops.add_rmsnorm(x, delta, params["scale"], eps=eps)


def fuse_norm(kind: str, params, x: torch.Tensor,
              delta: Optional[torch.Tensor], *, eps: float,
              fusion_op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """A track-block boundary: x, delta [n, ..., d] -> (f, norm(f)) with f
    [..., d] the fusion of x + delta over the tracks (of x alone when
    delta is None: a track rank's gathered rows); the norm under the next
    layer's per-track scale [k, d] (y [k, ..., d]; k = n, or a rank's
    n/W tracks) or the final scale [d] (y [..., d])."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"a track fusion under {kind!r}: PT "
                                  "models use RMSNorm")
    return ops.fuse_rmsnorm(x, delta, params["scale"], eps=eps,
                            fusion_op=fusion_op)
