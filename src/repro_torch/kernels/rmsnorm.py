"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in fp32,
cast back to x's dtype, with one scale row per Parallel-Track track.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas ``_kernel``);
the JAX model calls the identical jnp ``models/norms.py::rmsnorm``.

Bound on the H100: bytes (x read once, out written once; a few flops
per element).  The Triton kernel runs one program per row: the row
(d <= BLOCK, masked) stays in registers between the variance reduction
and the scaling pass, so x crosses device memory once and no fp32 copy
is written.  x [n, ..., d] with scale [n, d] normalises every track in
one launch.  ``rmsnorm_plain`` is the same function in plain PyTorch:
the wrapper runs it for CPU tensors, and the on-card check holds the
kernel against it.  ``triton`` is imported only inside the launch.
"""
from __future__ import annotations

from typing import Dict

import torch

_KERNEL: Dict[str, object] = {}


def _per_track(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Rows of x that share one scale row (all of them for scale [d])."""
    d = x.shape[-1]
    if scale.dim() == 1 and scale.shape[0] == d:
        return x.numel() // d
    if scale.dim() == 2 and scale.shape[1] == d and x.dim() >= 2 \
            and x.shape[0] == scale.shape[0]:
        return x[0].numel() // d
    raise ValueError(f"scale {tuple(scale.shape)} does not fit x "
                     f"{tuple(x.shape)}: want [d] or [n, d] with x [n, ..., d]")


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version.  x [..., d] with scale [d], or x
    [n, ..., d] with per-track scale [n, d]."""
    _per_track(x, scale)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    w = 1.0 + scale.float()
    if scale.dim() == 2:
        w = w.reshape(scale.shape[0], *([1] * (x.dim() - 2)), x.shape[-1])
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _triton_kernel():
    if "k" not in _KERNEL:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, rows_per_scale, d, eps,
                           BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            srow = row // rows_per_scale
            cols = tl.arange(0, BLOCK)
            mask = cols < d
            x = tl.load(x_ptr + row * d + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / d
            w = 1.0 + tl.load(s_ptr + srow * d + cols, mask=mask,
                              other=0.0).to(tl.float32)
            y = x * tl.rsqrt(var + eps) * w
            tl.store(o_ptr + row * d + cols, y.to(o_ptr.dtype.element_ty),
                     mask=mask)

        _KERNEL["k"] = rmsnorm_kernel
    return _KERNEL["k"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with gemma-style ``(1 + scale)`` weight.  x [..., d] with
    scale [d], or x [n, ..., d] with per-track scale [n, d] (one launch
    for all tracks).  CPU tensors run the plain version; CUDA tensors
    launch the Triton kernel or raise."""
    rows_per_scale = _per_track(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError("scale must be fp32 on x's device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    d = x.shape[-1]
    block = 1 << (d - 1).bit_length()            # next power of two
    if block > 8192:
        raise ValueError(f"one row per program takes d <= 8192, got {d}")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        _triton_kernel()[(rows,)](x, scale, out, rows_per_scale, d, eps,
                                  BLOCK=block,
                                  num_warps=4 if block <= 2048 else 8)
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
