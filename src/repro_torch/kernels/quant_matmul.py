"""W8A16 matrix product with the per-output-column scale fused into the
fp32 accumulator, every track of a projection in one launch.

Replaces ``repro/kernels/quant_matmul.py::int8_matmul`` (the Pallas
``_kernel``).  The CUDA kernel is ``csrc/int8_matmul.cu``; what bounds
it on the H100 (bytes at decode, operations at prefill) and how its
design answers that is noted there.  The weight stays int8 in device
memory and is widened in registers; it is never written out in a wider
type.  ``int8_matmul_plain`` is the same function in plain PyTorch: the
wrapper runs it for CPU tensors, and the on-card check holds the kernel
against it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or scale.dim() != 3:
        raise ValueError(f"want x [n,M,K], w [n,K,N], scale [n,1,N]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(scale.shape)}")
    n, _, K = x.shape
    if tuple(w.shape[:2]) != (n, K) \
            or tuple(scale.shape) != (n, 1, w.shape[2]):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and "
                         f"scale {tuple(scale.shape)} do not match")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"want an int8 weight and an fp32 scale, got "
                         f"{w.dtype} and {scale.dtype}")
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: both operands widened to fp32, the scale on
    the product.  x [n, M, K]; w [n, K, N] int8; scale [n, 1, N] fp32.
    Returns [n, M, N] fp32."""
    _check(x, w, scale)
    return torch.matmul(x.float(), w.float()) * scale


def _launcher():
    fn = build.library("int8_matmul.cu").int8_matmul_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [n, M, K] (fp32 or bf16) @ w [n, K, N] int8, times the
    per-column scale [n, 1, N] fp32.  Returns [n, M, N] fp32 (the caller
    casts to its activation dtype).  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(x, w, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    for t in (x, w, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    n, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((n, M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    err = _launcher()(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                      out.data_ptr(), n, M, N, K, _DTYPES[x.dtype],
                      build.cuda_stream(x))
    build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
