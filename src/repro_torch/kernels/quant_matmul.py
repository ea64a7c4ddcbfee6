"""W8A16 matrix product with the per-output-column scale fused into the
fp32 accumulator, every track of a projection in one launch.

Replaces ``repro/kernels/quant_matmul.py::int8_matmul`` (the Pallas
``_kernel``).  The CUDA kernel is ``csrc/int8_matmul.cu``; what bounds
each of its routes on the H100 (operations at prefill, bytes at decode)
and how its design answers that is noted there.  ``route`` picks the
route from the shape, on the host, and the wrapper counts each launch
under it in ``int8_matmul.routes``.  The weight stays int8 in device
memory and is widened on the card; it is never written out in a wider
type.  ``out_dtype`` bf16 rounds acc * scale once, in the kernel's
epilogue: the bits of the fp32 output cast with ``.to``.
``int8_matmul_plain`` is the same function in plain PyTorch: the wrapper
runs it for CPU tensors, and the on-card check holds the kernel against
it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's routes, in the order of csrc/int8_matmul.cu's route codes
ROUTES = ("wgmma_tma", "mma_m16", "mma_m64", "fma_rows", "fma_m16",
          "fma_m64")
_CODES = {r: i for i, r in enumerate(ROUTES)}
DECODE_ROWS = 16      # M at or below it: the decode routes


def route(M: int, K: int, N: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel route for x [n, M, K] of ``dtype`` @ w [n, K, N] int8;
    ``aligned``: x and w start on 16-byte boundaries.  bf16 x above the
    decode rows goes to wgmma fed by TMA, which needs 16-byte row strides
    (K % 8, N % 16) and bases; fp32 x at the decode rows (the LM head)
    streams the weight in 16-byte copies (N % 16, base).  The other
    shapes take the register-staged kernels."""
    if dtype == torch.bfloat16:
        if M <= DECODE_ROWS:
            return "mma_m16"
        if aligned and K % 8 == 0 and N % 16 == 0:
            return "wgmma_tma"
        return "mma_m64"
    if dtype == torch.float32:
        if M > DECODE_ROWS:
            return "fma_m64"
        return "fma_rows" if aligned and N % 16 == 0 else "fma_m16"
    raise ValueError(f"unsupported dtype {dtype}")


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
           out_dtype: torch.dtype) -> None:
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
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: both operands widened to fp32, the scale on
    the product, one rounding to ``out_dtype``.  x [n, M, K]; w [n, K, N]
    int8; scale [n, 1, N] fp32.  Returns [n, M, N] of ``out_dtype``."""
    _check(x, w, scale, out_dtype)
    return (torch.matmul(x.float(), w.float()) * scale).to(out_dtype)


def _launcher():
    fn = build.library("int8_matmul.cu").int8_matmul_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [n, M, K] (fp32 or bf16) @ w [n, K, N] int8, times the
    per-column scale [n, 1, N] fp32.  Returns [n, M, N] of ``out_dtype``
    (fp32, the Pallas contract, or bf16).  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(x, w, scale, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    for t in (x, w, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    n, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((n, M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    xp, wp = x.data_ptr(), w.data_ptr()
    r = route(M, K, N, x.dtype, xp % 16 == 0 and wp % 16 == 0)
    err = _launcher()(xp, wp, scale.data_ptr(), out.data_ptr(), n, M, N, K,
                      _DTYPES[x.dtype], _DTYPES[out_dtype], _CODES[r],
                      build.cuda_stream(x))
    build.check(err, f"int8_matmul ({r})")
    int8_matmul.launches += 1
    int8_matmul.routes[r] += 1
    return out


int8_matmul.launches = 0
int8_matmul.routes = dict.fromkeys(ROUTES, 0)
