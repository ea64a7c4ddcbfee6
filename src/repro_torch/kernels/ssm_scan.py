"""Linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over the sequence axis
(the Mamba mixer's selective scan), every ``h`` and the last one in fp32.

Replaces ``repro/kernels/ssm_scan.py::ssm_scan`` (the Pallas ``_kernel``).
The CUDA kernel is ``csrc/ssm_scan.cu``; what bounds it on the H100
(bytes) and how its design answers that is noted there.  The TPU kernel
tiles the sequence into chunks of a sequential grid; the CUDA kernel
keeps the whole time loop inside a thread, so it takes any S and any
``d_state`` (the reference requires S to tile its chunk).
``ssm_scan_plain`` is the same function in plain PyTorch: the wrapper
runs it for CPU tensors, and the on-card check holds the kernel against
it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() < 3 or a.shape != b.shape:
        raise ValueError(f"want a, b [B, S, ...] of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if tuple(h0.shape) != (a.shape[0],) + tuple(a.shape[2:]):
        raise ValueError(f"h0 {tuple(h0.shape)} does not fit a "
                         f"{tuple(a.shape)}: want [B, ...]")
    for t in (a, b, h0):
        if not t.is_floating_point():
            raise ValueError(f"a, b and h0 must be floating point, got "
                             f"{t.dtype}")


def ssm_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a step loop in fp32 (product, then sum).
    a, b [B, S, ...]; h0 [B, ...].  Returns (h [B, S, ...] fp32, h_last
    [B, ...] fp32)."""
    _check(a, b, h0)
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    cur = h0.float().clone()                  # never an alias of h0
    for t in range(a.shape[1]):
        cur = a[:, t].float() * cur + b[:, t].float()
        h[:, t] = cur
    return h, cur


def _launcher():
    fn = build.library("ssm_scan.cu").ssm_scan_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [B, S, di, ds] (fp32 or bf16, one dtype); h0 [B, di, ds] ->
    (h [B, S, di, ds] fp32, h_last [B, di, ds] fp32).  Any trailing
    feature dims are flattened.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return ssm_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"a and b must share one dtype of {list(_DTYPES)}, "
                         f"got {a.dtype} and {b.dtype}")
    if b.device != a.device or h0.device != a.device:
        raise ValueError("a, b and h0 must lie on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    h0 = h0.float().contiguous()
    B, S = a.shape[:2]
    F = a[0, 0].numel() if S else h0[0].numel()
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if S == 0 or B * F == 0:
        return h, h0.clone()
    h_last = torch.empty(h0.shape, dtype=torch.float32, device=a.device)
    err = _launcher()(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                      h.data_ptr(), h_last.data_ptr(), B, S, F,
                      _DTYPES[a.dtype], build.cuda_stream(a))
    build.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return h, h_last


ssm_scan.launches = 0
