"""Linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over the sequence axis
(the Mamba mixer's selective scan, the RG-LRU's scan), every ``h`` and
the last one in fp32, in two routes of one kernel.

Replaces ``repro/kernels/ssm_scan.py::ssm_scan`` (the Pallas ``_kernel``).
The CUDA kernel is ``csrc/ssm_scan.cu``; what bounds it on the H100
(bytes) and how its design answers that is noted there.  The TPU kernel
tiles the sequence into chunks of a sequential grid; the CUDA kernel
keeps the whole time loop inside a thread, so it takes any S and any
``d_state`` (the reference requires S to tile its chunk).

* ``ssm_scan(a, b, h0)``, route ``scan``: a and b given, h written.
* ``selective_scan(dt, x, A, Bt, Ct, h0, lens)``, route ``selective``:
  the Mamba mixer's discretisation (a = exp(dt A), b = dt x B_t), the
  chunk mask, the recurrence and y = h . C_t in one pass, so a, b and h
  never reach device memory; y and h_last are written.

Both count under ``ssm_scan.launches``, and ``ssm_scan.routes`` splits
them by route.  ``ssm_scan_plain`` and ``selective_scan_plain`` are the
same functions in plain PyTorch: the wrappers run them for CPU tensors,
and the on-card checks hold the kernel against them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("scan", "selective")
MAX_SELECTIVE_STATE = 16          # the selective route's widest d_state


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


def _lib():
    lib = build.library("ssm_scan.cu")
    if lib.ssm_scan_launch.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssm_scan_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.ssm_scan_launch.restype = ctypes.c_int
        lib.selective_scan_launch.argtypes = [vp] * 9 + [i] * 4 + [ll, ll,
                                                                  vp]
        lib.selective_scan_launch.restype = ctypes.c_int
    return lib


def _count(route: str) -> None:
    ssm_scan.launches += 1
    ssm_scan.routes[route] += 1


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [B, S, di, ds] (fp32 or bf16, one dtype); h0 [B, di, ds] ->
    (h [B, S, di, ds] fp32, h_last [B, di, ds] fp32).  Any trailing
    feature dims are flattened.  CPU tensors run the plain version; CUDA
    tensors launch the kernel's scan route or raise."""
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
    err = _lib().ssm_scan_launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                 h.data_ptr(), h_last.data_ptr(), B, S, F,
                                 _DTYPES[a.dtype], build.cuda_stream(a))
    build.check(err, "ssm_scan (scan)")
    _count("scan")
    return h, h_last


ssm_scan.launches = 0
ssm_scan.routes = dict.fromkeys(ROUTES, 0)


def _check_selective(dt, x, A, Bt, Ct, h0, lens) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"want dt, x [B, S, di] of one shape; got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    B, S, di = dt.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A {tuple(A.shape)} does not fit di {di}: want "
                         f"[di, ds]")
    ds = A.shape[1]
    for name, t in (("Bt", Bt), ("Ct", Ct)):
        if tuple(t.shape) != (B, S, ds):
            raise ValueError(f"{name} {tuple(t.shape)}: want [{B}, {S}, "
                             f"{ds}]")
    if tuple(h0.shape) != (B, di, ds):
        raise ValueError(f"h0 {tuple(h0.shape)}: want [{B}, {di}, {ds}]")
    if lens is not None and tuple(lens.shape) != (B,):
        raise ValueError(f"lens {tuple(lens.shape)}: want [{B}]")


def selective_scan_plain(dt: torch.Tensor, x: torch.Tensor,
                         A: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor,
                         h0: torch.Tensor,
                         lens: Optional[torch.Tensor] = None, *,
                         scan=ssm_scan_plain
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the Mamba mixer's unfused composition: a =
    exp(dt A) and b = (dt x) B_t as [B, S, di, ds] fp32, a = 1 and b = 0
    at positions t >= lens[row] (the chunk mask; ``lens`` None masks
    nothing), h from ``scan`` (the plain step loop; the on-card checks
    pass the kernel's scan route), y = h . C_t (an einsum).  dt, x [B, S,
    di] fp32; A [di, ds]; Bt, Ct [B, S, ds]; h0 [B, di, ds].  Returns (y
    [B, S, di] fp32, h_last [B, di, ds] fp32)."""
    _check_selective(dt, x, A, Bt, Ct, h0, lens)
    a = (dt[..., None] * A[None, None]).exp_()               # [B,S,di,ds]
    b = (dt * x)[..., None] * Bt.float()[:, :, None, :]
    if lens is not None:
        pad = (torch.arange(dt.shape[1], device=dt.device)[None]
               >= lens.to(dt.device)[:, None])[..., None, None]
        a.masked_fill_(pad, 1.0)
        b.masked_fill_(pad, 0.0)
    h, h_last = scan(a, b, h0.float())
    del a, b
    return torch.einsum("bsiz,bsz->bsi", h, Ct.float()), h_last


def selective_scan(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                   Bt: torch.Tensor, Ct: torch.Tensor, h0: torch.Tensor,
                   lens: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba mixer's scan from ``x_dbl`` to y = h . C_t: dt, x [B, S,
    di] fp32; A [di, ds] (= -exp(A_log)); Bt, Ct [B, S, ds] fp32 (views of
    ``x_dbl`` welcome: the last dim contiguous, one stride for both);
    h0 [B, di, ds]; ``lens`` [B] valid tokens a row (positions at or past
    it update h by a = 1, b = 0), None for every position.  Returns (y
    [B, S, di] fp32, without the D skip, h_last [B, di, ds] fp32).  CPU
    tensors run the plain version; CUDA tensors launch the kernel's
    selective route or raise."""
    _check_selective(dt, x, A, Bt, Ct, h0, lens)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, x, A, Bt, Ct, h0, lens)
    if dt.device.type != "cuda":
        raise ValueError(f"unsupported device {dt.device}")
    ts = (dt, x, A, Bt, Ct, h0) + (() if lens is None else (lens,))
    if any(t.device != dt.device for t in ts):
        raise ValueError("the selective scan's inputs must lie on one "
                         "device")
    if any(t.dtype != torch.float32 for t in ts[:6]):
        raise ValueError("the selective route takes fp32 dt, x, A, Bt, Ct "
                         "and h0")
    B, S, di = dt.shape
    ds = A.shape[1]
    if not 1 <= ds <= MAX_SELECTIVE_STATE:
        raise ValueError(f"the selective route takes d_state 1 .. "
                         f"{MAX_SELECTIVE_STATE}, got {ds}")
    if Bt.stride() != Ct.stride() or Bt.stride(-1) != 1:
        Bt, Ct = Bt.contiguous(), Ct.contiguous()
    dt, x, A, h0 = (t.contiguous() for t in (dt, x, A, h0))
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    if S == 0 or B * di == 0:
        return y, h0.clone()
    if lens is not None:
        lens = lens.to(torch.int32).contiguous()
    h_last = torch.empty_like(h0)
    err = _lib().selective_scan_launch(
        dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bt.data_ptr(),
        Ct.data_ptr(), h0.data_ptr(),
        None if lens is None else lens.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), B, S, di, ds, Bt.stride(0), Bt.stride(1),
        build.cuda_stream(dt))
    build.check(err, "ssm_scan (selective)")
    _count("selective")
    return y, h_last
