"""(1 + scale)-RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in
fp32, cast back to x's dtype, with one scale row per Parallel-Track
track; with the residual add before it, and at a track-block boundary
the track-fusion mean, folded into the same launch.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas ``_kernel``);
the JAX model calls the identical jnp ``models/norms.py::rmsnorm`` after
its own residual add (``models/layers.py``) and fusion mean
(``core/track.py::_fuse``).  One CUDA kernel source,
``csrc/rmsnorm.cu``, has three routes, each counted in
``rmsnorm.routes`` and every launch in ``rmsnorm.launches``:

  norm       ``rmsnorm(x, s)`` -> y
  add_norm   ``add_rmsnorm(x, delta, s)`` -> (x + delta, y of that)
  fuse_norm  ``fuse_rmsnorm(x, delta, s)`` -> (f, y): f the fusion (fp32
             mean or sum over the tracks) of x + delta, y its norm, under
             k scale rows ([k, d], k <= n: y [k, ...], the next block's
             tracks, all n or a rank's n/W) or one ([d]: y [...], the
             final norm); with delta None, of x as it is (a rank's
             boundary, whose x + delta was added before the gather)

What bounds it on the H100 and how the kernel answers that is noted in
the source.  x may be the broadcast of one fused row to every track
(stride 0 over the track dim), so no copy spreads a fused value.  Each
route rounds where the unfused sequence of PyTorch ops rounds (x + delta
and f to x's dtype before the norm reads them); the ``*_plain`` versions
are that sequence: the wrappers run them for CPU tensors, and the
on-card checks hold the kernel against them.  ``launch_plan`` picks the
launch geometry on the host.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

ROUTES = ("norm", "add_norm", "fuse_norm")
FUSION_OPS = ("mean", "sum")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROW_BYTES = 16384          # d * element size: 512 threads x 2 vectors


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


def _is_track_broadcast(x: torch.Tensor) -> bool:
    return x.dim() >= 2 and x.shape[0] > 1 and x.stride(0) == 0 \
        and x[0].is_contiguous()


def _check_stream(x: torch.Tensor, delta: Optional[torch.Tensor]) -> None:
    """x contiguous, or one row broadcast to every track; delta (when
    given) contiguous, of x's shape."""
    if not (x.is_contiguous() or _is_track_broadcast(x)):
        raise ValueError("x must be contiguous, or one contiguous row "
                         "broadcast over the track dim (stride 0)")
    if delta is not None:
        if delta.shape != x.shape or not delta.is_contiguous():
            raise ValueError(f"delta must be contiguous of x's shape "
                             f"{tuple(x.shape)}, got {tuple(delta.shape)}")


def _check_fuse(x: torch.Tensor, delta: Optional[torch.Tensor],
                scale: torch.Tensor, fusion_op: str) -> None:
    _check_stream(x, delta)
    d = x.shape[-1]
    if x.dim() < 2:
        raise ValueError(f"x must be [n, ..., d], got {tuple(x.shape)}")
    if not (tuple(scale.shape) == (d,)
            or (scale.dim() == 2 and scale.shape[1] == d
                and 1 <= scale.shape[0] <= x.shape[0])):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit x "
                         f"{tuple(x.shape)}: want [d] or [k, d], k <= n")
    if fusion_op not in FUSION_OPS:
        raise ValueError(f"fusion_op {fusion_op!r} not in {FUSION_OPS}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

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


def add_rmsnorm_plain(x: torch.Tensor, delta: torch.Tensor,
                      scale: torch.Tensor, *, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``add_rmsnorm``: the residual add in x's
    dtype, then ``rmsnorm_plain`` of its result."""
    _check_stream(x, delta)
    xn = x + delta
    return xn, rmsnorm_plain(xn, scale, eps=eps)


def fuse_rmsnorm_plain(x: torch.Tensor, delta: Optional[torch.Tensor],
                       scale: torch.Tensor, *, eps: float = 1e-6,
                       fusion_op: str = "mean"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fuse_rmsnorm``: the residual add in x's
    dtype (none when delta is None), the fusion over dim 0 accumulated in
    fp32 and cast back, then ``rmsnorm_plain`` of the fused value under
    each of the k scale rows (scale [k, d]) or one (scale [d])."""
    _check_fuse(x, delta, scale, fusion_op)
    xn = x if delta is None else x + delta
    red = torch.mean if fusion_op == "mean" else torch.sum
    f = red(xn, dim=0, dtype=torch.float32).to(x.dtype)
    if scale.dim() == 2:
        return f, rmsnorm_plain(f[None].expand(scale.shape[0], *f.shape),
                                scale, eps=eps)
    return f, rmsnorm_plain(f, scale, eps=eps)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def launch_plan(d: int, itemsize: int) -> Tuple[int, int]:
    """(threads per CTA, 16-byte vectors per thread) of a launch over rows
    of ``d`` elements of ``itemsize`` bytes, for every route: a row's
    vectors spread over as many threads as it has, up to 512 (one vector
    a thread; two in rows of more than 512 vectors)."""
    if d <= 0 or (d * itemsize) % 16 or d * itemsize > MAX_ROW_BYTES:
        raise ValueError(f"rows of {d} x {itemsize} bytes: want a multiple "
                         f"of 16 bytes up to {MAX_ROW_BYTES}")
    vecs = d * itemsize // 16
    threads = min(512, 32 * math.ceil(vecs / 32))
    return threads, math.ceil(vecs / threads)


def _launcher():
    fn = build.library("rmsnorm.cu").rmsnorm_launch
    if fn.argtypes is None:
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
        fn.argtypes = [i, vp, ll, vp, vp, vp, vp, ll, i, i, i, i, f, f, i,
                       i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(route: str, x: torch.Tensor, delta: Optional[torch.Tensor],
            x_out: Optional[torch.Tensor], y: torch.Tensor,
            scale: torch.Tensor, *, n: int, M: int, s_track: int, ns: int,
            div: float, eps: float) -> None:
    """Check what only the kernel needs (device, dtypes, alignment) and
    launch ``route`` on the current stream; raises when it cannot."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}: want "
                         f"{list(_DTYPES)}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError("scale must be contiguous fp32")
    ins = [t for t in (x, delta, scale) if t is not None]
    if any(t.device != x.device for t in ins):
        raise ValueError("x, delta and scale must lie on one device")
    if delta is not None and delta.dtype != x.dtype:
        raise ValueError(f"delta {delta.dtype} is not x's {x.dtype}")
    d = x.shape[-1]
    threads, vpt = launch_plan(d, x.element_size())
    outs = [t for t in (x_out, y) if t is not None]
    if any(t.data_ptr() % 16 for t in ins + outs):
        raise ValueError("every tensor must start on a 16-byte boundary")
    if n * M == 0:
        return
    if n * M >= 2 ** 31:
        raise ValueError(f"{n * M} rows: the kernel indexes rows in int32")
    err = _launcher()(ROUTES.index(route), x.data_ptr(),
                      x.stride(0) if x.dim() >= 2 and n > 1 else 0,
                      0 if delta is None else delta.data_ptr(),
                      0 if x_out is None else x_out.data_ptr(),
                      y.data_ptr(), scale.data_ptr(), s_track, n, M, d, ns,
                      div, eps, _DTYPES[x.dtype], threads, vpt,
                      build.cuda_stream(x))
    build.check(err, f"rmsnorm ({route})")
    rmsnorm.launches += 1
    rmsnorm.routes[route] += 1


def _rows(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int]:
    """(tracks n, positions M, scale-row stride) of the norm / add_norm
    launch: x [n, ..., d] with scale [n, d], a track broadcast with scale
    [d], or plain rows [..., d] (n = 1) with scale [d]."""
    d = x.shape[-1]
    if scale.dim() == 2 or _is_track_broadcast(x):
        return x.shape[0], x[0].numel() // d, d if scale.dim() == 2 else 0
    return 1, x.numel() // d, 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """Route ``norm``.  x [..., d] with scale [d], or x [n, ..., d] with
    per-track scale [n, d] (one launch for all tracks); x may be one row
    broadcast to every track.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    _per_track(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    _check_stream(x, None)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    n, M, s_track = _rows(x, scale)
    _launch("norm", x, None, None, y, scale, n=n, M=M, s_track=s_track,
            ns=n, div=1.0, eps=eps)
    return y


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                *, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``add_norm``: (x + delta, its norm) in one launch.  x as in
    ``rmsnorm`` (a track broadcast included); delta contiguous of x's
    shape; both outputs contiguous of that shape."""
    _per_track(x, scale)
    _check_stream(x, delta)
    if x.device.type == "cpu":
        return add_rmsnorm_plain(x, delta, scale, eps=eps)
    x_out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x_out)
    n, M, s_track = _rows(x, scale)
    _launch("add_norm", x, delta, x_out, y, scale, n=n, M=M,
            s_track=s_track, ns=n, div=1.0, eps=eps)
    return x_out, y


def fuse_rmsnorm(x: torch.Tensor, delta: Optional[torch.Tensor],
                 scale: torch.Tensor, *, eps: float = 1e-6,
                 fusion_op: str = "mean"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route ``fuse_norm``: x, delta [n, ..., d] -> (f [..., d], y): f the
    fusion (``fusion_op``, accumulated in fp32) of x + delta over the n
    tracks, y its norm, [k, ..., d] under scale [k, d] (k <= n) or
    [..., d] under scale [d].  With delta None the kernel reads no delta
    and fuses x as it is."""
    _check_fuse(x, delta, scale, fusion_op)
    if x.device.type == "cpu":
        return fuse_rmsnorm_plain(x, delta, scale, eps=eps,
                                  fusion_op=fusion_op)
    n, d = x.shape[0], x.shape[-1]
    M = x[0].numel() // d
    f = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    ns = scale.shape[0] if scale.dim() == 2 else 1
    y = torch.empty((ns, *x.shape[1:]) if scale.dim() == 2 else x.shape[1:],
                    dtype=x.dtype, device=x.device)
    _launch("fuse_norm", x, delta, f, y, scale, n=n, M=M, s_track=d, ns=ns,
            div=float(n) if fusion_op == "mean" else 1.0, eps=eps)
    return f, y


rmsnorm.launches = 0
rmsnorm.routes = dict.fromkeys(ROUTES, 0)
