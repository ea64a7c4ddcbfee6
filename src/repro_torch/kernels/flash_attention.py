"""Flash attention for whole-prompt prefill.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas ``_kernel``).  The CUDA kernel is ``csrc/flash_attention.cu``;
what bounds it on the H100 and how its design answers that is noted
there.  Unlike the Pallas kernel it takes K/V with their KV heads
un-expanded ([B, S, KH, hd]) and maps query head h to KV head h // G
itself, so no G-fold copy of K/V is written or read.  ``route`` picks
the kernel's route from dtype, head dim and alignment, on the host: bf16
with head dim 64 or 128 and 16-byte-aligned bases (the serving path)
runs ``wgmma_tma`` (wgmma fed by TMA, warp-specialised); fp32, other
head dims and unaligned bases run ``cuda_core``, a CUDA-core kernel of
the same contract.  The wrapper counts each launch under its route in
``flash_attention.routes``.  ``flash_attention_plain`` is the same
function in plain PyTorch: the wrapper runs it for CPU tensors, and the
on-card check holds the kernel against it.

Causal masking follows the Pallas kernel: query row i sees key columns
j <= i (rows and columns both counted from 0).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's routes, in the order of csrc/flash_attention.cu's route codes
ROUTES = ("wgmma_tma", "cuda_core")
_CODES = {r: i for i, r in enumerate(ROUTES)}


def route(dtype: torch.dtype, hd: int, aligned: bool) -> str:
    """The kernel route for q of ``dtype`` and head dim ``hd``;
    ``aligned``: q, k, v and the output start on 16-byte boundaries.
    TMA needs 16-byte bases and row strides (hd * 2 bytes) and wgmma
    tiles of 64 columns: bf16 at hd 64 or 128.  Everything else takes
    the CUDA-core kernel."""
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    if dtype == torch.bfloat16 and hd in (64, 128) and aligned:
        return "wgmma_tma"
    return "cuda_core"


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Sq,H,hd], k/v [B,Sk,KH,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype mismatch: q {q.dtype}, k/v {k.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores, one softmax over all keys.
    q [B, Sq, H, hd]; k, v [B, Sk, KH, hd].  Returns [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    kf = k.float().repeat_interleave(G, dim=2)          # head h -> h // G
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _launcher():
    fn = build.library("flash_attention.cu").flash_attention_launch
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, f, f, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Softmax attention, causal or full, with optional tanh softcap.
    q [B, Sq, H, hd]; k, v [B, Sk, KH, hd] (GQA: KH divides H).  Returns
    [B, Sq, H, hd] in q's dtype.  CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous on one device")
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if hd > 128:
        raise ValueError(f"kernel takes hd <= 128, got {hd}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0:                 # no key: the plain version's empty sum
        return out.zero_()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    r = route(q.dtype, hd, all(p % 16 == 0 for p in ptrs))
    err = _launcher()(*ptrs, B, Sq, Sk, H, KH, hd, int(causal),
                      0.0 if softcap is None else float(softcap),
                      hd ** -0.5, _DTYPES[q.dtype], _CODES[r],
                      build.cuda_stream(q))
    build.check(err, f"flash_attention ({r})")
    flash_attention.launches += 1
    flash_attention.routes[r] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
