"""Flash attention for whole-prompt prefill.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas ``_kernel``).  The CUDA kernel is ``csrc/flash_attention.cu``;
what bounds it on the H100 and how its design answers that is noted
there.  Unlike the Pallas kernel it takes K/V with their KV heads
un-expanded ([B, S, KH, hd]) and maps query head h to KV head h // G
itself, so no G-fold copy of K/V is written or read.  ``route`` picks
the kernel's route from dtype, head dims and alignment, on the host:
bf16 with 16-byte-aligned bases at head dim 64, 128, 256, 288 or 320
(value width as wide; the serving path and the gemma heads) or at
MLA's q/k width 192 with value width 128 runs ``wgmma_tma`` (wgmma fed
by TMA, warp-specialised); fp32, other widths and unaligned bases run
``cuda_core``, a CUDA-core kernel of the same contract.  V may be
narrower than q and k (``dv <= hd``, as the Pallas kernel allows for
MLA); the output takes V's width.  The wrapper counts each launch under
its route in ``flash_attention.routes``.  ``flash_attention_plain`` is
the same function in plain PyTorch: the wrapper runs it for CPU
tensors, and the on-card check holds the kernel against it.

Causal masking follows the Pallas kernel: query row i sees key columns
j <= i (rows and columns both counted from 0).  Beyond the Pallas
kernel's contract the kernel takes a sliding ``window`` W (row i sees
only j > i - W; key tiles wholly before a query tile's window are not
visited) and, per batch row b, a query offset and a key length
(``q_offset``, ``k_lengths`` [B] int32): row b's query i sits at
absolute position q_offset[b] + i and sees keys j < k_lengths[b].  The
chunk program runs warm prompt tails through it over keys gathered from
the cache: each row visits the key tiles from 0 in the same order as in
a cold prefill, a tile past its diagonal adds exact zeros, so a row's
result does not depend on its offset or on its tile-mates.
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
MAX_HD = 320                    # the cuda_core route's widest head


# (q/k width, value width) pairs the wgmma_tma route is built for (288
# runs the 320 instantiation over maps 288 wide)
WGMMA_WIDTHS = ((64, 64), (128, 128), (192, 128), (256, 256), (288, 288),
                (320, 320))


def route(dtype: torch.dtype, hd: int, aligned: bool,
          dv: Optional[int] = None) -> str:
    """The kernel route for q of ``dtype``, q/k head dim ``hd`` and value
    width ``dv`` (default ``hd``); ``aligned``: q, k, v and the output
    start on 16-byte boundaries.  TMA needs 16-byte bases and row
    strides, and the kernel is built for the widths of ``WGMMA_WIDTHS``:
    bf16 at (hd, dv) (64, 64), (128, 128), MLA's (192, 128), (256, 256),
    (288, 288) or (320, 320).  Everything else takes the CUDA-core
    kernel."""
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    if (dtype == torch.bfloat16 and (hd, dv or hd) in WGMMA_WIDTHS
            and aligned):
        return "wgmma_tma"
    return "cuda_core"


def _check(q, k, v, q_offset=None, k_lengths=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"want q [B,Sq,H,hd], k [B,Sk,KH,hd], v "
                         f"[B,Sk,KH,dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if v.shape[3] > hd:
        raise ValueError(f"value width {v.shape[3]} exceeds the q/k width "
                         f"{hd}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype mismatch: q {q.dtype}, k/v {k.dtype}")
    if (q_offset is None) != (k_lengths is None):
        raise ValueError("pass both q_offset and k_lengths, or neither")
    for t in (q_offset, k_lengths):
        if t is not None and (tuple(t.shape) != (B,)
                              or t.dtype != torch.int32):
            raise ValueError(f"want int32 [{B}] offsets and lengths, got "
                             f"{tuple(t.shape)} {t.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None,
                          q_offset: Optional[torch.Tensor] = None,
                          k_lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores, one softmax over all keys.
    q [B, Sq, H, hd]; k [B, Sk, KH, hd]; v [B, Sk, KH, dv], dv <= hd;
    ``window``, ``q_offset`` and ``k_lengths`` as the kernel's.  Returns
    [B, Sq, H, dv]; a row that sees no key gives zeros, as the kernel's
    max(l, 1e-37)."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    kf = k.float().repeat_interleave(G, dim=2)          # head h -> h // G
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[None, :, None]      # [1, Sq, 1]
    cols = torch.arange(Sk, device=q.device)[None, None, :]
    seen = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if q_offset is not None:
        rows = rows + q_offset.to(q.device).long()[:, None, None]
        seen = seen & (cols < k_lengths.to(q.device).long()[:, None, None])
    if causal:
        seen = seen & (cols <= rows)
    if window is not None:
        seen = seen & (cols > rows - window)
    s = s.masked_fill(~seen[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _launcher():
    fn = build.library("flash_attention.cu").flash_attention_launch
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, f,
                       f, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    q_offset: Optional[torch.Tensor] = None,
                    k_lengths: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Softmax attention, causal or full, with optional tanh softcap and
    sliding ``window``.  q [B, Sq, H, hd]; k [B, Sk, KH, hd] (GQA: KH
    divides H); v [B, Sk, KH, dv] with dv <= hd (MLA's prefill: q/k
    192 wide, v 128); the scale is hd ** -0.5; ``q_offset`` /
    ``k_lengths`` [B] int32 (both or neither): row b's queries at
    q_offset[b] + i over keys [0, k_lengths[b]), k_lengths[b] <= Sk.
    Returns [B, Sq, H, dv] in q's dtype.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(q, k, v, q_offset, k_lengths)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, softcap=softcap,
                                     window=window, q_offset=q_offset,
                                     k_lengths=k_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    rows = () if q_offset is None else (q_offset, k_lengths)
    for t in (q, k, v) + rows:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("q, k, v (and the offsets and lengths) must "
                             "be contiguous on one device")
    B, Sq, H, hd = q.shape
    Sk, KH, dv = k.shape[1], k.shape[2], v.shape[3]
    if hd > MAX_HD:
        raise ValueError(f"kernel takes hd <= {MAX_HD}, got {hd}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    out = q.new_empty(B, Sq, H, dv)
    if out.numel() == 0:
        return out
    if Sk == 0:                 # no key: the plain version's empty sum
        return out.zero_()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    r = route(q.dtype, hd, all(p % 16 == 0 for p in ptrs), dv)
    err = _launcher()(*ptrs,
                      None if q_offset is None else q_offset.data_ptr(),
                      None if k_lengths is None else k_lengths.data_ptr(),
                      B, Sq, Sk, H, KH, hd, dv, int(causal), window or 0,
                      0.0 if softcap is None else float(softcap),
                      hd ** -0.5, _DTYPES[q.dtype], _CODES[r],
                      build.cuda_stream(q))
    build.check(err, f"flash_attention ({r})")
    flash_attention.launches += 1
    flash_attention.routes[r] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
