"""Paged flash-decode: one query token per sequence against a block-pool
K/V cache, for every Parallel-Track track of a layer in one launch.

Replaces ``repro/kernels/decode_attention.py::paged_decode_attention``
(the Pallas ``_paged_kernel``).  The CUDA kernel is
``csrc/paged_decode.cu``; what bounds it on the H100 (bytes: each live
K/V row is read once for all G query heads) and how its design answers
that is noted there.  ``paged_decode_attention_plain`` is the same
function in plain PyTorch: the wrapper runs it for CPU tensors, and the
on-card check holds the kernel against it.

The int8 branch of the Pallas kernel (scale pools dequantized inside
the softmax loop) comes with quantized serving (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _sweep_blocks(nmax: int, bs: int, max_len: Optional[int]) -> int:
    """Blocks the sweep may visit: the whole table, or the ``max_len``
    cut (at least one block), as the Pallas kernel's grid."""
    if max_len is None:
        return nmax
    return max(1, min(nmax, -(-max_len // bs)))


def _check(q, k_pool, v_pool, block_table, lengths) -> None:
    if q.dim() != 4 or k_pool.dim() != 5 or v_pool.shape != k_pool.shape:
        raise ValueError(f"want q [n,B,H,hd] and pools [n,N,bs,KH,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    n, B, H, hd = q.shape
    KH = k_pool.shape[3]
    if k_pool.shape[0] != n or k_pool.shape[4] != hd or H % KH:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"table {tuple(block_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"dtype mismatch: q {q.dtype}, pools {k_pool.dtype}")


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor, *,
                                 max_len: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version: gather the table's blocks, masked fp32
    softmax.  q [n, B, H, hd]; pools [n, N, bs, KH, hd]; block_table
    [B, nmax] int32; lengths [B] int32 (columns >= length are masked).
    Returns [n, B, H, hd] in q's dtype."""
    n, N, bs, KH, hd = k_pool.shape
    B, H = q.shape[1], q.shape[2]
    G = H // KH
    n_s = _sweep_blocks(block_table.shape[1], bs, max_len)
    tbl = block_table[:, :n_s].long()
    k = k_pool[:, tbl].reshape(n, B, n_s * bs, KH, hd).float()
    v = v_pool[:, tbl].reshape(n, B, n_s * bs, KH, hd).float()
    qf = q.float().reshape(n, B, KH, G, hd) * hd ** -0.5
    s = torch.einsum("nbkgd,nbskd->nbkgs", qf, k)
    cols = torch.arange(n_s * bs, device=q.device)
    live = cols[None, :] < lengths.to(q.device).long()[:, None]     # [B, S]
    s = s.masked_fill(~live[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("nbkgs,nbskd->nbkgd", p, v)
    return o.reshape(n, B, H, hd).to(q.dtype)


def _launcher():
    fn = build.library("paged_decode.cu").paged_decode_attention_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           max_len: Optional[int] = None) -> torch.Tensor:
    """Flash-decode over a block pool, all tracks at once.

    q [n, B, H, hd]; pools [n, N, bs, KH, hd] (one layer's slice of the
    [R, D, n, N, bs, KH, hd] pool); block_table [B, nmax] int32 shared by
    the tracks; lengths [B] int32 live tokens; ``max_len`` (host-known
    bound on lengths) cuts the sweep to ceil(max_len / bs) blocks.
    Returns [n, B, H, hd].  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    _check(q, k_pool, v_pool, block_table, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_table,
                                            lengths, max_len=max_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    for t in (q, k_pool, v_pool, block_table, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    n, B, H, hd = q.shape
    _, N, bs, KH, _ = k_pool.shape
    if H // KH > 8 or hd > 256:
        raise ValueError(f"kernel takes G <= 8 and hd <= 256, got "
                         f"G={H // KH}, hd={hd}")
    nmax = block_table.shape[1]
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      block_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), n, B, H, KH, hd, N, bs, nmax,
                      _sweep_blocks(nmax, bs, max_len), hd ** -0.5,
                      _DTYPES[q.dtype], build.cuda_stream(q))
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
