"""Flash-decode: one query token per sequence against a K/V cache, in
the two layouts of the reference.

  * ``paged_decode_attention`` -- a block-pool cache read through a
    block table, every Parallel-Track track of a layer in one launch;
    replaces ``repro/kernels/decode_attention.py::paged_decode_attention``
    (the Pallas ``_paged_kernel``).
  * ``decode_attention`` -- a contiguous per-slot cache [B, S, KH, hd];
    replaces ``repro/kernels/decode_attention.py::decode_attention`` (the
    Pallas ``_kernel``).

Both take the tanh logit softcap of gemma2 (``softcap``: each score s
becomes cap * tanh(s / cap) before the softmax, one tanh per score in
the kernel), which the Pallas kernels do not (the reference routes such
layers to jnp).  Both have both branches: fp caches, and int8 caches whose fp32
per-token-per-head scales are dequantized inside the softmax loop
(``_online_softmax_step``'s ``ks``/``vs``).  The CUDA kernel is
``csrc/paged_decode.cu``, one split-KV template for both layouts and both
branches; what bounds it on the H100 (bytes: each live K/V row is read
once for all G query heads; past 8 heads a KV head, ``head_groups``
splits them over blocks) and how its design answers that is noted
there.  ``split_plan`` is its host-side split of the swept tokens over
blocks, shared by the two layouts.  ``paged_decode_attention_plain`` and
``decode_attention_plain`` are the same functions in plain PyTorch: the
wrappers run them for CPU tensors, and the on-card checks hold the
kernels against them.  Each int8 branch keeps its own launch count
(``paged_decode_attention_int8``, ``decode_attention_int8``), apart from
its fp branch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2                       # pool dtype code of the int8 branch
MAX_HD = 320                    # csrc/paged_decode.cu kMaxHd
MAX_G = 8                       # csrc/paged_decode.cu kMaxG: heads a block


def head_groups(G: int) -> int:
    """The groups a KV head's G query heads are split into, one block
    each: the fewest that divide G into groups of at most ``MAX_G`` (1
    for G <= 8; recurrentgemma's G 16 takes 2)."""
    hg = -(-G // MAX_G)
    while G % hg:
        hg += 1
    return hg


def _cap(softcap: Optional[float]) -> float:
    """The kernel's softcap argument (0: none)."""
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return 0.0 if softcap is None else float(softcap)

# split-KV plan (the kernel's kMaxSplits / kMaxPages bound the first two)
_MAX_SPLITS = 64                # splits of one (track, row, KV head)
_MAX_PAGES = 256                # table entries one paged split holds
_SPLIT_MIN = 64                 # tokens: below it a split's fixed cost rules
_BLOCKS_PER_SM = 2              # blocks the plan aims to put on each SM
H100_SMS = 132


def split_plan(sweep: int, base: int, page: Optional[int] = None,
               sms: int = H100_SMS, capacity: Optional[int] = None
               ) -> Tuple[int, int]:
    """How the kernel splits the swept tokens over blocks: returns
    (splits, tokens per split).  ``sweep`` is the tokens the sweep may
    visit (the host's ``max_len`` cut), ``capacity`` the tokens the cache
    holds per row (a paged table row's blocks x block size, a contiguous
    cache's S; default ``sweep``), ``base`` the blocks without a split
    (tracks x rows x KV heads), ``page`` the block size of a paged cache
    (None for the contiguous one), ``sms`` the card's SM count.

    Split s covers tokens [s * c, (s + 1) * c).  The split size c depends
    on the capacity, never on the sweep: c is ``page`` (or 1) times a
    power of two, at least ``_SPLIT_MIN``, as small as gives about
    ``_BLOCKS_PER_SM`` blocks per SM when the whole capacity is swept.
    The sweep only sets how many splits launch, ceil(sweep / c); so a
    wider sweep bound adds splits after the same boundaries, splits that
    hold no live token and add exact zeros to the merge (the kernel's sum
    order, hence its bits, does not follow the bound).  Paged splits are
    whole pages, and the two layouts get the same plan from the same
    capacity.  Host ints only: no device sync."""
    capacity = sweep if capacity is None else capacity
    if sweep < 1 or base < 1 or capacity < sweep:
        raise ValueError(f"want 1 <= sweep <= capacity and base >= 1, got "
                         f"sweep {sweep}, capacity {capacity}, base {base}")
    want = max(1, -(-_BLOCKS_PER_SM * sms // base))
    per = -(-capacity // want)
    c = page or 1
    while c < _SPLIT_MIN or c < per:
        c *= 2
    if page is not None:
        c = min(c, _MAX_PAGES * page)
    while -(-capacity // c) > _MAX_SPLITS:
        c *= 2
    if page is not None and c > _MAX_PAGES * page:
        raise ValueError(f"a capacity of {capacity} tokens in pages of "
                         f"{page} needs more than {_MAX_SPLITS} splits of "
                         f"{_MAX_PAGES} pages")
    return -(-sweep // c), c


_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []    # replaced buffers a graph may hold
_SMS: Dict[torch.device, int] = {}


def reserve_counters(dev: torch.device, base: int) -> torch.Tensor:
    """The device's ticket counter buffer, grown to at least ``base``
    counters.  A buffer it replaces stays allocated (a CUDA graph
    captured over it goes on using it; every launch leaves its counters
    at zero, and one stream runs the launches one after another), and a
    growth while a graph is being captured raises: call this, for the
    largest ``base`` of every program, before the first capture."""
    cnt = _COUNTERS.get(dev)
    if cnt is not None and cnt.numel() >= base:
        return cnt
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"the decode kernels' ticket counters must grow to {base} "
            f"during a CUDA graph capture (they hold "
            f"{0 if cnt is None else cnt.numel()}): reserve_counters() "
            "before capturing")
    if cnt is not None:
        _RETIRED.append(cnt)
    cnt = torch.zeros(max(base, 2 * (0 if cnt is None else cnt.numel())),
                      dtype=torch.int32, device=dev)
    _COUNTERS[dev] = cnt
    return cnt


def _split_args(dev: torch.device, sweep: int, capacity: int, base: int,
                page: Optional[int], G: int, hd: int, plan_scale: int = 1):
    """(splits, tokens per split, workspace, counters) of one launch of
    ``base`` blocks without a split, the split size from the cache's
    ``capacity`` (``split_plan``) and from ``plan_scale`` x ``base``
    blocks: on a track rank of W, W x its own, the blocks of the launch
    one process makes over all n tracks, so that the rank splits (and
    sums) as that process does.  The workspace (partial m, l, acc in
    fp32) is fresh (under a capture, from the graph's pool); the ticket
    counters are ``reserve_counters``' buffer."""
    if plan_scale < 1:
        raise ValueError(f"plan_scale must be >= 1, got {plan_scale}")
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, c = split_plan(sweep, base * plan_scale, page, _SMS[dev],
                            capacity)
    if n_split == 1:
        return n_split, c, None, None
    cnt = reserve_counters(dev, base)
    ws = torch.empty(base * n_split * G * (hd + 2), dtype=torch.float32,
                     device=dev)
    return n_split, c, ws, cnt


def _vector_rows(hd: int, *caches) -> int:
    """1 when the caches' rows are a power-of-two number of 16-byte
    words, at most 512 bytes, from 16-byte aligned bases (the kernel's
    vector path), else 0 (its scalar path)."""
    row = hd * caches[0].element_size()
    words = row // 16
    return int(row % 16 == 0 and 0 < words <= 32 and not words & (words - 1)
               and all(c.data_ptr() % 16 == 0 for c in caches))


def _sweep_blocks(nmax: int, bs: int, max_len: Optional[int]) -> int:
    """Blocks the sweep may visit: the whole table, or the ``max_len``
    cut (at least one block), as the Pallas kernel's grid."""
    if max_len is None:
        return nmax
    return max(1, min(nmax, -(-max_len // bs)))


def _check(q, k_pool, v_pool, block_table, lengths, k_scale=None,
           v_scale=None) -> None:
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
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError(f"dtype mismatch: q {q.dtype}, pools "
                             f"{k_pool.dtype}")
        return
    want = tuple(k_pool.shape[:-1]) + (1,)
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"scale pools need int8 pools, got {k_pool.dtype}")
    for s in (k_scale, v_scale):
        if tuple(s.shape) != want or s.dtype != torch.float32:
            raise ValueError(f"want fp32 scale pools {want}, got "
                             f"{tuple(s.shape)} {s.dtype}")


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_table: torch.Tensor,
                                 lengths: torch.Tensor, *,
                                 max_len: Optional[int] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 softcap: Optional[float] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version: gather the table's blocks (dequantizing
    int8 pools: payload * per-row scale), masked fp32 softmax.  q
    [n, B, H, hd]; pools [n, N, bs, KH, hd] (int8 with fp32 scale pools
    [n, N, bs, KH, 1]); block_table [B, nmax] int32; lengths [B] int32
    (columns >= length are masked).  Returns [n, B, H, hd] in q's
    dtype.  The ``max_len`` cut masks the columns past it: the sums run
    over the whole table row whatever the cut, so a row within the cut
    gets the same bits from any cut (the pipelined engine's steps may
    take a wider one than the sync engine's)."""
    n, N, bs, KH, hd = k_pool.shape
    B, H = q.shape[1], q.shape[2]
    G = H // KH
    n_s = block_table.shape[1]
    cut = _sweep_blocks(n_s, bs, max_len) * bs
    tbl = block_table.long()

    def gather(pool, scale):
        g = pool[:, tbl].reshape(n, B, n_s * bs, KH, -1).float()
        if scale is not None:
            g = g * scale[:, tbl].reshape(n, B, n_s * bs, KH, 1)
        return g

    k = gather(k_pool, k_scale)
    v = gather(v_pool, v_scale)
    qf = q.float().reshape(n, B, KH, G, hd) * hd ** -0.5
    s = torch.einsum("nbkgd,nbskd->nbkgs", qf, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(n_s * bs, device=q.device)
    live = ((cols[None, :] < lengths.to(q.device).long()[:, None])
            & (cols[None, :] < cut))                                # [B, S]
    s = s.masked_fill(~live[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("nbkgs,nbskd->nbkgd", p, v)
    # a row with no live column stores zeros, as the Pallas kernel
    o = o * (lengths.to(q.device) > 0)[None, :, None, None, None]
    return o.reshape(n, B, H, hd).to(q.dtype)


def _launcher():
    fn = build.library("paged_decode.cu").paged_decode_attention_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                       i, i, i, i, i, i, i, ctypes.c_float, ctypes.c_float,
                       i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pool, v_pool, k_scale, v_scale, block_table, lengths,
            max_len, plan_scale, softcap) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands (either branch)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    operands = [q, k_pool, v_pool, block_table, lengths]
    if k_scale is not None:
        operands += [k_scale, v_scale]
    for t in operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    n, B, H, hd = q.shape
    _, N, bs, KH, _ = k_pool.shape
    if hd > MAX_HD:
        raise ValueError(f"kernel takes hd <= {MAX_HD}, got hd={hd}")
    hg = head_groups(H // KH)
    nmax = block_table.shape[1]
    n_sweep = _sweep_blocks(nmax, bs, max_len)
    n_split, c, ws, cnt = _split_args(q.device, n_sweep * bs, nmax * bs,
                                      n * B * KH * hg, bs, H // KH // hg,
                                      hd, plan_scale)
    out = torch.empty_like(q)
    quant = k_scale is not None
    err = _launcher()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      k_scale.data_ptr() if quant else None,
                      v_scale.data_ptr() if quant else None,
                      block_table.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), ws.data_ptr() if n_split > 1 else None,
                      cnt.data_ptr() if n_split > 1 else None, n, B, H, KH,
                      hd, N, bs, nmax, n_sweep, hg, n_split, c, hd ** -0.5,
                      _cap(softcap), _DTYPES[q.dtype],
                      _INT8 if quant else _DTYPES[q.dtype],
                      _vector_rows(hd, k_pool, v_pool), build.cuda_stream(q))
    build.check(err, "paged_decode_attention")
    return out


def paged_decode_attention_int8(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor,
                                block_table: torch.Tensor,
                                lengths: torch.Tensor, *,
                                max_len: Optional[int] = None,
                                plan_scale: int = 1,
                                softcap: Optional[float] = None
                                ) -> torch.Tensor:
    """The int8 branch: pools int8 [n, N, bs, KH, hd] with fp32 scale
    pools [n, N, bs, KH, 1], dequantized per row inside the softmax
    loop; otherwise as ``paged_decode_attention``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _check(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_table, lengths, max_len=max_len,
            k_scale=k_scale, v_scale=v_scale, softcap=softcap)
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, block_table, lengths,
                  max_len, plan_scale, softcap)
    paged_decode_attention_int8.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           max_len: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           plan_scale: int = 1,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Flash-decode over a block pool, all tracks at once.

    q [n, B, H, hd]; pools [n, N, bs, KH, hd] (one layer's slice of the
    [R, D, n, N, bs, KH, hd] pool); block_table [B, nmax] int32 shared by
    the tracks; lengths [B] int32 live tokens; ``max_len`` (host-known
    bound on lengths) cuts the sweep to ceil(max_len / bs) blocks.  int8
    pools pass their ``k_scale``/``v_scale`` pools and go to
    ``paged_decode_attention_int8``.  ``plan_scale``: the split plan
    counts that many times this launch's blocks (on a track rank of W,
    W: one process's launch over every track), so that the kernel sums
    each row as that launch does.  ``softcap``: the tanh logit cap.
    Returns [n, B, H, hd].  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if k_scale is not None or v_scale is not None:
        return paged_decode_attention_int8(q, k_pool, v_pool, k_scale,
                                           v_scale, block_table, lengths,
                                           max_len=max_len,
                                           plan_scale=plan_scale,
                                           softcap=softcap)
    _check(q, k_pool, v_pool, block_table, lengths)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_table,
                                            lengths, max_len=max_len,
                                            softcap=softcap)
    out = _launch(q, k_pool, v_pool, None, None, block_table, lengths,
                  max_len, plan_scale, softcap)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0


# ---------------------------------------------------------------------------
# contiguous layout
# ---------------------------------------------------------------------------

def _sweep_cols(S: int, block_s: int, max_len: Optional[int]) -> int:
    """Cache columns the sweep may visit: all S, or the ``max_len`` cut
    to ceil(max_len / block_s) tiles of ``min(block_s, S)`` (at least
    one), as the Pallas kernel's grid.  Unlike the Pallas kernel, S need
    not be a multiple of the tile."""
    if max_len is None:
        return S
    block_s = min(block_s, S)
    return min(S, max(1, -(-max_len // block_s)) * block_s)


def _check_dense(q, k_cache, v_cache, lengths, k_scale=None,
                 v_scale=None) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q [B,H,hd] and caches [B,S,KH,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or H % k_cache.shape[2] or k_cache.shape[1] == 0:
        raise ValueError(f"q {tuple(q.shape)} does not match caches "
                         f"{tuple(k_cache.shape)}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"want int32 lengths [{B}], got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise ValueError(f"dtype mismatch: q {q.dtype}, caches "
                             f"{k_cache.dtype}")
        return
    want = tuple(k_cache.shape[:-1]) + (1,)
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise ValueError(f"scales need int8 caches, got {k_cache.dtype}")
    for s in (k_scale, v_scale):
        if tuple(s.shape) != want or s.dtype != torch.float32:
            raise ValueError(f"want fp32 scales {want}, got "
                             f"{tuple(s.shape)} {s.dtype}")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           block_s: int = 512,
                           max_len: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: the swept columns of the cache
    (dequantizing int8 caches: payload * per-row scale), masked fp32
    softmax.  q [B, H, hd]; caches [B, S, KH, hd] (int8 with fp32 scales
    [B, S, KH, 1]); lengths [B] int32 (columns >= length are masked).
    Returns [B, H, hd] in q's dtype.  The ``max_len`` cut masks the
    columns past it: the sums run over all S columns whatever the cut,
    so a row within the cut gets the same bits from any cut."""
    B, S, KH, hd = k_cache.shape
    H = q.shape[1]
    cut = _sweep_cols(S, block_s, max_len)

    def cols(cache, scale):
        c = cache.float()
        return c if scale is None else c * scale

    k = cols(k_cache, k_scale)
    v = cols(v_cache, v_scale)
    qf = q.float().reshape(B, KH, H // KH, hd) * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    c = torch.arange(S, device=q.device)[None, :]
    live = (c < lengths.to(q.device).long()[:, None]) & (c < cut)  # [B, S]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    o = o * (lengths.to(q.device) > 0)[:, None, None, None]   # empty rows
    return o.reshape(B, H, hd).to(q.dtype)


def _dense_launcher():
    fn = build.library("paged_decode.cu").decode_attention_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       i, i, i, ctypes.c_float, ctypes.c_float, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _dense_launch(q, k_cache, v_cache, k_scale, v_scale, lengths, block_s,
                  max_len, plan_scale, softcap) -> torch.Tensor:
    """Launch the contiguous-layout kernel on checked operands (either
    branch)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    operands = [q, k_cache, v_cache, lengths]
    if k_scale is not None:
        operands += [k_scale, v_scale]
    for t in operands:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")
    B, H, hd = q.shape
    S, KH = k_cache.shape[1:3]
    if hd > MAX_HD:
        raise ValueError(f"kernel takes hd <= {MAX_HD}, got hd={hd}")
    hg = head_groups(H // KH)
    n_cols = _sweep_cols(S, block_s, max_len)
    n_split, c, ws, cnt = _split_args(q.device, n_cols, S, B * KH * hg,
                                      None, H // KH // hg, hd, plan_scale)
    out = torch.empty_like(q)
    quant = k_scale is not None
    err = _dense_launcher()(q.data_ptr(), k_cache.data_ptr(),
                            v_cache.data_ptr(),
                            k_scale.data_ptr() if quant else None,
                            v_scale.data_ptr() if quant else None,
                            lengths.data_ptr(), out.data_ptr(),
                            ws.data_ptr() if n_split > 1 else None,
                            cnt.data_ptr() if n_split > 1 else None, B, H,
                            KH, hd, S, n_cols, hg, n_split, c, hd ** -0.5,
                            _cap(softcap), _DTYPES[q.dtype],
                            _INT8 if quant else _DTYPES[q.dtype],
                            _vector_rows(hd, k_cache, v_cache),
                            build.cuda_stream(q))
    build.check(err, "decode_attention")
    return out


def decode_attention_int8(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, lengths: torch.Tensor, *,
                          block_s: int = 512,
                          max_len: Optional[int] = None,
                          plan_scale: int = 1,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The int8 branch: caches int8 [B, S, KH, hd] with fp32 scales
    [B, S, KH, 1], dequantized per row inside the softmax loop; otherwise
    as ``decode_attention``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    _check_dense(q, k_cache, v_cache, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      block_s=block_s, max_len=max_len,
                                      k_scale=k_scale, v_scale=v_scale,
                                      softcap=softcap)
    out = _dense_launch(q, k_cache, v_cache, k_scale, v_scale, lengths,
                        block_s, max_len, plan_scale, softcap)
    decode_attention_int8.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     block_s: int = 512, max_len: Optional[int] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     plan_scale: int = 1,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Flash-decode over a contiguous cache, the reference's signature.

    q [B, H, hd]; caches [B, S, KH, hd] (the tracks of a PT layer folded
    into B); lengths [B] int32 live tokens; ``max_len`` (host-known
    bound on lengths) cuts the sweep to ceil(max_len / block_s) tiles of
    ``min(block_s, S)`` columns.  int8 caches pass their ``k_scale`` /
    ``v_scale`` [B, S, KH, 1] and go to ``decode_attention_int8``.
    ``plan_scale`` as in ``paged_decode_attention`` (on a track rank the
    rows are its n/W tracks' folded rows); ``softcap`` the tanh logit
    cap.  Returns [B, H, hd].  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if k_scale is not None or v_scale is not None:
        return decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale,
                                     lengths, block_s=block_s,
                                     max_len=max_len, plan_scale=plan_scale,
                                     softcap=softcap)
    _check_dense(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      block_s=block_s, max_len=max_len,
                                      softcap=softcap)
    out = _dense_launch(q, k_cache, v_cache, None, None, lengths, block_s,
                        max_len, plan_scale, softcap)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention_int8.launches = 0
