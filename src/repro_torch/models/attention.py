"""GQA attention over the stacked track dim: whole-prompt prefill through
the flash-attention kernel, decode through the paged-decode kernel
(either branch: fp or int8 pools) or, on the contiguous cache, through
the contiguous-cache decode kernel, chunked prefill and the speculative
verify against the pools, and the drafter's chunk fill of its
contiguous rows (counterpart of ``repro.models.attention``).

Layout conventions (JAX layouts, with a leading track dim n; a layer of
the dense ``lm_*`` decoder comes here as n = 1 views):
- activations: x [n, B, S, d]
- weights    : wq [n, d, H, hd]; wk/wv [n, d, KH, hd]; wo [n, H, hd, d]
- K/V pools  : [n, N, bs, KH, hd] (one layer's slice of the engine pool),
               RoPE already applied to K.
- contiguous : [n, B, S, KH, hd] per-slot rows (one layer's slice of the
               contiguous engine cache), RoPE already applied to K.
Every projection is one batched GEMM over the tracks, every attention
call one kernel launch for all tracks.  int8 weights (``QuantTensor``)
take the W8A16 kernel in every projection, ``wq``/``wk``/``wv`` and
``wo`` too, where the reference dequantizes in jnp; the output stays in
the activation dtype.  int8 pools (``PagedLeaf.scale``) quantize rows on
write and dequantize on read.

Layer features (gemma2 / gemma3, qwen2-vl): M-RoPE (the (t, h, w)
position streams of ``rope="mrope"`` layers; decode and chunks, which
see text, take three equal streams), qk-norm (an RMSNorm of each q and k
head before RoPE, through the RMSNorm kernel), RoPE at the local theta
on ``rope="local_rope"`` layers, the tanh logit softcap on every path,
and sliding windows.  A windowed layer's prefill runs the flash kernel
with its ``window``; its cache is a ring of W = window rows per slot
(slot = position % W; ``_to_ring_per_row`` builds it from right-padded
prefill rows) when W is shorter than the cache, which decodes on the
contiguous decode kernel over ``min(pos + 1, W)`` slots and takes
chunks in plain PyTorch (``_ring_chunk``, as the reference computes it
in jnp).  A window that covers the cache stays a plain (paged or
contiguous) cache with the window mask.

The chunk program of a prompt (``prefill=True``: chunked prefill, the
warm tail behind a prefix-cache hit) over an fp pool on the card runs
the flash kernel with per-row query offsets over the row's gathered
K/V, so that a prompt's K/V and first token do not depend on how much
of it came from the prefix cache (flash sums each row over the same key
tiles in the same order whatever its offset).  The verify, int8 pools
and the CPU keep the reference's plain masked softmax.

Cross-attention (whisper's decoder, ``cross_kv`` and
``cross_attention_apply``): the encoder's K/V are projected once, at
prefill, and kept in the layer's cache, which no later step writes; a
prefill or a chunk attends over them on the flash kernel with no causal
mask, a decode step on the contiguous decode kernel with every row's
length the encoder's.  Layers with ``rope="none"`` (whisper) take no
RoPE.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.common.paged import PagedLeaf, is_paged, token_to_pool
from repro_torch.common.quant import (as_matrix, dequantize_rows, matmul,
                                      quantize_rows)
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.models import rope as rope_lib
from repro_torch.models.norms import plain_rmsnorm, rmsnorm
from repro_torch.models.params import Leaf


def attention_shapes(d_stream: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, qk_norm: bool = False):
    """Per-track weight shapes and init std (normal * std), as
    ``repro.models.attention.attention_init`` draws them; with
    ``qk_norm`` the q and k heads' RMSNorm scales [hd] (fp32 zeros)."""
    s_in = 1.0 / d_stream ** 0.5
    s_out = 1.0 / (n_heads * head_dim) ** 0.5
    p = {"wq": Leaf((d_stream, n_heads, head_dim), s_in),
         "wk": Leaf((d_stream, n_kv_heads, head_dim), s_in),
         "wv": Leaf((d_stream, n_kv_heads, head_dim), s_in),
         "wo": Leaf((n_heads, head_dim, d_stream), s_out)}
    if qk_norm:
        p["q_norm"] = {"scale": Leaf((head_dim,))}
        p["k_norm"] = {"scale": Leaf((head_dim,))}
    return p


def rope_theta(spec: LayerSpec, cfg: ModelConfig) -> float:
    """The RoPE base of a layer: ``local_rope_theta`` on local layers."""
    return cfg.local_rope_theta if spec.rope == "local_rope" \
        else cfg.rope_theta


def _project_qkv(params, x: torch.Tensor, spec: LayerSpec,
                 cfg: ModelConfig, positions: torch.Tensor, qk_norm=rmsnorm):
    """x [n, B, S, d] -> q [n, B, S, H, hd], k/v [n, B, S, KH, hd]: the
    projections, qk-norm (``cfg.qk_norm``; ``qk_norm`` the norm function,
    the kernel's by default), then RoPE (or M-RoPE) at the layer's theta
    applied to q and k in fp32 (``rope_tables``; none where the layer's
    ``rope`` is "none")."""
    q, k, v = (_project(params[w], x) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = qk_norm(params["q_norm"], q, eps=cfg.norm_eps)
        k = qk_norm(params["k_norm"], k, eps=cfg.norm_eps)
    if spec.rope == "none":
        return q, k, v
    cos, sin = rope_tables(spec, cfg, positions, q.shape[-1])
    return rope_lib.apply_rope(q, cos, sin), rope_lib.apply_rope(k, cos, sin), v


def _project(w, x: torch.Tensor) -> torch.Tensor:
    """x [n, B, S, d] times a head projection w [n, d, H, hd] -> [n, B, S,
    H, hd]."""
    n, B, S, d = x.shape
    return matmul(x, as_matrix(w, d)).reshape(n, B, S, *w.shape[2:])


def rope_tables(spec: LayerSpec, cfg: ModelConfig, positions: torch.Tensor,
                head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [B, S, hd/2] of a layer at ``positions``: [B, S], or
    [3, B, S] (t, h, w) streams, which an M-RoPE layer reads (2-D
    positions give it three equal streams, as text does) and a plain
    RoPE layer reads the first of (the reference's ``_rope_tables``)."""
    theta = rope_theta(spec, cfg)
    if spec.rope == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return rope_lib.mrope_cos_sin(positions, head_dim, theta,
                                      cfg.mrope_sections)
    if positions.dim() == 3:
        positions = positions[0]
    return rope_lib.rope_cos_sin(positions, head_dim, theta)


def is_ring(spec: LayerSpec, cache_len: int) -> bool:
    """A windowed layer's cache of ``cache_len`` rows per slot is a ring
    (slot = position % cache_len) when the window covers it; else it is
    a plain cache (the reference's ``S_cache <= window`` rule)."""
    return spec.window is not None and cache_len <= spec.window


def _out_proj(params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [n, ..., H, hd] -> [n, ..., d] (contracts heads and head dim)."""
    wo = params["wo"]
    _, H, hd, _ = wo.shape
    return matmul(ctx.reshape(*ctx.shape[:-2], H * hd),
                  as_matrix(wo, H * hd))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_start: int = 0,
                        chunk_q: int = 512, chunk_k: int = 1024
                        ) -> torch.Tensor:
    """Online-softmax attention with static causal / window block
    skipping (the reference's ``blockwise_attention``, the train path's
    attention): q [B, Sq, H, hd], k [B, Sk, H, hd], v [B, Sk, H, dv]
    (K/V already expanded to H heads; dv <= hd, as MLA's).  q row i sits
    at position q_start + i, key j at j.  The q chunks and each chunk's
    key range are static, whole key chunks outside the causal / window
    range are skipped, and scores, max, sum and accumulator are fp32 with
    the reference's NEG_INF mask and its clamp of the sum at 1e-37.
    Every op returns a new tensor, so autograd differentiates it."""
    B, Sq, H, hd = q.shape
    Sk, dv = k.shape[1], v.shape[-1]
    scale = hd ** -0.5
    cq = chunk_q if Sq % chunk_q == 0 else Sq
    ck = chunk_k if Sk % chunk_k == 0 else Sk
    dev = q.device
    out = []
    for i in range(Sq // cq):
        q_lo = q_start + i * cq                    # position of the first row
        q_hi = q_start + (i + 1) * cq - 1          # and of the last
        k_hi = min(Sk, q_hi + 1) if causal else Sk
        k_lo = max(0, q_lo - window + 1) if window is not None else 0
        k_lo = (k_lo // ck) * ck                   # whole key chunks
        k_hi = min(Sk, ((k_hi + ck - 1) // ck) * ck)
        if k_hi <= k_lo:
            out.append(torch.zeros(B, cq, H, dv, dtype=q.dtype, device=dev))
            continue
        qi = q[:, i * cq:(i + 1) * cq].float() * scale
        q_pos = q_lo + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros(B, H, cq, dtype=torch.float32, device=dev)
        acc = torch.zeros(B, H, cq, dv, dtype=torch.float32, device=dev)
        for lo in range(k_lo, k_hi, ck):
            s = torch.einsum("bqhd,bkhd->bhqk", qi,
                             k[:, lo:lo + ck].float())
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            k_pos = lo + torch.arange(ck, device=dev)
            mask = torch.ones(cq, ck, dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v[:, lo:lo + ck].float())
            m = m_new
        l = torch.clamp_min(l, 1e-37)
        out.append((acc / l[..., None]).to(q.dtype).movedim(1, 2))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[..., KH, hd] -> [..., H, hd]: KV head h // (H / KH) for query
    head h (the reference's static gather), as a broadcast copy, whose
    backward is a sum over each KV head's G query heads (no atomics, so
    the same bits every run)."""
    *lead, kh, hd = k.shape
    g = n_heads // kh
    return k[..., None, :].expand(*lead, kh, g, hd).reshape(*lead, kh * g,
                                                            hd)


def _attention_train(params, x: torch.Tensor, spec: LayerSpec,
                     cfg: ModelConfig, positions: torch.Tensor
                     ) -> torch.Tensor:
    """The train path: plain qk-norm, K/V expanded to the query heads and
    ``blockwise_attention`` (tracks flattened into its batch); no kernel
    wrapper, no cache."""
    n, B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, spec, cfg, positions,
                           qk_norm=plain_rmsnorm)
    H, hd = q.shape[-2:]
    ctx = blockwise_attention(
        q.reshape(n * B, S, H, hd),
        _expand_kv(k, H).reshape(n * B, S, H, hd),
        _expand_kv(v, H).reshape(n * B, S, H, v.shape[-1]),
        causal=spec.causal, window=spec.window,
        softcap=spec.attn_logit_softcap, chunk_q=cfg.attn_chunk_q,
        chunk_k=cfg.attn_chunk_k)
    return _out_proj(params, ctx.reshape(n, B, S, H, v.shape[-1]))


def attention_apply(params, x: torch.Tensor, *, spec: LayerSpec,
                    cfg: ModelConfig, positions: torch.Tensor,
                    return_cache: bool = False,
                    lengths: Optional[torch.Tensor] = None,
                    train: bool = False):
    """Causal (windowed) self-attention over x [n, B, S, d] at
    ``positions`` [B, S] (or M-RoPE streams [3, B, S]) through the
    flash kernel (tracks flattened into its batch).  Returns (out
    [n, B, S, d], cache or None): (k, v) [n, B, S, KH, hd] with RoPE
    applied, or for a window W < S the rings [n, B, W, KH, hd] built from
    each row's true ``lengths`` [B] (default S: no padding).  ``train``:
    the reference's train mode, (out, None) from ``blockwise_attention``
    on plain ops (``_attention_train``)."""
    if train:
        return _attention_train(params, x, spec, cfg, positions), None
    n, B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, spec, cfg, positions)
    H, hd = q.shape[-2:]
    KH = k.shape[-2]
    ctx = ops.flash_attention(q.reshape(n * B, S, H, hd),
                              k.reshape(n * B, S, KH, hd),
                              v.reshape(n * B, S, KH, hd),
                              causal=spec.causal,
                              softcap=spec.attn_logit_softcap,
                              window=spec.window)
    out = _out_proj(params, ctx.reshape(n, B, S, H, hd))
    if not return_cache:
        return out, None
    if spec.window is not None and spec.window < S:
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.long, device=x.device)
        return out, (_to_ring_per_row(k, lengths, spec.window),
                     _to_ring_per_row(v, lengths, spec.window))
    return out, (k, v)


def _to_ring_per_row(k: torch.Tensor, lengths: torch.Tensor,
                     w: int) -> torch.Tensor:
    """The ring [n, B, w, KH, hd] of right-padded prefill rows k
    [n, B, S, KH, hd]: slot j of row b holds the latest real position
    p <= lengths[b] - 1 with p % w == j (zeros where there is none), so
    padding never enters a ring and never evicts a real in-window row."""
    n, B, S = k.shape[:3]
    last = lengths.to(k.device).long()[:, None] - 1               # [B, 1]
    j = torch.arange(w, device=k.device)[None, :]
    src = last - torch.remainder(last - j, w)                     # [B, w]
    idx = src.clamp(0, S - 1)[None, :, :, None, None].expand(
        n, B, w, *k.shape[3:])
    ring = torch.gather(k, 2, idx)
    return torch.where((src >= 0)[None, :, :, None, None], ring,
                       torch.zeros((), dtype=k.dtype, device=k.device))


def pool_write(leaf: PagedLeaf, rows: torch.Tensor,
               w_idx: torch.Tensor) -> PagedLeaf:
    """Write rows [n, M, KH, hd] into one layer's pool [n, N, bs, KH, hd]
    (or an MLA latent pool's rows [n, M, r] into [n, N, bs, r]: any
    trailing shape) at flat pool rows ``w_idx`` [M], in place (the JAX version returns a
    new pool; updating in place saves a pool-sized copy per token).  An
    int8 leaf quantizes each row over hd and writes payload and scale
    through the same indices."""
    def put(pool, r):
        flat = pool.view(pool.shape[0], -1, *pool.shape[3:])
        flat[:, w_idx] = r.to(pool.dtype)

    if leaf.scale is not None:
        payload, scale = quantize_rows(rows.float())
        put(leaf.pool, payload)
        put(leaf.scale, scale)
    else:
        put(leaf.pool, rows)
    return leaf


def pool_read(leaf: PagedLeaf, block_table: torch.Tensor) -> torch.Tensor:
    """The contiguous per-slot view [n, B, nmax * bs, KH, hd] of one
    layer's pool [n, N, bs, KH, hd] through block_table [B, nmax] (an
    MLA latent pool [n, N, bs, r] gives [n, B, nmax * bs, r]); int8
    leaves come back dequantized to fp32."""
    n, _, bs = leaf.pool.shape[:3]
    B, nmax = block_table.shape
    tbl = block_table.long()

    def gather(pool):
        return pool[:, tbl].reshape(n, B, nmax * bs, *pool.shape[3:])

    if leaf.scale is None:
        return gather(leaf.pool)
    return dequantize_rows(gather(leaf.pool), gather(leaf.scale))


def _paged_decode(params, q: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, k_leaf: PagedLeaf, v_leaf: PagedLeaf,
                  *, spec: LayerSpec, pos: torch.Tensor,
                  block_table: torch.Tensor, kv_max_len: Optional[int],
                  out_dtype: torch.dtype, plan_scale: int):
    """Decode step against block pools.  q [n, B, H, hd]; k_new/v_new
    [n, B, KH, hd]; pools [n, N, bs, KH, hd]; block_table [B, nmax]
    int32 shared by the tracks; pos [B] int32 (the new token's index).

    Write-before-read, as in the reference: the new K/V rows land first
    (inactive lanes carry zeroed table rows, so theirs land in the trash
    block), then the kernel attends over ``lengths = pos + 1`` columns.
    A windowed layer is paged only when its window covers the cache, so
    the window masks nothing here.  Returns (out [n, B, 1, d],
    (k_leaf, v_leaf))."""
    if block_table is None:
        raise ValueError("paged cache leaf but no block_table passed")
    bs = k_leaf.pool.shape[2]
    w_idx = token_to_pool(block_table, pos[:, None], bs)[:, 0]
    pool_write(k_leaf, k_new, w_idx)
    pool_write(v_leaf, v_new, w_idx)
    ctx = ops.paged_decode_attention(q, k_leaf.pool, v_leaf.pool,
                                     block_table, (pos + 1).to(torch.int32),
                                     max_len=kv_max_len,
                                     k_scale=k_leaf.scale,
                                     v_scale=v_leaf.scale,
                                     plan_scale=plan_scale,
                                     softcap=spec.attn_logit_softcap)
    out = _out_proj(params, ctx.to(out_dtype))[:, :, None]
    return out, (k_leaf, v_leaf)


def _dense_decode(params, q: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, *, spec: LayerSpec,
                  pos: torch.Tensor, active: Optional[torch.Tensor],
                  kv_max_len: Optional[int], out_dtype: torch.dtype,
                  plan_scale: int):
    """Decode step against contiguous per-slot rows (the reference's
    dense branch with ``_scatter_cache``).  q [n, B, H, hd]; k_new/v_new
    [n, B, KH, hd]; caches [n, B, S, KH, hd]; pos [B] int32.

    The new K/V row lands in place at [:, b, pos[b]] first.  A lane
    with ``active`` false keeps its old row, and so does a lane whose
    pos lies past the cache (a finished slot's pos may reach S): the
    reference's scatter drops that write.  Then the kernel attends, the
    tracks folded into its batch, over ``lengths = pos + 1`` columns.

    A ring (``is_ring``: a window covering the S rows) takes the row at
    slot pos % S, and the kernel attends over its first min(pos + 1, S)
    slots: every stored position lies in the window, so that is the
    reference's masked ring attention (a softmax does not depend on the
    order of its columns).  Returns (out [n, B, 1, d], (k_cache,
    v_cache))."""
    n, B, S, KH, hd = k_cache.shape
    H = q.shape[2]
    b = torch.arange(B, device=pos.device)
    ring = is_ring(spec, S)
    if ring:
        slot = torch.remainder(pos.long(), S)
        keep = torch.ones_like(pos, dtype=torch.bool)
        lengths = torch.clamp(pos + 1, max=S)
    else:
        slot = pos.long().clamp(max=S - 1)
        keep = pos < S
        lengths = pos + 1
    if active is not None:
        keep = keep & active
    keep = keep[None, :, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[:, b, slot] = torch.where(keep, new.to(cache.dtype),
                                        cache[:, b, slot])
    lengths = lengths.to(torch.int32).repeat(n)
    ctx = ops.decode_attention(q.reshape(n * B, H, hd),
                               k_cache.view(n * B, S, KH, hd),
                               v_cache.view(n * B, S, KH, hd), lengths,
                               max_len=kv_max_len, plan_scale=plan_scale,
                               softcap=spec.attn_logit_softcap)
    out = _out_proj(params, ctx.reshape(n, B, H, hd).to(out_dtype))
    return out[:, :, None], (k_cache, v_cache)


def attention_decode(params, x: torch.Tensor, cache: Tuple[Any, Any], *,
                     spec: LayerSpec, cfg: ModelConfig, pos: torch.Tensor,
                     block_table: Optional[torch.Tensor] = None,
                     kv_max_len: Optional[int] = None,
                     active: Optional[torch.Tensor] = None):
    """x [n, B, 1, d]; cache: this layer's (k, v) block pools, or its
    contiguous rows [n, B, S, KH, hd]; pos [B] int32.  ``kv_max_len``
    (host-known bound on pos + 1) cuts the kernel's sweep to the live
    prefix.  ``active`` [B] bool keeps the contiguous rows of inactive
    lanes (pool leaves are protected by their zeroed table rows).  On a
    track rank x holds n/W of the model's n tracks, and the kernel plans
    its split for all n (``plan_scale`` W), as one process's launch.
    Returns (out [n, B, 1, d], cache)."""
    k_leaf, v_leaf = cache
    q, k_new, v_new = _project_qkv(params, x, spec, cfg, pos[:, None])
    plan_scale = 1
    if cfg.pt is not None:
        plan_scale, rem = divmod(cfg.pt.n_tracks, x.shape[0])
        if rem or not plan_scale:
            raise ValueError(f"{x.shape[0]} tracks is no rank's share of "
                             f"{cfg.pt.n_tracks}")
    if not is_paged(k_leaf):
        return _dense_decode(params, q[:, :, 0], k_new[:, :, 0],
                             v_new[:, :, 0], k_leaf, v_leaf, spec=spec,
                             pos=pos, active=active, kv_max_len=kv_max_len,
                             out_dtype=x.dtype, plan_scale=plan_scale)
    return _paged_decode(params, q[:, :, 0], k_new[:, :, 0], v_new[:, :, 0],
                         k_leaf, v_leaf, spec=spec, pos=pos,
                         block_table=block_table, kv_max_len=kv_max_len,
                         out_dtype=x.dtype, plan_scale=plan_scale)


def _chunk_mask(positions: torch.Tensor, S: int,
                window: Optional[int]) -> torch.Tensor:
    """[B, C, S]: query (b, c) at positions[b, c] sees the columns j <=
    its position, and with a window only j > position - window."""
    cols = torch.arange(S, device=positions.device)[None, None, :]
    mask = cols <= positions[:, :, None]
    if window is not None:
        mask &= cols > positions[:, :, None] - window
    return mask


def _masked_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, round_dtype: torch.dtype,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Masked grouped softmax in fp32, the reference's jnp chunk
    attention: q [n, B, C, H, hd]; k, v [n, B, S, KH, hd]; mask
    [B, C, S] (True: seen).  The scaled q and the probabilities are
    rounded to ``round_dtype`` before their products, as the reference's
    branch does (the paged branch to the cache dtype, the contiguous and
    ring ones to fp32); the softcap applies to the scores before the
    mask.  Returns ctx [n, B, C, H, hd] fp32."""
    n, B, C, H, hd = q.shape
    KH = k.shape[3]
    qg = (q * hd ** -0.5).to(round_dtype).reshape(n, B, C, KH, H // KH, hd)
    s = torch.einsum("nbckgd,nbskd->nbckgs", qg.float(), k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    # in place: at full width the scores are the chunk's largest transient
    s.masked_fill_(~mask[None, :, :, None, None, :], NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    p = s.div_(s.sum(dim=-1, keepdim=True))
    ctx = torch.einsum("nbckgs,nbskd->nbckgd", p.to(round_dtype).float(),
                       v.float())
    return ctx.reshape(n, B, C, H, hd)


def _dense_chunk_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       positions: torch.Tensor) -> None:
    """The chunk's K/V rows [n, B, C, KH, hd] into contiguous rows
    [n, B, S, KH, hd] at [:, b, positions[b, c]], in place; a row whose
    position is >= S is dropped (the reference's ``mode="drop"``).  Each
    row's chunk is contiguous from positions[b, 0], so column s takes
    chunk row s - positions[b, 0] where that lies in [0, C): a select
    over the rows, with no host sync and no colliding scatter indices."""
    n, B, S = k_cache.shape[:3]
    C = positions.shape[1]
    off = (torch.arange(S, device=positions.device)[None, :]
           - positions[:, :1].long())                          # [B, S]
    hit = ((off >= 0) & (off < C))[None, :, :, None, None]
    idx = off.clamp(0, C - 1)[None, :, :, None, None].expand(
        n, B, S, *k_cache.shape[3:])
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        rows = torch.gather(new.to(cache.dtype), 2, idx)
        cache.copy_(torch.where(hit, rows, cache))


def _ring_chunk(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                spec: LayerSpec, pos: torch.Tensor, positions: torch.Tensor,
                slots: Optional[torch.Tensor],
                chunk_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """A chunk against ring rows [n, S_slots, W, KH, hd] (the reference's
    ``_ring_chunk``): the chunk's queries attend to the ring rows of
    their slots (``slots`` [B]; None: the rows align with the batch) as
    they were before the chunk, each slot j holding the position
    p_j = pos - 1 - ((pos - 1 - j) mod W), plus the chunk's own K/V, in
    the window; then each slot takes the chunk's latest valid token
    (``chunk_lens`` [B] valid tokens; default all C) of its residue, in
    place.  Returns ctx [n, B, C, H, hd] fp32."""
    n, B, C = q.shape[:3]
    W = k_cache.shape[2]
    if chunk_lens is None:
        chunk_lens = torch.full_like(pos, C)
    sl = slice(None) if slots is None else slots.long()
    k_rows, v_rows = k_cache[:, sl], v_cache[:, sl]             # [n, B, W]
    j = torch.arange(W, device=q.device)[None, :]
    last_old = pos.long()[:, None] - 1
    p_j = last_old - torch.remainder(last_old - j, W)           # [B, W]
    src_pos = torch.cat([p_j, positions.long()], dim=1)         # [B, W+C]
    src_ok = torch.cat(
        [p_j >= 0, torch.ones_like(positions, dtype=torch.bool)], dim=1)
    at = positions.long()[:, :, None]
    mask = (src_ok[:, None, :] & (src_pos[:, None, :] <= at)
            & (src_pos[:, None, :] > at - spec.window))
    ctx = _masked_ctx(q, torch.cat([k_rows, k_new.to(k_rows.dtype)], dim=2),
                      torch.cat([v_rows, v_new.to(v_rows.dtype)], dim=2),
                      mask, torch.float32, spec.attn_logit_softcap)
    last = pos.long()[:, None] + chunk_lens.long()[:, None] - 1
    q_new = last - torch.remainder(last - j, W)                  # [B, W]
    from_chunk = (q_new >= pos.long()[:, None])[None, :, :, None, None]
    idx = (q_new - pos.long()[:, None]).clamp(0, C - 1)[None, :, :, None,
                                                         None]
    idx = idx.expand(n, B, W, *k_cache.shape[3:])
    for cache, rows, new in ((k_cache, k_rows, k_new), (v_cache, v_rows,
                                                        v_new)):
        upd = torch.gather(new.to(rows.dtype), 2, idx)
        rows = torch.where(from_chunk, upd, rows)
        if slots is None:
            cache.copy_(rows)
        else:
            cache.index_copy_(1, slots.long(), rows)
    return ctx


def _flash_chunk(q: torch.Tensor, k_g: torch.Tensor, v_g: torch.Tensor,
                 spec: LayerSpec, pos: torch.Tensor) -> torch.Tensor:
    """The chunk's attention on the flash kernel: q [n, B, C, H, hd];
    the rows' gathered K/V [n, B, S, KH, hd]; row b's queries at
    pos[b] + c over keys [0, min(pos[b] + C, S)).  Returns ctx
    [n, B, C, H, hd] in q's dtype."""
    n, B, C, H, hd = q.shape
    S, KH = k_g.shape[2:4]
    q_off = pos.to(torch.int32).repeat(n)
    k_len = torch.clamp(pos + C, max=S).to(torch.int32).repeat(n)
    ctx = ops.flash_attention(q.reshape(n * B, C, H, hd),
                              k_g.reshape(n * B, S, KH, hd),
                              v_g.reshape(n * B, S, KH, hd), causal=True,
                              softcap=spec.attn_logit_softcap,
                              window=spec.window, q_offset=q_off,
                              k_lengths=k_len)
    return ctx.reshape(n, B, C, H, hd)


def attention_chunk(params, x: torch.Tensor, cache: Tuple[Any, Any], *,
                    spec: LayerSpec, cfg: ModelConfig, pos: torch.Tensor,
                    block_table: Optional[torch.Tensor] = None,
                    kv_max_len: Optional[int] = None,
                    slots: Optional[torch.Tensor] = None,
                    chunk_lens: Optional[torch.Tensor] = None,
                    prefill: bool = False):
    """Chunked prefill or the K+1-token verify: C new tokens per row.

    x [n, B, C, d]; pos [B] int32 position of each row's first chunk
    token; cache: this layer's (k, v) pools, or its contiguous rows
    [n, B, S, KH, hd] aligned with the batch (the speculative drafter's
    cache; the reference's ``_dense_chunk``), or a windowed layer's ring
    rows (``is_ring``; ``_ring_chunk`` with ``slots`` and
    ``chunk_lens``).  The chunk's K/V rows are written first: through
    the block table (rows past a prompt's end land in owned or trash
    blocks and sit causally after every real query), or at [:, b,
    pos[b] + c] in the rows (dropped at or past S).  Then every chunk row
    attends causally (and in its window) over the gathered (and, for
    int8 pools, dequantized) per-slot view, or over the whole of its
    rows, as the reference computes it in jnp: plain PyTorch, masked
    grouped softmax in fp32, over the whole table row: ``kv_max_len``
    (host-known bound on pos + C) cuts nothing, so that a row's result
    does not depend on the bound (the pipelined engine's speculative
    steps take a wider one than the sync engine's), as on the reference's
    jnp path, which is given none.  With ``prefill`` (the chunk program
    of a prompt) an fp pool on the card takes the flash kernel instead
    (``_flash_chunk``), over the same gathered rows.  Returns (out
    [n, B, C, d], cache)."""
    k_leaf, v_leaf = cache
    if is_paged(k_leaf) and block_table is None:
        raise ValueError("attention_chunk on a paged cache requires a "
                         "block_table")
    n, B, C, _ = x.shape
    positions = pos[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=x.device)[None]             # [B, C]
    q, k_new, v_new = _project_qkv(params, x, spec, cfg, positions)
    H, hd = q.shape[-2:]
    KH = k_new.shape[-2]
    cap = spec.attn_logit_softcap
    if not is_paged(k_leaf):
        if is_ring(spec, k_leaf.shape[2]):
            ctx = _ring_chunk(q, k_new, v_new, k_leaf, v_leaf, spec=spec,
                              pos=pos, positions=positions, slots=slots,
                              chunk_lens=chunk_lens)
            return _out_proj(params, ctx.to(x.dtype)), (k_leaf, v_leaf)
        _dense_chunk_write(k_leaf, v_leaf, k_new, v_new, positions)
        mask = _chunk_mask(positions, k_leaf.shape[2], spec.window)
        ctx = _masked_ctx(q, k_leaf, v_leaf, mask, torch.float32, cap)
        return _out_proj(params, ctx.to(x.dtype)), (k_leaf, v_leaf)
    bs = k_leaf.pool.shape[2]
    w_idx = token_to_pool(block_table, positions, bs).reshape(-1)
    pool_write(k_leaf, k_new.reshape(n, B * C, KH, hd), w_idx)
    pool_write(v_leaf, v_new.reshape(n, B * C, KH, hd), w_idx)
    k_g = pool_read(k_leaf, block_table)               # [n, B, S, KH, hd]
    v_g = pool_read(v_leaf, block_table)
    if prefill and k_leaf.scale is None and q.is_cuda:
        ctx = _flash_chunk(q, k_g, v_g, spec, pos)
    else:
        mask = _chunk_mask(positions, k_g.shape[2], spec.window)
        ctx = _masked_ctx(q, k_g, v_g, mask, k_g.dtype, cap)
    out = _out_proj(params, ctx.to(x.dtype))
    return out, (k_leaf, v_leaf)


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder)
# ---------------------------------------------------------------------------

def cross_kv(params, enc_states: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's output projected once (the reference's ``cross_kv``):
    enc_states [n, B, S_enc, d] -> (k, v) [n, B, S_enc, KH, hd], no RoPE."""
    return _project(params["wk"], enc_states), _project(params["wv"],
                                                         enc_states)


def cross_attention_apply(params, x: torch.Tensor,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor], *,
                          cfg: ModelConfig, mode: str) -> torch.Tensor:
    """x [n, B, S, d] attends over the encoder's (k, v) [n, B, S_enc, KH,
    hd] with no mask (the reference's ``cross_attention_apply``): mode
    'decode' (S = 1) on the contiguous decode kernel, every row's length
    S_enc and nothing written; 'train' on ``blockwise_attention`` (plain
    ops, K/V expanded to the query heads); any other mode (prefill, a
    chunk) on the flash kernel with ``causal=False``, tracks folded into
    the batch.  Returns [n, B, S, d]."""
    q = _project(params["wq"], x)
    k, v = enc_kv
    n, B, S, H, hd = q.shape
    Se, KH = k.shape[2:4]
    if mode == "train":
        ctx = blockwise_attention(
            q.reshape(n * B, S, H, hd),
            _expand_kv(k, H).reshape(n * B, Se, H, hd),
            _expand_kv(v, H).reshape(n * B, Se, H, hd), causal=False,
            chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
    elif mode == "decode":
        lengths = torch.full((n * B,), Se, dtype=torch.int32,
                             device=q.device)
        ctx = ops.decode_attention(q.reshape(n * B, H, hd),
                                   k.reshape(n * B, Se, KH, hd),
                                   v.reshape(n * B, Se, KH, hd), lengths)
    else:
        ctx = ops.flash_attention(q.reshape(n * B, S, H, hd),
                                  k.reshape(n * B, Se, KH, hd),
                                  v.reshape(n * B, Se, KH, hd), causal=False)
    return _out_proj(params, ctx.reshape(n, B, S, H, hd))
