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

Not ported (each raises): sliding windows and ring caches, logit
softcap on the decode and chunk paths, qk-norm, M-RoPE,
cross-attention.
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
from repro_torch.models.params import Leaf


def attention_shapes(d_stream: int, n_heads: int, n_kv_heads: int,
                     head_dim: int):
    """Per-track weight shapes and init std (normal * std), as
    ``repro.models.attention.attention_init`` draws them."""
    s_in = 1.0 / d_stream ** 0.5
    s_out = 1.0 / (n_heads * head_dim) ** 0.5
    return {"wq": Leaf((d_stream, n_heads, head_dim), s_in),
            "wk": Leaf((d_stream, n_kv_heads, head_dim), s_in),
            "wv": Leaf((d_stream, n_kv_heads, head_dim), s_in),
            "wo": Leaf((n_heads, head_dim, d_stream), s_out)}


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x [n, B, S, d] -> q [n, B, S, H, hd], k/v [n, B, S, KH, hd], RoPE
    (theta = cfg.rope_theta) applied to q and k in fp32."""
    n, B, S, d = x.shape
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    q = matmul(x, as_matrix(wq, d)).reshape(n, B, S, *wq.shape[2:])
    k = matmul(x, as_matrix(wk, d)).reshape(n, B, S, *wk.shape[2:])
    v = matmul(x, as_matrix(wv, d)).reshape(n, B, S, *wv.shape[2:])
    cos, sin = rope_lib.rope_cos_sin(positions, wq.shape[-1], cfg.rope_theta)
    return rope_lib.apply_rope(q, cos, sin), rope_lib.apply_rope(k, cos, sin), v


def _out_proj(params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [n, ..., H, hd] -> [n, ..., d] (contracts heads and head dim)."""
    wo = params["wo"]
    _, H, hd, _ = wo.shape
    return matmul(ctx.reshape(*ctx.shape[:-2], H * hd),
                  as_matrix(wo, H * hd))


def attention_apply(params, x: torch.Tensor, *, spec: LayerSpec,
                    cfg: ModelConfig, positions: torch.Tensor,
                    return_cache: bool = False):
    """Causal self-attention over x [n, B, S, d] through the flash kernel
    (tracks flattened into its batch).  Returns (out [n, B, S, d],
    (k, v) [n, B, S, KH, hd] with RoPE applied, or None)."""
    if spec.window is not None:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "(ROADMAP queue 1, item 3)")
    n, B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    H, hd = q.shape[-2:]
    KH = k.shape[-2]
    ctx = ops.flash_attention(q.reshape(n * B, S, H, hd),
                              k.reshape(n * B, S, KH, hd),
                              v.reshape(n * B, S, KH, hd),
                              causal=spec.causal,
                              softcap=spec.attn_logit_softcap)
    out = _out_proj(params, ctx.reshape(n, B, S, H, hd))
    return out, ((k, v) if return_cache else None)


def pool_write(leaf: PagedLeaf, rows: torch.Tensor,
               w_idx: torch.Tensor) -> PagedLeaf:
    """Write rows [n, M, KH, hd] into one layer's pool [n, N, bs, KH, hd]
    at flat pool rows ``w_idx`` [M], in place (the JAX version returns a
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
    layer's pool [n, N, bs, KH, hd] through block_table [B, nmax];
    int8 leaves come back dequantized to fp32."""
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
    Returns (out [n, B, 1, d], (k_leaf, v_leaf))."""
    if block_table is None:
        raise ValueError("paged cache leaf but no block_table passed")
    if spec.attn_logit_softcap is not None:
        raise NotImplementedError("logit softcap on the decode paths is "
                                  "not ported (ROADMAP queue 1, item 3)")
    bs = k_leaf.pool.shape[2]
    w_idx = token_to_pool(block_table, pos[:, None], bs)[:, 0]
    pool_write(k_leaf, k_new, w_idx)
    pool_write(v_leaf, v_new, w_idx)
    ctx = ops.paged_decode_attention(q, k_leaf.pool, v_leaf.pool,
                                     block_table, (pos + 1).to(torch.int32),
                                     max_len=kv_max_len,
                                     k_scale=k_leaf.scale,
                                     v_scale=v_leaf.scale,
                                     plan_scale=plan_scale)
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
    Returns (out [n, B, 1, d], (k_cache, v_cache))."""
    if spec.attn_logit_softcap is not None:
        raise NotImplementedError("logit softcap on the decode paths is "
                                  "not ported (ROADMAP queue 1, item 3)")
    n, B, S, KH, hd = k_cache.shape
    H = q.shape[2]
    b = torch.arange(B, device=pos.device)
    slot = pos.long().clamp(max=S - 1)
    keep = pos < S
    if active is not None:
        keep = keep & active
    keep = keep[None, :, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[:, b, slot] = torch.where(keep, new.to(cache.dtype),
                                        cache[:, b, slot])
    lengths = (pos + 1).to(torch.int32).repeat(n)
    ctx = ops.decode_attention(q.reshape(n * B, H, hd),
                               k_cache.view(n * B, S, KH, hd),
                               v_cache.view(n * B, S, KH, hd), lengths,
                               max_len=kv_max_len, plan_scale=plan_scale)
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
    q, k_new, v_new = _project_qkv(params, x, cfg, pos[:, None])
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


def _causal_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, round_dtype: torch.dtype
                ) -> torch.Tensor:
    """Masked grouped softmax in fp32, the reference's jnp chunk
    attention: q [n, B, C, H, hd]; k, v [n, B, S, KH, hd]; query (b, c)
    sees columns <= positions[b, c].  The scaled q and the probabilities
    are rounded to ``round_dtype`` before their products, as the
    reference's branch does (the paged branch to the cache dtype, the
    contiguous one to fp32).  Returns ctx [n, B, C, H, hd] fp32."""
    n, B, C, H, hd = q.shape
    S, KH = k.shape[2:4]
    qg = (q * hd ** -0.5).to(round_dtype).reshape(n, B, C, KH, H // KH, hd)
    s = torch.einsum("nbckgd,nbskd->nbckgs", qg.float(), k.float())
    cols = torch.arange(S, device=q.device)
    mask = cols[None, None, :] <= positions[:, :, None]          # [B, C, S]
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


def attention_chunk(params, x: torch.Tensor, cache: Tuple[Any, Any], *,
                    spec: LayerSpec, cfg: ModelConfig, pos: torch.Tensor,
                    block_table: Optional[torch.Tensor] = None,
                    kv_max_len: Optional[int] = None):
    """Chunked prefill or the K+1-token verify: C new tokens per row.

    x [n, B, C, d]; pos [B] int32 position of each row's first chunk
    token; cache: this layer's (k, v) pools, or its contiguous rows
    [n, B, S, KH, hd] aligned with the batch (the speculative drafter's
    cache; the reference's ``_dense_chunk``).  The chunk's K/V rows are
    written first: through the block table (rows past a prompt's end land
    in owned or trash blocks and sit causally after every real query), or
    at [:, b, pos[b] + c] in the rows (dropped at or past S).  Then every
    chunk row attends causally over the gathered (and, for int8 pools,
    dequantized) per-slot view, or over the whole of its rows, as the
    reference computes it in jnp: plain PyTorch, masked grouped softmax
    in fp32, over the whole table row: ``kv_max_len`` (host-known bound
    on pos + C) cuts nothing, so that a row's result does not depend on
    the bound (the pipelined engine's speculative steps take a wider one
    than the sync engine's), as on the reference's jnp path, which is
    given none.  Returns (out [n, B, C, d], cache)."""
    k_leaf, v_leaf = cache
    if is_paged(k_leaf) and block_table is None:
        raise ValueError("attention_chunk on a paged cache requires a "
                         "block_table")
    if spec.window is not None or spec.attn_logit_softcap is not None:
        raise NotImplementedError("windows and logit softcap on the chunk "
                                  "path are not ported (ROADMAP queue 1, "
                                  "item 3)")
    n, B, C, _ = x.shape
    positions = pos[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=x.device)[None]             # [B, C]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    H, hd = q.shape[-2:]
    KH = k_new.shape[-2]
    if not is_paged(k_leaf):
        _dense_chunk_write(k_leaf, v_leaf, k_new, v_new, positions)
        ctx = _causal_ctx(q, k_leaf, v_leaf, positions, torch.float32)
        return _out_proj(params, ctx.to(x.dtype)), (k_leaf, v_leaf)
    bs = k_leaf.pool.shape[2]
    w_idx = token_to_pool(block_table, positions, bs).reshape(-1)
    pool_write(k_leaf, k_new.reshape(n, B * C, KH, hd), w_idx)
    pool_write(v_leaf, v_new.reshape(n, B * C, KH, hd), w_idx)
    k_g = pool_read(k_leaf, block_table)               # [n, B, S, KH, hd]
    v_g = pool_read(v_leaf, block_table)
    ctx = _causal_ctx(q, k_g, v_g, positions, k_g.dtype)
    out = _out_proj(params, ctx.to(x.dtype))
    return out, (k_leaf, v_leaf)
