"""Multi-head Latent Attention, DeepSeek-V2 / -V3 (counterpart of
``repro.models.mla``), in the dense ``lm_*`` decoder: x [B, S, d].

Prefill decompresses the latent K/V per head and runs causal attention
on the flash kernel at q/k width nope + rope (192) and value width
``v_head_dim`` (128), where the reference runs its jnp
``blockwise_attention``; the scale is (nope + rope) ** -0.5 in both.
Decode is the reference's "absorbed" form, as it computes it (plain
PyTorch products; the reference has no kernel for it): q_abs = q_nope
W_uk in fp32, cast to the cache dtype; scores against the latent c_kv
plus the shared k_rope, fp32, masked by position; the context in the
latent space, cast to the activation dtype before W_uv.  So the cache
holds kv_lora_rank + qk_rope_head_dim values per token and layer (576
at full width), with no per-head K/V and no KV-head axis.

Cache layouts: contiguous per-slot rows (c_kv [B, S, r], k_rope [B, S,
rr]), written at each row's position (dropped at or past S, the
reference's scatter) unless the lane is inactive (``active``: the
reference writes every lane, but the port's step programs run their
warm-up and capture with every lane idle, and must leave live rows as
they are; a paged lane is kept out by its zeroed table row instead), or
the paged engine's latent pools ([N, bs, r] and [N, bs,
rr] ``PagedLeaf``s) written and read through the block table.  The
paged read gathers every table column whatever ``kv_max_len`` says, as
the plain attention versions do: the columns past a row's position are
masked to exact zeros, and a sync step and a planned one (whose bounds
differ) then contract over the same columns, so no bound changes a
bit.  RMSNorms (q_norm over q_lora_rank, kv_norm over kv_lora_rank) run
on the RMSNorm kernel's ``norm`` route.

Train mode (``mla_apply(train=True)``) is the reference's ``mla_apply``
on plain ops, for autograd: the latent norms plain (``plain_rmsnorm``),
attention the reference's ``blockwise_attention`` at its
``attn_chunk_q`` / ``attn_chunk_k``, no kernel wrapper.

The chunk step (``mla_chunk``: chunked prefill, prefix-cache tails,
the speculative verify) is reached by no config: every MLA config
served has MoE layers, which turn those features off
(``arch_capabilities``).  It raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.paged import PagedLeaf, is_paged, token_to_pool
from repro_torch.common.quant import as_matrix, matmul
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.models import rope as rope_lib
from repro_torch.models.attention import (blockwise_attention, pool_read,
                                          pool_write)
from repro_torch.models.norms import plain_rmsnorm, rmsnorm
from repro_torch.models.params import Leaf


def mla_shapes(cfg: ModelConfig, d_stream: int) -> Dict[str, Any]:
    """The mixer's leaves, as ``repro.models.mla.mla_init`` draws them:
    w_dq [d, qr], q_norm, w_uq [qr, H, nope + rope] (or w_uq [d, H, nope
    + rope] when q_lora_rank is 0), w_dkv [d, r + rr], kv_norm, w_uk
    [r, H, nope], w_uv [r, H, v], wo [H, v, d]."""
    m = cfg.mla
    H, d = cfg.n_heads, d_stream
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    p: Dict[str, Any] = {}
    if m.q_lora_rank > 0:
        qr = m.q_lora_rank
        p["w_dq"] = Leaf((d, qr), d ** -0.5)
        p["q_norm"] = {"scale": Leaf((qr,))}
        p["w_uq"] = Leaf((qr, H, qk), qr ** -0.5)
    else:
        p["w_uq"] = Leaf((d, H, qk), d ** -0.5)
    p["w_dkv"] = Leaf((d, r + m.qk_rope_head_dim), d ** -0.5)
    p["kv_norm"] = {"scale": Leaf((r,))}
    p["w_uk"] = Leaf((r, H, m.qk_nope_head_dim), r ** -0.5)
    p["w_uv"] = Leaf((r, H, m.v_head_dim), r ** -0.5)
    p["wo"] = Leaf((H, m.v_head_dim, d), (H * m.v_head_dim) ** -0.5)
    return p


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    if positions.dim() == 3:
        positions = positions[0]
    return rope_lib.rope_cos_sin(positions, cfg.mla.qk_rope_head_dim,
                                 cfg.rope_theta)


def _q_proj(params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, norm=rmsnorm
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> q_nope [B, S, H, nope], q_rope [B, S, H, rope]
    (RoPE applied); ``norm`` the RMSNorm of the q latent."""
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora_rank > 0:
        cq = norm(params["q_norm"], x @ params["w_dq"], eps=cfg.norm_eps)
        q = cq @ params["w_uq"].reshape(m.q_lora_rank, -1)
    else:
        q = x @ params["w_uq"].reshape(x.shape[-1], -1)
    q = q.reshape(B, S, cfg.n_heads, -1)
    cos, sin = _rope(cfg, positions)
    return (q[..., :m.qk_nope_head_dim],
            rope_lib.apply_rope(q[..., m.qk_nope_head_dim:], cos, sin))


def _kv_latent(params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, norm=rmsnorm
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> c_kv [B, S, r] (normed by ``norm``), k_rope [B, S,
    rope] (RoPE applied)."""
    r = cfg.mla.kv_lora_rank
    ckr = x @ params["w_dkv"]
    c_kv = norm(params["kv_norm"], ckr[..., :r].contiguous(),
                   eps=cfg.norm_eps)
    cos, sin = _rope(cfg, positions)
    k_rope = rope_lib.apply_rope(ckr[..., None, r:], cos, sin)[..., 0, :]
    return c_kv, k_rope


def _out(params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx [B, ..., H, v] -> [B, ..., d] through wo [H, v, d] (int8 wo
    too: the W8A16 kernel, on a track dim of 1)."""
    H, v = ctx.shape[-2:]
    y = matmul(ctx.reshape(1, -1, H * v), as_matrix(params["wo"][None],
                                                    H * v))
    return y.reshape(*ctx.shape[:-2], -1)


def mla_apply(params, x: torch.Tensor, *, spec: LayerSpec,
              cfg: ModelConfig, positions: torch.Tensor,
              return_cache: bool = False, train: bool = False):
    """Causal MLA over x [B, S, d] at ``positions`` [B, S].  Returns
    (out [B, S, d], (c_kv [B, S, r], k_rope [B, S, rope]) or None).
    ``train``: plain latent norms and ``blockwise_attention`` in place of
    the kernels, for autograd."""
    m = cfg.mla
    B, S, _ = x.shape
    H, r = cfg.n_heads, m.kv_lora_rank
    norm = plain_rmsnorm if train else rmsnorm
    q_nope, q_rope = _q_proj(params, x, cfg, positions, norm)
    c_kv, k_rope = _kv_latent(params, x, cfg, positions, norm)
    k_nope = (c_kv @ params["w_uk"].reshape(r, -1)).reshape(B, S, H, -1)
    v = (c_kv @ params["w_uv"].reshape(r, -1)).reshape(B, S, H, -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    kw = dict(causal=True, window=spec.window,
              softcap=spec.attn_logit_softcap)
    if train:
        ctx = blockwise_attention(q, k, v, chunk_q=cfg.attn_chunk_q,
                                  chunk_k=cfg.attn_chunk_k, **kw)
    else:
        ctx = ops.flash_attention(q, k, v, **kw)
    return _out(params, ctx), ((c_kv, k_rope) if return_cache else None)


def _absorbed(params, q_nope: torch.Tensor, q_rope: torch.Tensor,
              c: torch.Tensor, kr: torch.Tensor, pos: torch.Tensor, *,
              spec: LayerSpec, cfg: ModelConfig,
              out_dtype: torch.dtype) -> torch.Tensor:
    """One token per row against latent rows c [B, S, r], kr [B, S,
    rope]: q_nope [B, H, nope], q_rope [B, H, rope]; row b sees columns
    j <= pos[b].  Returns [B, 1, d]."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope, params["w_uk"])
    s = (torch.einsum("bhr,bsr->bhs", q_abs.to(c.dtype).float(), c.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.to(kr.dtype).float(),
                        kr.float())) * scale
    cap = spec.attn_logit_softcap
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    j = torch.arange(c.shape[1], device=c.device)
    s.masked_fill_(~(j[None, :] <= pos.long()[:, None])[:, None, :],
                   NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhs,bsr->bhr", p.to(c.dtype).float(), c.float())
    v_heads = torch.einsum("bhr,rhv->bhv", ctx_c.to(out_dtype),
                           params["w_uv"])
    return _out(params, v_heads)[:, None]


def mla_decode(params, x: torch.Tensor, cache: Tuple[Any, Any], *,
               spec: LayerSpec, cfg: ModelConfig, pos: torch.Tensor,
               block_table: Optional[torch.Tensor] = None,
               kv_max_len: Optional[int] = None,
               active: Optional[torch.Tensor] = None):
    """Absorbed MLA decode.  x [B, 1, d]; pos [B] int32 (the new token's
    position); cache: this layer's contiguous rows (c_kv [B, S, r],
    k_rope [B, S, rope]) or its latent pools ([N, bs, r], [N, bs, rope]
    ``PagedLeaf``s) with ``block_table`` [B, nmax].  The new latents are
    written first (in place; contiguous rows of lanes with ``active``
    [B] false keep theirs), then read.  ``kv_max_len`` cuts nothing (see
    the module's note).  Returns (out [B, 1, d], cache)."""
    positions = pos[:, None]
    q_nope, q_rope = _q_proj(params, x, cfg, positions)
    c_new, kr_new = _kv_latent(params, x, cfg, positions)
    c_cache, kr_cache = cache
    if is_paged(c_cache):
        if block_table is None:
            raise ValueError("paged MLA cache requires a block_table")
        bs = c_cache.pool.shape[1]
        w_idx = token_to_pool(block_table, positions, bs)[:, 0]
        for leaf, new in ((c_cache, c_new), (kr_cache, kr_new)):
            pool_write(leaf[None], new[None, :, 0], w_idx)
        c = pool_read(c_cache[None], block_table)[0]
        kr = pool_read(kr_cache[None], block_table)[0]
    else:
        S = c_cache.shape[1]
        b = torch.arange(x.shape[0], device=x.device)
        keep = pos < S
        if active is not None:
            keep = keep & active
        keep = keep[:, None]
        at = pos.long().clamp(max=S - 1)
        for rows, new in ((c_cache, c_new), (kr_cache, kr_new)):
            rows[b, at] = torch.where(keep, new[:, 0].to(rows.dtype),
                                      rows[b, at])
        c, kr = c_cache, kr_cache
    out = _absorbed(params, q_nope[:, 0], q_rope[:, 0], c, kr, pos,
                    spec=spec, cfg=cfg, out_dtype=x.dtype)
    return out, cache


def mla_chunk(*args, **kwargs):
    """The reference's chunk step over latent pools (chunked prefill,
    prefix-cache tails, the verify): no served config reaches it (MoE
    turns those features off), so it is not ported."""
    raise NotImplementedError(
        "mla_chunk is not ported to repro_torch: chunked prefill, the "
        "prefix cache and speculation are off for every MLA config served "
        "(MoE); see ROADMAP queue 1, item 3.5")
