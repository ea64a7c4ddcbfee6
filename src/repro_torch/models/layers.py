"""Layer assembly: RMSNorm + mixer (+ MLP) per LayerSpec (counterpart of
``repro.models.layers``).

Two flavours are ported:
  * the GQA + SwiGLU layer: over the stacked track dim in a
    Parallel-Track model (x [n, B, S, d], every parameter [n, ...]), and
    in the dense ``lm_*`` decoder (x [B, S, d]), where the layer views x
    as [1, B, S, d] and every parameter and cache leaf with a leading
    track dim of 1 (views, no copies) and runs the same code;
  * the Mamba layer of the dense ``lm_*`` decoder, mixer only
    (``mlp="none"``, x [B, S, d]).

``layer_step`` is what the model loops run: its caller applies ln1 (the
norm of the residual stream, with the previous layer's pending residual
add, or a track fusion, folded into the same launch: ``norm_in`` and
``models/norms.py``), and it leaves its own last residual add pending
for the next norm; ``layer_apply`` is the whole layer, residuals added.
Both run the modes the serving path needs:
  'prefill' — full-sequence forward, returns the layer's cache
              ((k, v) for GQA, (conv window, h) for Mamba)
  'decode'  — one token per row against the layer's cache
  'chunk'   — C tokens per row appended to the layer's cache
GQA caches are block pools written through the block table, or
contiguous per-slot rows [.., B, S, KH, hd] written at each row's
position (inactive decode lanes keep their rows); Mamba caches are
per-slot state rows, updated in place: the chunk batch
gathers its rows at ``slots``, advances them by ``chunk_lens`` valid
tokens and writes them back (``index_copy_``), and a decode step
rewrites every row with ``active`` lanes frozen (the reference does the
same functionally, on donated buffers).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.paged import PagedLeaf
from repro_torch.common.quant import QuantTensor
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.norms import add_norm, apply_norm
from repro_torch.models.params import Leaf

_PT_LAYER = ("gqa", "swiglu")       # (mixer, mlp) of the PT path
_LM_LAYERS = (("gqa", "swiglu"), ("mamba", "none"))   # of the lm_* path


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer is a ported flavour: GQA + SwiGLU in a PT
    model; GQA + SwiGLU or Mamba alone in a dense ``lm_*`` model.  GQA
    layers take full attention with RoPE (no window, no M-RoPE)."""
    unported = []
    for nm in cfg.layer_names:
        s = cfg.spec(nm)
        if cfg.pt is not None:
            if (s.mixer, s.mlp) != _PT_LAYER:
                unported.append(f"PT layer mixer={s.mixer} mlp={s.mlp}")
        elif (s.mixer, s.mlp) not in _LM_LAYERS:
            unported.append(f"lm_* layer mixer={s.mixer} mlp={s.mlp}")
        if s.mixer == "gqa" and (s.window is not None or s.rope != "rope"):
            unported.append(f"window={s.window} rope={s.rope}")
        if s.cross_attn:
            unported.append("cross-attention")
    if cfg.post_norm or cfg.qk_norm or cfg.norm != "rmsnorm":
        unported.append("post_norm / qk_norm / non-RMS norms")
    if any(x is not None for x in (cfg.moe, cfg.mla, cfg.rglru, cfg.encdec)):
        unported.append("MoE / MLA / RG-LRU / encoder-decoder")
    if cfg.ssm is not None and cfg.pt is not None:
        unported.append("SSM in a PT model")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet ("
            + "; ".join(sorted(set(unported)))
            + "); see ROADMAP queue 1, item 3")


def layer_shapes(cfg: ModelConfig, spec: LayerSpec,
                 d_stream: int) -> Dict[str, Any]:
    """Parameter specs of one layer (per track for a PT layer)."""
    norm = {"scale": Leaf((d_stream,))}
    if spec.mixer == "mamba":
        return {"ln1": norm, "mixer": ssm_lib.ssm_shapes(cfg, d_stream)}
    return {"ln1": norm,
            "mixer": attn.attention_shapes(d_stream, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim),
            "ln2": {"scale": Leaf((d_stream,))},
            "mlp": {"wi_gate": Leaf((d_stream, cfg.d_ff), 1 / d_stream ** 0.5),
                    "wi_up": Leaf((d_stream, cfg.d_ff), 1 / d_stream ** 0.5),
                    "wo": Leaf((cfg.d_ff, d_stream), 1 / cfg.d_ff ** 0.5)}}


def norm_in(cfg: ModelConfig, params, x: torch.Tensor,
            delta: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y): the residual stream with the pending residual ``delta``
    added (None: none pending) and its norm under ``params`` (a
    ``{"scale": ...}`` node), in one launch."""
    if delta is None:
        return x, apply_norm(cfg.norm, params, x, eps=cfg.norm_eps)
    return add_norm(cfg.norm, params, x, delta, eps=cfg.norm_eps)


def _write_rows(cache, new_rows, slots: Optional[torch.Tensor]):
    """Write advanced state rows into the per-slot leaves in place: at
    ``slots`` (a chunk batch), or every row when ``slots`` is None."""
    for leaf, row in zip(cache, new_rows):
        if slots is None:
            leaf.copy_(row)
        else:
            leaf.index_copy_(0, slots, row.to(leaf.dtype))
    return cache


def _mamba(params, h: torch.Tensor, *, cfg: ModelConfig, mode: str,
           cache: Any, slots: Optional[torch.Tensor],
           chunk_lens: Optional[torch.Tensor],
           active: Optional[torch.Tensor]):
    if mode == "prefill":
        return ssm_lib.ssm_apply(params, h, cfg=cfg, return_cache=True)
    if mode == "decode":
        out, new_rows = ssm_lib.ssm_decode(params, h, cache, cfg=cfg,
                                           active=active)
        return out, _write_rows(cache, new_rows, None)
    if mode == "chunk":
        rows = cache if slots is None else tuple(l[slots] for l in cache)
        out, new_rows = ssm_lib.ssm_chunk(params, h, rows, cfg=cfg,
                                          chunk_lens=chunk_lens)
        return out, _write_rows(cache, new_rows, slots)
    raise NotImplementedError(f"layer mode {mode!r} is not ported (train: "
                              "ROADMAP queue 1, item 9)")


def _gqa(params, h: torch.Tensor, *, cfg: ModelConfig, spec: LayerSpec,
         mode: str, positions, pos, cache, block_table, kv_max_len, active):
    if mode == "prefill":
        return attn.attention_apply(params, h, spec=spec, cfg=cfg,
                                    positions=positions, return_cache=True)
    if mode == "decode":
        return attn.attention_decode(params, h, cache, spec=spec, cfg=cfg,
                                     pos=pos, block_table=block_table,
                                     kv_max_len=kv_max_len, active=active)
    if mode == "chunk":
        return attn.attention_chunk(params, h, cache, spec=spec, cfg=cfg,
                                    pos=pos, block_table=block_table,
                                    kv_max_len=kv_max_len)
    raise NotImplementedError(f"layer mode {mode!r} is not ported (train: "
                              "ROADMAP queue 1, item 9)")


def _track1(tree):
    """An lm_* GQA layer's parameters or cache with a leading track dim
    of 1: views of every tensor, QuantTensor and PagedLeaf."""
    if isinstance(tree, dict):
        return {k: _track1(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_track1(v) for v in tree)
    if isinstance(tree, (torch.Tensor, QuantTensor, PagedLeaf)):
        return tree[None]
    return tree


def _step(params, x: torch.Tensor, y: torch.Tensor, *, cfg: ModelConfig,
          spec: LayerSpec, mode: str, positions, pos, cache, block_table,
          kv_max_len, slots, chunk_lens, active
          ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    if spec.mixer == "mamba":
        h, new_cache = _mamba(params["mixer"], y, cfg=cfg, mode=mode,
                              cache=cache, slots=slots,
                              chunk_lens=chunk_lens, active=active)
        return x, h, new_cache
    h, new_cache = _gqa(params["mixer"], y, cfg=cfg, spec=spec, mode=mode,
                        positions=positions, pos=pos, cache=cache,
                        block_table=block_table, kv_max_len=kv_max_len,
                        active=active)
    x, y = norm_in(cfg, params["ln2"], x, h)
    return x, mlp_apply(params["mlp"], y, spec.mlp), new_cache


def layer_step(params, x: torch.Tensor, y: torch.Tensor, *,
               cfg: ModelConfig, spec: LayerSpec, mode: str,
               positions: Optional[torch.Tensor] = None,
               pos: Optional[torch.Tensor] = None, cache: Any = None,
               block_table: Optional[torch.Tensor] = None,
               kv_max_len: Optional[int] = None,
               slots: Optional[torch.Tensor] = None,
               chunk_lens: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """One layer whose ln1 the caller applied: x the residual stream (in a
    PT model possibly one fused row broadcast to every track), y =
    ln1(x).  Returns (x, delta, cache): the layer's output is x + delta,
    the add left for the next norm to fold in (``norm_in``).  Arguments
    and cache as ``layer_apply``."""
    kw = dict(cfg=cfg, spec=spec, mode=mode, positions=positions, pos=pos,
              block_table=block_table, kv_max_len=kv_max_len, slots=slots,
              chunk_lens=chunk_lens, active=active)
    if cfg.pt is None and spec.mixer == "gqa":
        # an lm_* GQA layer runs the PT layer's code at n = 1, on views
        x1, d1, c1 = _step(_track1(params), x[None], y[None],
                           cache=_track1(cache), **kw)
        return x1[0], d1[0], (tuple(c[0] for c in c1) if mode == "prefill"
                              else cache)
    return _step(params, x, y, cache=cache, **kw)


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
                spec: LayerSpec, mode: str,
                positions: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, cache: Any = None,
                block_table: Optional[torch.Tensor] = None,
                kv_max_len: Optional[int] = None,
                slots: Optional[torch.Tensor] = None,
                chunk_lens: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One layer.  A PT layer takes x [n, B, S, d] and params leaves
    [n, ...]; an lm_* layer x [B, S, d].  'prefill' takes ``positions``
    [B, S] and returns (x, cache); 'decode' and 'chunk' take ``pos`` [B]
    (the row's first new position) and this layer's cache: a GQA layer's
    pools with the block table, or its contiguous rows; a Mamba layer's
    state rows with ``slots`` [B] (chunk rows -> engine slots; None when
    the rows align with the batch) and ``chunk_lens`` [B] (valid tokens
    of a padded final chunk).  ``active`` [B] marks the decode lanes
    whose contiguous rows or state may change.  Returns (x, cache).
    (The reference also returns an auxiliary MoE loss, always zero
    here.)"""
    x, y = norm_in(cfg, params["ln1"], x, None)
    x, delta, cache = layer_step(params, x, y, cfg=cfg, spec=spec,
                                 mode=mode, positions=positions, pos=pos,
                                 cache=cache, block_table=block_table,
                                 kv_max_len=kv_max_len, slots=slots,
                                 chunk_lens=chunk_lens, active=active)
    return x + delta, cache
