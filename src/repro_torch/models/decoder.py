"""The dense ``lm_*`` decoder (counterpart of ``repro.models.decoder``),
with the embedding and LM head the Parallel-Track model shares.

The layer stack is (prefix, unit × R, suffix) per ModelConfig, as in the
reference; the repeated unit's parameters and cache leaves are stacked
on a leading [R] axis, and the layers run as a Python loop over it (the
reference scans).  Two layers are ported on this path: GQA + SwiGLU
(the paper's dense baselines, tinyllama-1.1b) and Mamba
(falcon-mamba-7b).

  init_lm(generator, cfg, device)               -> params
  lm_forward(params, batch, cfg, mode)          -> (logits, cache)
  lm_decode_step(params, cache, tokens, pos, cfg, ...) -> (logits, cache)
  lm_chunk_step(params, cache, tokens, pos, cfg, ...)  -> (logits, cache)
  lm_chunk_hidden(...)                          -> hidden states (no head)
  init_cache(cfg, batch, seq_len, device)       -> zeroed cache

The cache is the reference's tree {"prefix", "unit", "suffix"} (unit
leaves stacked [R, ...]).  A GQA layer's entry is (k, v), each
[.., B, S, KH, hd] in the model dtype (the contiguous cache), or the
paged engine's (PagedLeaf k, PagedLeaf v) pools [.., N, bs, KH, hd]; a
Mamba layer's entry is (conv window [.., B, dc-1, di] in the model
dtype, h [.., B, di, ds] fp32): per-slot state rows.  The decode and
chunk steps update every leaf in place.  (The reference's prefill also returns an
auxiliary loss, always zero here; training is ROADMAP queue 1, item 9.)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common import quant
from repro_torch.common.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.common.types import ModelConfig
from repro_torch.models.layers import (check_supported, layer_shapes,
                                       layer_step, norm_in)
from repro_torch.models import rope as rope_lib
from repro_torch.models.norms import apply_norm
from repro_torch.models.params import Leaf, make_params, stack


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def lm_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree ``repro.models.decoder.init_lm`` builds, as
    :class:`~repro_torch.models.params.Leaf` specs: embed [V, d], head
    [d, V], prefix/suffix layers, unit layers stacked [R, ...]."""
    check_supported(cfg)
    if cfg.pt is not None:
        raise ValueError(f"{cfg.name} is a PT model: use core.track.init_pt")
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": Leaf((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "final_norm": {"scale": Leaf((d,))},
        "prefix": tuple(layer_shapes(cfg, cfg.spec(nm), d)
                        for nm in cfg.pattern_prefix),
        "unit": tuple(stack(layer_shapes(cfg, cfg.spec(nm), d),
                            (cfg.pattern_repeat,))
                      for nm in cfg.pattern_unit) if cfg.pattern_repeat else (),
        "suffix": tuple(layer_shapes(cfg, cfg.spec(nm), d)
                        for nm in cfg.pattern_suffix),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Leaf((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    return specs


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's distributions (see
    ``lm_param_specs``).  ``generator`` must live on ``device`` (CUDA
    unless 'cpu' is given).  The numbers differ from the JAX init of the
    same seed; tests load one JAX tree into both packages through
    ``weights.from_jax_params``."""
    device = resolve_device(device)
    return make_params(lm_param_specs(cfg), generator, model_dtype(cfg),
                       device)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed(params, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """inputs [B, S] token ids -> [B, S, d] in the model dtype."""
    if inputs.is_floating_point():
        raise NotImplementedError("precomputed input embeddings are not "
                                  "ported (ROADMAP queue 1, item 3)")
    h = params["embed"][inputs.long()]
    if cfg.embedding_multiplier != 1.0:
        h = (h.float() * cfg.embedding_multiplier).to(model_dtype(cfg))
    return h


def _head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + LM head: h [..., d] -> logits [..., V]."""
    return _logits(params, apply_norm(cfg.norm, params["final_norm"], h,
                                      eps=cfg.norm_eps), cfg)


def _logits(params, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM head on the final norm's output y [..., d] -> [..., V].

    With ``cfg.logits_fp32`` the product runs in fp32 on the fp32 cast
    of both operands, as the reference does.  ``head.float()`` is free
    when the caller already holds an fp32 copy of the head (the serving
    runner does, so no step re-casts the bf16 head).  An int8 head
    (``QuantTensor`` [d, V]) goes through the W8A16 kernel, in y's
    dtype."""
    h = y.float() if cfg.logits_fp32 else y
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    if quant.is_quantized(w):
        logits = quant.matmul(h.reshape(1, -1, h.shape[-1]), w[None])
        logits = logits.reshape(*h.shape[:-1], w.shape[-1])
    else:
        logits = h @ w.to(h.dtype)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _final(params, x: torch.Tensor, delta: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The last residual add folded into the final norm: the normed
    hidden states [..., d] the LM head reads."""
    return norm_in(cfg, params["final_norm"], x, delta)[1]


# ---------------------------------------------------------------------------
# forward / decode / chunk
# ---------------------------------------------------------------------------

def _at(tree, r: int):
    """Layer r of a [R]-stacked tree (views; QuantTensors slice too)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_at(v, r) for v in tree)
    return tree[r]


def _layers(cfg: ModelConfig):
    """(group, index, r, spec name) of every layer in order; r is the
    unit repeat (None outside the unit)."""
    out = [("prefix", i, None, nm) for i, nm in enumerate(cfg.pattern_prefix)]
    for r in range(cfg.pattern_repeat):
        out += [("unit", j, r, nm) for j, nm in enumerate(cfg.pattern_unit)]
    out += [("suffix", i, None, nm) for i, nm in enumerate(cfg.pattern_suffix)]
    return out


def _stacked(caches: List[Any]) -> Any:
    """Per-layer caches of one unit position -> one [R]-stacked cache."""
    first = caches[0]
    if isinstance(first, tuple):
        return tuple(_stacked([c[i] for c in caches])
                     for i in range(len(first)))
    return torch.stack(caches)


def lm_forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               mode: str = "prefill"):
    """Whole-prompt prefill.  batch: {'inputs': [B, S] token ids,
    'positions'?: [B, S]}.
    Returns (logits [B, S, V], cache) in the reference's prefill layout
    (a GQA layer's (k, v) [B, S, KH, hd] with RoPE applied, unit leaves
    stacked [R, B, ...]).  Right-padded rows are safe for full
    attention: a padded key lies causally after every real query (the
    reference's ``lengths`` only shapes ring caches, not ported).
    Recurrent layers carry every position into their state, so their
    rows must not be right-padded: the engine prefills them at exact
    length."""
    if mode != "prefill":
        raise NotImplementedError(f"lm_forward mode {mode!r} is not ported "
                                  "(train: ROADMAP queue 1, item 9)")
    inputs = batch["inputs"]
    positions = batch.get("positions")
    if positions is None:
        positions = rope_lib.positions_default(*inputs.shape[:2],
                                               device=inputs.device)
    x, delta = _embed(params, inputs, cfg), None
    caches: Dict[str, Any] = {"prefix": [], "unit": [[] for _ in
                                                     cfg.pattern_unit],
                              "suffix": []}
    for group, i, r, nm in _layers(cfg):
        lp = (params[group][i] if r is None
              else _at(params["unit"][i], r))
        x, y = norm_in(cfg, lp["ln1"], x, delta)
        x, delta, c = layer_step(lp, x, y, cfg=cfg, spec=cfg.spec(nm),
                                 mode="prefill", positions=positions)
        (caches[group] if r is None else caches["unit"][i]).append(c)
    cache = {"prefix": tuple(caches["prefix"]),
             "unit": (tuple(_stacked(cs) for cs in caches["unit"])
                      if cfg.pattern_repeat else ()),
             "suffix": tuple(caches["suffix"])}
    return _logits(params, _final(params, x, delta, cfg), cfg), cache


def _step_layers(params, cache, h: torch.Tensor, pos: torch.Tensor,
                 cfg: ModelConfig, mode: str,
                 block_table: Optional[torch.Tensor],
                 kv_max_len: Optional[int],
                 slots: Optional[torch.Tensor] = None,
                 chunk_lens: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the (prefix, unit × R, suffix) stack in decode or chunk mode;
    every layer updates its cache entry in place.  Returns (x, delta):
    the hidden states are x + delta, the last residual add left for the
    final norm to fold in."""
    x, delta = h, None
    for group, i, r, nm in _layers(cfg):
        if r is None:
            lp, lc = params[group][i], cache[group][i]
        else:
            lp, lc = _at(params["unit"][i], r), _at(cache["unit"][i], r)
        x, y = norm_in(cfg, lp["ln1"], x, delta)
        x, delta, _ = layer_step(lp, x, y, cfg=cfg, spec=cfg.spec(nm),
                                 mode=mode, pos=pos, cache=lc,
                                 block_table=block_table,
                                 kv_max_len=kv_max_len, slots=slots,
                                 chunk_lens=chunk_lens, active=active)
    return x, delta


def lm_decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig,
                   block_table: Optional[torch.Tensor] = None,
                   kv_max_len: Optional[int] = None,
                   active: Optional[torch.Tensor] = None):
    """tokens [B]; pos [B] int32 (cache write index).  ``active`` [B]
    bool freezes the state rows of inactive lanes.  The cache is updated
    in place.  Returns (logits [B, V], cache)."""
    h = _embed(params, tokens[:, None], cfg)
    x, delta = _step_layers(params, cache, h, pos, cfg, "decode",
                            block_table, kv_max_len, active=active)
    return _logits(params, _final(params, x, delta, cfg)[:, 0], cfg), cache


def lm_chunk_hidden(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                    cfg: ModelConfig,
                    block_table: Optional[torch.Tensor] = None,
                    kv_max_len: Optional[int] = None,
                    slots: Optional[torch.Tensor] = None,
                    chunk_lens: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``lm_chunk_step`` without the LM head: tokens [B, C] appended at
    positions pos[:, None] + arange(C) -> hidden states [B, C, d].  State
    rows advance at ``slots`` by ``chunk_lens`` valid tokens.  The
    serving runner applies the head to each row's last real token only;
    the head is row-wise, so those logits are the rows ``lm_chunk_step``
    returns."""
    h = _embed(params, tokens, cfg)
    x, delta = _step_layers(params, cache, h, pos, cfg, "chunk",
                            block_table, kv_max_len, slots=slots,
                            chunk_lens=chunk_lens)
    return x + delta


def lm_chunk_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig,
                  block_table: Optional[torch.Tensor] = None,
                  kv_max_len: Optional[int] = None,
                  slots: Optional[torch.Tensor] = None,
                  chunk_lens: Optional[torch.Tensor] = None):
    """Chunked prefill: tokens [B, C] appended against the cache (updated
    in place).  Returns (logits [B, C, V], cache)."""
    h = _embed(params, tokens, cfg)
    x, delta = _step_layers(params, cache, h, pos, cfg, "chunk",
                            block_table, kv_max_len, slots=slots,
                            chunk_lens=chunk_lens)
    return _logits(params, _final(params, x, delta, cfg), cfg), cache


def layer_cache(cfg: ModelConfig, nm: str, lead, batch: int, seq_len: int,
                device, kv_dtype: Optional[torch.dtype] = None) -> Any:
    """Zeroed cache entry of layer ``nm`` with stacking dims ``lead``: a
    GQA layer's (k, v) [*lead, batch, seq_len, KH, hd] (in ``kv_dtype``,
    default the model dtype; the paged engine asks for (num_blocks,
    block_size) in place of (batch, seq_len)), a Mamba layer's state
    rows for ``batch`` slots."""
    if cfg.spec(nm).mixer == "gqa":
        shape = (*lead, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        dtype = kv_dtype or model_dtype(cfg)
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(2))
    s = cfg.ssm
    return (torch.zeros(*lead, batch, s.d_conv - 1, s.d_inner,
                        dtype=model_dtype(cfg), device=device),
            torch.zeros(*lead, batch, s.d_inner, s.d_state,
                        dtype=torch.float32, device=device))


def map_layers(cfg: ModelConfig, fn) -> Dict[str, Any]:
    """The {"prefix", "unit", "suffix"} tree of ``fn(name, lead)`` over
    the layer pattern; ``lead`` is (R,) in the unit, () elsewhere."""
    R = cfg.pattern_repeat
    return {"prefix": tuple(fn(nm, ()) for nm in cfg.pattern_prefix),
            "unit": tuple(fn(nm, (R,)) for nm in cfg.pattern_unit)
            if R else (),
            "suffix": tuple(fn(nm, ()) for nm in cfg.pattern_suffix)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed contiguous cache for ``batch`` rows of ``seq_len``
    positions (``seq_len`` does not change the size of state leaves)."""
    check_supported(cfg)
    device = resolve_device(device)
    return map_layers(cfg, lambda nm, lead: layer_cache(
        cfg, nm, lead, batch, seq_len, device))
