"""Transformer-layer assembly: RMSNorm + GQA + SwiGLU over the stacked
track dim (counterpart of ``repro.models.layers``).

``layer_apply`` runs the modes the serving path needs:
  'prefill' — full-sequence forward, returns the layer's (k, v)
  'decode'  — one token per row against this layer's block pools
  'chunk'   — C tokens per row appended to this layer's block pools
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.norms import apply_norm


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer is the ported GQA + SwiGLU flavour."""
    unported = []
    for nm in cfg.layer_names:
        s = cfg.spec(nm)
        if s.mixer != "gqa" or s.mlp != "swiglu":
            unported.append(f"mixer={s.mixer} mlp={s.mlp}")
        if s.window is not None or s.rope != "rope" or s.cross_attn:
            unported.append(f"window={s.window} rope={s.rope} "
                            f"cross_attn={s.cross_attn}")
    if cfg.post_norm or cfg.qk_norm or cfg.norm != "rmsnorm":
        unported.append("post_norm / qk_norm / non-RMS norms")
    if any(x is not None for x in (cfg.moe, cfg.mla, cfg.ssm, cfg.rglru,
                                   cfg.encdec)):
        unported.append("MoE / MLA / SSM / RG-LRU / encoder-decoder")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet ("
            + "; ".join(sorted(set(unported)))
            + "); see ROADMAP queue 1, item 8")


def layer_shapes(cfg: ModelConfig, d_stream: int) -> Dict[str, Any]:
    """Per-track parameter shapes of one layer: (shape, std) for weights
    drawn normal * std, (shape, None) for norm scales (zeros, fp32)."""
    return {"ln1": {"scale": ((d_stream,), None)},
            "mixer": attn.attention_shapes(d_stream, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim),
            "ln2": {"scale": ((d_stream,), None)},
            "mlp": {"wi_gate": ((d_stream, cfg.d_ff), 1 / d_stream ** 0.5),
                    "wi_up": ((d_stream, cfg.d_ff), 1 / d_stream ** 0.5),
                    "wo": ((cfg.d_ff, d_stream), 1 / cfg.d_ff ** 0.5)}}


def _norm(cfg: ModelConfig, params, name: str, x: torch.Tensor):
    return apply_norm(cfg.norm, params[name], x, eps=cfg.norm_eps)


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig,
                spec: LayerSpec, mode: str,
                positions: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, cache: Any = None,
                block_table: Optional[torch.Tensor] = None,
                kv_max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One layer for all tracks: params leaves [n, ...], x [n, B, S, d].
    'prefill' takes ``positions`` [B, S] and returns (x, (k, v));
    'decode' and 'chunk' take ``pos`` [B] (the row's first new
    position), this layer's pool ``cache`` and the block table, and
    return (x, cache).  (The reference also returns an auxiliary MoE
    loss, always zero here.)"""
    h = _norm(cfg, params, "ln1", x)
    if mode == "prefill":
        h, new_cache = attn.attention_apply(params["mixer"], h, spec=spec,
                                            cfg=cfg, positions=positions,
                                            return_cache=True)
    elif mode == "decode":
        h, new_cache = attn.attention_decode(params["mixer"], h, cache,
                                             spec=spec, cfg=cfg, pos=pos,
                                             block_table=block_table,
                                             kv_max_len=kv_max_len)
    elif mode == "chunk":
        h, new_cache = attn.attention_chunk(params["mixer"], h, cache,
                                            spec=spec, cfg=cfg, pos=pos,
                                            block_table=block_table,
                                            kv_max_len=kv_max_len)
    else:
        raise NotImplementedError(
            f"layer mode {mode!r} is not ported (train: ROADMAP queue 1, "
            "item 10)")
    x = x + h
    h = _norm(cfg, params, "ln2", x)
    x = x + mlp_apply(params["mlp"], h, spec.mlp)
    return x, new_cache
