"""Embedding and LM head shared by the decoders (counterpart of the
``model_dtype`` / ``_embed`` / ``_head`` part of
``repro.models.decoder``; the dense ``lm_*`` decoder itself is ROADMAP
queue 1, item 9)."""
from __future__ import annotations

import torch

from repro_torch.common import quant
from repro_torch.common.device import torch_dtype
from repro_torch.common.types import ModelConfig
from repro_torch.models.norms import apply_norm


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _embed(params, inputs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """inputs [B, S] token ids -> [B, S, d] in the model dtype."""
    if inputs.is_floating_point():
        raise NotImplementedError("precomputed input embeddings are not "
                                  "ported (ROADMAP queue 1, item 8)")
    h = params["embed"][inputs.long()]
    if cfg.embedding_multiplier != 1.0:
        h = (h.float() * cfg.embedding_multiplier).to(model_dtype(cfg))
    return h


def _head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + LM head: h [..., d] -> logits [..., V].

    With ``cfg.logits_fp32`` the product runs in fp32 on the fp32 cast
    of both operands, as the reference does.  ``head.float()`` is free
    when the caller already holds an fp32 copy of the head (the serving
    runner does, so no step re-casts the bf16 head).  An int8 head
    (``QuantTensor`` [d, V]) goes through the W8A16 kernel, in h's
    dtype."""
    h = apply_norm(cfg.norm, params["final_norm"], h, eps=cfg.norm_eps)
    if cfg.logits_fp32:
        h = h.float()
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
