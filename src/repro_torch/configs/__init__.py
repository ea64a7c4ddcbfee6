"""Config registry of the port: the paper's Parallel-Track models, its
dense baselines, tinyllama-1.1b, falcon-mamba-7b, nemotron-4-15b,
gemma2-2b, gemma3-4b, qwen2-vl-72b, recurrentgemma-9b, deepseek-v2-236b,
deepseek-v3-671b and whisper-medium: every architecture of the
reference's zoo.

  get_config(name)      — full-size config
  reduced_config(name)  — small same-family config (CPU tests)

The ``pt-*`` names serve through ``core.track``; ``dense-*``,
``tinyllama-1.1b`` (GQA + SwiGLU), ``falcon-mamba-7b`` (Mamba),
``nemotron-4-15b`` (LayerNorm, squared ReLU), the gemma models
(GeGLU, sliding windows, softcaps, qk-norm, sandwich norms),
``qwen2-vl-72b`` (M-RoPE, precomputed input embeddings),
``recurrentgemma-9b`` (RG-LRU beside windowed MQA), the deepseek
models (MLA over paged latent pools, capacity-routed MoE) and
``whisper-medium`` (an encoder over precomputed frame embeddings, a
decoder with cross-attention, no RoPE, sinusoid positions) through the
dense ``lm_*`` decoder.  An unknown name raises ``KeyError``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.common.types import ModelConfig
from repro_torch.configs import (deepseek_v2_236b, deepseek_v3_671b,
                                falcon_mamba_7b, gemma2_2b, gemma3_4b,
                                nemotron_4_15b, pt_paper, qwen2_vl_72b,
                                recurrentgemma_9b, tinyllama_1_1b,
                                whisper_medium)

_PAPER: Dict[str, Callable[[], ModelConfig]] = {
    "pt-6b-d2": lambda: pt_paper.pt_6b(2),
    "pt-6b-d4": lambda: pt_paper.pt_6b(4),
    "pt-6b-d8": lambda: pt_paper.pt_6b(8),
    "pt-13b-d2": lambda: pt_paper.pt_13b(2),
    "pt-13b-d4": lambda: pt_paper.pt_13b(4),
    "pt-13b-d8": lambda: pt_paper.pt_13b(8),
    "pt-30b-d2": lambda: pt_paper.pt_30b(2),
    "pt-30b-d4": lambda: pt_paper.pt_30b(4),
    "pt-30b-d8": lambda: pt_paper.pt_30b(8),
}

PT_NAMES: List[str] = list(_PAPER)
_LM: Dict[str, Tuple[Callable[[], ModelConfig], Callable[[], ModelConfig]]] = {
    "dense-6b": (pt_paper.dense_6b, pt_paper.reduced_dense),
    "dense-13b": (pt_paper.dense_13b, pt_paper.reduced_dense),
    "dense-30b": (pt_paper.dense_30b, pt_paper.reduced_dense),
    "tinyllama-1.1b": (tinyllama_1_1b.config, tinyllama_1_1b.reduced),
    "falcon-mamba-7b": (falcon_mamba_7b.config, falcon_mamba_7b.reduced),
    "nemotron-4-15b": (nemotron_4_15b.config, nemotron_4_15b.reduced),
    "gemma2-2b": (gemma2_2b.config, gemma2_2b.reduced),
    "gemma3-4b": (gemma3_4b.config, gemma3_4b.reduced),
    "qwen2-vl-72b": (qwen2_vl_72b.config, qwen2_vl_72b.reduced),
    "recurrentgemma-9b": (recurrentgemma_9b.config, recurrentgemma_9b.reduced),
    "deepseek-v2-236b": (deepseek_v2_236b.config, deepseek_v2_236b.reduced),
    "deepseek-v3-671b": (deepseek_v3_671b.config, deepseek_v3_671b.reduced),
    "whisper-medium": (whisper_medium.config, whisper_medium.reduced),
}
NAMES: List[str] = PT_NAMES + list(_LM)


def _unknown(name: str) -> KeyError:
    return KeyError(f"unknown arch {name!r}: one of {NAMES}")


def get_config(name: str) -> ModelConfig:
    if name in _PAPER:
        return _PAPER[name]()
    if name in _LM:
        return _LM[name][0]()
    raise _unknown(name)


def reduced_config(name: str) -> ModelConfig:
    if name in _PAPER:
        return pt_paper.reduced_pt()
    if name in _LM:
        return _LM[name][1]()
    raise _unknown(name)
