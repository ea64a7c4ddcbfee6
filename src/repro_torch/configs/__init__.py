"""Config registry of the port: the paper's Parallel-Track models, its
dense baselines, tinyllama-1.1b, falcon-mamba-7b, nemotron-4-15b,
gemma2-2b, gemma3-4b, qwen2-vl-72b and recurrentgemma-9b.

  get_config(name)      — full-size config
  reduced_config(name)  — small same-family config (CPU tests)

The ``pt-*`` names serve through ``core.track``; ``dense-*``,
``tinyllama-1.1b`` (GQA + SwiGLU), ``falcon-mamba-7b`` (Mamba),
``nemotron-4-15b`` (LayerNorm, squared ReLU), the gemma models
(GeGLU, sliding windows, softcaps, qk-norm, sandwich norms),
``qwen2-vl-72b`` (M-RoPE, precomputed input embeddings) and
``recurrentgemma-9b`` (RG-LRU beside windowed MQA) through the dense
``lm_*`` decoder.  The other assigned architectures (deepseek-v2 / -v3:
MLA and MoE; whisper-medium: cross-attention) need mixers and layer
features not ported yet (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.common.types import ModelConfig
from repro_torch.configs import (falcon_mamba_7b, gemma2_2b, gemma3_4b,
                                nemotron_4_15b, pt_paper, qwen2_vl_72b,
                                recurrentgemma_9b, tinyllama_1_1b)

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
}
NAMES: List[str] = PT_NAMES + list(_LM)


def _unported(name: str) -> KeyError:
    return KeyError(
        f"arch {name!r} is not ported to repro_torch yet: only {NAMES} are "
        "(the other architectures need the MLA and MoE mixers or "
        "cross-attention: ROADMAP queue 1, item 3)")


def get_config(name: str) -> ModelConfig:
    if name in _PAPER:
        return _PAPER[name]()
    if name in _LM:
        return _LM[name][0]()
    raise _unported(name)


def reduced_config(name: str) -> ModelConfig:
    if name in _PAPER:
        return pt_paper.reduced_pt()
    if name in _LM:
        return _LM[name][1]()
    raise _unported(name)
