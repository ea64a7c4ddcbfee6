"""Config registry of the port: the paper's Parallel-Track models and
falcon-mamba-7b.

  get_config(name)      — full-size config
  reduced_config(name)  — small same-family config (CPU tests)

The ``pt-*`` names serve through ``core.track``, ``falcon-mamba-7b``
through the dense ``lm_*`` decoder.  The dense baselines and the other
assigned architectures wait on the GQA branch of that decoder and the
other mixers (ROADMAP queue 1, items 2 and 3).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.common.types import ModelConfig
from repro_torch.configs import falcon_mamba_7b, pt_paper

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
    "falcon-mamba-7b": (falcon_mamba_7b.config, falcon_mamba_7b.reduced),
}
NAMES: List[str] = PT_NAMES + list(_LM)


def _unported(name: str) -> KeyError:
    return KeyError(
        f"arch {name!r} is not ported to repro_torch yet: only {NAMES} are "
        "(the GQA branch of the lm_* decoder with the dense baselines, and "
        "the other architectures, are ROADMAP queue 1, items 2-3)")


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
