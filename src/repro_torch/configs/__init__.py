"""Config registry of the port: the paper's Parallel-Track models.

  get_config(name)      — full-size config
  reduced_config(name)  — small same-family config (CPU tests)

Only the ``pt-*`` names are ported.  The dense baselines and the other
assigned architectures wait on the dense ``lm_*`` decoder and the other
mixers (ROADMAP queue 1, items 9 and 10).
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.common.types import ModelConfig
from repro_torch.configs import pt_paper

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


def _unported(name: str) -> KeyError:
    return KeyError(
        f"arch {name!r} is not ported to repro_torch yet: only the "
        f"Parallel-Track models {PT_NAMES} are (the dense lm_* decoder and "
        "the other architectures are ROADMAP queue 1, items 9-10)")


def get_config(name: str) -> ModelConfig:
    if name in _PAPER:
        return _PAPER[name]()
    raise _unported(name)


def reduced_config(name: str) -> ModelConfig:
    if name in _PAPER:
        return pt_paper.reduced_pt()
    raise _unported(name)
