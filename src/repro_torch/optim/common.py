"""Optimizer utilities (counterpart of ``repro.optim.common``): global-
norm clipping, the warmup-cosine schedule, and the factory the train
step uses (AdamW below 30 B params, Adafactor for the giants)."""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch.common.pytree import global_norm, tree_map
from repro_torch.common.types import ModelConfig
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update


def _over(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t as one true division (``float / tensor`` in PyTorch is a
    reciprocal and a multiply, two roundings)."""
    return torch.full_like(t, a) / t


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm); each leaf scaled
    in fp32 and cast back to its dtype."""
    gn = global_norm(grads)
    scale = torch.clamp_max(_over(max_norm, torch.clamp_min(gn, 1e-12)), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; fp32, on step's device."""
    t = step.float()
    warm = peak_lr * t / max(1, warmup)
    frac = torch.clamp((t - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(t < warmup, warm, cos)


ADAFACTOR_THRESHOLD = 30e9     # params above this use Adafactor


def make_optimizer(cfg: ModelConfig, n_params: int
                   ) -> Tuple[Callable, Callable, str]:
    """(init_fn(params), update_fn(grads, state, params, lr), name)."""
    if n_params >= ADAFACTOR_THRESHOLD:
        return adafactor_init, adafactor_update, "adafactor"
    return adamw_init, adamw_update, "adamw"
