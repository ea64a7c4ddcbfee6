"""Greedy token sampling and the fused decode-step epilogue (counterpart
of ``repro.serving.sampler``).

Sampling with ``temperature > 0`` needs keys bit-exact with JAX's
threefry stream (``row_keys``) and is ROADMAP queue 1, item 4: every
entry point here checks the host-side temperatures and raises for it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SampleParams:
    temperature: float = 0.0          # 0 => greedy (the only ported mode)
    top_k: int = 0
    top_p: float = 1.0


def stack_params(params: Sequence[SampleParams]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[SampleParams] -> (temperature [B] f32, top_k [B] i32, top_p [B] f32),
    host arrays."""
    return (np.asarray([p.temperature for p in params], np.float32),
            np.asarray([p.top_k for p in params], np.int32),
            np.asarray([p.top_p for p in params], np.float32))


def require_greedy(temperature) -> None:
    """Raise for any row with temperature > 0 (host-side check, no
    device sync)."""
    if np.any(np.asarray(temperature) > 0.0):
        raise NotImplementedError(
            "sampling with temperature > 0 is not ported: it needs keys "
            "bit-exact with the reference's threefry stream (ROADMAP "
            "queue 1, item 4)")


def sample_rows(logits: torch.Tensor, temperature) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.  Greedy: the first maximal
    index, as jnp.argmax picks (no top-k substitute).  ``temperature``
    is the host array of per-row temperatures (all must be 0)."""
    require_greedy(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_step(logits: torch.Tensor, temperature, active: torch.Tensor,
                eos: torch.Tensor, remaining: torch.Tensor) -> torch.Tensor:
    """The fused decode-step epilogue on device: per-slot token plus
    done flag, packed [2, B] int32 = (token, done) — the decode loop's
    one host transfer.  ``active`` [B] bool, ``eos`` [B] int32 (-1 =
    none), ``remaining`` [B] int32 tokens still allowed."""
    new = sample_rows(logits, temperature)
    new = torch.where(active, new, torch.zeros_like(new))
    done = active & ((remaining <= 1) | ((eos >= 0) & (new == eos)))
    return torch.stack([new, done.to(torch.int32)])
