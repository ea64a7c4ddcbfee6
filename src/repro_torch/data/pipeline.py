"""Synthetic LM data pipeline: deterministic, resumable (counterpart of
``repro.data.pipeline``, in numpy only).

Structured pseudo-language token streams (a small stochastic grammar
over the vocab with long-range copy spans), keyed by (seed, step): a
restart at step k reproduces batch k exactly, so a checkpoint only
records the step.  The batches are bitwise the reference's for every
(seed, step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64           # markov states of the grammar
    copy_period: int = 0         # 0 => seq_len // 4


def _grammar(cfg: DataConfig) -> np.ndarray:
    """The next-token table [n_states, 8] shared by every batch (the
    'language')."""
    rng = np.random.default_rng(cfg.seed + 7777)
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.n_states, 8)).astype(np.int32)


def sample_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Batch for ``step``: {'inputs': [B, S], 'targets': [B, S]} int32,
    markov-grammar tokens with the second half of each copy period a
    copy of its first half."""
    B, S = cfg.global_batch, cfg.seq_len
    table = _grammar(cfg)
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    state = rng.integers(0, cfg.n_states, size=(B,))
    toks = np.empty((B, S + 1), np.int32)
    choices = rng.integers(0, table.shape[1], size=(B, S + 1))
    jumps = rng.integers(0, cfg.n_states, size=(B, S + 1))
    jump_mask = rng.random((B, S + 1)) < 0.1
    for t in range(S + 1):
        toks[:, t] = table[state, choices[:, t]]
        state = (state + toks[:, t]) % cfg.n_states
        state = np.where(jump_mask[:, t], jumps[:, t], state)
    period = cfg.copy_period or max(8, S // 4)
    half = period // 2
    for start in range(0, S + 1 - period, period):
        toks[:, start + half:start + period] = toks[:, start:start + half]
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


class DataLoader:
    """Iterator over global batches with explicit step-indexed access."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = sample_batch(self.cfg, self.step)
        self.step += 1
        return batch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return sample_batch(self.cfg, step)
