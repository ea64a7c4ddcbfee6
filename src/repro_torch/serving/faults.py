"""Deterministic fault injection for the serving engine (counterpart of
``repro.serving.faults``, kept as a copy: the port imports nothing of the
JAX package).

A :class:`FaultPlan` is a seeded schedule of failures threaded through
the allocation and host-transfer choke points of the serving stack:

  * allocation faults  — ``PagedKVCache.allocate`` / ``append`` /
    ``fork`` / ``ensure_writable`` raise ``MemoryError`` as if the block
    pool were exhausted, exercising the engine's preempt-and-recompute
    and stall-watchdog paths without needing a real fork storm.
  * transfer faults    — ``ModelRunner`` raises :class:`TransferFault`
    at the packed host-transfer point of a decode / speculative /
    prefill-chunk step, as if the device-to-host copy died.  The device
    work of the step has already been issued, but replaying the step is
    bitwise-safe: every input (tokens, positions, per-request PRNG keys)
    is unchanged, so the recompute writes identical bytes to identical
    cache positions.
  * slow steps         — an injected per-step sleep, for driving
    deadline / watchdog timing paths deterministically in tests.

Determinism is the point: the whole schedule is a pure function of the
plan's ``seed`` and the sequence of fault-site calls, so a chaos test
that fails replays exactly from its seed.  Sites can also be forced
explicitly via the ``*_ops`` index sets (the i-th call to that site
faults), which composes with the probabilistic schedule.

Every injected fault is appended to ``events`` as ``(site, op_index)``
so tests can assert on — and operators can read back — exactly what was
injected.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np


class TransferFault(RuntimeError):
    """An (injected) device-to-host transfer failure.  The engine treats
    the step as not having happened and retries it on the next tick."""


@dataclasses.dataclass
class FaultPlan:
    """Seeded, reproducible schedule of injected serving faults.

    ``alloc_p`` / ``transfer_p`` / ``slow_p`` are per-call probabilities
    drawn from a private ``numpy`` generator seeded with ``seed``; the
    ``alloc_ops`` / ``transfer_ops`` sets force specific call indices to
    fault regardless of the dice.  ``max_faults`` bounds the total
    number of injected faults (a storm that eventually clears), and
    ``slow_s`` is the sleep injected on a slow step.
    """
    seed: int = 0
    alloc_p: float = 0.0
    transfer_p: float = 0.0
    slow_p: float = 0.0
    slow_s: float = 0.0
    max_faults: Optional[int] = None
    alloc_ops: FrozenSet[int] = frozenset()
    transfer_ops: FrozenSet[int] = frozenset()

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self.alloc_calls = 0
        self.transfer_calls = 0
        self.slow_calls = 0
        self.injected = 0
        self.events: List[Tuple[str, int]] = []
        # labeled transfer-fault sites: (op_index, label) per injected
        # transfer fault, so tests can assert WHERE a fault surfaced —
        # in the pipelined engine that is the wait on the *completing*
        # step (one step after its dispatch), never the dispatch itself
        self.transfer_sites: List[Tuple[int, str]] = []

    # -- internals ------------------------------------------------------
    def _spent(self) -> bool:
        return (self.max_faults is not None
                and self.injected >= self.max_faults)

    def _fire(self, site: str, op: int) -> bool:
        self.injected += 1
        self.events.append((site, op))
        return True

    # -- fault sites ----------------------------------------------------
    def take_alloc(self) -> bool:
        """One allocation-site call; True => the caller must raise
        ``MemoryError`` *before mutating any block accounting*."""
        op = self.alloc_calls
        self.alloc_calls += 1
        # the dice roll always happens (even when the budget is spent)
        # so the schedule stays a pure function of seed + call sequence
        roll = self._rng.random() < self.alloc_p
        if self._spent():
            return False
        if op in self.alloc_ops or roll:
            return self._fire("alloc", op)
        return False

    def take_transfer(self, label: Optional[str] = None) -> bool:
        """One host-transfer-site call; True => raise TransferFault.
        ``label`` names the site (e.g. ``"decode"``, ``"decode_wait"``)
        purely for ``transfer_sites`` — it never affects the schedule,
        which stays a pure function of seed + call sequence."""
        op = self.transfer_calls
        self.transfer_calls += 1
        roll = self._rng.random() < self.transfer_p
        if self._spent():
            return False
        if op in self.transfer_ops or roll:
            self.transfer_sites.append((op, label or "transfer"))
            return self._fire("transfer", op)
        return False

    def take_slow(self) -> float:
        """Seconds the current engine step should sleep (0.0 normally)."""
        op = self.slow_calls
        self.slow_calls += 1
        roll = self._rng.random() < self.slow_p
        if self._spent() or not roll:
            return 0.0
        self._fire("slow", op)
        return self.slow_s

    # -- reporting ------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {"alloc": 0, "transfer": 0, "slow": 0}
        for site, _ in self.events:
            counts[site] += 1
        return {
            "seed": self.seed,
            "injected": self.injected,
            "alloc_faults": counts["alloc"],
            "transfer_faults": counts["transfer"],
            "slow_steps": counts["slow"],
            "alloc_calls": self.alloc_calls,
            "transfer_calls": self.transfer_calls,
        }
