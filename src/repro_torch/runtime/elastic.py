"""Straggler detection and retry-with-backoff (counterpart of the
pure-Python half of ``repro.runtime.elastic``).  The elastic re-mesh,
``plan_mesh`` and ``build_mesh``, is ROADMAP queue 1, item 9c."""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class StragglerMonitor:
    """Per-step timing outlier detection: hosts slower than median x
    ``threshold`` for ``patience`` consecutive steps are flagged."""

    threshold: float = 1.5
    patience: int = 3
    _strikes: Dict[str, int] = field(default_factory=dict)
    history: List[Dict[str, float]] = field(default_factory=list)

    def observe(self, step_times: Dict[str, float]) -> List[str]:
        self.history.append(dict(step_times))
        med = statistics.median(step_times.values())
        flagged = []
        for host, t in step_times.items():
            if med > 0 and t > self.threshold * med:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes[host] >= self.patience:
                flagged.append(host)
        return flagged


@dataclass
class RetryPolicy:
    """Launcher-side retry-with-backoff around the train loop: a
    RuntimeError (CUDA errors among them) or OSError restarts ``fn`` up
    to ``max_restarts`` times."""

    max_restarts: int = 5
    backoff_s: float = 1.0

    def run(self, fn, on_restart=None):
        attempt = 0
        while True:
            try:
                return fn()
            except (RuntimeError, OSError) as e:
                attempt += 1
                if attempt > self.max_restarts:
                    raise
                if on_restart is not None:
                    on_restart(attempt, e)
                time.sleep(self.backoff_s * attempt)
