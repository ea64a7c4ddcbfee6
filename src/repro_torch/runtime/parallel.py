"""Track parallelism over ``torch.distributed`` (counterpart of
``repro.runtime.parallel``).

The reference places a Parallel-Track model's track dim on the 'track'
axis of a device mesh (``repro/runtime/sharding.py``) and lets XLA turn
each block's fusion mean into one all-reduce.  The port runs one
process per rank instead: rank r of W holds tracks [r n/W, (r+1) n/W)
of every block leaf and of the KV cache, and the embedding, the final
norm, the LM head and the speculative drafter's tracks are replicated.
Every rank thus computes the same full logits and samples the same
token, and the only communication is at a track-block boundary: ONE
collective (``Parallelism.gather_tracks``) that gathers every rank's
x + delta rows in track order, so that each rank fuses all n rows
itself, in the order one process sums them.

``NO_PARALLEL`` (no group) is one process holding every track.
``spawn`` starts W rank processes on one host, joined by a
``file://`` store in a temporary directory.
"""
from __future__ import annotations

import dataclasses
import datetime
import queue
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclasses.dataclass
class Counts:
    """What a rank issued: the collectives of ``gather_tracks``, and the
    local adds before them (x + delta of a block boundary, one
    elementwise launch each, counted by ``core.track`` where it forms
    them)."""
    collectives: int = 0
    local_adds: int = 0


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """The track process group of this rank (None: one process, every
    track local), its rank and the world size.  ``counts`` is shared by
    the copies ``without_axis`` makes."""
    group: Optional[Any] = None
    rank: int = 0
    world: int = 1
    counts: Counts = dataclasses.field(default_factory=Counts,
                                       compare=False)

    @property
    def sharded(self) -> bool:
        return self.group is not None

    def local_tracks(self, cfg) -> int:
        """Tracks each rank holds: n / W (W must divide n)."""
        if cfg.pt is None:
            raise ValueError(f"{cfg.name} has no tracks to place on ranks")
        n = cfg.pt.n_tracks
        if n % self.world:
            raise ValueError(f"{self.world} ranks do not divide {n} tracks")
        return n // self.world

    def track_range(self, cfg) -> Tuple[int, int]:
        """This rank's tracks [start, stop)."""
        k = self.local_tracks(cfg)
        return self.rank * k, (self.rank + 1) * k

    def without_axis(self, axis: str) -> "Parallelism":
        """The same rank with the 'track' axis stripped: nothing sharded
        over it, no collective (the reference's ``without_axis``, which
        the track-subset drafter runs under).  'track' is the port's only
        axis."""
        if axis != "track":
            raise ValueError(f"no mesh axis {axis!r}: the port places "
                             "tracks only")
        return Parallelism(counts=self.counts)

    def gather_tracks(self, s: torch.Tensor) -> torch.Tensor:
        """This rank's rows s [n/W, ...] gathered from every rank into
        [n, ...] in track order by ONE collective."""
        if not self.sharded:
            raise ValueError("gather_tracks needs a track group")
        out = s.new_empty((self.world * s.shape[0], *s.shape[1:]))
        # all_gather_single where this torch has it (it deprecates
        # all_gather_into_tensor in its favour); looked up at each call
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, s.contiguous(), group=self.group)
        self.counts.collectives += 1
        return out


NO_PARALLEL = Parallelism()


# ---------------------------------------------------------------------------
# rank processes on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world: int, init: str,
               timeout: float, results, args: Sequence[Any]) -> None:
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(Parallelism(dist.group.WORLD, rank, world), *args)
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *,
          timeout: float = 300.0) -> List[Any]:
    """Run ``fn(par, *args)`` on ``world`` rank processes (``spawn``
    start method, gloo over a ``file://`` store in a fresh temporary
    directory) and return each rank's result, by rank.  ``fn`` must be
    importable by name and return something picklable without tensors.
    A rank that raises fails the call with its traceback; a run that
    outlasts ``timeout`` seconds is terminated and raises TimeoutError.
    Every rank process has ended when this returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        procs = mp.start_processes(
            _rank_main, args=(fn, world, f"file://{tmp}/store", timeout,
                              results, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            # drain the queue before the joins: a rank's exit waits for
            # its result to be read
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks: {sorted(got)} done "
                                       f"after {timeout:.0f} s")
                try:
                    rank, out = results.get(timeout=min(left, 0.5))
                    got[rank] = out
                except queue.Empty:
                    # raises ProcessRaisedException when a rank raised
                    if procs.join(timeout=0) and results.empty():
                        lost = sorted(set(range(world)) - set(got))
                        raise RuntimeError(f"ranks {lost} ended without "
                                           "a result")
            while not procs.join(
                    timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not exit within "
                                       f"{timeout:.0f} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
    return [got[r] for r in range(world)]
