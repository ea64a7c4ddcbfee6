"""Model-function dispatch of the serving path (counterpart of the
``model_fns`` table of ``repro.launch.steps``; its train and dry-run
step functions are ROADMAP queue 1, item 9), and ``StepGraph``, the
counterpart of its ``aot_compile``: one serving step captured once as a
CUDA graph and replayed.

A PT config (``cfg.pt`` set) serves through ``core.track``, every other
config through the dense ``lm_*`` decoder.  The entries take the same
arguments on both paths: a PT cache has no per-slot state rows, so
``active``, ``slots`` and ``chunk_lens`` change nothing there (in the
reference they are dead code for it too).  ``chunk_hidden`` (no
reference counterpart) is the chunk step without the LM head, which the
runner applies to each request's last real row only.  ``init_cache`` is
the contiguous cache of either path, the engine cache of
``Engine(paged=False)``: ``[R, D, n, B, S, KH, hd]`` K and V for a PT
model, the ``lm_*`` tree of per-layer rows otherwise.  The PT entries
take ``par`` (``runtime.parallel``), as the reference's step functions
do; ``model_fns(cfg, par)`` binds it, so that a track rank's runner
calls them as one process does.  Only a PT model has tracks to place on
ranks.
"""
from __future__ import annotations

import functools
import gc
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.common.types import ModelConfig
from repro_torch.core import track as pt_lib
from repro_torch.kernels import ops
from repro_torch.models import decoder as dec_lib
from repro_torch.runtime.parallel import NO_PARALLEL, Parallelism


def model_fns(cfg: ModelConfig,
              par: Parallelism = NO_PARALLEL) -> Dict[str, Callable]:
    if cfg.pt is not None:
        fns = {"forward": pt_lib.pt_forward,
               "decode": pt_lib.pt_decode_step,
               "chunk": pt_lib.pt_chunk_step,
               "chunk_hidden": pt_lib.pt_chunk_hidden,
               "init_cache": pt_lib.pt_init_cache}
        fns = {k: functools.update_wrapper(functools.partial(f, par=par), f)
               for k, f in fns.items()}
        return dict(fns, init=pt_lib.init_pt)
    if par.sharded:
        raise ValueError(f"{cfg.name} has no tracks to place on ranks: "
                         "track ranks serve PT configs only")
    return {"init": dec_lib.init_lm,
            "forward": dec_lib.lm_forward,
            "decode": dec_lib.lm_decode_step,
            "chunk": dec_lib.lm_chunk_step,
            "chunk_hidden": dec_lib.lm_chunk_hidden,
            "init_cache": dec_lib.init_cache}


_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up and capture stream per device for every StepGraph:
    cuBLAS keeps a workspace for each stream it ever ran on, for the
    life of the process."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


class StepGraph:
    """One serving step ``fn`` (no arguments: it reads and writes static
    tensors that outlive it) captured as a CUDA graph and replayed: the
    counterpart of the reference's ``aot_compile`` per live-length
    bucket, "the CUDA-graph-per-batch-size pattern".

    ``warm_up`` runs ``fn`` for real on a side stream (the kernels ask
    for their shared memory, cuBLAS sets up its workspace), and ``capture`` records it on that stream into a graph
    whose allocations come from ``pool``.  The graphs of a runner share
    one pool: each graph's temporaries die inside it and one stream runs
    the replays one after another, so they may reuse each other's
    memory; what ``fn`` returns stays allocated, rewritten by every
    replay.  The launch counters' change over the capture is put back,
    and added at every ``replay``, so they go on counting the launches
    the device runs.  On the CPU nothing is captured: ``replay`` runs
    ``fn`` itself, on the same static tensors.  ``replay`` returns
    ``fn``'s result."""

    def __init__(self, fn: Callable[[], Any], device: torch.device,
                 pool: Optional[Any] = None):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.graph: Any = None
        self.result: Any = None
        self.delta: Dict[str, int] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def warm_up(self, n: int = 2) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        self._stream = _side_stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for _ in range(n):
                self.fn()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def capture(self) -> None:
        if self.device.type != "cuda":
            return
        before = ops.counters()
        try:
            self.graph, self.result = self._record()
        finally:
            after = ops.counters()
            ops.set_counters(before)
        self.delta = {k: after[k] - n for k, n in before.items()
                      if after[k] != n}

    def _record(self):
        # a garbage collection inside the capture could destroy a dead
        # CUDA graph, which CUDA forbids while a stream captures (it
        # invalidates the capture): collect first, then hold the
        # collector off until the capture ends
        gc.collect()
        was_on = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=self._stream):
                result = self.fn()
        finally:
            if was_on:
                gc.enable()
        if self.pool is None:
            self.pool = graph.pool()
        return graph, result

    def replay(self) -> Any:
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        ops.add_counters(self.delta)
        return self.result


def plan_graphs(fns: Dict[Hashable, Callable[[], Any]],
                device: torch.device, pool: Optional[Any] = None
                ) -> Dict[Hashable, StepGraph]:
    """A ``StepGraph`` for each entry of ``fns``, all in one memory pool
    (``pool``, or the first capture's): every one warmed up first, then
    every one captured, so that nothing runs eagerly between captures
    (a first launch that grows a buffer a graph holds, say)."""
    graphs = {k: StepGraph(fn, device) for k, fn in fns.items()}
    for g in graphs.values():
        g.warm_up()
    for g in graphs.values():
        g.pool = pool
        g.capture()
        pool = g.pool
    return graphs
