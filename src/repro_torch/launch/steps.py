"""Model-function dispatch (counterpart of the ``model_fns`` table of
``repro.launch.steps``), the train step (``make_train_step``,
``cfg_default_microbatches``; the dry-run's step functions and input
specs are ROADMAP queue 1, item 9c), and ``StepGraph``, the counterpart
of its ``aot_compile``: one serving step captured once as a CUDA graph
and replayed.

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
ranks.  ``init`` draws the serving tree, ``init_train`` the train tree
(a MoE's experts in the reference's stored layout, padding included:
``decoder.init_lm(padded=True)``).
"""
from __future__ import annotations

import functools
import gc
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.common.pytree import (count_params, map_with_path,
                                       tree_map, tree_paths)
from repro_torch.common.types import ModelConfig
from repro_torch.core import track as pt_lib
from repro_torch.kernels import ops
from repro_torch.models import decoder as dec_lib
from repro_torch.models.layers import check_supported
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
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
        return dict(fns, init=pt_lib.init_pt, init_train=pt_lib.init_pt,
                    loss=pt_lib.pt_loss)
    if par.sharded:
        raise ValueError(f"{cfg.name} has no tracks to place on ranks: "
                         "track ranks serve PT configs only")
    return {"init": dec_lib.init_lm,
            "init_train": functools.partial(dec_lib.init_lm, padded=True),
            "loss": dec_lib.lm_loss,
            "forward": dec_lib.lm_forward,
            "decode": dec_lib.lm_decode_step,
            "chunk": dec_lib.lm_chunk_step,
            "chunk_hidden": dec_lib.lm_chunk_hidden,
            "init_cache": dec_lib.init_cache}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _n_params(cfg: ModelConfig) -> int:
    """Parameters of the train tree, a MoE's padded experts included:
    the count the reference picks its optimizer by."""
    specs = (pt_lib.param_specs(cfg) if cfg.pt is not None
             else dec_lib.lm_param_specs(cfg, padded=True))
    return count_params(specs)


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch) -> (loss, metrics)`` by
    autograd: every leaf of ``params`` requires grad for the call only;
    grads have the params' structure (zeros for a leaf the loss does not
    read)."""
    paths, leaves = zip(*tree_paths(params))
    with torch.enable_grad():
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
    by_path = {p: torch.zeros_like(l) if g is None else g
               for p, l, g in zip(paths, leaves, grads)}
    return loss.detach(), map_with_path(lambda p, _: by_path[p], params)


def make_train_step(cfg: ModelConfig, par: Parallelism = NO_PARALLEL,
                    microbatches: int = 0, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    clip_norm: float = 1.0):
    """(train_step, opt_init, opt_name), train_step (params, opt_state,
    batch) -> (params, opt_state, metrics) as the reference's: the batch
    split into microbatches on its leading axis (M-RoPE positions on
    their second), the grads of each summed in fp32 and divided by
    their count (one microbatch: the grads in the params' dtype), then
    clipping to ``clip_norm``, the warmup-cosine rate at the optimizer's
    step, and the optimizer's update (AdamW below 30 B params, in
    place; Adafactor above).  One process:
    training on several cards is ROADMAP queue 1, item 9c."""
    if par.sharded:
        raise NotImplementedError("training on track ranks or several "
                                  "cards: ROADMAP queue 1, item 9c")
    check_supported(cfg)
    fns = model_fns(cfg)
    opt_init, opt_update, opt_name = make_optimizer(cfg, _n_params(cfg))
    mb = microbatches or cfg_default_microbatches(cfg)

    def loss_fn(params, batch):
        return fns["loss"](params, batch, cfg)

    def train_step(params, opt_state, batch):
        B = batch["targets"].shape[0]
        mb_eff = mb
        while mb_eff > 1 and B % mb_eff:
            mb_eff //= 2
        if mb_eff > 1:
            def micro(x, i):
                if x.shape[0] == B:
                    return x.reshape(mb_eff, B // mb_eff, *x.shape[1:])[i]
                return x.reshape(x.shape[0], mb_eff, B // mb_eff,
                                 *x.shape[2:])[:, i]

            gsum, lsum = None, 0.0
            for i in range(mb_eff):
                loss, g = value_and_grad(
                    loss_fn, params, {k: micro(v, i) for k, v in
                                      batch.items()})
                gsum = (tree_map(lambda b: b.float(), g) if gsum is None
                        else tree_map(lambda a, b: a.add_(b.float()),
                                      gsum, g))
                lsum = lsum + loss
            grads = tree_map(lambda g: g.div_(mb_eff), gsum)
            loss = lsum / mb_eff
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = warmup_cosine(opt_state["step"], peak_lr=peak_lr,
                           warmup=warmup, total=total_steps)
        params, opt_state = opt_update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step, opt_init, opt_name


def cfg_default_microbatches(cfg: ModelConfig) -> int:
    """The reference's accumulation factor per architecture (sized for
    its 4k-token train cell)."""
    by_name = {
        "deepseek-v3-671b": 16,
        "deepseek-v2-236b": 16,
        "qwen2-vl-72b": 16,
        "nemotron-4-15b": 8,
        "recurrentgemma-9b": 8,
        "falcon-mamba-7b": 8,
        "gemma3-4b": 4,
        "gemma2-2b": 4,
        "whisper-medium": 2,
        "tinyllama-1.1b": 2,
    }
    for k, v in by_name.items():
        if cfg.name.startswith(k):
            return v
    return 4 if cfg.n_layers >= 24 else 1


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
