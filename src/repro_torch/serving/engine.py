"""Continuous-batching serving engine: Scheduler + ModelRunner + Engine
(counterpart of ``repro.serving.engine``), synchronous or pipelined.

  Scheduler   — pure-Python FCFS admission over a fixed slot table,
                budgeted by padded prefill tokens and free KV blocks.
  ModelRunner — everything that touches the device: the cache (paged
                K/V pools, or the contiguous per-slot cache), bucketed
                batched prefill and the decode step with its fused
                sampling epilogue.
  Engine      — submit / step / run / generate, streaming callbacks and
                TTFT / TPOT / throughput metrics; with
                ``pipeline_depth > 0`` it dispatches step N + 1 before
                it waits on step N's transfer.

One engine step: admit queued requests (bucketed, batched prefill that
samples each request's first token), advance every chunked prefill by
one chunk (``prefill_chunk > 0``), run ONE decode step for every
decoding slot, and free the blocks of slots that finished.  With int8
KV (``kv_dtype="int8"``) every cold prompt runs through the chunk
program, as in the reference, so its first token comes from attention
over the quantized pool bytes; ``weight_dtype="int8"`` quantizes the
projection weights once, when the runner is built.  A decode
step makes exactly one device-to-host transfer: the packed [2, slots]
(token, done) tensor of ``sampler.sample_step``.  The device block table
is copied in only when the cache's table version or the active set
changes.

Every decode or speculative step is a step program over the runner's
static tensors (the packed inputs, the block table, the packed result
with the inputs as carried): a dispatch stages the host inputs, runs
the program and queues the result's copy to the host; a wait takes that
one transfer.  The pipelined engine composes step N + 1's inputs on the
device from step N's result (``sampler.advance_decode`` /
``advance_spec``), the host's values only for lanes it rewrote.  With
``preplan`` the runner captures each program once per live-length
bucket as a CUDA graph (``launch.steps.StepGraph``) and a dispatch
replays it; an unplanned bucket runs the same program eagerly.

``paged=False`` serves through the contiguous cache instead, as the
reference does: the model's ``init_cache`` at ``max_slots`` rows of
``max_seq_len`` positions, prefill rows written in by
``cache.insert_rows``, decode with no block table (the contiguous-cache
decode kernel), admission with no block metering; chunked prefill and
int8 KV need the paged cache and fall back, as in the reference.

The runner serves through ``launch.steps.model_fns``: a PT model
through ``core.track``, the dense baselines and falcon-mamba through
the dense ``lm_*`` decoder (falcon-mamba's cache is per-slot state rows
under the same, virtual, block accounting).  Recurrent architectures prefill at exact prompt length (a
padded token would run through the conv window and the SSM state), and
a chunked admission zeroes its slot's state rows before the first
chunk.  Which features an architecture supports, and why not, comes
from ``arch_capabilities``, as in the reference: a requested feature it
does not support falls back with the reference's reason
(``quant_fallbacks``).

Track-speculative decoding (``speculate_k=K``, ``draft_tracks=d``; a
PT config on the paged cache, else it falls back to plain decode with
the reference's reason): the first d of the n tracks, as views of the
target's blocks, are a narrow drafter with a contiguous cache of its
own, filled at admission (or chunk by chunk).  Each engine step then
runs K + 1 draft steps, ONE (K+1)-token verify of the target through
the chunk program, and ``sampler.accept_step``, whose packed [K+2,
slots] result is the step's one host transfer; every decoding slot
advances by 1..K+1 tokens: for a greedy request the tokens plain greedy
decode emits, for a sampled one draws from the target's distribution
(rejection sampling).

Each request samples under its own ``SampleParams`` (temperature, top-k,
top-p) and its own seed: every draw is keyed by (request seed, token
counter, salt) (``sampler.row_keys``), the prefill's last row by
``prefill_keys``, a decode step's rows by ``SALT_SAMPLE`` and the
drafter's by ``SALT_DRAFT``, the keys derived on the device inside the
step program.  A step whose lanes are all greedy runs the greedy
program (the argmax alone); one with a sampled lane runs the sampled
variant of the same program, whose greedy lanes take the same argmax.

The prefix cache is off (``prefix_cache=False``; the
reference defaults to on); the pipelined engine has no transfer faults,
watchdog, deadlines or preemption (ROADMAP queue 1, item 8b).  Every
feature of the reference engine this slice leaves out raises
``NotImplementedError`` naming its ROADMAP item when asked for, never
silently ignored.
"""
from __future__ import annotations

import dataclasses
import enum
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.quant import is_quantized, quantize_params
from repro_torch.common.types import ModelConfig
from repro_torch.core.track import (pt_chunk_hidden, pt_draft_config,
                                    pt_draft_params, pt_draft_step,
                                    pt_forward, pt_init_cache, map_blocks,
                                    shard_tracks)
from repro_torch.kernels.decode_attention import reserve_counters
from repro_torch.launch.steps import StepGraph, model_fns, plan_graphs
from repro_torch.models.decoder import _head
from repro_torch.models.layers import check_supported
from repro_torch.runtime.parallel import NO_PARALLEL, Parallelism
from repro_torch.serving.cache import PagedKVCache, insert_rows
from repro_torch.serving.sampler import (SALT_DRAFT, SALT_SAMPLE,
                                         SampleParams, accept_step,
                                         advance_decode, advance_spec,
                                         prefill_keys, row_keys,
                                         sample_rows, sample_step,
                                         stack_params)


RECURRENT_MIXERS = ("mamba", "rglru")


def _unported(what: str, item: Any) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP queue 1, item {item})")


def _ranks_unpipelined(what: str) -> NotImplementedError:
    return _unported(f"{what} on track ranks (a gloo collective cannot be "
                     "captured in a CUDA graph)", "7b")


def _refuse(**knobs: Tuple[Any, Any, int]) -> None:
    """knobs: name -> (value, off value, ROADMAP item)."""
    for name, (value, off, item) in knobs.items():
        if value != off:
            raise _unported(f"{name}={value!r}", item)


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    REJECTED = "rejected"      # never ran: failed validation


TERMINAL_STATES = (RequestState.DONE, RequestState.REJECTED)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    params: SampleParams = dataclasses.field(default_factory=SampleParams)
    on_token: Optional[Callable[["Request", int], None]] = None
    seed: int = 0                      # per-request PRNG seed (sampling)
    # filled by the engine
    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    truncated: bool = False            # max_new_tokens clamped to capacity
    finish_reason: Optional[str] = None
    prefilled: int = 0                 # prompt tokens already in the cache
    draft_filled: int = 0              # drafter cache tokens (chunked+spec)
    pending_first: Optional[int] = None  # first token parked until the
                                       # drafter catches up (chunked+spec)
    # monotonic (perf_counter) latency marks
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> float:
        n = max(1, len(self.output) - 1)
        return (self.t_done - self.t_first) / n

    @property
    def seq_tokens(self) -> List[int]:
        return self.prompt + self.output

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL_STATES


class EngineMetrics:
    """Aggregate serving metrics over completed requests."""

    def __init__(self) -> None:
        self.ttfts: List[float] = []
        self.tpots: List[float] = []
        self.prompt_tokens = 0
        self.output_tokens = 0
        self.max_active = 0
        self.rejected = 0
        self.t_start: Optional[float] = None
        self.t_last: Optional[float] = None
        # speculative decoding
        self.spec_steps = 0
        self.draft_proposed = 0        # usable drafts per slot per step
        self.draft_accepted = 0        # drafts the verify forward kept
        self.acceptance_ema: Optional[float] = None
        self.spec_tokens = 0           # tokens the spec steps emitted
        self.spec_slot_steps = 0       # decoding slots summed over them
        # pipelined stepping
        self.dispatch_gaps: List[float] = []   # s between step dispatches
        self.steps_in_flight = 0       # peak dispatched-but-unfetched steps

    def start(self) -> None:
        if self.t_start is None:
            self.t_start = time.perf_counter()

    def observe(self, req: Request) -> None:
        self.ttfts.append(req.ttft)
        self.tpots.append(req.tpot)
        self.prompt_tokens += len(req.prompt)
        self.output_tokens += len(req.output)
        self.t_last = req.t_done

    def observe_spec(self, accepted: int, proposed: int,
                     alpha: float = 0.2, emitted: int = 0,
                     slots: int = 0) -> None:
        """One speculative step's acceptance, summed over active slots,
        and the tokens it emitted over its ``slots`` decoding slots."""
        self.spec_tokens += emitted
        self.spec_slot_steps += slots
        if proposed <= 0:
            return
        self.spec_steps += 1
        self.draft_accepted += accepted
        self.draft_proposed += proposed
        rate = accepted / proposed
        self.acceptance_ema = (rate if self.acceptance_ema is None
                               else (1 - alpha) * self.acceptance_ema
                               + alpha * rate)

    def summary(self) -> Dict[str, Any]:
        """TTFT / TPOT percentiles (ms) and output-token throughput; safe
        on an engine that never finished a request."""
        def pct(xs: List[float]) -> Dict[str, float]:
            if not xs:
                return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "mean": 0.0}
            a = np.asarray(xs, np.float64) * 1e3
            return {"p50": float(np.percentile(a, 50)),
                    "p90": float(np.percentile(a, 90)),
                    "p99": float(np.percentile(a, 99)),
                    "mean": float(np.mean(a))}

        elapsed = ((self.t_last or time.perf_counter()) - self.t_start
                   if self.t_start is not None else 0.0)
        return {"requests": len(self.ttfts),
                "prompt_tokens": self.prompt_tokens,
                "output_tokens": self.output_tokens,
                "max_active": self.max_active,
                "rejected": self.rejected,
                "elapsed_s": elapsed,
                "throughput_tok_s": (self.output_tokens / elapsed
                                     if elapsed > 0 else 0.0),
                "ttft_ms": pct(self.ttfts),
                "tpot_ms": pct(self.tpots),
                "spec_steps": self.spec_steps,
                "acceptance_rate": (self.draft_accepted / self.draft_proposed
                                    if self.draft_proposed else 0.0),
                "acceptance_ema": (self.acceptance_ema
                                   if self.acceptance_ema is not None
                                   else 0.0),
                "tokens_per_slot_step": (self.spec_tokens
                                         / self.spec_slot_steps
                                         if self.spec_slot_steps else 0.0),
                "dispatch_gap_ms": pct(self.dispatch_gaps),
                "steps_in_flight": self.steps_in_flight}


class EngineStallError(RuntimeError):
    """``Engine.run`` exhausted its step budget with work still pending."""


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """FCFS admission over a fixed slot table, budgeted by prefill tokens.

    ``plan_admission`` pops queued requests in order while free slots,
    the per-round padded-token budget and (paged cache) free KV blocks
    last, grouping
    the admitted set by prefill bucket so each group runs as one batched
    prefill.  Strict FCFS: the first request that does not fit stops
    admission for the round, except that one oversized request is always
    admitted alone rather than livelocking."""

    def __init__(self, max_slots: int, bucket_fn: Callable[[int], int],
                 max_waiting_prefill_tokens: int = 4096,
                 charge_fn: Optional[Callable[[Request], int]] = None):
        self.max_slots = max_slots
        self.bucket_fn = bucket_fn
        self.charge_fn = charge_fn or (lambda r: bucket_fn(len(r.seq_tokens)))
        self.max_waiting_prefill_tokens = max_waiting_prefill_tokens
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots

    def submit(self, req: Request) -> None:
        req.state = RequestState.QUEUED
        self.queue.append(req)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active_slots(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def release(self, slot: int) -> None:
        self.slots[slot] = None

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def plan_admission(self, can_fit: Optional[Callable[[Request], bool]]
                       = None) -> List[Tuple[int, List[Tuple[int, Request]]]]:
        """[(bucket, [(slot, request), ...]), ...] for this round."""
        free = self.free_slots()
        budget = self.max_waiting_prefill_tokens
        groups: Dict[int, List[Tuple[int, Request]]] = {}
        admitted = 0
        while free and self.queue:
            head = self.queue[0]
            if can_fit is not None and not can_fit(head):
                break                      # wait for blocks, never skip
            bucket = self.bucket_fn(len(head.seq_tokens))
            if self.charge_fn(head) > budget and admitted:
                break                      # strict FCFS: wait, don't skip
            req = self.queue.popleft()
            slot = free.pop(0)
            self.slots[slot] = req
            req.state = RequestState.PREFILL
            groups.setdefault(bucket, []).append((slot, req))
            budget -= self.charge_fn(req)
            admitted += 1
        return sorted(groups.items())


# ---------------------------------------------------------------------------
# model runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Capability:
    """One serving feature's static support verdict for an architecture:
    ``supported`` plus a human-readable ``reason`` when it is not."""
    supported: bool
    reason: Optional[str] = None


def arch_capabilities(cfg: ModelConfig) -> Dict[str, Capability]:
    """Per-feature serving capabilities of an architecture, with recorded
    reasons for every gate (the reference's table, word for word; the
    port implements the verdicts of the features it has ported).

    Features:
      paged           — serve through the block-table cache (all decoder
                        archs; ring/state leaves stay dense per-slot
                        under the same block accounting)
      chunked_prefill — feed prompts chunk-by-chunk through the cache
      speculative     — track-speculative draft/verify decoding
      prefix_cache    — content-addressed block sharing across prompts
      int8_kv         — int8 block pools with fused dequant
      fork            — n-way copy-on-write request cloning
    """
    specs = [cfg.spec(nm) for nm in cfg.layer_names]
    has_moe = any(s.mlp == "moe" for s in specs)
    has_window = any(s.window is not None for s in specs)
    has_recurrent = any(s.mixer in RECURRENT_MIXERS for s in specs)
    has_mla = any(s.mixer == "mla" for s in specs)
    # every leaf a block-pool leaf: no per-slot ring/state rows at all
    all_paged = not (has_window or has_recurrent)

    def cap(ok: bool, why: Optional[str]) -> Capability:
        return Capability(ok, None if ok else why)

    paged = cap(cfg.encdec is None,
                "encoder-decoder cross-attention caches are per-request "
                "dense; served through the contiguous cache")
    chunked = cap(paged.supported and not has_moe,
                  paged.reason if not paged.supported else
                  "capacity-based MoE routing is batch-global: a padded "
                  "chunk row would steal expert capacity from real tokens")
    dense_reason = ("sliding-window ring leaves are per-slot rows, not "
                    "content-addressable blocks" if has_window else
                    "recurrent state is a per-slot row, not a "
                    "content-addressable block" if has_recurrent else None)
    prefix = cap(chunked.supported and all_paged,
                 dense_reason or chunked.reason)
    speculative = cap(cfg.pt is not None and chunked.supported and all_paged,
                      "track-speculative decoding needs the PT track "
                      "structure to slice a drafter from"
                      if cfg.pt is None else
                      dense_reason and (dense_reason + "; rejected draft "
                                        "tokens could not be rolled back")
                      or chunked.reason)
    int8_kv = cap(chunked.supported and all_paged and not has_mla,
                  dense_reason or chunked.reason or
                  "int8 quantization of MLA latent pools is unvalidated")
    fork = cap(paged.supported, paged.reason)
    return {"paged": paged, "chunked_prefill": chunked,
            "speculative": speculative, "prefix_cache": prefix,
            "int8_kv": int8_kv, "fork": fork}


# rows of the step programs' packed int32 input (``ModelRunner.step_in``):
# the sampling rows hold each slot's request seed (its 32-bit pattern),
# temperature and top-p (float32 bit patterns) and top-k
STEP_ROWS = ("tok", "pos", "active", "eos", "remaining", "counts",
             "override", "seed", "temp", "top_k", "top_p")


@dataclasses.dataclass
class _Stage:
    """Pinned host buffers of one step in flight: its packed input, its
    block table, the packed result's copy and the event that marks it
    landed (None on the CPU, where every copy is synchronous)."""
    inp: torch.Tensor
    table: Optional[torch.Tensor]
    out: torch.Tensor
    event: Any
    busy: bool = False


class ModelRunner:
    """Device side: the paged cache (K/V pools or state rows) or the
    contiguous cache (``paged=False``), bucketed or exact-length
    prefill, the chunk program, the decode step and the speculative
    step.  ``params`` must already live on ``device``; with
    ``weight_dtype="int8"`` the runner holds its own quantized copy (the
    caller may drop the fp tree).

    ``speculate_k > 0`` (a PT config on the paged cache; elsewhere it
    falls back to 0 with the capability table's reason in
    ``quant_fallbacks``) adds the track-subset drafter: the first
    ``draft_tracks`` tracks (default ``max(1, n_tracks // 2)``) as views
    of the runner's blocks, sharing its embedding, final norm and head,
    with a contiguous cache of its own (``pt_init_cache(draft_cfg,
    max_slots, max_seq_len)``).  With int8 weights the drafter's blocks
    are quantized after the slice, on their own.  ``pipeline_depth`` is
    the engine's: it sizes the host staging for the steps in flight.

    On a track rank (``par``, a PT config) the runner holds its n/W
    tracks of the blocks and of the cache; ``params`` is the full tree,
    of which it keeps its share (``shard_tracks``).  Embed, final norm,
    head and the drafter's tracks are replicated: the drafter's blocks
    are views where its tracks lie in the rank's range, else copies of
    tracks [0, draft_tracks) of the full tree.  Every forward, decode
    and verify then makes R collectives (one per track block), the
    drafter none, and every rank samples the same tokens from the same
    full logits."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_seq_len: int, min_bucket: int = 16,
                 paged: bool = True,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 0, kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 speculate_k: int = 0, draft_tracks: int = 0,
                 pipeline_depth: int = 0, device: DeviceLike = None,
                 par: Parallelism = NO_PARALLEL):
        self.device = resolve_device(device)
        check_supported(cfg)
        if par.sharded and pipeline_depth:
            raise _ranks_unpipelined(f"pipeline_depth={pipeline_depth}")
        if kv_dtype not in (None, "float32", "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        if weight_dtype not in (None, "float32", "int8"):
            raise ValueError(f"unsupported weight_dtype {weight_dtype!r}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the runner on {self.device}")
        self.cfg = cfg
        self.par = par
        self.params = shard_tracks(params, cfg, par)
        self.fns = model_fns(cfg, par)
        self.capabilities = arch_capabilities(cfg)
        caps = self.capabilities
        # padded tokens would run through a recurrent layer's conv window
        # and state: those architectures prefill at exact prompt length
        self.exact_prefill = any(cfg.spec(nm).mixer in RECURRENT_MIXERS
                                 for nm in cfg.layer_names)
        self.paged = paged and caps["paged"].supported
        # effective dtypes (None = full precision) and, as in the
        # reference, the reason for each requested int8 arm not taken
        self.kv_dtype: Optional[str] = None
        self.weight_dtype: Optional[str] = None
        self.quant_fallbacks: List[str] = []
        if kv_dtype == "int8":
            if self.paged and caps["int8_kv"].supported:
                self.kv_dtype = "int8"
            else:
                why = (caps["int8_kv"].reason
                       if self.paged and caps["int8_kv"].reason
                       else "needs the paged cache")
                self.quant_fallbacks.append(
                    f"kv_dtype=int8: {why}; serving fp KV")
        # track-speculative decoding, gated as in the reference
        self.speculate_k = 0
        self.draft_tracks = 0
        draft_blocks = None
        if speculate_k > 0:
            if self.paged and caps["speculative"].supported:
                self.speculate_k = speculate_k
                d = draft_tracks or max(1, cfg.pt.n_tracks // 2)
                self.draft_tracks = min(d, cfg.pt.n_tracks)
                self.draft_cfg = pt_draft_config(cfg, self.draft_tracks)
                draft_blocks = self._draft_blocks(params)
                self.draft_cache = pt_init_cache(self.draft_cfg, max_slots,
                                                 max_seq_len,
                                                 device=self.device)
                self.draft_prefill_shapes: set = set()
                self.draft_chunk_shapes: set = set()
            else:
                why = caps["speculative"].reason or "needs the paged cache"
                self.quant_fallbacks.append(
                    f"speculate_k={speculate_k}: {why}; serving plain "
                    "decode")
        self.n_quantized = 0
        if weight_dtype == "int8":
            self.params, self.n_quantized = quantize_params(self.params)
            if self.n_quantized:
                self.weight_dtype = "int8"
                if draft_blocks is not None:
                    draft_blocks = quantize_params(
                        {"blocks": draft_blocks})[0]["blocks"]
            else:
                self.quant_fallbacks.append(
                    "weight_dtype=int8: no quantizable weight leaves in "
                    "this architecture; serving fp weights")
        head = self.params.get("head")
        if cfg.logits_fp32 and head is not None and not is_quantized(head):
            # the LM head runs in fp32 (as the reference does); an fp32
            # copy is kept once instead of casting the head every step
            self.params = dict(self.params, head=head.float())
        if draft_blocks is not None:
            # embed, final norm and head: the runner's own (its fp32 or
            # int8 head; quantizing the drafter's copy would give the same
            # bytes)
            self.draft_params = dict(self.params, blocks=draft_blocks)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.min_bucket = min_bucket
        self.prefill_chunk = (prefill_chunk if self.paged
                              and caps["chunked_prefill"].supported else 0)
        self.kv: Optional[PagedKVCache] = None
        if self.paged:
            self.kv = PagedKVCache(cfg, max_slots=max_slots,
                                   max_seq_len=max_seq_len,
                                   block_size=block_size,
                                   num_blocks=num_blocks,
                                   kv_dtype=self.kv_dtype,
                                   device=self.device, par=par)
            self.cache = self.kv.engine_cache()
        else:
            self.cache = self.fns["init_cache"](cfg, max_slots, max_seq_len,
                                                device=self.device)
        self._table_key = None             # (kv.version, active bytes)
        # the step programs' static tensors, which every decode or spec
        # step of this runner (replayed or eager) reads and writes: the
        # packed host inputs (STEP_ROWS), the masked block table, and
        # the packed result followed by the step's inputs as carried
        B, K = max_slots, self.speculate_k
        i32 = dict(dtype=torch.int32, device=self.device)
        self.step_in = torch.zeros((len(STEP_ROWS), B), **i32)
        self.step_table = (torch.zeros((B, self.kv.blocks_per_seq), **i32)
                           if self.paged else None)
        self.step_out = torch.zeros((K + 5 if K else 6, B), **i32)
        # host staging, one slot per step that may be in flight: a
        # non-blocking copy reads its pinned source after the host moved on
        self._stages = [self._new_stage() for _ in range(pipeline_depth + 1)]
        self._stage_at = 0
        self.programs: Dict[tuple, StepGraph] = {}   # (kind, bounds) ->
        self._pool = None                  # their one memory pool
        self.planned_hits = 0              # steps run as a replay
        self.plan_seconds = 0.0            # wall time of plan_programs
        self.prefill_shapes: set = set()   # observed (n_reqs, bucket)
        self.chunk_shapes: set = set()     # observed (n_reqs, chunk)
        self.prefill_calls = 0
        self.chunk_calls = 0               # chunk forwards (incl. int8-KV
                                           # whole-prompt prefills)
        self.decode_transfers = 0          # host transfers in decode steps

    def _draft_blocks(self, params):
        """The drafter's blocks, tracks [0, draft_tracks) of the full tree
        ``params``: views of the runner's blocks where this rank holds
        them (always in one process), else copies."""
        d, (lo, hi) = self.draft_tracks, self.par.track_range(self.cfg)
        if lo == 0 and d <= hi:
            return pt_draft_params(self.params, self.cfg, d)["blocks"]
        return map_blocks(torch.clone,
                          pt_draft_params(params, self.cfg, d)["blocks"])

    # -- bucket policy --------------------------------------------------
    def bucket_for(self, length: int) -> int:
        """Power-of-two padding bucket, capped at the engine capacity
        (the length itself for recurrent architectures)."""
        if length > self.max_seq_len:
            raise ValueError(f"prompt length {length} exceeds engine "
                             f"capacity {self.max_seq_len}")
        if self.exact_prefill:
            return length
        b = self.min_bucket
        while b < length:
            b *= 2
        return min(b, self.max_seq_len)

    def admission_charge(self, req: Request) -> int:
        """Prefill tokens a request costs per admission round: its padded
        bucket, or one chunk when chunked prefill spreads the rest over
        later steps."""
        bucket = self.bucket_for(len(req.seq_tokens))
        return min(bucket, self.prefill_chunk) if self.prefill_chunk \
            else bucket

    def cache_stats(self) -> Dict[str, Any]:
        """Cache mode, the quantization in effect and (paged cache) pool
        occupancy and leaf layouts."""
        quant = {"weight_dtype": self.weight_dtype or "float32",
                 "quantized_weight_leaves": self.n_quantized,
                 "quant_fallbacks": list(self.quant_fallbacks)}
        if not self.paged:
            return {"mode": "contiguous", **quant}
        stats = dict(self.kv.utilization())
        stats.update(mode="paged", block_size=self.kv.block_size,
                     state_bytes=self.kv.state_bytes(), **quant)
        return stats

    # -- device steps ---------------------------------------------------
    def _to_dev(self, a, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def _sample_first(self, last: torch.Tensor, seeds: Sequence[int],
                      counters: Sequence[int],
                      params_list: Sequence[SampleParams]) -> torch.Tensor:
        """The token each prompt's last row samples [n]: draw
        ``counters[i]`` of its request's stream (``prefill_keys``; 0 for
        a fresh prompt); an all-greedy batch takes the argmax alone."""
        temps, tks, tps = stack_params(params_list)
        if not (temps > 0).any():
            return sample_rows(last, None)
        keys = prefill_keys(self._to_dev(np.asarray(seeds, np.int64),
                                         torch.long),
                            self._to_dev(np.asarray(counters, np.int64),
                                         torch.long))
        return sample_rows(last, keys, self._to_dev(temps, torch.float32),
                           self._to_dev(tks, torch.int32),
                           self._to_dev(tps, torch.float32))

    @torch.no_grad()
    def prefill(self, prompts: Sequence[Sequence[int]], bucket: int,
                slots: Sequence[int], seeds: Sequence[int],
                counters: Sequence[int],
                params_list: Sequence[SampleParams]) -> np.ndarray:
        """Batched prefill of ``prompts`` (right-padded to ``bucket``; a
        recurrent architecture's bucket is the prompts' one length) into
        cache ``slots``.  Returns the first sampled token of each prompt
        [n] (each row's draw ``counters[i]`` of the stream of
        ``seeds[i]``).  The prefill cache goes in through
        ``kv.insert_prefill`` (paged) or ``insert_rows`` (contiguous)."""
        n = len(prompts)
        tokens = np.zeros((n, bucket), np.int64)
        lengths = np.empty((n,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
            lengths[i] = len(p)
        len_d = self._to_dev(lengths, torch.long)
        logits, cache = self.fns["forward"](
            self.params, {"inputs": self._to_dev(tokens, torch.long)},
            self.cfg, mode="prefill")
        last = logits[torch.arange(n, device=self.device), len_d - 1]
        toks = self._sample_first(last, seeds, counters, params_list)
        if self.paged:
            self.kv.insert_prefill(cache, slots, self.kv.table_rows(slots))
        else:
            insert_rows(self.cache, cache, slots)
        self.prefill_shapes.add((n, bucket))
        self.prefill_calls += 1
        return toks.cpu().numpy()

    def _chunk(self, toks: np.ndarray, pos: np.ndarray,
               slots: Sequence[int], last_idx: np.ndarray,
               seeds: Sequence[int], counters: Sequence[int],
               params_list: Sequence[SampleParams]) -> np.ndarray:
        """The chunk program for n rows: toks [n, C] appended at
        pos[:, None] + arange(C) through the block-table rows of
        ``slots`` (the whole table row is gathered, as the reference's
        chunk call passes no ``kv_max_len``); state rows advance at
        ``slots`` by ``last_idx + 1`` valid tokens.  Returns the token
        sampled at each row's ``last_idx`` [n] (draw ``counters[i]`` of
        the stream of ``seeds[i]``) -- meaningful only for a row's final
        chunk.  The LM head runs on those n rows only (the
        reference takes them from the logits of all n * C rows; the head
        is row-wise)."""
        n = len(toks)
        h = self.fns["chunk_hidden"](
            self.params, self.cache, self._to_dev(toks, torch.long),
            self._to_dev(pos, torch.int32), self.cfg,
            block_table=self.kv.table_rows(slots),
            slots=self._to_dev(slots, torch.long),
            chunk_lens=self._to_dev(np.asarray(last_idx) + 1, torch.long))
        last = h[torch.arange(n, device=self.device),
                 self._to_dev(last_idx, torch.long)]
        cand = self._sample_first(_head(self.params, last, self.cfg), seeds,
                                  counters, params_list)
        self.chunk_shapes.add(tuple(np.shape(toks)))
        self.chunk_calls += 1
        return cand.cpu().numpy()

    @torch.no_grad()
    def chunk(self, toks: np.ndarray, pos: np.ndarray, slots: Sequence[int],
              last_idx: np.ndarray, seeds: Sequence[int],
              counters: Sequence[int],
              params_list: Sequence[SampleParams]) -> np.ndarray:
        """One chunk step for the requests prefilling in ``slots``."""
        return self._chunk(toks, pos, slots, last_idx, seeds, counters,
                           params_list)

    @torch.no_grad()
    def warm_prefill(self, prompts: Sequence[Sequence[int]],
                     slots: Sequence[int], seeds: Sequence[int],
                     counters: Sequence[int],
                     params_list: Sequence[SampleParams]) -> np.ndarray:
        """Whole prompts through the chunk program, one call right-padded
        to the bucket of the longest: the int8-KV route of cold prompts.
        (The reference's ``warm_prefill`` also starts each prompt after a
        matched cached prefix; with the prefix cache not ported that
        prefix is always empty.)  Returns first tokens [n]."""
        n = len(prompts)
        bucket = self.bucket_for(max(len(p) for p in prompts))
        toks = np.zeros((n, bucket), np.int64)
        last_idx = np.empty((n,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            last_idx[i] = len(p) - 1
        return self._chunk(toks, np.zeros((n,), np.int32), slots, last_idx,
                           seeds, counters, params_list)

    def _table_rows(self, active) -> Optional[np.ndarray]:
        """The block table with inactive lanes' rows zeroed (their writes
        land in the trash block), when it differs from what
        ``step_table`` holds (allocate / free / active-set changes), else
        None."""
        act = np.asarray(active, bool)
        key = (self.kv.version, act.tobytes())
        if key == self._table_key:
            return None
        self._table_key = key
        return self.kv.table_np * act.astype(np.int32)[:, None]

    def _masked_table(self, active) -> torch.Tensor:
        """``step_table`` holding the masked table of ``active``, copied
        in (synchronously) when it changed; the steps stage theirs."""
        rows = self._table_rows(active)
        if rows is not None:
            self.step_table.copy_(torch.from_numpy(rows))
        return self.step_table

    def _bound(self, length: int, paged: bool) -> int:
        """Power-of-two bound on ``length`` positions, in blocks (paged)
        or positions (contiguous), capped at the capacity, in
        positions."""
        unit, cap = ((self.kv.block_size, self.kv.blocks_per_seq)
                     if paged else (1, self.max_seq_len))
        need = -(-length // unit)
        p2 = 1
        while p2 < need:
            p2 *= 2
        return min(cap, p2) * unit

    def _live_max_len(self, pos: np.ndarray, active: np.ndarray,
                      extra=0, paged: Optional[bool] = None
                      ) -> Optional[int]:
        """Power-of-two bound on the live cache prefix of the active
        lanes, in blocks (paged) or positions (contiguous), capped at
        the capacity: the decode kernel sweeps nothing past it.
        ``extra`` (an int, or one per lane) widens it by positions a
        step writes past ``pos``: the speculative step's K, and the
        steps still in flight of a pipelined engine, whose positions
        the host mirror lags; ``paged`` picks the cache (default: the
        engine's; the drafter's is contiguous)."""
        act = np.asarray(active, bool)
        if not act.any():
            return None
        paged = self.paged if paged is None else paged
        far = int((np.asarray(pos, np.int64) + extra)[act].max()) + 1
        return self._bound(far, paged)

    # -- the decode and speculative steps: dispatch, wait, programs -----
    #
    # A step is a DISPATCH, which stages the host inputs, runs the step
    # program (a replayed CUDA graph when one is planned for its bounds,
    # else the same function eagerly) and enqueues the copy of its packed
    # result to the host, and a WAIT, the one host transfer.  The sync
    # engine waits right away; the pipelined one dispatches step N + 1
    # first, whose inputs the program composes on the device from step
    # N's result (``carry``), but for lanes marked in ``override``.

    def _new_stage(self) -> "_Stage":
        pin = self.device.type == "cuda"

        def host(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            return None if t is None else torch.zeros(
                t.shape, dtype=t.dtype, pin_memory=pin)

        return _Stage(host(self.step_in), host(self.step_table),
                      host(self.step_out),
                      torch.cuda.Event() if pin else None)

    def _sampling_rows(self) -> Tuple[torch.Tensor, ...]:
        """The staged (seed, temperature, top-k, top-p) rows of
        ``step_in``, as views of their dtypes."""
        seed, temp, top_k, top_p = self.step_in[len(STEP_ROWS) - 4:]
        return (seed, temp.view(torch.float32), top_k,
                top_p.view(torch.float32))

    def _decode_body(self, max_len: Optional[int],
                     sampled: bool) -> torch.Tensor:
        """The decode step program over the static tensors: the carry,
        the model's decode step (``active`` keeps the contiguous and
        state rows of idle lanes and of lanes mid-chunked-prefill; pool
        leaves are protected by the zeroed table rows) and the sampling
        epilogue: the argmax alone (``sampled`` False), or each row's
        draw under ``row_keys(seed, counts, SALT_SAMPLE)``, its keys
        derived here, on the device, from the staged seeds and the
        carried counts.  Returns the logits."""
        tok, pos, act, eos, rem, cnt, ovr = self.step_in.unbind(0)[:7]
        out = self.step_out
        tok, pos, cnt, rem = advance_decode(out[:2], out[2], out[3], out[4],
                                            out[5], ovr.bool(), tok, pos,
                                            cnt, rem)
        active = act.bool()
        logits, _ = self.fns["decode"](
            self.params, self.cache, tok.long(), pos, self.cfg,
            block_table=self.step_table, kv_max_len=max_len, active=active)
        seed, temp, top_k, top_p = (self._sampling_rows() if sampled
                                    else (None,) * 4)
        keys = row_keys(seed, cnt, SALT_SAMPLE) if sampled else None
        packed = sample_step(logits, keys, temp, top_k, top_p, active, eos,
                             rem)
        out.copy_(torch.cat([packed, torch.stack([tok, pos, cnt, rem])]))
        return logits

    def _spec_body(self, draft_len: Optional[int],
                   verify_len: Optional[int], sampled: bool) -> torch.Tensor:
        """The speculative step program over the static tensors: the
        carry, K draft steps of the drafter, one more at pos + K (no head)
        so that d_K's K/V lands there too (on the all-accepted path the
        next step starts at pos + K + 1), ONE (K+1)-token verify of the
        target through the chunk program on the paged cache, and
        ``accept_step``: greedy, or (``sampled``) the drafter's tokens
        drawn under ``row_keys(seed, counts + j, SALT_DRAFT)`` and the
        rejection-sampling accept.  ``active`` freezes the drafter rows
        of idle lanes and of lanes whose drafter is being chunk-filled; the
        target's idle lanes write through zeroed table rows, and verify
        rows past a slot's reservation fall through its zeroed table
        columns, into trash block 0.  Returns the verify's logits."""
        K = self.speculate_k
        tok, pos, act, _, _, cnt, ovr = self.step_in.unbind(0)[:7]
        seed, temp, top_k, top_p = (self._sampling_rows() if sampled
                                    else (None,) * 4)
        out = self.step_out
        tok, pos, cnt = advance_spec(out[:K + 2], out[K + 2], out[K + 3],
                                     out[K + 4], ovr.bool(), tok, pos, cnt)
        active = act.bool()
        t, d_toks, d_logits = tok, [], []
        for j in range(K + 1):
            logits, _ = pt_draft_step(self.draft_params, self.draft_cache,
                                      t, pos + j, self.draft_cfg,
                                      active=active, kv_max_len=draft_len,
                                      head=j < K, par=self.par)
            if j < K:
                keys = (row_keys(seed, cnt + j, SALT_DRAFT) if sampled
                        else None)
                t = sample_rows(logits, keys, temp, top_k, top_p)
                d_toks.append(t)
                d_logits.append(logits)
        seq = torch.stack([tok] + d_toks, dim=1)                # [B, K+1]
        tgt, _ = self.fns["chunk"](self.params, self.cache, seq, pos,
                                   self.cfg, block_table=self.step_table,
                                   kv_max_len=verify_len)
        packed = accept_step(tgt, torch.stack(d_logits, dim=1),
                             torch.stack(d_toks, dim=1),
                             seed if sampled else None, cnt, temp, top_k,
                             top_p, active)
        out.copy_(torch.cat([packed, torch.stack([tok, pos, cnt])]))
        return tgt

    def _body(self, key: tuple) -> Callable[[], torch.Tensor]:
        # through a weak reference: a graph that held its runner would
        # make a cycle, left to the garbage collector to free
        me = weakref.ref(self)
        if key[0] == "decode":
            return lambda: me()._decode_body(key[1], key[2])
        return lambda: me()._spec_body(key[1], key[2], key[3])

    def _dispatch_step(self, key: tuple, toks, pos, active, eos, remaining,
                       counts, carry, override, sampling) -> Dict[str, Any]:
        st = self._stages[self._stage_at]
        if st.busy:
            raise RuntimeError("more steps in flight than the runner's "
                               f"pipeline_depth + 1 = {len(self._stages)} "
                               "staging slots")
        self._stage_at = (self._stage_at + 1) % len(self._stages)
        rows = st.inp.numpy()
        for i, v in enumerate((toks, pos, active,
                               -1 if eos is None else eos,
                               0 if remaining is None else remaining,
                               0 if counts is None else counts,
                               1 if carry is None else override)
                              + sampling):
            rows[i] = v
        nb = st.event is not None
        self.step_in.copy_(st.inp, non_blocking=nb)
        table = self._table_rows(active) if self.paged else None
        if table is not None:
            st.table.numpy()[:] = table
            self.step_table.copy_(st.table, non_blocking=nb)
        prog = self.programs.get(key)
        if prog is not None:
            result = prog.replay()
            self.planned_hits += 1
        else:
            result = self._body(key)()
        st.out.copy_(self.step_out, non_blocking=nb)
        if nb:
            st.event.record()
        st.busy = True
        return {"key": key, "stage": st, "logits": result,
                "active": np.asarray(active, bool).copy()}

    def _wait(self, handle: Dict[str, Any]) -> np.ndarray:
        st = handle["stage"]
        if st.event is not None:
            st.event.synchronize()
        host = st.out.numpy().copy()             # THE transfer
        st.busy = False
        self.decode_transfers += 1
        return host

    def _sampling(self, active, temps, seeds, top_k, top_p
                  ) -> Tuple[bool, tuple]:
        """Whether a step runs the sampled program (an active lane with
        temperature > 0), and its staged sampling rows: the seeds' and
        the float rows' 32-bit patterns (defaults: seed 0, top-k 0,
        top-p 1)."""
        B = self.max_slots
        temps = np.asarray(temps, np.float32)
        sampled = bool((temps[np.asarray(active, bool)] > 0).any())
        bits = lambda a, dt, fill: (np.full((B,), fill, dt) if a is None
                                    else np.asarray(a).astype(dt))
        return sampled, (bits(seeds, np.uint32, 0).view(np.int32),
                         temps.view(np.int32),
                         bits(top_k, np.int32, 0),
                         bits(top_p, np.float32, 1.0).view(np.int32))

    @torch.no_grad()
    def dispatch_decode(self, toks, pos, active, temps, eos, remaining,
                        counts=None, *, seeds=None, top_k=None, top_p=None,
                        carry=None, override=None,
                        extra_len=0) -> Dict[str, Any]:
        """Dispatch one decode step for all slots; no host transfer.
        ``temps`` / ``top_k`` / ``top_p`` are the slots' sampling
        parameters and ``seeds`` their request seeds (host arrays); a
        step with no active sampled lane runs the greedy program.
        ``carry`` (the previous step's handle) feeds that step's result
        in on the device, but for lanes marked in ``override``;
        ``extra_len`` (an int or one per lane) widens the sweep bound by
        the positions the steps in flight advanced past ``pos``."""
        sampled, rows = self._sampling(active, temps, seeds, top_k, top_p)
        key = ("decode", self._live_max_len(pos, active, extra=extra_len),
               sampled)
        return self._dispatch_step(key, toks, pos, active, eos, remaining,
                                   counts, carry, override, rows)

    def wait_decode(self, handle: Dict[str, Any]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The one host transfer of a dispatched decode step: the packed
        (token, done) array."""
        host = self._wait(handle)
        return host[0], host[1].astype(bool)

    @torch.no_grad()
    def dispatch_spec(self, toks, pos, active, temps, counts=None, *,
                      seeds=None, top_k=None, top_p=None, carry=None,
                      override=None, extra_len=0) -> Dict[str, Any]:
        """Dispatch one speculative step (``_spec_body``) for all slots;
        no host transfer.  The sampling arguments, ``carry``,
        ``override``, ``extra_len`` as in ``dispatch_decode``; the
        drafter's and the verify's bounds widen by K beside
        ``extra_len``."""
        sampled, rows = self._sampling(active, temps, seeds, top_k, top_p)
        extra = self.speculate_k + np.asarray(extra_len)
        key = ("spec", self._live_max_len(pos, active, extra, paged=False),
               self._live_max_len(pos, active, extra), sampled)
        return self._dispatch_step(key, toks, pos, active, None, None,
                                   counts, carry, override, rows)

    def wait_spec(self, handle: Dict[str, Any]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """The one host transfer of a dispatched speculative step: the
        packed [K+2, slots] result.  Returns (tokens [slots, K+1],
        emitted counts [slots])."""
        host = self._wait(handle)
        K = self.speculate_k
        return host[:K + 1].T, host[K + 1]

    def _program_keys(self) -> List[tuple]:
        """The (kind, bounds, sampled) of every step program a run may
        dispatch: decode, one per power-of-two bound of the engine's
        cache (blocks up to ``blocks_per_seq`` paged, positions up to
        ``max_seq_len`` contiguous); speculative, one per pair (drafter's
        contiguous bound, verify's paged bound) that one live length
        gives; each greedy and sampled."""
        top = self.max_seq_len
        if self.paged:
            top = max(top, self.kv.blocks_per_seq * self.kv.block_size)
        lengths = range(1, top + 1)
        if self.speculate_k:
            bounds = {("spec", self._bound(n, False), self._bound(n, True))
                      for n in lengths}
        else:
            bounds = {("decode", self._bound(n, self.paged))
                      for n in lengths}
        return sorted(b + (s,) for b in bounds for s in (False, True))

    @torch.no_grad()
    def plan_programs(self, sampled: Sequence[bool] = (False, True)) -> int:
        """Capture one CUDA graph per step program (``_program_keys``;
        of the variants in ``sampled``: the greedy ones, the sampled
        ones, or both), all in one memory pool, so that a dispatch
        replays a ready program with no Python launch on the hot path; a
        shape with no program runs eagerly.  Warm-up and capture run
        with every lane idle: pool writes go through zeroed table rows
        into trash block 0, and the contiguous, state and drafter rows
        are kept by ``active``, so no live cache byte changes.  The
        decode kernels' ticket counters are sized first, for the most
        (track, row, KV head) bases any program launches.  On the CPU the
        programs are run once each and replayed as eager calls.  Returns
        the number of programs."""
        if self.par.sharded:
            raise _ranks_unpipelined("plan_programs")
        if any(st.busy for st in self._stages):
            raise RuntimeError("plan_programs with steps in flight")
        todo = {k: self._body(k) for k in self._program_keys()
                if k not in self.programs and k[-1] in sampled}
        if not todo:
            return len(self.programs)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            tracks = self.cfg.pt.n_tracks if self.cfg.pt else 1
            reserve_counters(self.device,
                             tracks * self.max_slots * self.cfg.n_kv_heads)
        self.step_in.zero_()
        self.step_in[STEP_ROWS.index("eos")] = -1
        self.step_in[STEP_ROWS.index("override")] = 1
        self.step_in[STEP_ROWS.index("top_p")] = int(
            np.float32(1.0).view(np.int32))
        if self.paged:
            self.step_table.zero_()
            self._table_key = None
        graphs = plan_graphs(todo, self.device, self._pool)
        self._pool = next(iter(graphs.values())).pool
        self.programs.update(graphs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.plan_seconds += time.perf_counter() - t0
        return len(self.programs)

    # -- the track-subset drafter and the speculative step ---------------
    @torch.no_grad()
    def draft_prefill(self, prompts: Sequence[Sequence[int]], bucket: int,
                      slots: Sequence[int]) -> None:
        """Fill the drafter's contiguous cache rows ``slots`` with the
        prompts (one batched narrow forward, right-padded to ``bucket``,
        no LM head: the first token comes from the target's prefill), in
        through ``insert_rows``.  The bucketed-admission path; chunked
        admissions use ``draft_chunk``."""
        n = len(prompts)
        tokens = np.zeros((n, bucket), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        _, cache = pt_forward(self.draft_params,
                              {"inputs": self._to_dev(tokens, torch.long)},
                              self.draft_cfg, head=False,
                              par=self.par.without_axis("track"))
        insert_rows(self.draft_cache, cache, slots)
        self.draft_prefill_shapes.add((n, bucket))

    @torch.no_grad()
    def draft_chunk(self, toks: np.ndarray, pos: np.ndarray,
                    slots: Sequence[int]) -> None:
        """Advance the drafter's cache one chunk per prefilling row
        (``toks`` [n, C] at positions ``pos[:, None] + arange(C)``): the
        rows at ``slots`` are gathered (a copy), run through the chunk
        program with no block table and no head, and written back.
        Positions past a row's tokens write pad K/V that decode's causal
        mask never reads before it is overwritten."""
        idx = self._to_dev(slots, torch.long)
        rows = {"blocks": tuple(leaf.index_select(3, idx)
                                for leaf in self.draft_cache["blocks"]),
                "tail": ()}
        pt_chunk_hidden(self.draft_params, rows,
                        self._to_dev(toks, torch.long),
                        self._to_dev(pos, torch.int32), self.draft_cfg,
                        par=self.par.without_axis("track"))
        insert_rows(self.draft_cache, rows, slots)
        self.draft_chunk_shapes.add(tuple(np.shape(toks)))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class Engine:
    """The serving loop over one ``ModelRunner``: synchronous, or with
    ``pipeline_depth > 0`` pipelined (step N + 1 is dispatched before
    step N's host transfer is waited on); ``preplan`` captures the step
    programs (``ModelRunner.plan_programs``) when the engine is built.

    Runs on CUDA unless ``device='cpu'`` is given; the knobs of reference
    features not ported yet must stay at their off values.  ``paged``
    picks the paged cache (the default) or the contiguous one.  ``par``
    serves a PT model on one track rank of a ``torch.distributed`` group
    (``runtime.parallel``): every rank runs this loop on the same
    requests, in the same order, and emits the same tokens; the
    pipelined engine and planned programs are refused there."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq_len: int = 256,
                 max_waiting_prefill_tokens: int = 4096,
                 min_bucket: int = 16, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False, device: DeviceLike = None,
                 paged: bool = True, prefill_chunk: int = 0,
                 speculate_k: int = 0, draft_tracks: int = 0,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 pipeline_depth: int = 0, preplan: bool = False,
                 seed: int = 0, max_queue: Optional[int] = None,
                 fault_plan: Any = None, par: Parallelism = NO_PARALLEL):
        _refuse(prefix_cache=(prefix_cache, False, 5),
                max_queue=(max_queue, None, 8),
                fault_plan=(fault_plan, None, 8))
        if par.sharded and preplan:
            raise _ranks_unpipelined("preplan=True")
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got "
                             f"{pipeline_depth}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.runner = ModelRunner(cfg, params, max_slots=max_slots,
                                  max_seq_len=max_seq_len,
                                  min_bucket=min_bucket, paged=paged,
                                  block_size=block_size,
                                  num_blocks=num_blocks,
                                  prefill_chunk=prefill_chunk,
                                  kv_dtype=kv_dtype,
                                  weight_dtype=weight_dtype,
                                  speculate_k=speculate_k,
                                  draft_tracks=draft_tracks,
                                  pipeline_depth=pipeline_depth,
                                  device=device, par=par)
        if preplan:
            self.runner.plan_programs()
        self.scheduler = Scheduler(max_slots, self.runner.bucket_for,
                                   max_waiting_prefill_tokens,
                                   charge_fn=self.runner.admission_charge)
        self.metrics = EngineMetrics()
        self.seed = seed               # base for derived per-request seeds
        self._next_rid = 0
        self.steps_run = 0
        B = max_slots
        self._tok = np.zeros((B,), np.int32)
        self._pos = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._temps = np.zeros((B,), np.float32)
        self._topks = np.zeros((B,), np.int32)
        self._topps = np.ones((B,), np.float32)
        self._seeds = np.zeros((B,), np.uint32)    # per-request PRNG seed
        self._eos = np.full((B,), -1, np.int32)
        self._remaining = np.zeros((B,), np.int32)
        self._counts = np.zeros((B,), np.int32)    # tokens emitted so far

        # pipelined stepping (pipeline_depth >= 1): dispatched steps whose
        # transfer has not been waited on yet, oldest first.
        # ``_host_fresh[slot]`` marks lanes whose host-side inputs are
        # authoritative for the next dispatch (newly admitted); carried
        # lanes advance on the device from the previous step's result.
        # ``_slot_gen`` counts slot reassignments, so that an in-flight
        # result for a previous tenant of the slot is discarded.
        # ``_ahead[slot]`` counts the tenant's steps in flight: the
        # positions (a plain step's exactly, a speculative step's at
        # least) that the device is ahead of the host mirror.
        self.pipeline_depth = pipeline_depth
        self._inflight: deque = deque()
        self._host_fresh = np.ones((B,), bool)
        self._slot_gen = np.zeros((B,), np.int64)
        self._ahead = np.zeros((B,), np.int32)
        self._last_dispatch_t: Optional[float] = None

    # ------------------------------------------------------------------
    def _reserve_tokens(self, req: Request) -> int:
        """Cache positions a request occupies over its lifetime: prompt
        plus decode writes (the last sampled token is never written)."""
        L = len(req.prompt)
        cap = self.max_seq_len - L + 1
        return L + min(req.max_new_tokens, cap) - 1

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               params: SampleParams = SampleParams(),
               on_token: Optional[Callable[[Request, int], None]] = None,
               seed: Optional[int] = None, *, priority: int = 0,
               deadline_s: Optional[float] = None,
               on_event: Optional[Callable[[Request, str], None]] = None
               ) -> Request:
        """Queue a request.  ``params`` sets its sampling (greedy by
        default); ``seed`` keys its sampling stream, so that with the same
        seed it draws the same tokens whatever shares its batch (default:
        ``(engine seed * 1_000_003 + request id) & 0x7FFFFFFF``, as in the
        reference).  Invalid requests (empty or overlong prompt,
        non-positive token budget, on the paged cache a reservation
        larger than the whole block pool) come back REJECTED with
        ``finish_reason`` set."""
        _refuse(priority=(priority, 0, 8), deadline_s=(deadline_s, None, 8),
                on_event=(on_event, None, 8))
        if seed is None:
            seed = (self.seed * 1_000_003 + self._next_rid) & 0x7FFFFFFF
        req = Request(self._next_rid, list(prompt), max_new_tokens, eos_id,
                      params, on_token, seed=seed)
        req.t_submit = time.perf_counter()
        self._next_rid += 1
        kv = self.runner.kv
        reason = None
        if not req.prompt:
            reason = "empty prompt"
        elif max_new_tokens <= 0:
            reason = f"max_new_tokens must be positive, got {max_new_tokens}"
        elif len(req.prompt) > self.max_seq_len:
            reason = (f"prompt length {len(req.prompt)} exceeds engine "
                      f"capacity {self.max_seq_len}")
        elif kv is not None and \
                kv.blocks_for(self._reserve_tokens(req)) > kv.num_blocks - 1:
            reason = (f"request needs "
                      f"{kv.blocks_for(self._reserve_tokens(req))} KV blocks "
                      f"but the pool holds {kv.num_blocks - 1}")
        if reason is not None:
            req.state = RequestState.REJECTED
            req.finish_reason = reason
            req.t_done = time.perf_counter()
            self.metrics.rejected += 1
            return req
        self.metrics.start()
        self.scheduler.submit(req)
        return req

    def fork(self, *args, **kwargs):
        raise _unported("Engine.fork (copy-on-write)", 5)

    def cancel(self, *args, **kwargs):
        raise _unported("Engine.cancel", 8)

    # ------------------------------------------------------------------
    def _emit(self, req: Request, tok: int) -> None:
        req.output.append(tok)
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finish(self, slot: int, req: Request) -> None:
        req.state = RequestState.DONE
        req.t_done = time.perf_counter()
        self._active[slot] = False
        if self.runner.paged:
            self.runner.kv.free_slot(slot)
        self._slot_gen[slot] += 1      # in-flight results: discard
        self.scheduler.release(slot)
        self.metrics.observe(req)

    def _make_can_fit(self) -> Optional[Callable[[Request], bool]]:
        """Block-availability gate for one admission round; accumulates
        the blocks already promised this round.  None (no gate) on the
        contiguous cache, whose every slot holds ``max_seq_len``."""
        kv = self.runner.kv
        if kv is None:
            return None
        planned = 0

        def can_fit(req: Request) -> bool:
            nonlocal planned
            need = kv.blocks_for(self._reserve_tokens(req))
            if planned + need > kv.free_blocks:
                return False
            planned += need
            return True

        return can_fit

    def _start_decode(self, slot: int, req: Request, tok: int) -> None:
        """The prefill sampled the request's first token: move it into
        the decode batch (or finish it when that was its last).  When
        speculating, the caller fills the drafter's cache: batched at
        admission (``_fill_drafter``) or chunk by chunk."""
        req.t_first = time.perf_counter()
        req.state = RequestState.DECODE
        L = len(req.prompt)
        cap = self.max_seq_len - L + 1
        req.truncated = req.max_new_tokens > cap
        self._tok[slot] = tok
        self._pos[slot] = L
        self._active[slot] = True
        self._remaining[slot] = min(req.max_new_tokens, cap) - 1
        self._counts[slot] = 1
        self._host_fresh[slot] = True  # host lanes authoritative again
        self._ahead[slot] = 0
        self._emit(req, int(tok))
        if (self._remaining[slot] <= 0
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(slot, req)

    def _fill_drafter(self, rows: Sequence[Tuple[int, Request]],
                      bucket: int) -> None:
        """When speculating, one batched narrow forward fills the
        drafter's cache for every admitted row still decoding."""
        started = [(s, r) for s, r in rows if r.state is RequestState.DECODE]
        if self.runner.speculate_k and started:
            self.runner.draft_prefill([r.prompt for _, r in started], bucket,
                                      [s for s, _ in started])

    def _admit(self) -> int:
        """Admit queued requests into free slots and prefill them: one
        batched call per bucket, or (int8 KV) one chunk-program call for
        the whole round; with chunked prefill the chunks run in
        ``_prefill_chunks``.  Returns the number admitted."""
        chunked = self.runner.prefill_chunk > 0
        warm_rows: List[Tuple[int, Request]] = []
        admitted = 0
        for bucket, group in self.scheduler.plan_admission(
                self._make_can_fit()):
            for slot, req in group:
                if self.runner.paged:
                    self.runner.kv.allocate(slot, self._reserve_tokens(req))
                self._temps[slot] = req.params.temperature
                self._topks[slot] = req.params.top_k
                self._topps[slot] = req.params.top_p
                self._seeds[slot] = req.seed & 0xFFFFFFFF
                self._eos[slot] = -1 if req.eos_id is None else req.eos_id
                req.prefilled = 0
            admitted += len(group)
            if chunked:
                # chunks run in _prefill_chunks (the drafter's too, from
                # position 0); the slots' state rows belonged to their
                # previous tenants: zero them first
                self.runner.kv.reset_slots([s for s, _ in group])
                continue
            if self.runner.kv_dtype == "int8":
                # int8 KV: cold prompts run through the chunk program, as
                # in the reference, so the first token comes from
                # attention over the quantized pool bytes
                warm_rows += group
                continue
            slots = [s for s, _ in group]
            reqs = [r for _, r in group]
            toks = self.runner.prefill([r.seq_tokens for r in reqs], bucket,
                                       slots, [r.seed for r in reqs],
                                       [len(r.output) for r in reqs],
                                       [r.params for r in reqs])
            for slot, req, tok in zip(slots, reqs, toks):
                req.prefilled = len(req.seq_tokens)
                self._start_decode(slot, req, int(tok))
            self._fill_drafter(group, bucket)
        if warm_rows:
            toks = self.runner.warm_prefill(
                [r.seq_tokens for _, r in warm_rows],
                [s for s, _ in warm_rows], [r.seed for _, r in warm_rows],
                [len(r.output) for _, r in warm_rows],
                [r.params for _, r in warm_rows])
            for (slot, req), tok in zip(warm_rows, toks):
                req.prefilled = len(req.seq_tokens)
                self._start_decode(slot, req, int(tok))
            self._fill_drafter(warm_rows, self.runner.bucket_for(
                max(len(r.prompt) for _, r in warm_rows)))
        return admitted

    def _prefill_chunks(self) -> int:
        """Advance every prefilling request by one chunk (one batched
        call), starting the decode of rows whose prompt is now fully in
        the cache.  When speculating, the drafter's cache fills chunk by
        chunk in step (its own batched call): a row whose target prompt
        is in first parks its token in ``pending_first``, and joins the
        decode batch only when both cursors have caught up.  Returns rows
        advanced."""
        C = self.runner.prefill_chunk
        spec = self.runner.speculate_k > 0
        rows = [(s, r) for s, r in self.scheduler.active_slots()
                if r.state is RequestState.PREFILL]
        tgt = [(s, r) for s, r in rows if r.prefilled < len(r.seq_tokens)]
        if tgt:
            n = len(tgt)
            toks = np.zeros((n, C), np.int64)
            pos = np.empty((n,), np.int32)
            last_idx = np.zeros((n,), np.int64)
            for i, (_, req) in enumerate(tgt):
                seq = req.seq_tokens
                chunk = seq[req.prefilled:req.prefilled + C]
                toks[i, :len(chunk)] = chunk
                pos[i] = req.prefilled
                last_idx[i] = min(C - 1, len(seq) - 1 - req.prefilled)
            cand = self.runner.chunk(toks, pos, [s for s, _ in tgt],
                                     last_idx, [r.seed for _, r in tgt],
                                     [len(r.output) for _, r in tgt],
                                     [r.params for _, r in tgt])
            for i, (slot, req) in enumerate(tgt):
                req.prefilled = min(req.prefilled + C, len(req.seq_tokens))
                if req.prefilled == len(req.seq_tokens):
                    if spec:
                        req.pending_first = int(cand[i])
                    else:
                        self._start_decode(slot, req, int(cand[i]))
        if not spec:
            return len(tgt)
        drows = [(s, r) for s, r in rows
                 if r.draft_filled < len(r.seq_tokens)]
        if drows:
            dtoks = np.zeros((len(drows), C), np.int64)
            dpos = np.empty((len(drows),), np.int32)
            for i, (_, req) in enumerate(drows):
                chunk = req.seq_tokens[req.draft_filled:req.draft_filled + C]
                dtoks[i, :len(chunk)] = chunk
                dpos[i] = req.draft_filled
            self.runner.draft_chunk(dtoks, dpos, [s for s, _ in drows])
            for _, req in drows:
                req.draft_filled = min(req.draft_filled + C,
                                       len(req.seq_tokens))
        for slot, req in rows:
            if (req.pending_first is not None
                    and req.draft_filled >= len(req.seq_tokens)):
                tok, req.pending_first = req.pending_first, None
                self._start_decode(slot, req, tok)
        return len({s for s, _ in tgt} | {s for s, _ in drows})

    # -- applying step results -----------------------------------------
    #
    # One routine per kind applies a decode / speculative step's result
    # to host state, shared by the synchronous and the pipelined loop.
    # ``rows`` is the (slot, request, slot generation) snapshot taken at
    # dispatch: a row whose slot was released since (its request
    # finished, in an earlier step's result) is discarded.

    def _snap_rows(self, active: List[Tuple[int, Request]]
                   ) -> List[Tuple[int, Request, int]]:
        return [(s, r, int(self._slot_gen[s])) for s, r in active]

    def _landed(self, slot: int, req: Request, gen: int) -> bool:
        """Whether a step's row for (slot, req, gen) still applies; the
        tenant's count of steps in flight drops either way."""
        if gen != self._slot_gen[slot]:
            return False
        self._ahead[slot] -= 1
        return (self.scheduler.slots[slot] is req
                and req.state is RequestState.DECODE)

    def _apply_decode(self, rows: List[Tuple[int, Request, int]], toks,
                      done) -> int:
        n = 0
        for slot, req, gen in rows:
            if not self._landed(slot, req, gen):
                continue
            tok = int(toks[slot])
            self._emit(req, tok)
            self._tok[slot] = tok
            self._pos[slot] += 1
            self._counts[slot] += 1
            self._remaining[slot] -= 1
            if done[slot]:
                self._finish(slot, req)
            n += 1
        return n

    def _apply_spec(self, rows: List[Tuple[int, Request, int]], toks_mat,
                    counts) -> int:
        """Emit each slot's 1..K+1 tokens of a speculative step, stopping
        at EOS or at the slot's remaining budget, as plain decode would.
        Acceptance charges only the proposals a slot could use: the
        budget caps the window up front, and an EOS stop drops the
        proposals after it, so an early finish does not drag the rate
        below its true value."""
        acc = prop = out = n = 0
        K = self.runner.speculate_k
        for slot, req, gen in rows:
            if not self._landed(slot, req, gen):
                continue
            m = int(counts[slot])
            usable = min(K, int(self._remaining[slot]))
            emitted = 0
            eos_stop = False
            for j in range(m):
                tok = int(toks_mat[slot, j])
                self._emit(req, tok)
                self._tok[slot] = tok
                self._pos[slot] += 1
                self._counts[slot] += 1
                self._remaining[slot] -= 1
                emitted += 1
                eos_stop = req.eos_id is not None and tok == req.eos_id
                if self._remaining[slot] <= 0 or eos_stop:
                    self._finish(slot, req)
                    break
            prop_eff = min(usable, emitted) if eos_stop else usable
            acc += min(emitted, m - 1, prop_eff)
            prop += prop_eff
            out += emitted
            n += 1
        self.metrics.observe_spec(acc, prop, emitted=out, slots=n)
        return n

    # -- stepping: dispatch, then wait ----------------------------------

    def _dispatch(self, active: List[Tuple[int, Request]]) -> bool:
        """Dispatch the next decode / speculative step, no host transfer.
        With a step in flight, this one's inputs are composed on the
        device from that step's still-unfetched result (``carry``); lanes
        the host rewrote since (fresh admissions) or that were idle in
        the carried step take the host values (``override``).  A lane
        whose budget runs out in a step in flight has finished there: it
        runs idle, as the sync engine would run it, so that the sweep
        bound is the sync engine's (a plain step advances each lane by
        exactly one).  Returns False when no lane is left to run."""
        r = self.runner
        K = r.speculate_k
        lanes = self._active & (self._remaining > self._ahead)
        if not lanes.any():
            return False
        carry = self._inflight[-1]["handle"] if self._inflight else None
        override = (None if carry is None
                    else self._host_fresh | ~carry["active"])
        rows = self._snap_rows([(s, q) for s, q in active if lanes[s]])
        kw = dict(seeds=self._seeds, top_k=self._topks, top_p=self._topps,
                  carry=carry, override=override)
        if K:
            handle = r.dispatch_spec(self._tok, self._pos, lanes,
                                     self._temps, self._counts,
                                     extra_len=(K + 1) * self._ahead, **kw)
        else:
            handle = r.dispatch_decode(self._tok, self._pos, lanes,
                                       self._temps, self._eos,
                                       self._remaining, self._counts,
                                       extra_len=self._ahead, **kw)
        self._inflight.append({"handle": handle, "rows": rows,
                               "spec": bool(K)})
        if self.pipeline_depth:
            now = time.perf_counter()
            if self._last_dispatch_t is not None:
                self.metrics.dispatch_gaps.append(now - self._last_dispatch_t)
            self._last_dispatch_t = now
            self.metrics.steps_in_flight = max(self.metrics.steps_in_flight,
                                               len(self._inflight))
        for s, _, _ in rows:
            # from here the device carry is the truth for these lanes;
            # the host mirror catches up when the result is applied
            self._host_fresh[s] = False
            self._ahead[s] += 1
        return True

    def _process_oldest(self) -> int:
        """Wait on the oldest step in flight and apply it.  Returns the
        number of rows applied.  TTFT and TPOT marks are taken here, when
        the transfer has landed, never at dispatch."""
        entry = self._inflight.popleft()
        if entry["spec"]:
            toks_mat, counts = self.runner.wait_spec(entry["handle"])
            return self._apply_spec(entry["rows"], toks_mat, counts)
        toks, done = self.runner.wait_decode(entry["handle"])
        return self._apply_decode(entry["rows"], toks, done)

    def _drain_inflight(self) -> None:
        """Apply every step in flight."""
        while self._inflight:
            self._process_oldest()

    def step(self) -> int:
        """Admit, advance chunked prefills by one chunk, then dispatch one
        decode step (or one speculative draft + verify step) for every
        decoding slot, and wait on the oldest step in flight once more
        than ``pipeline_depth`` are queued: at once in the synchronous
        engine (depth 0); with depth > 0 admission, chunked prefill and
        the next dispatch overlap the steps still on the device.
        Returns the number of requests that made progress."""
        progress = self._admit()
        if self.runner.prefill_chunk:
            progress += self._prefill_chunks()
        self.metrics.max_active = max(self.metrics.max_active,
                                      len(self.scheduler.active_slots()))
        active = [(s, r) for s, r in self.scheduler.active_slots()
                  if r.state is RequestState.DECODE]
        dispatched = False
        if active and len(self._inflight) <= self.pipeline_depth:
            dispatched = self._dispatch(active)
            if dispatched:
                progress += len(active)
        processed_any = False
        while len(self._inflight) > self.pipeline_depth:
            n = self._process_oldest()
            processed_any = True
            if not dispatched:
                progress += n
        if not dispatched and not processed_any and self._inflight:
            progress += self._process_oldest()   # the tail: drain
        self.steps_run += 1
        return progress

    def run(self, max_steps: int = 10000) -> None:
        """Drain queue, slots and steps in flight; raise EngineStallError
        when the step budget runs out with work pending."""
        for _ in range(max_steps):
            if not self.scheduler.has_work() and not self._inflight:
                return
            self.step()
        if self.scheduler.has_work() or self._inflight:
            raise EngineStallError(
                f"engine stalled: {max_steps} steps exhausted with "
                f"{len(self.scheduler.queue)} queued, "
                f"{len(self.scheduler.active_slots())} active requests "
                f"and {len(self._inflight)} steps in flight")

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 params: SampleParams = SampleParams()) -> List[List[int]]:
        """Submit every prompt (default seeds), run to the end, return
        the streams."""
        reqs = [self.submit(p, max_new_tokens, params=params)
                for p in prompts]
        self.run()
        return [r.output for r in reqs]
