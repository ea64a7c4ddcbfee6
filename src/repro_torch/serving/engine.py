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

The prefix cache is on by default, as in the reference (a PT or dense
model on the paged cache; off by capability for falcon-mamba and on the
contiguous cache): an admission shares the longest cached block-aligned
prefix of its prompt (``cache.PagedKVCache.allocate(..., tokens=)``)
and runs only the tail, at its true positions, through the chunk
program (``ModelRunner.warm_prefill``), after every cold prefill of the
round; finished chunks, prompts and streams are committed as they are
written.  ``Engine.fork`` clones a decoding request n ways over the
same blocks, and before every decode or speculative dispatch a slot's
shared blocks in its write span are copied (``_cow``).

The robustness layer is the reference's, decision for decision: under
block exhaustion (a starved higher-priority admission, a fork or a
copy-on-write short of blocks) the engine preempts the lowest-priority,
newest decoding request: it commits the positions written, so that its
blocks park in the prefix cache's LRU, and requeues it with prompt +
output as its effective prompt; the resume prefills that sequence
(mostly a prefix hit) at the request's own key counters and decodes on
from position L + m.  Requests carry ``priority``, ``deadline_s`` and
``on_event``, can be cancelled anywhere (``cancel``), and end in exactly
one of DONE / REJECTED / CANCELLED / TIMED_OUT; invalid requests,
unmeetable deadlines and overload past ``max_queue`` come back REJECTED
through ``on_event``, never as an exception.  A stall watchdog breaks a
run of ``watchdog_patience`` steps without progress (preempt, or shed
the head with a diagnostic), and ``faults.FaultPlan`` injects
allocation failures, transfer faults and slow steps at the reference's
sites, in the reference's order, so that one seed gives the same
schedule in both engines.  A transfer fault at a synchronous step drops
the step (its stage freed, the lanes' host values authoritative again)
and the next tick recomputes it from the same inputs, writing the same
K/V bytes; in the pipelined engine the faulted step stays at the head
of the queue and the retry re-reads its result, while back-pressure
keeps any dispatch from reusing its staging slot.  Deadlines are
refused on track ranks (a wall clock read on each rank could differ;
ROADMAP item 7f).  Every feature of the reference engine this slice
leaves out raises ``NotImplementedError`` naming its ROADMAP item when
asked for, never silently ignored.
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
from repro_torch.serving.faults import FaultPlan, TransferFault
from repro_torch.serving.sampler import (SALT_DRAFT, SALT_SAMPLE,
                                         SampleParams, accept_step,
                                         advance_decode, advance_spec,
                                         fork_seeds, prefill_keys, row_keys,
                                         sample_rows, sample_step,
                                         stack_params)


RECURRENT_MIXERS = ("mamba", "rglru")


def _unported(what: str, item: Any) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP queue 1, item {item})")


def _ranks_unpipelined(what: str) -> NotImplementedError:
    return _unported(f"{what} on track ranks (a gloo collective cannot be "
                     "captured in a CUDA graph)", "7b")


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    REJECTED = "rejected"      # validation, overload shed, watchdog, or
                               # preempted more than max_preemptions
    CANCELLED = "cancelled"    # Engine.cancel
    TIMED_OUT = "timed_out"    # deadline_s exceeded


TERMINAL_STATES = (RequestState.DONE, RequestState.REJECTED,
                   RequestState.CANCELLED, RequestState.TIMED_OUT)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    params: SampleParams = dataclasses.field(default_factory=SampleParams)
    on_token: Optional[Callable[["Request", int], None]] = None
    seed: int = 0                      # per-request PRNG seed (sampling)
    priority: int = 0                  # higher evicts lower under pressure
    deadline_s: Optional[float] = None  # submit-to-done budget (monotonic)
    on_event: Optional[Callable[["Request", str], None]] = None
    # filled by the engine
    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    truncated: bool = False            # max_new_tokens clamped to capacity
    finish_reason: Optional[str] = None
    prefilled: int = 0                 # prompt tokens already in the cache
    cached_prefix: int = 0             # prompt tokens served from the
                                       # prefix cache (or shared by fork)
    draft_filled: int = 0              # drafter cache tokens (chunked+spec)
    pending_first: Optional[int] = None  # first token parked until the
                                       # drafter catches up (chunked+spec)
    preemptions: int = 0               # times evicted and requeued
    # monotonic (perf_counter) latency marks
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    t_submit_wall: float = 0.0         # wall clock, for logs only

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> float:
        n = max(1, len(self.output) - 1)
        return (self.t_done - self.t_first) / n

    @property
    def seq_tokens(self) -> List[int]:
        """The prompt and every token emitted so far: the effective prompt
        a preempted request re-enters the queue with."""
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
        self.t_start: Optional[float] = None
        self.t_last: Optional[float] = None
        # speculative decoding
        self.spec_steps = 0
        self.draft_proposed = 0        # usable drafts per slot per step
        self.draft_accepted = 0        # drafts the verify forward kept
        self.acceptance_ema: Optional[float] = None
        self.spec_tokens = 0           # tokens the spec steps emitted
        self.spec_slot_steps = 0       # decoding slots summed over them
        # robustness counters
        self.preemptions = 0           # evict-and-requeue events
        self.resumes = 0               # preempted requests re-admitted
        self.rejected = 0              # REJECTED: validation, watchdog,
                                       # preemption give-up
        self.shed = 0                  # bounded-queue overload rejects
        self.cancelled = 0
        self.timed_out = 0
        self.watchdog_fires = 0
        self.transfer_faults = 0       # TransferFault steps retried
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
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "rejected": self.rejected,
                "shed": self.shed,
                "cancelled": self.cancelled,
                "timed_out": self.timed_out,
                "watchdog_fires": self.watchdog_fires,
                "transfer_faults": self.transfer_faults,
                "dispatch_gap_ms": pct(self.dispatch_gaps),
                "steps_in_flight": self.steps_in_flight}


class EngineStallError(RuntimeError):
    """``Engine.run`` exhausted its step budget with work still pending
    (or a pipeline drain its retries).  ``diagnostic`` is the queued /
    active / pool snapshot at the stall (``Engine.stall_diagnostic``)."""

    def __init__(self, message: str, diagnostic: Dict[str, Any]):
        super().__init__(message)
        self.diagnostic = diagnostic


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

    def remove(self, req: Request) -> bool:
        """Drop a queued request (cancel, deadline, watchdog shed)."""
        try:
            self.queue.remove(req)
            return True
        except ValueError:
            return False

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
    full logits.

    An encoder-decoder config (whisper-medium) is refused before any
    other check, with the reference's ValueError ("engine serves
    decoder-only models"); it runs through the ``lm_*`` entry points on
    the contiguous cache (``serving/cache.py::pad_cache``)."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_seq_len: int, min_bucket: int = 16,
                 paged: bool = True,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 0, kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 speculate_k: int = 0, draft_tracks: int = 0,
                 prefix_cache: bool = True,
                 pipeline_depth: int = 0, device: DeviceLike = None,
                 par: Parallelism = NO_PARALLEL,
                 fault_plan: Optional[FaultPlan] = None):
        if cfg.encdec is not None:
            raise ValueError("engine serves decoder-only models")
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
        self.faults = fault_plan       # deterministic fault injection
        self.params = shard_tracks(params, cfg, par)
        self.fns = model_fns(cfg, par)
        self.capabilities = arch_capabilities(cfg)
        caps = self.capabilities
        # padded tokens would run through a recurrent layer's conv window
        # and state, or take expert-capacity slots that belong to real
        # tokens in a capacity-routed MoE: those architectures prefill at
        # exact prompt length
        self.exact_prefill = any(cfg.spec(nm).mixer in RECURRENT_MIXERS
                                 or cfg.spec(nm).mlp == "moe"
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
        # the warm tail behind a prefix-cache hit runs through the chunk
        # program, as a chunked prefill does
        self.prefix_cache = (prefix_cache and self.paged
                             and caps["prefix_cache"].supported)
        self.kv: Optional[PagedKVCache] = None
        if self.paged:
            self.kv = PagedKVCache(cfg, max_slots=max_slots,
                                   max_seq_len=max_seq_len,
                                   block_size=block_size,
                                   num_blocks=num_blocks,
                                   prefix_cache=self.prefix_cache,
                                   kv_dtype=self.kv_dtype,
                                   device=self.device, par=par,
                                   fault_plan=fault_plan)
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
        """Prefill tokens a request costs per admission round: the padded
        bucket of its uncached tail (a prefix-cache hit costs no
        compute), or one chunk when chunked prefill spreads the rest
        over later steps."""
        length = len(req.seq_tokens)
        if self.prefix_cache:
            length -= self.kv.match_prefix(req.seq_tokens)[0]
        bucket = self.bucket_for(length)
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
                     prefix_cache=self.prefix_cache,
                     state_bytes=self.kv.state_bytes(), **quant)
        return stats

    # -- device steps ---------------------------------------------------
    def _maybe_inject_transfer(self, site: str) -> None:
        """The fault hook at each device-to-host transfer, fired after the
        step's device work was issued and before its result is read, at
        the reference's five sites with its labels: ``prefill``,
        ``chunk``, ``warm_prefill``, ``decode`` and ``draft_verify``.
        The engine undoes no device work: the retry writes the same bytes
        at the same positions."""
        if self.faults is not None and self.faults.take_transfer(site):
            raise TransferFault(
                f"injected device-to-host transfer failure at {site} "
                f"(op {self.faults.transfer_calls - 1})")

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
            self.params, {"inputs": self._to_dev(tokens, torch.long),
                          "lengths": len_d}, self.cfg, mode="prefill")
        last = logits[torch.arange(n, device=self.device), len_d - 1]
        toks = self._sample_first(last, seeds, counters, params_list)
        if self.paged:
            self.kv.insert_prefill(cache, slots, self.kv.table_rows(slots))
        else:
            insert_rows(self.cache, cache, slots)
        self.prefill_shapes.add((n, bucket))
        self.prefill_calls += 1
        self._maybe_inject_transfer("prefill")
        return toks.cpu().numpy()

    def _chunk(self, toks: np.ndarray, pos: np.ndarray,
               slots: Sequence[int], last_idx: np.ndarray,
               seeds: Sequence[int], counters: Sequence[int],
               params_list: Sequence[SampleParams]) -> torch.Tensor:
        """The chunk program for n rows: toks [n, C] appended at
        pos[:, None] + arange(C) through the block-table rows of
        ``slots`` (the whole table row is gathered, as the reference's
        chunk call passes no ``kv_max_len``); state rows advance at
        ``slots`` by ``last_idx + 1`` valid tokens.  Returns the token
        sampled at each row's ``last_idx`` [n] (draw ``counters[i]`` of
        the stream of ``seeds[i]``), on the device -- meaningful only for a
        row's final chunk.  The LM head runs on those n rows only (the
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
        return cand

    @torch.no_grad()
    def chunk(self, toks: np.ndarray, pos: np.ndarray, slots: Sequence[int],
              last_idx: np.ndarray, seeds: Sequence[int],
              counters: Sequence[int],
              params_list: Sequence[SampleParams]) -> np.ndarray:
        """One chunk step for the requests prefilling in ``slots``."""
        cand = self._chunk(toks, pos, slots, last_idx, seeds, counters,
                           params_list)
        self._maybe_inject_transfer("chunk")
        return cand.cpu().numpy()

    @torch.no_grad()
    def warm_prefill(self, prompts: Sequence[Sequence[int]],
                     matched: Sequence[int], slots: Sequence[int],
                     seeds: Sequence[int], counters: Sequence[int],
                     params_list: Sequence[SampleParams]) -> np.ndarray:
        """The uncached tails of prompts, tokens [matched_i, len_i), at
        their true positions through the chunk program, one call
        right-padded to the bucket of the longest tail: each tail attends
        to the shared blocks of its prefix.  With ``matched`` 0 this is
        the int8-KV route of cold prompts.  Returns first tokens [n]
        (each row's draw ``counters[i]``)."""
        n = len(prompts)
        bucket = self.bucket_for(max(len(p) - m
                                     for p, m in zip(prompts, matched)))
        toks = np.zeros((n, bucket), np.int64)
        pos = np.empty((n,), np.int32)
        last_idx = np.empty((n,), np.int64)
        for i, (p, m) in enumerate(zip(prompts, matched)):
            toks[i, :len(p) - m] = p[m:]
            pos[i] = m
            last_idx[i] = len(p) - m - 1
        cand = self._chunk(toks, pos, slots, last_idx, seeds, counters,
                           params_list)
        self._maybe_inject_transfer("warm_prefill")
        return cand.cpu().numpy()

    @torch.no_grad()
    def copy_blocks(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Apply the copy-on-write pairs of ``kv.ensure_writable`` to the
        pools (and int8 scale pools), eagerly between steps: a step
        program then reads the new blocks through ``step_table``, which
        the next dispatch copies in (the table's version changed)."""
        self.kv.copy_blocks(pairs)

    @torch.no_grad()
    def dense_fork(self, src: int, dsts: Sequence[int]) -> None:
        """Copy the state rows of slot ``src`` into ``dsts`` on a fork (a
        Mamba model; nothing for an all-pool cache)."""
        self.kv.copy_rows(src, dsts)

    @torch.no_grad()
    def draft_fork(self, src: int, dsts: Sequence[int]) -> None:
        """Copy the drafter's contiguous rows of slot ``src`` into
        ``dsts`` on a fork (the target's pools are shared through the
        block table instead)."""
        idx = self._to_dev(list(dsts), torch.long)
        at = self._to_dev([src] * len(dsts), torch.long)
        for leaf in self.draft_cache["blocks"]:
            leaf.index_copy_(3, idx, leaf.index_select(3, at))

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

    def drop(self, handle: Dict[str, Any]) -> None:
        """Give up a dispatched step's result (a synchronous step whose
        transfer faulted: the engine recomputes it): once its copies have
        run, its staging slot is free again."""
        st = handle["stage"]
        if st.event is not None:
            st.event.synchronize()
        st.busy = False

    def wait_decode(self, handle: Dict[str, Any]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The one host transfer of a dispatched decode step: the packed
        (token, done) array.  An injected TransferFault leaves the step's
        stage busy with its result, for the engine to retry or drop."""
        self._maybe_inject_transfer("decode")
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
        self._maybe_inject_transfer("draft_verify")
        host = self._wait(handle)
        K = self.speculate_k
        return host[:K + 1].T, host[K + 1]

    def _program_keys(self, lengths: Optional[Sequence[int]] = None
                      ) -> List[tuple]:
        """The (kind, bounds, sampled) of every step program a run may
        dispatch: decode, one per power-of-two bound of the engine's
        cache (blocks up to ``blocks_per_seq`` paged, positions up to
        ``max_seq_len`` contiguous); speculative, one per pair (drafter's
        contiguous bound, verify's paged bound) that one live length
        gives; each greedy and sampled.  ``lengths``: only the bounds of
        these live lengths (default every length up to the capacity)."""
        if lengths is None:
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
    def plan_programs(self, sampled: Sequence[bool] = (False, True),
                      lengths: Optional[Sequence[int]] = None) -> int:
        """Capture one CUDA graph per step program (``_program_keys``;
        of the variants in ``sampled``: the greedy ones, the sampled
        ones, or both; with ``lengths`` only those whose bounds these
        live lengths take), all in one memory pool, so that a dispatch
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
        todo = {k: self._body(k) for k in self._program_keys(lengths)
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

    Runs on CUDA unless ``device='cpu'`` is given.  ``paged`` picks the
    paged cache (the default) or the contiguous one.  ``par`` serves a
    PT model on one track rank of a ``torch.distributed`` group
    (``runtime.parallel``): every rank runs this loop on the same
    requests, in the same order, and emits the same tokens; the
    pipelined engine, planned programs and deadlines are refused there.

    The robustness knobs are the reference's: ``max_queue`` bounds the
    queue (a submission past it is shed, REJECTED), ``watchdog_patience``
    is the number of steps in a row without progress after which the
    stall watchdog fires, ``max_preemptions`` the evictions a request
    survives before it is REJECTED, and ``fault_plan`` a
    ``faults.FaultPlan`` of injected faults.  Encoder-decoder configs are
    refused first, as ``ModelRunner`` refuses them."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq_len: int = 256,
                 max_waiting_prefill_tokens: int = 4096,
                 min_bucket: int = 16, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, device: DeviceLike = None,
                 paged: bool = True, prefill_chunk: int = 0,
                 speculate_k: int = 0, draft_tracks: int = 0,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 pipeline_depth: int = 0, preplan: bool = False,
                 seed: int = 0, max_queue: Optional[int] = None,
                 watchdog_patience: int = 25, max_preemptions: int = 8,
                 fault_plan: Optional[FaultPlan] = None,
                 par: Parallelism = NO_PARALLEL):
        if cfg.encdec is not None:
            raise ValueError("engine serves decoder-only models")
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
                                  prefix_cache=prefix_cache,
                                  pipeline_depth=pipeline_depth,
                                  device=device, par=par,
                                  fault_plan=fault_plan)
        if preplan:
            self.runner.plan_programs()
        self.scheduler = Scheduler(max_slots, self.runner.bucket_for,
                                   max_waiting_prefill_tokens,
                                   charge_fn=self.runner.admission_charge)
        self.metrics = EngineMetrics()
        self.seed = seed               # base for derived per-request seeds
        self.max_queue = max_queue
        self.watchdog_patience = watchdog_patience
        self.max_preemptions = max_preemptions
        self.faults = fault_plan
        self._stalled_steps = 0        # consecutive steps without progress
        self._step_ema: Optional[float] = None   # step time (s), for the
                                                 # deadline estimate
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
        # authoritative for the next dispatch (newly admitted, resumed,
        # forked); carried lanes advance on the device from the previous
        # step's result.  ``_slot_gen`` counts slot reassignments, so that
        # an in-flight result for a previous tenant of the slot (or for a
        # tenant that was preempted, cancelled or timed out) is discarded.
        # ``_ahead[slot]`` counts the tenant's steps in flight: the
        # positions (a plain step's exactly, a speculative step's at
        # least) that the device is ahead of the host mirror.
        self.pipeline_depth = pipeline_depth
        self._inflight: deque = deque()
        self._host_fresh = np.ones((B,), bool)
        self._slot_gen = np.zeros((B,), np.int64)
        self._ahead = np.zeros((B,), np.int32)
        self._last_dispatch_t: Optional[float] = None

    def capabilities(self) -> Dict[str, Dict[str, Any]]:
        """Per feature, whether the architecture supports it (with the
        reason when not) and whether this engine has it on; the int8
        fallbacks fold in, as in the reference."""
        r = self.runner
        live = {"paged": r.paged,
                "chunked_prefill": r.prefill_chunk > 0,
                "speculative": r.speculate_k > 0,
                "prefix_cache": r.prefix_cache,
                "int8_kv": r.kv_dtype == "int8",
                "fork": r.paged}
        out = {name: {"supported": cap.supported, "reason": cap.reason,
                      "active": live[name]}
               for name, cap in r.capabilities.items()}
        wfall = next((f for f in r.quant_fallbacks
                      if f.startswith("weight_dtype")), None)
        kfall = next((f for f in r.quant_fallbacks
                      if f.startswith("kv_dtype")), None)
        out["int8_weights"] = {"supported": wfall is None, "reason": wfall,
                               "active": r.weight_dtype == "int8"}
        if kfall is not None and out["int8_kv"]["reason"] is None:
            # requested but gated off (the engine is not paged)
            out["int8_kv"]["reason"] = kfall
        return out

    # ------------------------------------------------------------------
    def _reserve_tokens(self, req: Request) -> int:
        """Cache positions a request occupies over its lifetime: prompt
        plus decode writes (the last sampled token is never written)."""
        L = len(req.prompt)
        cap = self.max_seq_len - L + 1
        return L + min(req.max_new_tokens, cap) - 1

    def _estimate_completion_s(self, req: Request) -> float:
        """An optimistic submit-to-done estimate at the current load, from
        the step-time EMA (``_finish_step``): the request's own prefill
        and decode steps, times the full queue waves ahead of it.  A lower
        bound on purpose: only a deadline unmeetable even under ideal
        scheduling is rejected.  0.0 before any step has run."""
        if self._step_ema is None:
            return 0.0
        L = len(req.prompt)
        C = self.runner.prefill_chunk
        prefill_steps = -(-L // C) if C else 1
        cap = self.max_seq_len - L + 1
        decode_steps = min(req.max_new_tokens, cap)
        if self.runner.speculate_k:
            decode_steps = -(-decode_steps // (self.runner.speculate_k + 1))
        own = (prefill_steps + decode_steps) * self._step_ema
        waves = len(self.scheduler.queue) // self.max_slots
        return own * (1 + waves)

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
        reference).  ``priority`` orders eviction under memory pressure
        (a higher-priority admission may preempt strictly lower-priority
        decoders); ``deadline_s`` bounds submit-to-done time (past it the
        request is TIMED_OUT); ``on_event`` hears every terminal
        transition and every preemption.

        Invalid requests (empty or overlong prompt, non-positive token
        budget, on the paged cache a reservation larger than the whole
        block pool), a deadline the step-time EMA says cannot be met
        (``finish_reason`` starting ``unmeetable_deadline``) and overload
        (``max_queue`` requests waiting) come back REJECTED with
        ``finish_reason`` set, through ``on_event``, never as an
        exception.  On track ranks ``deadline_s`` raises (item 7f)."""
        if deadline_s is not None and self.runner.par.sharded:
            raise _unported("deadline_s on track ranks (each rank would "
                            "read its own clock: one expiry decided on one "
                            "rank alone would stall the others' "
                            "collectives)", "7f")
        if seed is None:
            seed = (self.seed * 1_000_003 + self._next_rid) & 0x7FFFFFFF
        req = Request(self._next_rid, list(prompt), max_new_tokens, eos_id,
                      params, on_token, seed=seed, priority=priority,
                      deadline_s=deadline_s, on_event=on_event)
        req.t_submit = time.perf_counter()     # monotonic: latency math
        req.t_submit_wall = time.time()        # wall clock: logs only
        self._next_rid += 1
        if not req.prompt:
            return self._reject(req, "empty prompt")
        if max_new_tokens <= 0:
            return self._reject(req, "max_new_tokens must be positive, "
                                     f"got {max_new_tokens}")
        if len(req.prompt) > self.max_seq_len:
            return self._reject(req, f"prompt length {len(req.prompt)} "
                                     "exceeds engine capacity "
                                     f"{self.max_seq_len}")
        kv = self.runner.kv
        if kv is not None and \
                kv.blocks_for(self._reserve_tokens(req)) > kv.num_blocks - 1:
            return self._reject(
                req,
                f"request needs {kv.blocks_for(self._reserve_tokens(req))} "
                f"KV blocks but the pool holds {kv.num_blocks - 1}")
        if deadline_s is not None:
            est = self._estimate_completion_s(req)
            if est > deadline_s:
                return self._reject(
                    req, "unmeetable_deadline: needs "
                         f"~{est:.3f}s at current load, "
                         f"budget {deadline_s:.3f}s")
        if self.max_queue is not None \
                and len(self.scheduler.queue) >= self.max_queue:
            self.metrics.shed += 1
            return self._reject(req, f"queue full ({self.max_queue} "
                                     "waiting): overload shed",
                                count=False)
        self.metrics.start()
        self.scheduler.submit(req)
        return req

    # -- terminal transitions ------------------------------------------
    def _event(self, req: Request) -> None:
        if req.on_event is not None:
            req.on_event(req, req.finish_reason or req.state.value)

    def _reject(self, req: Request, reason: str, *,
                count: bool = True) -> Request:
        req.state = RequestState.REJECTED
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        if count:
            self.metrics.rejected += 1
        self._event(req)
        return req

    def _slot_of(self, req: Request) -> Optional[int]:
        for s, r in self.scheduler.active_slots():
            if r is req:
                return s
        return None

    def _evict_slot(self, slot: int, req: Request) -> None:
        """Reclaim the slot of a request that leaves mid-flight (preempted,
        cancelled, timed out): every position written is committed, so
        that its blocks park in the LRU for its own resume (or an equal
        prompt) to match, then its references drop.  Steps still in
        flight for it are discarded when they land (``_slot_gen``); their
        K/V writes land at or past the host position, never in a block
        the commit registered, and before any later tenant's writes on
        the same stream."""
        self._active[slot] = False
        if self.runner.paged:
            kv = self.runner.kv
            if req.state is RequestState.DECODE:
                # [0, pos) is written: the prompt and every emitted token
                # but the last (a chunked prefill committed its chunks)
                kv.commit_tokens(slot, req.seq_tokens[:-1])
            kv.free_slot(slot)
        self._slot_gen[slot] += 1
        self._ahead[slot] = 0
        self.scheduler.release(slot)

    def cancel(self, req: Request,
               reason: str = "cancelled by caller") -> bool:
        """End a request wherever it is: drop it from the queue, or free
        its slot and blocks mid-prefill or mid-decode.  Safe from a
        streaming callback: the step skips slots whose request is gone,
        and a result in flight for it is discarded.  False when the
        request had already ended."""
        if req.finished:
            return False
        if req.state is RequestState.QUEUED:
            self.scheduler.remove(req)
        else:
            slot = self._slot_of(req)
            if slot is not None:
                self._evict_slot(slot, req)
        req.state = RequestState.CANCELLED
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        self.metrics.cancelled += 1
        self._event(req)
        return True

    def _time_out(self, req: Request) -> None:
        if req.state is RequestState.QUEUED:
            self.scheduler.remove(req)
        else:
            slot = self._slot_of(req)
            if slot is not None:
                self._evict_slot(slot, req)
        req.state = RequestState.TIMED_OUT
        req.finish_reason = f"deadline {req.deadline_s:.3f}s exceeded"
        req.t_done = time.perf_counter()
        self.metrics.timed_out += 1
        self._event(req)

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        late = [r for r in self.scheduler.queue
                if r.deadline_s is not None
                and now - r.t_submit > r.deadline_s]
        late += [r for _, r in self.scheduler.active_slots()
                 if r.deadline_s is not None
                 and now - r.t_submit > r.deadline_s]
        for req in late:
            self._time_out(req)

    # -- preemption -----------------------------------------------------
    def _pick_victim(self, max_priority: int, exclude: Sequence[int] = ()
                     ) -> Optional[Tuple[int, Request]]:
        """The lowest-priority, most recently submitted decoding slot of
        priority at most ``max_priority`` (the newest, cheapest request
        loses first, so preemption cannot ping-pong)."""
        cands = [(s, r) for s, r in self.scheduler.active_slots()
                 if r.state is RequestState.DECODE and s not in exclude
                 and r.priority <= max_priority]
        if not cands:
            return None
        return min(cands, key=lambda sr: (sr[1].priority, -sr[1].t_submit))

    def _preempt(self, slot: int, req: Request, why: str) -> None:
        """Evict a decoding request and requeue it at the back of the
        line; its resume prefills prompt + output (mostly a prefix hit)
        at its own key counters.  A request evicted more than
        ``max_preemptions`` times is REJECTED instead, so that the engine
        terminates."""
        self._evict_slot(slot, req)
        if req.preemptions >= self.max_preemptions:
            req.state = RequestState.REJECTED
            req.finish_reason = (f"gave up after {req.preemptions} "
                                 f"preemptions under memory pressure "
                                 f"({why})")
            req.t_done = time.perf_counter()
            self.metrics.rejected += 1
            self._event(req)
            return
        req.preemptions += 1
        req.state = RequestState.QUEUED
        req.prefilled = 0
        req.cached_prefix = 0
        req.draft_filled = 0
        req.pending_first = None
        self.scheduler.queue.append(req)
        self.metrics.preemptions += 1
        if req.on_event is not None:
            req.on_event(req, f"preempted ({why})")

    def _preempt_for_admission(self) -> None:
        """The head of the queue waits for a slot or for blocks: evict
        strictly lower-priority decoders until it fits.  Equal priority
        never preempts (FCFS among peers)."""
        if not self.scheduler.queue:
            return
        head = self.scheduler.queue[0]
        for _ in range(self.max_slots + 1):
            blocked_slot = not self.scheduler.free_slots()
            blocked_blocks = (not blocked_slot and self.runner.paged
                              and not self._make_can_fit()(head))
            if not (blocked_slot or blocked_blocks):
                return
            victim = self._pick_victim(head.priority - 1)
            if victim is None:
                return
            self._preempt(victim[0], victim[1],
                          "admission of higher-priority request "
                          f"{head.rid}")

    # ------------------------------------------------------------------
    def fork(self, parent: Request, n: int, *,
             seeds: Optional[Sequence[int]] = None,
             params: Optional[SampleParams] = None,
             on_token: Optional[Callable[[Request, int], None]] = None
             ) -> List[Request]:
        """Clone a decoding request into ``n`` children that share every
        KV block of its committed tokens (best-of-n from one prompt's
        cache, no recompute).  The children take free slots at once and
        diverge through their own seeds (``seeds``, default
        ``fork_seeds(parent.seed, n)``) and ``params`` (default the
        parent's); a shared block is copied at its first divergent write.
        The steps in flight are applied first, so that a pipelined
        engine forks from the host state a synchronous one would have.
        Short of blocks, the fork preempts strictly lower-priority
        decoders first, as the reference does.

        Raises ValueError on the contiguous cache, when the parent is
        not decoding or fewer than ``n`` slots are free, and MemoryError
        when the pool cannot hold the children's uncommitted tails with
        no one left to evict (or an allocation fault hits mid-fork: the
        children made so far are cancelled first)."""
        if not self.runner.paged:
            raise ValueError("fork requires the paged KV cache")
        self._drain_inflight()
        if parent.state is not RequestState.DECODE:
            raise ValueError("fork parent must be actively decoding")
        pslot = next(s for s, r in self.scheduler.active_slots()
                     if r is parent)
        free = self.scheduler.free_slots()
        if len(free) < n:
            raise ValueError(f"fork needs {n} free slots, have {len(free)}")
        kv = self.runner.kv
        # [0, pos) is written: the prompt and every emitted token but the
        # last.  Committing it first makes the children share the partial
        # block that holds the decode positions written since the last
        # full block, instead of taking fresh (unwritten) blocks there
        kv.commit_tokens(pslot, parent.prompt + parent.output[:-1])
        while n * kv.fork_cost(pslot) > kv.free_blocks:
            victim = self._pick_victim(parent.priority - 1,
                                       exclude=(pslot,))
            if victim is None:
                raise MemoryError(f"fork needs {n * kv.fork_cost(pslot)} "
                                  f"blocks, free {kv.free_blocks}")
            self._preempt(victim[0], victim[1],
                          f"fork of request {parent.rid}")
        child_seeds = (list(seeds) if seeds is not None
                       else fork_seeds(parent.seed, n))
        if len(child_seeds) != n:
            raise ValueError(f"fork needs {n} seeds, got {len(child_seeds)}")
        children: List[Request] = []
        for i, slot in enumerate(free[:n]):
            try:
                kv.fork(pslot, slot)
            except MemoryError:
                for c in children:
                    self.cancel(c, "fork aborted: allocation failure "
                                   "mid-fork")
                raise
            child = Request(self._next_rid, list(parent.prompt),
                            parent.max_new_tokens, parent.eos_id,
                            params if params is not None else parent.params,
                            on_token, seed=child_seeds[i])
            self._next_rid += 1
            child.state = RequestState.DECODE
            child.output = list(parent.output)
            child.prefilled = len(parent.prompt)
            child.cached_prefix = kv.committed(slot)
            child.truncated = parent.truncated
            child.t_submit = child.t_first = time.perf_counter()
            child.t_submit_wall = time.time()
            self.scheduler.slots[slot] = child
            for lane in (self._tok, self._pos, self._active, self._eos,
                         self._remaining, self._counts):
                lane[slot] = lane[pslot]
            self._temps[slot] = child.params.temperature
            self._topks[slot] = child.params.top_k
            self._topps[slot] = child.params.top_p
            self._seeds[slot] = child_seeds[i] & 0xFFFFFFFF
            self._host_fresh[slot] = True
            self._ahead[slot] = 0
            children.append(child)
        dsts = free[:n]
        # the pools are shared through the block table; state rows and
        # the drafter's contiguous rows are per slot and copied
        self.runner.dense_fork(pslot, dsts)
        if self.runner.speculate_k:
            self.runner.draft_fork(pslot, dsts)
        self.metrics.max_active = max(self.metrics.max_active,
                                      len(self.scheduler.active_slots()))
        return children

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
            kv = self.runner.kv
            # the prompt and every output token whose K/V was written (all
            # but the last) are registered before the blocks park in the
            # LRU, for a follow-up or a repeated prompt to share
            kv.commit_tokens(slot, req.prompt + req.output[:-1])
            kv.free_slot(slot)
        self._slot_gen[slot] += 1      # in-flight results: discard
        self.scheduler.release(slot)
        self.metrics.observe(req)
        self._event(req)

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
            if self.runner.prefix_cache:
                # matched blocks still live are shared, not allocated (a
                # matched block at refcount zero still takes a free one)
                _, blocks = kv.match_prefix(req.seq_tokens)
                need -= sum(1 for b in blocks if kv.refcount(b) > 0)
            if planned + need > kv.free_blocks:
                return False
            planned += need
            return True

        return can_fit

    def _start_decode(self, slot: int, req: Request, tok: int) -> None:
        """A (re)prefill sampled the request's next token: move it into
        the decode batch (or finish it when that was its last).  A
        request resumed with m tokens already emitted decodes on from
        position L + m at key counter m + 1.  When speculating, the
        caller fills the drafter's cache: batched at admission
        (``_fill_drafter``) or chunk by chunk."""
        if req.t_first == 0.0:
            req.t_first = time.perf_counter()
        req.state = RequestState.DECODE
        L, m = len(req.prompt), len(req.output)
        cap = self.max_seq_len - L + 1
        req.truncated = req.max_new_tokens > cap
        self._tok[slot] = tok
        self._pos[slot] = L + m
        self._active[slot] = True
        self._remaining[slot] = min(req.max_new_tokens, cap) - 1 - m
        self._counts[slot] = m + 1
        self._host_fresh[slot] = True  # host lanes authoritative again
        self._ahead[slot] = 0
        self._emit(req, int(tok))
        if self.scheduler.slots[slot] is not req:
            return                     # its callback cancelled it
        if (self._remaining[slot] <= 0
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(slot, req)

    def _fill_drafter(self, rows: Sequence[Tuple[int, Request]],
                      bucket: Optional[int] = None) -> None:
        """When speculating, one batched narrow forward fills the
        drafter's cache of every admitted row still decoding with its
        written positions, ``seq_tokens[:-1]`` (the prompt when fresh,
        prompt + output but the last token on a resume), right-padded
        to ``bucket`` (default: the bucket of the longest)."""
        started = [(s, r) for s, r in rows if r.state is RequestState.DECODE
                   and self.scheduler.slots[s] is r]
        if not (self.runner.speculate_k and started):
            return
        seqs = [r.seq_tokens[:-1] for _, r in started]
        self.runner.draft_prefill(
            seqs, bucket or self.runner.bucket_for(max(map(len, seqs))),
            [s for s, _ in started])

    def _unadmit(self, rows: List[Tuple[int, Request]]) -> None:
        """Roll an admission back (an allocation fault mid-round, or a
        transfer fault on the prefill that would have sampled the first
        tokens): the blocks freed (nothing was committed, so no later
        match sees half-written bytes) and the requests requeued at the
        front, in request order, keeping their FCFS turn."""
        for slot, req in rows:
            if self.runner.paged:
                self.runner.kv.free_slot(slot)
            self._active[slot] = False
            self._slot_gen[slot] += 1
            self._ahead[slot] = 0
            self.scheduler.release(slot)
            req.state = RequestState.QUEUED
            req.cached_prefix = 0
            req.prefilled = 0
            req.draft_filled = 0
            req.pending_first = None
        self.scheduler.queue.extendleft(
            [r for _, r in sorted(rows, key=lambda sr: sr[1].rid,
                                  reverse=True)])

    def _admit(self) -> int:
        """Admit queued requests into free slots (after preempting for a
        starved higher-priority head) and prefill them: each shares the
        longest cached prefix of its ``seq_tokens``; per bucket one
        batched call for the cold prompts, then one chunk-program call
        for every warm tail of the round (int8 KV: every prompt, from
        position 0 when cold); with chunked prefill the chunks run in
        ``_prefill_chunks``, from the end of the cached prefix.  Each
        call's blocks are committed once it is issued.  An allocation
        fault un-admits that request, a transfer fault the call's rows.
        Returns the number that made prefill progress (for the
        watchdog)."""
        self._preempt_for_admission()
        chunked = self.runner.prefill_chunk > 0
        kv = self.runner.kv
        warm_rows: List[Tuple[int, Request]] = []
        admitted = 0
        for bucket, group in self.scheduler.plan_admission(
                self._make_can_fit()):
            if self.runner.paged:
                # a block is matchable once committed, after the call that
                # writes it was issued: a match within this round hits
                # blocks whose writes are already in the stream
                kept, bounced = [], []
                for slot, req in group:
                    try:
                        req.cached_prefix = kv.allocate(
                            slot, self._reserve_tokens(req),
                            tokens=req.seq_tokens)
                        kept.append((slot, req))
                    except MemoryError:
                        bounced.append((slot, req))
                if bounced:
                    self._unadmit(bounced)
                group = kept
            admitted += len(group)
            for slot, req in group:
                if req.output:
                    self.metrics.resumes += 1
                self._temps[slot] = req.params.temperature
                self._topks[slot] = req.params.top_k
                self._topps[slot] = req.params.top_p
                self._seeds[slot] = req.seed & 0xFFFFFFFF
                self._eos[slot] = -1 if req.eos_id is None else req.eos_id
                self._counts[slot] = len(req.output)   # the resume counter
                req.prefilled = 0
            if chunked:
                # chunks run in _prefill_chunks, the target's from the end
                # of the cached prefix, the drafter's (no prefix cache)
                # from position 0; the slots' state rows belonged to their
                # previous tenants: zero them first
                for _, req in group:
                    req.prefilled = req.cached_prefix
                    req.draft_filled = 0
                    req.pending_first = None
                kv.reset_slots([s for s, _ in group])
                continue
            if self.runner.kv_dtype == "int8":
                # int8 KV: cold prompts run through the chunk program too,
                # as in the reference, so that every first token comes
                # from attention over the quantized pool bytes
                warm_rows += group
                continue
            cold = [(s, r) for s, r in group if not r.cached_prefix]
            warm_rows += [(s, r) for s, r in group if r.cached_prefix]
            if not cold:
                continue
            slots = [s for s, _ in cold]
            reqs = [r for _, r in cold]
            try:
                toks = self.runner.prefill(
                    [r.seq_tokens for r in reqs], bucket, slots,
                    [r.seed for r in reqs], [len(r.output) for r in reqs],
                    [r.params for r in reqs])
            except TransferFault:
                self.metrics.transfer_faults += 1
                self._unadmit(cold)
                admitted -= len(cold)
                continue
            if self.runner.paged:
                for slot, req in cold:
                    kv.commit_tokens(slot, req.seq_tokens)
            for slot, req, tok in zip(slots, reqs, toks):
                req.prefilled = len(req.seq_tokens)
                self._start_decode(slot, req, int(tok))
            self._fill_drafter(cold, bucket)
        if warm_rows:
            # after every cold prefill of the round: one call for all
            try:
                toks = self.runner.warm_prefill(
                    [r.seq_tokens for _, r in warm_rows],
                    [r.cached_prefix for _, r in warm_rows],
                    [s for s, _ in warm_rows],
                    [r.seed for _, r in warm_rows],
                    [len(r.output) for _, r in warm_rows],
                    [r.params for _, r in warm_rows])
            except TransferFault:
                self.metrics.transfer_faults += 1
                self._unadmit(warm_rows)
                return admitted - len(warm_rows)
            for slot, req in warm_rows:
                kv.commit_tokens(slot, req.seq_tokens)
            for (slot, req), tok in zip(warm_rows, toks):
                req.prefilled = len(req.seq_tokens)
                self._start_decode(slot, req, int(tok))
            # the drafter has no prefix cache: it takes whole sequences
            self._fill_drafter(warm_rows)
        return admitted

    def _prefill_chunks(self) -> int:
        """Advance every prefilling request by one chunk (one batched
        call) over its ``seq_tokens``, starting the decode of rows now
        fully in the cache.  When speculating, the drafter's cache fills
        chunk by chunk in step (its own batched call): a row whose target
        sequence is in first parks its token in ``pending_first``, and
        joins the decode batch only when both cursors have caught up.
        Returns rows advanced (0 on a transfer fault: nothing on the host
        moves, and the retry writes the same chunk bytes)."""
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
            try:
                cand = self.runner.chunk(toks, pos, [s for s, _ in tgt],
                                         last_idx, [r.seed for _, r in tgt],
                                         [len(r.output) for _, r in tgt],
                                         [r.params for _, r in tgt])
            except TransferFault:
                self.metrics.transfer_faults += 1
                return 0
            for i, (slot, req) in enumerate(tgt):
                if self.scheduler.slots[slot] is not req:
                    continue           # cancelled by an earlier callback
                seq = req.seq_tokens
                req.prefilled = min(req.prefilled + C, len(seq))
                # the chunk's writes are in the stream: its full blocks
                # are matchable by later admissions
                self.runner.kv.commit_tokens(slot, seq[:req.prefilled])
                if req.prefilled == len(seq):
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
            if (self.scheduler.slots[slot] is req
                    and req.pending_first is not None
                    and req.prefilled >= len(req.seq_tokens)
                    and req.draft_filled >= len(req.seq_tokens)):
                tok, req.pending_first = req.pending_first, None
                self._start_decode(slot, req, tok)
        return len({s for s, _ in tgt} | {s for s, _ in drows})

    def _cow(self, active: List[Tuple[int, Request]]) -> None:
        """Copy-on-write before a decode or speculative dispatch: every
        block a lane is about to write while sharing it (fork siblings,
        live prefix-cache readers) is copied first, so that the others
        keep its bytes.  The write span is K + 1 positions past the host
        mirror, times the steps in flight plus this one: a dispatched
        step must find every position it may write already in a block of
        its own.  A lane that finished in a step still in flight runs
        idle (zeroed table row) and needs none.  Short of blocks, the
        writer preempts an equal- or lower-priority decoder and retries;
        with no one to evict it preempts itself, as in the reference
        (``ensure_writable`` is all or nothing).  The pairs of a writer
        preempted later in the pass are dropped before the copy: its new
        blocks went back to the pool."""
        kv = self.runner.kv
        span = (self.runner.speculate_k + 1) * (len(self._inflight) + 1)
        taken: List[Tuple[int, Request, List[Tuple[int, int]]]] = []
        for slot, req in active:
            if self.scheduler.slots[slot] is not req \
                    or self._remaining[slot] <= self._ahead[slot]:
                continue
            lo = int(self._pos[slot])
            while True:
                try:
                    taken.append((slot, req,
                                  kv.ensure_writable(slot, lo, lo + span)))
                    break
                except MemoryError as e:
                    victim = self._pick_victim(req.priority,
                                               exclude=(slot,))
                    if victim is None:
                        self._preempt(slot, req, f"copy-on-write: {e}")
                        break
                    self._preempt(victim[0], victim[1],
                                  f"copy-on-write by request {req.rid}")
        self.runner.copy_blocks([p for slot, req, ps in taken
                                 if self.scheduler.slots[slot] is req
                                 for p in ps])

    # -- applying step results -----------------------------------------
    #
    # One routine per kind applies a decode / speculative step's result
    # to host state, shared by the synchronous and the pipelined loop.
    # ``rows`` is the (slot, request, slot generation) snapshot taken at
    # dispatch: a row whose slot was released since (its request
    # finished, was preempted, cancelled or timed out) is discarded.

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
            n += 1
            if self.scheduler.slots[slot] is not req:
                continue               # its callback cancelled it
            self._tok[slot] = tok
            self._pos[slot] += 1
            self._counts[slot] += 1
            self._remaining[slot] -= 1
            if done[slot]:
                self._finish(slot, req)
        return n

    def _apply_spec(self, rows: List[Tuple[int, Request, int]], toks_mat,
                    counts) -> int:
        """Emit each slot's 1..K+1 tokens of a speculative step, stopping
        at EOS, at the slot's remaining budget, or where a callback
        cancelled the request, as plain decode would.  Acceptance charges
        only the proposals a slot could use: the budget caps the window
        up front, and an EOS stop drops the proposals after it, so an
        early finish does not drag the rate below its true value."""
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
                emitted += 1
                if self.scheduler.slots[slot] is not req:
                    break
                self._tok[slot] = tok
                self._pos[slot] += 1
                self._counts[slot] += 1
                self._remaining[slot] -= 1
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

    def _dispatch(self, active: List[Tuple[int, Request]]) -> None:
        """Dispatch the next decode / speculative step, no host transfer.
        With a step in flight, this one's inputs are composed on the
        device from that step's still-unfetched result (``carry``); lanes
        the host rewrote since (fresh admissions, resumes) or that were
        idle in the carried step take the host values (``override``).  A
        lane whose budget runs out in a step in flight has finished
        there: it runs idle, as the sync engine would run it, so that the
        sweep bound is the sync engine's (a plain step advances each lane
        by exactly one).  When every lane has, the reference still
        dispatches a step: the port runs no device work for it, but
        queues a step with no rows and no handle in its place, so that
        the engine's ticks and the sequence of fault sites stay the
        reference's."""
        r = self.runner
        K = r.speculate_k
        lanes = self._active & (self._remaining > self._ahead)
        if not lanes.any():
            self._inflight.append({"handle": None, "rows": [],
                                   "spec": bool(K)})
            return
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

    def _process_oldest(self) -> int:
        """Wait on the oldest step in flight and apply it.  Returns the
        number of rows applied, or -1 on a transfer fault.  A pipelined
        fault leaves the step at the head of the queue: the retry next
        tick re-reads its result (its staging slot stays busy, and
        back-pressure dispatches nothing on top).  A synchronous fault
        drops the step instead: its stage is freed and its lanes' host
        values are authoritative again, so that the next tick recomputes
        it from the same inputs, as the reference's synchronous loop
        does.  TTFT and TPOT marks are taken here, when the transfer has
        landed, never at dispatch."""
        entry = self._inflight[0]
        handle = entry["handle"]
        try:
            if handle is None:
                self.runner._maybe_inject_transfer(
                    "draft_verify" if entry["spec"] else "decode")
            elif entry["spec"]:
                toks_mat, counts = self.runner.wait_spec(handle)
            else:
                toks, done = self.runner.wait_decode(handle)
        except TransferFault:
            self.metrics.transfer_faults += 1
            if not self.pipeline_depth:
                self._inflight.popleft()
                self.runner.drop(handle)
                for slot, _, gen in entry["rows"]:
                    if gen == self._slot_gen[slot]:
                        self._ahead[slot] -= 1
                        self._host_fresh[slot] = True
            return -1
        self._inflight.popleft()
        if handle is None:
            return 0
        if entry["spec"]:
            return self._apply_spec(entry["rows"], toks_mat, counts)
        return self._apply_decode(entry["rows"], toks, done)

    def _drain_inflight(self) -> None:
        """Apply every step in flight (fork needs the exact host state).
        Bounded retries keep a transfer-fault storm from hanging it."""
        for _ in range(1000):
            if not self._inflight:
                return
            self._process_oldest()
        raise EngineStallError(
            "pipeline drain: transfer-fault storm outlived its retry "
            "budget", self.stall_diagnostic())

    def step(self) -> int:
        """Sleep an injected slow step, expire deadlines, admit (first
        preempting for a starved higher-priority head), advance chunked
        prefills by one chunk, then dispatch one decode step (or one
        speculative draft + verify step) for every decoding slot, and
        wait on the oldest step in flight once more than
        ``pipeline_depth`` are queued: at once in the synchronous engine
        (depth 0); with depth > 0 admission, chunked prefill and the
        next dispatch overlap the steps still on the device.  Transfer
        faults are absorbed here (``_process_oldest``).  Returns the
        number of requests that made progress; a run of
        ``watchdog_patience`` steps without any, with work pending, fires
        the stall watchdog."""
        t0 = time.perf_counter()
        if self.faults is not None:
            dt = self.faults.take_slow()
            if dt > 0:
                time.sleep(dt)
        self._expire_deadlines()
        progress = self._admit()
        if self.runner.prefill_chunk:
            progress += self._prefill_chunks()
        self.metrics.max_active = max(self.metrics.max_active,
                                      len(self.scheduler.active_slots()))
        active = [(s, r) for s, r in self.scheduler.active_slots()
                  if r.state is RequestState.DECODE]
        dispatched = False
        if active and len(self._inflight) <= self.pipeline_depth:
            if self.runner.paged:
                self._cow(active)      # may preempt: re-filter
                active = [(s, r) for s, r in active
                          if self.scheduler.slots[s] is r]
            if active:
                self._dispatch(active)
                dispatched = True
        processed_any = False
        while len(self._inflight) > self.pipeline_depth:
            n = self._process_oldest()
            if n < 0:
                break                  # a transfer fault: retry next tick
            processed_any = True
            if not dispatched:
                progress += n
        if dispatched and (processed_any or self.pipeline_depth):
            # a pipelined dispatch is progress (the watchdog must not
            # fire on work the device is running); a synchronous step
            # only once its result landed
            progress += len(active)
        if not dispatched and not processed_any and self._inflight:
            n = self._process_oldest()          # the tail: drain
            if n > 0:
                progress += n
        return self._finish_step(t0, progress)

    def _finish_step(self, t0: float, progress: int) -> int:
        self.steps_run += 1
        # the step-time EMA for the deadline estimate; alpha 0.2 forgets
        # a one-off spike within a few steps
        dt = time.perf_counter() - t0
        self._step_ema = (dt if self._step_ema is None
                          else 0.8 * self._step_ema + 0.2 * dt)
        if progress > 0 or not self.scheduler.has_work():
            self._stalled_steps = 0
        else:
            self._stalled_steps += 1
            if self._stalled_steps >= self.watchdog_patience:
                self._watchdog_fire()
        return progress

    def _watchdog_fire(self) -> None:
        """``watchdog_patience`` steps in a row without progress, with
        work pending: if the head of the queue waits for a slot or for
        blocks, preempt a decoder (equal priority allowed: anything beats
        livelock); with no one to evict, shed the head with the stall
        diagnostic as its reason.  A stall with nothing queued is on the
        device side (a transfer-fault storm): scheduling can free
        nothing, and ``run`` reports it when its budget ends."""
        self.metrics.watchdog_fires += 1
        self._stalled_steps = 0
        if not self.scheduler.queue:
            return
        head = self.scheduler.queue[0]
        blocked_slot = not self.scheduler.free_slots()
        blocked_blocks = (not blocked_slot and self.runner.paged
                          and not self._make_can_fit()(head))
        if blocked_slot or blocked_blocks:
            victim = self._pick_victim(head.priority)
            if victim is not None:
                self._preempt(victim[0], victim[1],
                              "watchdog: head-of-line starved")
                return
        self.scheduler.remove(head)
        head.state = RequestState.REJECTED
        head.finish_reason = ("watchdog: no forward progress for "
                              f"{self.watchdog_patience} steps; "
                              f"{self._stall_summary()}")
        head.t_done = time.perf_counter()
        self.metrics.rejected += 1
        self._event(head)

    def stall_diagnostic(self) -> Dict[str, Any]:
        """The queued / active / pool snapshot for stall reports (the
        reference's keys, in its order)."""
        sched = self.scheduler
        active = sched.active_slots()
        diag: Dict[str, Any] = {
            "steps_run": self.steps_run,
            "queued": len(sched.queue),
            "head_rid": sched.queue[0].rid if sched.queue else None,
            "active_prefill": sum(1 for _, r in active
                                  if r.state is RequestState.PREFILL),
            "active_decode": sum(1 for _, r in active
                                 if r.state is RequestState.DECODE),
            "preemptions": self.metrics.preemptions,
            "watchdog_fires": self.metrics.watchdog_fires,
            "transfer_faults": self.metrics.transfer_faults,
            "steps_in_flight": len(self._inflight),
        }
        if self.runner.paged:
            kv = self.runner.kv
            diag["free_blocks"] = kv.free_blocks
            diag["block_utilization"] = kv.utilization()["block_utilization"]
            if sched.queue:
                diag["head_needs_blocks"] = kv.blocks_for(
                    self._reserve_tokens(sched.queue[0]))
        return diag

    def _stall_summary(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in
                         self.stall_diagnostic().items())

    def run(self, max_steps: int = 10000, *,
            allow_incomplete: bool = False) -> None:
        """Drain queue, slots and steps in flight.  Running out of
        ``max_steps`` with work pending raises EngineStallError with
        ``stall_diagnostic()`` attached, unless ``allow_incomplete``
        (the engine stays whole: ``run`` can be called again)."""
        for _ in range(max_steps):
            if not self.scheduler.has_work() and not self._inflight:
                return
            self.step()
        if ((self.scheduler.has_work() or self._inflight)
                and not allow_incomplete):
            raise EngineStallError(
                f"engine stalled: {max_steps} steps exhausted with "
                f"{len(self.scheduler.queue)} queued and "
                f"{len(self.scheduler.active_slots())} active requests "
                f"({self._stall_summary()})", self.stall_diagnostic())

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 params: SampleParams = SampleParams()) -> List[List[int]]:
        """Submit every prompt (default seeds), run to the end, return
        the streams."""
        reqs = [self.submit(p, max_new_tokens, params=params)
                for p in prompts]
        self.run()
        return [r.output for r in reqs]
