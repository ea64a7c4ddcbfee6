"""On-card smoke test of the PyTorch port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA GPU.  Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from the sources in the checkout
     (nvcc, one process per source, in parallel) and print ptxas's report;
  3. hold each kernel against its plain PyTorch version at the shapes of
     the serving paths below (tolerance bf16 2e-2, fp32 1e-4; the scan
     with bf16 inputs 5e-2), and time kernel, plain version and one
     PyTorch library call (yardstick only; none computes the scan) with
     CUDA events, beside the kernel's bound on an H100 (3.35 TB/s, 989
     TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores); the W8A16
     matmul at seven shapes (decode MLP, decode LM head with fp32 x, the
     five prefill products), each with fp32 and with bf16 output (which
     must be bitwise the fp32 output's cast) and the route it took;
     flash prefill at the pt-6b-d4 and the dense-6b layouts, each with
     the route it took (which must be the one ``route`` names); RMSNorm
     by route (``norm``, ``add_norm``, ``fuse_norm``) at the pt-6b-d4 and
     dense-6b decode and prefill shapes (``check_rmsnorm``), each beside
     a yardstick of PyTorch calls; ``ssm_scan``'s selective route
     (``check_selective_scan``: the Mamba mixer's discretisation, chunk
     mask, recurrence and C contraction fused) at the falcon-mamba chunk
     (dt, x [8, 256, 8192], d_state 16), h_last gated bitwise the unfused
     route's (a, b, h in device memory, the scan route, the einsum) and
     y within 1e-5, then at ragged lens and d_state 4 / 1 / 5; its scan
     route at the falcon-mamba chunk shape (which no serve path launches
     any more), then at ragged S, d_state 1, bf16 inputs and an odd
     feature count; ``decode_attention`` (the contiguous cache) at the
     dense-6b decode shape, bf16 and int8, and at the speculative runs'
     drafter shape (4 tracks x 8 slots folded: q [32, 4, 128], cache
     [32, 584, 1, 128]), bf16.  The W8A16, flash, RMSNorm and
     decode rows (the split-KV template, paged and contiguous, fp and
     int8) are timed as device work (their calls replayed from a CUDA
     graph, as their library calls; the eager loops' times beside them),
     each with its share of the bound; the decode rows with their split
     plan, and the fp decode rows over a short sweep of B 1 and 8 by live
     length 64, 576 and 4096; then this slice's shapes
     (``check_layer_kernels``): flash at gemma3-4b's prefill (q [8, 1536,
     8, 320], k, v [8, 1536, 4, 320]), causal and with window 1024, and
     at gemma2-2b's (hd 288, softcap 50), all on the ``wgmma_tma`` route
     (``route``'s), beside SDPA with a boolean mask and, where the rows
     see every earlier key, with ``is_causal``;
     flash's offset route at phase 9's warm tails (q [64, 64, 4, 128] at
     position 448 over K/V gathered [64, 592, 1, 128]), gated bitwise
     against the same rows of a whole-prompt call; paged decode at
     gemma3-4b's global layers (hd 320, 1600 live) and gemma2-2b's (hd
     288, softcap 50); contiguous decode over gemma3-4b's 1024-slot
     rings (hd 320) — each against its plain version, beside SDPA (none
     for a softcap) and its bound;
  4. the reduced PT config in fp32, on the card against the same weights
     on the CPU (tolerance 1e-4): prefill logits, K/V and teacher-forced
     paged decode steps; then with int8 weights, int8 KV and chunked
     prefill (chunk 8): int8 weight payloads bitwise, chunk and decode
     logits, the int8 decode kernel on the CPU's pools; and whether the
     greedy token streams agree; then reduced falcon-mamba in fp32, card
     against CPU (1e-4): whole-prompt prefill then decode, chunked
     prefill (chunk 8, a non-aligned last chunk) then decode, and
     greedy streams, which must be identical; then reduced dense-6b
     (8 layers, d 64) in fp32, card against CPU (1e-4): prefill, paged
     and contiguous decode, paged chunk-8 logits, and greedy streams on
     both caches, which must all be identical; then the reduced PT model
     on the contiguous cache: decode logits and greedy streams; then the
     speculative arm (speculate_k=3, draft_tracks=2): the drafter's
     draft-step logits and the verify logits (1e-4), greedy streams
     identical card vs CPU and to plain decode with whole-prompt prefill,
     chunk 8 and int8 weights + int8 KV, and acceptance 1.0 with the
     tracks tied; then reduced gemma2-2b, gemma3-4b and nemotron-4-15b
     (``check_layer_parity``): prefill of right-padded rows (rings built
     per row), chunk 8 into the paged cache with ring leaves, decode
     across the rings' wrap (1e-4) and greedy streams, identical;
  5. serve pt-6b-d4 at full width (random weights from a seeded
     generator): 8 slots, 8 greedy requests of 512 prompt tokens and 64
     new tokens, block size 16 — TTFT, TPOT, throughput, peak memory and
     each kernel's launch count, which must all be non-zero, and in
     every serve run below the RMSNorm launches by route, which must
     equal ``norm_routes``'s arithmetic; once with
     bf16 weights and KV (flash prefill, one launch per layer per
     prefill call, every one on the ``wgmma_tma`` route; fp paged
     decode), then with int8 weights and int8 KV (every projection and
     the head through the W8A16 kernel, int8 paged decode, prompts
     through the chunk program), whose
     launch counts must equal 7 per layer + 1 head per forward and one
     int8 decode per layer per decode step, the prefill products all on
     the W8A16 kernel's wgmma route, the decode products on its bf16
     decode route and the heads on its fp32 decode-row route; then
     falcon-mamba-7b at full width and depth, bf16, the same workload
     with chunked prefill of 256 tokens, whose launch counts must equal
     64 ``ssm_scan`` per chunk call, every one on the selective route,
     65 ``rmsnorm`` per forward and no attention kernel (TTFT, TPOT, the
     admission step's device busy time and peak memory in the
     ``[falcon] summary`` line); then
     dense-6b at full width and depth, bf16, the same workload, on the
     paged cache and then on the contiguous cache, whose launch counts
     must equal 32 ``flash_attention`` per prefill call (every one on
     the ``wgmma_tma`` route), 65 ``rmsnorm`` per forward and 32 per
     decode step of the cache's decode kernel (``paged_decode_attention``
     or ``decode_attention``), the other never; and pt-6b-d4 bf16 with
     speculate_k=4, draft_tracks=4 on the plain bf16 run's prompts, once
     with its seeded weights (a) and once with the tracks tied in place
     (b): TTFT, TPOT, throughput, peak memory, acceptance rate, spec
     steps, tokens per slot per spec step and each request's stream
     against the plain run's (on the tied weights for (b)); gates: all
     finish, 0 <= acceptance (a) <= 1, 0 < acceptance (b) <= 1 and (b)
     >= (a), one host transfer per step, and the launch arithmetic of
     ``serve_spec``; then, per run, the target's logits teacher-forced
     along the plain streams by plain decode, the verify, the drafter
     and the prefill, whose gates (``check_spec_logits``) hold the
     verify (and the tied drafter) as close to decode as the prefill is,
     and each stream's first divergence to a near-tie; after each of
     these seven sync runs, the same prompts served again by
     ``Engine(pipeline_depth=1, preplan=True)`` (one CUDA graph per
     live-length bucket of the decode or spec step, replayed; step N + 1
     dispatched before step N's transfer is waited on), gated by
     ``serve_planned``: all finish, every decode / spec step a replay
     with one host transfer, the sync run's launch and route arithmetic
     with the replays counted, streams bitwise equal to the sync run's
     (speculative ones too: the decode kernels' split size follows the
     cache's capacity, so the pipelined step's wider bound changes no
     bit), one replayed step bitwise equal to the eager step (logits,
     packed result, cache bytes); with each pair's TTFT, TPOT,
     throughput, peak memory, graph count, capture time and dispatch
     gaps;
  6. where the time goes: device time by kernel (torch.profiler) over the
     step that admits 8 prompts and over three decode steps, and the
     decode step's device busy share against its unprofiled TPOT, for
     the five plain serve runs; for the two speculative runs, one spec
     step's device busy time split between the K + 1 draft forwards and
     the verify, its device ops and its busy share against the
     unprofiled step; for each planned run, one replayed step's device
     busy time, device ops and busy share against the unprofiled step;
  7. sampled serving, pt-6b-d4 bf16 (``serve_sampling``,
     ``spec_boundary``, ``serve_spec_sampled``): the threefry keys, bits
     and uniforms on the card bitwise the CPU port's (gated; the Gumbel
     noise's ulp distance and 64 categorical draws reported); the
     sampling epilogue alone, greedy against sampled, for the decode
     step and the spec step's accept (device work and device ops); phase
     5's prompts served with every request sampled (temperature 0.8,
     top-k 50, top-p 0.95, seeds 0-7), sync then planned with the greedy
     and the sampled programs captured (``serve_planned``'s gates:
     streams bitwise equal to sync, every step a replay, one replay
     bitwise its eager step; each variant's graphs, capture seconds and
     memory); a mixed batch (lanes 0-3 greedy) whose greedy lanes must
     emit phase 5's greedy streams bitwise; greedy speculation (seeded
     tracks) on prompts of 496-503 tokens, whose farthest lane passes
     within K positions below 512, sync against pipelined (the
     drafter's logits bitwise at every step) and planned (streams
     bitwise), gated on at least one step taking another bound; and,
     on the tied tracks, the speculative arm with every request
     sampled (rejection-sampling accept), sync against planned;
  8. pt-6b-d4 bf16 on 2 track ranks of the one card (``serve_ranks``:
     spawned processes, gloo; each rank 4 of the 8 tracks, the paged
     cache, phase 5's prompts, the sync engine): per rank TTFT, TPOT,
     peak memory and the collective's share of a decode step's host
     clock; gates: (a) ranks bitwise equal to each other, (b) 8
     collectives per prefill call and per decode step (a wrapper on
     ``torch.distributed``) and no other, launches and routes equal to
     phase 5's, (c) logits teacher-forced along phase 5's streams and
     the free streams bitwise phase 5's, or else the logits within
     ``check_spec_logits``'s limit;
  9. the prefix cache, copy-on-write blocks and fork, pt-6b-d4 at full
     width on phase 5's seeded tree (``prefix_hit``, ``fork_runs``) and,
     for the speculative arm, on run (b)'s tied tree (``prefix_spec``),
     block 16, SLOTS slots, capacity PROMPT + NEW + 8: (a) a seed request
     (a 448-token shared prefix and a 64-token tail), then 8 requests of
     the same prefix and tails of their own, submitted together, against
     the same 8 served cold (``prefix_cache=False``): every
     ``cached_prefix`` 448, ``prefix_hit_tokens`` 8 x 448, flash prefill
     in the seed's cold call, the warm tails in one chunk call whose
     attention is flash's offset route (32 launches on ``wgmma_tma``),
     every warm stream bitwise its cold one, the invariants, and
     ``check_warm_logits`` (logits teacher-forced along the cold streams
     within ``check_spec_logits``'s limit, every first divergence a
     near-tie; the tail's K/V bytes and every decode step's logits
     bitwise the cold pass's); TTFT p50 / p90 warm against cold, the
     admission step's device busy time, used blocks, peak memory; (b)
     the same with int8 weights and int8 KV (every prompt through the
     chunk program; whether warm equals cold bitwise, and the first
     layer whose K/V bytes differ); (c) a 512-token greedy request forked
     3 ways after 5 decode steps: children bitwise the parent, exactly 3
     copy-on-write copies, used blocks the fork arithmetic; (d) the
     request sampled and forked 4 ways (``fork_seeds``), sync then
     pipelined with the sampled programs planned: every step a replay,
     planned bitwise sync, the children pairwise distinct; (e) (a) with
     speculate_k=4, draft_tracks=4, sync then pipelined with the greedy
     programs planned: the drafter filled for the warm slots, every step
     a replay, planned bitwise sync.  Phases 1-8 serve with the prefix
     cache off (``prefix_cache=False``), as they measured before it;
 10. the robustness layer, pt-6b-d4 at full width on phase 5's seeded
     tree (``robust_runs``): (a) a pool of ROBUST_BLOCKS blocks (half of
     SLOTS requests fit), the prefix cache on: 4 priority-0 requests
     decode, then 4 priority-1 requests arrive and each admission
     preempts one; gates: all DONE, preemptions >= 1 and resumes equal
     to them, the invariants, 0 used blocks at the end, and
     ``check_resume_logits`` (each stream bitwise phase 5's, or the
     logits teacher-forced along phase 5's streams, by the admission
     programs the run took, within ``check_spec_logits``'s limit and
     every first divergence a near-tie); TTFT and TPOT p50 by priority,
     the device busy ms of the step that admits the first resume, the
     cached prefix of each resume; (b) the same with int8 weights and
     int8 KV against an uncontended int8 run (whether the resumes are
     bitwise); (c) transfer faults (``FaultPlan(transfer_ops=...)``) at
     the prefill, decode and draft_verify waits, the prefix cache off:
     plain sync and pipelined with planned programs bitwise phase 5's
     streams, the speculative arm (K 4 of 4 tracks, 2 prompts, 16
     tokens) sync and planned bitwise its fault-free sync run, every
     planned step a replay, no staging slot left busy; (d) a request
     cancelled from its own ``on_token`` and one timed out mid-decode,
     their blocks reclaimed, the other streams bitwise phase 5's; (e) a
     bounded storm of allocation faults: the watchdog fires and sheds
     the head with the stall diagnostic, every request in one terminal
     state;
 11. this slice's models at full width and depth, bf16, seeded random
     weights, all prompts admitted in one round (``serve_layer_models``):
     gemma3-4b, 8 x (1536 in / 64 out), capacity 1608 past its 1024
     window (its 29 local layers' K/V in ring leaves, its 5 global ones'
     in pools: leaf kinds {ring 18, paged 2}), sync then pipelined with
     planned programs; gemma2-2b, 8 x (512 / 32), every layer paged (its
     4096 window covers the capacity), softcaps, hd 288; nemotron-4-15b,
     8 x (512 / 32), LayerNorm, squared ReLU: TTFT, TPOT p50 / p90,
     throughput, peak memory, leaf kinds, launches per kernel and per
     flash / RMSNorm route; gates: every request finished, the launch
     arithmetic (``layer_arith``: flash L a prefill call, per decode
     step the paged kernel on each pool layer and the contiguous one on
     each ring layer; ``norm_routes``: per forward ``norm`` 1 + the
     sandwich and qk norms, ``add_norm`` 2 L), every flash launch on
     ``route``'s route; planned: every step a replay, streams bitwise
     sync.
 12. qwen2-vl-72b at 16 of its 80 layers (sync, planned, its embeddings
     arm) and recurrentgemma-9b at full depth (sync, planned, chunk 512)
     (``serve_phase12``; its phase-3 rows ``check_slice16_kernels``, the
     scan route at its prefill and chunk among them, its phase-4 parity
     ``check_slice16_parity``); every ``ssm_scan`` launch of phases
     11-13 on the scan route (gated).
 13. deepseek-v2-236b at 8 of its 60 layers and deepseek-v3-671b at 5 of
     its 61 (``ds_config``: the dense prefix, then MoE layers; widths,
     heads, experts, top-k, ranks and vocabulary as published), bf16,
     seeded random weights, 8 x (512 / 32) greedy, sync then planned
     (``serve_phase13``): TTFT / TPOT p50 and p90, throughput, peak
     memory, leaf kinds (every layer's latents in pools), launches per
     kernel and route against ``layer_arith`` (flash once per layer a
     prefill call, on ``wgmma_tma`` at q / k width 192 and value width
     128; no decode kernel: MLA's absorbed decode is plain products), the
     MoE's routed and dropped (token, expert) pairs in prefill and
     decode; gates: every request finished, the arithmetic, planned
     streams bitwise sync.  Its phase-3 row (``check_slice17_kernels``):
     flash at the MLA prefill, q, k [8, 512, 128, 192], v [8, 512, 128,
     128], against its plain version and SDPA's memory-efficient
     backend; its phase 4 (``check_slice17_parity``): both reduced
     models, fp32, card against CPU (1e-4), equal streams.
 14. training (``train_phase``; train mode runs plain ops, no kernel):
     (a) reduced PT and dense, fp32, 4 steps of ``make_train_step`` on
     the card and on the CPU from one seeded state (losses within 1e-5,
     params within 2 x the summed lr with at most 1e-3 of a leaf past
     1e-5; no kernel launched); (d) the card-trained reduced PT saved as
     a checkpoint and served by ``launch/serve.py --ckpt-dir`` on the
     card and the CPU (streams equal by the CLI's sha256; flash, paged
     decode and RMSNorm launched); (c) in a child process with
     deterministic algorithms, 6 ``train_loop`` steps against 3, an
     ``AsyncCheckpointer`` save and a resumed loop's 3 (params and
     optimizer state bitwise); (b) pt-6b-d4 at 16 and dense-6b at 8 of
     their 32 layers, bf16 + fp32 master, ``train_loop`` 4 steps of 8 x
     512: step ms, tokens/s, peak memory, losses, the model-FLOP share;
     finite losses and grad norms, every parameter leaf changed.
 15. whisper-medium at full width and depth (24 encoder + 24 decoder
     layers, d 1024, 16 heads of 64), bf16, seeded random weights
     (``serve_whisper``): 8 rows of 1500 seeded frame embeddings and a
     4-token prompt, ``lm_forward`` (encoder + decoder prefill),
     ``pad_cache``, 63 greedy ``lm_decode_step``s on the contiguous
     cache (64 new tokens a row; the engine, as the reference's, serves
     decoder-only models): encode ms, TTFT and TPOT p50, tokens/s, peak
     memory, a decode step's device-busy share (torch.profiler) and byte
     bound, launches by kernel and route; gates: every flash launch
     (encoder full, decoder causal, cross-attention prefill full) on
     ``wgmma_tma`` at hd 64, one per layer and role, ``decode_attention``
     twice a layer a step (self and cross), no other kernel; the first
     logits and the logits teacher-forced along the 64-token streams
     recomputed with the plain versions of flash and
     ``decode_attention`` (mean |diff| at most 2e-2 x the logits' std;
     SDPA in flash's place beside it as a control, not gated);
     one reduced AdamW train step card against CPU.  Its phase-3 rows
     (``check_slice21_kernels``): flash full at the encoder's q, k, v
     [8, 1500, 16, 64] and the cross prefill's q [8, 4, 16, 64] over k, v
     [8, 1500, 16, 64], ``decode_attention`` at the cross decode's q [8,
     16, 64] over [8, 1500, 16, 64] (lengths 1500, G 1); its phase 4
     (``check_whisper_parity``): reduced whisper fp32, card against CPU
     (1e-4), equal greedy streams.
Prints one ``{"kernels": [...]}`` JSON line, then the card line, then
``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import faulthandler
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HBM_BYTES_S = 3.35e12          # H100 SXM data sheet
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12
L2_BYTES = 50 * 2 ** 20
KERNEL_TOL = 2e-2              # bf16, as the reference's kernel sweeps
FP32_KERNEL_TOL = 1e-4         # the fp32 instantiations
# flash rows at a layer model's shape, beside KERNEL_TOL: the largest of
# each output row's error norm over the plain row's norm (row_rel_err),
# which scales with the output where an absolute limit does not (late
# rows of a long prompt are ~0.03 in size).  The kernel reads ~3.5e-3,
# a key tile skipped ~0.7 (tools/flash_attention_variants.py drop_tile)
FLASH_ROW_REL_TOL = 1e-2
PARITY_TOL = 1e-4              # fp32 model on the card vs the CPU

# the serving cells of phase 5, which fix the kernel shapes of phase 3
ARCH, SLOTS, PROMPT, NEW, BLOCK = "pt-6b-d4", 8, 512, 64, 16
FM_ARCH, FM_SLOTS, FM_CHUNK = "falcon-mamba-7b", 8, 256
DENSE_ARCH = "dense-6b"
SPEC_K, SPEC_TRACKS = 4, 4      # the speculative serve runs of phase 5


def log(msg: str) -> None:
    print(msg, flush=True)


T0 = time.perf_counter()
# past this many seconds every thread's stack goes to stderr (once), so a
# run that nears the 1200 s limit shows where it is
STACKS_AFTER_S = 1100


def log_time(done: str) -> None:
    """A phase boundary: what is done and the seconds since the start (the
    script has 1200 s, the kernels' build included)."""
    log(f"[time] {done} at {time.perf_counter() - T0:.1f}s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per call, CUDA events, after one warm-up call per set; the
    sets are cycled so the working set exceeds L2 like the serving path,
    where every other layer's weights run between two calls."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per call of the device work alone: ``iters`` calls (the
    sets cycled, as ``time_ms``) captured in one CUDA graph after a
    warm-up, replayed once and timed with CUDA events.  For calls whose
    launch costs the host more than the kernel takes, an eager loop times
    the host; this times the kernels."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def device_timing(kern, lib, sets, lib_sets, iters: int = 200):
    """A row's times: kernel and library call as device work
    (``graph_ms``), and both eager loops (``time_ms``)."""
    return {"ms": graph_ms(kern, sets, iters),
            "library_ms": graph_ms(lib, lib_sets, iters),
            "eager_ms": time_ms(kern, sets, iters),
            "library_eager_ms": time_ms(lib, lib_sets, iters)}


def decode_extras(row, t, sweep: int, base: int, page, capacity: int):
    """Beside a decode row: its eager times, its split plan (as the
    wrapper makes it on this card: the split size from the cache's
    capacity, the splits from the tokens it sweeps) and its share of the
    bound."""
    from repro_torch.kernels import decode_attention as da
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, per = da.split_plan(sweep, base, page, sms, capacity)
    row.update(eager_ms=t["eager_ms"], library_eager_ms=t["library_eager_ms"],
               split_plan={"splits": splits, "tokens_per_split": per,
                           "blocks": splits * base, "swept": sweep,
                           "capacity": capacity},
               bound_share=row["bound_ms"] / row["ms"],
               timing="ms and library_ms: device work (CUDA graph replay)")
    log(f"[kernel]   {row['name']}: {splits} split(s) of {per} tokens, "
        f"{splits * base} blocks; {100 * row['bound_share']:.1f} % of its "
        f"bound; eager loop {t['eager_ms']:.4f} ms (library "
        f"{t['library_eager_ms']:.4f} ms)")


def timed_extras(row, t, at: str) -> None:
    """Beside a row timed by ``device_timing``: where it was taken, its
    eager times and its share of the bound."""
    row.update(at=at, eager_ms=t["eager_ms"],
               library_eager_ms=t["library_eager_ms"],
               bound_share=row["bound_ms"] / row["ms"],
               timing="ms and library_ms: device work (CUDA graph replay)")
    log(f"[kernel]   {row['name']} at {at}: {100 * row['bound_share']:.1f} "
        f"% of its bound; eager loop {t['eager_ms']:.4f} ms (library "
        f"{t['library_eager_ms']:.4f} ms)")


def copies_for(nbytes: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / max(1, nbytes)))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2 + 3: build the kernels, hold each against its plain version
# ---------------------------------------------------------------------------

def build_kernels() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} CUDA libraries in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {build.nvcc_path()})")
    for src, b in built.items():
        log(f"[build] {src}: {b.seconds:.1f}s -> {b.path.name}")
        for ln in b.ptxas:
            log(f"[build]   {ln}")


def _agree(name, out, ref, tol):
    """Max |out - ref| after a check within ``tol`` (rtol and atol)."""
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise SystemExit(f"[kernel] {name} disagrees with its plain version "
                         f"(max_abs_err {err:.3e}, tol {tol})")
    return err


def row_rel_err(out, ref) -> float:
    """Max over the rows of the last axis of |out - ref|_2 / |ref|_2 (a
    row of zeros in both gives 0)."""
    o, r = out.float(), ref.float()
    return ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
            ).max().item()


def _report(name, route, source, replaces, out, ref, ms, plain_ms, lib_ms,
            bytes_, flops, flop_rate, tol=KERNEL_TOL):
    err = (out.float() - ref.float()).abs().max().item()
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "bytes": bytes_, "ops": flops}
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib}, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    _agree(name, out, ref, tol)
    return row


def check_kernels(dev: torch.device):
    """Phase 3 at the shapes the pt-6b-d4 serving cell gives the kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    cfg = get_config(ARCH)
    n, H, KH, hd, d = (cfg.pt.n_tracks, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_model)
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- paged decode: the decode step near the end of the run ---------
    cap = PROMPT + NEW + 8
    nmax = -(-cap // BLOCK)
    N = SLOTS * nmax + 1
    L = PROMPT + NEW                       # live tokens of every row
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(2))
    table = (perm[:SLOTS * nmax].reshape(SLOTS, nmax) + 1).to(torch.int32)
    table = table.to(dev)
    lengths = torch.full((SLOTS,), L, dtype=torch.int32, device=dev)
    p2 = 1
    while p2 < -(-L // BLOCK):
        p2 *= 2
    max_len = min(nmax, p2) * BLOCK
    one = nbytes(randn(n, N, BLOCK, KH, hd)) * 2
    sets = [(randn(n, SLOTS, H, hd), randn(n, N, BLOCK, KH, hd),
             randn(n, N, BLOCK, KH, hd)) for _ in range(copies_for(one))]
    q, kp, vp = sets[0]
    out = ops.paged_decode_attention(q, kp, vp, table, lengths,
                                     max_len=max_len)
    want = ref.paged_decode_attention_plain(q, kp, vp, table, lengths,
                                            max_len=max_len)
    p_ms = time_ms(lambda q, k, v: ref.paged_decode_attention_plain(
        q, k, v, table, lengths, max_len=max_len), sets, 20)
    # yardstick: SDPA on K/V gathered and expanded beforehand (untimed)
    tbl = table.long()

    def gathered(q, k, v):
        kk = k[:, tbl].reshape(n * SLOTS, nmax * BLOCK, KH, hd)[:, :L]
        vv = v[:, tbl].reshape(n * SLOTS, nmax * BLOCK, KH, hd)[:, :L]
        return (q.reshape(n * SLOTS, H, 1, hd),
                kk.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous(),
                vv.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous())

    lib_sets = [gathered(*s) for s in sets]
    t = device_timing(lambda q, k, v: ops.paged_decode_attention(
        q, k, v, table, lengths, max_len=max_len),
        F.scaled_dot_product_attention, sets, lib_sets)
    del lib_sets
    live = n * SLOTS * L * KH * hd * 2 * 2           # K and V rows, bf16
    rows.append(_report(
        "paged_decode_attention", "cuda",
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro/kernels/decode_attention.py:187", out, want, t["ms"], p_ms,
        t["library_ms"], live + nbytes(q, table, lengths, out),
        4.0 * n * SLOTS * L * H * hd, BF16_FLOP_S))
    decode_extras(rows[-1], t, max_len, n * SLOTS * KH, BLOCK,  # whole blocks
                  nmax * BLOCK)
    del sets, q, kp, vp, out, want
    torch.cuda.empty_cache()
    rows[-1]["shapes"] = decode_shapes(dev, g, paged=True)

    # -- flash prefill: the batched prefill of all 8 prompts, at the
    # pt-6b-d4 layout (8 tracks x 8 prompts) and at dense-6b's ----------
    dcfg = get_config(DENSE_ARCH)
    rows.append(flash_row(dev, g, n * SLOTS, H, KH, hd, ARCH))
    rows[-1]["shapes"] = [flash_row(dev, g, SLOTS, dcfg.n_heads,
                                    dcfg.n_kv_heads, dcfg.head_dim,
                                    DENSE_ARCH)]
    torch.cuda.empty_cache()

    rows.append(check_rmsnorm(dev, g))
    torch.cuda.empty_cache()
    rows += check_int8_kernels(dev, g)
    torch.cuda.empty_cache()
    rows.append(check_selective_scan(dev, g))
    torch.cuda.empty_cache()
    rows += check_decode_attention(dev, g)
    torch.cuda.empty_cache()
    check_layer_kernels(dev, g, rows)
    check_slice16_kernels(dev, g, rows)
    check_slice17_kernels(dev, g, rows)
    check_slice21_kernels(dev, g, rows)
    return rows


def flash_row(dev: torch.device, g: torch.Generator, B: int, H: int,
              KH: int, hd: int, arch: str):
    """Phase 3 for flash prefill at one cell's layout: q [B, PROMPT, H,
    hd], k, v [B, PROMPT, KH, hd] bf16, causal; the kernel and SDPA (on
    K / V expanded and transposed beforehand, untimed) as device work with
    their eager loops beside; the route the launch took, which must be
    the one ``route`` names."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    S, bf = PROMPT, torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    one = 2 * B * S * (H + KH) * hd * 2
    sets = [(randn(B, S, H, hd), randn(B, S, KH, hd), randn(B, S, KH, hd))
            for _ in range(copies_for(one))]
    q, k, v = sets[0]
    routes0 = dict(fa.flash_attention.routes)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    took = {r for r, c in fa.flash_attention.routes.items()
            if c != routes0[r]}
    want_route = fa.route(bf, hd, True)
    if took != {want_route}:
        raise SystemExit(f"[kernel] flash_attention at {arch}'s layout took "
                         f"routes {took}, not {want_route}")
    want = ref.flash_attention_plain(q, k, v, causal=True)

    def bhsd(q, k, v):
        return (q.transpose(1, 2).contiguous(),
                k.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous(),
                v.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous())

    lib_sets = [bhsd(*s) for s in sets]
    t = device_timing(lambda q, k, v: ops.flash_attention(q, k, v,
                                                          causal=True),
                      lambda q, k, v: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True), sets, lib_sets, 50)
    del lib_sets
    p_ms = time_ms(lambda q, k, v: ref.flash_attention_plain(
        q, k, v, causal=True), sets, 4)
    row = _report(
        "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:79", out, want, t["ms"], p_ms,
        t["library_ms"], nbytes(q, k, v, out),
        4.0 * B * H * hd * S * (S + 1) / 2, BF16_FLOP_S)
    row["kernel_route"] = want_route
    timed_extras(row, t, f"q [{B},{S},{H},{hd}], k, v [{B},{S},{KH},{hd}] "
                         f"bf16, causal ({arch}); route {want_route}")
    del sets, q, k, v, out, want
    return row


def check_decode_attention(dev: torch.device, g: torch.Generator,
                           drafter: bool = False):
    """Phase 3 for the contiguous cache: ``decode_attention`` at the
    dense-6b serve run's decode shape near its end (q [8, 32, 128], the
    engine's cache [8, 584, 8, 128], lengths 513-576, max_len 576), bf16
    and int8 with fp32 per-token scales, each held against its plain
    version (bf16 2e-2; the int8 branch with fp32 math inside, as the
    paged int8 row).  With ``drafter``, at the shape the speculative
    serve runs give it instead, bf16 only: the drafter's SPEC_TRACKS
    tracks folded into the batch (q [32, 4, 128], cache [32, 584, 1,
    128]), each slot's length pos + 1 + j of a draft step j <= SPEC_K
    (513-580) on all its tracks, max_len as ``_live_max_len(extra=K,
    paged=False)`` makes it (the next power of two, capped at S = 584).
    Yardstick: SDPA on the same cache with K/V expanded to the query
    heads and the length mask built beforehand (untimed).  The bound
    counts the live rows only."""
    from repro_torch.common.quant import quantize_rows
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    cfg = get_config(ARCH if drafter else DENSE_ARCH)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S, bf = PROMPT + NEW + 8, torch.bfloat16
    if drafter:
        B = SPEC_TRACKS * SLOTS
        lengths = torch.randint(PROMPT + 1, PROMPT + NEW + SPEC_K + 1,
                                (SLOTS,), generator=g, device=dev,
                                dtype=torch.int32).repeat(SPEC_TRACKS)
        max_len = 1
        while max_len < int(lengths.max()):
            max_len *= 2
        max_len = min(S, max_len)
    else:
        B = SLOTS
        lengths = torch.randint(PROMPT + 1, PROMPT + NEW + 1, (B,),
                                generator=g, device=dev, dtype=torch.int32)
        max_len = PROMPT + NEW
    live = int(lengths.sum())
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]           # [B, 1, 1, S]

    def expand(c):
        return c.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous()

    rows = []
    for branch in (("bf16",) if drafter else ("bf16", "int8")):
        one = B * S * KH * (hd * 2 if branch == "bf16" else hd + 4) * 2
        sets = []
        for _ in range(copies_for(one)):
            q = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
            k, v = (torch.randn(B, S, KH, hd, generator=g, device=dev)
                    for _ in range(2))
            if branch == "bf16":
                sets.append((q, k.to(bf), v.to(bf), None, None))
            else:
                (k8, ks), (v8, vs) = quantize_rows(k), quantize_rows(v)
                sets.append((q, k8, v8, ks, vs))
            del k, v

        def kern(q, k, v, ks, vs):
            return ops.decode_attention(q, k, v, lengths, max_len=max_len,
                                        k_scale=ks, v_scale=vs)

        def plain(q, k, v, ks, vs):
            return ref.decode_attention_plain(q, k, v, lengths,
                                              max_len=max_len, k_scale=ks,
                                              v_scale=vs)

        out, want = kern(*sets[0]), plain(*sets[0])
        p_ms = time_ms(plain, sets, 20)

        def lib_args(q, k, v, ks, vs):
            if ks is not None:
                k, v = (k.float() * ks).to(bf), (v.float() * vs).to(bf)
            return q[:, :, None], expand(k), expand(v)

        lib_sets = [lib_args(*st) for st in sets]
        t = device_timing(kern, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), sets, lib_sets)
        del lib_sets
        row_bytes = hd * 2 if branch == "bf16" else hd + 4
        name = "decode_attention" + ("" if branch == "bf16" else "_int8")
        row = _report(
            name, "cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
            "src/repro/kernels/decode_attention.py:92", out, want, t["ms"],
            p_ms, t["library_ms"],
            live * KH * row_bytes * 2 + nbytes(sets[0][0], lengths, out),
            4.0 * live * H * hd,
            BF16_FLOP_S if branch == "bf16" else FP32_FLOP_S)
        decode_extras(row, t, da._sweep_cols(S, 512, max_len), B * KH, None,
                      S)
        row["at"] = (f"q [{B},{H},{hd}] bf16, cache [{B},{S},{KH},{hd}] "
                     f"{'bf16' if branch == 'bf16' else 'int8 + fp32 scales'}"
                     f", lengths {int(lengths.min())}-{int(lengths.max())} "
                     f"({live} live rows), max_len {max_len}")
        if drafter:
            row["at"] += (f" ({ARCH} spec drafter, {SPEC_TRACKS} of "
                          f"{cfg.pt.n_tracks} tracks folded)")
            row["run"] = "spec a"      # main() takes its launches from there
        if branch == "int8":
            row["branch"] = ("int8 cache with fp32 scales (_kernel :60, "
                             "_online_softmax_step :34)")
        log(f"[kernel]   {name} at {row['at']}")
        rows.append(row)
        del sets, out, want
        torch.cuda.empty_cache()
        if branch == "bf16" and not drafter:
            row["shapes"] = (check_decode_attention(dev, g, drafter=True)
                             + decode_shapes(dev, g, paged=False))
    return rows


def decode_shapes(dev: torch.device, g: torch.Generator, paged: bool):
    """The fp decode rows over B 1 and 8 by live length 64, 576 and 4096
    (every row of a batch at that length): pt-6b-d4's paged shape (8
    tracks, G 4 over one KV head, block 16) or dense-6b's contiguous one
    (8 KV heads of G 4, S = length + 8), ``max_len`` as the engine buckets
    it.  Kernel and library call (SDPA on K/V gathered and expanded
    beforehand) as device work; each held against the plain version
    (bf16 2e-2), beside its split plan and bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    cfg = get_config(ARCH if paged else DENSE_ARCH)
    n = cfg.pt.n_tracks if paged else 1
    H, KH, hd, bf = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, torch.bfloat16
    out_rows = []
    for B in (1, SLOTS):
        for L in (64, PROMPT + NEW, 4096):
            S = L + 8
            lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
            if paged:
                nmax = -(-S // BLOCK)
                N = B * nmax + 1
                table = (torch.randperm(N - 1, generator=torch.Generator()
                                        .manual_seed(L))[:B * nmax]
                         .reshape(B, nmax) + 1).to(torch.int32).to(dev)
                p2 = 1
                while p2 < -(-L // BLOCK):
                    p2 *= 2
                max_len = min(nmax, p2) * BLOCK
                shape = (n, N, BLOCK, KH, hd)
                sweep = max_len                    # whole blocks
            else:
                max_len, shape = L, (B, S, KH, hd)
                sweep = da._sweep_cols(S, 512, max_len)
            one = 2 * math.prod(shape) * 2
            sets = [(torch.randn(n, B, H, hd, generator=g, device=dev)
                     .to(bf).reshape((n, B, H, hd) if paged else (B, H, hd)),
                     torch.randn(shape, generator=g, device=dev).to(bf),
                     torch.randn(shape, generator=g, device=dev).to(bf))
                    for _ in range(min(100, copies_for(one)))]
            if paged:
                tbl = table.long()

                def kern(q, k, v):
                    return ops.paged_decode_attention(q, k, v, table, lengths,
                                                      max_len=max_len)

                def plain(q, k, v):
                    return ref.paged_decode_attention_plain(
                        q, k, v, table, lengths, max_len=max_len)

                def lib_args(q, k, v):
                    def one_(c):
                        c = c[:, tbl].reshape(n * B, nmax * BLOCK, KH, hd)
                        return c[:, :L].repeat_interleave(H // KH, 2) \
                            .transpose(1, 2).contiguous()
                    return q.reshape(n * B, H, 1, hd), one_(k), one_(v)
            else:
                def kern(q, k, v):
                    return ops.decode_attention(q, k, v, lengths,
                                                max_len=max_len)

                def plain(q, k, v):
                    return ref.decode_attention_plain(q, k, v, lengths,
                                                      max_len=max_len)

                def lib_args(q, k, v):
                    def one_(c):
                        return c[:, :L].repeat_interleave(H // KH, 2) \
                            .transpose(1, 2).contiguous()
                    return q[:, :, None], one_(k), one_(v)
            out, want = kern(*sets[0]), plain(*sets[0])
            lib_sets = [lib_args(*st) for st in sets]
            t = {"ms": graph_ms(kern, sets, 100),
                 "library_ms": graph_ms(F.scaled_dot_product_attention,
                                        lib_sets, 100),
                 "eager_ms": time_ms(kern, sets, 100),
                 "library_eager_ms": time_ms(F.scaled_dot_product_attention,
                                             lib_sets, 100)}
            del lib_sets
            name = "paged_decode_attention" if paged else "decode_attention"
            row = _report(
                name, "cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                "src/repro/kernels/decode_attention.py:"
                + ("187" if paged else "92"), out, want, t["ms"],
                time_ms(plain, sets[:1], 3), t["library_ms"],
                n * B * L * KH * hd * 2 * 2 + nbytes(sets[0][0], lengths, out),
                4.0 * n * B * L * H * hd, BF16_FLOP_S)
            layout = "paged, 8 tracks" if paged else "contiguous"
            row["at"] = f"B {B}, live {L} ({layout}, max_len {max_len})"
            log(f"[kernel]   {name} at {row['at']}")
            decode_extras(row, t, sweep, n * B * KH, BLOCK if paged else None,
                          nmax * BLOCK if paged else S)
            out_rows.append(row)
            del sets, out, want
            torch.cuda.empty_cache()
    return out_rows


def check_rmsnorm(dev: torch.device, g: torch.Generator):
    """Phase 3 for the RMSNorm kernel (``csrc/rmsnorm.cu``): each route at
    the shapes the serve runs give it, bf16: pt-6b-d4 decode x [8,8,1,1408]
    and prefill [8,8,512,1408] (``norm`` on one fused row broadcast to the
    8 tracks, as the first ln1 reads the embedding; ``add_norm``;
    ``fuse_norm`` at a block boundary, per-track scale rows), dense-6b
    decode [8,1,4096] and prefill [8,512,4096] (``norm``, ``add_norm``;
    one scale row); and ``fuse_norm`` at a track rank's decode boundary
    (phase 8): the 8 tracks' x + delta gathered [8,8,1,1408], no delta,
    the rank's 4 scale rows [4,1408].  Each is held against its plain
    version and timed as device work beside its eager loop, its bytes
    bound and share, and a yardstick of PyTorch calls on the same
    inputs: ``F.rms_norm`` for
    ``norm`` (the library call), for the others the sequence they replace
    (the add, the fp32 mean and cast, then ``F.rms_norm``; the per-track
    scale rows are one row repeated, so its weight is that row).  Returns
    the row of ``add_norm`` at the pt-6b-d4 decode shape (56 of the 65
    launches of each forward, 63 forwards of 64) with the others under
    ``shapes``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    bf = torch.bfloat16
    pcfg, dcfg = get_config(ARCH), get_config(DENSE_ARCH)
    n = pcfg.pt.n_tracks
    cells = [(n, pcfg, "decode", (SLOTS, 1), 200),
             (None, dcfg, "decode", (SLOTS, 1), 200),
             (n, pcfg, "prefill", (SLOTS, PROMPT), 30),
             (None, dcfg, "prefill", (SLOTS, PROMPT), 30)]
    out_rows = []
    for tracks, cfg, phase, bs, iters in cells:
        d, eps = cfg.d_model, cfg.norm_eps
        lead = ((tracks,) if tracks else ()) + bs
        srow = torch.randn(d, generator=g, device=dev) * 0.1
        s = srow[None].expand(tracks, d).contiguous() if tracks else srow
        w = (1.0 + srow).to(bf)
        one = 2 * nbytes(torch.empty(*lead, d, dtype=bf))
        sets = [(torch.randn(*bs, d, generator=g, device=dev).to(bf),
                 torch.randn(*lead, d, generator=g, device=dev).to(bf),
                 torch.randn(*lead, d, generator=g, device=dev).to(bf))
                for _ in range(copies_for(2 * one))]
        routes = ["norm", "add_norm"] + (["fuse_norm"] if tracks else []) \
            + (["fuse_norm rank"] if tracks and phase == "decode" else [])
        for route in routes:
            if route == "norm":
                # the fused row (spread when the model has tracks)
                def args(f, x, dl):
                    return ((f[None].expand(tracks, *f.shape),) if tracks
                            else (f,))
                kern = lambda x: ops.rmsnorm(x, s, eps=eps)
                plain = lambda x: ref.rmsnorm_plain(x, s, eps=eps)
                lib = lambda x: F.rms_norm(x, (d,), weight=w, eps=eps)
                what = "F.rms_norm (library call)"
            elif route == "add_norm":
                def args(f, x, dl):
                    return x, dl
                kern = lambda x, dl: ops.add_rmsnorm(x, dl, s, eps=eps)
                plain = lambda x, dl: ref.add_rmsnorm_plain(x, dl, s,
                                                            eps=eps)

                def lib(x, dl):
                    xn = x + dl
                    return xn, F.rms_norm(xn, (d,), weight=w, eps=eps)
                what = "x + delta, then F.rms_norm"
            elif route == "fuse_norm rank":
                # a rank of RANKS: every track's x + delta gathered, the
                # norm under this rank's scale rows
                sr = s[:tracks // RANKS].contiguous()

                def args(f, x, dl):
                    return (x,)
                kern = lambda x: ops.fuse_rmsnorm(x, None, sr, eps=eps)
                plain = lambda x: ref.fuse_rmsnorm_plain(x, None, sr,
                                                         eps=eps)

                def lib(x):
                    f = torch.mean(x, dim=0, dtype=torch.float32).to(bf)
                    return f, F.rms_norm(f[None].expand(sr.shape[0], *f.shape),
                                         (d,), weight=w, eps=eps)
                what = ("the fp32 track mean and its cast, then F.rms_norm "
                        "on the broadcast to the rank's tracks")
            else:
                def args(f, x, dl):
                    return x, dl
                kern = lambda x, dl: ops.fuse_rmsnorm(x, dl, s, eps=eps)
                plain = lambda x, dl: ref.fuse_rmsnorm_plain(x, dl, s,
                                                             eps=eps)

                def lib(x, dl):
                    xn = x + dl
                    f = torch.mean(xn, dim=0, dtype=torch.float32).to(bf)
                    return f, F.rms_norm(f[None].expand(xn.shape), (d,),
                                         weight=w, eps=eps)
                what = ("x + delta, the fp32 track mean and its cast, then "
                        "F.rms_norm on the broadcast")
            rsets = [args(*a) for a in sets]
            got = kern(*rsets[0])
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*rsets[0])
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                _agree(f"rmsnorm {route}", a, b, KERNEL_TOL)
            t = device_timing(kern, lib, rsets, rsets, iters)
            x0 = rsets[0][0]
            ins = (sets[0][0] if route == "norm" and tracks else x0,) + \
                tuple(rsets[0][1:]) + (sr if route == "fuse_norm rank"
                                       else s,)
            row = _report("rmsnorm", "cuda",
                          "src/repro_torch/kernels/csrc/rmsnorm.cu",
                          "src/repro/kernels/rmsnorm.py:20", got[-1],
                          want[-1], t["ms"],
                          time_ms(plain, rsets, max(5, iters // 10)),
                          t["library_ms"] if route == "norm" else None,
                          nbytes(*ins, *got),
                          4.0 * got[-1].numel() + 2.0 * x0.numel(),
                          FP32_FLOP_S)
            shape = "x [" + ",".join(map(str, x0.shape)) + "]"
            sc = ins[-1]
            timed_extras(row, t, f"{route}: {shape} bf16"
                                 f"{' (one row broadcast)' if route == 'norm' and tracks else ''}"
                                 f"{' (gathered, no delta)' if route == 'fuse_norm rank' else ''}"
                                 f", scale [{','.join(map(str, sc.shape))}] "
                                 f"({ARCH if tracks else DENSE_ARCH} "
                                 f"{phase})")
            row.update(kernel_route=route.split()[0], yardstick=what,
                       yardstick_ms=t["library_ms"],
                       yardstick_eager_ms=t["library_eager_ms"],
                       run=("ranks" if route == "fuse_norm rank" else "bf16")
                       if tracks else "dense paged")
            log(f"[kernel]   rmsnorm {route}: yardstick ({what}) "
                f"{t['library_ms']:.4f} ms as device work")
            out_rows.append(row)
        del sets
        torch.cuda.empty_cache()
    main = out_rows.pop(1)                 # add_norm at the PT decode shape
    main["shapes"] = out_rows
    return main


SCAN_TOL = 1e-5    # y of the selective route against the unfused einsum
                   # (rtol and atol): the d_state sum runs in another order


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units of the last place between two fp32
    tensors of one shape (0: bitwise equal; both signs counted through
    the ordered integer images)."""
    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() \
        else 0


def selective_inputs(dev, g, B: int, S: int, di: int, ds: int, dtr: int):
    """Inputs of the selective route as the Mamba mixer makes them: dt =
    softplus(N(0, 1) / 2 + softplus^-1(1)) [B, S, di]; x N(0, 1); A =
    -(1 .. ds) (the init's -exp(A_log)); Bt, Ct [B, S, ds] as the
    column views of one x_dbl [B, S, dtr + 2 ds] N(0, 1) / 2; h0 N(0, 1)
    [B, di, ds]; all fp32."""
    F = torch.nn.functional
    dt = F.softplus(torch.randn(B, S, di, generator=g, device=dev) / 2
                    + math.log(math.e - 1))
    x = torch.randn(B, S, di, generator=g, device=dev)
    A = -torch.arange(1, ds + 1, dtype=torch.float32,
                      device=dev).expand(di, ds).contiguous()
    x_dbl = torch.randn(B, S, dtr + 2 * ds, generator=g, device=dev) / 2
    h0 = torch.randn(B, di, ds, generator=g, device=dev)
    return dt, x, A, x_dbl[..., dtr:dtr + ds], x_dbl[..., dtr + ds:], h0


def check_selective_scan(dev: torch.device, g: torch.Generator):
    """Phase 3 for the falcon-mamba path: the scan's selective route
    (``selective_scan``: discretisation, chunk mask, recurrence and the C
    contraction fused; one launch per layer per chunk call) at the serve
    run's chunk (dt, x [8, 256, 8192] fp32, d_state 16, Bt / Ct views of
    x_dbl, nonzero h0, every row 256 valid), against its plain version
    (the unfused composition with the plain step loop; y within
    SCAN_TOL) and the unfused route on the card (the same composition on
    the scan route): h_last must be bitwise both, y within SCAN_TOL; then
    ragged lens (a row of 0, rows cut mid-chunk), d_state 4 (the reduced
    config), 1 and 5, checked alike.  Timed as device work (a CUDA graph)
    beside its eager loop, the unfused route's and the plain version's
    times; bound by bytes (dt, x, A, B, C, h0 in, y and h_last out) or by
    fp32 operations (7 a state update + 1 a (row, step, feature)),
    whichever is larger."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import dt_rank_of
    cfg = get_config(FM_ARCH)
    s = cfg.ssm
    di, ds, dtr = s.d_inner, s.d_state, dt_rank_of(cfg)
    B, S = FM_SLOTS, FM_CHUNK
    dt, x, A, Bt, Ct, h0 = selective_inputs(dev, g, B, S, di, ds, dtr)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    args = (dt, x, A, Bt, Ct, h0, lens)
    routes0 = dict(ops.ssm_scan.routes)
    y, hl = ops.selective_scan(*args)
    torch.cuda.synchronize()
    took = {r: n - routes0[r] for r, n in ops.ssm_scan.routes.items()}
    if took != {"scan": 0, "selective": 1}:
        raise SystemExit(f"[kernel] selective_scan took routes {took}")
    ry, rhl = ref.selective_scan_plain(*args)
    uy, uhl = ref.selective_scan_plain(*args, scan=ops.ssm_scan)
    bitwise = torch.equal(hl, rhl) and torch.equal(hl, uhl)
    ulp = max(ulp_distance(hl, rhl), ulp_distance(hl, uhl))
    y_err = _agree("selective_scan y vs the unfused route", y, uy, SCAN_TOL)
    del uy, rhl, uhl
    torch.cuda.empty_cache()
    t = graph_ms(ops.selective_scan, [args], 20)
    eager = time_ms(ops.selective_scan, [args], 20)
    unfused = time_ms(lambda *a: ref.selective_scan_plain(
        *a, scan=ops.ssm_scan), [args], 2)
    p_ms = time_ms(ref.selective_scan_plain, [args], 1)
    bc_bytes = 2 * B * S * ds * 4                   # the B and C values read
    row = _report("ssm_scan", "cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                  "src/repro/kernels/ssm_scan.py:47", y, ry, t, p_ms, None,
                  nbytes(dt, x, A, h0, lens, y, hl) + bc_bytes,
                  7.0 * B * S * di * ds + B * S * di, FP32_FLOP_S,
                  tol=SCAN_TOL)
    row.update(kernel_route="selective", run="falcon",
               at=f"{FM_ARCH} chunk: dt, x [{B},{S},{di}] fp32, d_state "
                  f"{ds}, Bt / Ct views of x_dbl [{B},{S},{dtr + 2 * ds}], "
                  f"h0 [{B},{di},{ds}], lens {S}",
               eager_ms=eager, unfused_ms=unfused,
               h_last_bitwise=bitwise, h_last_max_ulp=ulp,
               y_vs_unfused_max_abs_err=y_err,
               bound_share=row["bound_ms"] / t,
               library_ms_why="no single PyTorch call computes a linear "
                              "recurrence over the sequence axis",
               timing="ms: device work (CUDA graph replay); eager_ms, "
                      "unfused_ms and plain_ms: CUDA events over eager "
                      "loops")
    log(f"[kernel]   ssm_scan selective at {row['at']}: "
        f"{100 * row['bound_share']:.1f} % of its bound; eager loop "
        f"{eager:.4f} ms; the unfused route (a, b, h in device memory, the "
        f"scan route, the einsum) {unfused:.4f} ms; h_last bitwise the "
        f"plain and the unfused route's: {bitwise} (max {ulp} ulp); y vs "
        f"the unfused route max |diff| {y_err:.3e} (tol {SCAN_TOL})")
    if not bitwise:
        raise SystemExit(f"[kernel] selective_scan h_last differs from the "
                         f"unfused route's by up to {ulp} ulp")
    del args, dt, x, A, Bt, Ct, h0, y, hl, ry
    torch.cuda.empty_cache()
    for B, S, di, ds, lens in ((3, 37, 300, s.d_state, [37, 20, 0]),
                               (2, 70, 128, 4, [64, 70]),
                               (2, 33, 96, 1, None),
                               (3, 19, 40, 5, [1, 19, 7])):
        dt, x, A, Bt, Ct, h0 = selective_inputs(dev, g, B, S, di, ds, 8)
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        y, hl = ops.selective_scan(dt, x, A, Bt, Ct, h0, ln)
        uy, uhl = ref.selective_scan_plain(dt, x, A, Bt, Ct, h0, ln,
                                           scan=ops.ssm_scan)
        err = _agree("selective_scan y", y, uy, SCAN_TOL)
        same = torch.equal(hl, uhl)
        log(f"[kernel]   ssm_scan selective at dt [{B},{S},{di}], d_state "
            f"{ds}, lens {lens}: y max_abs_err {err:.3e} (tol {SCAN_TOL}); "
            f"h_last bitwise {same} ({ulp_distance(hl, uhl)} ulp)")
        if not same:
            raise SystemExit("[kernel] selective_scan h_last differs from "
                             "the unfused route's")
    row["shapes"] = [check_ssm_scan(dev, g)]
    return row


def check_ssm_scan(dev: torch.device, g: torch.Generator):
    """Phase 3, the scan route at the falcon-mamba chunk shape (a, b [8,
    256, 8192, 16] fp32, nonzero h0; no serve path launches it since the
    Mamba mixer takes the selective route), timed against its plain
    version and its bound (no single PyTorch call computes the
    recurrence, so no library time); then ragged S, d_state 1, bf16
    inputs and the scalar path, checked only (tolerances as the
    reference's sweep)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    s = get_config(FM_ARCH).ssm
    shape = (FM_SLOTS, FM_CHUNK, s.d_inner, s.d_state)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=dev))
    b = torch.randn(shape, generator=g, device=dev)
    h0 = torch.randn(FM_SLOTS, s.d_inner, s.d_state, generator=g, device=dev)
    (h, hl), (rh, rhl) = ops.ssm_scan(a, b, h0), ref.ssm_scan_plain(a, b, h0)
    _agree("ssm_scan h_last", hl, rhl, FP32_KERNEL_TOL)
    k_ms = graph_ms(ops.ssm_scan, [(a, b, h0)], 10)
    eager = time_ms(ops.ssm_scan, [(a, b, h0)], 20)
    p_ms = time_ms(ref.ssm_scan_plain, [(a, b, h0)], 3)
    row = _report("ssm_scan", "cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                  "src/repro/kernels/ssm_scan.py:47", h, rh, k_ms, p_ms, None,
                  nbytes(a, b, h0, h, hl), 2.0 * a.numel(), FP32_FLOP_S,
                  tol=FP32_KERNEL_TOL)
    row.update(kernel_route="scan", run="falcon", eager_ms=eager,
               bound_share=row["bound_ms"] / k_ms,
               at=f"a, b [{FM_SLOTS},{FM_CHUNK},{s.d_inner},{s.d_state}] "
                  f"fp32, h0 [{FM_SLOTS},{s.d_inner},{s.d_state}] (no serve "
                  f"path launches it: falcon-mamba takes the selective "
                  f"route)",
               library_ms_why="no single PyTorch call computes a linear "
                              "recurrence over the sequence axis",
               timing="ms: device work (CUDA graph replay); eager_ms and "
                      "plain_ms: CUDA events over eager loops")
    log(f"[kernel]   ssm_scan at {row['at']}: "
        f"{100 * row['bound_share']:.1f} % of its bound; eager loop "
        f"{eager:.4f} ms")
    del a, b, h, hl, rh, rhl
    torch.cuda.empty_cache()
    for B, S, di, ds, dt in ((3, 37, s.d_inner, 1, torch.float32),
                             (2, 100, 512, s.d_state, torch.bfloat16),
                             (3, 37, 48, 3, torch.bfloat16),
                             (2, 19, 33, 5, torch.float32)):
        a = torch.sigmoid(torch.randn(B, S, di, ds, generator=g,
                                      device=dev)).to(dt)
        b = torch.randn(B, S, di, ds, generator=g, device=dev).to(dt)
        h0 = torch.randn(B, di, ds, generator=g, device=dev)
        tol = FP32_KERNEL_TOL if dt == torch.float32 else 5e-2
        (h, hl), (rh, rhl) = ops.ssm_scan(a, b, h0), ref.ssm_scan_plain(a, b,
                                                                       h0)
        err = max(_agree("ssm_scan", h, rh, tol),
                  _agree("ssm_scan h_last", hl, rhl, tol))
        log(f"[kernel]   ssm_scan at [{B},{S},{di},{ds}] {str(dt)[6:]}: "
            f"max_abs_err {err:.3e} (tol {tol})")
    return row


def check_int8_kernels(dev: torch.device, g: torch.Generator):
    """Phase 3 for the int8 serving path: the W8A16 matmul at the shapes of
    the int8 serve run (its row reports the decode MLP shape and lists all
    seven: the decode MLP, the fp32 LM head and the five prefill products),
    each with fp32 and bf16 output and the route it took, and the int8
    branch of paged decode at the decode shape."""
    from repro_torch.common.quant import quantize_rows
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant_matmul import route
    F = torch.nn.functional
    cfg = get_config(ARCH)
    n, H, KH, hd, d = (cfg.pt.n_tracks, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_model)
    bf, f32 = torch.bfloat16, torch.float32
    P = SLOTS * PROMPT                  # prefill rows per track
    shapes = []
    for what, nn, M, K, N, xdt, iters, p_iters in (
            ("decode MLP wi_gate", n, SLOTS, d, cfg.d_ff, bf, 200, 20),
            ("decode LM head, fp32 x", 1, SLOTS, d, cfg.vocab_size, f32,
             100, 10),
            ("prefill wq", n, P, d, H * hd, bf, 20, 3),
            ("prefill wk / wv", n, P, d, KH * hd, bf, 40, 3),
            ("prefill attention wo", n, P, H * hd, d, bf, 20, 3),
            ("prefill MLP wi_gate / wi_up", n, P, d, cfg.d_ff, bf, 10, 3),
            ("prefill MLP wo", n, P, cfg.d_ff, d, bf, 10, 3)):
        one = nn * K * N + nn * M * K * (2 if xdt == bf else 4)
        sets = []
        for _ in range(copies_for(one)):
            w = torch.randint(-127, 128, (nn, K, N), generator=g,
                              device=dev).to(torch.int8)
            sets.append((torch.randn(nn, M, K, generator=g,
                                     device=dev).to(xdt), w,
                         torch.rand(nn, 1, N, generator=g, device=dev)
                         * 1e-3 + 1e-4))
        x, w, sc = sets[0]
        routes0 = dict(ops.int8_matmul.routes)
        out = ops.int8_matmul(x, w, sc)
        out16 = ops.int8_matmul(x, w, sc, out_dtype=bf)
        torch.cuda.synchronize()
        took = {r for r, c in ops.int8_matmul.routes.items()
                if c != routes0[r]}
        want_route = route(M, K, N, xdt, x.data_ptr() % 16 == 0
                           and w.data_ptr() % 16 == 0)
        if took != {want_route}:
            raise SystemExit(f"[kernel] int8_matmul at [{nn},{M},{K},{N}] "
                             f"took routes {took}, not {want_route}")
        if not torch.equal(out16, out.to(bf)):
            raise SystemExit(f"[kernel] int8_matmul bf16 output at "
                             f"[{nn},{M},{K},{N}] is not the fp32 output's "
                             f"cast")
        want = ref.int8_matmul_plain(x, w, sc)
        # kernel and library as device work (a decode-row call is shorter
        # than its launch on the host, so an eager loop times the host);
        # the kernel's eager loop beside them
        k_ms = graph_ms(ops.int8_matmul, sets, iters)
        k16_ms = graph_ms(lambda a, b, c: ops.int8_matmul(a, b, c,
                                                          out_dtype=bf),
                          sets, iters)
        eager_ms = time_ms(ops.int8_matmul, sets, iters)
        p_ms = time_ms(ref.int8_matmul_plain, sets, p_iters)
        # yardstick: torch.matmul on the weight dequantized beforehand
        lib_sets = [(x, (w.float() * sc).to(xdt)) for x, w, sc in sets]
        l_ms = graph_ms(torch.matmul, lib_sets, iters)
        del lib_sets
        row = _report(
            "int8_matmul", "cuda", "src/repro_torch/kernels/csrc/int8_matmul.cu",
            "src/repro/kernels/quant_matmul.py:34", out, want, k_ms, p_ms,
            l_ms, nbytes(x, w, sc, out), 2.0 * nn * M * K * N,
            BF16_FLOP_S if xdt == bf else FP32_FLOP_S,
            tol=KERNEL_TOL if xdt == bf else FP32_KERNEL_TOL)
        # the bf16-output form moves half the output bytes
        b16 = max(nbytes(x, w, sc, out16) / HBM_BYTES_S * 1e3,
                  row["ops"] / (BF16_FLOP_S if xdt == bf else FP32_FLOP_S)
                  * 1e3)
        row.update(at=(f"{what}: x [{nn},{M},{K}] {str(xdt)[6:]}, "
                       f"w [{nn},{K},{N}] int8"), kernel_route=want_route,
                   bound_share=row["bound_ms"] / k_ms,
                   bf16_out_ms=k16_ms, bf16_out_bound_ms=b16,
                   bf16_out_bound_share=b16 / k16_ms, eager_ms=eager_ms,
                   timing="ms, bf16_out_ms and library_ms: device work "
                          "(CUDA graph replay)")
        log(f"[kernel]   int8_matmul at {row['at']}: route {want_route}; "
            f"fp32 out {k_ms:.4f} ms ({100 * row['bound_share']:.1f} % of "
            f"{row['bound_ms']:.4f}), bf16 out {k16_ms:.4f} ms "
            f"({100 * b16 / k16_ms:.1f} % of {b16:.4f}, bitwise the fp32 "
            f"cast); library {l_ms:.4f} ms; eager loop {eager_ms:.4f} ms")
        shapes.append(row)
        del sets, x, w, sc, out, out16, want
        torch.cuda.empty_cache()
    rows = [dict(shapes[0], shapes=[dict(r) for r in shapes])]

    # -- int8 paged decode: the decode step near the end of the run ----
    cap = PROMPT + NEW + 8
    nmax = -(-cap // BLOCK)
    N = SLOTS * nmax + 1
    L = PROMPT + NEW
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(3))
    table = (perm[:SLOTS * nmax].reshape(SLOTS, nmax) + 1).to(torch.int32)
    table = table.to(dev)
    lengths = torch.full((SLOTS,), L, dtype=torch.int32, device=dev)
    p2 = 1
    while p2 < -(-L // BLOCK):
        p2 *= 2
    max_len = min(nmax, p2) * BLOCK
    pool = (n, N, BLOCK, KH, hd)
    sets = []
    for _ in range(copies_for(2 * n * N * BLOCK * KH * (hd + 4))):
        k8, ks = quantize_rows(torch.randn(pool, generator=g, device=dev))
        v8, vs = quantize_rows(torch.randn(pool, generator=g, device=dev))
        sets.append((torch.randn(n, SLOTS, H, hd, generator=g,
                                 device=dev).to(bf), k8, v8, ks, vs))
    q, k8, v8, ks, vs = sets[0]

    def kern(q, k, v, ks, vs):
        return ops.paged_decode_attention(q, k, v, table, lengths,
                                          max_len=max_len, k_scale=ks,
                                          v_scale=vs)

    def plain(q, k, v, ks, vs):
        return ref.paged_decode_attention_plain(q, k, v, table, lengths,
                                                max_len=max_len, k_scale=ks,
                                                v_scale=vs)

    out, want = kern(*sets[0]), plain(*sets[0])
    p_ms = time_ms(plain, sets, 20)
    # yardstick: SDPA on K/V gathered, dequantized to bf16 and expanded
    # beforehand (untimed)
    tbl = table.long()

    def gathered(q, k, v, ks, vs):
        def one(p, sc):
            x = (p[:, tbl].float() * sc[:, tbl]).to(bf)
            x = x.reshape(n * SLOTS, nmax * BLOCK, KH, hd)[:, :L]
            return x.repeat_interleave(H // KH, 2).transpose(1, 2)
        return (q.reshape(n * SLOTS, H, 1, hd), one(k, ks).contiguous(),
                one(v, vs).contiguous())

    lib_sets = [gathered(*st) for st in sets]
    t = device_timing(kern, F.scaled_dot_product_attention, sets, lib_sets)
    del lib_sets
    live = n * SLOTS * L * KH * (hd + 4) * 2    # int8 K and V rows + scales
    rows.append(_report(
        "paged_decode_attention_int8", "cuda",
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro/kernels/decode_attention.py:187", out, want, t["ms"],
        p_ms, t["library_ms"], live + nbytes(q, table, lengths, out),
        4.0 * n * SLOTS * L * H * hd, FP32_FLOP_S))
    decode_extras(rows[-1], t, max_len, n * SLOTS * KH, BLOCK, nmax * BLOCK)
    rows[-1]["branch"] = ("int8 pools with scale pools (_paged_kernel :153, "
                          "_online_softmax_step :34)")
    del sets
    return rows


# ---------------------------------------------------------------------------
# phase 4: the reduced model in fp32, card against CPU
# ---------------------------------------------------------------------------

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def _close(name, a, b):
    err = (a.float().cpu() - b.float().cpu()).abs().max().item()
    log(f"[parity] {name}: max_abs_err {err:.3e} (tol {PARITY_TOL})")
    if not torch.allclose(a.float().cpu(), b.float().cpu(), rtol=PARITY_TOL,
                          atol=PARITY_TOL):
        raise SystemExit(f"[parity] {name}: card and CPU disagree")


def check_reduced_parity(dev: torch.device) -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.core.track import init_pt, pt_decode_step, pt_forward
    from repro_torch.serving.engine import Engine, ModelRunner
    from repro_torch.serving.sampler import SampleParams
    cfg = reduced_config(ARCH)
    cpu = torch.device("cpu")
    params = {cpu: init_pt(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (9, 16)]
    teacher = rng.integers(1, cfg.vocab_size, size=(4, 2))
    got = {}
    for d in (cpu, dev):
        toks = torch.as_tensor(np.asarray([p[:9] for p in prompts])).to(d)
        logits, cache = pt_forward(params[d], {"inputs": toks}, cfg)
        r = ModelRunner(cfg, params[d], max_slots=2, max_seq_len=32,
                        device=d)
        for s, p in enumerate(prompts):
            r.kv.allocate(s, len(p) + 4)
        first = r.prefill(prompts, 16, [0, 1], [0, 0], [0, 0],
                          [SampleParams()] * 2)
        steps = []
        pos = np.asarray([len(p) for p in prompts], np.int32)
        for t in range(teacher.shape[0]):
            lg, r.cache = pt_decode_step(
                r.params, r.cache, torch.as_tensor(teacher[t]).to(d),
                torch.as_tensor(pos + t).to(d), cfg,
                block_table=r.kv.table(), kv_max_len=32)
            steps.append(lg)
        got[d] = (logits, cache["blocks"][0], first, torch.stack(steps))
    _close("prefill logits", got[dev][0], got[cpu][0])
    _close("prefill K", got[dev][1], got[cpu][1])
    _close("teacher-forced decode logits", got[dev][3], got[cpu][3])
    if not np.array_equal(got[dev][2], got[cpu][2]):
        raise SystemExit("[parity] first greedy tokens differ")
    streams = {}
    for d in (cpu, dev):
        eng = Engine(cfg, params[d], max_slots=2, max_seq_len=48, device=d,
                     prefix_cache=False)
        streams[d] = eng.generate(prompts + [prompts[0][:5]], 8)
    log(f"[parity] greedy token streams, card vs CPU: "
        f"{'identical' if streams[dev] == streams[cpu] else 'DIFFER'} "
        f"({sum(map(len, streams[dev]))} tokens)")


def check_int8_parity(dev: torch.device) -> None:
    """Phase 4, int8 path: the reduced fp32 config with int8 weights and
    chunked prefill (chunk 8), with fp32 and with int8 KV, on the card
    against the CPU: two prompt chunks then three teacher-forced decode
    steps.  int8 weight payloads must be bitwise equal and every logit
    within 1e-4.  With int8 KV each device quantizes the K/V rows it
    computed itself, so a row element within fp32 noise of a rounding
    boundary may land one int8 step apart, and the logits after it
    legitimately differ by more than 1e-4; the script counts such
    elements and holds the logits to 1e-4 when there are none.  The int8
    decode kernel itself is held to 1e-4 on the CPU run's own pools."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.track import init_pt, pt_chunk_step, pt_decode_step
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.engine import Engine, ModelRunner
    cfg = reduced_config(ARCH)
    cpu = torch.device("cpu")
    params = {cpu: init_pt(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    knobs = dict(weight_dtype="int8", prefill_chunk=8)
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, cfg.vocab_size, size=(2, 16))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2))
    runs = {}
    for kv in (None, "int8"):
        for where, d in (("cpu", cpu), ("card", dev)):
            r = ModelRunner(cfg, params[d], max_slots=2, max_seq_len=32,
                            kv_dtype=kv, device=d, **knobs)
            for slot in range(2):
                r.kv.allocate(slot, 16 + teacher.shape[0])
            table = r.kv.table()
            lgs = []
            with torch.no_grad():
                for c in range(2):
                    lg, _ = pt_chunk_step(
                        r.params, r.cache,
                        torch.as_tensor(prompts[:, 8 * c:8 * c + 8]).to(d),
                        torch.full((2,), 8 * c, dtype=torch.int32,
                                   device=d), cfg, block_table=table)
                    lgs.append(lg)
                for t in range(teacher.shape[0]):
                    lg, _ = pt_decode_step(
                        r.params, r.cache, torch.as_tensor(teacher[t]).to(d),
                        torch.full((2,), 16 + t, dtype=torch.int32,
                                   device=d), cfg, block_table=table,
                        kv_max_len=32)
                    lgs.append(lg[:, None])
            runs[(kv, where)] = (r, torch.cat(lgs, dim=1))
    mine, theirs = runs[(None, "card")][0], runs[(None, "cpu")][0]
    for a, b in zip(_leaves(mine.params), _leaves(theirs.params)):
        if not torch.equal(a.cpu(), b):
            raise SystemExit("[parity] int8 weights: the card's "
                             "quantization differs from the CPU's")
    log(f"[parity] int8 weights: {mine.n_quantized} quantized leaves, "
        f"payloads and scales bitwise equal card vs CPU")
    _close("int8 weights, fp32 KV, chunk 8: chunk + decode logits",
           runs[(None, "card")][1], runs[(None, "cpu")][1])
    (rd, lgd), (rc, lgc) = runs[("int8", "card")], runs[("int8", "cpu")]
    steps = sum(int((a.pool.cpu() != b.pool).sum())
                for a, b in zip(rd.cache["blocks"], rc.cache["blocks"]))
    elems = sum(b.pool.numel() for b in rc.cache["blocks"])
    err = (lgd.cpu() - lgc).abs().max().item()
    log(f"[parity] int8 weights + int8 KV, chunk 8: {steps} of {elems} "
        f"K/V pool elements one int8 step apart card vs CPU; chunk + decode "
        f"logits max_abs_err {err:.3e}")
    if steps == 0:
        _close("int8 weights + int8 KV, chunk 8: chunk + decode logits",
               lgd, lgc)
    # the int8 decode kernel (fp32 q) on the CPU run's own layer-0 pools
    k_leaf, v_leaf = (leaf[0, 0] for leaf in rc.cache["blocks"])
    g = torch.Generator().manual_seed(4)
    q = torch.randn(cfg.pt.n_tracks, 2, cfg.n_heads, cfg.head_dim,
                    generator=g)
    lengths = torch.tensor([19, 17], dtype=torch.int32)
    args = (q, k_leaf.pool, v_leaf.pool, rc.kv.table(), lengths)
    scales = dict(k_scale=k_leaf.scale, v_scale=v_leaf.scale)
    want = ref.paged_decode_attention_plain(*args, max_len=32, **scales)
    got = ops.paged_decode_attention(*(a.to(dev) for a in args), max_len=32,
                                     **{k: v.to(dev)
                                        for k, v in scales.items()})
    _close("int8 paged decode kernel (fp32) on the CPU run's pools", got,
           want)
    streams = {}
    for d in (cpu, dev):
        eng = Engine(cfg, params[d], max_slots=2, max_seq_len=48, device=d,
                     kv_dtype="int8", prefix_cache=False, **knobs)
        streams[d] = eng.generate([p.tolist() for p in prompts]
                                  + [prompts[0, :5].tolist()], 8)
    log(f"[parity] greedy token streams, int8 weights + int8 KV + chunk 8, "
        f"card vs CPU: "
        f"{'identical' if streams[dev] == streams[cpu] else 'DIFFER'} "
        f"({sum(map(len, streams[dev]))} tokens)")


def check_mamba_parity(dev: torch.device) -> None:
    """Phase 4, falcon-mamba: ``reduced_config("falcon-mamba-7b")`` in
    fp32 (4 layers, d 64, d_inner 128) on the card against the same
    weights on the CPU, within 1e-4: whole-prompt prefill then three
    teacher-forced decode steps, and chunked prefill (chunk 8; the
    second row's last chunk holds 3 of 8 tokens) then the same decode
    steps, one lane frozen in the second; then the engine's greedy
    streams, whole-prompt and chunk 8, which must be identical."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder as dec
    from repro_torch.serving.engine import Engine
    cfg = reduced_config(FM_ARCH)
    cpu = torch.device("cpu")
    params = {cpu: dec.init_lm(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 13))
    lens = np.asarray([13, 11])
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2))
    got = {}
    with torch.no_grad():
        for d in (cpu, dev):
            t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
                np.asarray(a)).to(d, dt)
            logits, cache = dec.lm_forward(params[d], {"inputs": t(toks)},
                                           cfg)
            chunks, ccache = [], dec.init_cache(cfg, 2, 32, device=d)
            for start in (0, 8):
                chunk = np.zeros((2, 8), np.int64)
                chunk[:, :min(8, 13 - start)] = toks[:, start:start + 8]
                lg, _ = dec.lm_chunk_step(
                    params[d], ccache, t(chunk),
                    t(np.full(2, start), torch.int32), cfg,
                    chunk_lens=t(np.clip(lens - start, 0, 8)))
                chunks.append(lg)
            steps = {"whole": [], "chunked": []}
            for route, c in (("whole", cache), ("chunked", ccache)):
                p0 = np.full(2, 13) if route == "whole" else lens
                for k in range(teacher.shape[0]):
                    lg, _ = dec.lm_decode_step(
                        params[d], c, t(teacher[k]), t(p0 + k, torch.int32),
                        cfg, active=t([True, k != 1], torch.bool))
                    steps[route].append(lg)
            got[d] = (logits, torch.cat(chunks, 1),
                      torch.stack(steps["whole"]),
                      torch.stack(steps["chunked"]), ccache)
    _close("falcon-mamba whole-prompt prefill logits", got[dev][0],
           got[cpu][0])
    _close("falcon-mamba whole-prompt route: decode logits", got[dev][2],
           got[cpu][2])
    _close("falcon-mamba chunk-8 logits (non-aligned last chunk)",
           got[dev][1], got[cpu][1])
    _close("falcon-mamba chunked route: decode logits", got[dev][3],
           got[cpu][3])
    for a, b in zip(_leaves(got[dev][4]), _leaves(got[cpu][4])):
        _close("falcon-mamba state rows after chunks and decode", a, b)
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (13, 11, 5)]
    for knobs in ({}, {"prefill_chunk": 8}):
        streams = {d: Engine(cfg, params[d], max_slots=2, max_seq_len=48,
                             device=d, prefix_cache=False,
                             **knobs).generate(prompts, 8)
                   for d in (cpu, dev)}
        same = streams[dev] == streams[cpu]
        log(f"[parity] falcon-mamba greedy token streams {knobs or 'whole'}, "
            f"card vs CPU: {'identical' if same else 'DIFFER'} "
            f"({sum(map(len, streams[dev]))} tokens)")
        if not same:
            raise SystemExit("[parity] falcon-mamba greedy streams differ")


def check_dense_parity(dev: torch.device) -> None:
    """Phase 4, the dense baseline: ``reduced_config("dense-6b")`` in fp32
    (8 layers, d 64, 8 heads, 2 KV heads) on the card against the same
    weights on the CPU, within 1e-4: prefill logits (rows of 13 and 9
    tokens right-padded to 16); the rows into the paged cache (block 8)
    and into the contiguous cache, then three teacher-forced decode
    steps on each (the contiguous one with a lane frozen in the second
    step); chunked prefill (chunk 8, the second row's last chunk holding
    3 real tokens) into the paged cache (the contiguous cache takes no
    chunk: only the speculative drafter's would, not ported); then the
    engine's greedy streams on both caches, which must be identical card
    vs CPU and paged vs contiguous."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import PagedKVCache, insert_rows
    from repro_torch.serving.engine import Engine
    cfg = reduced_config(DENSE_ARCH)
    cpu = torch.device("cpu")
    params = {cpu: dec.init_lm(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    rng = np.random.default_rng(3)
    lens = np.asarray([13, 9])
    toks = np.zeros((2, 16), np.int64)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(1, cfg.vocab_size, size=(L,))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2))
    got = {}
    with torch.no_grad():
        for d in (cpu, dev):
            t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
                np.asarray(a)).to(d, dt)
            p = params[d]
            logits, pre = dec.lm_forward(p, {"inputs": t(toks)}, cfg)
            kv = PagedKVCache(cfg, max_slots=2, max_seq_len=32, block_size=8,
                              device=d)
            for slot in range(2):
                kv.allocate(slot, 16 + teacher.shape[0])
            kv.insert_prefill(pre, [0, 1], kv.table())
            contig = dec.init_cache(cfg, 2, 32, device=d)
            insert_rows(contig, pre, [0, 1])
            paged_steps, contig_steps = [], []
            for k in range(teacher.shape[0]):
                pos = t(lens + k, torch.int32)
                lg, _ = dec.lm_decode_step(p, kv.engine_cache(),
                                           t(teacher[k]), pos, cfg,
                                           block_table=kv.table(),
                                           kv_max_len=32)
                paged_steps.append(lg)
                lg, _ = dec.lm_decode_step(p, contig, t(teacher[k]), pos,
                                           cfg, kv_max_len=32,
                                           active=t([True, k != 1],
                                                    torch.bool))
                contig_steps.append(lg)
            ckv = PagedKVCache(cfg, max_slots=2, max_seq_len=32, block_size=8,
                               device=d)
            for slot in range(2):
                ckv.allocate(slot, 16)
            chunks = [dec.lm_chunk_step(p, ckv.engine_cache(),
                                        t(toks[:, c:c + 8]),
                                        t([c, c], torch.int32), cfg,
                                        block_table=ckv.table())[0]
                      for c in (0, 8)]
            got[d] = (logits, torch.stack(paged_steps),
                      torch.stack(contig_steps), torch.cat(chunks, 1),
                      contig)
    _close("dense prefill logits", got[dev][0], got[cpu][0])
    _close("dense paged decode logits", got[dev][1], got[cpu][1])
    _close("dense contiguous decode logits (a frozen lane)", got[dev][2],
           got[cpu][2])
    _close("dense contiguous cache after decode", got[dev][4]["unit"][0][0],
           got[cpu][4]["unit"][0][0])
    _close("dense paged chunk-8 logits (non-aligned last chunk)",
           got[dev][3], got[cpu][3])
    _close("dense paged vs contiguous decode logits, CPU", got[cpu][1][0],
           got[cpu][2][0])
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (13, 9, 5, 11)]
    streams = {}
    for d in (cpu, dev):
        for paged in (True, False):
            streams[(d, paged)] = Engine(
                cfg, params[d], max_slots=2, max_seq_len=48, device=d,
                paged=paged, prefix_cache=False).generate(prompts, 8)
    same = len({str(v) for v in streams.values()}) == 1
    log(f"[parity] dense greedy token streams, card vs CPU x paged vs "
        f"contiguous: {'identical' if same else 'DIFFER'} "
        f"({sum(map(len, streams[(dev, False)]))} tokens per run)")
    if not same:
        raise SystemExit("[parity] dense greedy streams differ")


def check_pt_contiguous_parity(dev: torch.device) -> None:
    """Phase 4, the reduced PT model on the contiguous cache, fp32, card
    against CPU (1e-4): prefill rows into [R, D, n, B, S, KH, hd], three
    teacher-forced decode steps (a lane frozen in the second; the tracks
    folded into the kernel's batch), then greedy streams, which must be
    identical card vs CPU and equal the paged engine's."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.track import (init_pt, pt_decode_step, pt_forward,
                                        pt_init_cache)
    from repro_torch.serving.cache import insert_rows
    from repro_torch.serving.engine import Engine
    cfg = reduced_config(ARCH)
    cpu = torch.device("cpu")
    params = {cpu: init_pt(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16))
    teacher = rng.integers(1, cfg.vocab_size, size=(3, 2))
    got = {}
    with torch.no_grad():
        for d in (cpu, dev):
            t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
                np.asarray(a)).to(d, dt)
            _, pre = pt_forward(params[d], {"inputs": t(toks)}, cfg)
            cache = pt_init_cache(cfg, 2, 24, device=d)
            insert_rows(cache, pre, [1, 0])
            steps = []
            for k in range(teacher.shape[0]):
                lg, _ = pt_decode_step(params[d], cache, t(teacher[k]),
                                       t([16 + k] * 2, torch.int32), cfg,
                                       kv_max_len=24,
                                       active=t([True, k != 1], torch.bool))
                steps.append(lg)
            got[d] = torch.stack(steps)
    _close("PT contiguous decode logits (a frozen lane)", got[dev], got[cpu])
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (9, 16, 5)]
    streams = {(d, paged): Engine(cfg, params[d], max_slots=2, max_seq_len=48,
                                  device=d, paged=paged,
                                  prefix_cache=False).generate(prompts, 8)
               for d in (cpu, dev) for paged in (False, True)}
    same = len({str(v) for v in streams.values()}) == 1
    log(f"[parity] PT greedy token streams, contiguous card vs CPU (and the "
        f"paged engine): {'identical' if same else 'DIFFER'} "
        f"({sum(map(len, streams[(dev, False)]))} tokens per run)")
    if not same:
        raise SystemExit("[parity] PT contiguous greedy streams differ")


def _tie_tracks(blocks) -> None:
    """Every track of every block leaf [R, D, n, ...] a copy of track 0,
    written in place (no memory added)."""
    for leaf in _leaves(blocks):
        leaf[:, :, 1:] = leaf[:, :, :1]


def check_spec_parity(dev: torch.device) -> None:
    """Phase 4, the speculative arm: the reduced PT model in fp32 with
    speculate_k=3, draft_tracks=2, card against CPU on the same weights.
    Gates: the drafter's draft-step logits (three steps on its contiguous
    cache, after its prefill) and the target's 4-token verify logits (the
    chunk program on the paged cache) within 1e-4; greedy streams
    identical on card and CPU and to the same engine's without
    speculation, with whole-prompt prefill, with ``prefill_chunk=8`` and
    with int8 weights + int8 KV; with the tracks tied (in place),
    acceptance exactly 1.0 on both."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.track import init_pt, pt_chunk_step, pt_draft_step
    from repro_torch.serving.engine import Engine, ModelRunner
    from repro_torch.serving.sampler import SampleParams
    cfg = reduced_config(ARCH)
    cpu = torch.device("cpu")
    params = {cpu: init_pt(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
               for L in (9, 16)]
    seq = rng.integers(1, cfg.vocab_size, size=(2, 4))
    got = {}
    with torch.no_grad():
        for d in (cpu, dev):
            r = ModelRunner(cfg, params[d], max_slots=2, max_seq_len=32,
                            speculate_k=3, draft_tracks=2, device=d)
            for slot, p in enumerate(prompts):
                r.kv.allocate(slot, len(p) + 4)
            r.prefill(prompts, 16, [0, 1], [0, 0], [0, 0],
                      [SampleParams()] * 2)
            r.draft_prefill(prompts, 16, [0, 1])
            pos = torch.as_tensor([len(p) for p in prompts],
                                  dtype=torch.int32).to(d)
            dl = [pt_draft_step(r.draft_params, r.draft_cache,
                                torch.as_tensor(seq[:, j]).to(d), pos + j,
                                r.draft_cfg, kv_max_len=32)[0]
                  for j in range(3)]
            vl, _ = pt_chunk_step(r.params, r.cache, torch.as_tensor(seq)
                                  .to(d), pos, cfg, block_table=r.kv.table(),
                                  kv_max_len=32)
            got[d] = (torch.stack(dl, dim=1), vl)
    _close("drafter (2 of 4 tracks) draft-step logits, 3 steps",
           got[dev][0], got[cpu][0])
    _close("4-token verify logits", got[dev][1], got[cpu][1])
    work = prompts + [prompts[0][:5]]
    for name, knobs in (("whole-prompt prefill", {}),
                        ("prefill_chunk=8", {"prefill_chunk": 8}),
                        ("int8 weights + int8 KV",
                         {"weight_dtype": "int8", "kv_dtype": "int8"})):
        out, acc = {}, {}
        for where, d in (("CPU", cpu), ("card", dev)):
            for k in (0, 3):
                eng = Engine(cfg, params[d], max_slots=2, max_seq_len=48,
                             device=d, speculate_k=k, draft_tracks=2,
                             **knobs, prefix_cache=False)
                out[(where, k)] = eng.generate(work, 8)
                acc[where] = eng.metrics.summary()["acceptance_rate"]
        same = len({str(v) for v in out.values()}) == 1
        log(f"[parity] spec K=3 d=2, {name}: greedy streams card vs CPU x "
            f"spec vs plain {'identical' if same else 'DIFFER'} "
            f"({sum(map(len, out[('card', 3)]))} tokens per run); "
            f"acceptance card {acc['card']:.4f}, CPU {acc['CPU']:.4f}")
        if not same:
            raise SystemExit(f"[parity] spec streams differ ({name}): {out}")
    for where, d in (("CPU", cpu), ("card", dev)):
        _tie_tracks(params[d]["blocks"])
        eng = Engine(cfg, params[d], max_slots=2, max_seq_len=48, device=d,
                     speculate_k=3, draft_tracks=2, prefix_cache=False)
        eng.generate(work, 8)
        rate = eng.metrics.summary()["acceptance_rate"]
        log(f"[parity] spec, tracks tied, {where}: acceptance {rate}")
        if rate != 1.0:
            raise SystemExit(f"[parity] tied tracks: acceptance {rate} != 1")


# ---------------------------------------------------------------------------
# phase 5: serve pt-6b-d4, falcon-mamba-7b and dense-6b at full width
# ---------------------------------------------------------------------------

# the kernels each serve run must go through
FP_PATH = ("paged_decode_attention", "flash_attention", "rmsnorm")
INT8_PATH = ("int8_matmul", "paged_decode_attention_int8", "rmsnorm")
INT8_ROUTES = {}      # the W8A16 launches of the int8 serve run, by route
FLASH_ROUTES = {}     # the flash launches of each bf16 serve run, by route
NORM_ROUTES = {}      # the RMSNorm launches of each serve run, by route
RANK_SUMMARY = {}     # the figures of phase 8, for the summary line


def norm_routes(kind: str, cfg, c: dict) -> dict:
    """The RMSNorm launches by route of a run of ``c["P"]`` prefill calls
    (the head on every row), ``c["C"]`` chunk calls (a bare fusion or a
    bare residual add at the end, then the head's norm on one row per
    prompt) and ``c["T"]`` decode or spec steps, from the code: a forward
    runs ``norm`` once (the first ln1), folds every residual add into the
    next norm (``add_norm``) and, in a PT model of R = L / D blocks, each
    block's end into ``fuse_norm`` (the last one with the final norm);
    the drafter's prefill and its step at pos + K skip the head, so their
    last block ends on a bare fusion.  Per forward the routes add up to
    2 L + 1 (L + 1 for Mamba), 2 L for a forward without a head; a layer
    with sandwich norms adds 2 ``norm`` launches, one with qk-norm 2 more
    (q and k), an MLA layer 1 (kv_norm) or 2 (and q_norm, at q_lora_rank
    > 0); a LayerNorm model launches none."""
    L, P, C, T = cfg.n_layers, c["P"], c.get("C", 0), c["T"]
    if cfg.norm != "rmsnorm":
        return {"norm": 0, "add_norm": 0, "fuse_norm": 0}
    if cfg.pt is None:
        A = L if kind == "falcon" else 2 * L         # adds per forward
        X = L * (2 * cfg.post_norm + 2 * cfg.qk_norm)  # per-layer norms
        if cfg.mla is not None:
            X += sum(cfg.spec(nm).mixer == "mla" for nm in cfg.layer_names
                     ) * (1 + (cfg.mla.q_lora_rank > 0))
        return {"norm": P + 2 * C + T + X * (P + C + T),
                "add_norm": A * (P + T) + (A - 1) * C, "fuse_norm": 0}
    R = L // cfg.pt.block_depth
    if kind == "spec":
        Fw = (SPEC_K + 2) * T      # the K + 1 draft steps and the verify
        return {"norm": 2 * P + Fw, "add_norm": (2 * L - R) * (2 * P + Fw),
                "fuse_norm": (2 * R - 1) * P + R * Fw - T}
    return {"norm": P + 2 * C + T, "add_norm": (2 * L - R) * (P + C + T),
            "fuse_norm": R * (P + T) + (R - 1) * C}


def check_norm_routes(tag: str, kind: str, cfg, c: dict, routes) -> None:
    """A sync serve run's RMSNorm launches by route against
    ``norm_routes``; raises when they differ."""
    want = norm_routes(kind, cfg, c)
    log(f"[serve] {tag}: RMSNorm routes {json.dumps(routes)}, arithmetic "
        f"{json.dumps(want)}: {'met' if routes == want else 'NOT MET'}")
    NORM_ROUTES[tag] = routes
    if routes != want:
        raise SystemExit(f"[serve] {tag}: RMSNorm routes {routes} != {want}")


def serve_full(dev: torch.device, card: str, int8: bool = False,
               keep: Optional[dict] = None):
    """Phase 5 (and 6): serve the cell with bf16 weights and KV, or with
    int8 weights and int8 KV.  Returns the launch counts of the measured
    run; ``keep`` (bf16 only) receives the parameters, the measured run's
    prompts and its token streams, for the speculative runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.track import init_pt
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    cfg = get_config(ARCH)
    tag = "int8 weights + int8 KV" if int8 else "bf16"
    t0 = time.perf_counter()
    params = init_pt(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
        f"{sum(nbytes(t) for t in _leaves(params)) / 1e9:.3f} GB bf16, "
        f"init {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    knobs = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, prefix_cache=False, **knobs)
    head_bf16 = params["head"]
    if int8:
        del params, head_bf16    # the engine holds its own int8 copy
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        st = eng.runner.cache_stats()
        log(f"[serve] {tag}: {st['quantized_weight_leaves']} leaves "
            f"quantized in {time.perf_counter() - t0:.1f}s; KV pool "
            f"{st['pool_bytes'] / 1e9:.3f} GB ({st['kv_dtype']})")
    # the decode step reads every weight once (the embedding table
    # included, as in slice 1's figure; the LM head as the runner holds
    # it): the least time a step can take
    read = sum(nbytes(t) for t in _leaves(eng.runner.params))
    rng = np.random.default_rng(0)
    # warm-up: cuBLAS handles and the kernels' first launches for every
    # shape class the measured run meets (prefill and decode rows)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size,
                                    size=(PROMPT,)).tolist(), NEW)
            for _ in range(SLOTS)]
    r = eng.runner
    steps0, transfers0 = eng.steps_run, r.decode_transfers
    calls0, prefills0 = r.prefill_calls + r.chunk_calls, r.prefill_calls
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = dict(ops.int8_matmul.routes)
    flash_routes = dict(ops.flash_attention.routes)
    rms_routes = dict(ops.rmsnorm.routes)
    m = eng.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)
    done = sum(rq.state is RequestState.DONE and len(rq.output) == NEW
               for rq in reqs)
    decodes = r.decode_transfers - transfers0
    prefills = r.prefill_calls - prefills0
    forwards = r.prefill_calls + r.chunk_calls - calls0 + decodes
    log(f"[serve] {card} | {tag}: {SLOTS} reqs x ({PROMPT} in / {NEW} out), "
        f"slots {SLOTS}, block {BLOCK}, {eng.steps_run - steps0} steps, "
        f"wall {wall:.3f}s")
    log(f"[serve] {card} | {tag}: TTFT ms p50 {m['ttft_ms']['p50']:.2f} "
        f"p90 {m['ttft_ms']['p90']:.2f}; TPOT ms p50 "
        f"{m['tpot_ms']['p50']:.3f} p90 {m['tpot_ms']['p90']:.3f}; "
        f"throughput {m['throughput_tok_s']:.1f} tok/s")
    log(f"[serve] {tag}: weight-read bound of a decode step "
        f"{read / HBM_BYTES_S * 1e3:.3f} ms ({read / 1e9:.3f} GB at 3.35 TB/s)"
        f"; peak memory {peak / 1e9:.3f} GB")
    log(f"[serve] {tag}: kernel launches: {json.dumps(launches)}; "
        f"forwards {forwards} (prefill/chunk calls "
        f"{forwards - decodes}, decode steps {decodes}); finished "
        f"{done}/{len(reqs)}")
    if not int8:
        head_choice_ms(eng, head_bf16, dev)
    if done != len(reqs):
        raise SystemExit("[serve] not every request finished")
    check_norm_routes(tag, "int8" if int8 else "bf16", cfg,
                      {"P": prefills, "C": forwards - decodes - prefills,
                       "T": decodes}, rms_routes)
    path = INT8_PATH if int8 else FP_PATH
    if not all(launches[k] for k in path):
        raise SystemExit(f"[serve] a kernel of the {tag} path never ran: "
                         f"{launches}")
    if not int8:
        # one flash launch per layer per prefill call (all tracks in one)
        want = cfg.n_layers * prefills
        log(f"[serve] {tag}: flash_attention {launches['flash_attention']} "
            f"launches in {prefills} prefill calls, {cfg.n_layers} layers: "
            f"{'met' if launches['flash_attention'] == want else 'NOT MET'}")
        if launches["flash_attention"] != want or not prefills:
            raise SystemExit(f"[serve] flash_attention launches "
                             f"{launches['flash_attention']} != {want}")
        check_flash_routes(tag, launches, flash_routes)
    if int8:
        # every projection (7 per layer) and the LM head through the W8A16
        # kernel in every forward; the int8 decode kernel in every layer
        # of every decode step; no fp attention kernel anywhere
        want = {"int8_matmul": forwards * (7 * cfg.n_layers + 1),
                "paged_decode_attention_int8": decodes * cfg.n_layers,
                "paged_decode_attention": 0, "flash_attention": 0,
                "decode_attention": 0}
        got = {k: launches[k] for k in want}
        log(f"[serve] {tag}: launch arithmetic {json.dumps(want)}: "
            f"{'met' if got == want else 'NOT MET'}")
        if got != want:
            raise SystemExit(f"[serve] launch counts {got} != {want}")
        # every prefill / chunk product on the wgmma route, every decode
        # product (M = SLOTS rows) on the bf16 decode route, every LM head
        # (fp32 x, SLOTS rows) on the fp32 decode-row route
        want = dict.fromkeys(routes, 0)
        want.update(wgmma_tma=(forwards - decodes) * 7 * cfg.n_layers,
                    mma_m16=decodes * 7 * cfg.n_layers, fma_rows=forwards)
        log(f"[serve] {tag}: W8A16 routes {json.dumps(routes)}: "
            f"{'met' if routes == want else 'NOT MET'}")
        if routes != want:
            raise SystemExit(f"[serve] W8A16 routes {routes} != {want}")
        INT8_ROUTES.update(routes)
    profile_steps(eng, cfg.vocab_size, rng, m["tpot_ms"]["p50"], tag)
    if keep is not None:
        keep.update(params=params, prompts=[rq.prompt for rq in reqs],
                    streams=[rq.output for rq in reqs], m=m)
    sync = {"m": m, "peak": peak, "streams": [rq.output for rq in reqs]}
    del eng, r
    gc.collect()
    torch.cuda.empty_cache()
    serve_planned(dev, card, tag, "int8" if int8 else "bf16", cfg,
                  (lambda: init_pt(torch.Generator(device=dev).manual_seed(0),
                                   cfg, dev)) if int8 else params, knobs,
                  [rq.prompt for rq in reqs], sync)
    return launches


SCAN_ROUTES = {}   # tag -> the ssm_scan launches by route of a serve run


def scan_route_counts(route: str, launches) -> dict:
    """The scan's route counts of a run whose every ``ssm_scan`` launch
    takes ``route`` (falcon-mamba: ``selective``; recurrentgemma's
    RG-LRU: ``scan``; a model without a recurrence: none at all)."""
    from repro_torch.kernels.ssm_scan import ROUTES
    return dict(dict.fromkeys(ROUTES, 0), **{route: launches["ssm_scan"]})


def check_flash_routes(tag: str, launches, routes) -> None:
    """Every flash launch of a bf16 serve run on the wgmma + TMA route."""
    want = dict.fromkeys(routes, 0)
    want["wgmma_tma"] = launches["flash_attention"]
    log(f"[serve] {tag}: flash_attention routes {json.dumps(routes)}: "
        f"{'met' if routes == want else 'NOT MET'}")
    if routes != want:
        raise SystemExit(f"[serve] flash_attention routes {routes} != {want}")
    FLASH_ROUTES[tag] = routes


def profile_steps(eng, vocab: int, rng, tpot_ms: float, tag: str,
                  chunk_steps: int = 0) -> Optional[float]:
    """Where the time goes: device time by kernel (torch.profiler, CUPTI)
    over the step that admits SLOTS prompts and over three decode steps,
    beside the decode step's unprofiled time (TPOT).  With chunked
    prefill the admission step runs the first chunk, and the other
    ``chunk_steps - 1`` chunk steps run unprofiled before the decode
    steps.  Returns the admission step's device busy ms (None where the
    profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(SLOTS):
        eng.submit(rng.integers(1, vocab, size=(PROMPT,)).tolist(), 5)
    first = ("admission step (first prompt chunk)" if chunk_steps else
             "admission step (prefill + first decode)")
    admission = None
    for what, n in ((first, 1), ("decode step", 3)):
        if what == "decode step":
            for _ in range(max(0, chunk_steps - 1)):
                eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
        # device-side events only: an aten op's row repeats the device
        # time of the kernels it launched, which have rows of their own
        rows = sorted(((e.self_device_time_total / n / 1e3, e.count / n,
                        e.key) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        if not rows:
            log(f"[profile] {tag} {what}: the profiler saw no device time "
                "(busy / idle share not measured)")
            continue
        busy = sum(r[0] for r in rows)
        if what == first:
            admission = busy
        log(f"[profile] {tag} {what}: device busy {busy:.3f} ms in "
            f"{sum(r[1] for r in rows):.0f} kernels and copies per step")
        if what == "decode step":
            log(f"[profile] {tag} decode step: busy {busy:.3f} ms of TPOT p50 "
                f"{tpot_ms:.3f} ms unprofiled ({100 * busy / tpot_ms:.1f} % "
                f"busy, {100 - 100 * busy / tpot_ms:.1f} % idle)")
        # the top eight, and flash prefill wherever it ranks
        for ms, count, key in rows[:8] + [r for r in rows[8:]
                                          if "flash_attention" in r[2]]:
            log(f"[profile]   {ms:9.3f} ms {count:6.0f}x  {key[:90]}")
    return admission


def _divergence(a, b) -> int:
    """First index where two token streams differ (-1: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def serve_spec(dev: torch.device, card: str, params, prompts, plain,
               tag: str, tied: bool):
    """Phase 5 (and 6), a speculative run of the pt-6b-d4 cell: bf16,
    speculate_k=SPEC_K, draft_tracks=SPEC_TRACKS, the plain bf16 run's 8
    prompts, each stream compared with ``plain`` (reported, not gated:
    the verify, the reference's chunk program, rounds its probabilities
    to bf16 before P V, as flash prefill does, where the split-KV decode
    kernel keeps them in fp32, so a near-tie can flip a token;
    ``check_spec_logits`` gates how far apart the programs' logits lie).

    Launch arithmetic, from the code, with L = 32 layers, K = SPEC_K, P
    admission (prefill) calls and T speculative steps (= the step's one
    host transfer each):
      flash_attention  2 L P: the target's prefill and the drafter's
                       batched prefill, one launch per layer each;
      decode_attention L (K + 1) T: the drafter's K draft steps and the
                       one at pos + K, one launch per layer each (its d
                       tracks folded into the kernel's batch);
      rmsnorm          (4 L + 1) P + ((K + 2)(2 L + 1) - 1) T: 2 L + 1
                       per forward (ln1, ln2, the final norm), except the
                       drafter's prefill and its step at pos + K, which
                       skip the head and so the final norm;
      paged_decode_attention, its int8 branch, decode_attention_int8,
      int8_matmul, ssm_scan: 0 (the verify is the chunk program).
    Gates: every request finishes with NEW tokens, acceptance in [0, 1]
    and, with the tracks ``tied``, above 0 (with independent random
    tracks the drafter's argmax over 100352 tokens need never meet the
    target's: 0 of ~1900 proposals on an H100), one host transfer per
    engine step, the arithmetic above.  Returns (launch counts,
    acceptance rate)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    cfg = get_config(ARCH)
    K = SPEC_K
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, speculate_k=K,
                 draft_tracks=SPEC_TRACKS, prefix_cache=False)
    r = eng.runner
    draft_bytes = sum(nbytes(t) for t in _leaves(r.draft_params["blocks"]))
    log(f"[serve] {tag}: drafter {r.draft_tracks} of {cfg.pt.n_tracks} "
        f"tracks, {draft_bytes / 1e9:.3f} GB of block parameters as views of "
        f"the target's (no copy), contiguous cache "
        f"{sum(nbytes(t) for t in r.draft_cache['blocks']) / 1e9:.3f} GB")
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)               # warm-up
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    steps0, transfers0, prefills0 = (eng.steps_run, r.decode_transfers,
                                     r.prefill_calls)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    m = eng.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)
    done = sum(rq.state is RequestState.DONE and len(rq.output) == NEW
               for rq in reqs)
    steps = eng.steps_run - steps0
    T = r.decode_transfers - transfers0
    P = r.prefill_calls - prefills0
    rms_routes = dict(ops.rmsnorm.routes)
    div = [_divergence(rq.output, p) for rq, p in zip(reqs, plain)]
    log(f"[serve] {card} | {tag}: {SLOTS} reqs x ({PROMPT} in / {NEW} out), "
        f"slots {SLOTS}, block {BLOCK}, K {K}, {steps} steps, wall "
        f"{wall:.3f}s")
    log(f"[serve] {card} | {tag}: TTFT ms p50 {m['ttft_ms']['p50']:.2f} "
        f"p90 {m['ttft_ms']['p90']:.2f}; TPOT ms p50 "
        f"{m['tpot_ms']['p50']:.3f} p90 {m['tpot_ms']['p90']:.3f}; "
        f"throughput {m['throughput_tok_s']:.1f} tok/s; peak memory "
        f"{peak / 1e9:.3f} GB")
    log(f"[serve] {tag}: acceptance rate {m['acceptance_rate']:.4f} (EMA "
        f"{m['acceptance_ema']:.4f}), spec steps {m['spec_steps']}, tokens "
        f"per slot per spec step {m['tokens_per_slot_step']:.3f}; streams "
        f"equal to the plain bf16 run's: {div.count(-1)}/{len(div)} (first "
        f"divergence per request: {div})")
    L = cfg.n_layers
    want = {"flash_attention": 2 * L * P, "decode_attention": L * (K + 1) * T,
            "rmsnorm": (4 * L + 1) * P + ((K + 2) * (2 * L + 1) - 1) * T,
            "paged_decode_attention": 0, "paged_decode_attention_int8": 0,
            "decode_attention_int8": 0, "int8_matmul": 0, "ssm_scan": 0}
    got = {k: launches[k] for k in want}
    log(f"[serve] {tag}: kernel launches {json.dumps(launches)}; prefill "
        f"calls {P}, spec steps (host transfers) {T} in {steps} engine "
        f"steps; launch arithmetic {json.dumps(want)}: "
        f"{'met' if got == want else 'NOT MET'}; finished {done}/{len(reqs)}")
    if done != len(reqs):
        raise SystemExit(f"[serve] not every {tag} request finished")
    lo_ok = m["acceptance_rate"] > 0.0 if tied else \
        m["acceptance_rate"] >= 0.0
    if not (lo_ok and m["acceptance_rate"] <= 1.0):
        raise SystemExit(f"[serve] {tag}: acceptance rate "
                         f"{m['acceptance_rate']} not in "
                         f"{'(0, 1]' if tied else '[0, 1]'}")
    if T != steps:
        raise SystemExit(f"[serve] {tag}: {T} host transfers in {steps} "
                         "engine steps")
    if got != want or not P or not T:
        raise SystemExit(f"[serve] launch counts {got} != {want}")
    check_norm_routes(tag, "spec", cfg, {"P": P, "T": T}, rms_routes)
    check_flash_routes(tag, launches, dict(ops.flash_attention.routes))
    check_spec_logits(eng, prompts, plain, [rq.output for rq in reqs], tag,
                      tied)
    profile_spec_step(eng, cfg.vocab_size, rng, tag)
    sync = {"m": m, "peak": peak, "streams": [rq.output for rq in reqs]}
    del eng, r
    gc.collect()
    torch.cuda.empty_cache()
    serve_planned(dev, card, tag, "spec", cfg, params,
                  dict(speculate_k=K, draft_tracks=SPEC_TRACKS), prompts,
                  sync)
    return launches, m["acceptance_rate"]


def check_spec_logits(eng, prompts, plain, spec, tag: str,
                      tied: bool) -> None:
    """Phase 5, after a speculative run: the target's logits teacher-
    forced along the plain run's streams (their first T = 60 tokens, 12
    verify calls of K + 1), at full width on the same weights, by four
    programs: plain decode (the paged split-KV kernel, one token a step:
    a replay of the plain run), the verify (the chunk program along the
    all-accepted chain, fp32 softmax over the bf16 K/V it wrote), the
    drafter's decode steps (with ``tied`` tracks the target model) and
    the whole-sequence prefill (flash).  Reports each program's mean and
    max |logits - decode's| beside decode's logit std, its argmax
    agreement with decode, and, at each request's first divergence in
    the speculative run, decode's top-1 / top-2 gap and the two tokens'
    logit gaps under decode and under the verify.
    Gates: the verify's mean |difference| from decode is at most twice
    the prefill's, or the bf16 kernel tolerance (2e-2) times decode's
    logit std where that is larger (the prefill is the model's own
    program over the same tokens, and rounds the probabilities to bf16
    before P V as the verify does: a fault of cut, position or cache
    state puts the difference at the scale of the logits, bf16
    arithmetic at the prefill's scale), and with ``tied`` tracks the
    drafter's too; and at every first divergence inside the window the
    plain token leads the speculative one under decode by at most twice
    the max |verify - decode| at that position (a near-tie that the two
    programs' bf16 arithmetic can flip)."""
    from repro_torch.core.track import pt_draft_step
    from repro_torch.serving.sampler import SampleParams
    r, cfg, K = eng.runner, eng.runner.cfg, eng.runner.speculate_k
    n, T, dev = len(prompts), (NEW - 1) // (K + 1) * (K + 1), r.device
    slots = list(range(n))
    for s_ in slots:
        r.kv.allocate(s_, PROMPT + NEW)
    active = np.ones((n,), bool)
    act_d = torch.ones((n,), dtype=torch.bool, device=dev)
    pos = np.full((n,), PROMPT, np.int32)
    pos_d = torch.as_tensor(pos, device=dev)
    toks = torch.as_tensor([p[:T] for p in plain], dtype=torch.int32,
                           device=dev)                          # [n, T]
    with torch.no_grad():
        bucket = r.bucket_for(PROMPT)
        first = r.prefill(prompts, bucket, slots, [0] * n, [0] * n,
                          [SampleParams()] * n)
        r.draft_prefill(prompts, bucket, slots)
        ver = torch.cat([r.fns["chunk"](
            r.params, r.cache, toks[:, c:c + K + 1], pos_d + c, cfg,
            block_table=r._masked_table(active),
            kv_max_len=r._live_max_len(pos + c, active, extra=K))[0].float()
            for c in range(0, T, K + 1)], dim=1)                # [n, T, V]
        dec, drf = [], []
        for i in range(T):
            dec.append(r.fns["decode"](
                r.params, r.cache, toks[:, i].long(), pos_d + i, cfg,
                block_table=r._masked_table(active),
                kv_max_len=r._live_max_len(pos + i, active),
                active=act_d)[0].float())
            drf.append(pt_draft_step(
                r.draft_params, r.draft_cache, toks[:, i], pos_d + i,
                r.draft_cfg, active=act_d,
                kv_max_len=r._live_max_len(pos + i, active, extra=K,
                                           paged=False))[0].float())
        dec, drf = torch.stack(dec, dim=1), torch.stack(drf, dim=1)
        seq = torch.cat([torch.as_tensor(prompts, device=dev),
                         toks.long()], dim=1)
        pre = r.fns["forward"](r.params, {"inputs": seq}, cfg,
                               mode="prefill")[0][:, PROMPT:PROMPT + T]
        pre = pre.float()
    for s_ in slots:
        r.kv.free_slot(s_)
    a_dec = dec.argmax(-1)
    want = torch.as_tensor([p[1:T + 1] for p in plain], device=dev)
    replay = int((a_dec == want).sum()) + int(
        (torch.as_tensor(first) == torch.as_tensor([p[0] for p in plain]))
        .sum())
    stat = {}
    for name, x in (("verify", ver), ("drafter", drf), ("prefill", pre)):
        diff = (x - dec).abs()
        stat[name] = (diff.mean().item(), diff.max().item(),
                      int((x.argmax(-1) == a_dec).sum()))
    top2 = dec.topk(2, dim=-1).values
    gap12 = (top2[..., 0] - top2[..., 1]).flatten()
    log(f"[serve] {tag}: logits teacher-forced along the plain streams "
        f"({n} x {T} positions): decode replays the plain run at "
        f"{replay}/{n * (T + 1)} tokens; decode logit std "
        f"{dec.std().item():.4f}, top-1 - top-2 gap median "
        f"{gap12.median().item():.4f}, min {gap12.min().item():.3e}")
    for name, (mean, mx, agree) in stat.items():
        log(f"[serve] {tag}:   {name} vs decode: mean |diff| {mean:.4e}, "
            f"max {mx:.4e}, argmax equal {agree}/{n * T}")
    bad = []
    for b, (sp, pl) in enumerate(zip(spec, plain)):
        i = _divergence(sp, pl)
        if i < 1 or i > T or i >= min(len(sp), len(pl)):
            log(f"[serve] {tag}:   request {b}: first divergence {i} "
                f"(-1: none; the window is 1-{T})")
            continue
        t_pl, t_sp, j = pl[i], sp[i], i - 1
        g_dec = (dec[b, j, t_pl] - dec[b, j, t_sp]).item()
        g_ver = (ver[b, j, t_sp] - ver[b, j, t_pl]).item()
        dmax = (ver[b, j] - dec[b, j]).abs().max().item()
        log(f"[serve] {tag}:   request {b}: diverges at {i} (plain {t_pl}, "
            f"spec {t_sp}): decode gap plain - spec {g_dec:.4e} (its top-1 "
            f"- top-2 {(top2[b, j, 0] - top2[b, j, 1]).item():.4e}), "
            f"verify gap spec - plain {g_ver:.4e}, verify argmax "
            f"{int(ver[b, j].argmax())}; max |verify - decode| there "
            f"{dmax:.4e}")
        if g_dec > 2 * dmax:
            bad.append(b)
    # the bf16 kernel tolerance, relative to the logits' spread, as a
    # floor where the prefill's arithmetic coincides with decode's
    limit = max(2 * stat["prefill"][0], KERNEL_TOL * dec.std().item())
    gates = {"verify": stat["verify"][0] <= limit}
    if tied:
        gates["drafter"] = stat["drafter"][0] <= limit
    gates["near-ties"] = not bad
    log(f"[serve] {tag}: logit gates {json.dumps(gates)}")
    if not all(gates.values()):
        raise SystemExit(f"[serve] {tag}: logit gates {gates} (requests "
                         f"whose divergence is no near-tie: {bad})")


def profile_spec_step(eng, vocab: int, rng, tag: str) -> None:
    """Phase 6 for a speculative run: one admission of SLOTS prompts, then
    three engine steps timed unprofiled (wall, synchronized) and three
    profiled.  Device busy time per step, split between the K + 1 draft
    forwards and the verify (each wrapped in a ``record_function`` range
    for the profiled steps only, whose kernels' device time it sums), the
    device-op count, and the busy share against the unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving import engine as engine_mod
    for _ in range(SLOTS):
        eng.submit(rng.integers(1, vocab, size=(PROMPT,)).tolist(), NEW)
    eng.step()                                 # admission + first spec step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    r = eng.runner
    draft_fn, fns = engine_mod.pt_draft_step, r.fns

    def draft(*a, **k):
        with record_function("spec: draft forward"):
            return draft_fn(*a, **k)

    def verify(*a, **k):
        with record_function("spec: verify"):
            return fns["chunk"](*a, **k)

    engine_mod.pt_draft_step = draft
    r.fns = dict(fns, chunk=verify)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
    finally:
        engine_mod.pt_draft_step, r.fns = draft_fn, fns
    avg = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 3 / 1e3, e.count / 3, e.key)
                   for e in avg if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("spec: ")), reverse=True)
    if not rows:
        log(f"[profile] {tag} spec step: the profiler saw no device time "
            "(busy / idle share not measured)")
        return
    busy = sum(x[0] for x in rows)
    split = {e.key: e.device_time_total / 3 / 1e3 for e in avg
             if e.key.startswith("spec: ") and e.device_type == DeviceType.CPU}
    log(f"[profile] {tag} spec step: device busy {busy:.3f} ms in "
        f"{sum(x[1] for x in rows):.0f} kernels and copies per step; "
        f"K + 1 draft forwards {split.get('spec: draft forward', 0.0):.3f} "
        f"ms, verify {split.get('spec: verify', 0.0):.3f} ms (the rest: "
        f"embedding, accept, host copies); unprofiled step {step_ms:.3f} ms "
        f"({100 * busy / step_ms:.1f} % busy, "
        f"{100 - 100 * busy / step_ms:.1f} % idle)")
    for ms, count, key in rows[:8]:
        log(f"[profile]   {ms:9.3f} ms {count:6.0f}x  {key[:90]}")


FALCON = {}        # the figures of phase 5's falcon-mamba run, for the JSON


def serve_falcon(dev: torch.device, card: str):
    """Phase 5 (and 6) for falcon-mamba-7b: full width and depth, bf16,
    8 greedy requests of 512 prompt tokens and 64 new tokens, 8 slots,
    block 16, chunked prefill of 256 tokens (two chunk calls per prompt,
    the reference's Pallas scan route).  The launch counts must be
    ``ssm_scan`` 64 per chunk call, ``rmsnorm`` 65 per forward (64 ln1 +
    the final norm) and no attention kernel.  Returns the launch counts
    of the measured run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.decoder import init_lm
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    cfg = get_config(FM_ARCH)
    tag = "falcon-mamba bf16"
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    n_bf16 = sum(nbytes(t) for t in leaves if t.dtype == torch.bfloat16)
    n_fp32 = sum(nbytes(t) for t in leaves if t.dtype == torch.float32)
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
        f"{n_bf16 / 1e9:.3f} GB bf16 + {n_fp32 / 1e9:.3f} GB fp32, init "
        f"{time.perf_counter() - t0:.1f}s")
    eng = Engine(cfg, params, max_slots=FM_SLOTS,
                 max_seq_len=PROMPT + NEW + 8, block_size=BLOCK,
                 prefill_chunk=FM_CHUNK, device=dev, prefix_cache=False)
    del params, leaves
    r = eng.runner
    st = r.cache_stats()
    log(f"[serve] {tag}: cache leaves {st['leaf_kinds']}, pool "
        f"{st['pool_bytes']} B, state rows {st['state_bytes'] / 1e6:.1f} MB "
        f"({st['state_bytes'] / FM_SLOTS / 1e6:.2f} MB per slot), "
        f"{st['num_blocks']} virtual blocks")
    read = sum(nbytes(t) for t in _leaves(r.params))
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(FM_SLOTS)], 3)            # warm-up
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size,
                                    size=(PROMPT,)).tolist(), NEW)
            for _ in range(FM_SLOTS)]
    steps0, transfers0, chunks0 = (eng.steps_run, r.decode_transfers,
                                   r.chunk_calls)
    prefills0 = r.prefill_calls
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    rms_routes = dict(ops.rmsnorm.routes)
    scan_routes = dict(ops.ssm_scan.routes)
    m = eng.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)
    done = sum(rq.state is RequestState.DONE and len(rq.output) == NEW
               for rq in reqs)
    decodes = r.decode_transfers - transfers0
    chunks = r.chunk_calls - chunks0
    log(f"[serve] {card} | {tag}: {FM_SLOTS} reqs x ({PROMPT} in / {NEW} "
        f"out), slots {FM_SLOTS}, block {BLOCK}, chunk {FM_CHUNK}, "
        f"{eng.steps_run - steps0} steps, wall {wall:.3f}s")
    log(f"[serve] {card} | {tag}: TTFT ms p50 {m['ttft_ms']['p50']:.2f} "
        f"p90 {m['ttft_ms']['p90']:.2f}; TPOT ms p50 "
        f"{m['tpot_ms']['p50']:.3f} p90 {m['tpot_ms']['p90']:.3f}; "
        f"throughput {m['throughput_tok_s']:.1f} tok/s")
    log(f"[serve] {tag}: weight-read bound of a decode step "
        f"{read / HBM_BYTES_S * 1e3:.3f} ms ({read / 1e9:.3f} GB at 3.35 TB/s, "
        f"the fp32 LM-head copy included); peak memory {peak / 1e9:.3f} GB")
    want = {"ssm_scan": cfg.n_layers * chunks,
            "rmsnorm": (cfg.n_layers + 1) * (chunks + decodes),
            "flash_attention": 0, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0, "int8_matmul": 0,
            "decode_attention": 0, "decode_attention_int8": 0}
    got = {k: launches[k] for k in want}
    log(f"[serve] {tag}: kernel launches {json.dumps(launches)}; chunk calls "
        f"{chunks}, decode steps {decodes}; launch arithmetic "
        f"{json.dumps(want)}: {'met' if got == want else 'NOT MET'}; "
        f"finished {done}/{len(reqs)}")
    if done != len(reqs):
        raise SystemExit("[serve] not every falcon-mamba request finished")
    if got != want or not chunks:
        raise SystemExit(f"[serve] launch counts {got} != {want}")
    want_scan = scan_route_counts("selective", launches)
    log(f"[serve] {tag}: ssm_scan routes {json.dumps(scan_routes)}: "
        f"{'met' if scan_routes == want_scan else 'NOT MET'} (every launch "
        f"on the selective route)")
    if scan_routes != want_scan:
        raise SystemExit(f"[serve] ssm_scan routes {scan_routes} != "
                         f"{want_scan}")
    SCAN_ROUTES[tag] = scan_routes
    check_norm_routes(tag, "falcon", cfg,
                      {"P": r.prefill_calls - prefills0, "C": chunks,
                       "T": decodes}, rms_routes)
    FALCON.update(ttft_ms=m["ttft_ms"], tpot_ms=m["tpot_ms"],
                  peak_gb=peak / 1e9, chunk_calls=chunks,
                  scan_routes=scan_routes)
    FALCON["admission_busy_ms"] = profile_steps(
        eng, cfg.vocab_size, rng, m["tpot_ms"]["p50"], tag,
        chunk_steps=-(-PROMPT // FM_CHUNK))
    sync = {"m": m, "peak": peak, "streams": [rq.output for rq in reqs]}
    del eng, r
    gc.collect()
    torch.cuda.empty_cache()
    serve_planned(dev, card, tag, "falcon", cfg,
                  lambda: init_lm(torch.Generator(device=dev).manual_seed(0),
                                  cfg, dev), {"prefill_chunk": FM_CHUNK},
                  [rq.prompt for rq in reqs], sync)
    return launches


def serve_dense(dev: torch.device, card: str, params, paged: bool):
    """Phase 5 (and 6) for the dense baseline dense-6b: full width and
    depth, bf16, 8 greedy requests of 512 prompt tokens and 64 new
    tokens, 8 slots, on the paged cache (block 16) or the contiguous
    cache.  The launch counts must be ``flash_attention`` 32 per prefill
    call, ``rmsnorm`` 65 per forward, and 32 per decode step of the
    cache's decode kernel (``paged_decode_attention`` or
    ``decode_attention``), the other one never.  Returns the launch
    counts of the measured run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    cfg = get_config(DENSE_ARCH)
    tag = f"dense-6b bf16 {'paged' if paged else 'contiguous'}"
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, paged=paged, device=dev, prefix_cache=False)
    r = eng.runner
    kv_bytes = (r.kv.pool_bytes() if paged
                else sum(nbytes(t) for t in _leaves(r.cache)))
    log(f"[serve] {tag}: KV cache {kv_bytes / 1e9:.3f} GB "
        f"({r.cache_stats()['mode']})")
    read = sum(nbytes(t) for t in _leaves(r.params))
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)               # warm-up
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size,
                                    size=(PROMPT,)).tolist(), NEW)
            for _ in range(SLOTS)]
    steps0, transfers0, prefills0 = (eng.steps_run, r.decode_transfers,
                                     r.prefill_calls)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    rms_routes = dict(ops.rmsnorm.routes)
    m = eng.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)
    done = sum(rq.state is RequestState.DONE and len(rq.output) == NEW
               for rq in reqs)
    decodes = r.decode_transfers - transfers0
    prefills = r.prefill_calls - prefills0
    log(f"[serve] {card} | {tag}: {SLOTS} reqs x ({PROMPT} in / {NEW} out), "
        f"slots {SLOTS}{f', block {BLOCK}' if paged else ''}, "
        f"{eng.steps_run - steps0} steps, wall {wall:.3f}s")
    log(f"[serve] {card} | {tag}: TTFT ms p50 {m['ttft_ms']['p50']:.2f} "
        f"p90 {m['ttft_ms']['p90']:.2f}; TPOT ms p50 "
        f"{m['tpot_ms']['p50']:.3f} p90 {m['tpot_ms']['p90']:.3f}; "
        f"throughput {m['throughput_tok_s']:.1f} tok/s")
    log(f"[serve] {tag}: weight-read bound of a decode step "
        f"{read / HBM_BYTES_S * 1e3:.3f} ms ({read / 1e9:.3f} GB at 3.35 TB/s, "
        f"the fp32 LM-head copy included); peak memory {peak / 1e9:.3f} GB")
    mine, other = (("paged_decode_attention", "decode_attention") if paged
                   else ("decode_attention", "paged_decode_attention"))
    L = cfg.n_layers
    want = {"flash_attention": L * prefills,
            "rmsnorm": (2 * L + 1) * (prefills + decodes),
            mine: L * decodes, other: 0, "paged_decode_attention_int8": 0,
            "decode_attention_int8": 0, "int8_matmul": 0, "ssm_scan": 0}
    got = {k: launches[k] for k in want}
    log(f"[serve] {tag}: kernel launches {json.dumps(launches)}; prefill "
        f"calls {prefills}, decode steps {decodes}; launch arithmetic "
        f"{json.dumps(want)}: {'met' if got == want else 'NOT MET'}; "
        f"finished {done}/{len(reqs)}")
    if done != len(reqs):
        raise SystemExit(f"[serve] not every {tag} request finished")
    if got != want or not decodes or not prefills:
        raise SystemExit(f"[serve] launch counts {got} != {want}")
    check_norm_routes(tag, "dense", cfg, {"P": prefills, "T": decodes},
                      rms_routes)
    check_flash_routes(tag, launches, dict(ops.flash_attention.routes))
    profile_steps(eng, cfg.vocab_size, rng, m["tpot_ms"]["p50"], tag)
    sync = {"m": m, "peak": peak, "streams": [rq.output for rq in reqs]}
    del eng, r
    gc.collect()
    torch.cuda.empty_cache()
    serve_planned(dev, card, tag, "dense paged" if paged else "dense",
                  cfg, params, {"paged": paged}, [rq.prompt for rq in reqs],
                  sync)
    return launches


# ---------------------------------------------------------------------------
# phase 5 (and 6), pipelined and preplanned: each sync run's prompts again
# through Engine(pipeline_depth=1, preplan=True)
# ---------------------------------------------------------------------------

def _arith(kind: str, cfg, c: dict):
    """The launch (and route) counts the sync run's arithmetic gives for
    a run of ``c["P"]`` prefill calls, ``c["C"]`` chunk calls and
    ``c["T"]`` decode or spec steps (host transfers): (launches, W8A16
    routes or None)."""
    L, P, C, T = cfg.n_layers, c["P"], c["C"], c["T"]
    zero = {"flash_attention": 0, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0, "int8_matmul": 0,
            "decode_attention": 0, "decode_attention_int8": 0,
            "ssm_scan": 0}
    if kind == "bf16":
        return dict(zero, flash_attention=L * P,
                    paged_decode_attention=L * T,
                    rmsnorm=(2 * L + 1) * (P + T)), None
    if kind == "int8":
        fwd = P + C + T
        want = dict(zero, int8_matmul=fwd * (7 * L + 1),
                    paged_decode_attention_int8=L * T)
        del want["ssm_scan"], want["decode_attention_int8"]
        return want, {"wgmma_tma": (fwd - T) * 7 * L, "mma_m16": T * 7 * L,
                      "fma_rows": fwd}
    if kind == "spec":
        K = SPEC_K
        return dict(zero, flash_attention=2 * L * P,
                    decode_attention=L * (K + 1) * T,
                    rmsnorm=(4 * L + 1) * P + ((K + 2) * (2 * L + 1) - 1)
                    * T), None
    if kind == "falcon":
        return dict(zero, ssm_scan=L * C, rmsnorm=(L + 1) * (C + T)), None
    mine = "paged_decode_attention" if kind == "dense paged" else \
        "decode_attention"
    return dict(zero, flash_attention=L * P, rmsnorm=(2 * L + 1) * (P + T),
                **{mine: L * T}), None


def _cache_tensors(r):
    """Every tensor of the runner's cache (pools with their scales,
    state rows, contiguous rows) and of the drafter's."""
    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from walk(v)
        elif isinstance(tree, tuple):
            for v in tree:
                yield from walk(v)
        elif hasattr(tree, "pool"):
            yield from (t for t in (tree.pool, tree.scale) if t is not None)
        else:
            yield tree

    return list(walk(r.cache)) + (list(r.draft_cache["blocks"])
                                  if r.speculate_k else [])


def check_replay(eng, prompts, tag: str, submit_kws=None) -> bool:
    """One decode (or spec) step replayed from its CUDA graph against the
    same step run eagerly, from the same cache bytes and inputs: the
    logits (the verify's, for a spec step), the packed result and every
    cache byte afterwards must be bitwise equal.  The step is taken with
    SLOTS fresh requests decoding (each submitted with its entry of
    ``submit_kws``: a sampled run replays its sampled program); the
    engine is spent afterwards."""
    from repro_torch.serving.engine import RequestState
    r = eng.runner
    kws = submit_kws or [{}] * len(prompts)
    reqs = [eng.submit(p, NEW, **kw) for p, kw in zip(prompts, kws)]
    while any(q.state is not RequestState.DECODE for q in reqs):
        eng.step()
    eng._drain_inflight()
    cache = _cache_tensors(r)
    saved = [t.clone() for t in cache]

    def one_step():
        kw = dict(seeds=eng._seeds, top_k=eng._topks, top_p=eng._topps)
        if r.speculate_k:
            h = r.dispatch_spec(eng._tok, eng._pos, eng._active, eng._temps,
                                eng._counts, **kw)
            out = r.wait_spec(h)
        else:
            h = r.dispatch_decode(eng._tok, eng._pos, eng._active,
                                  eng._temps, eng._eos, eng._remaining,
                                  eng._counts, **kw)
            out = r.wait_decode(h)
        return (h["key"], h["logits"].float().clone(),
                [np.asarray(o).copy() for o in out],
                [t.clone() for t in cache])

    programs, r.programs = r.programs, {}
    try:
        eager = one_step()
    finally:
        r.programs = programs
    for t, s_ in zip(cache, saved):
        t.copy_(s_)
    hits = r.planned_hits
    replay = one_step()
    replayed = r.planned_hits == hits + 1
    same_logits = torch.equal(eager[1], replay[1])
    same_out = all(np.array_equal(a, b) for a, b in zip(eager[2], replay[2]))
    same_cache = all(torch.equal(a, b) for a, b in zip(eager[3], replay[3]))
    dmax = (eager[1] - replay[1]).abs().max().item()
    log(f"[planned] {tag}: one step at {replay[0]} replayed against the "
        f"eager step: logits {list(replay[1].shape)} bitwise "
        f"{'equal' if same_logits else 'NOT equal'} (max |diff| {dmax:.3e}),"
        f" packed result {'equal' if same_out else 'NOT equal'}, cache "
        f"bytes {'equal' if same_cache else 'NOT equal'}; replayed "
        f"{replayed}")
    return replayed and same_logits and same_out and same_cache


def profile_planned(eng, vocab: int, rng, tag: str, submit_kws=None) -> None:
    """Phase 6 for a planned run: SLOTS requests admitted and decoding
    (each submitted with its entry of ``submit_kws``), then three engine
    steps timed unprofiled (wall, synchronized; each dispatches one
    replay and waits on the one before) and three profiled: device busy
    per step, device ops per step (the graph's kernels and the step's
    copies), and the busy share against the unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import RequestState
    kws = submit_kws or [{}] * SLOTS
    reqs = [eng.submit(rng.integers(1, vocab, size=(PROMPT,)).tolist(), NEW,
                       **kw) for kw in kws]
    while any(q.state is not RequestState.DECODE for q in reqs):
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 3 / 1e3, e.count / 3, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    eng.run()
    if not rows:
        log(f"[profile] {tag} planned step: the profiler saw no device time "
            f"(busy / idle share not measured); unprofiled step "
            f"{step_ms:.3f} ms")
        return
    busy = sum(x[0] for x in rows)
    ops_ = sum(x[1] for x in rows)
    log(f"[profile] {tag} planned step (replayed): device busy {busy:.3f} ms "
        f"in {ops_:.0f} kernels and copies per step; "
        f"unprofiled step {step_ms:.3f} ms ({100 * busy / step_ms:.1f} % "
        f"busy, {100 - 100 * busy / step_ms:.1f} % idle)")
    for ms, count, key in rows[:6]:
        log(f"[profile]   {ms:9.3f} ms {count:6.0f}x  {key[:90]}")
    PROFILED[tag] = {"busy_ms": busy, "device_ops": ops_,
                     "step_ms": step_ms}


PLANNED = {}      # tag -> the figures of each planned run, for the JSON
PROFILED = {}     # tag -> one planned step's device busy ms and ops


def serve_planned(dev, card: str, tag: str, kind: str, cfg, params, knobs,
                  prompts, sync: dict, submit_kws=None,
                  variants=(False,)):
    """Phase 5 (and 6): the sync run's prompts (each submitted with its
    entry of ``submit_kws``) served again with ``Engine(pipeline_depth=1)``
    and the sync run's knobs (``params`` a tree, or a function that makes
    one), its step programs captured by ``plan_programs`` for the
    ``variants`` asked (greedy, sampled), greedy first, those of the
    live lengths PROMPT..PROMPT + NEW that the run, ``check_replay`` and
    ``profile_planned`` take, each stage's graphs, capture seconds and
    memory reported.  Gates: every request
    finishes with NEW tokens; every decode / spec step of the run is a
    replay (``planned_hits``) with one host transfer (transfers =
    dispatches); the sync run's launch and route arithmetic
    (``_arith``) holds with the replays' launches counted; the streams
    are the sync run's token for token, plain and speculative alike
    (the decode kernels' split size follows the capacity, so a wider
    sweep bound in a pipelined step changes no bit); one replayed step
    equals the eager step bitwise (``check_replay``).  Prints the pair's
    TTFT, TPOT, throughput, peak memory, the graph count and capture
    seconds, the dispatch gaps.  Returns the launch counts of the
    measured run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    if callable(params):
        params = params()
    kws = submit_kws or [{}] * len(prompts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, pipeline_depth=1,
                 prefix_cache=False, **knobs)
    del params
    r = eng.runner
    stages = {}
    for v in variants:
        torch.cuda.synchronize()
        before = (len(r.programs), r.plan_seconds,
                  torch.cuda.memory_reserved(dev))
        # the programs of the live lengths this run and its probes take
        # (every step still a replay); all of them took ~70 s more
        r.plan_programs(sampled=(v,), lengths=range(PROMPT, PROMPT + NEW + 1))
        torch.cuda.synchronize()
        stages["sampled" if v else "greedy"] = {
            "graphs": len(r.programs) - before[0],
            "capture_s": r.plan_seconds - before[1],
            "reserved_gb": (torch.cuda.memory_reserved(dev) - before[2])
            / 1e9}
    plan_peak = torch.cuda.max_memory_allocated(dev)
    log(f"[planned] {tag}: {len(r.programs)} CUDA graphs "
        f"({', '.join(str(k[1:]) for k in sorted(r.programs))}) captured in "
        f"{r.plan_seconds:.3f}s; by variant {json.dumps(stages)}; peak "
        f"memory while planning {plan_peak / 1e9:.3f} GB, reserved "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB")
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)               # warm-up
    eng.metrics = EngineMetrics()
    eng._last_dispatch_t = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    base = (eng.steps_run, r.decode_transfers, r.planned_hits,
            r.prefill_calls, r.chunk_calls)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW, **kw) for p, kw in zip(prompts, kws)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    routes = dict(ops.int8_matmul.routes)
    flash_routes = dict(ops.flash_attention.routes)
    rms_routes = dict(ops.rmsnorm.routes)
    scan_routes = dict(ops.ssm_scan.routes)
    m = eng.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)
    c = {"steps": eng.steps_run - base[0], "T": r.decode_transfers - base[1],
         "hits": r.planned_hits - base[2], "P": r.prefill_calls - base[3],
         "C": r.chunk_calls - base[4]}
    dispatches = len(eng.metrics.dispatch_gaps) + 1
    done = sum(q.state is RequestState.DONE and len(q.output) == NEW
               for q in reqs)
    streams = [q.output for q in reqs]
    div = [_divergence(a, b) for a, b in zip(streams, sync["streams"])]
    sm, gap = sync["m"], m["dispatch_gap_ms"]
    log(f"[planned] {card} | {tag}: {SLOTS} reqs x ({PROMPT} in / {NEW} out),"
        f" pipeline depth 1, {c['steps']} engine steps, {dispatches} "
        f"dispatches, {c['T']} host transfers, {c['hits']} replays, wall "
        f"{wall:.3f}s")
    log(f"[pair] {card} | {tag}: sync -> planned: TTFT ms p50 "
        f"{sm['ttft_ms']['p50']:.2f} -> {m['ttft_ms']['p50']:.2f}, p90 "
        f"{sm['ttft_ms']['p90']:.2f} -> {m['ttft_ms']['p90']:.2f}; TPOT ms "
        f"p50 {sm['tpot_ms']['p50']:.3f} -> {m['tpot_ms']['p50']:.3f}, p90 "
        f"{sm['tpot_ms']['p90']:.3f} -> {m['tpot_ms']['p90']:.3f}; "
        f"throughput {sm['throughput_tok_s']:.1f} -> "
        f"{m['throughput_tok_s']:.1f} tok/s; peak memory "
        f"{sync['peak'] / 1e9:.3f} -> {peak / 1e9:.3f} GB; graphs "
        f"{len(r.programs)}, capture {r.plan_seconds:.3f}s; dispatch gap ms "
        f"p50 {gap['p50']:.3f} p90 {gap['p90']:.3f}; steps in flight "
        f"{m['steps_in_flight']}")
    if r.speculate_k:
        log(f"[planned] {tag}: acceptance {m['acceptance_rate']:.4f} (sync "
            f"{sm['acceptance_rate']:.4f}), tokens per slot per spec step "
            f"{m['tokens_per_slot_step']:.3f}")
    want, want_routes = _arith(kind, cfg, c)
    got = {k: launches[k] for k in want}
    gates = {"finished": done == len(reqs),
             "every step replayed": c["hits"] == c["T"] > 0,
             "one transfer per step": c["T"] == dispatches,
             "launch arithmetic": got == want and (c["P"] + c["C"]) > 0}
    if want_routes is not None:
        gates["W8A16 routes"] = routes == dict(
            dict.fromkeys(routes, 0), **want_routes)
    want_norm = norm_routes(kind, cfg, c)
    gates["RMSNorm routes"] = rms_routes == want_norm
    NORM_ROUTES[tag + " planned"] = rms_routes
    log(f"[planned] {tag}: RMSNorm routes {json.dumps(rms_routes)}, "
        f"arithmetic {json.dumps(want_norm)}")
    gates["scan routes"] = scan_routes == scan_route_counts("selective",
                                                            launches)
    SCAN_ROUTES[tag + " planned"] = scan_routes
    if kind != "int8" and kind != "falcon":
        gates["flash routes"] = flash_routes == dict(
            dict.fromkeys(flash_routes, 0),
            wgmma_tma=launches["flash_attention"])
    log(f"[planned] {tag}: kernel launches {json.dumps(launches)}; "
        f"arithmetic {json.dumps(want)}: {'met' if got == want else 'NOT MET'}")
    log(f"[planned] {tag}: streams equal to the sync run's: "
        f"{div.count(-1)}/{len(div)} (first divergence per request: {div})")
    gates["streams equal sync"] = div.count(-1) == len(div)
    profile_planned(eng, cfg.vocab_size, rng, tag, kws[:SLOTS])
    gates["replay == eager, bitwise"] = check_replay(eng, prompts[:SLOTS],
                                                     tag, kws[:SLOTS])
    log(f"[planned] {tag}: gates {json.dumps(gates)}")
    PLANNED[tag] = {"launches": launches, "graphs": len(r.programs),
                    "graphs_by_variant": stages,
                    "capture_s": r.plan_seconds, "ttft_ms": m["ttft_ms"],
                    "tpot_ms": m["tpot_ms"],
                    "throughput_tok_s": m["throughput_tok_s"],
                    "peak_gb": peak / 1e9, "dispatch_gap_ms": gap,
                    "sync_tpot_ms": sm["tpot_ms"], "sync_peak_gb":
                    sync["peak"] / 1e9}
    del eng, r
    gc.collect()
    torch.cuda.empty_cache()
    if not all(gates.values()):
        raise SystemExit(f"[planned] {tag}: gates {gates}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: sampled serving (threefry keys on the card, the sampled step
# programs) and the split plan at a bound boundary
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLING = {}     # the figures of phase 7, for the summary line


def sampled_kws(lanes=range(SLOTS)):
    """Per-request submit arguments: SAMPLED with seed i on the lanes
    given, greedy (seed i) on the others."""
    from repro_torch.serving.sampler import SampleParams
    return [dict(params=SampleParams(**SAMPLED) if i in lanes
                 else SampleParams(), seed=i) for i in range(SLOTS)]


def check_prng(dev: torch.device, vocab: int) -> None:
    """The threefry stream on the card against the CPU port's: row_keys
    of seeds 0-7 (and 2**31 - 1, 2**32 - 1) by counters 0-300 in each
    salt, the 32-bit words and the uniforms of [8, vocab] draws,
    bitwise (gated); the Gumbel noise's largest difference in units of
    the last place of max(|g|, 1), and how many of 64 categorical draws
    over the same logits agree (reported: ``log`` may differ in its
    last bit between the card's and the CPU's implementation)."""
    from repro_torch.common import prng
    from repro_torch.serving import sampler
    seeds = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 2 ** 31 - 1, 2 ** 32 - 1],
                         dtype=torch.int64)
    cnt = torch.arange(301, dtype=torch.int64)
    s, c = seeds.repeat_interleave(len(cnt)), cnt.repeat(len(seeds))
    keys_ok = all(torch.equal(
        sampler.row_keys(s.to(dev), c.to(dev), salt).cpu(),
        sampler.row_keys(s, c, salt)) for salt in (0, 1, 2))
    keys = sampler.row_keys(seeds[:8], torch.full((8,), 5), 0)
    kd = keys.to(dev)
    bits_ok = torch.equal(prng.random_bits(kd, (vocab,)).cpu(),
                          prng.random_bits(keys, (vocab,)))
    uni_ok = torch.equal(prng.uniform(kd, (vocab,)).cpu(),
                         prng.uniform(keys, (vocab,)))
    g_card = prng.gumbel(kd, (vocab,)).cpu().double()
    g_cpu = prng.gumbel(keys, (vocab,)).double()
    ulp = np.spacing(np.maximum(g_cpu.abs().numpy(), 1.0).astype(np.float32))
    g_ulp = float(((g_card - g_cpu).abs().numpy() / ulp).max())
    logits = torch.randn(64, vocab, generator=torch.Generator()
                         .manual_seed(0)) * 3
    k64 = sampler.row_keys(torch.arange(64), torch.zeros(64), 0)
    agree = int((prng.categorical(k64.to(dev), logits.to(dev)).cpu()
                 == prng.categorical(k64, logits)).sum())
    log(f"[sampling] threefry on the card against the CPU port: row_keys "
        f"(10 seeds x 301 counters x 3 salts) bitwise {keys_ok}; random "
        f"bits [8, {vocab}] bitwise {bits_ok}; uniforms bitwise {uni_ok}; "
        f"Gumbel max |diff| {g_ulp:.2f} ulp of max(|g|, 1); categorical "
        f"draws over [64, {vocab}] logits equal {agree}/64")
    SAMPLING.update(keys_bitwise=keys_ok, bits_bitwise=bits_ok,
                    uniform_bitwise=uni_ok, gumbel_max_ulp=g_ulp,
                    categorical_equal=agree)
    if not (keys_ok and bits_ok and uni_ok):
        raise SystemExit("[sampling] threefry keys or bits differ between "
                         "the card and the CPU")


def serve_sync(dev, card: str, tag: str, cfg, params, knobs, prompts,
               submit_kws) -> dict:
    """One sync run of the cell's shape (SLOTS slots, capacity PROMPT +
    NEW + 8, block BLOCK) on ``prompts``, each submitted with its entry
    of ``submit_kws``, after a warm-up: every request must finish with
    NEW tokens.  Returns {"m", "peak", "streams", "wall"}."""
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, prefix_cache=False, **knobs)
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)               # warm-up
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW, **kw) for p, kw in zip(prompts, submit_kws)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics.summary()
    done = sum(q.state is RequestState.DONE and len(q.output) == NEW
               for q in reqs)
    log(f"[sampling] {card} | {tag}: {len(reqs)} reqs x ({PROMPT} in / "
        f"{NEW} out), wall {wall:.3f}s; TTFT ms p50 "
        f"{m['ttft_ms']['p50']:.2f}; TPOT ms p50 {m['tpot_ms']['p50']:.3f} "
        f"p90 {m['tpot_ms']['p90']:.3f}; throughput "
        f"{m['throughput_tok_s']:.1f} tok/s"
        + (f"; acceptance rate {m['acceptance_rate']:.4f}, tokens per slot "
           f"per spec step {m['tokens_per_slot_step']:.3f}"
           if eng.runner.speculate_k else ""))
    out = {"m": m, "peak": torch.cuda.max_memory_allocated(dev),
           "streams": [q.output for q in reqs], "wall": wall}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if done != len(reqs):
        raise SystemExit(f"[sampling] {tag}: not every request finished")
    return out


def epilogue_cost(dev: torch.device, vocab: int) -> None:
    """The sampling epilogue alone at the serve shape (logits [SLOTS,
    vocab] fp32, as the fp32 head gives them): the decode step's greedy
    ``sample_step`` against its sampled one (``row_keys`` + filter +
    Gumbel-max), and the speculative step's greedy against its sampled
    ``accept_step`` (K = SPEC_K), as device work (a CUDA graph of the
    calls) and device ops per call (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import sampler
    g = torch.Generator(device=dev).manual_seed(0)
    B, K = SLOTS, SPEC_K
    logits = torch.randn(B, vocab, generator=g, device=dev) * 3
    tgt = torch.randn(B, K + 1, vocab, generator=g, device=dev) * 3
    dlg = tgt[:, :K] + torch.randn(B, K, vocab, generator=g, device=dev)
    drafts = torch.argmax(dlg, -1).to(torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    seeds, cnt = torch.arange(B, **i32), torch.full((B,), 9, **i32)
    temp = torch.full((B,), SAMPLED["temperature"], device=dev)
    top_k = torch.full((B,), SAMPLED["top_k"], **i32)
    top_p = torch.full((B,), SAMPLED["top_p"], device=dev)
    act = torch.ones(B, dtype=torch.bool, device=dev)
    eos, rem = torch.full((B,), -1, **i32), torch.full((B,), 9, **i32)
    fns = {
        "decode greedy": lambda: sampler.sample_step(
            logits, None, None, None, None, act, eos, rem),
        "decode sampled": lambda: sampler.sample_step(
            logits, sampler.row_keys(seeds, cnt, sampler.SALT_SAMPLE), temp,
            top_k, top_p, act, eos, rem),
        "spec accept greedy": lambda: sampler.accept_step(
            tgt, dlg, drafts, None, None, None, None, None, act),
        "spec accept sampled": lambda: sampler.accept_step(
            tgt, dlg, drafts, seeds, cnt, temp, top_k, top_p, act)}
    cost = {}
    for name, fn in fns.items():
        ms = graph_ms(lambda: fn(), [()], 20)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n_ops = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        cost[name] = {"ms": ms, "device_ops": n_ops}
    log(f"[sampling] epilogue alone ({B} rows, vocab {vocab}, device work): "
        + "; ".join(f"{k} {v['ms']:.4f} ms in {v['device_ops']} device ops"
                    for k, v in cost.items()))
    SAMPLING["epilogue"] = cost


def serve_sampling(dev, card: str, params, prompts, greedy: dict) -> None:
    """Phase 7a: pt-6b-d4 bf16 on phase 5's prompts, every request
    sampled (SAMPLED, seeds 0-7): the sync run, then the planned run
    (``serve_planned`` with greedy and sampled programs: its streams
    bitwise the sync run's, every step a replay of a sampled program,
    one replay bitwise its eager step); then a mixed batch (lanes 0-3
    greedy, 4-7 sampled) by the sync engine, whose greedy lanes must
    emit phase 5's all-greedy streams bitwise (``greedy`` the bf16 sync
    run's result).  Prints each run's TTFT / TPOT beside the greedy
    runs' and the epilogue's cost."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    check_prng(dev, cfg.vocab_size)
    epilogue_cost(dev, cfg.vocab_size)
    kws = sampled_kws()
    sync = serve_sync(dev, card, "bf16 sampled", cfg, params, {}, prompts,
                      kws)
    serve_planned(dev, card, "bf16 sampled", "bf16", cfg, params, {},
                  prompts, sync, submit_kws=kws, variants=(False, True))
    mixed = serve_sync(dev, card, "bf16 mixed (lanes 0-3 greedy)", cfg,
                       params, {}, prompts, sampled_kws(range(4, SLOTS)))
    same = [mixed["streams"][i] == greedy["streams"][i] for i in range(4)]
    differ = sum(mixed["streams"][i] != greedy["streams"][i]
                 for i in range(4, SLOTS))
    log(f"[sampling] mixed batch: greedy lanes 0-3 equal the all-greedy "
        f"run's streams {sum(same)}/4; sampled lanes 4-7 differ from greedy "
        f"{differ}/4")
    gm, pm = greedy["m"], PLANNED["bf16"]
    sm, spm = sync["m"], PLANNED["bf16 sampled"]
    log(f"[sampling] TTFT / TPOT p50 ms, greedy -> sampled: sync "
        f"{gm['ttft_ms']['p50']:.2f} / {gm['tpot_ms']['p50']:.3f} -> "
        f"{sm['ttft_ms']['p50']:.2f} / {sm['tpot_ms']['p50']:.3f}; planned "
        f"{pm['ttft_ms']['p50']:.2f} / {pm['tpot_ms']['p50']:.3f} -> "
        f"{spm['ttft_ms']['p50']:.2f} / {spm['tpot_ms']['p50']:.3f}")
    SAMPLING.update(mixed_greedy_equal=sum(same), mixed_sampled_differ=differ,
                    sync_ttft_ms=sm["ttft_ms"], sync_tpot_ms=sm["tpot_ms"])
    if not all(same):
        raise SystemExit("[sampling] a greedy lane of the mixed batch left "
                         "the all-greedy stream")


def _record_spec_keys(eng, store: list) -> None:
    """Wrap the runner's spec dispatch: each step's program key."""
    r = eng.runner
    inner = r.dispatch_spec

    def dispatch(*a, **k):
        h = inner(*a, **k)
        store.append(h["key"])
        return h

    r.dispatch_spec = dispatch


def serve_spec_sampled(dev, card: str, params) -> None:
    """Phase 7b, on the tied tracks: the speculative arm (K SPEC_K,
    SPEC_TRACKS tracks) with every request sampled (SAMPLED, seeds 0-7):
    the drafter samples under SALT_DRAFT keys, the accept is rejection
    sampling; the sync run, then the planned one, whose streams must be
    the sync run's bitwise."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    knobs = dict(speculate_k=SPEC_K, draft_tracks=SPEC_TRACKS)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=(PROMPT,)).tolist()
               for _ in range(SLOTS)]
    kws = sampled_kws()
    tag = "bf16 spec sampled, tracks tied"
    sync = serve_sync(dev, card, tag, cfg, params, knobs, prompts, kws)
    serve_planned(dev, card, tag, "spec", cfg, params, knobs, prompts, sync,
                  submit_kws=kws, variants=(False, True))
    SAMPLING["spec_acceptance_rate"] = sync["m"]["acceptance_rate"]


BOUNDARY_NEW = 24        # tokens of the bound-boundary runs


def spec_boundary(dev, card: str, params) -> None:
    """Phase 7c: greedy speculation (K SPEC_K, SPEC_TRACKS tracks, the
    seeded tracks: no draft is accepted, so every lane moves one token a
    step) on 8 prompts of 496-503 tokens, BOUNDARY_NEW new tokens, at the
    serve cell's capacity.  The farthest lane passes the positions
    within K below 512, where a pipelined step's bounds (the host's
    positions, one step behind, plus K + (K + 1) per step in flight) lie
    in the next bucket (the drafter's contiguous 584, the verify's 37
    blocks) while the sync step's do not: the drafter's decode kernel
    then sweeps more splits.  Three runs: sync, pipelined (depth 1,
    eager programs) and planned (depth 1, CUDA graphs).  Gates: the
    pipelined run's drafter logits bitwise the sync run's at every step
    (recorded eagerly: a graph replay runs no Python), both runs'
    streams bitwise the sync run's, and at least one step with another
    bound (which the split plan sized from the bound summed in another
    order)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import Engine
    cfg = get_config(ARCH)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, size=(496 + i,)).tolist()
               for i in range(SLOTS)]
    inner = engine_mod.pt_draft_step
    out = {}
    try:
        for name, extra in (("sync", {}), ("pipelined",
                                           dict(pipeline_depth=1)),
                            ("planned", dict(pipeline_depth=1))):
            rows, keys = [], []

            def draft_step(*a, **k):
                logits, c = inner(*a, **k)
                if logits is not None:
                    rows.append(logits.float().clone())
                return logits, c

            # the planned run's steps are graph replays: no recording
            engine_mod.pt_draft_step = (inner if name == "planned"
                                        else draft_step)
            eng = Engine(cfg, params, max_slots=SLOTS,
                         max_seq_len=PROMPT + NEW + 8, block_size=BLOCK,
                         device=dev, speculate_k=SPEC_K,
                         draft_tracks=SPEC_TRACKS, prefix_cache=False, **extra)
            if name == "planned":
                eng.runner.plan_programs(sampled=(False,))   # greedy runs
            _record_spec_keys(eng, keys)
            reqs = [eng.submit(p, BOUNDARY_NEW) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            out[name] = {"rows": rows, "keys": keys,
                         "streams": [q.output for q in reqs],
                         "hits": eng.runner.planned_hits,
                         "steps": eng.runner.decode_transfers}
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        engine_mod.pt_draft_step = inner
    s_, p_, q_ = out["sync"], out["pipelined"], out["planned"]
    other = [(x, y) for x, y in zip(s_["keys"], p_["keys"])
             if x[1:3] != y[1:3]]
    n = min(len(s_["rows"]), len(p_["rows"]))
    diffs = [(a - b).abs().max().item()
             for a, b in zip(s_["rows"][:n], p_["rows"][:n])]
    div_p = [_divergence(a, b) for a, b in zip(s_["streams"], p_["streams"])]
    div_q = [_divergence(a, b) for a, b in zip(s_["streams"], q_["streams"])]
    gates = {"drafter logits bitwise": n > 0 and not any(diffs),
             "pipelined streams equal sync": div_p.count(-1) == SLOTS,
             "planned streams equal sync": div_q.count(-1) == SLOTS,
             "planned every step replayed": q_["hits"] == q_["steps"] > 0,
             "a step took another bound": bool(other)}
    log(f"[boundary] {card} | spec K {SPEC_K} at the bound boundary "
        f"(prompts 496-503, {BOUNDARY_NEW} new): {len(s_['keys'])} sync / "
        f"{len(p_['keys'])} pipelined / {len(q_['keys'])} planned steps; "
        f"{len(other)} pipelined steps with another (drafter, verify) "
        f"bound than the sync step (first: {other[:1]}); drafter logits "
        f"compared over {n} draft steps, max |diff| "
        f"{max(diffs, default=0.0):.3e}; streams equal to sync: pipelined "
        f"{div_p.count(-1)}/{SLOTS}, planned {div_q.count(-1)}/{SLOTS}")
    log(f"[boundary] gates {json.dumps(gates)}")
    SAMPLING.update(boundary_steps_other_bound=len(other),
                    boundary_draft_steps_compared=n,
                    boundary_gates=gates)
    if not all(gates.values()):
        raise SystemExit(f"[boundary] gates {gates}")


# ---------------------------------------------------------------------------
# phase 8: pt-6b-d4 served on track ranks (torch.distributed, gloo) on the
# one card
# ---------------------------------------------------------------------------

RANKS = 2                      # two track ranks of pt-6b-d4's 8 tracks
RANK_TIMEOUT = 600.0           # seconds for the spawned run, start to join


def teacher_forced(r, prompts, streams) -> torch.Tensor:
    """The logits a runner gives along ``streams`` [n, NEW] after
    ``prompts`` [n, PROMPT]: the whole-prompt prefill's last row (the
    engine's prefill call: the bucket is the prompt length) and one paged
    decode step per stream token but the last, each the engine's decode
    call (the same block table rows, bound and active lanes).  [n, NEW, V]
    fp32; the cache rows are freed after."""
    n, T, dev, cfg = len(prompts), NEW - 1, r.device, r.cfg
    slots = list(range(n))
    for s_ in slots:
        r.kv.allocate(s_, PROMPT + NEW)
    active = np.ones((n,), bool)
    act_d = torch.ones((n,), dtype=torch.bool, device=dev)
    pos = np.full((n,), PROMPT, np.int32)
    pos_d = torch.as_tensor(pos, device=dev)
    toks = torch.as_tensor([s[:T] for s in streams], device=dev)
    with torch.no_grad():
        logits, cache = r.fns["forward"](
            r.params, {"inputs": torch.as_tensor(prompts, device=dev)}, cfg)
        out = [logits[:, PROMPT - 1].float()]
        r.kv.insert_prefill(cache, slots, r.kv.table_rows(slots))
        del logits, cache
        for i in range(T):
            out.append(r.fns["decode"](
                r.params, r.cache, toks[:, i], pos_d + i, cfg,
                block_table=r._masked_table(active),
                kv_max_len=r._live_max_len(pos + i, active),
                active=act_d)[0].float())
    for s_ in slots:
        r.kv.free_slot(s_)
    return torch.stack(out, dim=1)


def _wrap_collectives(calls: dict, timed: dict):
    """Count every collective of ``torch.distributed`` (independently of
    the port's own counter) by name in ``calls``; while ``timed["on"]``,
    also the host-clock seconds inside each (the card synchronised before
    and after, so that the span is the collective's alone) in
    ``timed["s"]``."""
    import torch.distributed as dist
    names = ("all_gather_single", "all_gather_into_tensor", "all_gather",
             "all_reduce", "broadcast", "reduce", "reduce_scatter",
             "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
             "gather", "scatter", "barrier", "send", "recv", "isend",
             "irecv", "batch_isend_irecv")

    def wrap(fn, name):
        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            if not timed["on"]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timed["s"] += time.perf_counter() - t0
            return out
        return counted

    for name in names:
        if hasattr(dist, name):
            setattr(dist, name, wrap(getattr(dist, name), name))


def serve_rank(par, device: str, prompts, streams, ref_path: str) -> dict:
    """Phase 8 on one track rank (a spawned process; ``par`` its rank of
    the gloo group): pt-6b-d4 bf16 from phase 5's seed, the rank's share
    kept, served by ``Engine(par=...)`` on phase 5's prompts after phase
    5's warm-up, with the launch counts, the collectives per prefill call
    and per decode step and the RMSNorm routes of the measured run; then
    the logits teacher-forced along one process's streams, against one
    process's (``ref_path``), with the host clock's share of each decode
    step spent in the collective."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.core.track import init_pt
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    calls, timed = {}, {"on": False, "s": 0.0}
    _wrap_collectives(calls, timed)
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    full = init_pt(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    eng = Engine(cfg, full, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, par=par, prefix_cache=False)
    del full                            # the engine keeps the rank's share
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r = eng.runner
    held = sum(nbytes(t) for t in _leaves(r.params))
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)                 # as phase 5
    eng.metrics = EngineMetrics()
    per_prefill, per_step = [], []

    def counted(fn, into):
        def call(*args, **kwargs):
            n0 = sum(calls.values())
            out = fn(*args, **kwargs)
            into.append(sum(calls.values()) - n0)
            return out
        return call

    r.prefill = counted(r.prefill, per_prefill)
    r._dispatch_step = counted(r._dispatch_step, per_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    calls.clear()
    port0, adds0 = par.counts.collectives, par.counts.local_adds
    t0 = time.perf_counter()
    reqs = [eng.submit(p, NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rank": par.rank, "wall": wall, "init_s": init_s,
           "param_bytes": held, "kv_bytes": r.kv.pool_bytes(),
           "launches": ops.launch_counts(),
           "norm_routes": dict(ops.rmsnorm.routes),
           "flash_routes": dict(ops.flash_attention.routes),
           "per_prefill": per_prefill, "per_step": per_step,
           "calls": dict(calls),
           "port_collectives": par.counts.collectives - port0,
           "local_adds": par.counts.local_adds - adds0,
           "m": eng.metrics.summary(),
           "peak": torch.cuda.max_memory_allocated(dev),
           "done": sum(q.state is RequestState.DONE and len(q.output) == NEW
                       for q in reqs),
           "streams": [q.output for q in reqs]}
    del r.prefill, r._dispatch_step
    # teacher-forced along one process's streams, the collective timed
    timed["on"] = True
    t0 = time.perf_counter()
    got = teacher_forced(r, prompts, streams)
    torch.cuda.synchronize()
    out["forced_s"], out["collective_s"] = time.perf_counter() - t0, timed["s"]
    timed["on"] = False
    ref = torch.from_numpy(np.load(ref_path)).to(dev)
    diff = (got - ref).abs()
    rows = (got != ref).flatten(2).any(-1)                  # [n, NEW]
    out.update(
        logits_sha=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
        bitwise=bool(torch.equal(got, ref)),
        mean_diff=diff[:, 1:].mean().item(), max_diff=diff.max().item(),
        prefill_diff=diff[:, 0].max().item(),
        argmax_equal=int((got.argmax(-1) == ref.argmax(-1)).sum()),
        first_diff_step=(int(rows.any(0).nonzero()[0]) if rows.any()
                         else -1))
    return out


def serve_ranks(dev: torch.device, card: str, prompts, streams,
                launches) -> dict:
    """Phase 8: pt-6b-d4 bf16 at full width and depth on RANKS track
    ranks of the one card (one process each, gloo: NCCL takes one rank
    per device; 4 of the 8 tracks each), the paged cache, phase 5's 8
    prompts of 512 tokens and 64 greedy new tokens, the sync engine.
    ``streams`` and ``launches`` are phase 5's one-process bf16 sync
    run's (its routes are in NORM_ROUTES and FLASH_ROUTES).  First one
    process's logits teacher-forced along its streams
    (``teacher_forced``), and its whole-sequence prefill over the same
    tokens, the yardstick of ``check_spec_logits``.
    Gates: (a) the ranks' streams and teacher-forced logits bitwise
    equal to each other; (b) a wrapper on the ``torch.distributed``
    functions counts exactly R = L / D collectives per prefill call and
    per decode step, of the gather alone, as the port's own counter
    does, with one local add each; every kernel's launches and every
    RMSNorm and flash route's on each rank equal to phase 5's; (c)
    streams and logits bitwise equal to one process's, or else the
    teacher-forced logits within ``check_spec_logits``'s limit of one
    process's decode logits (2 x the one-process prefill's mean distance
    to its decode, or 2e-2 x decode's logit std where larger); the free
    streams are printed, not gated.  Returns rank 0's launch counts."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.track import init_pt, pt_sync_points
    from repro_torch.runtime.parallel import spawn
    from repro_torch.serving.engine import Engine
    cfg = get_config(ARCH)
    R, T = pt_sync_points(cfg.n_layers, cfg.pt.block_depth), NEW - 1
    params = init_pt(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, prefix_cache=False)
    ref = teacher_forced(eng.runner, prompts, streams)
    replay = int((ref.argmax(-1) == torch.as_tensor(streams, device=dev))
                 .sum())
    with torch.no_grad():
        seq = torch.cat([torch.as_tensor(prompts, device=dev),
                         torch.as_tensor([s[:T] for s in streams],
                                         device=dev)], dim=1)
        pre = eng.runner.fns["forward"](eng.runner.params,
                                        {"inputs": seq}, cfg)[0]
        pre = pre[:, PROMPT:PROMPT + T].float()
    dec = ref[:, 1:]
    pre_mean = (pre - dec).abs().mean().item()
    limit = max(2 * pre_mean, KERNEL_TOL * dec.std().item())
    log(f"[ranks] one process: teacher-forced logits replay its streams at "
        f"{replay}/{len(prompts) * NEW} tokens; its prefill vs its decode "
        f"mean |diff| {pre_mean:.4e}; limit {limit:.4e}")
    del eng, params, pre, dec, seq
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        path = str(Path(tmp) / "ref.npy")
        np.save(path, ref.cpu().numpy())
        del ref
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = spawn(serve_rank, RANKS, (str(dev), prompts, streams, path),
                    timeout=RANK_TIMEOUT)
        log(f"[ranks] {RANKS} rank processes, spawn to join "
            f"{time.perf_counter() - t0:.1f}s")
    gather = ("all_gather_single" if hasattr(torch.distributed,
                                             "all_gather_single")
              else "all_gather_into_tensor")
    n_pre, n_dec = len(res[0]["per_prefill"]), len(res[0]["per_step"])
    for o in res:
        m = o["m"]
        share = o["collective_s"] / o["forced_s"]
        log(f"[ranks] {card} | rank {o['rank']}/{RANKS}: TTFT ms p50 "
            f"{m['ttft_ms']['p50']:.2f} p90 {m['ttft_ms']['p90']:.2f}; TPOT "
            f"ms p50 {m['tpot_ms']['p50']:.3f} p90 {m['tpot_ms']['p90']:.3f};"
            f" throughput {m['throughput_tok_s']:.1f} tok/s; wall "
            f"{o['wall']:.3f}s; peak memory {o['peak'] / 1e9:.3f} GB "
            f"(weights held {o['param_bytes'] / 1e9:.3f} GB, KV pool "
            f"{o['kv_bytes'] / 1e9:.3f} GB); init + shard {o['init_s']:.1f}s")
        log(f"[ranks] {card} | rank {o['rank']}: collective (gloo through "
            f"host memory on one card, not NVLink) {share * 100:.1f} % of "
            f"the host clock of {T} teacher-forced decode steps + 1 prefill "
            f"({o['collective_s'] * 1e3:.1f} of {o['forced_s'] * 1e3:.1f} "
            f"ms, the card synchronised around each collective)")
        log(f"[ranks] rank {o['rank']}: launches {json.dumps(o['launches'])}"
            f"; RMSNorm routes {json.dumps(o['norm_routes'])}; collectives "
            f"{json.dumps(o['calls'])} (port's counter "
            f"{o['port_collectives']}, local adds {o['local_adds']}) over "
            f"{len(o['per_prefill'])} prefill calls and "
            f"{len(o['per_step'])} decode steps")
        log(f"[ranks] rank {o['rank']} vs one process, teacher-forced: "
            f"bitwise {o['bitwise']}, mean |diff| {o['mean_diff']:.4e}, max "
            f"{o['max_diff']:.4e} (prefill row {o['prefill_diff']:.4e}), "
            f"argmax equal {o['argmax_equal']}/{len(prompts) * NEW}, first "
            f"differing step {o['first_diff_step']} (-1: none); free "
            f"streams equal {sum(a == b for a, b in zip(o['streams'], streams))}"
            f"/{len(streams)}")
    total = R * (n_pre + n_dec)
    gates = {
        "finished": all(o["done"] == len(prompts) for o in res),
        "(a) ranks bitwise": all(o["streams"] == res[0]["streams"]
                                 and o["logits_sha"] == res[0]["logits_sha"]
                                 for o in res),
        "(b) R per prefill call": all(o["per_prefill"] == [R] * n_pre
                                      and n_pre for o in res),
        "(b) R per decode step": all(o["per_step"] == [R] * n_dec and n_dec
                                     for o in res),
        "(b) the gather alone": all(o["calls"] == {gather: total}
                                    and o["port_collectives"] == total
                                    and o["local_adds"] == total
                                    for o in res),
        "launches = one process": all(o["launches"] == launches
                                      for o in res),
        "RMSNorm routes = one process": all(
            o["norm_routes"] == NORM_ROUTES["bf16"] for o in res),
        "flash routes = one process": all(
            o["flash_routes"] == FLASH_ROUTES["bf16"] for o in res)}
    bitwise = all(o["bitwise"] and o["streams"] == streams for o in res)
    if bitwise:
        gates["(c) bitwise = one process"] = True
    else:
        gates["(c) teacher-forced within limit"] = all(
            o["mean_diff"] <= limit for o in res)
    log(f"[ranks] gates {json.dumps(gates)}")
    if not all(gates.values()):
        raise SystemExit(f"[ranks] gates not met: {gates}")
    NORM_ROUTES["ranks"] = res[0]["norm_routes"]
    RANK_SUMMARY.update(
        ranks=RANKS, R=R, bitwise=bitwise, limit=limit,
        per_rank=[{k: o[k] for k in ("rank", "mean_diff", "max_diff",
                                     "first_diff_step", "collective_s",
                                     "forced_s", "peak", "param_bytes")}
                  | {"ttft_p50": o["m"]["ttft_ms"]["p50"],
                     "tpot_p50": o["m"]["tpot_ms"]["p50"]} for o in res])
    return res[0]["launches"]


# ---------------------------------------------------------------------------
# phase 9: the prefix cache, copy-on-write blocks and fork at full width
# ---------------------------------------------------------------------------

PFX_SHARED, PFX_TAIL = 448, 64      # 28 shared blocks, a 64-token tail each
# phase 9 (a, b) serves pt-6b-d4 cut to 8 of its 32 layers (two of its 8
# track blocks): its gates hold warm against its own cold run, and the cut
# keeps the script inside its time limit on a slow host
PFX_LAYERS = 8
FORK_STEPS = 5                      # decode steps before the fork: pos 517
PREFIX = {}                         # the figures of phase 9, for the summary


def pt_depth_cut(cfg, params, layers: int):
    """A PT config cut to ``layers`` (whole track blocks of D layers) and
    its tree: views of the first layers / D blocks of ``params``, embed,
    head and final norm as they are.  Widths, tracks and weights stay the
    full model's."""
    from repro_torch.common.pytree import tree_map
    cut = cfg.replace(n_layers=layers)
    R = layers // cfg.pt.block_depth
    return cut, dict(params, blocks=tree_map(lambda t: t[:R],
                                             params["blocks"]))


def _prefix_prompts(vocab: int, seed: int):
    """The seed request's prompt and SLOTS prompts that share its first
    PFX_SHARED tokens, each with a tail of its own (PROMPT tokens each)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=(PFX_SHARED,)).tolist()
    tail = lambda: rng.integers(1, vocab, size=(PFX_TAIL,)).tolist()
    return shared + tail(), [shared + tail() for _ in range(SLOTS)]


def _pfx_engine(dev, cfg, params, knobs, **kw):
    """An engine of the cell's shape, warmed up (cuBLAS handles and
    heuristics, the kernels' first loads) on short random prompts and
    then on phase 9's shapes: a PROMPT-token request, then SLOTS requests
    sharing its first PFX_SHARED tokens (warm tails on an engine with the
    prefix cache, cold prompts on one without), so that no measured
    admission is the process's first call of its program and shape; its
    metrics fresh."""
    from repro_torch.serving.engine import Engine, EngineMetrics
    eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                 block_size=BLOCK, device=dev, **knobs, **kw)
    head, tails = _prefix_prompts(cfg.vocab_size, 1)
    rng = np.random.default_rng(1)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)
    eng.generate([head], 3)
    eng.generate(tails, 3)
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    return eng


def admission_busy(eng, prompts) -> Optional[float]:
    """Device busy ms (torch.profiler, CUPTI) of the engine step that
    admits ``prompts`` (its prefill or warm tails and first decode step);
    the requests then finish.  None when the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        eng.submit(p, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    eng.run()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy or None


def _measured(eng, dev, prompts, submit_kws=None):
    """Serve ``prompts`` (NEW tokens each) from a clean slate of launch
    counts, metrics and peak memory; the used blocks are read after the
    admission step.  Returns (requests, launches, summary, peak bytes,
    used blocks, runner call deltas)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineMetrics
    r = eng.runner
    eng.metrics = EngineMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    c0 = (r.prefill_calls, r.chunk_calls)
    reqs = [eng.submit(p, NEW, **kw) for p, kw in
            zip(prompts, submit_kws or [{}] * len(prompts))]
    eng.step()
    used = r.kv.utilization()["used_blocks"]
    eng.run()
    torch.cuda.synchronize()
    calls = (r.prefill_calls - c0[0], r.chunk_calls - c0[1])
    return (reqs, ops.launch_counts(), eng.metrics.summary(),
            torch.cuda.max_memory_allocated(dev), used, calls)


def _first_logits(r, prompts, matched, slots) -> torch.Tensor:
    """The logits an admission gives each prompt's last row [n, V] fp32,
    by the program the engine runs: flash prefill for a cold bf16
    prompt, the chunk program for a warm tail (tokens [matched, len) at
    their positions) and for every int8-KV prompt; the cache rows are
    written as the engine writes them."""
    from repro_torch.models.decoder import _head
    n, dev, cfg = len(prompts), r.device, r.cfg
    idx = torch.arange(n, device=dev)
    if not any(matched) and r.kv_dtype is None:
        logits, cache = r.fns["forward"](
            r.params, {"inputs": torch.as_tensor(prompts, device=dev)}, cfg,
            mode="prefill")
        r.kv.insert_prefill(cache, slots, r.kv.table_rows(slots))
        return logits[:, -1].float()
    tails = [p[m:] for p, m in zip(prompts, matched)]
    C = r.bucket_for(max(len(t) for t in tails))
    toks = torch.zeros((n, C), dtype=torch.long, device=dev)
    for i, t in enumerate(tails):
        toks[i, :len(t)] = torch.as_tensor(t, device=dev)
    last = torch.as_tensor([len(t) - 1 for t in tails], device=dev)
    h = r.fns["chunk_hidden"](
        r.params, r.cache, toks,
        torch.as_tensor(matched, dtype=torch.int32, device=dev), cfg,
        block_table=r.kv.table_rows(slots),
        slots=torch.as_tensor(slots, device=dev), chunk_lens=last + 1)
    return _head(r.params, h[idx, last], cfg).float()


def _tail_kv(r, slots, lo, hi) -> list:
    """Each pool's (and scale pool's) rows of positions [lo, hi) of
    ``slots`` through their tables, per layer: [R, D, n, len(slots),
    hi - lo, ...] copies."""
    bs = r.kv.block_size
    pos = torch.arange(lo, hi, device=r.device)
    out = []
    for leaf in r.kv.engine_cache()["blocks"]:
        for t in (leaf.pool, leaf.scale):
            if t is None:
                continue
            rows = []
            for s_ in slots:
                blk = torch.as_tensor(r.kv.table_np[s_], device=r.device)
                rows.append(t[:, :, :, blk[pos // bs], pos % bs])
            out.append(torch.stack(rows, dim=3))
    return out


def _first_diff_layer(a: list, b: list) -> Optional[tuple]:
    """(track block, layer in the block) of the first layer whose K or V
    rows (or scales) differ between two ``_tail_kv`` reads; None when
    every byte is equal."""
    R, D = a[0].shape[:2]
    for r_ in range(R):
        for j in range(D):
            if any(not torch.equal(x[r_, j], y[r_, j]) for x, y in zip(a, b)):
                return (r_, j)
    return None


def check_warm_logits(eng, prompts, cold, warm, tag: str,
                      bitwise: bool = False) -> dict:
    """Phase 9: the target's logits teacher-forced along the cold run's
    streams (the first token and T = NEW - 1 decode steps) after a warm
    admission (the first PFX_SHARED tokens matched in the prefix cache,
    the tail through the chunk program) and after a cold one (fresh
    blocks, the engine's cold admission program), on one runner; beside
    them the whole-sequence prefill over prompt + stream, the model's
    own program over the same tokens.  Reports each program's mean and
    max |logits - cold's| and argmax agreement, whether the warm and
    cold passes wrote the same K/V bytes (the tail: the first layer
    that differs; the prefix: the seed's shared blocks against the cold
    pass's), and at each stream's first divergence the cold token's
    lead over the warm one under the cold logits.
    Gates (``check_spec_logits``'s): the warm logits' mean |difference|
    from cold at most twice the prefill's, or the bf16 kernel tolerance
    times the cold logits' std where that is larger; every first
    divergence a near-tie (the cold token leads by at most twice the
    max |warm - cold| at that position).  With ``bitwise`` (bf16: the
    warm tails on flash's offset route) the tail's K/V bytes must equal
    the cold pass's and so must every decode step's logits (the first
    position's come from the LM head over the prompts' last rows alone
    in the warm program and over every row in the cold one: a GEMM of
    other rows, within the limit above)."""
    r, cfg = eng.runner, eng.runner.cfg
    n, T, dev = len(prompts), NEW - 1, r.device
    slots = list(range(n))
    act = np.ones((n,), bool)
    act_d = torch.ones((n,), dtype=torch.bool, device=dev)
    pos = np.full((n,), PROMPT, np.int32)
    pos_d = torch.as_tensor(pos, device=dev)
    toks = torch.as_tensor([c[:T] for c in cold], device=dev)
    out, kv_rows = {}, {}
    with torch.no_grad():
        for how in ("warm", "cold"):
            matched = []
            for s_, p in zip(slots, prompts):
                # a match over PFX_SHARED + 1 tokens can take the shared
                # blocks only, whatever else the runs committed since
                m = r.kv.allocate(s_, PROMPT + NEW, tokens=p[:PFX_SHARED + 1]
                                  if how == "warm" else None)
                matched.append(m)
            if matched != ([PFX_SHARED] * n if how == "warm" else [0] * n):
                raise SystemExit(f"[prefix] {tag}: {how} pass matched "
                                 f"{matched}")
            rows = [_first_logits(r, prompts, matched, slots)]
            kv_rows[how] = (_tail_kv(r, slots, PFX_SHARED, PROMPT),
                            _tail_kv(r, slots, 0, PFX_SHARED))
            for i in range(T):
                rows.append(r.fns["decode"](
                    r.params, r.cache, toks[:, i].long(), pos_d + i, cfg,
                    block_table=r._masked_table(act),
                    kv_max_len=r._live_max_len(pos + i, act),
                    active=act_d)[0].float())
            out[how] = torch.stack(rows, dim=1)                # [n, T+1, V]
            for s_ in slots:
                r.kv.free_slot(s_)
        seq = torch.cat([torch.as_tensor(prompts, device=dev), toks], dim=1)
        out["prefill"] = r.fns["forward"](r.params, {"inputs": seq}, cfg,
                                          mode="prefill")[0][
            :, PROMPT - 1:PROMPT + T].float()
    r.kv.check_invariants()
    c = out["cold"]
    stat = {}
    for name in ("warm", "prefill"):
        diff = (out[name] - c).abs()
        stat[name] = (diff.mean().item(), diff.max().item(),
                      int((out[name].argmax(-1) == c.argmax(-1)).sum()))
    tail_diff = _first_diff_layer(kv_rows["warm"][0], kv_rows["cold"][0])
    prefix_same = _first_diff_layer(kv_rows["warm"][1],
                                    kv_rows["cold"][1]) is None
    log(f"[prefix] {tag}: logits teacher-forced along the cold streams "
        f"({n} x {T + 1} positions): cold logit std {c.std().item():.4f}")
    for name, (mean, mx, agree) in stat.items():
        log(f"[prefix] {tag}:   {name} vs cold: mean |diff| {mean:.4e}, "
            f"max {mx:.4e}, argmax equal {agree}/{n * (T + 1)}")
    log(f"[prefix] {tag}:   K/V bytes, warm pass against cold pass: the "
        f"tail's first differing layer (track block, layer) {tail_diff} "
        f"(None: all equal); the prefix (the seed's shared blocks against "
        f"the cold pass's own) bitwise equal: {prefix_same}")
    bad = []
    for b, (w, cs) in enumerate(zip(warm, cold)):
        i = _divergence(w, cs)
        if i < 0 or i > T or i >= min(len(w), len(cs)):
            log(f"[prefix] {tag}:   request {b}: first divergence {i} "
                f"(-1: none)")
            continue
        g = (c[b, i, cs[i]] - c[b, i, w[i]]).item()
        dmax = (out["warm"][b, i] - c[b, i]).abs().max().item()
        log(f"[prefix] {tag}:   request {b}: diverges at {i} (cold {cs[i]}, "
            f"warm {w[i]}): cold gap {g:.4e}, max |warm - cold| there "
            f"{dmax:.4e}")
        if g > 2 * dmax:
            bad.append(b)
    limit = max(2 * stat["prefill"][0], KERNEL_TOL * c.std().item())
    gates = {"warm": stat["warm"][0] <= limit, "near-ties": not bad}
    if bitwise:
        gates["warm decode logits bitwise cold"] = torch.equal(
            out["warm"][:, 1:], c[:, 1:])
        gates["tail K/V bitwise cold"] = tail_diff is None
    log(f"[prefix] {tag}: logit gates {json.dumps(gates)} (limit "
        f"{limit:.4e})")
    if not all(gates.values()):
        raise SystemExit(f"[prefix] {tag}: logit gates {gates} (requests "
                         f"whose divergence is no near-tie: {bad})")
    return {"warm_mean_abs": stat["warm"][0], "warm_max_abs": stat["warm"][1],
            "prefill_mean_abs": stat["prefill"][0], "limit": limit,
            "tail_kv_first_diff": tail_diff, "prefix_kv_bitwise": prefix_same}


def probe_rows(dev, cfg, int8: bool) -> dict:
    """Phase 9: which ops of the chunk program give a row bits that depend
    on how many rows share the call.  The tail rows [PFX_SHARED, PROMPT)
    of SLOTS prompts, computed inside a whole-prompt call and in a
    tail-only call, at pt-6b-d4's shapes on random inputs: the q
    projection (W8A16 with ``int8``, else the bf16 product), then the
    chunk attention's pieces as the int8 pool's chunk program computes
    them (``models.attention._masked_ctx``: scores, softmax, P V; over
    fp32 K/V, as an int8 pool reads, or bf16).  True where the tail rows are bitwise equal."""
    from repro_torch.common.quant import matmul, quantize
    g = torch.Generator(device=dev).manual_seed(5)
    n, H, KH, hd = cfg.pt.n_tracks, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t0, B, C = PFX_SHARED, SLOTS, PROMPT
    S = -(-(PROMPT + NEW + 8) // BLOCK) * BLOCK
    bf = torch.bfloat16
    x = torch.randn(n, B, C, cfg.d_model, generator=g, device=dev, dtype=bf)
    w = torch.randn(n, cfg.d_model, H * hd, generator=g, device=dev,
                    dtype=bf)
    if int8:
        w = quantize(w, axes=(-2,))
    res = {"q projection": torch.equal(
        matmul(x, w)[:, :, t0:], matmul(x[:, :, t0:].contiguous(), w))}
    rd = torch.float32 if int8 else bf
    q = torch.randn(n, B, C, H, hd, generator=g, device=dev, dtype=bf)
    k, v = (torch.randn(n, B, S, KH, hd, generator=g, device=dev).to(rd)
            for _ in range(2))

    def pieces(q, positions):
        qg = (q * hd ** -0.5).to(rd).reshape(*q.shape[:3], KH, H // KH, hd)
        sc = torch.einsum("nbckgd,nbskd->nbckgs", qg.float(), k.float())
        mask = torch.arange(S, device=dev)[None, None] <= positions[:, :,
                                                                    None]
        p = sc.masked_fill(~mask[None, :, :, None, None], -1e30)
        p = (p - p.amax(dim=-1, keepdim=True)).exp()
        p = p / p.sum(dim=-1, keepdim=True)
        ctx = torch.einsum("nbckgs,nbskd->nbckgd", p.to(rd).float(),
                           v.float())
        return sc, p, ctx

    pos = torch.arange(C, device=dev)[None].expand(B, C)
    whole = pieces(q, pos)
    part = pieces(q[:, :, t0:], pos[:, t0:])
    for name, a, b in zip(("scores", "softmax", "P V"), whole, part):
        res[name] = torch.equal(a[:, :, t0:], b)
    del whole, part
    torch.cuda.empty_cache()
    return res


def prefix_hit(dev, card: str, params, tag: str, int8: bool = False) -> None:
    """Phase 9 (a), (b with ``int8``): pt-6b-d4 cut to PFX_LAYERS of its
    layers (``pt_depth_cut``) on phase 5's seeded tree, SLOTS slots,
    capacity PROMPT + NEW + 8, block BLOCK.  A cold engine
    (``prefix_cache=False``) serves SLOTS prompts that share their first
    PFX_SHARED tokens; a prefix-cache engine serves a seed request (the
    shared prefix and a tail of its own) and then the same SLOTS prompts,
    submitted together.  Gates: every ``cached_prefix`` is PFX_SHARED,
    ``prefix_hit_tokens`` SLOTS x PFX_SHARED; bf16: flash prefill runs in
    the seed's cold call (one launch a layer), the warm tails take one
    chunk call and no prefill call, its attention the flash kernel's
    offset route (one launch a layer, on ``wgmma_tma``), and every warm
    stream is bitwise its cold one; int8: one chunk call each, no flash;
    ``check_invariants``; ``check_warm_logits``.  Reports TTFT p50 / p90
    warm against cold, the admission step's device busy ms, used blocks
    after admission, peak memory, and whether the streams are bitwise
    the cold ones."""
    from repro_torch.configs import get_config
    cfg, params = pt_depth_cut(get_config(ARCH), params, PFX_LAYERS)
    L = cfg.n_layers
    knobs = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    log(f"[prefix] {tag}: {ARCH} cut to {L} of its "
        f"{get_config(ARCH).n_layers} layers, widths as published")
    seed, prompts = _prefix_prompts(cfg.vocab_size, 9)
    _, probe = _prefix_prompts(cfg.vocab_size, 10)     # the busy-time probe
    probe = [seed[:PFX_SHARED] + p[PFX_SHARED:] for p in probe]
    fig = {}
    for how in ("cold", "warm"):
        eng = _pfx_engine(dev, cfg, params, knobs,
                          prefix_cache=how == "warm")
        r = eng.runner
        if how == "warm":
            _, launches, _, _, _, calls = _measured(eng, dev, [seed])
            want = ({"flash_attention": 0} if int8
                    else {"flash_attention": L})
            log(f"[prefix] {tag}: seed request: calls (prefill, chunk) "
                f"{calls}, flash_attention {launches['flash_attention']}")
            if launches["flash_attention"] != want["flash_attention"] \
                    or calls != ((0, 1) if int8 else (1, 0)):
                raise SystemExit(f"[prefix] {tag}: the seed's admission "
                                 f"ran {calls} calls, {launches}")
            hits0 = r.kv.prefix_hit_tokens
        t0 = time.perf_counter()
        reqs, launches, m, peak, used, calls = _measured(eng, dev, prompts)
        wall = time.perf_counter() - t0
        from repro_torch.kernels import ops
        flash_routes = dict(ops.flash_attention.routes)
        streams = [q.output for q in reqs]
        if how == "warm":
            hits = r.kv.prefix_hit_tokens - hits0
        busy = admission_busy(eng, probe)
        fig[how] = {"ttft_p50_ms": m["ttft_ms"]["p50"],
                    "ttft_p90_ms": m["ttft_ms"]["p90"],
                    "tpot_p50_ms": m["tpot_ms"]["p50"],
                    "admission_busy_ms": busy, "used_blocks": used,
                    "peak_gb": peak / 1e9, "calls": calls, "wall_s": wall,
                    "launches": launches, "flash_routes": flash_routes}
        log(f"[prefix] {card} | {tag} {how}: {SLOTS} reqs x ({PROMPT} in "
            f"/ {NEW} out), wall {wall:.3f}s; TTFT ms p50 "
            f"{m['ttft_ms']['p50']:.2f} p90 {m['ttft_ms']['p90']:.2f}; TPOT "
            f"ms p50 {m['tpot_ms']['p50']:.3f}; admission step device busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}; used "
            f"blocks after admission {used}; peak memory {peak / 1e9:.3f} "
            f"GB; calls (prefill, chunk) {calls}; launches "
            f"{json.dumps(launches)}")
        if not all(q.state.value == "done" and len(q.output) == NEW
                   for q in reqs):
            raise SystemExit(f"[prefix] {tag} {how}: not every request "
                             "finished")
        if how == "cold":
            cold = streams
            del eng, r
            gc.collect()
            torch.cuda.empty_cache()
            continue
        cached = [q.cached_prefix for q in reqs]
        same = sum(w == c for w, c in zip(streams, cold))
        gates = {"cached_prefix": cached == [PFX_SHARED] * SLOTS,
                 "hit_tokens": hits == SLOTS * PFX_SHARED,
                 "calls": calls == (0, 1)}
        if int8:
            gates["no flash"] = launches["flash_attention"] == 0
        else:
            # the warm tails' one chunk call: one flash launch a layer, on
            # the offset route, and every stream bitwise the cold one
            gates["flash offset route"] = (
                launches["flash_attention"] == L and flash_routes == dict(
                    dict.fromkeys(flash_routes, 0), wgmma_tma=L))
            gates["streams bitwise cold"] = same == SLOTS
        r.kv.check_invariants()
        div = [_divergence(w, c) for w, c in zip(streams, cold)]
        log(f"[prefix] {tag}: cached_prefix {cached}, prefix_hit_tokens "
            f"{hits}; streams bitwise the cold run's {same}/{SLOTS} (first "
            f"divergence per request: {div}); gates {json.dumps(gates)}")
        if not all(gates.values()):
            raise SystemExit(f"[prefix] {tag}: gates {gates}")
        fig["logits"] = check_warm_logits(eng, prompts, cold, streams, tag,
                                          bitwise=not int8)
        fig["rows_bitwise"] = probe_rows(dev, cfg, int8)
        log(f"[prefix] {tag}: tail rows bitwise between a whole-prompt call "
            f"and a tail-only call, by op: {json.dumps(fig['rows_bitwise'])}")
        fig.update(streams_bitwise_cold=same, first_divergence=div,
                   hit_tokens=hits)
        del eng, r
        gc.collect()
        torch.cuda.empty_cache()
    w, c = fig["warm"], fig["cold"]
    log(f"[prefix] {card} | {tag}: warm / cold TTFT p50 "
        f"{w['ttft_p50_ms'] / c['ttft_p50_ms']:.4f}, p90 "
        f"{w['ttft_p90_ms'] / c['ttft_p90_ms']:.4f}; used blocks "
        f"{w['used_blocks']} / {c['used_blocks']}")
    PREFIX[tag] = fig


def _fork_run(eng, prompt, n, submit_kw) -> tuple:
    """One request, FORK_STEPS decode steps after its first token (the
    steps in flight of a pipelined engine counted), then a fork into
    ``n`` children and the rest of the run.  Returns (parent, children,
    figures)."""
    r = eng.runner
    req = eng.submit(prompt, NEW, **submit_kw)
    while len(req.output) + len(eng._inflight) < FORK_STEPS + 1:
        eng.step()
    kids = eng.fork(req, n)
    if len(req.output) != FORK_STEPS + 1:
        raise SystemExit(f"[prefix] fork after {len(req.output)} tokens")
    pslot = next(s_ for s_, q in eng.scheduler.active_slots() if q is req)
    fig = {"used_after_fork": r.kv.utilization()["used_blocks"],
           "committed": r.kv.committed(pslot)}
    eng.step()
    fig["used_after_cow"] = r.kv.utilization()["used_blocks"]
    eng.run()
    fig["cow_copies"] = r.kv.cow_copies
    r.kv.check_invariants()
    return req, kids, fig


def fork_runs(dev, card: str, params) -> None:
    """Phase 9 (c), (d): pt-6b-d4 bf16 on phase 5's seeded tree.  (c) one
    PROMPT-token greedy request, FORK_STEPS decode steps after its first
    token (position 517, inside the partial block 32, which the children
    share), forked three ways.  Gates: the children's streams bitwise
    the parent's; exactly 3 copy-on-write copies (the parent's and two
    children's writes to block 32; the last holder writes in place);
    used blocks after the fork 33 shared + ``fork_cost`` (3 at a
    575-token reservation) fresh per holder, 3 more after the copies.
    (d) the same request sampled (SAMPLED, seed 0) forked four ways
    (seeds ``fork_seeds``), sync and then on ``Engine(pipeline_depth=1)``
    with the sampled step programs of its live lengths planned.  Gates: every planned step a
    replay, the planned streams bitwise the sync run's, the children's
    streams pairwise distinct, 4 copies."""
    from repro_torch.configs import get_config
    from repro_torch.serving.sampler import SampleParams, fork_seeds
    cfg = get_config(ARCH)
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, cfg.vocab_size, size=(PROMPT,)).tolist()
    eng = _pfx_engine(dev, cfg, params, {})
    kv = eng.runner.kv
    reserve = PROMPT + NEW - 1
    t0 = time.perf_counter()
    req, kids, fig = _fork_run(eng, prompt, 3, {})
    wall = time.perf_counter() - t0
    shared = kv.blocks_for(PROMPT + FORK_STEPS)
    cost = kv.blocks_for(reserve) - shared
    want = {"committed": PROMPT + FORK_STEPS,
            "used_after_fork": shared + 4 * cost,
            "used_after_cow": shared + 4 * cost + 3, "cow_copies": 3}
    got = {k: fig[k] for k in want}
    bitwise = all(k.output == req.output for k in kids)
    log(f"[prefix] {card} | greedy fork: 1 request of {PROMPT} tokens, "
        f"forked 3 ways after {FORK_STEPS} decode steps, wall {wall:.3f}s; "
        f"{json.dumps(got)} (want {json.dumps(want)}: 33 shared blocks, "
        f"fork_cost {cost}); children bitwise the parent: {bitwise}")
    PREFIX["greedy fork"] = dict(got, children_bitwise_parent=bitwise,
                                 fork_cost=cost)
    if got != want or not bitwise or len(req.output) != NEW:
        raise SystemExit(f"[prefix] greedy fork: {got} != {want} or "
                         f"children differ ({bitwise})")
    del eng, kv
    gc.collect()
    torch.cuda.empty_cache()
    sp = {"params": SampleParams(**SAMPLED), "seed": 0}
    out = {}
    for how in ("sync", "planned"):
        kw = {"pipeline_depth": 1} if how == "planned" else {}
        eng = _pfx_engine(dev, cfg, params, {}, **kw)
        r = eng.runner
        if how == "planned":
            t0 = time.perf_counter()
            r.plan_programs(sampled=(True,),
                            lengths=range(PROMPT, PROMPT + NEW + 1))
            plan_s = time.perf_counter() - t0
            hits0, steps0 = r.planned_hits, r.decode_transfers
        req, kids, fig = _fork_run(eng, prompt, 4, sp)
        out[how] = [req.output] + [k.output for k in kids]
        seeds = [k.seed for k in kids]
        if how == "planned":
            replays = (r.planned_hits - hits0, r.decode_transfers - steps0)
            fig.update(replays=replays, graphs=len(r.programs),
                       capture_s=plan_s)
        log(f"[prefix] {card} | sampled fork, {how}: seeds {seeds}; "
            f"{json.dumps(fig)}")
        if seeds != fork_seeds(0, 4) or fig["cow_copies"] != 4:
            raise SystemExit(f"[prefix] sampled fork {how}: seeds {seeds}, "
                             f"{fig['cow_copies']} copies")
        del eng, r
        gc.collect()
        torch.cuda.empty_cache()
    kids = out["sync"][1:]
    gates = {"replays": replays[0] == replays[1] > 0,
             "planned_bitwise_sync": out["planned"] == out["sync"],
             "children_distinct": len({tuple(k) for k in kids}) == len(kids)}
    log(f"[prefix] sampled fork: gates {json.dumps(gates)}")
    PREFIX["sampled fork"] = gates
    if not all(gates.values()):
        raise SystemExit(f"[prefix] sampled fork: gates {gates}")


def prefix_spec(dev, card: str, params) -> None:
    """Phase 9 (e), on the tied tree (run (b)'s, so that the speculative
    runs take seconds, not minutes): (a)'s warm hit with
    speculate_k=SPEC_K, draft_tracks=SPEC_TRACKS, sync and then on
    ``Engine(pipeline_depth=1)`` with the greedy step programs of the
    run's live lengths planned.
    The drafter has no prefix cache: the warm round fills its rows for
    every warm slot from position 0, in one batched narrow forward.
    Gates: every ``cached_prefix`` PFX_SHARED, the drafter filled for
    the SLOTS warm slots in one call of (SLOTS, the prompts' bucket),
    every planned
    step a replay, the planned streams bitwise the sync run's."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    seed, prompts = _prefix_prompts(cfg.vocab_size, 9)
    knobs = dict(speculate_k=SPEC_K, draft_tracks=SPEC_TRACKS)
    out = {}
    for how in ("sync", "planned"):
        kw = {"pipeline_depth": 1} if how == "planned" else {}
        eng = _pfx_engine(dev, cfg, params, knobs, **kw)
        r = eng.runner
        if how == "planned":
            t0 = time.perf_counter()
            r.plan_programs(sampled=(False,),
                            lengths=range(PROMPT, PROMPT + NEW + 1))
            plan_s = time.perf_counter() - t0
            hits0, steps0 = r.planned_hits, r.decode_transfers
        eng.generate([seed], NEW)
        r.draft_prefill_shapes.clear()
        reqs, launches, m, peak, used, calls = _measured(eng, dev, prompts)
        out[how] = [q.output for q in reqs]
        cached = [q.cached_prefix for q in reqs]
        fig = {"cached_prefix_ok": cached == [PFX_SHARED] * SLOTS,
               "drafter_fills": sorted(r.draft_prefill_shapes),
               "calls": calls, "ttft_p50_ms": m["ttft_ms"]["p50"],
               "tpot_p50_ms": m["tpot_ms"]["p50"],
               "acceptance": m["acceptance_rate"], "used_blocks": used}
        if how == "planned":
            fig.update(replays=(r.planned_hits - hits0,
                                r.decode_transfers - steps0),
                       graphs=len(r.programs), capture_s=plan_s)
        log(f"[prefix] {card} | spec warm hit, {how}: {json.dumps(fig)}")
        r.kv.check_invariants()
        if not fig["cached_prefix_ok"] or fig["drafter_fills"] != [
                (SLOTS, r.bucket_for(PROMPT))] or calls != (0, 1):
            raise SystemExit(f"[prefix] spec warm hit {how}: {fig}")
        if how == "planned" and not fig["replays"][0] == \
                fig["replays"][1] > 0:
            raise SystemExit(f"[prefix] spec warm hit: not every step a "
                             f"replay {fig['replays']}")
        PREFIX[f"spec warm hit {how}"] = fig
        del eng, r
        gc.collect()
        torch.cuda.empty_cache()
    same = out["planned"] == out["sync"]
    log(f"[prefix] spec warm hit: planned streams bitwise the sync run's: "
        f"{same}")
    if not same:
        raise SystemExit("[prefix] spec warm hit: planned streams differ")


# ---------------------------------------------------------------------------
# phase 10: the robustness layer at full width
# ---------------------------------------------------------------------------

HALF = SLOTS // 2
# a pool that holds HALF requests of PROMPT + NEW - 1 positions (and a
# few blocks more): the second half's admissions must preempt
ROBUST_BLOCKS = HALF * -(-(PROMPT + NEW - 1) // BLOCK) + 4
SPEC_NEW = 16                       # tokens of the speculative fault runs
ROBUST = {}                         # the figures of phase 10, for the summary


def _robust_engine(dev, cfg, params, knobs=None, **kw):
    from repro_torch.serving.engine import Engine
    return Engine(cfg, params, max_slots=SLOTS, max_seq_len=PROMPT + NEW + 8,
                  block_size=BLOCK, device=dev, **(knobs or {}), **kw)


def _free() -> None:
    """Return the memory of the engines the caller has just dropped."""
    gc.collect()
    torch.cuda.empty_cache()


def teacher_forced_from(r, prompts, streams, starts, together: bool
                        ) -> torch.Tensor:
    """Phase 10: logits [n, NEW, V] fp32 teacher-forced along ``streams``:
    row b is admitted with its prompt and the first ``starts[b]`` tokens
    of its stream (the program the engine admits it with,
    ``_first_logits``: flash prefill, or the chunk program for int8 KV;
    all rows in one call with ``together``, else one call a row, as a
    resume or a lone admission runs), which gives its logits at index
    starts[b]; decode steps along the stream give the rest.  Entries
    before starts[b] are NaN."""
    n, cfg, dev = len(prompts), r.cfg, r.device
    slots = list(range(n))
    out = torch.full((n, NEW, cfg.vocab_size), float("nan"), device=dev)
    seqs = [p + s[:m] for p, s, m in zip(prompts, streams, starts)]
    with torch.no_grad():
        for s_ in slots:
            r.kv.allocate(s_, PROMPT + NEW)
        if together:
            first = _first_logits(r, seqs, [0] * n, slots)
        else:
            first = torch.cat([_first_logits(r, [q], [0], [s_])
                               for s_, q in zip(slots, seqs)])
        for b in slots:
            out[b, starts[b]] = first[b]
        P = len(prompts[0])
        for step in range(1, NEW):
            j = np.asarray(starts) + step          # the index each row makes
            act = j <= NEW - 1
            if not act.any():
                break
            tok = torch.as_tensor([s[min(jj, NEW - 1) - 1]
                                   for s, jj in zip(streams, j)], device=dev)
            pos = (P + j - 1).astype(np.int32)
            lg = r.fns["decode"](
                r.params, r.cache, tok.long(),
                torch.as_tensor(pos, device=dev), cfg,
                block_table=r._masked_table(act),
                kv_max_len=r._live_max_len(pos, act),
                active=torch.as_tensor(act, device=dev))[0].float()
            for b in np.flatnonzero(act):
                out[b, j[b]] = lg[b]
        for s_ in slots:
            r.kv.free_slot(s_)
    r.kv.check_invariants()
    return out


def check_resume_logits(eng, prompts, ref, got, starts, tag: str) -> dict:
    """Phase 10: the streams of a preemption run against the uncontended
    run's (``ref``), by the logits teacher-forced along ``ref``: C, the
    uncontended run's program (every prompt in one admission call, then
    decode); S, each prompt admitted alone (the contended run admits one
    at a time); X, each request admitted, as its resume is, with its
    prompt and the ``starts[b]`` tokens it had emitted when it was last
    preempted (0 for the others); W, the whole-sequence prefill.
    Reports mean and max |S - C| and |X - C| (X from its resume point
    on) beside |W - C| and C's std, and at each stream's first
    divergence from ``ref`` the ref token's lead over the run's under C.
    Gates (``check_spec_logits``'s): S's and X's mean |difference| from C
    at most twice W's, or the bf16 kernel tolerance times C's std where
    that is larger; every first divergence a near-tie: the lead at most
    twice max |Y - C| at that position, Y the pass of the program that
    made the token (X at or past the resume point, else S)."""
    r, cfg = eng.runner, eng.runner.cfg
    n, dev = len(prompts), eng.runner.device
    C = teacher_forced_from(r, prompts, ref, [0] * n, together=True)
    S = teacher_forced_from(r, prompts, ref, [0] * n, together=False)
    X = teacher_forced_from(r, prompts, ref, starts, together=False)
    with torch.no_grad():
        seq = torch.as_tensor([p + s[:NEW - 1] for p, s in zip(prompts, ref)],
                              device=dev)
        W = r.fns["forward"](r.params, {"inputs": seq}, cfg,
                             mode="prefill")[0][:, PROMPT - 1:].float()
    live = torch.as_tensor([[j >= m for j in range(NEW)] for m in starts],
                           device=dev)
    stat = {}
    for name, Y, mask in (("S", S, None), ("X", X, live), ("W", W, None)):
        d = (Y - C).abs()
        if mask is not None:
            d = d[mask]
        stat[name] = (d.mean().item(), d.max().item())
    replay = int((C.argmax(-1) == torch.as_tensor(ref, device=dev)).sum())
    log(f"[robust] {tag}: logits teacher-forced along the uncontended "
        f"streams ({n} x {NEW}): C replays them at {replay}/{n * NEW} "
        f"tokens, C's std {C.std().item():.4f}; mean / max |Y - C|: "
        + ", ".join(f"{k} {m_:.4e} / {x_:.4e}" for k, (m_, x_)
                    in stat.items()))
    bad = []
    for b, (g_, w_) in enumerate(zip(got, ref)):
        i = _divergence(g_, w_)
        if i < 0 or i >= min(len(g_), len(w_)):
            continue
        Y = X if i >= starts[b] else S
        lead = (C[b, i, w_[i]] - C[b, i, g_[i]]).item()
        dmax = (Y[b, i] - C[b, i]).abs().max().item()
        log(f"[robust] {tag}:   request {b}: diverges at {i} (resume point "
            f"{starts[b]}; uncontended {w_[i]}, run {g_[i]}): lead under C "
            f"{lead:.4e}, max |{'X' if Y is X else 'S'} - C| there "
            f"{dmax:.4e}")
        if lead > 2 * dmax:
            bad.append(b)
    limit = max(2 * stat["W"][0], KERNEL_TOL * C.std().item())
    gates = {"S": stat["S"][0] <= limit, "X": stat["X"][0] <= limit,
             "near-ties": not bad}
    log(f"[robust] {tag}: logit gates {json.dumps(gates)} (limit "
        f"{limit:.4e})")
    if not all(gates.values()):
        raise SystemExit(f"[robust] {tag}: logit gates {gates} (requests "
                         f"whose divergence is no near-tie: {bad})")
    return {k: v[0] for k, v in stat.items()} | {"limit": limit}


def _step_busy(eng) -> Optional[float]:
    """One engine step under torch.profiler (CUPTI): its device busy ms,
    None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy or None


def robust_preempt(dev, card: str, params, prompts, ref, tag: str,
                   int8: bool = False) -> None:
    """Phase 10 (a), (b with ``int8``): pt-6b-d4 on phase 5's seeded tree,
    SLOTS slots, block BLOCK, a pool of ROBUST_BLOCKS blocks (HALF
    requests fit), the prefix cache on.  HALF priority-0 requests (phase
    5's first prompts) are admitted and decode; then HALF priority-1
    requests arrive, and each admission preempts a decoder; the victims
    resume when the pool frees.  ``ref``: the uncontended streams
    (phase 5's bf16 run; for int8 an uncontended int8 run made here, all
    prompts in one admission, as phase 5's).  Gates: every request DONE
    with NEW tokens, preemptions >= 1 and resumes equal to them, the
    invariants, 0 used blocks at the end, ``check_resume_logits``.
    Reports the streams bitwise the uncontended ones (for int8 whether
    the resumed ones are), TTFT and TPOT p50 by priority, the device
    busy ms of the step that admits the first resume, the cached prefix
    of each resume."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineMetrics
    cfg = get_config(ARCH)
    knobs = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    t0 = time.perf_counter()
    # an uncontended engine (the whole pool, phase 5's admission): the
    # int8 reference streams, and the teacher-forced logits afterwards
    check = _robust_engine(dev, cfg, params, knobs, prefix_cache=False)
    if ref is None:
        ref = check.generate(prompts, NEW)
    eng = _robust_engine(dev, cfg, params, knobs, num_blocks=ROBUST_BLOCKS)
    rng = np.random.default_rng(1)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(SLOTS)], 3)                 # warm-up
    eng.metrics = EngineMetrics()
    r = eng.runner
    starts = {}

    def on_event(q, why):
        if why.startswith("preempted"):
            starts[q.rid] = len(q.output)

    low = [eng.submit(p, NEW, priority=0, on_event=on_event)
           for p in prompts[:HALF]]
    while any(q.state.value != "decode" for q in low):
        eng.step()
    eng.step()
    high = [eng.submit(p, NEW, priority=1, on_event=on_event)
            for p in prompts[HALF:]]
    busy, resumed_then, step_s = None, None, {True: [], False: []}
    while eng.scheduler.has_work() or eng._inflight:
        q = eng.scheduler.queue
        if (resumed_then is None and q and q[0].output
                and eng.scheduler.free_slots()
                and eng._make_can_fit()(q[0])):
            m0 = eng.metrics.resumes                   # the first resume
            busy = _step_busy(eng)
            resumed_then = eng.metrics.resumes - m0
        else:
            waiting = bool(q)
            t1 = time.perf_counter()
            eng.step()
            step_s[waiting].append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = low + high
    got = [q.output for q in reqs]
    m = eng.metrics.summary()
    r.kv.check_invariants()
    used = r.kv.utilization()["used_blocks"]
    pct = lambda xs: float(np.percentile(np.asarray(xs) * 1e3, 50))
    resumed = [b for b, q in enumerate(reqs) if q.preemptions]
    same = [g_ == w_ for g_, w_ in zip(got, ref)]
    fig = {"preemptions": m["preemptions"], "resumes": m["resumes"],
           "preempted": [q.preemptions for q in reqs],
           "resume_points": [starts.get(q.rid, 0) for q in reqs],
           "resume_cached_prefix": [reqs[b].cached_prefix for b in resumed],
           "ttft_p50_ms": {p_: pct([q.ttft for q in g]) for p_, g
                           in (("priority 0", low), ("priority 1", high))},
           "tpot_p50_ms": {p_: pct([q.tpot for q in g]) for p_, g
                           in (("priority 0", low), ("priority 1", high))},
           "resume_admission_busy_ms": busy,
           "resumed_in_that_step": resumed_then,
           "step_ms_p50": {k: pct(v) if v else None for k, v in
                           (("queue waiting", step_s[True]),
                            ("queue empty", step_s[False]))},
           "used_blocks_end": used,
           "bitwise_uncontended": sum(same),
           "resumed_bitwise": [same[b] for b in resumed],
           "first_divergence": [_divergence(g_, w_)
                                for g_, w_ in zip(got, ref)],
           "pool_blocks": ROBUST_BLOCKS, "wall_s": wall}
    gates = {"done": all(q.state.value == "done" and len(q.output) == NEW
                         for q in reqs),
             "preempted": m["preemptions"] >= 1,
             "resumes == preemptions": m["resumes"] == m["preemptions"],
             "used blocks 0": used == 0}
    log(f"[robust] {card} | {tag}: {HALF} priority-0 then {SLOTS - HALF} "
        f"priority-1 requests of ({PROMPT} in / {NEW} out) on "
        f"{ROBUST_BLOCKS} blocks: {json.dumps(fig)}; gates "
        f"{json.dumps(gates)}")
    if not all(gates.values()):
        raise SystemExit(f"[robust] {tag}: gates {gates}")
    del eng, r
    _free()
    fig["logits"] = check_resume_logits(
        check, prompts, ref, got, [starts.get(q.rid, 0) for q in reqs], tag)
    ROBUST[tag] = fig
    del check
    _free()


def _fault_run(dev, cfg, params, prompts, new, plan, knobs,
               plan_lengths=None) -> tuple:
    """One run of ``prompts`` (``new`` tokens each) under ``plan``, the
    prefix cache off (phase 5's admission program); with
    ``plan_lengths`` pipelined (depth 1) with the greedy step programs of
    those live lengths planned.  Returns (streams, figures)."""
    kw = {"pipeline_depth": 1} if plan_lengths else {}
    eng = _robust_engine(dev, cfg, params, knobs, prefix_cache=False,
                         fault_plan=plan, **kw)
    r = eng.runner
    if plan_lengths:
        r.plan_programs(sampled=(False,), lengths=plan_lengths)
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    r.kv.check_invariants()
    fig = {"done": all(q.state.value == "done" for q in reqs),
           "transfer_faults": eng.metrics.transfer_faults,
           "sites": sorted({lbl for _, lbl in plan.transfer_sites})
           if plan else [],
           "steps": eng.steps_run, "transfers": r.decode_transfers,
           "replays": r.planned_hits,
           "stages_busy": sum(st.busy for st in r._stages),
           "used_blocks_end": r.kv.utilization()["used_blocks"]}
    out = [q.output for q in reqs]
    del eng, r
    _free()
    return out, fig


def robust_faults(dev, card: str, params, prompts, ref) -> None:
    """Phase 10 (c): transfer faults (``FaultPlan(transfer_ops=...)``) on
    phase 5's seeded tree, the prefix cache off.  Plain decode, sync and
    pipelined with the programs of the run's live lengths planned, on
    phase 5's prompts against phase 5's streams (``ref``; planned equals
    sync bitwise); then the speculative arm (K SPEC_K of SPEC_TRACKS
    tracks) on two prompts, SPEC_NEW tokens, sync and planned, against
    its fault-free sync run.  Gates: the faulted streams bitwise the
    fault-free ones; the faults fired at the prefill, decode and
    draft_verify waits (never at a dispatch); no staging slot left busy;
    every planned step a replay; 0 used blocks at the end."""
    from repro_torch.configs import get_config
    from repro_torch.serving.faults import FaultPlan
    cfg = get_config(ARCH)
    lengths = range(PROMPT, PROMPT + NEW + 1)
    spec = dict(speculate_k=SPEC_K, draft_tracks=SPEC_TRACKS)
    runs = {}
    for name, ps, want, knobs, ops_, planned in (
            ("plain sync", prompts, ref, {},
             {0, 3, NEW // 4 + 1, NEW // 2 + 8}, None),
            ("plain planned", prompts, ref, {},
             {0, 5, NEW // 3 + 2, NEW // 2 + 9}, lengths),
            ("spec sync", prompts[:2], None, spec, {0, 2, 4}, None),
            ("spec planned", prompts[:2], None, spec, {0, 3, 4},
             lengths)):
        new = NEW if not knobs else SPEC_NEW
        if want is None:
            want = runs.get("spec control")
            if want is None:
                want, _ = _fault_run(dev, cfg, params, ps, new, None, knobs)
                runs["spec control"] = want
        plan = FaultPlan(transfer_ops=frozenset(ops_))
        got, fig = _fault_run(dev, cfg, params, ps, new, plan, knobs,
                              planned)
        site = "draft_verify" if knobs else "decode"
        gates = {"done": fig["done"], "bitwise": got == want,
                 "faults": fig["transfer_faults"] == len(ops_),
                 "sites": fig["sites"] == sorted({"prefill", site}),
                 "no stage busy": fig["stages_busy"] == 0,
                 "used blocks 0": fig["used_blocks_end"] == 0}
        if planned:
            gates["every step a replay"] = (fig["replays"]
                                            == fig["transfers"] > 0)
        log(f"[robust] {card} | transfer faults, {name}: ops {sorted(ops_)}"
            f"; {json.dumps(fig)}; gates {json.dumps(gates)}")
        ROBUST[f"faults {name}"] = dict(fig, gates=gates)
        if not all(gates.values()):
            raise SystemExit(f"[robust] transfer faults {name}: {gates}")


def robust_cancel_deadline(dev, card: str, params, prompts, ref) -> None:
    """Phase 10 (d): phase 5's prompts and admission (prefix cache off),
    request 0 cancelled from its own ``on_token`` after 5 tokens,
    request 1 admitted with a 600 s deadline that its ``on_token`` cuts
    to the time spent at its 10th token (it times out at the next
    step's check).  Gates: the two end CANCELLED with 5 tokens and
    TIMED_OUT with 10, each a prefix of the uncontended stream, the
    others DONE and bitwise phase 5's, the invariants, 0 used blocks at
    the end."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    eng = _robust_engine(dev, cfg, params, prefix_cache=False)
    events = []

    def stop(q, tok):
        if len(q.output) >= 5:
            eng.cancel(q, "client disconnected")

    def late(q, tok):
        # the budget shrinks to the time already spent: the next step's
        # deadline check expires the request mid-decode
        if len(q.output) == 10:
            q.deadline_s = time.perf_counter() - q.t_submit

    reqs = [eng.submit(prompts[0], NEW, on_token=stop,
                       on_event=lambda q, why: events.append((q.rid, why))),
            eng.submit(prompts[1], NEW, on_token=late, deadline_s=600.0,
                       on_event=lambda q, why: events.append((q.rid, why)))]
    reqs += [eng.submit(p, NEW) for p in prompts[2:]]
    eng.run()
    torch.cuda.synchronize()
    r = eng.runner
    r.kv.check_invariants()
    got = [q.output for q in reqs]
    used = r.kv.utilization()["used_blocks"]
    gates = {"cancelled": (reqs[0].state.value == "cancelled"
                           and got[0] == ref[0][:5]),
             "timed out": (reqs[1].state.value == "timed_out"
                           and got[1] == ref[1][:10]),
             "others bitwise": got[2:] == ref[2:],
             "used blocks 0": used == 0}
    fig = {"events": events, "lengths": [len(g_) for g_ in got[:2]],
           "used_blocks_end": used, "gates": gates}
    log(f"[robust] {card} | cancel + deadline: {json.dumps(fig)}")
    ROBUST["cancel + deadline"] = fig
    del eng, r
    _free()
    if not all(gates.values()):
        raise SystemExit(f"[robust] cancel + deadline: {gates}")


def robust_watchdog(dev, card: str, params, prompts) -> None:
    """Phase 10 (e): a bounded storm of allocation faults
    (``FaultPlan(alloc_p=1.0, max_faults=12)``: every allocation of
    three admission rounds, watchdog patience 3) over
    four 64-token prompts of 8 new tokens.  Gates: ``run`` ends (no
    EngineStallError), the watchdog fires and sheds the head with the
    stall diagnostic in its reason, every request in exactly one
    terminal state, the invariants, 0 used blocks."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import TERMINAL_STATES
    from repro_torch.serving.faults import FaultPlan
    cfg = get_config(ARCH)
    plan = FaultPlan(alloc_p=1.0, max_faults=12)
    eng = _robust_engine(dev, cfg, params, prefix_cache=False,
                         watchdog_patience=3, fault_plan=plan)
    reqs = [eng.submit(p[:64], 8) for p in prompts[:4]]
    eng.run(max_steps=200)
    r = eng.runner
    r.kv.check_invariants()
    shed = [q for q in reqs if q.state.value == "rejected"]
    m = eng.metrics.summary()
    used = r.kv.utilization()["used_blocks"]
    gates = {"watchdog fired": m["watchdog_fires"] >= 1,
             "head shed with diagnostic": bool(shed) and all(
                 "watchdog" in q.finish_reason and "queued=" in
                 q.finish_reason for q in shed),
             "one terminal state each": all(
                 sum(q.state is s for s in TERMINAL_STATES) == 1
                 for q in reqs),
             "used blocks 0": used == 0}
    fig = {"states": [q.state.value for q in reqs],
           "watchdog_fires": m["watchdog_fires"], "faults": plan.summary(),
           "reason": shed[0].finish_reason if shed else None,
           "gates": gates}
    log(f"[robust] {card} | watchdog: {json.dumps(fig)}")
    ROBUST["watchdog"] = fig
    del eng, r
    _free()
    if not all(gates.values()):
        raise SystemExit(f"[robust] watchdog: {gates}")


def robust_runs(dev, card: str, params, prompts, ref) -> None:
    """Phase 10: (a) preemption, bf16; (b) the same with int8 weights and
    int8 KV; (c) transfer faults; (d) cancel and deadline; (e) the
    watchdog."""
    t0 = time.perf_counter()
    robust_preempt(dev, card, params, prompts, ref, "bf16")
    robust_preempt(dev, card, params, prompts, None,
                   "int8 weights + int8 KV", int8=True)
    robust_faults(dev, card, params, prompts, ref)
    robust_cancel_deadline(dev, card, params, prompts, ref)
    robust_watchdog(dev, card, params, prompts)
    ROBUST["seconds"] = time.perf_counter() - t0
    log(f"[robust] phase 10 took {ROBUST['seconds']:.1f}s")


# ---------------------------------------------------------------------------
# phase 3, the layer models' kernel shapes (gemma3-4b, gemma2-2b) and the
# flash offset route of phase 9's warm tails
# ---------------------------------------------------------------------------

G3_ARCH, G2_ARCH, NEMO_ARCH = "gemma3-4b", "gemma2-2b", "nemotron-4-15b"
G3_PROMPT, G2_PROMPT, LM_NEW = 1536, 512, 32   # phase 11's requests
G3_NEW = 64


def _flash_keys(B: int, Sq: int, window=None, q_off=None, k_len=None):
    """The key columns a flash call's rows see, summed over the rows of
    one (batch row, head): causal, in the window, below k_len."""
    seen = 0
    for b in range(B):
        o = 0 if q_off is None else q_off[b]
        kl = None if k_len is None else k_len[b]
        for i in range(Sq):
            hi = o + i + 1 if kl is None else min(o + i + 1, kl)
            lo = 0 if window is None else max(0, o + i - window + 1)
            seen += max(0, hi - lo)
    return seen


def layer_flash_row(dev, g, arch: str, tag: str, B: int, S: int, H: int,
                    KH: int, hd: int, window=None, softcap=None,
                    iters: int = 10):
    """One phase-3 flash row at a layer model's prefill shape (bf16,
    causal, with ``window`` or ``softcap``): the kernel against its plain
    version (2e-2, and ``row_rel_err`` within FLASH_ROW_REL_TOL), kernel
    and SDPA (K / V expanded beforehand; none for
    a softcap, which SDPA does not compute) as device work, the route it
    took (``route``'s), the bound from the key columns the rows see.
    SDPA runs with a boolean mask and, where no window cuts a row's keys
    (none, or one as long as the prompt), with ``is_causal`` too, which
    skips the tiles above the diagonal as the kernel does; the row's
    ``library_ms`` is the faster of the two."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    bf = torch.bfloat16
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(bf)
    k, v = (torch.randn(B, S, KH, hd, generator=g, device=dev).to(bf)
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap)
    routes0 = dict(fa.flash_attention.routes)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    took = {r for r, c in fa.flash_attention.routes.items()
            if c != routes0[r]}
    want_route = fa.route(bf, hd, True)
    if took != {want_route}:
        raise SystemExit(f"[kernel] flash_attention at {tag} took {took}")
    want = ref.flash_attention_plain(q, k, v, **kw)
    rel = row_rel_err(out, want)
    if rel > FLASH_ROW_REL_TOL:
        raise SystemExit(f"[kernel] flash_attention at {tag}: max_row_rel_err "
                         f"{rel:.3e} (tol {FLASH_ROW_REL_TOL})")
    t = {"ms": graph_ms(lambda q, k, v: ops.flash_attention(q, k, v, **kw),
                        [(q, k, v)], iters),
         "eager_ms": time_ms(lambda q, k, v: ops.flash_attention(
             q, k, v, **kw), [(q, k, v)], iters)}
    lib = None
    sdpa = {}
    if softcap is None:
        qq = q.transpose(1, 2).contiguous()
        kk, vv = (x.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous()
                  for x in (k, v))
        i = torch.arange(S, device=dev)
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask &= i[None, :] > i[:, None] - window
        sdpa["masked_ms"] = graph_ms(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=mask), [(qq, kk, vv)], iters)
        if window is None or window >= S:
            sdpa["is_causal_ms"] = graph_ms(
                lambda a, b, c: F.scaled_dot_product_attention(
                    a, b, c, is_causal=True), [(qq, kk, vv)], iters)
        lib = min(sdpa.values())
        del qq, kk, vv, mask
    p_ms = time_ms(lambda q, k, v: ref.flash_attention_plain(q, k, v, **kw),
                   [(q, k, v)], 2)
    row = _report("flash_attention", "cuda",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:79", out, want,
                  t["ms"], p_ms, lib, nbytes(q, k, v, out),
                  4.0 * H * hd * _flash_keys(B, S, window), BF16_FLOP_S)
    row.update(kernel_route=want_route, run=arch, eager_ms=t["eager_ms"],
               sdpa=sdpa, max_row_rel_err=rel,
               at=f"{tag}: q [{B},{S},{H},{hd}], k, v [{B},{S},{KH},{hd}] "
                  f"bf16, causal" + (f", window {window}" if window else "")
               + (f", softcap {softcap}" if softcap else "")
               + f"; route {want_route}",
               bound_share=row["bound_ms"] / row["ms"],
               timing="ms and library_ms: device work (CUDA graph replay)")
    log(f"[kernel]   flash_attention at {row['at']}: "
        f"{100 * row['bound_share']:.1f} % of its bound; max_row_rel_err "
        f"{rel:.3e} (tol {FLASH_ROW_REL_TOL}); SDPA {json.dumps(sdpa)}")
    del q, k, v, out, want
    torch.cuda.empty_cache()
    return row


def flash_offset_row(dev, g):
    """Phase 3, the flash offset route at phase 9's warm shape (pt-6b-d4:
    SLOTS x 8 tracks of 64-token tails at offset PFX_SHARED over their
    rows' K/V gathered from the pool, table width
    ceil((PROMPT + NEW + 8) / BLOCK) blocks): held against the plain
    version (2e-2) and, the A1 gate, bitwise against the same rows of a
    whole-prompt call from position 0 (a cold prefill).  SDPA with a
    boolean mask as the yardstick."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    cfg = get_config(ARCH)
    B, H, KH, hd = cfg.pt.n_tracks * SLOTS, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    S = -(-(PROMPT + NEW + 8) // BLOCK) * BLOCK
    C, o, bf = PFX_TAIL, PFX_SHARED, torch.bfloat16
    qf = torch.randn(B, PROMPT, H, hd, generator=g, device=dev).to(bf)
    kf, vf = (torch.randn(B, S, KH, hd, generator=g, device=dev).to(bf)
              for _ in range(2))
    q = qf[:, o:o + C].contiguous()
    q_off = torch.full((B,), o, dtype=torch.int32, device=dev)
    k_len = torch.full((B,), o + C, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=q_off, k_lengths=k_len)
    out = ops.flash_attention(q, kf, vf, **kw)
    cold = ops.flash_attention(qf, kf[:, :PROMPT].contiguous(),
                               vf[:, :PROMPT].contiguous(), causal=True)
    torch.cuda.synchronize()
    bitwise = torch.equal(out, cold[:, o:o + C])
    log(f"[kernel] flash_attention offset route: the tail rows bitwise the "
        f"whole-prompt call's: {bitwise}")
    if not bitwise:
        raise SystemExit("[kernel] flash offset route is not bitwise the "
                         "whole-prompt call")
    want = ref.flash_attention_plain(q, kf, vf, **kw)
    t = {"ms": graph_ms(lambda q: ops.flash_attention(q, kf, vf, **kw),
                        [(q,)], 200),
         "eager_ms": time_ms(lambda q: ops.flash_attention(q, kf, vf, **kw),
                             [(q,)], 200)}
    i = torch.arange(C, device=dev)[:, None] + o
    mask = torch.arange(S, device=dev)[None, :] <= i
    qq = q.transpose(1, 2).contiguous()
    kk, vv = (x.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous()
              for x in (kf, vf))
    lib = graph_ms(lambda a: F.scaled_dot_product_attention(
        a, kk, vv, attn_mask=mask), [(qq,)], 200)
    del qq, kk, vv
    p_ms = time_ms(lambda q: ref.flash_attention_plain(q, kf, vf, **kw),
                   [(q,)], 3)
    keys = _flash_keys(B, C, q_off=[o] * B, k_len=[o + C] * B)
    row = _report("flash_attention", "cuda",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:79", out, want,
                  t["ms"], p_ms, lib,
                  nbytes(q, out, q_off, k_len) + (o + C) * B * KH * hd * 4,
                  4.0 * H * hd * keys, BF16_FLOP_S)
    row.update(kernel_route="wgmma_tma", run="prefix bf16 warm",
               eager_ms=t["eager_ms"], bitwise_cold=bitwise,
               at=f"offset route (phase 9's warm tails): q [{B},{C},{H},{hd}]"
                  f" at {o}, k, v [{B},{S},{KH},{hd}] gathered, k_len "
                  f"{o + C}, bf16; route wgmma_tma",
               bound_share=row["bound_ms"] / row["ms"],
               timing="ms and library_ms: device work (CUDA graph replay)")
    del qf, kf, vf, q, out, cold, want
    torch.cuda.empty_cache()
    return row


def layer_decode_row(dev, g, arch: str, tag: str, paged: bool, B: int,
                     L: int, S: int, H: int, KH: int, hd: int,
                     softcap=None):
    """One phase-3 decode row at a layer model's decode shape near the end
    of its phase-11 run (every row L live tokens): paged (one layer's
    pools, n = 1, block BLOCK, a capacity of S tokens, ``max_len`` as the
    engine buckets it) or contiguous (the ring [B, S, KH, hd]); with
    ``softcap``.  Kernel against plain (2e-2); SDPA on K / V gathered and
    expanded beforehand (none for a softcap) as device work."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    bf = torch.bfloat16
    hg = da.head_groups(H // KH)        # blocks a KV head's query heads take
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    if paged:
        nmax = -(-S // BLOCK)
        N = B * nmax + 1
        table = (torch.randperm(N - 1, generator=torch.Generator()
                                .manual_seed(L))[:B * nmax]
                 .reshape(B, nmax) + 1).to(torch.int32).to(dev)
        p2 = 1
        while p2 < -(-L // BLOCK):
            p2 *= 2
        max_len = min(nmax, p2) * BLOCK
        shape, qshape = (1, N, BLOCK, KH, hd), (1, B, H, hd)
    else:
        max_len, shape, qshape = S, (B, S, KH, hd), (B, H, hd)
    one = 2 * math.prod(shape) * 2
    sets = [(torch.randn(qshape, generator=g, device=dev).to(bf),
             torch.randn(shape, generator=g, device=dev).to(bf),
             torch.randn(shape, generator=g, device=dev).to(bf))
            for _ in range(min(20, copies_for(one)))]
    if paged:
        tbl = table.long()

        def kern(q, k, v):
            return ops.paged_decode_attention(q, k, v, table, lengths,
                                              max_len=max_len,
                                              softcap=softcap)

        def plain(q, k, v):
            return ref.paged_decode_attention_plain(
                q, k, v, table, lengths, max_len=max_len, softcap=softcap)

        def lib_args(q, k, v):
            def one_(c):
                c = c[:, tbl].reshape(B, nmax * BLOCK, KH, hd)
                return c[:, :L].repeat_interleave(H // KH, 2) \
                    .transpose(1, 2).contiguous()
            return q.reshape(B, H, 1, hd), one_(k), one_(v)
    else:
        def kern(q, k, v):
            return ops.decode_attention(q, k, v, lengths, max_len=max_len,
                                        softcap=softcap)

        def plain(q, k, v):
            return ref.decode_attention_plain(q, k, v, lengths,
                                              max_len=max_len,
                                              softcap=softcap)

        def lib_args(q, k, v):
            def one_(c):
                return c[:, :L].repeat_interleave(H // KH, 2) \
                    .transpose(1, 2).contiguous()
            return q[:, :, None], one_(k), one_(v)
    out, want = kern(*sets[0]), plain(*sets[0])
    t = {"ms": graph_ms(kern, sets, 100), "eager_ms": time_ms(kern, sets, 100),
         "library_ms": None, "library_eager_ms": float("nan")}
    if softcap is None:
        lib_sets = [lib_args(*st) for st in sets]
        t["library_ms"] = graph_ms(F.scaled_dot_product_attention, lib_sets,
                                   100)
        t["library_eager_ms"] = time_ms(F.scaled_dot_product_attention,
                                        lib_sets, 100)
        del lib_sets
    name = "paged_decode_attention" if paged else "decode_attention"
    row = _report(name, "cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                  "src/repro/kernels/decode_attention.py:"
                  + ("187" if paged else "92"), out, want, t["ms"],
                  time_ms(plain, sets[:1], 3), t["library_ms"],
                  B * L * KH * hd * 2 * 2 + nbytes(sets[0][0], lengths, out),
                  4.0 * B * L * H * hd, BF16_FLOP_S)
    row["run"] = arch
    row["head_groups"] = hg
    row["at"] = (f"{tag}: B {B}, live {L}, hd {hd}, G {H // KH} ("
                 + (f"{hg} head groups of {H // KH // hg}, " if hg > 1
                    else "")
                 + ("paged, block 16" if paged else "contiguous ring")
                 + f", capacity {S}, max_len {max_len}"
                 + (f", softcap {softcap}" if softcap else "") + ")")
    log(f"[kernel]   {name} at {row['at']}")
    sweep = max_len if paged else da._sweep_cols(S, 512, max_len)
    decode_extras(row, t, sweep, B * KH * hg, BLOCK if paged else None,
                  nmax * BLOCK if paged else S)
    del sets, out, want
    torch.cuda.empty_cache()
    return row


def check_layer_kernels(dev, g, rows) -> None:
    """Phase 3 for this slice's paths, appended to the shapes of the flash,
    paged decode and contiguous decode rows: flash at gemma3's global
    (hd 320) and local (window 1024) prefill shapes and gemma2's (hd 288,
    softcap 50); the offset route at phase 9's warm shape (bitwise the
    cold rows); paged decode at gemma3's global layers and at gemma2's
    (softcap); contiguous decode over gemma3's 1024-slot rings."""
    from repro_torch.configs import get_config
    g3, g2 = get_config(G3_ARCH), get_config(G2_ARCH)
    by = {r["name"]: r for r in rows}
    g3_cap = G3_PROMPT + G3_NEW + 8
    g2_cap = G2_PROMPT + LM_NEW + 8
    by["flash_attention"]["shapes"] += [
        layer_flash_row(dev, g, G3_ARCH, "gemma3-4b global", SLOTS,
                        G3_PROMPT, g3.n_heads, g3.n_kv_heads, g3.head_dim),
        layer_flash_row(dev, g, G3_ARCH, "gemma3-4b local", SLOTS,
                        G3_PROMPT, g3.n_heads, g3.n_kv_heads, g3.head_dim,
                        window=g3.spec("local").window),
        layer_flash_row(dev, g, G2_ARCH, "gemma2-2b", SLOTS, G2_PROMPT,
                        g2.n_heads, g2.n_kv_heads, g2.head_dim,
                        softcap=g2.spec("local").attn_logit_softcap),
        flash_offset_row(dev, g)]
    by["paged_decode_attention"]["shapes"] += [
        layer_decode_row(dev, g, G3_ARCH, "gemma3-4b global", True, SLOTS,
                         G3_PROMPT + G3_NEW, g3_cap, g3.n_heads,
                         g3.n_kv_heads, g3.head_dim),
        layer_decode_row(dev, g, G2_ARCH, "gemma2-2b", True, SLOTS,
                         G2_PROMPT + LM_NEW, g2_cap, g2.n_heads,
                         g2.n_kv_heads, g2.head_dim,
                         softcap=g2.spec("local").attn_logit_softcap)]
    W = g3.spec("local").window
    by["decode_attention"].setdefault("shapes", []).append(
        layer_decode_row(dev, g, G3_ARCH, "gemma3-4b local ring", False,
                         SLOTS, W, W, g3.n_heads, g3.n_kv_heads,
                         g3.head_dim))


def check_layer_parity(dev: torch.device) -> None:
    """Phase 4, this slice's models: ``reduced_config`` of gemma2-2b (4
    layers alternating a 16-token window with global, softcaps),
    gemma3-4b (10 layers, 8 local of window 16, qk-norm, sandwich norms)
    and nemotron-4-15b (4 layers, LayerNorm, squared ReLU), fp32, on the
    card against the same weights on the CPU within 1e-4: prefill logits
    (rows of 30 and 21 tokens right-padded to 32: the rings built per
    row), chunked prefill (chunk 8, the second row's last chunk holding
    5 real tokens) into the paged cache of capacity 48 (ring leaves for
    the windowed layers), then four teacher-forced decode steps across
    the rings' wrap; then the engine's greedy streams (paged, whole
    prompts), which must be identical card vs CPU."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import PagedKVCache
    from repro_torch.serving.engine import Engine
    cpu = torch.device("cpu")
    for arch in (G2_ARCH, G3_ARCH, NEMO_ARCH):
        cfg = reduced_config(arch)
        params = {cpu: dec.init_lm(torch.Generator().manual_seed(0), cfg,
                                   cpu)}
        params[dev] = _to(params[cpu], dev)
        rng = np.random.default_rng(4)
        lens = np.asarray([30, 21])
        toks = np.zeros((2, 32), np.int64)
        for i, L in enumerate(lens):
            toks[i, :L] = rng.integers(1, cfg.vocab_size, size=(L,))
        teacher = rng.integers(1, cfg.vocab_size, size=(4, 2))
        got = {}
        with torch.no_grad():
            for d in (cpu, dev):
                t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
                    np.asarray(a)).to(d, dt)
                p = params[d]
                logits, _ = dec.lm_forward(p, {"inputs": t(toks),
                                               "lengths": t(lens)}, cfg)
                kv = PagedKVCache(cfg, max_slots=2, max_seq_len=48,
                                  block_size=8, device=d)
                for slot in range(2):
                    kv.allocate(slot, int(lens[slot]) + 4)
                chunks = []
                for c in range(0, 32, 8):
                    cl = np.clip(lens - c, 0, 8)
                    chunks.append(dec.lm_chunk_step(
                        p, kv.engine_cache(), t(toks[:, c:c + 8]),
                        t([c, c], torch.int32), cfg, block_table=kv.table(),
                        slots=t([0, 1]), chunk_lens=t(cl))[0])
                steps = [dec.lm_decode_step(
                    p, kv.engine_cache(), t(teacher[k]),
                    t(lens + k, torch.int32), cfg, block_table=kv.table(),
                    kv_max_len=48)[0] for k in range(teacher.shape[0])]
                got[d] = (logits, torch.cat(chunks, 1), torch.stack(steps),
                          kv.leaf_kinds())
        _close(f"{arch} prefill logits", got[dev][0], got[cpu][0])
        _close(f"{arch} paged chunk-8 logits", got[dev][1], got[cpu][1])
        _close(f"{arch} decode logits across the ring wrap", got[dev][2],
               got[cpu][2])
        log(f"[parity] {arch}: leaf kinds {got[dev][3]}")
        prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
                   for L in (30, 21, 9, 26)]
        streams = {d: Engine(cfg, params[d], max_slots=2, max_seq_len=48,
                             device=d).generate(prompts, 8)
                   for d in (cpu, dev)}
        same = streams[dev] == streams[cpu]
        log(f"[parity] {arch} greedy token streams, card vs CPU: "
            f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise SystemExit(f"[parity] {arch} greedy streams differ")


# ---------------------------------------------------------------------------
# phase 11: gemma3-4b, gemma2-2b and nemotron-4-15b at full width
# ---------------------------------------------------------------------------

LAYER_RUNS = {}       # the figures of phase 11, for the summary


def layer_arith(cfg, c: dict) -> dict:
    """The launch counts of a phase-11, 12 or 13 run of ``c["P"]``
    prefill calls, ``c.get("C", 0)`` chunk calls (a prompt's chunk
    program) and ``c["T"]`` decode steps, from the code: per prefill call
    one flash launch per attention layer (GQA or MLA) and one scan launch
    per recurrent layer; per chunk call one scan launch per recurrent
    layer and one flash launch (the offset route) per pooled GQA layer (a
    ring's chunk is plain PyTorch, as the reference computes it in jnp);
    per decode step one decode launch per GQA layer, the paged kernel on
    a pool layer and the contiguous one on a ring layer or on the
    contiguous cache (``c["contiguous"]``), none for an MLA layer (its
    absorbed decode is plain products, as the reference's); the RMSNorm
    launches ``norm_routes`` counts (none for LayerNorm; one residual add
    per layer in a model of Mamba layers without MLPs)."""
    from repro_torch.common.paged import leaf_kind
    P, C, T = c["P"], c.get("C", 0), c["T"]
    specs = [cfg.spec(nm) for nm in cfg.layer_names]
    kind = "falcon" if all(s.mlp == "none" for s in specs) else "layers"
    gqa = [leaf_kind(s, c["capacity"]) for s in specs if s.mixer == "gqa"]
    attn = sum(s.mixer in ("gqa", "mla") for s in specs)
    pools = 0 if c.get("contiguous") else gqa.count("paged")
    rec = len(specs) - attn
    return {"flash_attention": attn * P + pools * C,
            "paged_decode_attention": pools * T,
            "decode_attention": (len(gqa) - pools) * T,
            "paged_decode_attention_int8": 0, "decode_attention_int8": 0,
            "int8_matmul": 0, "ssm_scan": rec * (P + C),
            "rmsnorm": sum(norm_routes(kind, cfg, c).values())}


def serve_layer_model(dev, card: str, arch: str, prompt: int, new: int,
                      planned: bool = False, cfg=None, cap=None,
                      chunk: int = 0, store=None, after=None):
    """Phase 11 (and 12), one model at full width, bf16, seeded random
    weights: SLOTS greedy requests of ``prompt`` tokens and ``new`` new
    tokens, SLOTS slots, block BLOCK, capacity ``cap`` (default prompt +
    new + 8), all prompts admitted in one round
    (``max_waiting_prefill_tokens``), the prefix cache off (windowed and
    recurrent models have none).  ``cfg``: the config to serve (default
    ``get_config(arch)``; phase 12 cuts qwen2-vl's depth).  Prints TTFT
    and TPOT p50 / p90, throughput, peak memory, the cache's leaf kinds
    (and each layer's) and the launches per kernel and per flash /
    RMSNorm route; gates: every request finishes, the launch arithmetic
    (``layer_arith``), every flash launch on ``route``'s route, the
    RMSNorm launches by route as ``norm_routes`` counts them.  With
    ``planned`` the same prompts again pipelined (depth 1, the programs
    of the run's live lengths captured): every step a replay, streams
    bitwise the sync run's, the same arithmetic.  With ``chunk`` the same
    prompts again, sync, with ``prefill_chunk=chunk``: its streams against
    the whole-prompt run's are reported (bf16 near-ties may flip, so no
    gate), the arithmetic gated.  A MoE model's routed and dropped (token,
    expert) pairs are counted (``moe.track_drops``) and printed.  The
    figures go into ``store`` (default
    ``LAYER_RUNS``) under ``arch``; ``after(cfg, params)`` runs on the
    model before its weights are freed.  Returns the sync run's launch
    counts."""
    from collections import Counter

    from repro_torch.common.paged import leaf_kind
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.decoder import init_lm
    from repro_torch.serving.engine import Engine, EngineMetrics, RequestState
    cfg = cfg or get_config(arch)
    cap = cap or prompt + new + 8
    store = LAYER_RUNS if store is None else store
    if cfg.moe is not None:
        # on before any capture: the planned steps' graphs count too
        moe.track_drops(dev)
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    log(f"[layers] {cfg.name}: "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters, "
        f"{sum(nbytes(t) for t in _leaves(params)) / 1e9:.3f} GB, init "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, size=(prompt,)).tolist()
               for _ in range(SLOTS)]
    if cfg.mla is not None:        # MLA's prefill: q / k 192, v 128 wide
        ml = cfg.mla
        route = fa.route(torch.bfloat16, ml.qk_nope_head_dim
                         + ml.qk_rope_head_dim, True, ml.v_head_dim)
    else:
        route = fa.route(torch.bfloat16, cfg.head_dim, True)
    layer_kinds = dict(Counter(leaf_kind(cfg.spec(nm), cap)
                               for nm in cfg.layer_names))
    modes = ("sync",) + (("planned",) if planned else ()) \
        + (("chunk",) if chunk else ())
    fig, sync_streams, launches0 = {}, None, None
    for mode in modes:
        eng = Engine(cfg, params, max_slots=SLOTS, max_seq_len=cap,
                     block_size=BLOCK, device=dev, prefix_cache=False,
                     max_waiting_prefill_tokens=SLOTS * cap,
                     prefill_chunk=chunk if mode == "chunk" else 0,
                     pipeline_depth=1 if mode == "planned" else 0)
        r = eng.runner
        if mode == "planned":
            r.plan_programs(sampled=(False,),
                            lengths=range(prompt, prompt + new + 1))
        kinds = r.kv.leaf_kinds()
        eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                      for _ in range(SLOTS)], 3)          # warm-up
        eng.metrics = EngineMetrics()
        eng._last_dispatch_t = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        if cfg.moe is not None:
            moe.track_drops(dev)
        base = (r.decode_transfers, r.prefill_calls, r.chunk_calls,
                r.planned_hits)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, new) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        flash_routes = dict(ops.flash_attention.routes)
        rms_routes = dict(ops.rmsnorm.routes)
        scan_routes = dict(ops.ssm_scan.routes)
        drops = moe.drop_counts()
        m = eng.metrics.summary()
        peak = torch.cuda.max_memory_allocated(dev)
        c = {"T": r.decode_transfers - base[0], "P": r.prefill_calls - base[1],
             "C": r.chunk_calls - base[2], "hits": r.planned_hits - base[3],
             "capacity": cap}
        done = sum(q.state is RequestState.DONE and len(q.output) == new
                   for q in reqs)
        streams = [q.output for q in reqs]
        want = layer_arith(cfg, c)
        got = {k: launches[k] for k in want}
        calls_ok = (c["C"] > 0 and c["P"] == 0 if mode == "chunk"
                    else c["P"] > 0 and c["C"] == 0)
        gates = {"finished": done == len(reqs),
                 "launch arithmetic": got == want and calls_ok,
                 "flash route": flash_routes == dict(
                     dict.fromkeys(flash_routes, 0),
                     **{route: launches["flash_attention"]}),
                 "RMSNorm routes": rms_routes == norm_routes("layers", cfg,
                                                             c),
                 "scan routes": scan_routes == scan_route_counts(
                     "scan", launches)}
        SCAN_ROUTES[f"{cfg.name} {mode}"] = scan_routes
        if mode == "planned":
            gates["every step replayed"] = c["hits"] == c["T"] > 0
            gates["streams equal sync"] = streams == sync_streams
        vs_sync = None
        if mode == "chunk":
            vs_sync = {"equal": sum(a == b for a, b in
                                    zip(streams, sync_streams)),
                       "first_divergence": [_divergence(a, b) for a, b in
                                            zip(streams, sync_streams)]}
        log(f"[layers] {card} | {cfg.name} {mode}: {SLOTS} reqs x ({prompt} "
            f"in / {new} out), slots {SLOTS}, block {BLOCK}, capacity {cap}"
            + (f", chunk {chunk}" if mode == "chunk" else "")
            + f", wall {wall:.3f}s; TTFT ms p50 {m['ttft_ms']['p50']:.2f} "
            f"p90 {m['ttft_ms']['p90']:.2f}; TPOT ms p50 "
            f"{m['tpot_ms']['p50']:.3f} p90 {m['tpot_ms']['p90']:.3f}; "
            f"throughput {m['throughput_tok_s']:.1f} tok/s; peak memory "
            f"{peak / 1e9:.3f} GB")
        log(f"[layers] {cfg.name} {mode}: leaf kinds {json.dumps(kinds)}, "
            f"layers {json.dumps(layer_kinds)} (pool "
            f"{r.kv.pool_bytes() / 1e9:.3f} GB, ring and state rows "
            f"{r.kv.state_bytes() / 1e9:.3f} GB); prefill calls {c['P']}, "
            f"chunk calls {c['C']}, decode steps {c['T']}, replays "
            f"{c['hits']}; launches {json.dumps(launches)}; arithmetic "
            f"{json.dumps(want)}; flash routes {json.dumps(flash_routes)}; "
            f"RMSNorm routes {json.dumps(rms_routes)}; scan routes "
            f"{json.dumps(scan_routes)}; gates "
            f"{json.dumps(gates)}"
            + (f"; streams vs whole-prompt {json.dumps(vs_sync)}"
               if vs_sync else ""))
        if drops:
            log(f"[layers] {cfg.name} {mode}: MoE (token, expert) pairs "
                f"routed / dropped: prefill {drops['prefill']['routed']} / "
                f"{drops['prefill']['dropped']}, decode "
                f"{drops['decode']['routed']} / "
                f"{drops['decode']['dropped']}")
        fig[mode] = {"ttft_ms": m["ttft_ms"], "tpot_ms": m["tpot_ms"],
                     "throughput_tok_s": m["throughput_tok_s"],
                     "peak_gb": peak / 1e9, "wall_s": wall,
                     "leaf_kinds": kinds, "layer_kinds": layer_kinds,
                     "launches": launches, "flash_routes": flash_routes,
                     "rmsnorm_routes": rms_routes,
                     "scan_routes": scan_routes, "graphs": len(r.programs),
                     "calls": c}
        if drops:
            fig[mode]["moe_pairs"] = drops
        if vs_sync:
            fig[mode]["streams_vs_whole_prompt"] = vs_sync
        if mode == "sync":
            sync_streams, launches0 = streams, launches
        del eng, r
        gc.collect()
        torch.cuda.empty_cache()
        if not all(gates.values()):
            raise SystemExit(f"[layers] {cfg.name} {mode}: gates {gates}")
    store[arch] = fig
    moe.track_drops(None)
    if after is not None:
        after(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches0


def serve_layer_models(dev, card: str, runs: dict) -> None:
    """Phase 11: gemma3-4b (8 x 1536 / 64: a capacity past its 1024
    window, so its 29 local layers hold rings and its 5 global ones
    pools; sync, then planned), gemma2-2b (8 x 512 / 32; its 4096 window
    covers the capacity: every layer paged, softcaps, hd 288) and
    nemotron-4-15b (8 x 512 / 32, LayerNorm, squared ReLU), sync."""
    t0 = time.perf_counter()
    runs[G3_ARCH] = serve_layer_model(dev, card, G3_ARCH, G3_PROMPT, G3_NEW,
                                      planned=True)
    kinds = LAYER_RUNS[G3_ARCH]["sync"]["leaf_kinds"]
    if kinds != {"ring": 18, "paged": 2}:
        raise SystemExit(f"[layers] gemma3-4b leaf kinds {kinds}: want the "
                         "29 local layers' K/V as rings (18 leaves: 5 unit "
                         "positions and 4 suffix layers) and the 5 global "
                         "ones' as pools (2 leaves)")
    runs[G2_ARCH] = serve_layer_model(dev, card, G2_ARCH, G2_PROMPT, LM_NEW)
    runs[NEMO_ARCH] = serve_layer_model(dev, card, NEMO_ARCH, G2_PROMPT,
                                        LM_NEW)
    LAYER_RUNS["seconds"] = time.perf_counter() - t0
    log(f"[layers] phase 11 took {LAYER_RUNS['seconds']:.1f}s")


# ---------------------------------------------------------------------------
# phases 3, 4 and 12 for qwen2-vl-72b (M-RoPE, precomputed embeddings) and
# recurrentgemma-9b (RG-LRU on the scan kernel, 2048-token MQA rings at 16
# query heads a KV head)
# ---------------------------------------------------------------------------

QWEN_ARCH, RG_ARCH = "qwen2-vl-72b", "recurrentgemma-9b"
QWEN_LAYERS, QWEN_PROMPT, QWEN_NEW = 16, 512, 32   # phase 12's requests
RG_PROMPT, RG_NEW, RG_CHUNK = 2048, 64, 512
EMB_B, EMB_S, EMB_STEPS = 2, 1024, 16              # the embeddings arm
PHASE12 = {}          # the figures of phase 12, for the summary


def qwen_config():
    """qwen2-vl-72b cut to QWEN_LAYERS of its 80 layers: 72.7 B parameters
    are ~145 GB in bf16, past one 80 GB card; 16 layers with the
    embedding and the head are ~16.5 B, ~33 GB.  Widths untouched."""
    from repro_torch.configs import get_config
    return get_config(QWEN_ARCH).replace(n_layers=QWEN_LAYERS)


def scan_row(dev, g, S: int = RG_PROMPT):
    """Phase 3, the scan route at recurrentgemma's prefill (S = RG_PROMPT)
    or its chunk (S = RG_CHUNK): a, b [SLOTS, S, d_inner] fp32 (the
    RG-LRU's features, no d_state axis; the TMA path), nonzero h0,
    against its plain version (1e-4) and its bound, timed as device work
    (a CUDA graph) beside its eager loop."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    di = get_config(RG_ARCH).rglru.d_inner
    shape = (SLOTS, S, di)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=dev))
    b = torch.randn(shape, generator=g, device=dev)
    h0 = torch.randn(SLOTS, di, generator=g, device=dev)
    (h, hl), (rh, rhl) = ops.ssm_scan(a, b, h0), ref.ssm_scan_plain(a, b, h0)
    _agree("ssm_scan h_last", hl, rhl, FP32_KERNEL_TOL)
    k_ms = graph_ms(ops.ssm_scan, [(a, b, h0)], 20)
    eager = time_ms(ops.ssm_scan, [(a, b, h0)], 20)
    p_ms = time_ms(ref.ssm_scan_plain, [(a, b, h0)], 2)
    row = _report("ssm_scan", "cuda",
                  "src/repro_torch/kernels/csrc/ssm_scan.cu",
                  "src/repro/kernels/ssm_scan.py:47", h, rh, k_ms, p_ms, None,
                  nbytes(a, b, h0, h, hl), 2.0 * a.numel(), FP32_FLOP_S,
                  tol=FP32_KERNEL_TOL)
    what = "prefill" if S == RG_PROMPT else f"chunk of {S}"
    row.update(kernel_route="scan", eager_ms=eager,
               run=RG_ARCH if S == RG_PROMPT else RG_ARCH + " chunked",
               at=f"{RG_ARCH} {what}: a, b [{SLOTS},{S},{di}] fp32, h0 "
                  f"[{SLOTS},{di}]",
               bound_share=row["bound_ms"] / row["ms"],
               library_ms_why="no single PyTorch call computes a linear "
                              "recurrence over the sequence axis",
               timing="ms: device work (CUDA graph replay); eager_ms and "
                      "plain_ms: CUDA events over eager loops")
    log(f"[kernel]   ssm_scan at {row['at']}: "
        f"{100 * row['bound_share']:.1f} % of its bound; eager loop "
        f"{eager:.4f} ms")
    del a, b, h0, h, hl, rh, rhl
    torch.cuda.empty_cache()
    return row


def check_slice16_kernels(dev, g, rows) -> None:
    """Phase 3 for qwen2-vl-72b and recurrentgemma-9b, appended to the
    shapes of the decode and flash rows: contiguous decode over
    recurrentgemma's 2048-slot rings at 16 query heads on 1 KV head (two
    head groups), paged decode at qwen2-vl's decode (64 heads on 8, 544
    live), flash at recurrentgemma's prefill (hd 256, 16 on 1, window
    2048) and at qwen2-vl's (64 on 8, hd 128), both on ``wgmma_tma``;
    a row of its own for the scan route at recurrentgemma's prefill, its
    chunk of RG_CHUNK beside it."""
    from repro_torch.configs import get_config
    rg, qw = get_config(RG_ARCH), get_config(QWEN_ARCH)
    by = {r["name"]: r for r in rows}
    W = rg.spec("attn").window
    by["decode_attention"].setdefault("shapes", []).append(
        layer_decode_row(dev, g, RG_ARCH, "recurrentgemma-9b ring", False,
                         SLOTS, RG_PROMPT, W, rg.n_heads, rg.n_kv_heads,
                         rg.head_dim))
    by["paged_decode_attention"]["shapes"].append(
        layer_decode_row(dev, g, QWEN_ARCH, "qwen2-vl-72b", True, SLOTS,
                         QWEN_PROMPT + QWEN_NEW, QWEN_PROMPT + QWEN_NEW + 8,
                         qw.n_heads, qw.n_kv_heads, qw.head_dim))
    by["flash_attention"]["shapes"] += [
        layer_flash_row(dev, g, RG_ARCH, "recurrentgemma-9b", SLOTS,
                        RG_PROMPT, rg.n_heads, rg.n_kv_heads, rg.head_dim,
                        window=W),
        layer_flash_row(dev, g, QWEN_ARCH, "qwen2-vl-72b", SLOTS,
                        QWEN_PROMPT, qw.n_heads, qw.n_kv_heads, qw.head_dim)]
    rows.append(scan_row(dev, g))
    rows[-1]["shapes"] = [scan_row(dev, g, RG_CHUNK)]


def _grid_positions(B: int, S: int, dev, grid: int = 4) -> torch.Tensor:
    """(t, h, w) M-RoPE streams of a patch grid: ``grid`` x ``grid``
    patches a frame, frame after frame (three distinct streams),
    [3, B, S] int32."""
    i = torch.arange(S, device=dev)
    hw = i % (grid * grid)
    pos = torch.stack([i // (grid * grid), hw // grid, hw % grid])
    return pos[:, None].expand(3, B, S).to(torch.int32)


def check_slice16_parity(dev: torch.device) -> None:
    """Phase 4 for this slice's models, fp32, the card against the same
    weights on the CPU within 1e-4 and with equal greedy streams:
    ``reduced_config`` of qwen2-vl-72b (4 layers, M-RoPE sections (2, 3,
    3)) prefilled from precomputed embeddings [2, 24, d] with distinct
    4 x 4 grid (t, h, w) streams, then four teacher-forced decode steps on
    the paged cache the prefill rows went into; recurrentgemma-9b (8
    layers, window 16) prefilled whole (two rows of 24), then chunks of 8
    into the paged cache (state rows, rings) with the second row's last
    chunk padded, then four decode steps; each model's engine streams
    (paged; recurrentgemma whole-prompt and with chunk 4)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import PagedKVCache
    from repro_torch.serving.engine import Engine
    cpu = torch.device("cpu")
    for arch in (QWEN_ARCH, RG_ARCH):
        cfg = reduced_config(arch)
        params = {cpu: dec.init_lm(torch.Generator().manual_seed(0), cfg,
                                   cpu)}
        params[dev] = _to(params[cpu], dev)
        rng = np.random.default_rng(16)
        lens = np.asarray([24, 21])
        toks = rng.integers(1, cfg.vocab_size, size=(2, 24))
        emb = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
        teacher = rng.integers(1, cfg.vocab_size, size=(4, 2))
        got = {}
        with torch.no_grad():
            for d in (cpu, dev):
                t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
                    np.asarray(a)).to(d, dt)
                p = params[d]
                kv = PagedKVCache(cfg, max_slots=2, max_seq_len=40,
                                  block_size=8, device=d)
                if arch == QWEN_ARCH:
                    for slot in range(2):
                        kv.allocate(slot, 28)
                    logits, pre = dec.lm_forward(p, {
                        "inputs": t(emb, torch.float32),
                        "positions": _grid_positions(2, 24, d)}, cfg)
                    kv.insert_prefill(pre, [0, 1], kv.table())
                    mid = None
                    start = np.asarray([24, 24])
                else:
                    logits, _ = dec.lm_forward(p, {"inputs": t(toks)}, cfg)
                    for slot in range(2):
                        kv.allocate(slot, int(lens[slot]) + 4)
                    chunks = []
                    for c in range(0, 24, 8):
                        cl = np.clip(lens - c, 0, 8)
                        chunks.append(dec.lm_chunk_step(
                            p, kv.engine_cache(), t(toks[:, c:c + 8]),
                            t([c, c], torch.int32), cfg,
                            block_table=kv.table(), slots=t([0, 1]),
                            chunk_lens=t(cl))[0])
                    mid = torch.cat(chunks, 1)
                    mid = torch.cat([mid[0, :24], mid[1, :21]])
                    start = lens
                steps = [dec.lm_decode_step(
                    p, kv.engine_cache(), t(teacher[k]),
                    t(start + k, torch.int32), cfg, block_table=kv.table(),
                    kv_max_len=40)[0] for k in range(teacher.shape[0])]
                got[d] = (logits, mid, torch.stack(steps), kv.leaf_kinds())
        if arch == QWEN_ARCH:
            _close(f"{arch} prefill logits from embeddings, grid streams",
                   got[dev][0], got[cpu][0])
        else:
            _close(f"{arch} prefill logits", got[dev][0], got[cpu][0])
            _close(f"{arch} paged chunk-8 logits", got[dev][1], got[cpu][1])
        _close(f"{arch} decode logits", got[dev][2], got[cpu][2])
        log(f"[parity] {arch}: leaf kinds {got[dev][3]}")
        prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
                   for L in (30, 21, 9, 26)]
        for chunk in ((0, 4) if arch == RG_ARCH else (0,)):
            streams = {d: Engine(cfg, params[d], max_slots=2, max_seq_len=48,
                                 prefill_chunk=chunk, device=d
                                 ).generate(prompts, 8)
                       for d in (cpu, dev)}
            same = streams[dev] == streams[cpu]
            log(f"[parity] {arch} greedy token streams (chunk {chunk}), card "
                f"vs CPU: {'identical' if same else 'DIFFER'}")
            if not same:
                raise SystemExit(f"[parity] {arch} greedy streams differ")


def embeddings_arm(dev, card: str, cfg, params) -> dict:
    """Phase 12's qwen2-vl embeddings arm on the contiguous cache:
    EMB_B x EMB_S token ids; the token prefill; ``embed[tokens]`` as
    precomputed embeddings with three equal M-RoPE streams (gate: logits
    bitwise the token prefill's); the same embeddings with distinct 4 x 4
    grid (t, h, w) streams (reported: how far its logits move), whose
    cache goes into the contiguous rows for EMB_STEPS greedy
    ``lm_decode_step``s.  Gates: the bitwise prefill, finite decode
    logits, the launch arithmetic (flash on ``wgmma_tma``, the contiguous
    decode kernel, RMSNorm by route)."""
    from repro_torch.kernels import ops
    from repro_torch.models import decoder as dec
    from repro_torch.models.rope import mrope_positions_default
    from repro_torch.serving.cache import insert_rows
    g = torch.Generator(device=dev).manual_seed(12)
    toks = torch.randint(1, cfg.vocab_size, (EMB_B, EMB_S), generator=g,
                         device=dev)
    cap = EMB_S + EMB_STEPS
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        by_tok, _ = dec.lm_forward(params, {"inputs": toks}, cfg)
        emb = params["embed"][toks]
        by_emb, _ = dec.lm_forward(params, {
            "inputs": emb,
            "positions": mrope_positions_default(EMB_B, EMB_S, device=dev)},
            cfg)
        bitwise = torch.equal(by_tok, by_emb)
        del by_emb
        logits, pre = dec.lm_forward(params, {
            "inputs": emb, "positions": _grid_positions(EMB_B, EMB_S, dev)},
            cfg)
        moved = (logits - by_tok).abs()
        moved = {"max": moved.max().item(), "mean": moved.mean().item(),
                 "argmax_equal_rows": (logits.argmax(-1) == by_tok.argmax(-1))
                 .float().mean().item()}
        del by_tok
        cache = dec.init_cache(cfg, EMB_B, cap, device=dev)
        insert_rows(cache, pre, range(EMB_B))
        del pre
        tok = logits[:, -1].argmax(-1)
        del logits
        steps, finite = [], True
        for k in range(EMB_STEPS):
            pos = torch.full((EMB_B,), EMB_S + k, dtype=torch.int32,
                             device=dev)
            out, _ = dec.lm_decode_step(params, cache, tok, pos, cfg)
            finite &= bool(torch.isfinite(out).all())
            tok = out.argmax(-1)
            steps.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    c = {"P": 3, "T": EMB_STEPS, "capacity": cap, "contiguous": True}
    want = layer_arith(cfg, c)
    gates = {"embeddings = tokens bitwise": bitwise,
             "decode logits finite": finite,
             "launch arithmetic": {k: launches[k] for k in want} == want,
             "flash route": ops.flash_attention.routes["wgmma_tma"]
             == launches["flash_attention"],
             "RMSNorm routes": dict(ops.rmsnorm.routes)
             == norm_routes("layers", cfg, c)}
    out = {"moved": moved, "wall_s": wall, "launches": launches,
           "gates": gates,
           "streams": torch.stack(steps, 1).tolist()}
    log(f"[phase12] {card} | {cfg.name} embeddings arm: precomputed "
        f"embeddings [{EMB_B},{EMB_S},{cfg.d_model}], grid (t, h, w) "
        f"positions [3,{EMB_B},{EMB_S}], then {EMB_STEPS} decode steps on "
        f"the contiguous cache, wall {wall:.3f}s; distinct streams moved the "
        f"logits by {json.dumps(moved)} from the equal-stream ones; "
        f"launches {json.dumps(launches)}; arithmetic {json.dumps(want)}; "
        f"gates {json.dumps(gates)}")
    if not all(gates.values()):
        raise SystemExit(f"[phase12] embeddings arm: gates {gates}")
    return out


def serve_phase12(dev, card: str, runs: dict) -> None:
    """Phase 12, bf16, seeded random weights, every prompt admitted in one
    round: qwen2-vl-72b at full width, 16 of its 80 layers
    (``qwen_config``), 8 x (512 / 32) sync then planned (every layer
    paged), then its embeddings arm; recurrentgemma-9b, nothing cut, 8 x
    (2048 / 64), capacity 2112 past its 2048 window (its 12 attention
    layers ring rows, its 26 RG-LRU layers state rows), sync, planned,
    then sync with ``prefill_chunk`` 512."""
    t0 = time.perf_counter()
    qcfg = qwen_config()
    log(f"[phase12] {QWEN_ARCH}: cut to {QWEN_LAYERS} of 80 layers (72.7 B "
        "parameters are ~145 GB in bf16, past one 80 GB card); widths, "
        "heads, vocabulary and M-RoPE sections as published")
    emb = {}
    runs[QWEN_ARCH] = serve_layer_model(
        dev, card, QWEN_ARCH, QWEN_PROMPT, QWEN_NEW, planned=True, cfg=qcfg,
        store=PHASE12,
        after=lambda cfg, params: emb.update(embeddings_arm(dev, card, cfg,
                                                            params)))
    PHASE12[QWEN_ARCH]["embeddings"] = {k: v for k, v in emb.items()
                                        if k != "streams"}
    PHASE12[QWEN_ARCH]["cut"] = f"{QWEN_LAYERS} of 80 layers"
    runs[RG_ARCH] = serve_layer_model(
        dev, card, RG_ARCH, RG_PROMPT, RG_NEW, planned=True,
        cap=RG_PROMPT + RG_NEW, chunk=RG_CHUNK, store=PHASE12)
    runs[RG_ARCH + " chunked"] = PHASE12[RG_ARCH]["chunk"]["launches"]
    kinds = PHASE12[RG_ARCH]["sync"]
    want = ({"ring": 12, "state": 26}, {"state": 8, "ring": 2})
    if (kinds["layer_kinds"], kinds["leaf_kinds"]) != want:
        raise SystemExit(f"[phase12] recurrentgemma-9b layers "
                         f"{kinds['layer_kinds']}, leaves "
                         f"{kinds['leaf_kinds']}: want the 12 attention "
                         "layers' K/V as rings and the 26 RG-LRU layers' "
                         "state as rows (leaves: 2 ring, 8 state)")
    if PHASE12[QWEN_ARCH]["sync"]["leaf_kinds"] != {"paged": 2}:
        raise SystemExit("[phase12] qwen2-vl-72b: want every layer paged")
    PHASE12["seconds"] = time.perf_counter() - t0
    log(f"[phase12] phase 12 took {PHASE12['seconds']:.1f}s")


def phase12_summary() -> str:
    return json.dumps(
        {k: ({m: ({x: y for x, y in f.items() if x != "launches"}
                  if isinstance(f, dict) else f) for m, f in v.items()}
             if isinstance(v, dict) else v)
         for k, v in PHASE12.items()}, default=str)


# ---------------------------------------------------------------------------
# phases 3, 4 and 13 for deepseek-v2-236b and deepseek-v3-671b (MLA over
# paged latent pools, capacity-routed MoE)
# ---------------------------------------------------------------------------

DS_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
# each model's layers on one card: the dense prefix, then MoE layers
DS_LAYERS = {"deepseek-v2-236b": 8, "deepseek-v3-671b": 5}
DS_FULL = {"deepseek-v2-236b": 60, "deepseek-v3-671b": 61}
DS_PROMPT, DS_NEW = 512, 32                        # phase 13's requests
PHASE13 = {}          # the figures of phase 13, for the summary


def ds_config(arch: str):
    """``arch`` cut to ``DS_LAYERS`` of its layers, widths untouched:
    deepseek-v2-236b's 60 layers (236 B parameters, ~472 GB in bf16) to
    8 (its dense layer and 7 MoE layers, ~29.2 B, ~58.4 GB: each MoE
    layer holds its 160 routed experts, 3.97 B); deepseek-v3-671b's 61
    (~1.34 TB) to 5 (its 3 dense layers and 2 MoE layers of 256 experts,
    11.51 B each; ~26.6 B, ~53.2 GB)."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(n_layers=DS_LAYERS[arch])


def mla_flash_row(dev, g):
    """Phase 3, flash at deepseek's MLA prefill (both models): q, k [SLOTS,
    DS_PROMPT, 128, 192] (nope 128 + rope 64; k_rope broadcast to the
    heads), v [SLOTS, DS_PROMPT, 128, 128] bf16, causal, on the wgmma
    route; against its plain version (2e-2); SDPA's memory-efficient
    backend (the one that takes a value width unlike the q / k width) at
    the same shape as its library time; both as device work."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    m = ds_config(DS_ARCHS[0]).mla
    H, hd, dv = 128, m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    B, S, bf = SLOTS, DS_PROMPT, torch.bfloat16
    q, k = (torch.randn(B, S, H, hd, generator=g, device=dev).to(bf)
            for _ in range(2))
    v = torch.randn(B, S, H, dv, generator=g, device=dev).to(bf)
    routes0 = dict(fa.flash_attention.routes)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    took = {r for r, c in fa.flash_attention.routes.items()
            if c != routes0[r]}
    want_route = fa.route(bf, hd, True, dv)
    if took != {want_route} or want_route != "wgmma_tma":
        raise SystemExit(f"[kernel] flash_attention at MLA's widths took "
                         f"{took}, want wgmma_tma")
    want = ref.flash_attention_plain(q, k, v, causal=True)
    sets = [(q, k, v)]
    kern = lambda q, k, v: ops.flash_attention(q, k, v,  # noqa: E731
                                               causal=True)
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def lib(a, b, c):
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(a, b, c, is_causal=True)

    t = device_timing(kern, lib, sets, [(qq, kk, vv)], 20)
    p_ms = time_ms(lambda q, k, v: ref.flash_attention_plain(
        q, k, v, causal=True), sets, 2)
    row = _report("flash_attention", "cuda",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:79", out, want,
                  t["ms"], p_ms, t["library_ms"], nbytes(q, k, v, out),
                  2.0 * B * H * (hd + dv) * S * (S + 1) / 2, BF16_FLOP_S)
    row.update(kernel_route=want_route, run=DS_ARCHS[0],
               library_ms_why="SDPA, memory-efficient backend (value "
                              "width 128 unlike the q / k width 192)")
    timed_extras(row, t, f"deepseek MLA prefill: q, k [{B},{S},{H},{hd}], "
                         f"v [{B},{S},{H},{dv}] bf16, causal; route "
                         f"{want_route}")
    del q, k, v, qq, kk, vv, out, want
    torch.cuda.empty_cache()
    return row


def check_slice17_kernels(dev, g, rows) -> None:
    """Phase 3 for deepseek-v2 / -v3, appended to the flash row's shapes:
    flash at their MLA prefill (q / k width 192, value width 128,
    ``wgmma_tma``).  Their decode is plain products (the absorbed form,
    as the reference's): no decode kernel shape of theirs."""
    by = {r["name"]: r for r in rows}
    by["flash_attention"]["shapes"].append(mla_flash_row(dev, g))


def check_slice17_parity(dev: torch.device) -> None:
    """Phase 4 for deepseek-v2 and -v3, fp32, the card against the same
    weights on the CPU within 1e-4 and with equal greedy streams:
    ``reduced_config`` (4 layers: a dense layer then 3 MoE layers, kv_lora
    16, 8 experts top 2; v2 softmax routing and q_lora_rank 0, v3
    sigmoid_bias and q_lora_rank 24) prefilled from two rows of 24 tokens,
    the latents put into the paged cache, then four teacher-forced decode
    steps; each model's engine streams (paged, four prompts on two slots,
    so a lane idles while the last request decodes)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import PagedKVCache
    from repro_torch.serving.engine import Engine
    cpu = torch.device("cpu")
    for arch in DS_ARCHS:
        cfg = reduced_config(arch)
        params = {cpu: dec.init_lm(torch.Generator().manual_seed(0), cfg,
                                   cpu)}
        params[dev] = _to(params[cpu], dev)
        rng = np.random.default_rng(17)
        toks = rng.integers(1, cfg.vocab_size, size=(2, 24))
        teacher = rng.integers(1, cfg.vocab_size, size=(4, 2))
        got = {}
        with torch.no_grad():
            for d in (cpu, dev):
                t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
                    np.asarray(a)).to(d, dt)
                p = params[d]
                kv = PagedKVCache(cfg, max_slots=2, max_seq_len=40,
                                  block_size=8, device=d)
                for slot in range(2):
                    kv.allocate(slot, 28)
                logits, pre = dec.lm_forward(p, {"inputs": t(toks)}, cfg)
                kv.insert_prefill(pre, [0, 1], kv.table())
                steps = [dec.lm_decode_step(
                    p, kv.engine_cache(), t(teacher[k]),
                    t([24 + k] * 2, torch.int32), cfg,
                    block_table=kv.table(), kv_max_len=40)[0]
                    for k in range(teacher.shape[0])]
                got[d] = (logits, torch.stack(steps), kv.leaf_kinds())
        _close(f"{arch} prefill logits", got[dev][0], got[cpu][0])
        _close(f"{arch} decode logits (latent pools)", got[dev][1],
               got[cpu][1])
        log(f"[parity] {arch}: leaf kinds {got[dev][2]}")
        prompts = [rng.integers(1, cfg.vocab_size, size=(L,)).tolist()
                   for L in (30, 21, 9, 26)]
        streams = {d: Engine(cfg, params[d], max_slots=2, max_seq_len=48,
                             device=d).generate(prompts, 8)
                   for d in (cpu, dev)}
        same = streams[dev] == streams[cpu]
        log(f"[parity] {arch} greedy token streams, card vs CPU: "
            f"{'identical' if same else 'DIFFER'}")
        if not same:
            raise SystemExit(f"[parity] {arch} greedy streams differ")


def serve_phase13(dev, card: str, runs: dict) -> None:
    """Phase 13, bf16, seeded random weights, every prompt admitted in one
    round (MoE prefills at exact length: one prefill call of SLOTS x
    DS_PROMPT rows), SLOTS x (DS_PROMPT / DS_NEW) greedy, sync then
    planned: deepseek-v2-236b at 8 of its 60 layers and deepseek-v3-671b
    at 5 of its 61 (``ds_config``), at published widths, heads, experts,
    top-k, ranks and vocabulary.  Every layer's latents are pools; the
    gates of ``serve_layer_model`` (every request finished, the launch
    arithmetic, every flash launch on ``wgmma_tma``, the RMSNorm routes,
    planned streams bitwise sync), the MoE's routed and dropped pairs
    printed.  The earlier phases' models are freed before each model is
    drawn."""
    t0 = time.perf_counter()
    for arch in DS_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = ds_config(arch)
        log(f"[phase13] {arch}: cut to {cfg.n_layers} layers "
            f"({len(cfg.pattern_prefix)} dense + {cfg.pattern_repeat} MoE); "
            "widths, heads, experts, top-k, ranks and vocabulary as "
            "published")
        runs[arch] = serve_layer_model(dev, card, arch, DS_PROMPT, DS_NEW,
                                       planned=True, cfg=cfg, store=PHASE13)
        PHASE13[arch]["cut"] = f"{cfg.n_layers} of {DS_FULL[arch]} layers"
        if PHASE13[arch]["sync"]["leaf_kinds"] != {"paged": 2 * (
                len(cfg.pattern_prefix) + len(cfg.pattern_unit))}:
            raise SystemExit(f"[phase13] {arch}: want every layer's "
                             "latents paged")
    PHASE13["seconds"] = time.perf_counter() - t0
    log(f"[phase13] phase 13 took {PHASE13['seconds']:.1f}s")


def phase13_summary() -> str:
    return json.dumps(
        {k: ({m: ({x: y for x, y in f.items() if x != "launches"}
                  if isinstance(f, dict) else f) for m, f in v.items()}
             if isinstance(v, dict) else v)
         for k, v in PHASE13.items()}, default=str)


# ---------------------------------------------------------------------------
# phases 3, 4 and 15 for whisper-medium (the encoder, cross-attention and
# the encoder-decoder cache, on the contiguous cache)
# ---------------------------------------------------------------------------

WH_ARCH = "whisper-medium"
WH_PROMPT, WH_NEW = 4, 64           # phase 15's decoder prompt, new tokens
PHASE15 = {}          # the figures of phase 15, for the summary


def whisper_flash_row(dev, g, Sq: int, role: str):
    """Phase 3, flash at whisper-medium's full (non-causal) attention, bf16,
    16 heads of 64, G 1: q [SLOTS, Sq, 16, 64] over k, v [SLOTS, 1500,
    16, 64], the encoder's self-attention (Sq 1500) or the decoder's
    cross-attention prefill (Sq WH_PROMPT).  1500 = 23 x 64 + 28: the
    last key tile runs past the keys, so its mask runs in full mode too.
    Gated on the ``wgmma_tma`` route, against the plain version (2e-2,
    ``row_rel_err`` within FLASH_ROW_REL_TOL); SDPA (K / V transposed
    beforehand, untimed) beside it; both as device work."""
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_medium import ENC_FRAMES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    cfg = get_config(WH_ARCH)
    B, H, hd, Sk, bf = (SLOTS, cfg.n_heads, cfg.head_dim, ENC_FRAMES,
                        torch.bfloat16)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    one = B * (Sq + 2 * Sk) * H * hd * 2
    sets = [(randn(B, Sq, H, hd), randn(B, Sk, H, hd), randn(B, Sk, H, hd))
            for _ in range(copies_for(one))]
    q, k, v = sets[0]
    routes0 = dict(fa.flash_attention.routes)
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    took = {r for r, c in fa.flash_attention.routes.items()
            if c != routes0[r]}
    if took != {"wgmma_tma"} or fa.route(bf, hd, True) != "wgmma_tma":
        raise SystemExit(f"[kernel] flash_attention at whisper's {role} "
                         f"took {took}, want wgmma_tma")
    want = ref.flash_attention_plain(q, k, v, causal=False)
    rel = row_rel_err(out, want)

    def kern(q, k, v):
        return ops.flash_attention(q, k, v, causal=False)

    lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in st)
                for st in sets]
    t = device_timing(kern, F.scaled_dot_product_attention, sets, lib_sets,
                      50)
    del lib_sets
    p_ms = time_ms(lambda q, k, v: ref.flash_attention_plain(
        q, k, v, causal=False), sets, 4)
    row = _report("flash_attention", "cuda",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:79", out, want,
                  t["ms"], p_ms, t["library_ms"], nbytes(q, k, v, out),
                  4.0 * B * H * hd * Sq * Sk, BF16_FLOP_S)
    row.update(kernel_route="wgmma_tma", run="whisper", row_rel_err=rel)
    log(f"[kernel]   flash_attention whisper {role}: row_rel_err {rel:.3e} "
        f"(tol {FLASH_ROW_REL_TOL})")
    if rel > FLASH_ROW_REL_TOL:
        raise SystemExit(f"[kernel] flash_attention at whisper's {role}: "
                         f"row_rel_err {rel:.3e}")
    timed_extras(row, t, f"whisper-medium {role}: q [{B},{Sq},{H},{hd}], "
                         f"k, v [{B},{Sk},{H},{hd}] bf16, full (no causal "
                         "mask); route wgmma_tma")
    del sets, q, k, v, out, want
    torch.cuda.empty_cache()
    return row


def whisper_decode_row(dev, g):
    """Phase 3, ``decode_attention`` at whisper-medium's cross-attention
    decode: q [SLOTS, 16, 64] bf16 over the encoder's K/V [SLOTS, 1500,
    16, 64], every row's length 1500, no max_len cut, G 1 (the cache is
    only read).  Against the plain version (2e-2); SDPA beside it (one
    query row, K / V transposed beforehand, untimed; no mask: every row
    is live), both as device work; its split plan and share of the
    bound (each K/V row read once)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_medium import ENC_FRAMES
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    cfg = get_config(WH_ARCH)
    B, H, hd, Sk, bf = (SLOTS, cfg.n_heads, cfg.head_dim, ENC_FRAMES,
                        torch.bfloat16)
    lengths = torch.full((B,), Sk, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    sets = [(randn(B, H, hd), randn(B, Sk, H, hd), randn(B, Sk, H, hd))
            for _ in range(copies_for(2 * B * Sk * H * hd * 2))]

    def kern(q, k, v):
        return ops.decode_attention(q, k, v, lengths)

    def plain(q, k, v):
        return ref.decode_attention_plain(q, k, v, lengths)

    out, want = kern(*sets[0]), plain(*sets[0])
    p_ms = time_ms(plain, sets, 20)
    lib_sets = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous()) for q, k, v in sets]
    t = device_timing(kern, F.scaled_dot_product_attention, sets, lib_sets)
    del lib_sets
    q = sets[0][0]
    row = _report("decode_attention", "cuda",
                  "src/repro_torch/kernels/csrc/paged_decode.cu",
                  "src/repro/kernels/decode_attention.py:92", out, want,
                  t["ms"], p_ms, t["library_ms"],
                  B * Sk * H * hd * 2 * 2 + nbytes(q, lengths, out),
                  4.0 * B * Sk * H * hd, BF16_FLOP_S)
    decode_extras(row, t, Sk, B * H, None, Sk)
    row.update(run="whisper",
               at=f"whisper-medium cross-attention decode: q [{B},{H},{hd}] "
                  f"bf16 over the encoder's K/V [{B},{Sk},{H},{hd}], lengths "
                  f"{Sk}, no max_len (G 1, read only)")
    log(f"[kernel]   decode_attention at {row['at']}")
    del sets, out, want
    torch.cuda.empty_cache()
    return row


def check_slice21_kernels(dev, g, rows) -> None:
    """Phase 3 for whisper-medium, appended to the flash and the bf16
    ``decode_attention`` rows' shapes: flash full at the encoder's and
    the cross prefill's shapes (the table's first hd-64 rows), and the
    contiguous decode at the cross decode's."""
    by = {r["name"]: r for r in rows}
    from repro_torch.configs.whisper_medium import ENC_FRAMES
    by["flash_attention"]["shapes"] += [
        whisper_flash_row(dev, g, ENC_FRAMES, "encoder self-attention"),
        whisper_flash_row(dev, g, WH_PROMPT, "cross-attention prefill")]
    by["decode_attention"]["shapes"].append(whisper_decode_row(dev, g))


def _whisper_inputs(cfg, dev, rows: int, frames: int, prompt: int,
                    seed: int):
    """Seeded frame embeddings [rows, frames, d] fp32 and prompt tokens
    [rows, prompt] int32, drawn on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = torch.randn(rows, frames, cfg.d_model, generator=g, device=dev)
    tok = torch.randint(1, cfg.vocab_size, (rows, prompt), generator=g,
                        device=dev, dtype=torch.int32)
    return enc, tok


def check_whisper_parity(dev: torch.device) -> None:
    """Phase 4 for whisper-medium, fp32 (``reduced_config``: 2 encoder
    and 3 decoder layers, d 64, 4 heads of 64), one seeded tree on the
    card and the CPU, 2 rows of 40 frames and 5 prompt tokens: prefill
    logits and every cache leaf (the decoder's K/V and the encoder's),
    ``pad_cache`` then 8 greedy decode steps (each device its own
    tokens: logits within 1e-4, streams identical), and a 4-token chunk
    after the prefill, card against CPU within 1e-4."""
    from repro_torch.common.pytree import tree_paths
    from repro_torch.configs import reduced_config
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import pad_cache
    cpu = torch.device("cpu")
    cfg = reduced_config(WH_ARCH)
    params = {cpu: dec.init_lm(torch.Generator().manual_seed(0), cfg, cpu)}
    params[dev] = _to(params[cpu], dev)
    enc, tok = _whisper_inputs(cfg, cpu, 2, 40, 5, 21)
    chunk = torch.randint(1, cfg.vocab_size, (2, 4), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(22))
    got = {}
    with torch.no_grad():
        for d in (cpu, dev):
            p = params[d]
            logits, cache = dec.lm_forward(
                p, {"inputs": tok.to(d), "enc_inputs": enc.to(d)}, cfg)
            leaves = [l.clone() for _, l in tree_paths(cache)]
            pos = torch.full((2,), 5, dtype=torch.int32, device=d)
            # the chunk writes its own padded copy of the self K/V
            ch, _ = dec.lm_chunk_step(p, pad_cache(cache, cfg, 16),
                                      chunk.to(d), pos, cfg)
            cache = pad_cache(cache, cfg, 16)
            t, steps, stream = logits[:, -1].argmax(-1).int(), [], []
            for i in range(8):
                lg, cache = dec.lm_decode_step(p, cache, t, pos + i, cfg)
                steps.append(lg)
                t = lg.argmax(-1).int()
                stream.append(t.tolist())
            got[d] = (logits, leaves, ch, torch.stack(steps), stream)
    _close("whisper prefill logits", got[dev][0], got[cpu][0])
    for i, (a, b) in enumerate(zip(got[dev][1], got[cpu][1])):
        _close(f"whisper prefill cache leaf {i}", a, b)
    _close("whisper chunk logits", got[dev][2], got[cpu][2])
    _close("whisper decode logits", got[dev][3], got[cpu][3])
    same = got[dev][4] == got[cpu][4]
    log(f"[parity] whisper-medium greedy token streams, card vs CPU: "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("[parity] whisper-medium greedy streams differ")


def _whisper_generate(params, cfg, batch, dev, teacher=None):
    """lm_forward (prefill), pad_cache to WH_PROMPT + WH_NEW, then
    WH_NEW - 1 decode steps: greedy, or fed ``teacher`` [B, WH_NEW]'s
    tokens.  Returns (prefill logits, the decode steps' logits [steps, B,
    V], the stream [B, WH_NEW], TTFT s, each step's s, total s), every
    time on the host's clock around synchronised work."""
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import pad_cache
    B = batch["inputs"].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = dec.lm_forward(params, batch, cfg)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    cache = pad_cache(cache, cfg, WH_PROMPT + WH_NEW)
    stream, step_logits, step_s = [tok], [], []
    for i in range(WH_NEW - 1):
        t1 = time.perf_counter()
        feed = tok if teacher is None else teacher[:, i]
        pos = torch.full((B,), WH_PROMPT + i, dtype=torch.int32, device=dev)
        lg, cache = dec.lm_decode_step(params, cache, feed, pos, cfg)
        tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        stream.append(tok)
        step_logits.append(lg)
    total = time.perf_counter() - t0
    return (logits, torch.stack(step_logits), torch.stack(stream, 1), ttft,
            step_s, total)


def _sdpa_flash(q, k, v, *, causal=True, **rest):
    """SDPA in flash's place, a library control for phase 15's logits:
    whisper's calls have G 1 and no window, softcap or offsets."""
    if any(x is not None for x in rest.values()) or q.shape[2] != k.shape[2]:
        raise ValueError("the SDPA control takes G 1, no window, softcap "
                         "or offsets")
    out = torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), is_causal=causal)
    return out.transpose(1, 2).contiguous()


def _swapped_kernels(flash):
    """ops.flash_attention swapped for ``flash`` and ops.decode_attention
    for its plain version (on CUDA tensors); returns the function that
    puts both back."""
    from repro_torch.kernels import ops, ref
    saved = (ops.flash_attention, ops.decode_attention)
    ops.flash_attention = flash

    def decode_plain(q, k, v, lengths, plan_scale=1, **kw):
        return ref.decode_attention_plain(q, k, v, lengths, **kw)

    ops.decode_attention = decode_plain

    def restore():
        ops.flash_attention, ops.decode_attention = saved

    return restore


def _device_rows(prof, n: int):
    """(ms a call, launches a call, name) of every device-side event of
    a profile over ``n`` calls, largest first (an aten op's row repeats
    the device time of the kernels it launched, which have rows of their
    own)."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total / n / 1e3, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)


def whisper_train_step(dev: torch.device) -> None:
    """Phase 15: one AdamW ``make_train_step`` step (microbatches 2: the
    batch's enc_inputs split with the rest) of reduced whisper, fp32,
    from one seeded state on the card and on the CPU: loss within
    TRAIN_LOSS_TOL, params within 2 x lr with at most
    TRAIN_PARAM_SHARE of a leaf past TRAIN_PARAM_CLOSE, no kernel
    launched."""
    from repro_torch.common.pytree import tree_map, tree_paths
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import decoder as dec
    cpu = torch.device("cpu")
    cfg = reduced_config(WH_ARCH)
    init = dec.init_lm(torch.Generator().manual_seed(0), cfg, cpu)
    enc, tok = _whisper_inputs(cfg, cpu, 4, 40, 24, 23)
    tgt = torch.randint(0, cfg.vocab_size, (4, 24), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(24))
    got = {}
    ops.reset_launch_counts()
    for d in (cpu, dev):
        fn, opt_init, _ = make_train_step(cfg, microbatches=2, peak_lr=3e-3,
                                          warmup=0, total_steps=3)
        params = tree_map(lambda t: t.to(d, copy=True), init)
        params, _, m = fn(params, opt_init(params),
                          {"inputs": tok.to(d), "targets": tgt.to(d),
                           "enc_inputs": enc.to(d)})
        got[d] = (params, float(m["loss"]), float(m["lr"]))
    launched = {k: v for k, v in ops.counters().items() if v}
    rel = abs(got[dev][1] - got[cpu][1]) / abs(got[cpu][1])
    want = dict(tree_paths(got[cpu][0]))
    worst, share = 0.0, 0.0
    for p, leaf in tree_paths(got[dev][0]):
        err = (leaf.float().cpu() - want[p].float()).abs()
        worst = max(worst, err.max().item())
        share = max(share, (err > TRAIN_PARAM_CLOSE).float().mean().item())
    atol = 2 * got[cpu][2]
    log(f"[whisper] reduced train step card vs CPU: loss {got[dev][1]:.6f} "
        f"vs {got[cpu][1]:.6f} (rel {rel:.2e}, tol {TRAIN_LOSS_TOL}); params "
        f"max |diff| {worst:.3e} (tol {atol:.3e}), share over "
        f"{TRAIN_PARAM_CLOSE} {share:.2e} (tol {TRAIN_PARAM_SHARE}); "
        f"kernels launched {launched}")
    PHASE15["train_step"] = {"loss_card": got[dev][1], "loss_cpu": got[cpu][1],
                             "rel": rel, "params_max_diff": worst,
                             "params_share_off": share}
    if rel > TRAIN_LOSS_TOL or worst > atol or share > TRAIN_PARAM_SHARE \
            or launched:
        raise SystemExit("[whisper] reduced train step: card and CPU "
                         "disagree, or a kernel launched")


def whisper_step_bound(cfg, params, pos: int) -> dict:
    """Bytes a decode step at position ``pos`` must move and their time at
    HBM_BYTES_S: every decoder weight it reads (the cross-attention's wk
    and wv are not: the encoder K/V are cached), the tied embedding as
    the head, the final norm, the encoder K/V (every layer, every row)
    and the self K/V live at ``pos`` (pos + 1 rows)."""
    from repro_torch.common.pytree import tree_paths
    from repro_torch.configs.whisper_medium import ENC_FRAMES
    weights = sum(nbytes(leaf) for p, leaf in tree_paths(params["unit"])
                  if not p.endswith(("cross/wk", "cross/wv")))
    weights += nbytes(params["embed"]) + sum(
        nbytes(leaf) for _, leaf in tree_paths(params["final_norm"]))
    row = cfg.n_kv_heads * cfg.head_dim * 2 * 2            # K and V, bf16
    enc = cfg.n_layers * SLOTS * ENC_FRAMES * row
    own = cfg.n_layers * SLOTS * (pos + 1) * row
    total = weights + enc + own
    return {"weights_bytes": weights, "enc_kv_bytes": enc,
            "self_kv_bytes": own, "pos": pos,
            "bound_ms": total / HBM_BYTES_S * 1e3,
            "enc_kv_ms": enc / HBM_BYTES_S * 1e3}


def serve_whisper(dev: torch.device, card: str, runs: dict) -> None:
    """Phase 15: whisper-medium at full width and depth, bf16, seeded
    random weights and frame embeddings, SLOTS rows of WH_PROMPT prompt
    tokens, WH_NEW greedy tokens a row (``_whisper_generate``); the
    figures and gates of the module docstring's phase 15."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.whisper_medium import ENC_FRAMES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import decoder as dec
    from repro_torch.serving.cache import pad_cache
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WH_ARCH)
    L = cfg.n_layers
    params = dec.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    enc, tok = _whisper_inputs(cfg, dev, SLOTS, ENC_FRAMES, WH_PROMPT, 15)
    batch = {"inputs": tok, "enc_inputs": enc}
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[whisper] {cfg.name}: {n_params / 1e9:.3f} B parameters "
        f"({cfg.encdec.n_enc_layers} encoder + {L} decoder layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}); {SLOTS} "
        f"rows of {ENC_FRAMES} frames, {WH_PROMPT} prompt tokens, {WH_NEW} "
        "new tokens")
    with torch.no_grad():
        # warm-up: the prefill and two decode steps (cuBLAS, first loads)
        _, cache = dec.lm_forward(params, batch, cfg)
        cache = pad_cache(cache, cfg, WH_PROMPT + WH_NEW)
        for i in range(2):
            dec.lm_decode_step(params, cache, tok[:, 0], torch.full(
                (SLOTS,), WH_PROMPT + i, dtype=torch.int32, device=dev), cfg)
        del cache
        enc_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.encode(params, enc, cfg)
            torch.cuda.synchronize()
            enc_s.append(time.perf_counter() - t0)
        ttfts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = dec.lm_forward(params, batch, cfg)
            lg[:, -1].argmax(-1)
            torch.cuda.synchronize()
            ttfts.append(time.perf_counter() - t0)
        del lg
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        first, steps, stream, ttft, step_s, total = _whisper_generate(
            params, cfg, batch, dev)
        launches = ops.launch_counts()
        routes = dict(fa.flash_attention.routes)
        peak = torch.cuda.max_memory_allocated() / 1e9
    runs["whisper"] = launches
    ttfts.append(ttft)
    tpot = float(np.median(step_s)) * 1e3
    # the arithmetic: flash once per encoder layer (full), per decoder
    # layer (causal) and per cross layer (full); decode_attention twice a
    # decoder layer a step (self, cross); nothing else
    want = dict.fromkeys(launches, 0)
    n_flash = cfg.encdec.n_enc_layers + 2 * L
    want["flash_attention"] = n_flash
    want["decode_attention"] = 2 * L * (WH_NEW - 1)
    want_routes = {"wgmma_tma": n_flash, "cuda_core": 0}
    log(f"[whisper] launches {json.dumps(launches)}, flash routes "
        f"{json.dumps(routes)}; want {json.dumps(want)}, "
        f"{json.dumps(want_routes)}: "
        f"{'met' if launches == want and routes == want_routes else 'NOT MET'}")
    if launches != want or routes != want_routes:
        raise SystemExit("[whisper] kernel launches off the arithmetic")
    if tuple(stream.shape) != (SLOTS, WH_NEW) or not all(
            torch.isfinite(t).all() for t in (first, steps)):
        raise SystemExit("[whisper] streams or logits malformed")
    bound = whisper_step_bound(cfg, params, WH_PROMPT + WH_NEW // 2)
    # a decode step's device busy share: three steps at a mid position
    # (their rows are rewritten; the streams are already taken)
    busy = None
    with torch.no_grad():
        _, cache = dec.lm_forward(params, batch, cfg)
        cache = pad_cache(cache, cfg, WH_PROMPT + WH_NEW)
        pos = torch.full((SLOTS,), bound["pos"], dtype=torch.int32,
                         device=dev)
        feed = stream[:, 0].contiguous()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dec.encode(params, enc, cfg)
            torch.cuda.synchronize()
        rows = _device_rows(prof, 1)
        if rows:
            log(f"[whisper] encode (profiled): device busy "
                f"{sum(r[0] for r in rows):.3f} ms in "
                f"{sum(r[1] for r in rows):.0f} kernels")
            for ms, count, key in rows[:8]:
                log(f"[whisper]   {ms:9.3f} ms {count:6.0f}x  {key[:90]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                dec.lm_decode_step(params, cache, feed, pos, cfg)
            torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / 3
        del cache
    rows = _device_rows(prof, 3)
    if rows:
        busy = sum(r[0] for r in rows)
        log(f"[whisper] decode step (profiled): device busy {busy:.3f} ms of "
            f"TPOT p50 {tpot:.3f} ms unprofiled ({100 * busy / tpot:.1f} % "
            f"busy), {sum(r[1] for r in rows):.0f} kernels a step; "
            f"profiled step {prof_ms:.3f} ms")
        for ms, count, key in rows[:8]:
            log(f"[whisper]   {ms:9.3f} ms {count:6.0f}x  {key[:90]}")
    else:
        log("[whisper] the profiler saw no device time (busy share not "
            "measured)")
    # the same run through the plain versions of flash and
    # decode_attention, teacher-forced along the kernel run's streams;
    # then, as a control, with SDPA (a library's bf16 kernel) in flash's
    # place: how far one bf16 attention lies from the plain version
    from repro_torch.kernels import ref
    other = {}
    for name, flash in (("plain", ref.flash_attention_plain),
                        ("sdpa", _sdpa_flash)):
        restore = _swapped_kernels(flash)
        try:
            with torch.no_grad():
                other[name] = _whisper_generate(params, cfg, batch, dev,
                                                teacher=stream[:, 1:])[:2]
        finally:
            restore()
    checks = {}
    for i, what in enumerate(("prefill", "decode steps")):
        a, b, c_ = (first, steps)[i], other["plain"][i], other["sdpa"][i]
        diff = (a.float() - b.float()).abs()
        ctrl = (c_.float() - b.float()).abs()
        std = b.float().std().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        checks[what] = {"mean_abs_diff": diff.mean().item(),
                        "max_abs_diff": diff.max().item(), "logit_std": std,
                        "argmax_agree": agree,
                        "sdpa_mean_abs_diff": ctrl.mean().item(),
                        "sdpa_max_abs_diff": ctrl.max().item()}
        log(f"[whisper] {what} logits, kernels vs plain versions: mean "
            f"|diff| {diff.mean().item():.3e}, max {diff.max().item():.3e}, "
            f"limit {KERNEL_TOL * std:.3e} (2e-2 x std {std:.3f}); argmax "
            f"agreement {100 * agree:.2f} %; control, SDPA for flash vs "
            f"plain: mean {ctrl.mean().item():.3e}, max "
            f"{ctrl.max().item():.3e}")
        if diff.mean().item() > KERNEL_TOL * std:
            raise SystemExit(f"[whisper] {what} logits: kernels and plain "
                             "versions disagree")
    del other
    PHASE15.update({
        "card": card, "encode_ms_p50": float(np.median(enc_s)) * 1e3,
        "encode_ms": [x * 1e3 for x in enc_s],
        "ttft_ms_p50": float(np.median(ttfts)) * 1e3,
        "ttft_ms": [x * 1e3 for x in ttfts], "tpot_ms_p50": tpot,
        "tpot_ms_p90": float(np.percentile(step_s, 90)) * 1e3,
        "tokens_per_s": SLOTS * WH_NEW / total, "run_s": total,
        "peak_gb": peak, "params_b": n_params / 1e9,
        "decode_busy_ms": busy,
        "decode_busy_share": None if busy is None else busy / tpot,
        "decode_bound": bound, "launches": launches, "flash_routes": routes,
        "plain_checks": checks})
    log(f"[whisper] encode p50 {PHASE15['encode_ms_p50']:.3f} ms; TTFT p50 "
        f"{PHASE15['ttft_ms_p50']:.3f} ms (encode + decoder prefill); TPOT "
        f"p50 {tpot:.3f} ms (p90 {PHASE15['tpot_ms_p90']:.3f}); "
        f"{PHASE15['tokens_per_s']:.1f} tokens/s over the run; peak "
        f"{peak:.3f} GB [{card}]")
    gb = {k: bound[k] / 1e9 for k in ("weights_bytes", "enc_kv_bytes",
                                      "self_kv_bytes")}
    log(f"[whisper] decode step byte bound {bound['bound_ms']:.4f} ms at "
        f"position {bound['pos']}: weights {gb['weights_bytes']:.3f} GB, "
        f"encoder K/V {gb['enc_kv_bytes']:.3f} GB ({bound['enc_kv_ms']:.4f} "
        f"ms), self K/V {gb['self_kv_bytes']:.4f} GB; TPOT p50 is "
        f"{tpot / bound['bound_ms']:.1f} x it [{card}]")
    del params, first, steps
    gc.collect()
    torch.cuda.empty_cache()
    whisper_train_step(dev)
    PHASE15["seconds"] = time.perf_counter() - t_phase
    log(f"[whisper] phase 15 took {PHASE15['seconds']:.1f}s")


# ---------------------------------------------------------------------------
# phase 14: training (the reference's train path on plain ops: blockwise
# attention, plain norms, autograd, the reference's AdamW), checkpoint and
# resume, and the trained checkpoint served through the kernels
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
TRAIN_CUT = {"pt-6b-d4": 16, "dense-6b": 8}   # layers kept, of 32 each
TRAIN_B, TRAIN_S = 8, 512
TRAIN_LOSS_TOL = 1e-5     # losses, card against CPU, relative
# params after the steps, card against CPU: Adam moves an element by
# about lr whatever the size of its grad, so an element whose grad is
# within the two devices' rounding of zero can step the other way: every
# element within 2 x the steps' summed lr, and at most 1e-3 of a leaf's
# elements more than 1e-5 apart
TRAIN_PARAM_CLOSE, TRAIN_PARAM_SHARE = 1e-5, 1e-3
PHASE14 = {}          # the figures of phase 14, for the summary


def _run_steps(cfg, params, dev, dcfg, steps: int = TRAIN_STEPS):
    """``steps`` of ``make_train_step`` (warmup 2, so that every step
    after the first moves the params) on ``params`` (moved to ``dev``)
    from the data pipeline: (params, opt state, losses, grad norms,
    learning rates)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.data.pipeline import DataLoader
    from repro_torch.launch.steps import make_train_step
    fn, opt_init, _ = make_train_step(cfg, microbatches=1, peak_lr=3e-3,
                                      warmup=2, total_steps=steps)
    # a copy: the optimizer updates the params in place
    params = tree_map(lambda t: t.to(dev, copy=True), params)
    st = opt_init(params)
    losses, norms, lrs = [], [], []
    loader = DataLoader(dcfg)
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(loader).items()}
        params, st, m = fn(params, st, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    return params, st, losses, norms, lrs


def _card_vs_cpu(tag: str, arch: str, dev: torch.device, steps: int,
                 store: dict):
    """Reduced ``arch`` in fp32 (TF32 off) from one seeded train tree:
    ``steps`` train steps on the card and on the CPU.  Gates: losses
    within TRAIN_LOSS_TOL relative, params within the stated tolerance,
    no kernel launched by the train steps.  Returns the card's
    ``_run_steps`` result."""
    from repro_torch.common.pytree import tree_paths
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import model_fns
    cpu = torch.device("cpu")
    cfg = reduced_config(arch)
    init = model_fns(cfg)["init_train"](torch.Generator().manual_seed(0),
                                        cfg, cpu)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    ops.reset_launch_counts()
    got = {d: _run_steps(cfg, init, d, dcfg, steps) for d in (cpu, dev)}
    launched = {k: v for k, v in ops.counters().items() if v}
    if launched:
        raise SystemExit(f"[{tag}] {arch}: train steps launched kernels "
                         f"{launched}")
    lc, ld = got[cpu][2], got[dev][2]
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, ld))
    atol = 2 * sum(got[cpu][4])
    worst, share = 0.0, 0.0
    want = dict(tree_paths(got[cpu][0]))
    for p, leaf in tree_paths(got[dev][0]):
        err = (leaf.float().cpu() - want[p].float()).abs()
        worst = max(worst, err.max().item())
        share = max(share, (err > TRAIN_PARAM_CLOSE).float().mean().item())
    log(f"[{tag}] (a) {cfg.name} fp32, {steps} steps card vs CPU: losses "
        f"card {ld} CPU {lc} (max rel {rel:.2e}, tol {TRAIN_LOSS_TOL}); "
        f"grad norms card {got[dev][3]}; params max |diff| {worst:.3e} (tol "
        f"{atol:.3e} = 2 x summed lr), largest share over "
        f"{TRAIN_PARAM_CLOSE} {share:.2e} (tol {TRAIN_PARAM_SHARE})")
    store[f"parity {arch}"] = {"losses_card": ld, "losses_cpu": lc,
                               "max_rel": rel, "params_max_diff": worst,
                               "params_share_off": share}
    if rel > TRAIN_LOSS_TOL or worst > atol or share > TRAIN_PARAM_SHARE:
        raise SystemExit(f"[{tag}] (a) {arch}: card and CPU disagree")
    return got[dev]


def train_parity(dev: torch.device) -> dict:
    """Phase 14 (a): reduced PT and reduced dense, TRAIN_STEPS steps card
    vs CPU (``_card_vs_cpu``).  Returns the card-trained reduced PT's
    ``_run_steps`` result (for (d))."""
    trained = _card_vs_cpu("train", ARCH, dev, TRAIN_STEPS, PHASE14)
    _card_vs_cpu("train", DENSE_ARCH, dev, TRAIN_STEPS, PHASE14)
    return trained


def _first_params(cfg, dev):
    from repro_torch.launch.steps import model_fns
    return model_fns(cfg)["init"](torch.Generator(device=dev).manual_seed(0),
                                  cfg, dev)


def train_full(dev: torch.device, card: str, arch: str) -> None:
    """Phase 14 (b): ``arch`` at every published width, cut to
    TRAIN_CUT[arch] of its 32 layers, bf16 with AdamW's fp32 master,
    trained by ``launch.train.train_loop`` for TRAIN_STEPS steps of
    TRAIN_B x TRAIN_S tokens from the data pipeline.  Prints step ms
    (median of the last 3), tokens/s, peak memory, the loss per step and
    the model-FLOP share (6 N T a step over BF16_FLOP_S, N every
    parameter).  Gates: finite losses and grad norms, every parameter
    leaf changed, no kernel launched."""
    from repro_torch.common.pytree import count_params, tree_paths
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    cfg = get_config(arch).replace(n_layers=TRAIN_CUT[arch])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    marks, lines = [], []

    def mark(line):
        torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())
        lines.append(line)
        log(line)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_loop(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                     log_every=1, print_fn=mark, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in ops.counters().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
    ms = float(np.median(step_ms[-3:]))
    n = count_params(out["params"])
    tokens = TRAIN_B * TRAIN_S
    mfu = 6 * n * tokens / (ms / 1e3) / BF16_FLOP_S
    losses = [l for _, l in out["losses"]]
    norms = [float(ln.split("gnorm ")[1].split()[0]) for ln in lines[1:]]
    first = _first_params(cfg, dev)
    unchanged = [p for (p, a), (_, b) in zip(tree_paths(first),
                                             tree_paths(out["params"]))
                 if torch.equal(a, b)]
    del first
    fig = {"layers": f"{cfg.n_layers} of {get_config(arch).n_layers}",
           "params": n,
           "step_ms": step_ms, "step_ms_median_last3": ms,
           "tokens_per_s": tokens / (ms / 1e3), "peak_gb": peak / 1e9,
           "losses": losses, "grad_norms": norms, "model_flop_share": mfu,
           "wall_s": wall, "card": card}
    PHASE14[arch] = fig
    log(f"[train] (b) {card} | {arch} {cfg.dtype} + fp32 master at "
        f"{cfg.n_layers} of {get_config(arch).n_layers} layers "
        f"({n / 1e9:.3f} B params), batch {TRAIN_B} x "
        f"{TRAIN_S}: step ms {[round(x, 3) for x in step_ms]} (median of "
        f"the last 3 {ms:.3f}), {fig['tokens_per_s']:.1f} tokens/s, peak "
        f"{fig['peak_gb']:.3f} GB, losses {losses}, grad norms {norms}, "
        f"model-FLOP share {100 * mfu:.2f} % of {BF16_FLOP_S / 1e12:.0f} "
        f"TFLOP/s bf16 (6 N T, N = all {n} params)")
    bad = [x for x in losses + norms if not math.isfinite(x)]
    if bad or unchanged or launched or len(losses) != TRAIN_STEPS:
        raise SystemExit(f"[train] (b) {arch}: non-finite {bad}, unchanged "
                         f"leaves {unchanged}, kernels launched {launched}")
    del out
    gc.collect()
    torch.cuda.empty_cache()


def resume_check() -> None:
    """Phase 14 (c), in a process of its own (``CUBLAS_WORKSPACE_CONFIG``
    set before CUDA starts, ``torch.use_deterministic_algorithms(True)``):
    reduced PT on the card, 6 uninterrupted ``train_loop`` steps against
    3 steps, an ``AsyncCheckpointer`` save, a fresh ``train_loop`` that
    resumes, and 3 more.  Prints a JSON line: params and optimizer state
    bitwise equal or not."""
    import tempfile
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.common.pytree import tree_paths
    from repro_torch.configs import reduced_config
    from repro_torch.launch.train import train_loop
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = reduced_config(ARCH)
    kw = dict(batch=2, seq=32, device=dev, log_every=1, print_fn=log)
    whole = train_loop(cfg, steps=6, **kw)
    with tempfile.TemporaryDirectory() as d:
        train_loop(cfg, steps=3, ckpt_dir=d, ckpt_every=3, **kw)
        resumed = train_loop(cfg, steps=6, ckpt_dir=d, **kw)
    diff = []
    for key, name in (("params", "params"), ("opt_state", "opt")):
        want = dict(tree_paths(whole[key]))
        diff += [f"{name}/{p}" for p, leaf in tree_paths(resumed[key])
                 if not torch.equal(leaf, want[p])]
    print(json.dumps({"resume_bitwise": not diff, "differ": diff,
                      "first_resumed_step": resumed["losses"][0][0]}),
          flush=True)


def train_resume(dev: torch.device) -> None:
    """Phase 14 (c): ``resume_check`` in a child process; gated bitwise."""
    import os
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.resume_check()"],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    for ln in out.stdout.splitlines()[:-1]:
        log(f"[train] (c) {ln}")
    if out.returncode != 0:
        log(out.stderr[-4000:])
        raise SystemExit("[train] (c) the resume run failed")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["seconds"] = time.perf_counter() - t0
    PHASE14["resume"] = res
    log(f"[train] (c) resume after an AsyncCheckpointer save, deterministic "
        f"algorithms: params and optimizer state "
        f"{'bitwise equal' if res['resume_bitwise'] else 'DIFFER'} to 6 "
        f"uninterrupted steps ({res['seconds']:.1f}s)")
    if not res["resume_bitwise"] or res["first_resumed_step"] != 3:
        raise SystemExit(f"[train] (c) resume differs: {res['differ']}")


def train_then_serve(dev: torch.device, trained, runs: dict) -> None:
    """Phase 14 (d): the reduced PT trained on the card in (a), saved as
    a checkpoint and served by ``launch/serve.py --ckpt-dir`` on the card
    and on the CPU.  Gates: equal greedy streams (by the CLI's sha256),
    flash, paged decode and RMSNorm launched on the card."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint import store
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    params, st = trained[0], trained[1]
    digests = {}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, TRAIN_STEPS, {"params": params, "opt": st},
                   extra={"next_step": TRAIN_STEPS})
        for where in (str(dev), "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = serve.main(["--arch", ARCH, "--reduced", "--ckpt-dir",
                                   d, "--device", where, "--requests", "4",
                                   "--input-len", "16", "--output-len", "12",
                                   "--no-prefix-cache"])
            text = buf.getvalue()
            runs.setdefault("train-then-serve", ops.launch_counts())
            for ln in text.splitlines():
                log(f"[train] (d) {where}: {ln}")
            digests[where] = [ln for ln in text.splitlines()
                              if "output streams" in ln]
            if code != 0 or "loaded params from" not in text:
                raise SystemExit(f"[train] (d) serve on {where} failed")
    c = runs["train-then-serve"]
    used = {k: c[k] for k in FP_PATH}
    equal = digests[str(dev)] == digests["cpu"]
    PHASE14["serve"] = {"streams_equal": equal, "launches": used}
    log(f"[train] (d) trained checkpoint served: streams card vs CPU "
        f"{'equal' if equal else 'DIFFER'} ({digests['cpu']}); card "
        f"launches {used}")
    if not equal or not digests["cpu"] or not all(used.values()):
        raise SystemExit("[train] (d) the trained checkpoint's streams "
                         "differ, or a kernel of the path did not launch")


def train_phase(dev: torch.device, card: str, runs: dict) -> None:
    """Phase 14, (a) to (d)."""
    t0 = time.perf_counter()
    trained = train_parity(dev)
    train_then_serve(dev, trained, runs)
    del trained
    train_resume(dev)
    for arch in TRAIN_CUT:
        train_full(dev, card, arch)
    PHASE14["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 14 took {PHASE14['seconds']:.1f}s")


# ---------------------------------------------------------------------------
# phase 16: training the Mamba, RG-LRU and MLA + MoE models (train modes on
# plain ops: the sequential scan, blockwise attention, the MoE's dispatch
# and its auxiliary loss), and their trained checkpoints served through the
# kernels
# ---------------------------------------------------------------------------

TRAIN16_ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "deepseek-v2-236b",
                 "deepseek-v3-671b")
TRAIN16_STEPS = 3
# (b): layers kept of the published depth, rows of TRAIN_S tokens, the
# optimizer.  falcon-mamba-7b 8 of 64 (1.37 B params), recurrentgemma-9b
# 8 of 38 (two (rec, rec, attn) units and the (rec, rec) suffix; 2.65 B):
# AdamW, as the reference picks it by their counts.  deepseek-v2-236b 2 of
# 60 (the dense layer and one MoE layer of 160 routed experts stored as
# 256; 7.6 B): Adafactor, which the full 236 B model takes by the
# reference's threshold (AdamW's 16 B a parameter would need ~122 GB).
# deepseek-v3-671b trains on the CPU only: one MoE layer of 256 experts
# and its 3 dense layers need ~60 GB for bf16 params and grads alone.
TRAIN16_FULL = {"falcon-mamba-7b": (8, 8, "adamw"),
                "recurrentgemma-9b": (8, 8, "adamw"),
                "deepseek-v2-236b": (2, 4, "adafactor")}
PHASE16 = {}          # the figures of phase 16, for the summary


def active_params(cfg) -> int:
    """Parameters a token passes through: the serving tree's (a MoE's real
    experts only), its routed experts counted top_k / n_routed."""
    from repro_torch.common.pytree import count_params
    from repro_torch.models.decoder import lm_param_specs
    n = count_params(lm_param_specs(cfg))
    if cfg.moe is None:
        return n
    m = cfg.moe
    moe_layers = sum(cfg.spec(nm).mlp == "moe" for nm in cfg.layer_names)
    routed = moe_layers * 3 * m.n_routed_experts * cfg.d_model * m.d_expert
    return int(n - routed + routed * m.top_k / m.n_routed_experts)


def _adafactor_step(cfg):
    """deepseek-v2's step in (b): ``make_train_step``'s at one microbatch
    (``value_and_grad`` of ``lm_loss``, ``clip_by_global_norm``,
    ``warmup_cosine`` at warmup 1) with Adafactor in AdamW's place.  At 2
    of 60 layers the train tree counts 7.6 B, under the reference's 30 B
    threshold, so the count rule picks AdamW, whose 16 B a parameter
    (~122 GB) no single card holds; the full 236 B model takes Adafactor,
    and the reference has no option to choose it, so neither has the
    port.  Its metrics carry ``lm_loss``'s aux."""
    from repro_torch.launch import steps
    from repro_torch.models.decoder import lm_loss
    from repro_torch.optim import (adafactor_update, clip_by_global_norm,
                                   warmup_cosine)
    seen = {}

    def loss_fn(p, b):
        loss, metrics = lm_loss(p, b, cfg)
        seen["aux"] = metrics["aux"].detach()
        return loss, metrics

    def step(params, st, batch):
        loss, grads = steps.value_and_grad(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = warmup_cosine(st["step"], peak_lr=3e-3, warmup=1,
                           total=TRAIN16_STEPS)
        params, st = adafactor_update(grads, st, params, lr)
        return params, st, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                            "aux": seen["aux"]}

    return step


def train16_full(dev: torch.device, card: str, arch: str) -> None:
    """Phase 16 (b): ``arch`` at every published width, cut to
    TRAIN16_FULL's depth, bf16, TRAIN16_STEPS steps of rows x TRAIN_S
    tokens from the data pipeline.  falcon-mamba-7b and recurrentgemma-9b
    take the trainer's own step, ``make_train_step`` at one microbatch
    (AdamW, as the count rule picks it; no MoE layer, so no aux);
    deepseek-v2-236b takes ``_adafactor_step``.  Prints step ms (median
    of steps 1-2), tokens/s, peak memory, loss, aux and grad norm per
    step, and 6 N_active T over BF16_FLOP_S.  Gates: finite losses, aux
    and grad norms, every leaf changed, no kernel launched, peak under
    the card's memory."""
    from repro_torch.common.pytree import tree_paths
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import adafactor_init
    layers, rows, opt = TRAIN16_FULL[arch]
    full = get_config(arch)
    cfg = full.replace(n_layers=layers)
    n = steps._n_params(cfg)
    if opt == "adamw":
        step_fn, opt_init, name = steps.make_train_step(
            cfg, microbatches=1, peak_lr=3e-3, warmup=1,
            total_steps=TRAIN16_STEPS)
        if name != "adamw":
            raise SystemExit(f"[train16] (b) {arch}: the count rule picks "
                             f"{name}")
    else:
        step_fn, opt_init = _adafactor_step(cfg), adafactor_init
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    init = steps.model_fns(cfg)["init_train"]
    params = init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    st = opt_init(params)
    loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                   global_batch=rows))
    ops.reset_launch_counts()
    step_ms, per_step = [], []
    for _ in range(TRAIN16_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(loader).items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, st, metrics = step_fn(params, st, batch)
        torch.cuda.synchronize(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step.append({"loss": float(metrics["loss"]),
                         "aux": (float(metrics["aux"]) if "aux" in metrics
                                 else None),
                         "grad_norm": float(metrics["grad_norm"]),
                         "lr": float(metrics["lr"])})
        del metrics
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v for k, v in ops.counters().items() if v}
    del st
    gc.collect()
    torch.cuda.empty_cache()
    first = init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    unchanged = [p for (p, a), (_, b) in zip(tree_paths(first),
                                             tree_paths(params))
                 if torch.equal(a, b)]
    del first, params
    gc.collect()
    torch.cuda.empty_cache()
    ms = float(np.median(step_ms[1:]))
    tokens = rows * TRAIN_S
    n_active = active_params(cfg)
    mfu = 6 * n_active * tokens / (ms / 1e3) / BF16_FLOP_S
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    fig = {"layers": f"{layers} of {full.n_layers}", "batch": [rows, TRAIN_S],
           "optimizer": opt, "params": n, "params_active": n_active,
           "step_ms": step_ms, "step_ms_median_1_2": ms,
           "tokens_per_s": tokens / (ms / 1e3), "peak_gb": peak / 1e9,
           "allocated_before_gb": before / 1e9, "steps": per_step,
           "model_flop_share": mfu, "card": card}
    PHASE16[arch] = fig
    log(f"[train16] (b) {card} | {arch} {cfg.dtype} at {fig['layers']} "
        f"layers ({n / 1e9:.3f} B params in the train tree, "
        f"{n_active / 1e9:.3f} B active), {opt}, batch {rows} x {TRAIN_S}: "
        f"step ms {[round(x, 3) for x in step_ms]} (median of steps 1-2 "
        f"{ms:.3f}), {fig['tokens_per_s']:.1f} tokens/s, peak "
        f"{fig['peak_gb']:.3f} GB of {total_mem / 1e9:.1f} ({before / 1e9:.3f}"
        f" GB held before the run); per step "
        f"{json.dumps(per_step)}; 6 N_active T share {100 * mfu:.2f} % of "
        f"{BF16_FLOP_S / 1e12:.0f} TFLOP/s bf16")
    bad = [x for st_ in per_step for x in st_.values()
           if x is not None and not math.isfinite(x)]
    if bad or unchanged or launched or peak >= total_mem:
        raise SystemExit(f"[train16] (b) {arch}: non-finite {bad}, "
                         f"unchanged leaves {unchanged}, kernels launched "
                         f"{launched}, peak {peak / 1e9:.3f} GB")


def train16_serve(dev: torch.device, trained: dict, runs: dict) -> None:
    """Phase 16 (c): each reduced model trained on the card in (a), saved
    as a checkpoint and served by ``launch/serve.py --ckpt-dir`` on the
    card and on the CPU (4 requests of 16 + 12 tokens).  Gates: equal
    greedy streams (by the CLI's sha256); on the card the launches per
    kernel equal ``layer_arith``'s for the run's prefill calls, chunk
    calls and decode steps (as the CLI prints them), and every scan launch
    on the route of the model's recurrence (Mamba: ``selective``, RG-LRU:
    ``scan``)."""
    import contextlib
    import io
    import re
    import tempfile
    from repro_torch.checkpoint import store
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    prompt, new = 16, 12
    for arch in TRAIN16_ARCHS:
        cfg = reduced_config(arch)
        params, st = trained[arch][0], trained[arch][1]
        digests, counts, texts = [], [], []
        with tempfile.TemporaryDirectory() as d:
            store.save(d, TRAIN16_STEPS, {"params": params, "opt": st},
                       extra={"next_step": TRAIN16_STEPS})
            for where in (str(dev), "cpu"):
                ops.reset_launch_counts()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    code = serve.main([
                        "--arch", arch, "--reduced", "--ckpt-dir", d,
                        "--device", where, "--requests", "4",
                        "--input-len", str(prompt), "--output-len", str(new),
                        "--no-prefix-cache"])
                text = buf.getvalue()
                counts.append(ops.counters())
                texts.append(text)
                digests.append([ln for ln in text.splitlines()
                                if "output streams" in ln])
                if code != 0 or "loaded params from" not in text:
                    log(text[-3000:])
                    raise SystemExit(f"[train16] (c) {arch}: serve on "
                                     f"{where} failed")
        card = counts[0]
        runs[f"trained {arch}"] = {k: card[k] for k in ops.launch_counts()}
        calls = dict(re.findall(r"(chunk calls|prefill calls|decode steps) "
                                r"(\d+)", texts[0]))
        c = {"P": int(calls["prefill calls"]), "C": int(calls["chunk calls"]),
             "T": int(calls["decode steps"]), "capacity": prompt + new + 8}
        want = layer_arith(cfg, c)
        got = {k: card[k] for k in want}
        rec = {cfg.spec(nm).mixer for nm in cfg.layer_names}
        route = ("selective" if "mamba" in rec else
                 "scan" if "rglru" in rec else None)
        routes = {k: v for k, v in card.items() if k.startswith("ssm_scan/")}
        want_routes = dict(dict.fromkeys(routes, 0), **(
            {f"ssm_scan/{route}": want["ssm_scan"]} if route else {}))
        equal = digests[0] == digests[1]
        ok = (equal and bool(digests[1]) and c["P"] + c["C"] > 0
              and c["T"] > 0 and got == want and routes == want_routes)
        PHASE16[f"serve {arch}"] = {"streams_equal": equal, "calls": c,
                                    "launches": got, "scan_routes": routes}
        log(f"[train16] (c) {cfg.name}: trained checkpoint served, streams "
            f"card vs CPU {'equal' if equal else 'DIFFER'} "
            f"({digests[1]}); {c['P']} prefill calls, {c['C']} chunk calls, "
            f"{c['T']} decode steps; card launches {json.dumps(got)}, scan "
            f"routes {json.dumps(routes)}; launch arithmetic "
            f"{json.dumps(want)}, routes {json.dumps(want_routes)}: "
            f"{'met' if ok else 'NOT MET'}")
        if not ok:
            raise SystemExit(f"[train16] (c) {arch}: streams differ or the "
                             "launches differ from the arithmetic")


def train16_phase(dev: torch.device, card: str, runs: dict) -> None:
    """Phase 16, (a) to (c)."""
    t0 = time.perf_counter()
    trained = {arch: _card_vs_cpu("train16", arch, dev, TRAIN16_STEPS,
                                  PHASE16) for arch in TRAIN16_ARCHS}
    train16_serve(dev, trained, runs)
    del trained
    for arch in TRAIN16_FULL:
        train16_full(dev, card, arch)
    PHASE16["seconds"] = time.perf_counter() - t0
    log(f"[train16] phase 16 took {PHASE16['seconds']:.1f}s")


def head_choice_ms(eng, head, dev) -> None:
    """The LM head in fp32: the fp32 copy the runner keeps against a
    per-step cast of the bf16 head, at the decode shape."""
    h = torch.randn(SLOTS, head.shape[0], device=dev)
    kept = eng.runner.params["head"]
    a = time_ms(lambda h: h @ kept, [(h,)], 50)
    b = time_ms(lambda h: h @ head.float(), [(h,)], 50)
    log(f"[serve] LM head per decode step: fp32 copy {a:.4f} ms, cast each "
        f"step {b:.4f} ms")


def _leaves(tree):
    """Tensors of a parameter tree; a QuantTensor gives payload, scale."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "payload"):
        yield tree.payload
        yield tree.scale
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    # the port's reference numbers are taken in full fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    build_kernels()
    log_time("phase 2 (build)")
    rows = check_kernels(dev)
    log_time("phase 3 (kernels)")
    check_reduced_parity(dev)
    check_int8_parity(dev)
    check_mamba_parity(dev)
    check_dense_parity(dev)
    check_pt_contiguous_parity(dev)
    check_spec_parity(dev)
    check_layer_parity(dev)
    check_slice16_parity(dev)
    check_slice17_parity(dev)
    check_whisper_parity(dev)
    log_time("phase 4 (parity)")
    keep = {}
    runs = {"bf16": serve_full(dev, card, keep=keep)}
    gc.collect()
    torch.cuda.empty_cache()
    params = keep["params"]
    runs["spec a"], rate_a = serve_spec(dev, card, params, keep["prompts"],
                                        keep["streams"], "bf16 spec (a)",
                                        tied=False)
    gc.collect()
    torch.cuda.empty_cache()
    log_time("phase 5-6 pt-6b-d4 bf16 and spec (a)")
    serve_sampling(dev, card, params, keep["prompts"], keep)
    spec_boundary(dev, card, params)
    log_time("phase 7")
    # phase 9 on the seeded tree (the speculative warm hit comes after
    # the tracks are tied, below)
    prefix_hit(dev, card, params, "bf16")
    prefix_hit(dev, card, params, "int8 weights + int8 KV", int8=True)
    fork_runs(dev, card, params)
    # phase 10 on the seeded tree, against phase 5's streams
    log_time("phase 9 (a-d)")
    robust_runs(dev, card, params, keep["prompts"], keep["streams"])
    log_time("phase 10")
    # run (b): the same tree with its tracks tied in place, so the drafter
    # is the target model but for attention arithmetic; its plain stream
    # on the tied weights is one more plain run
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    _tie_tracks(params["blocks"])
    eng = Engine(get_config(ARCH), params, max_slots=SLOTS,
                 max_seq_len=PROMPT + NEW + 8, block_size=BLOCK, device=dev,
                 prefix_cache=False)
    tied_plain = eng.generate(keep["prompts"], NEW)
    del eng
    runs["spec b"], rate_b = serve_spec(
        dev, card, params, keep["prompts"], tied_plain,
        "bf16 spec (b), tracks tied", tied=True)
    log(f"[serve] acceptance: (a) {rate_a:.4f}, (b) tied {rate_b:.4f}: "
        f"{'met' if rate_b >= rate_a else 'NOT MET'} (b >= a)")
    if rate_b < rate_a:
        raise SystemExit("[serve] tied tracks accepted less than run (a)")
    serve_spec_sampled(dev, card, params)
    prefix_spec(dev, card, params)
    log_time("spec (b), its sampled run, phase 9 (e)")
    one = {k: keep[k] for k in ("prompts", "streams")}
    del params, keep
    gc.collect()
    torch.cuda.empty_cache()
    runs["int8"] = serve_full(dev, card, int8=True)
    log_time("int8")
    gc.collect()
    torch.cuda.empty_cache()
    runs["falcon"] = serve_falcon(dev, card)
    log_time("falcon-mamba")
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.models.decoder import init_lm
    cfg = get_config(DENSE_ARCH)
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters, "
        f"{sum(nbytes(t) for t in _leaves(params)) / 1e9:.3f} GB bf16, init "
        f"{time.perf_counter() - t0:.1f}s")
    for paged in (True, False):
        runs["dense " + ("paged" if paged else "contiguous")] = serve_dense(
            dev, card, params, paged)
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log_time("dense-6b")
    runs["ranks"] = serve_ranks(dev, card, one["prompts"], one["streams"],
                                runs["bf16"])
    log_time("phase 8")
    serve_layer_models(dev, card, runs)
    serve_phase12(dev, card, runs)
    serve_phase13(dev, card, runs)
    log_time("phases 11-13")
    train_phase(dev, card, runs)
    log_time("phase 14")
    serve_whisper(dev, card, runs)
    log_time("phase 15")
    train16_phase(dev, card, runs)
    log_time("phase 16")
    runs["prefix bf16 warm"] = PREFIX["bf16"]["warm"]["launches"]
    for row in rows:
        # each kernel's count from the run of the path it belongs to (the
        # scan's: its route's, every launch of which is gated to it)
        run = (row["run"] if row["name"] == "ssm_scan" else
               "dense contiguous" if row["name"].startswith("decode_attention")
               else "bf16" if row["name"] in FP_PATH else "int8")
        row["launches"] = runs[run][row["name"]]
        row["launches_by_run"] = {k: v[row["name"]] for k, v in runs.items()}
        row["launches_by_run"].update({
            f"{tag} planned": p["launches"][row["name"]]
            for tag, p in PLANNED.items()})
        for shape in row.get("shapes", []):
            if "run" in shape:      # a shape of its own run's path
                shape["launches"] = runs[shape["run"]][row["name"]]
        if row["name"] == "ssm_scan":
            # each scan row: its route's launches in its own run (the
            # falcon-mamba shape's scan route: none, the mixer being on
            # the selective route)
            tags = {"falcon": "falcon-mamba bf16",
                    RG_ARCH: f"{RG_ARCH} sync",
                    RG_ARCH + " chunked": f"{RG_ARCH} chunk"}
            for r_ in [row] + row.get("shapes", []):
                r_["launches"] = SCAN_ROUTES[tags[r_["run"]]][
                    r_["kernel_route"]]
            row["routes_in_serve"] = dict(SCAN_ROUTES)
        if row["name"] == "int8_matmul":
            row["routes_in_serve"] = dict(INT8_ROUTES)
        if row["name"] == "flash_attention":
            row["routes_in_serve"] = dict(FLASH_ROUTES)
        if row["name"] == "rmsnorm":
            # each route row: its route's launches in its run
            row["routes_in_serve"] = dict(NORM_ROUTES)
            for r_ in [row] + row["shapes"]:
                r_["route_launches"] = NORM_ROUTES[
                    {"bf16": "bf16", "ranks": "ranks"}.get(
                        r_["run"], "dense-6b bf16 paged")][r_["kernel_route"]]
        # the same two numbers under their longer key names as well
        row["kernel_ms"] = row["ms"]
        row["launches_in_serve"] = row["launches"]
    log("[falcon] summary " + json.dumps(FALCON))
    log("[planned] summary " + json.dumps(
        {tag: {k: v for k, v in p.items() if k != "launches"}
         for tag, p in PLANNED.items()}))
    log("[profile] planned steps " + json.dumps(PROFILED))
    log("[sampling] summary " + json.dumps(SAMPLING))
    log("[ranks] summary " + json.dumps(RANK_SUMMARY))
    log("[prefix] summary " + json.dumps(PREFIX))
    log("[robust] summary " + json.dumps(ROBUST))
    log("[layers] summary " + json.dumps(
        {k: ({m: {x: y for x, y in f.items() if x != "launches"}
              for m, f in v.items()} if isinstance(v, dict) else v)
         for k, v in LAYER_RUNS.items()}))
    log("[phase12] summary " + phase12_summary())
    log("[phase13] summary " + phase13_summary())
    log("[train] summary " + json.dumps(PHASE14))
    log("[train16] summary " + json.dumps(PHASE16))
    log("[whisper] summary " + json.dumps(
        {k: v for k, v in PHASE15.items() if k != "launches"}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
