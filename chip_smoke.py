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
     a yardstick of PyTorch calls; ``ssm_scan`` at the falcon-mamba
     chunk shape, then at ragged S, d_state 1, bf16 inputs and an odd
     feature count; ``decode_attention`` (the contiguous cache) at the
     dense-6b decode shape, bf16 and int8, and at the speculative runs'
     drafter shape (4 tracks x 8 slots folded: q [32, 4, 128], cache
     [32, 584, 1, 128]), bf16.  The W8A16, flash, RMSNorm and
     decode rows (the split-KV template, paged and contiguous, fp and
     int8) are timed as device work (their calls replayed from a CUDA
     graph, as their library calls; the eager loops' times beside them),
     each with its share of the bound; the decode rows with their split
     plan, and the fp decode rows over a short sweep of B 1 and 8 by live
     length 64, 576 and 4096;
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
     tracks tied;
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
     64 ``ssm_scan`` per chunk call, 65 ``rmsnorm`` per forward and no
     attention kernel; then
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
     ``check_spec_logits``'s limit.
Prints one ``{"kernels": [...]}`` JSON line, then the card line, then
``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

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
PARITY_TOL = 1e-4              # fp32 model on the card vs the CPU

# the serving cells of phase 5, which fix the kernel shapes of phase 3
ARCH, SLOTS, PROMPT, NEW, BLOCK = "pt-6b-d4", 8, 512, 64, 16
FM_ARCH, FM_SLOTS, FM_CHUNK = "falcon-mamba-7b", 8, 256
DENSE_ARCH = "dense-6b"
SPEC_K, SPEC_TRACKS = 4, 4      # the speculative serve runs of phase 5


def log(msg: str) -> None:
    print(msg, flush=True)


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
    rows.append(check_ssm_scan(dev, g))
    torch.cuda.empty_cache()
    rows += check_decode_attention(dev, g)
    torch.cuda.empty_cache()
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


def check_ssm_scan(dev: torch.device, g: torch.Generator):
    """Phase 3 for the falcon-mamba path: ``ssm_scan`` at the serve
    run's chunk shape (a, b [8, 256, 8192, 16] fp32, nonzero h0; one
    launch per layer per chunk call), timed against its plain version
    and its bound (no single PyTorch call computes the recurrence, so no
    library time); then ragged S, d_state 1, bf16 inputs and the scalar
    path, checked only (tolerances as the reference's sweep)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    s = get_config(FM_ARCH).ssm
    shape = (FM_SLOTS, FM_CHUNK, s.d_inner, s.d_state)
    a = torch.sigmoid(torch.randn(shape, generator=g, device=dev))
    b = torch.randn(shape, generator=g, device=dev)
    h0 = torch.randn(FM_SLOTS, s.d_inner, s.d_state, generator=g, device=dev)
    (h, hl), (rh, rhl) = ops.ssm_scan(a, b, h0), ref.ssm_scan_plain(a, b, h0)
    _agree("ssm_scan h_last", hl, rhl, FP32_KERNEL_TOL)
    k_ms = time_ms(ops.ssm_scan, [(a, b, h0)], 20)
    p_ms = time_ms(ref.ssm_scan_plain, [(a, b, h0)], 3)
    row = _report("ssm_scan", "cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                  "src/repro/kernels/ssm_scan.py:47", h, rh, k_ms, p_ms, None,
                  nbytes(a, b, h0, h, hl), 2.0 * a.numel(), FP32_FLOP_S,
                  tol=FP32_KERNEL_TOL)
    row["at"] = (f"a, b [{FM_SLOTS},{FM_CHUNK},{s.d_inner},{s.d_state}] fp32, "
                 "h0 [8,8192,16]")
    row["library_ms_why"] = ("no single PyTorch call computes a linear "
                             "recurrence over the sequence axis")
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
        eng = Engine(cfg, params[d], max_slots=2, max_seq_len=48, device=d)
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
                     kv_dtype="int8", **knobs)
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
                             device=d, **knobs).generate(prompts, 8)
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
                paged=paged).generate(prompts, 8)
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
                                  device=d, paged=paged).generate(prompts, 8)
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
                             **knobs)
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
                     speculate_k=3, draft_tracks=2)
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
    2 L + 1 (L + 1 for Mamba), 2 L for a forward without a head."""
    L, P, C, T = cfg.n_layers, c["P"], c.get("C", 0), c["T"]
    if cfg.pt is None:
        A = L if kind == "falcon" else 2 * L         # adds per forward
        return {"norm": P + 2 * C + T, "add_norm": A * (P + T) + (A - 1) * C,
                "fuse_norm": 0}
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
                 block_size=BLOCK, device=dev, **knobs)
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
                  chunk_steps: int = 0) -> None:
    """Where the time goes: device time by kernel (torch.profiler, CUPTI)
    over the step that admits SLOTS prompts and over three decode steps,
    beside the decode step's unprofiled time (TPOT).  With chunked
    prefill the admission step runs the first chunk, and the other
    ``chunk_steps - 1`` chunk steps run unprofiled before the decode
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(SLOTS):
        eng.submit(rng.integers(1, vocab, size=(PROMPT,)).tolist(), 5)
    first = ("admission step (first prompt chunk)" if chunk_steps else
             "admission step (prefill + first decode)")
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
                 draft_tracks=SPEC_TRACKS)
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
                 prefill_chunk=FM_CHUNK, device=dev)
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
    check_norm_routes(tag, "falcon", cfg,
                      {"P": r.prefill_calls - prefills0, "C": chunks,
                       "T": decodes}, rms_routes)
    profile_steps(eng, cfg.vocab_size, rng, m["tpot_ms"]["p50"], tag,
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
                 block_size=BLOCK, paged=paged, device=dev)
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
    ``variants`` asked (greedy, sampled), greedy first, each stage's
    graphs, capture seconds and memory reported.  Gates: every request
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
                 block_size=BLOCK, device=dev, pipeline_depth=1, **knobs)
    del params
    r = eng.runner
    stages = {}
    for v in variants:
        torch.cuda.synchronize()
        before = (len(r.programs), r.plan_seconds,
                  torch.cuda.memory_reserved(dev))
        r.plan_programs(sampled=(v,))
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
                 block_size=BLOCK, device=dev, **knobs)
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
                         draft_tracks=SPEC_TRACKS, **extra)
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
                 block_size=BLOCK, device=dev, par=par)
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
                 block_size=BLOCK, device=dev)
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
    # the port's reference numbers are taken in full fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    build_kernels()
    rows = check_kernels(dev)
    check_reduced_parity(dev)
    check_int8_parity(dev)
    check_mamba_parity(dev)
    check_dense_parity(dev)
    check_pt_contiguous_parity(dev)
    check_spec_parity(dev)
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
    serve_sampling(dev, card, params, keep["prompts"], keep)
    spec_boundary(dev, card, params)
    # run (b): the same tree with its tracks tied in place, so the drafter
    # is the target model but for attention arithmetic; its plain stream
    # on the tied weights is one more plain run
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    _tie_tracks(params["blocks"])
    eng = Engine(get_config(ARCH), params, max_slots=SLOTS,
                 max_seq_len=PROMPT + NEW + 8, block_size=BLOCK, device=dev)
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
    one = {k: keep[k] for k in ("prompts", "streams")}
    del params, keep
    gc.collect()
    torch.cuda.empty_cache()
    runs["int8"] = serve_full(dev, card, int8=True)
    gc.collect()
    torch.cuda.empty_cache()
    runs["falcon"] = serve_falcon(dev, card)
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
    runs["ranks"] = serve_ranks(dev, card, one["prompts"], one["streams"],
                                runs["bf16"])
    for row in rows:
        # each kernel's count from the run of the path it belongs to
        run = ("falcon" if row["name"] == "ssm_scan" else
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
    log("[planned] summary " + json.dumps(
        {tag: {k: v for k, v in p.items() if k != "launches"}
         for tag, p in PLANNED.items()}))
    log("[profile] planned steps " + json.dumps(PROFILED))
    log("[sampling] summary " + json.dumps(SAMPLING))
    log("[ranks] summary " + json.dumps(RANK_SUMMARY))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
