"""Serving launcher of the port: builds a model (a Parallel-Track model,
a dense baseline or any other ``configs.NAMES`` entry: tinyllama-1.1b,
falcon-mamba-7b, nemotron-4-15b, the gemma models, qwen2-vl-72b (text
tokens, M-RoPE with equal streams), recurrentgemma-9b, deepseek-v2-236b
or deepseek-v3-671b (MLA over latent pools, MoE) with random weights
from ``--seed``, serves a synthetic workload through the engine (the
paged cache, or with ``--contiguous`` the contiguous one), greedy or
with ``--temperature`` sampled (each request under its own seed, the
engine's default), and reports TTFT / TPOT / throughput, the launch
count of each kernel, a sha256 of the output streams (two runs' streams
compare by it) and, with the prefix cache on (the default; off with
``--no-prefix-cache``), the prompt tokens it served.
``--shared-prefix N`` puts the same N tokens before every prompt (a
system prompt).  The robustness knobs are the reference's: a bounded
queue (``--max-queue``), the stall watchdog's patience, the preemption
cap, a per-request deadline, priorities cycled over the requests
(``--priority-mix N``: N > 1 exercises preempt-and-recompute when the
pool is small) and a seeded ``FaultPlan`` (``--fault-*``); the summary
then counts preemptions, sheds, rejections, timeouts, watchdog fires and
transfer faults.  ``--ckpt-dir`` serves the params of the newest
checkpoint there (one that ``launch/train.py`` or the reference's
trainer wrote, a MoE's padded experts dropped) in place of the random
ones.  Runs on the GPU unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --requests 8 --input-len 512 --output-len 64 --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --weight-dtype int8 --kv-dtype int8 \
      --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --reduced --device cpu --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dense-6b \
      --reduced --device cpu --contiguous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-72b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --reduced --device cpu --prefill-chunk 8
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --speculate-k 3 --draft-tracks 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --pipeline-depth 1 --preplan
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --shared-prefix 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --num-blocks 12 --priority-mix 2 \
      --fault-transfer-p 0.1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store as ckpt_lib
from repro_torch.common.device import resolve_device
from repro_torch.configs import NAMES, get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import model_fns
from repro_torch.serving.engine import Engine, EngineStallError, RequestState
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.sampler import SampleParams
from repro_torch.weights import drop_expert_padding


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pt-6b-d4", choices=NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint here")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--input-len", type=int, default=64)
    ap.add_argument("--output-len", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--contiguous", action="store_true",
                    help="serve through the contiguous per-slot cache "
                    "instead of the paged cache")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-cache tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged-cache pool size (default slots*capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: prompt tokens fed per engine "
                    "step (0 = whole-prompt prefill)")
    ap.add_argument("--kv-dtype", default=None, choices=["float32", "int8"],
                    help="paged KV storage dtype: int8 stores 8-bit "
                    "payloads + per-token fp32 scales (dequant fused into "
                    "the decode kernel)")
    ap.add_argument("--weight-dtype", default=None,
                    choices=["float32", "int8"],
                    help="serving weight dtype: int8 quantizes the "
                    "projection and head weights at engine load (norms "
                    "and embeddings stay fp)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="track-speculative decoding: draft tokens per "
                    "verify step (PT models on the paged cache; 0 = off)")
    ap.add_argument("--draft-tracks", type=int, default=0,
                    help="tracks of the drafter (0 = n_tracks // 2)")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="pipelined stepping: dispatch up to this many "
                    "steps ahead of the packed device-to-host transfer "
                    "(0 = the synchronous loop)")
    ap.add_argument("--preplan", action="store_true",
                    help="capture one CUDA graph per live-length bucket of "
                    "the decode / speculative step when the engine is "
                    "built, and replay them")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="turn the content-addressed prefix cache off (on "
                    "by default where the architecture supports it)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="put the same this many tokens before every "
                    "prompt (a system prompt; exercises the prefix cache)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-budget", type=int, default=4096,
                    help="max padded prefill tokens admitted per step")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue: submissions past this "
                    "many waiting requests are shed as REJECTED "
                    "(default unbounded)")
    ap.add_argument("--watchdog-patience", type=int, default=25,
                    help="consecutive no-progress engine steps before "
                    "the stall watchdog preempts or sheds the head")
    ap.add_argument("--max-preemptions", type=int, default=8,
                    help="evictions a request survives before it is "
                    "REJECTED (termination guarantee under pressure)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request submit-to-done budget in seconds "
                    "(exceeding it yields TIMED_OUT)")
    ap.add_argument("--priority-mix", type=int, default=1,
                    help="cycle request priorities 0..N-1 across the "
                    "workload (N>1 exercises preempt-and-recompute)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic fault-injection "
                    "schedule (chaos drills)")
    ap.add_argument("--fault-alloc-p", type=float, default=0.0,
                    help="per-call probability of an injected KV "
                    "allocation failure")
    ap.add_argument("--fault-transfer-p", type=float, default=0.0,
                    help="per-call probability of an injected device-to-"
                    "host transfer failure (the step retries)")
    ap.add_argument("--fault-slow-p", type=float, default=0.0,
                    help="per-step probability of an injected slow step")
    ap.add_argument("--fault-slow-s", type=float, default=0.05,
                    help="sleep per injected slow step (seconds)")
    ap.add_argument("--fault-max", type=int, default=None,
                    help="cap on total injected faults (a storm that "
                    "clears; default unbounded)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                    "plain PyTorch path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_fns(cfg)["init"](gen, cfg, device)
    if args.ckpt_dir:
        params = drop_expert_padding(ckpt_lib.restore(
            args.ckpt_dir, {"params": params})["params"], cfg)
        print(f"[serve] loaded params from {args.ckpt_dir}")
    plan = None
    if args.fault_alloc_p or args.fault_transfer_p or args.fault_slow_p:
        plan = FaultPlan(seed=args.fault_seed, alloc_p=args.fault_alloc_p,
                         transfer_p=args.fault_transfer_p,
                         slow_p=args.fault_slow_p, slow_s=args.fault_slow_s,
                         max_faults=args.fault_max)
        print(f"[serve] fault injection armed: seed={plan.seed} "
              f"alloc_p={plan.alloc_p} transfer_p={plan.transfer_p} "
              f"slow_p={plan.slow_p} max={plan.max_faults}")
    eng = Engine(cfg, params, max_slots=args.slots,
                 max_seq_len=(args.shared_prefix + args.input_len
                              + args.output_len + 8),
                 max_waiting_prefill_tokens=args.prefill_budget,
                 paged=not args.contiguous, block_size=args.block_size,
                 num_blocks=args.num_blocks,
                 prefill_chunk=args.prefill_chunk, kv_dtype=args.kv_dtype,
                 weight_dtype=args.weight_dtype,
                 speculate_k=args.speculate_k,
                 draft_tracks=args.draft_tracks,
                 prefix_cache=not args.no_prefix_cache,
                 pipeline_depth=args.pipeline_depth, preplan=args.preplan,
                 max_queue=args.max_queue,
                 watchdog_patience=args.watchdog_patience,
                 max_preemptions=args.max_preemptions, fault_plan=plan,
                 device=device)
    del params                 # an int8 engine holds its own copy
    st = eng.runner.cache_stats()
    if st["mode"] == "contiguous":
        print(f"[serve] cache: contiguous, {args.slots} rows of "
              f"{eng.max_seq_len} positions, weights={st['weight_dtype']} "
              f"({st['quantized_weight_leaves']} leaves quantized)")
    else:
        if eng.runner.kv_dtype or eng.runner.weight_dtype:
            print(f"[serve] quantized: kv={st['kv_dtype']} "
                  f"weights={st['weight_dtype']} "
                  f"({st['quantized_weight_leaves']} leaves), pool "
                  f"{st['pool_bytes'] / 1e6:.1f} MB "
                  f"({st['bytes_per_block']} B/block)")
        print(f"[serve] cache: leaves {st['leaf_kinds']}, pool "
              f"{st['pool_bytes'] / 1e6:.1f} MB, state rows "
              f"{st['state_bytes'] / 1e6:.1f} MB, {st['num_blocks']} "
              f"blocks of {st['block_size']}")
    for why in eng.runner.quant_fallbacks:
        print(f"[serve] fallback: {why}")
    if eng.runner.speculate_k:
        print(f"[serve] speculative: K={eng.runner.speculate_k}, drafter of "
              f"{eng.runner.draft_tracks}/{cfg.pt.n_tracks} tracks")
    if args.preplan:
        print(f"[serve] step programs: {len(eng.runner.programs)} planned "
              f"in {eng.runner.plan_seconds:.3f}s")
    rng = np.random.default_rng(args.seed)
    sp = SampleParams(temperature=args.temperature)
    shared = rng.integers(1, cfg.vocab_size,
                          size=(args.shared_prefix,)).tolist()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(shared + rng.integers(1, cfg.vocab_size,
                                             size=(args.input_len,)).tolist(),
                       args.output_len, params=sp,
                       priority=i % max(1, args.priority_mix),
                       deadline_s=args.deadline_s)
            for i in range(args.requests)]
    stalled = False
    try:
        eng.run()
    except EngineStallError as e:
        stalled = True
        print(f"[serve] STALL: {e}")
        for k, v in e.diagnostic.items():
            print(f"[serve]   {k} = {v}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    m = eng.metrics.summary()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[serve] {cfg.name} on {name}: {args.requests} reqs x "
          f"({args.input_len} in / {args.output_len} out), "
          f"slots={args.slots}, temperature {args.temperature}")
    print(f"[serve] throughput {m['throughput_tok_s']:.1f} tok/s   "
          f"wall {wall:.3f}s   engine steps {eng.steps_run}   "
          f"prefill variants {len(eng.runner.prefill_shapes)}   "
          f"chunk calls {eng.runner.chunk_calls}   "
          f"prefill calls {eng.runner.prefill_calls}   "
          f"decode steps {eng.runner.decode_transfers}")
    print(f"[serve] TTFT ms: p50 {m['ttft_ms']['p50']:.2f}  "
          f"p90 {m['ttft_ms']['p90']:.2f}  p99 {m['ttft_ms']['p99']:.2f}")
    print(f"[serve] TPOT ms: p50 {m['tpot_ms']['p50']:.2f}  "
          f"p90 {m['tpot_ms']['p90']:.2f}  p99 {m['tpot_ms']['p99']:.2f}")
    if eng.runner.speculate_k:
        print(f"[serve] spec steps {m['spec_steps']}   acceptance rate "
              f"{m['acceptance_rate']:.4f}   tokens per slot per spec "
              f"step {m['tokens_per_slot_step']:.3f}")
    if args.preplan or args.pipeline_depth:
        r = eng.runner
        print(f"[serve] step programs: {len(r.programs)} planned, "
              f"replayed {r.planned_hits} of {r.decode_transfers} steps; "
              f"pipeline depth {args.pipeline_depth}, steps in flight "
              f"{m['steps_in_flight']}, dispatch gap ms p50 "
              f"{m['dispatch_gap_ms']['p50']:.3f}")
    if eng.runner.prefix_cache:
        u = eng.runner.kv.utilization()
        hit = u["prefix_hit_tokens"] / max(1, u["prefix_lookup_tokens"])
        print(f"[serve] prefix cache: {u['prefix_hit_tokens']} of "
              f"{u['prefix_lookup_tokens']} prompt tokens served from cache "
              f"({100 * hit:.0f}%), {u['cached_free_blocks']} cached blocks "
              f"retained, {u['cow_copies']} CoW copies")
    elif args.no_prefix_cache or args.shared_prefix:
        why = ("--no-prefix-cache" if args.no_prefix_cache else
               "needs the paged cache" if not eng.runner.paged else
               eng.runner.capabilities["prefix_cache"].reason)
        print(f"[serve] prefix cache: off ({why})")
    print("[serve] kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in ops.launch_counts().items()))
    by_state = {}
    for r in reqs:
        by_state[r.state.value] = by_state.get(r.state.value, 0) + 1
    pressure = (m["preemptions"] or m["rejected"] or m["shed"]
                or m["timed_out"] or m["watchdog_fires"]
                or m["transfer_faults"])
    if pressure or by_state.keys() != {RequestState.DONE.value}:
        states = ", ".join(f"{k}={v}" for k, v in sorted(by_state.items()))
        print(f"[serve] robustness: {states} | "
              f"preemptions {m['preemptions']} (resumes {m['resumes']}), "
              f"shed {m['shed']}, rejected {m['rejected']}, "
              f"cancelled {m['cancelled']}, timed_out {m['timed_out']}, "
              f"watchdog {m['watchdog_fires']}, "
              f"transfer_faults {m['transfer_faults']}")
    if plan is not None:
        fs = plan.summary()
        print(f"[serve] faults injected: {fs['injected']} "
              f"(alloc {fs['alloc_faults']}, transfer "
              f"{fs['transfer_faults']}, slow {fs['slow_steps']})")
    streams = json.dumps([r.output for r in reqs]).encode()
    print(f"[serve] output streams: {sum(len(r.output) for r in reqs)} "
          f"tokens, sha256 {hashlib.sha256(streams).hexdigest()}")
    done = sum(r.state is RequestState.DONE for r in reqs)
    print(f"[serve] finished {done}/{len(reqs)} requests")
    # every request ended, in one state (shed or timed out ones too)
    return 0 if all(r.finished for r in reqs) and not stalled else 1


if __name__ == "__main__":
    raise SystemExit(main())
