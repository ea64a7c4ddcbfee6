"""Serving launcher of the port: builds a model (a Parallel-Track model,
a dense baseline, tinyllama-1.1b or falcon-mamba-7b) with random weights
from ``--seed``, serves a synthetic workload through the engine (the
paged cache, or with ``--contiguous`` the contiguous one), greedy or
with ``--temperature`` sampled (each request under its own seed, the
engine's default), and reports TTFT / TPOT / throughput and the launch
count of each kernel.  Runs on the GPU unless ``--device cpu`` is given.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --speculate-k 3 --draft-tracks 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --pipeline-depth 1 --preplan
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pt-6b-d4 \
      --reduced --device cpu --temperature 0.8
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import NAMES, get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import model_fns
from repro_torch.serving.engine import Engine, RequestState
from repro_torch.serving.sampler import SampleParams


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pt-6b-d4", choices=NAMES)
    ap.add_argument("--reduced", action="store_true")
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-budget", type=int, default=4096,
                    help="max padded prefill tokens admitted per step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                    "plain PyTorch path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_fns(cfg)["init"](gen, cfg, device)
    eng = Engine(cfg, params, max_slots=args.slots,
                 max_seq_len=args.input_len + args.output_len + 8,
                 max_waiting_prefill_tokens=args.prefill_budget,
                 paged=not args.contiguous, block_size=args.block_size,
                 num_blocks=args.num_blocks,
                 prefill_chunk=args.prefill_chunk, kv_dtype=args.kv_dtype,
                 weight_dtype=args.weight_dtype,
                 speculate_k=args.speculate_k,
                 draft_tracks=args.draft_tracks,
                 pipeline_depth=args.pipeline_depth, preplan=args.preplan,
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
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size,
                                    size=(args.input_len,)).tolist(),
                       args.output_len, params=sp)
            for _ in range(args.requests)]
    eng.run()
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
          f"chunk calls {eng.runner.chunk_calls}")
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
    print("[serve] kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in ops.launch_counts().items()))
    done = sum(r.state is RequestState.DONE for r in reqs)
    print(f"[serve] finished {done}/{len(reqs)} requests")
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
