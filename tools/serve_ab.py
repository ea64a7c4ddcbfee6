"""The seven planned serve configurations of ``chip_smoke.py`` phase 5 on
this checkout and on another one, in turns, on one card.

  python3 tools/serve_ab.py OTHER_CHECKOUT [--json FILE] [--only TAGS]

Each side runs in its own process (both checkouts hold a package named
``repro_torch``), in the order other, this, this, other; each process
serves, one after another, pt-6b-d4 bf16, pt-6b-d4 speculative (K 4, 4
of 8 tracks) with the seeded tracks (a) and with the tracks tied (b),
pt-6b-d4 with int8 weights and int8 KV, falcon-mamba-7b bf16 (chunk
256) and dense-6b bf16 on the paged and on the contiguous cache: full
width and depth, seeded random weights, ``Engine(pipeline_depth=1,
preplan=True)``, 8 slots, block 16, 8 greedy requests of 512 prompt
tokens and 64 new ones (the same prompts on both sides), after a
warm-up.  Per configuration: TTFT and TPOT p50 of the run, then one
decode (or spec) step's device busy time and device ops (kernels and
copies, ``torch.profiler``, the mean of 3 replayed steps, whose window
may catch part of the step before it) against the unprofiled step's
wall time, and the device ops of one replay of the widest greedy step
program alone.  ``--only`` takes a comma-separated list
of configuration tags (say "PT bf16,dense-6b paged") and serves those
alone.  Needs one CUDA GPU.  Prints the card line and one JSON object
with both sides' runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLOTS, PROMPT, NEW, BLOCK = 8, 512, 64, 16
CONFIGS = (("PT bf16", "pt-6b-d4", {}, False),
           ("PT spec (a)", "pt-6b-d4",
            dict(speculate_k=4, draft_tracks=4), False),
           ("PT spec (b) tied", "pt-6b-d4",
            dict(speculate_k=4, draft_tracks=4), True),
           ("PT int8 w + KV", "pt-6b-d4",
            dict(weight_dtype="int8", kv_dtype="int8"), False),
           ("falcon-mamba-7b", "falcon-mamba-7b", dict(prefill_chunk=256),
            False),
           ("dense-6b paged", "dense-6b", {}, False),
           ("dense-6b contiguous", "dense-6b", dict(paged=False), False))


def _graph_ops(eng) -> int:
    """Device ops of one replay of the widest greedy step program (the
    graph's kernels and copies, counted by ``torch.profiler`` around the
    replay alone, so no other step's work falls into the window).  Run
    once the engine is done: the replay rewrites its static buffers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    progs = eng.runner.programs
    key = max(k for k in progs if k[-1] is not True)
    progs[key].replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        progs[key].replay()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _step_profile(eng, rng, vocab: int):
    """(busy ms, device ops, unprofiled ms) of one decode or spec step,
    SLOTS requests decoding."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import RequestState
    reqs = [eng.submit(rng.integers(1, vocab, size=(PROMPT,)).tolist(), NEW)
            for _ in range(SLOTS)]
    while any(q.state is not RequestState.DECODE for q in reqs):
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    eng.run()
    return (sum(e.self_device_time_total for e in ev) / 3 / 1e3,
            sum(e.count for e in ev) / 3, wall)


def worker(src: Path, only) -> None:
    """Serve every configuration (of ``only``, when given) with the
    package under ``src``; print one JSON line per configuration."""
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import model_fns
    from repro_torch.serving.engine import Engine, EngineMetrics
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    for tag, arch, knobs, tied in CONFIGS:
        if only and tag not in only:
            continue
        cfg = get_config(arch)
        params = model_fns(cfg)["init"](
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
        if tied:        # every track a copy of track 0, in place
            stack = [params["blocks"]]
            while stack:
                node = stack.pop()
                if isinstance(node, dict):
                    stack.extend(node.values())
                else:
                    node[:, :, 1:] = node[:, :, :1]
        eng = Engine(cfg, params, max_slots=SLOTS,
                     max_seq_len=PROMPT + NEW + 8, block_size=BLOCK,
                     device=dev, pipeline_depth=1, preplan=True, **knobs)
        del params
        rng = np.random.default_rng(0)
        eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                      for _ in range(SLOTS)], 3)
        eng.metrics = EngineMetrics()
        eng._last_dispatch_t = None
        prompts = [rng.integers(1, cfg.vocab_size, size=(PROMPT,)).tolist()
                   for _ in range(SLOTS)]
        reqs = [eng.submit(p, NEW) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        m = eng.metrics.summary()
        busy, ops, wall = _step_profile(eng, rng, cfg.vocab_size)
        print(json.dumps({"config": tag, "ttft_ms_p50": m["ttft_ms"]["p50"],
                          "tpot_ms_p50": m["tpot_ms"]["p50"],
                          "step_busy_ms": busy, "step_device_ops": ops,
                          "graph_device_ops": _graph_ops(eng),
                          "step_wall_ms": wall,
                          "finished": sum(len(q.output) == NEW
                                          for q in reqs)}), flush=True)
        del eng
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--only", default="",
                    help="comma-separated configuration tags to serve")
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = [t for t in args.only.split(",") if t]
    unknown = set(only) - {c[0] for c in CONFIGS}
    if unknown:
        raise SystemExit(f"serve_ab: unknown configurations {unknown}")
    if args.worker is not None:
        worker(args.worker, only)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sides = {"other": args.other.resolve() / "src", "this": ROOT / "src"}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(sides[side]), "--only", args.only],
                             stdout=subprocess.PIPE, text=True,
                             check=True).stdout
        rows = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")]
        runs[side].append(rows)
        for r in rows:
            print(f"[serve_ab] {side}: {json.dumps(r)}", flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "other": str(args.other), "runs": runs}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
