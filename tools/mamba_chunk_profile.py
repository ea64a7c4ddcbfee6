"""Where one falcon-mamba-7b chunk call spends its device time, by kernel,
on one card: the serve run of ``chip_smoke.py`` phase 5 (full width and
depth, bf16, seeded random weights, 8 slots, 8 prompts of 512 tokens,
chunked prefill of 256) up to its first chunk call, which
``torch.profiler`` records.

  python3 tools/mamba_chunk_profile.py [--checkout DIR] [--json FILE]

``--checkout DIR`` imports the port from DIR/src instead of this
checkout's (an earlier tree unpacked with ``git archive``), so two trees
are profiled alike in one call; only the two kernel sources the Mamba
path launches (``ssm_scan.cu``, ``rmsnorm.cu``) are built.  Prints each
kernel's device ms and launches for the chunk call, the sums by group
(GEMMs, the scan, elementwise passes, reductions and copies, the rest),
the chunk call's device busy ms, its wall time unprofiled (the
admission step, host clock around a synchronised step), the peak memory
of the unprofiled admission, the card line, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
GROUPS = (("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90_",
                    "cublas")),
          ("scan", ("ssm_scan", "selective_scan")),
          ("rmsnorm", ("rmsnorm", "rows_kernel")),
          ("elementwise", ("elementwise", "vectorized")),
          ("reduce", ("reduce",)),
          ("copy", ("memcpy", "memset", "copy", "cat", "index")))


def group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", type=Path, default=ROOT)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mamba_chunk_profile: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(args.checkout.resolve() / "src"), str(ROOT)]
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.decoder import init_lm
    from repro_torch.serving.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    build.SOURCES = ("ssm_scan.cu", "rmsnorm.cu")    # the Mamba path's
    build.build_all()
    cfg = get_config(cs.FM_ARCH)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    eng = Engine(cfg, params, max_slots=cs.FM_SLOTS,
                 max_seq_len=cs.PROMPT + cs.NEW + 8, block_size=cs.BLOCK,
                 prefill_chunk=cs.FM_CHUNK, device=dev, prefix_cache=False)
    del params
    rng = np.random.default_rng(0)
    eng.generate([rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
                  for _ in range(cs.FM_SLOTS)], 3)             # warm-up

    def admit():
        for _ in range(cs.FM_SLOTS):
            eng.submit(rng.integers(1, cfg.vocab_size,
                                    size=(cs.PROMPT,)).tolist(), 2)

    admit()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    chunks0 = eng.runner.chunk_calls
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    assert eng.runner.chunk_calls == chunks0 + 1, "the step ran no chunk"
    eng.run()
    admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    eng.run()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    by_group = {}
    for ms, n, key in rows:
        g = by_group.setdefault(group(key), {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += n
    print(f"[profile] {cfg.name} chunk call ({cs.FM_SLOTS} x {cs.FM_CHUNK} "
          f"tokens): device busy {busy:.3f} ms in "
          f"{sum(r[1] for r in rows)} kernels and copies; unprofiled "
          f"admission step {wall_ms:.3f} ms, peak memory "
          f"{peak / 1e9:.3f} GB", flush=True)
    for g, v in sorted(by_group.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[profile]   group {g:12s} {v['ms']:9.3f} ms "
              f"{v['launches']:6d}x", flush=True)
    for ms, n, key in rows[:25]:
        print(f"[profile]   {ms:9.3f} ms {n:6d}x  {key[:100]}", flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "checkout": args.checkout.name, "busy_ms": busy,
              "admission_wall_ms": wall_ms, "peak_gb": peak / 1e9,
              "groups": by_group,
              "kernels": [{"ms": ms, "launches": n, "name": key}
                          for ms, n, key in rows]}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps({k: v for k, v in result.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
