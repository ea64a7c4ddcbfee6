"""Where a full-width train step's time goes, on a GPU machine: phase 14
(b)'s configurations (pt-6b-d4 at 16 and dense-6b at 8 of their 32
layers, bf16 + AdamW's fp32 master, batch 8 x 512 from the data
pipeline, TF32 off as in chip_smoke.py).  After two warm-up steps, one
step split into its parts as CUDA-event times (forward + backward by
autograd, clipping, the schedule and AdamW's update), then one step under
``torch.profiler``: device busy against the step's wall time, and the
ops with the most device time (self time of the aten op that launched
the kernels), with the fp32 products (the LM head) apart.

  python3 tools/train_profile.py [--json chiprun_out/train_profile.json]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def _self_device_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def profile_arch(arch: str, dev, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.launch import steps
    from repro_torch.optim import (adamw_update, clip_by_global_norm,
                                   warmup_cosine)
    cfg = get_config(arch).replace(n_layers=c.TRAIN_CUT[arch])
    fns = steps.model_fns(cfg)
    fn, opt_init, _ = steps.make_train_step(cfg, microbatches=1,
                                            peak_lr=3e-3, warmup=10,
                                            total_steps=4)
    params = fns["init"](torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    st = opt_init(params)
    loader = DataLoader(DataConfig(cfg.vocab_size, c.TRAIN_S, c.TRAIN_B))

    def batch():
        return {k: torch.from_numpy(v).to(dev)
                for k, v in next(loader).items()}

    for _ in range(2):
        params, st, _ = fn(params, st, batch())
    torch.cuda.synchronize(dev)
    # the parts of one step, as make_train_step runs them
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    b = batch()
    ev[0].record()
    loss, grads = steps.value_and_grad(
        lambda p, x: fns["loss"](p, x, cfg), params, b)
    ev[1].record()
    grads, _ = clip_by_global_norm(grads, 1.0)
    lr = warmup_cosine(st["step"], peak_lr=3e-3, warmup=10, total=4)
    ev[2].record()
    params, st = adamw_update(grads, st, params, lr)
    ev[3].record()
    torch.cuda.synchronize(dev)
    del grads
    parts = {"forward_backward_ms": ev[0].elapsed_time(ev[1]),
             "clip_schedule_ms": ev[1].elapsed_time(ev[2]),
             "adamw_ms": ev[2].elapsed_time(ev[3])}
    b = batch()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, st, _ = fn(params, st, b)
        torch.cuda.synchronize(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    ops = {}
    kernels = {}
    for e in prof.key_averages():
        us = _self_device_us(e)
        if us <= 0:
            continue
        if e.key.startswith("aten::"):
            ops[e.key] = ops.get(e.key, 0.0) + us / 1e3
        elif getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:15]
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    fp32_gemm = sum(ms for k, ms in kernels.items()
                    if "gemm" in k.lower() and ("f32" in k.lower()
                                                or "sgemm" in k.lower())
                    and "bf16" not in k.lower())
    out = dict(parts, step_wall_ms=wall, device_busy_ms=busy,
               busy_share=busy / wall if wall else None,
               fp32_gemm_kernels_ms=fp32_gemm, top_ops_ms=top_ops,
               top_kernels_ms=top_kernels, card=card)
    c.log(f"[profile] {card} | {arch} at {cfg.n_layers} layers: step wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms; parts: forward + "
          f"backward {parts['forward_backward_ms']:.3f}, clip + schedule "
          f"{parts['clip_schedule_ms']:.3f}, AdamW {parts['adamw_ms']:.3f} "
          f"ms; fp32 GEMM kernels {fp32_gemm:.3f} ms")
    for k, ms in top_ops:
        c.log(f"[profile]   op {k}: {ms:.3f} ms")
    for k, ms in top_kernels:
        c.log(f"[profile]   kernel {k[:110]}: {ms:.3f} ms")
    del params, st
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = c.card_line()
    res = {}
    for arch in c.TRAIN_CUT:
        res[arch] = profile_arch(arch, dev, card)
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
