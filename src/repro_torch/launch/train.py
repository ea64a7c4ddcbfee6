"""Training launcher of the port (counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch pt-6b-d4 \
      --reduced --steps 20 --batch 8 --seq 64 --device cpu \
      --ckpt-dir /tmp/ckpt

The reference's production loop on one device: the data pipeline, the
train step (``launch/steps.py::make_train_step``: autograd through the
train-mode forward, clipping, the warmup-cosine rate, AdamW with an fp32
master or Adafactor), async checkpoints with keep-k and atomic
promotion, straggler monitoring, resume from the newest complete
checkpoint (the data stream replayed by step index) and retry with
backoff.  Parameters are drawn by the port's ``init_pt`` / ``init_lm``
from a ``torch.Generator`` seeded 0, in the train tree's layout (a MoE's
padded experts included, as the reference stores them).  Runs on the
GPU unless ``--device cpu`` is given.  Data- and model-parallel training
over several cards is ROADMAP queue 1, item 9c.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import store as ckpt_lib
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.pytree import count_params
from repro_torch.configs import NAMES, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.launch import steps as steps_lib
from repro_torch.models.layers import check_supported
from repro_torch.runtime.elastic import RetryPolicy, StragglerMonitor


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               keep: int = 3, microbatches: int = 1,
               peak_lr: float = 3e-3, log_every: int = 10,
               print_fn=print, device: DeviceLike = None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens,
    resuming from ``ckpt_dir``'s newest checkpoint when it has one.
    Returns {'losses': [(step, loss)] at the logged steps, 'params',
    'opt_state'}."""
    device = resolve_device(device)
    fns = steps_lib.model_fns(cfg)
    step_fn, opt_init, opt_name = steps_lib.make_train_step(
        cfg, microbatches=microbatches, peak_lr=peak_lr,
        warmup=max(10, steps // 20), total_steps=steps)

    gen = torch.Generator(device=device).manual_seed(0)
    params = fns["init_train"](gen, cfg, device)
    opt_state = opt_init(params)
    print_fn(f"[train] {cfg.name}: {count_params(params)/1e6:.1f}M params, "
             f"optimizer={opt_name}, device={device}")

    start_step = 0
    if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
        restored = ckpt_lib.restore(ckpt_dir,
                                    {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        extra = ckpt_lib.manifest_extra(ckpt_dir)
        start_step = int(extra.get("next_step",
                                   ckpt_lib.latest_step(ckpt_dir)))
        print_fn(f"[train] resumed from step {start_step}")

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    loader = DataLoader(dcfg, start_step=start_step)
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep) \
        if ckpt_dir else None
    monitor = StragglerMonitor()

    losses = []
    t_last = time.time()
    for step in range(start_step, steps):
        tbatch = {k: torch.from_numpy(v).to(device)
                  for k, v in next(loader).items()}
        params, opt_state, metrics = step_fn(params, opt_state, tbatch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            dt = time.time() - t_last
            t_last = time.time()
            print_fn(f"[train] step {step:5d} loss {loss:.4f} "
                     f"gnorm {float(metrics['grad_norm']):.3f} "
                     f"({dt:.2f}s)")
        monitor.observe({"host0": time.time() - t_last + 1e-9})
        if saver and (step + 1) % ckpt_every == 0:
            saver.save(step + 1, {"params": params, "opt": opt_state},
                       extra={"next_step": step + 1, "arch": cfg.name})
    if saver:
        saver.save(steps, {"params": params, "opt": opt_state},
                   extra={"next_step": steps, "arch": cfg.name})
        saver.wait()
    return {"losses": losses, "params": params, "opt_state": opt_state}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="data-parallel replicas (more than 1: ROADMAP "
                    "queue 1, item 9c)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel shards (more than 1: item 9c)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                    "plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.data_parallel > 1 or args.model_parallel > 1:
        raise NotImplementedError("data- and model-parallel training over "
                                  "several cards: ROADMAP queue 1, item 9c")
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    check_supported(cfg)                   # before the retry loop
    device = resolve_device(args.device)
    policy = RetryPolicy(max_restarts=args.max_restarts)

    def attempt():
        return train_loop(cfg, steps=args.steps, batch=args.batch,
                          seq=args.seq, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          microbatches=args.microbatches, peak_lr=args.lr,
                          device=device)

    def on_restart(n, err):
        print(f"[train] restart {n} after {type(err).__name__}: {err}")

    out = policy.run(attempt, on_restart=on_restart)
    first = out["losses"][0][1] if out["losses"] else float("nan")
    last = out["losses"][-1][1] if out["losses"] else float("nan")
    print(f"[train] done: loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
