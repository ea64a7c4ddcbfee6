"""On a GPU machine: the host time of each engine step of chip_smoke.py
phase 10 (a)'s contended run (4 priority-0 requests, then 4 priority-1
requests that preempt them, on a pool of ROBUST_BLOCKS blocks) against
the same prompts served uncontended, with the prefix cache on and off;
each step ends in ``torch.cuda.synchronize()``.  Prints the median step
time by (requests waiting in the queue, requests decoding), the
preemptions and the TPOT p50.

  python3 tools/robust_step_time.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def timed_steps(eng, label: str) -> None:
    times = {}
    steps = 0
    while eng.scheduler.has_work():
        key = (bool(eng.scheduler.queue),
               sum(r.state.value == "decode"
                   for _, r in eng.scheduler.active_slots()))
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        times.setdefault(key, []).append(time.perf_counter() - t0)
        steps += 1
    m = eng.metrics.summary()
    c.log(f"[steps] {label}: {steps} steps, preemptions {m['preemptions']}, "
          f"TPOT p50 {m['tpot_ms']['p50']:.3f} ms")
    for (waiting, decoding), v in sorted(times.items()):
        c.log(f"[steps] {label}:   queue waiting {waiting}, decoding "
              f"{decoding}: {len(v)} steps, median "
              f"{np.median(v) * 1e3:.3f} ms")


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    c.log(f"[card] {c.card_line()}")
    c.build_kernels()
    from repro_torch.configs import get_config
    from repro_torch.core.track import init_pt
    cfg = get_config(c.ARCH)
    params = init_pt(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=(c.PROMPT,)).tolist()
               for _ in range(c.SLOTS)]
    warm = [rng.integers(1, cfg.vocab_size, size=(16,)).tolist()
            for _ in range(c.SLOTS)]
    for cached in (False, True):
        eng = c._robust_engine(dev, cfg, params, prefix_cache=cached)
        eng.generate(warm, 3)
        for p in prompts:
            eng.submit(p, c.NEW)
        timed_steps(eng, f"uncontended, prefix cache {cached}")
        del eng
        c._free()
    for cached in (True, False):
        eng = c._robust_engine(dev, cfg, params, prefix_cache=cached,
                               num_blocks=c.ROBUST_BLOCKS)
        eng.generate(warm, 3)
        for p in prompts[:c.HALF]:
            eng.submit(p, c.NEW, priority=0)
        eng.step()
        eng.step()
        for p in prompts[c.HALF:]:
            eng.submit(p, c.NEW, priority=1)
        timed_steps(eng, f"contended, prefix cache {cached}")
        del eng
        c._free()


if __name__ == "__main__":
    main()
