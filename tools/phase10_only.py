"""chip_smoke.py's phase 10 alone, on a GPU machine: build the kernels,
draw pt-6b-d4 bf16 from seed 0 (phase 5's tree), serve phase 5's prompts
uncontended (its sync bf16 run, prefix cache off: the reference streams),
then the robustness runs: (a) preemption bf16, (b) int8 weights + int8
KV, (c) transfer faults, (d) cancel and deadline, (e) the watchdog.

  python3 tools/phase10_only.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = c.card_line()
    c.log(f"[card] {card} | torch {torch.__version__}")
    c.build_kernels()
    from repro_torch.configs import get_config
    from repro_torch.core.track import init_pt
    cfg = get_config(c.ARCH)
    params = init_pt(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    # phase 5's prompts: its rng draws the warm-up prompts first
    rng = np.random.default_rng(0)
    for _ in range(c.SLOTS):
        rng.integers(1, cfg.vocab_size, size=(16,))
    prompts = [rng.integers(1, cfg.vocab_size, size=(c.PROMPT,)).tolist()
               for _ in range(c.SLOTS)]
    eng = c._robust_engine(dev, cfg, params, prefix_cache=False)
    ref = eng.generate(prompts, c.NEW)
    del eng
    c._free()
    t0 = time.perf_counter()
    c.robust_runs(dev, card, params, prompts, ref)
    c.log(f"[robust] phase 10 alone took {time.perf_counter() - t0:.1f}s")
    c.log("[robust] summary " + json.dumps(c.ROBUST))


if __name__ == "__main__":
    main()
