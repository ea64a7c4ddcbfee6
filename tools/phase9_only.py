"""chip_smoke.py's phase 9 alone, on a GPU machine: build the kernels,
draw pt-6b-d4 bf16 from seed 0 (phase 5's tree), then the prefix-cache
runs, all of them or those named: ``a`` (bf16 warm hit), ``b`` (int8
weights + int8 KV), ``cd`` (the greedy and the sampled fork), ``e`` (the
speculative warm hit on the tracks tied in place).

  python3 tools/phase9_only.py [a] [b] [cd] [e]
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
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
    params = init_pt(torch.Generator(device=dev).manual_seed(0),
                     get_config(c.ARCH), dev)
    t0 = time.perf_counter()
    steps = sys.argv[1:] or ["a", "b", "cd", "e"]
    if "a" in steps:
        c.prefix_hit(dev, card, params, "bf16")
    if "b" in steps:
        c.prefix_hit(dev, card, params, "int8 weights + int8 KV", int8=True)
    if "cd" in steps:
        c.fork_runs(dev, card, params)
    if "e" in steps:
        c._tie_tracks(params["blocks"])
        c.prefix_spec(dev, card, params)
    c.log(f"[prefix] phase 9 took {time.perf_counter() - t0:.1f}s")
    c.log("[prefix] summary " + json.dumps(c.PREFIX))


if __name__ == "__main__":
    main()
