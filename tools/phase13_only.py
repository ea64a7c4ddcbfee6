"""deepseek-v2-236b's and deepseek-v3-671b's phases of chip_smoke.py
alone, on a GPU machine: build the kernels, then the steps named
(default all): ``kernels`` (phase 3's row: flash at the MLA prefill, q, k
[8, 512, 128, 192], v [8, 512, 128, 128], against its plain version and
SDPA), ``parity`` (phase 4: both reduced models, fp32, card against CPU)
and ``serve`` (phase 13: deepseek-v2-236b at 8 of 60 layers and
deepseek-v3-671b at 5 of 61, sync then planned).

  python3 tools/phase13_only.py [kernels] [parity] [serve]
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
    steps = sys.argv[1:] or ["kernels", "parity", "serve"]
    t0 = time.perf_counter()
    if "kernels" in steps:
        rows = [{"name": "flash_attention", "shapes": []}]
        g = torch.Generator(device=dev).manual_seed(1)
        c.check_slice17_kernels(dev, g, rows)
        print(json.dumps({"kernels": rows}), flush=True)
    if "parity" in steps:
        c.check_slice17_parity(dev)
    if "serve" in steps:
        c.serve_phase13(dev, card, {})
        c.log("[phase13] summary " + c.phase13_summary())
    c.log(f"[phase13] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
