"""whisper-medium's phases of chip_smoke.py alone, on a GPU machine:
build the kernels, then the steps named (default all): ``kernels``
(phase 3's rows: flash full at the encoder's q, k, v [8, 1500, 16, 64]
and the cross prefill's q [8, 4, 16, 64] over [8, 1500, 16, 64],
``decode_attention`` at the cross decode's q [8, 16, 64] over [8, 1500,
16, 64]; each against its plain version and SDPA), ``parity`` (phase 4:
reduced whisper, fp32, card against CPU) and ``serve`` (phase 15:
whisper-medium at full width, prefill + 63 greedy decode steps, its
gates and figures, and the reduced train step card against CPU).

  python3 tools/phase15_only.py [kernels] [parity] [serve]
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
        rows = [{"name": "flash_attention", "shapes": []},
                {"name": "decode_attention", "shapes": []}]
        g = torch.Generator(device=dev).manual_seed(1)
        c.check_slice21_kernels(dev, g, rows)
        print(json.dumps({"kernels": rows}), flush=True)
        c.log(f"[time] kernels at {time.perf_counter() - t0:.1f}s")
    if "parity" in steps:
        c.check_whisper_parity(dev)
        c.log(f"[time] parity at {time.perf_counter() - t0:.1f}s")
    if "serve" in steps:
        c.serve_whisper(dev, card, {})
        c.log("[whisper] summary " + json.dumps(
            {k: v for k, v in c.PHASE15.items() if k != "launches"}))
    c.log(f"[phase15] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
