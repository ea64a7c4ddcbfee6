"""Phase 16 of chip_smoke.py alone, on a GPU machine: build the kernels,
then the parts named (default all): ``parity`` ((a) reduced falcon-mamba,
recurrentgemma, deepseek-v2 and deepseek-v3 trained 3 steps on the card
and on the CPU, then (c) each trained checkpoint served by
``launch/serve.py --ckpt-dir`` on both, launches by kernel and route) and
``full`` ((b) falcon-mamba-7b at 8 of 64 layers and recurrentgemma-9b at
8 of 38 under AdamW, batch 8 x 512; deepseek-v2-236b at 2 of 60 under
Adafactor, batch 4 x 512; bf16).

  python3 tools/phase16_only.py [parity] [full]
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
    parts = sys.argv[1:] or ["parity", "full"]
    t0 = time.perf_counter()
    if "parity" in parts:
        c.build_kernels()
        trained = {arch: c._card_vs_cpu("train16", arch, dev,
                                        c.TRAIN16_STEPS, c.PHASE16)
                   for arch in c.TRAIN16_ARCHS}
        c.train16_serve(dev, trained, {})
        del trained
    if "full" in parts:
        for arch in c.TRAIN16_FULL:
            c.train16_full(dev, card, arch)
    c.log("[train16] summary " + json.dumps(c.PHASE16))
    c.log(f"[train16] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
