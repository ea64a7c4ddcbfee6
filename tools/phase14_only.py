"""Phase 14 of chip_smoke.py alone, on a GPU machine: build the kernels,
then the training steps named (default all): ``parity`` ((a) reduced PT
and dense trained 4 steps on the card and on the CPU, then (d) the
trained PT's checkpoint served by ``launch/serve.py --ckpt-dir`` on both),
``resume`` ((c) checkpoint and resume bitwise, deterministic algorithms,
in a child process) and ``full`` ((b) pt-6b-d4 at 16 and dense-6b at 8
of their 32 layers, bf16 + fp32 master, batch 8 x 512).

  python3 tools/phase14_only.py [parity] [resume] [full]
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
    steps = sys.argv[1:] or ["parity", "resume", "full"]
    t0 = time.perf_counter()
    if "parity" in steps:
        c.train_then_serve(dev, c.train_parity(dev), {})
    if "resume" in steps:
        c.train_resume(dev)
    if "full" in steps:
        for arch in c.TRAIN_CUT:
            c.train_full(dev, card, arch)
    c.log("[train] summary " + json.dumps(c.PHASE14))
    c.log(f"[train] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
