"""qwen2-vl-72b's and recurrentgemma-9b's phases of chip_smoke.py alone,
on a GPU machine: build the kernels, then the steps named (default all):
``kernels`` (phase 3's rows at their shapes: decode over recurrentgemma's
2048-slot rings at 16 query heads a KV head, paged decode at qwen2-vl's,
flash at both prefills, the scan at recurrentgemma's prefill and
chunk; each held against its plain version), ``parity`` (phase 4's
reduced qwen2-vl from precomputed embeddings with grid (t, h, w)
streams and reduced recurrentgemma whole and chunked, card against CPU)
and ``serve`` (phase
12: qwen2-vl-72b at 16 of 80 layers with its embeddings arm,
recurrentgemma-9b at full depth, sync, planned and chunked).

  python3 tools/phase12_only.py [kernels] [parity] [serve]
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
        rows = [{"name": n, "shapes": []} for n in (
            "flash_attention", "paged_decode_attention", "decode_attention")]
        g = torch.Generator(device=dev).manual_seed(1)
        c.check_slice16_kernels(dev, g, rows)
        print(json.dumps({"kernels": rows}), flush=True)
    if "parity" in steps:
        c.check_slice16_parity(dev)
    if "serve" in steps:
        c.serve_phase12(dev, card, {})
        c.log("[phase12] summary " + c.phase12_summary())
    c.log(f"[phase12] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
