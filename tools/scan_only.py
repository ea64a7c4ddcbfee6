"""The phases of chip_smoke.py that run the scan kernel, alone, on a GPU
machine: build the kernels, then the steps named (default all):
``kernels`` (phase 3's scan rows: the selective route at falcon-mamba's
chunk against its plain version and the unfused route, h_last bitwise,
then ragged lens and small d_state; the scan route at falcon-mamba's
shape and its small checks; the scan route at recurrentgemma-9b's
prefill and chunk), ``parity`` (phase 4's reduced falcon-mamba and
reduced recurrentgemma, card against CPU), ``falcon`` (phase 5-6's
falcon-mamba-7b run, sync then planned: TTFT, TPOT, peak memory, the
admission step's device busy time, launch and scan route arithmetic) and
``rg`` (phase 12's recurrentgemma-9b, sync, planned and chunked).

  python3 tools/scan_only.py [kernels] [parity] [falcon] [rg]
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
    steps = sys.argv[1:] or ["kernels", "parity", "falcon", "rg"]
    t0 = time.perf_counter()
    if "kernels" in steps:
        g = torch.Generator(device=dev).manual_seed(1)
        rows = [c.check_selective_scan(dev, g), c.scan_row(dev, g)]
        rows[-1]["shapes"] = [c.scan_row(dev, g, c.RG_CHUNK)]
        print(json.dumps({"kernels": rows}), flush=True)
        c.log_time("scan kernels")
    if "parity" in steps:
        c.check_mamba_parity(dev)
        c.check_slice16_parity(dev)
        c.log_time("parity")
    if "falcon" in steps:
        c.serve_falcon(dev, card)
        c.log("[falcon] summary " + json.dumps(c.FALCON))
        c.log_time("falcon-mamba")
    if "rg" in steps:
        c.serve_layer_model(dev, card, c.RG_ARCH, c.RG_PROMPT, c.RG_NEW,
                            planned=True, cap=c.RG_PROMPT + c.RG_NEW,
                            chunk=c.RG_CHUNK, store=c.PHASE12)
        c.log("[phase12] summary " + c.phase12_summary())
        c.log_time("recurrentgemma-9b")
    c.log("[scan] scan routes by run " + json.dumps(c.SCAN_ROUTES))
    c.log(f"[scan] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
