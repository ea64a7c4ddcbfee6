"""This slice's phases of chip_smoke.py alone, on a GPU machine: build
the kernels, then the steps named (default all): ``kernels`` (phase 3's
rows at gemma3-4b's and gemma2-2b's shapes and the flash offset route,
each held against its plain version), ``parity`` (phase 4's reduced
gemma2, gemma3 and nemotron, card against CPU), ``prefix`` (phase 9 (a):
pt-6b-d4 bf16 warm prefix hits, gated bitwise the cold run) and
``serve`` (phase 11: the three models at full width).

  python3 tools/layers_only.py [kernels] [parity] [prefix] [serve]
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
    steps = sys.argv[1:] or ["kernels", "parity", "prefix", "serve"]
    t0 = time.perf_counter()
    if "kernels" in steps:
        rows = [{"name": n, "shapes": []} for n in (
            "flash_attention", "paged_decode_attention", "decode_attention")]
        c.check_layer_kernels(dev, torch.Generator(device=dev).manual_seed(1),
                              rows)
        print(json.dumps({"kernels": rows}), flush=True)
    if "parity" in steps:
        c.check_layer_parity(dev)
    if "prefix" in steps:
        from repro_torch.configs import get_config
        from repro_torch.core.track import init_pt
        params = init_pt(torch.Generator(device=dev).manual_seed(0),
                         get_config(c.ARCH), dev)
        c.prefix_hit(dev, card, params, "bf16")
        del params
        torch.cuda.empty_cache()
        c.log("[prefix] summary " + json.dumps(
            {k: {h: {x: y for x, y in f.items() if x != "launches"}
                 if isinstance(f, dict) else f for h, f in v.items()}
             for k, v in c.PREFIX.items()}, default=str))
    if "serve" in steps:
        c.serve_layer_models(dev, card, {})
        c.log("[layers] summary " + json.dumps(
            {k: ({m: {x: y for x, y in f.items() if x != "launches"}
                  for m, f in v.items()} if isinstance(v, dict) else v)
             for k, v in c.LAYER_RUNS.items()}))
    c.log(f"[layers] took {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
