"""The serve runs of ``chip_smoke.py`` that launch the scan kernel, on
this checkout and on another one, in turns, on one card.

  python3 tools/scan_serve_ab.py OTHER_CHECKOUT [--json FILE]
      [--order this,other,other,this]

Each side runs in its own process (both checkouts hold a package named
``repro_torch`` and a ``chip_smoke.py``), in the order given (default
this, other, other, this); each process builds its checkout's kernels
(both checkouts are built first, at once), then calls its own
``chip_smoke.py``: ``serve_falcon`` (falcon-mamba-7b bf16, chunk 256,
sync then planned) and ``serve_layer_model`` for recurrentgemma-9b
(2048-token prompts; sync, planned and chunk 512), with every gate
those functions hold.  Per side and turn it reports TTFT and TPOT p50
and peak memory of each run, and falcon-mamba's admission step's device
busy time, as the runs log them (falcon-mamba's from the ``[pair]`` and
``[profile]`` lines, recurrentgemma-9b's from ``PHASE12``); with
``--json FILE`` each turn's log goes beside FILE.  Needs one CUDA GPU.
Prints the card line and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_NUM = r"([0-9.]+)"
_PAIR = re.compile(r"falcon-mamba bf16: sync -> planned: TTFT ms p50 "
                   rf"{_NUM} -> {_NUM},.*TPOT ms p50 {_NUM} -> {_NUM},.*"
                   rf"peak memory {_NUM} -> {_NUM} GB")
_BUSY = re.compile(r"falcon-mamba bf16 admission step \(first prompt "
                   rf"chunk\): device busy {_NUM} ms")


def worker(checkout: Path, build_only: bool) -> None:
    """Build ``checkout``'s kernels and, unless ``build_only``, serve its
    scan runs; print one JSON line of their figures."""
    sys.path[:0] = [str(checkout), str(checkout / "src")]
    import torch
    import chip_smoke as c
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.build_kernels()
    if build_only:
        return
    lines = []
    log = c.log
    c.log = lambda msg: (lines.append(msg), log(msg))[-1]
    dev = torch.device("cuda", torch.cuda.current_device())
    card = c.card_line()
    c.serve_falcon(dev, card)
    c.serve_layer_model(dev, card, c.RG_ARCH, c.RG_PROMPT, c.RG_NEW,
                        planned=True, cap=c.RG_PROMPT + c.RG_NEW,
                        chunk=c.RG_CHUNK, store=c.PHASE12)
    pair = [m for m in map(_PAIR.search, lines) if m]
    busy = [m for m in map(_BUSY.search, lines) if m]
    if len(pair) != 1:
        raise SystemExit(f"scan_serve_ab: {len(pair)} falcon-mamba [pair] "
                         f"lines")
    p = [float(x) for x in pair[0].groups()]
    out = {"falcon-mamba-7b": {
        "sync": {"ttft_ms_p50": p[0], "tpot_ms_p50": p[2], "peak_gb": p[4]},
        "planned": {"ttft_ms_p50": p[1], "tpot_ms_p50": p[3],
                    "peak_gb": p[5]},
        "admission_busy_ms": float(busy[0].group(1)) if busy else None}}
    out[c.RG_ARCH] = {
        mode: {"ttft_ms_p50": f["ttft_ms"]["p50"],
               "tpot_ms_p50": f["tpot_ms"]["p50"], "peak_gb": f["peak_gb"]}
        for mode, f in c.PHASE12[c.RG_ARCH].items() if isinstance(f, dict)
        and "ttft_ms" in f}
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--order", default="this,other,other,this")
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.build_only)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_serve_ab: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sides = {"other": args.other.resolve(), "this": ROOT}
    order = args.order.split(",")
    if set(order) - set(sides):
        raise SystemExit(f"scan_serve_ab: unknown sides in {order}")
    builds = [subprocess.Popen([sys.executable, __file__, "--worker",
                                str(path), "--build-only"],
                               stdout=subprocess.DEVNULL)
              for path in sides.values()]
    if any(b.wait() for b in builds):
        raise SystemExit("scan_serve_ab: a build failed")
    turns = []
    for i, side in enumerate(order):
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(sides[side])], stdout=subprocess.PIPE,
                             text=True, check=True).stdout
        if args.json:           # each turn's log beside the JSON
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.with_name(f"{args.json.stem}_{i}_{side}.log"
                                ).write_text(out)
        res = [json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
               if ln.startswith("RESULT ")]
        turns.append({"side": side, **res[0]})
        print(f"[scan_serve_ab] {side}: {json.dumps(res[0])}", flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "other": str(args.other), "turns": turns}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
