"""Where the W8A16 prefill route's time goes, on one card.

  python3 tools/int8_matmul_variants.py [--shape n,M,K,N] [--json FILE]

Builds variants of ``src/repro_torch/kernels/csrc/int8_matmul.cu``, each
with parts of the ``wgmma_tma`` route taken out by editing a copy of the
source (every edit must match, or the script stops), and times each at
the shape (default: pt-6b-d4's prefill gate product, x [8,4096,1408] @ w
[8,1408,3968]) with fp32 and with bf16 output:

  whole        the route as it is
  no_store     no TMA store of the output (the tile is still staged)
  loads_only   the TMA loads and their waits, no widening, products or store
  mma_only     the products and the epilogue staging, no loads or widening
  mma_widen    mma_only with the widening

The variants compute garbage; only their times mean anything.  Every
variant is built with the port's nvcc flags into ``build/variants/`` in
parallel and timed with CUDA events (``chip_smoke.time_ms``).  Needs one
CUDA GPU.  Prints the card line and one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/int8_matmul.cu"

# (text in the source, its replacement) for each part a variant drops
NO_STORE = [("            tma_store_3d(&omap, stage_o + i * (RP * 128),",
             "            if (0) tma_store_3d(&omap, stage_o + i * (RP * 128),")]
NO_WIDEN = [("    const uint2 lo = widen4_bf16(__byte_perm(h[4 * kk], "
             "h[4 * kk + 1], 0x5140));",
             "    const uint2 lo = make_uint2(h[4 * kk], h[4 * kk + 1]);"),
            ("        widen4_bf16(__byte_perm(h[4 * kk + 2], h[4 * kk + 3], "
             "0x5140));",
             "        make_uint2(h[4 * kk + 2], h[4 * kk + 3]);")]
NO_MMA = [("    for (int kk = 0; kk < BK / 16; ++kk)\n"
           "      wgmma_m64n256k16_rs(",
           "    for (int kk = 0; kk < 0; ++kk)\n"
           "      wgmma_m64n256k16_rs(")]
NO_LOAD = [("    if (tid == 0) {\n      int it = 0;",
            "    if (tid == -1) {\n      int it = 0;"),
           ("    if (it + 1 < total) mbar_wait(&full[(it + 1) % S], "
            "((it + 1) / S) & 1);\n", ""),
           ("    mbar_wait(&full[0], 0);\n", "")]
VARIANTS = {"whole": [],
            "no_store": NO_STORE,
            "loads_only": NO_STORE + NO_WIDEN + NO_MMA,
            "mma_only": NO_STORE + NO_WIDEN + NO_LOAD,
            "mma_widen": NO_STORE + NO_LOAD}


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"int8_matmul_variants: the edit {old!r} does "
                             f"not match the source once")
        text = text.replace(old, new)
    return text


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="8,4096,1408,3968")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_matmul_variants: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    n, M, K, N = (int(v) for v in args.shape.split(","))
    out_dir = ROOT / "build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(_edit(text, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for ln in log.splitlines():
            if "Potential Performance Loss" in ln:
                print(f"[variants] {name}: {ln.strip()}")
    card = cs.card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, M, K, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, K, N), generator=g,
                      device=dev).to(torch.int8)
    sc = torch.rand(n, 1, N, generator=g, device=dev) * 1e-3 + 1e-4
    vp, i = ctypes.c_void_p, ctypes.c_int
    rows = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).int8_matmul_launch
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = i
        rows[name] = {}
        for form, dt, code in (("fp32_out", torch.float32, 0),
                               ("bf16_out", torch.bfloat16, 1)):
            out = torch.empty(n, M, N, dtype=dt, device=dev)

            def call():
                build.check(fn(x.data_ptr(), w.data_ptr(), sc.data_ptr(),
                               out.data_ptr(), n, M, N, K, 1, code, 0,
                               build.cuda_stream(x)), name)
            rows[name][form] = cs.time_ms(call, [()], 20)
        print(f"[variants] {name}: fp32 out {rows[name]['fp32_out']:.4f} "
              f"ms, bf16 out {rows[name]['bf16_out']:.4f} ms", flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "shape": [n, M, K, N], "ms": rows}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
