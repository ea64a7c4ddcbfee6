"""Where the flash prefill route's time goes, on one card.

  python3 tools/flash_attention_variants.py [--shape B,S,H,KH] [--json FILE]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each with parts of the ``wgmma_tma`` route taken out or its rings
deepened by editing a copy of the source (every edit must match as often
as it says, or the script stops), and times each at the shape (default:
pt-6b-d4's prefill, q [64,512,4,128], k, v [64,512,1,128] bf16, causal),
beside SDPA on the same inputs (K / V expanded and transposed
beforehand):

  whole         the route as it is
  no_pingpong   the consumer warpgroups issue their products without
                taking turns
  no_softmax    no softmax (the scores go to P as they are; no mask)
  no_store      no TMA store of the output (the tile is still staged)
  no_mma        no products: loads, softmax, staging and store
  loads_only    the TMA loads and their waits alone
  q3, k3        a third Q buffer, a third K stage (the shared memory
                allows either at hd 128)

The variants other than ``whole``, ``no_pingpong``, ``q3`` and ``k3``
compute garbage; only their times mean anything.  Every variant is built
with the port's nvcc flags into ``build/variants/`` in parallel and timed
as device work (the calls replayed from a CUDA graph,
``chip_smoke.graph_ms``).  Needs one CUDA GPU.  Prints the card line and
one JSON object.
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
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"

# (text in the source, its replacement, how often it occurs)
NO_PINGPONG = [("  if (cw == 1) turn_pass(cw);", "", 1),
               ("if (cw == 0 || t + (int)gridDim.x < tiles) turn_pass(cw);",
                "", 1),
               ("turn_wait(cw);\n", "\n", 3),
               ("turn_pass(cw);\n", "\n", 2)]
NO_SOFTMAX = [("                                               float pre, "
               "float cap) {\n",
               "                                               float pre, "
               "float cap) {\n  return make_float2(1.f, 1.f);\n", 1)]
NO_STORE = [("        tma_store_4d(&omap,", "        if (0) tma_store_4d(&omap,",
             1)]
NO_MMA = [("    wgmma_ss_n128(s, sw128_desc(", "    if (0) wgmma_ss_n128(s, "
           "sw128_desc(", 1),
          ("    if constexpr (HD == 128)\n      wgmma_rs_n128t(",
           "    if constexpr (HD < 0)\n      wgmma_rs_n128t(", 1),
          ("    else\n      wgmma_rs_n64t(", "    else if constexpr (HD < 0)"
           "\n      wgmma_rs_n64t(", 1)]
VARIANTS = {"whole": [],
            "no_pingpong": NO_PINGPONG,
            "no_softmax": NO_SOFTMAX,
            "no_store": NO_STORE,
            "no_mma": NO_MMA,
            "loads_only": NO_MMA + NO_SOFTMAX + NO_STORE,
            "q3": [("constexpr int kQBufs = 2;", "constexpr int kQBufs = 3;",
                    1)],
            "k3": [("constexpr int kKStages = 2;",
                    "constexpr int kKStages = 3;", 1)]}


def _edit(text: str, edits) -> str:
    for old, new, count in edits:
        if text.count(old) != count:
            raise SystemExit(f"flash_attention_variants: the edit {old!r} "
                             f"matches the source {text.count(old)} times, "
                             f"not {count}")
        text = text.replace(old, new)
    return text


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="64,512,4,1")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_variants: no CUDA device visible",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    B, S, H, KH = (int(v) for v in args.shape.split(","))
    hd = 128
    out_dir = ROOT / "build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = out_dir / f"flash_{name}.cu"
        src.write_text(_edit(text, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out_dir / f"flash_{name}.so"), str(src)],
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
    one = 2 * B * S * (H + KH) * hd * 2
    sets = [tuple(torch.randn(B, S, h, hd, generator=g, device=dev)
                  .to(torch.bfloat16) for h in (H, KH, KH))
            for _ in range(cs.copies_for(one))]
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rows = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(out_dir / f"flash_{name}.so")
                         ).flash_attention_launch
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, f, f, i, i, vp]
        fn.restype = i

        def call(q, k, v, fn=fn, name=name):
            out = torch.empty_like(q)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), B, S, S, H, KH, hd, 1, 0.0,
                           hd ** -0.5, 1, 0, build.cuda_stream(q)), name)
            return out
        rows[name] = cs.graph_ms(call, sets, 50)
        print(f"[variants] {name}: {rows[name]:.4f} ms", flush=True)
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous(),
                 v.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous())
                for q, k, v in sets]
    rows["sdpa"] = cs.graph_ms(
        lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), lib_sets, 50)
    print(f"[variants] sdpa: {rows['sdpa']:.4f} ms", flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "shape": [B, S, H, KH, hd], "ms": rows}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
