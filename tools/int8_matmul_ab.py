"""The W8A16 kernel of this checkout against another checkout's, on one card.

  python3 tools/int8_matmul_ab.py OTHER_CHECKOUT [--json FILE]

Builds ``src/repro_torch/kernels/csrc/int8_matmul.cu`` of this checkout
(through the port's build) and of OTHER_CHECKOUT (nvcc with the same
flags, into ``build/ab/``), then at the int8 serve cell's shapes (those
of ``chip_smoke.py`` phase 3: the decode MLP, the fp32 LM head, the five
prefill products of pt-6b-d4):

* compares the two outputs on the same inputs: bitwise where both run the
  same arithmetic (the bf16 decode route), else their max |difference|;
* times both in turns (other, this, this, other) as device work (the
  calls replayed from a CUDA graph, ``chip_smoke.graph_ms``: a decode-row
  call is shorter than its launch on the host) over inputs cycled past
  the 50 MB L2, with fp32 output and with bf16 output (the other
  checkout's fp32 output then cast by ``.to``, as its caller did).

OTHER_CHECKOUT's launcher is the earlier C interface, with fp32 output
and no route: ``int8_matmul_launch(x, w, scale, out, n, M, N, K, dtype,
stream)``.  Needs one CUDA GPU.  Prints the card line and one JSON object.
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


def _build_other(other: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build
    src = other / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/ab/int8_matmul_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src),
                    "-o", str(out), str(src / "int8_matmul.cu")], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    fn = lib.int8_matmul_launch
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_matmul_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    build.build_all()
    other = _build_other(args.other.resolve())
    bf, f32 = torch.bfloat16, torch.float32

    def old(x, w, sc, out_dtype=f32):
        n, M, K = x.shape
        out = torch.empty((n, M, w.shape[2]), dtype=f32, device=dev)
        build.check(other(x.data_ptr(), w.data_ptr(), sc.data_ptr(),
                          out.data_ptr(), n, M, w.shape[2], K,
                          0 if x.dtype == f32 else 1, build.cuda_stream(x)),
                    "other int8_matmul")
        return out if out_dtype == f32 else out.to(out_dtype)

    def new(x, w, sc, out_dtype=f32):
        return ops.int8_matmul(x, w, sc, out_dtype=out_dtype)

    cfg = get_config(cs.ARCH)
    n, H, KH, hd, d = (cfg.pt.n_tracks, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_model)
    P = cs.SLOTS * cs.PROMPT
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for what, nn, M, K, N, xdt, iters in (
            ("decode MLP wi_gate", n, cs.SLOTS, d, cfg.d_ff, bf, 200),
            ("decode LM head, fp32 x", 1, cs.SLOTS, d, cfg.vocab_size, f32,
             100),
            ("prefill wq", n, P, d, H * hd, bf, 20),
            ("prefill wk / wv", n, P, d, KH * hd, bf, 40),
            ("prefill attention wo", n, P, H * hd, d, bf, 20),
            ("prefill MLP wi_gate / wi_up", n, P, d, cfg.d_ff, bf, 10),
            ("prefill MLP wo", n, P, cfg.d_ff, d, bf, 10)):
        one = nn * K * N + nn * M * K * (2 if xdt == bf else 4)
        sets = [(torch.randn(nn, M, K, generator=g, device=dev).to(xdt),
                 torch.randint(-127, 128, (nn, K, N), generator=g,
                               device=dev).to(torch.int8),
                 torch.rand(nn, 1, N, generator=g, device=dev) * 1e-3 + 1e-4)
                for _ in range(cs.copies_for(one))]
        a, b = old(*sets[0]), new(*sets[0])
        torch.cuda.synchronize()
        row = {"at": f"{what}: x [{nn},{M},{K}] {str(xdt)[6:]}, "
                     f"w [{nn},{K},{N}] int8",
               "bitwise_equal": bool(torch.equal(a, b)),
               "max_abs_diff": (a - b).abs().max().item()}
        for form, od in (("fp32_out", f32), ("bf16_out", bf)):
            t = [cs.graph_ms(lambda *s: fn(*s, out_dtype=od), sets, iters)
                 for fn in (old, new, new, old)]
            row[form] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
        print(f"[ab] {row['at']}: bitwise {row['bitwise_equal']} (max "
              f"{row['max_abs_diff']:.3e}); fp32 out other "
              f"{row['fp32_out']['other_ms']} this {row['fp32_out']['this_ms']}"
              f" ms; bf16 out other {row['bf16_out']['other_ms']} this "
              f"{row['bf16_out']['this_ms']} ms", flush=True)
        rows.append(row)
        del sets, a, b
        torch.cuda.empty_cache()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "other": str(args.other), "rows": rows}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
