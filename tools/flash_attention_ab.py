"""The flash prefill kernel of this checkout against another checkout's, on
one card.

  python3 tools/flash_attention_ab.py OTHER_CHECKOUT [--json FILE]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this
checkout (through the port's build) and of OTHER_CHECKOUT (nvcc with the
same flags, into ``build/ab/``), then at the bf16 serve cells' prefill
shapes (those of ``chip_smoke.py`` phase 3: pt-6b-d4's q [64,512,4,128]
with k, v [64,512,1,128], and dense-6b's q [8,512,32,128] with k, v
[8,512,8,128], causal):

* compares the two outputs on the same inputs (max |difference|), and
  each with the plain version;
* times both in turns (other, this, this, other) as device work (the
  calls replayed from a CUDA graph, ``chip_smoke.graph_ms``) over inputs
  cycled past the 50 MB L2.

OTHER_CHECKOUT's launcher is the earlier C interface, with no route:
``flash_attention_launch(q, k, v, out, B, Sq, Sk, H, KH, hd, causal,
softcap, scale, dtype, stream)``.  Needs one CUDA GPU.  Prints the card
line and one JSON object.
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


def _build_other(other: Path):
    from repro_torch.kernels import build
    src = other / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/ab/flash_attention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src),
                    "-o", str(out), str(src / "flash_attention.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, f, f, i, vp]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    build.build_all()
    other = _build_other(args.other.resolve())

    def old(q, k, v):
        B, Sq, H, hd = q.shape
        out = torch.empty_like(q)
        build.check(other(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, Sq, k.shape[1], H, k.shape[2],
                          hd, 1, 0.0, hd ** -0.5, 1, build.cuda_stream(q)),
                    "other flash_attention")
        return out

    def new(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)

    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for arch, batch in ((cs.ARCH, None), (cs.DENSE_ARCH, cs.SLOTS)):
        cfg = get_config(arch)
        B = batch or cfg.pt.n_tracks * cs.SLOTS
        H, KH, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cs.PROMPT
        one = 2 * B * S * (H + KH) * hd * 2
        sets = [tuple(torch.randn(B, S, h, hd, generator=g, device=dev)
                      .to(torch.bfloat16) for h in (H, KH, KH))
                for _ in range(cs.copies_for(one))]
        a, b = old(*sets[0]), new(*sets[0])
        want = ref.flash_attention_plain(*sets[0], causal=True).float()
        torch.cuda.synchronize()
        t = [cs.graph_ms(fn, sets, 50) for fn in (old, new, new, old)]
        row = {"at": f"{arch}: q [{B},{S},{H},{hd}], k, v [{B},{S},{KH},"
                     f"{hd}] bf16, causal",
               "max_abs_diff": (a.float() - b.float()).abs().max().item(),
               "other_vs_plain": (a.float() - want).abs().max().item(),
               "this_vs_plain": (b.float() - want).abs().max().item(),
               "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
        print(f"[ab] {row['at']}: max diff {row['max_abs_diff']:.3e} (vs "
              f"plain: other {row['other_vs_plain']:.3e}, this "
              f"{row['this_vs_plain']:.3e}); other {row['other_ms']} this "
              f"{row['this_ms']} ms", flush=True)
        rows.append(row)
        del sets, a, b, want
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
