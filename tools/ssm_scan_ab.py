"""The scan route of ``ssm_scan`` in this checkout against another
checkout's, on one card: every case bitwise (h and h_last), the serve
shapes timed in turns.

  python3 tools/ssm_scan_ab.py OTHER_CHECKOUT [--json FILE] [--digests FILE]
      [--cases-only]

Builds ``src/repro_torch/kernels/csrc/ssm_scan.cu`` of this checkout
(through the port's build) and of OTHER_CHECKOUT (nvcc with the same
flags, into ``build/ab/``), then:

* runs each of ``CASES`` (``tests/ssm_scan_cases.py``: seeded numpy
  inputs, a uniform in [0.5, 1), b and h0 standard normal, cast to the
  case's dtype on the card): recurrentgemma-9b's prefill and chunk
  shapes, the falcon-mamba chunk shape, a ragged S with d_state 1, bf16
  inputs, the register path (rows of a size TMA cannot copy), S 1,
  through both libraries, and compares h and h_last bitwise;
* times the three serve shapes (``TIMED``) in turns (other, this, this,
  other) as device work (the launches replayed from a CUDA graph,
  ``chip_smoke.graph_ms``), each beside its byte bound;
* with ``--digests FILE`` writes each case with the sha256 of the OTHER
  checkout's h and h_last bytes: ``tests/test_torch_gpu.py`` holds later
  launches to them.

Both checkouts' launcher is the C interface ``ssm_scan_launch(a, b, h0,
h, h_last, B, S, F, dtype, stream)``; each side is called on outputs
allocated beforehand, so the two are timed alike.  Needs one CUDA GPU.
Prints the card line and one JSON object.
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

sys.path.insert(0, str(ROOT / "tests"))
from ssm_scan_cases import CASES, KEYS, case_inputs, digest  # noqa: E402

TIMED = [("recurrentgemma-9b prefill", (8, 2048, 4096)),
         ("recurrentgemma-9b chunk 512", (8, 512, 4096)),
         ("falcon-mamba chunk", (8, 256, 8192, 16))]
_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(fn):
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _build_other(other: Path):
    """The other checkout's ``ssm_scan_launch``."""
    from repro_torch.kernels import build
    src = other / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/ab/ssm_scan_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src),
                    "-o", str(out), str(src / "ssm_scan.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    return _bind(ctypes.CDLL(str(out)).ssm_scan_launch)


def launcher(fn, name: str):
    """A call (a, b, h0, h, h_last) of the C launcher ``fn``."""
    from repro_torch.kernels import build

    def run(a, b, h0, h, h_last):
        B, S = a.shape[:2]
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), B, S, a[0, 0].numel(), _CODE[a.dtype],
                 build.cuda_stream(a))
        build.check(err, name)
    return run


def outputs(a, h0):
    return (torch.empty(a.shape, dtype=torch.float32, device=a.device),
            torch.empty(h0.shape, dtype=torch.float32, device=a.device))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--digests", type=Path, default=None)
    ap.add_argument("--cases-only", action="store_true",
                    help="skip the timed shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_scan_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    build.SOURCES = ("ssm_scan.cu",)       # the one library this tool runs
    build.build_all()
    old = launcher(_build_other(args.other.resolve()), "other ssm_scan")
    lib = build.library("ssm_scan.cu")
    new = launcher(_bind(lib.ssm_scan_launch), "ssm_scan")
    cases, equal = [], 0
    for dtype, shape in CASES:
        c = {"dtype": dtype, "shape": list(shape)}
        a, b, h0 = case_inputs(c, dev)
        (ho, hlo), (hn, hln) = outputs(a, h0), outputs(a, h0)
        old(a, b, h0, ho, hlo)
        new(a, b, h0, hn, hln)
        torch.cuda.synchronize()
        bitwise = torch.equal(ho, hn) and torch.equal(hlo, hln)
        equal += bitwise
        err = None
        if a.numel() <= 2 ** 24:            # the step loop is slow past it
            want, want_last = ref.ssm_scan_plain(a, b, h0)
            err = max((hn - want).abs().max().item(),
                      (hln - want_last).abs().max().item())
        c.update(bitwise=bitwise, sha256_h=digest(ho),
                 sha256_h_last=digest(hlo), this_vs_plain=err)
        print(f"[ab] {dtype} {list(shape)}: bitwise {bitwise}; vs plain "
              f"{'not run' if err is None else f'{err:.3e}'}", flush=True)
        cases.append(c)
        del a, b, h0, ho, hlo, hn, hln
        torch.cuda.empty_cache()

    rows = []
    for name, shape in ([] if args.cases_only else TIMED):
        a, b, h0 = case_inputs({"dtype": "float32", "shape": shape}, dev)
        outs = outputs(a, h0)
        sets = [(a, b, h0) + outs]
        t = [cs.graph_ms(fn, sets, 10) for fn in (old, new, new, old)]
        bound = cs.nbytes(a, b, h0, *outs) / cs.HBM_BYTES_S * 1e3
        row = {"at": f"{name}: a, b {list(shape)} fp32", "bound_ms": bound,
               "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
               "this_share_of_bound": bound / min(t[1], t[2])}
        print(f"[ab] {row['at']}: other {row['other_ms']} this "
              f"{row['this_ms']} ms, bound {bound:.4f} ms", flush=True)
        rows.append(row)
        del a, b, h0, outs, sets
        torch.cuda.empty_cache()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "other": str(args.other),
              "bitwise": f"{equal}/{len(cases)} cases", "cases": cases,
              "rows": rows}
    for path, obj in ((args.json, result),
                      (args.digests, {"card": card, "cases": [
                          {k: c[k] for k in KEYS + ("sha256_h",
                                                    "sha256_h_last")}
                          for c in cases]})):
        if path:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(obj, indent=1))
    print(card)
    print(json.dumps(result))
    return 0 if equal == len(cases) else 1


if __name__ == "__main__":
    sys.exit(main())
