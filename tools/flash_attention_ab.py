"""The flash prefill kernel of this checkout against another checkout's, on
one card: every launch with the value width equal to the q/k width
bitwise where both checkouts route it alike, and the serve and gemma
shapes timed.

  python3 tools/flash_attention_ab.py OTHER_CHECKOUT [--json FILE]
      [--digests FILE]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this
checkout (through the port's build) and of OTHER_CHECKOUT (nvcc with the
same flags, into ``build/ab/``), then:

* runs each of ``CASES`` (seeded numpy inputs, ``case_inputs``): the
  serve layouts of pt-6b-d4, dense-6b and qwen2-vl-72b on the wgmma
  route, full attention and softcaps at hd 64, windows and per-row
  offsets on both routes, phase 9's warm tails, fp32 on the CUDA cores,
  and hd 256 / 288 / 320 with their windows and softcaps, through both
  libraries, each on the route its own checkout's ``route`` names, and
  compares the outputs bitwise where the routes agree (each also
  against the plain version; a case whose route changed is reported,
  not compared);
* times the two serve shapes (pt-6b-d4's q [64,512,4,128] with k, v
  [64,512,1,128]; dense-6b's q [8,512,32,128] with k, v [8,512,8,128];
  causal) over inputs cycled past the 50 MB L2, and the wide heads'
  phase-3 shapes (recurrentgemma-9b, gemma3-4b global and local,
  gemma2-2b; ``WIDE``), in turns (other, this, this, other) as device
  work (the calls replayed from a CUDA graph, ``chip_smoke.graph_ms``);
* with ``--digests FILE`` writes each case with its route and the sha256
  of this checkout's output bytes: ``tests/test_torch_gpu.py`` holds
  later launches to them (a case of an unchanged route has the other
  checkout's bytes, as the run shows).

OTHER_CHECKOUT's launcher is the C interface with a value width:
``flash_attention_launch(q, k, v, out, q_off, k_len, B, Sq, Sk, H, KH,
hd, dv, causal, window, softcap, scale, dtype, route, stream)``; its
routes come from its own ``kernels/flash_attention.py::route``.  Needs
one CUDA GPU.  Prints the card line and one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# each case: dtype, B, Sq, Sk, H, KH, hd, causal, window, softcap and
# offsets (row b's queries at q_off[b] + i over keys < q_off[b] + Sq)
CASES = [
    ("bfloat16", 64, 512, 512, 4, 1, 128, True, None, None, None),
    ("bfloat16", 8, 512, 512, 32, 8, 128, True, None, None, None),
    ("bfloat16", 8, 512, 512, 64, 8, 128, True, None, None, None),
    ("bfloat16", 2, 200, 200, 4, 1, 64, False, None, 5.0, None),
    ("bfloat16", 2, 300, 100, 8, 2, 128, False, None, None, None),
    ("bfloat16", 3, 70, 300, 4, 1, 128, True, 37, None, (0, 230, 17)),
    ("bfloat16", 2, 130, 400, 8, 2, 64, True, 130, 5.0, (0, 270)),
    ("bfloat16", 64, 64, 592, 4, 1, 128, True, None, None, (448,) * 64),
    ("float32", 3, 40, 200, 4, 2, 64, True, None, None, (0, 160, 17)),
    ("float32", 2, 130, 130, 4, 1, 128, True, None, 5.0, None),
    ("bfloat16", 2, 512, 512, 8, 4, 288, True, None, 50.0, None),
    ("bfloat16", 2, 1536, 1536, 8, 4, 320, True, 1024, None, None),
    ("bfloat16", 2, 2048, 2048, 16, 1, 256, True, 2048, None, None),
    ("bfloat16", 2, 130, 130, 4, 1, 96, True, None, None, None),
]
KEYS = ("dtype", "B", "Sq", "Sk", "H", "KH", "hd", "causal", "window",
        "softcap", "offsets")
# the wide heads' phase-3 shapes, timed in turns: (name, B, S, H, KH, hd,
# window, softcap), bf16, causal
WIDE = [("recurrentgemma-9b", 8, 2048, 16, 1, 256, 2048, None),
        ("gemma3-4b global", 8, 1536, 8, 4, 320, None, None),
        ("gemma3-4b local", 8, 1536, 8, 4, 320, 1024, None),
        ("gemma2-2b", 8, 512, 8, 4, 288, None, 50.0)]


def case_inputs(case: dict, dev: torch.device):
    """(q, k, v, kwargs of ``flash_attention``) of one case, from numpy
    seeded by the case's shape."""
    c = case
    rng = np.random.default_rng([c["B"], c["Sq"], c["Sk"], c["H"], c["hd"]])
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[c["dtype"]]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dt)
               for s in ((c["B"], c["Sq"], c["H"], c["hd"]),
                         (c["B"], c["Sk"], c["KH"], c["hd"]),
                         (c["B"], c["Sk"], c["KH"], c["hd"])))
    kw = {"causal": c["causal"], "window": c["window"],
          "softcap": c["softcap"]}
    if c["offsets"] is not None:
        off = torch.tensor(c["offsets"], dtype=torch.int32, device=dev)
        kw.update(q_offset=off,
                  k_lengths=torch.clamp(off + c["Sq"], max=c["Sk"])
                  .to(torch.int32))
    return q, k, v, kw


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes."""
    b = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(b).hexdigest()


def _build_other(other: Path):
    """The other checkout's launcher and its ``route`` function."""
    from repro_torch.kernels import build
    src = other / "src/repro_torch/kernels/csrc"
    out = ROOT / "build/ab/flash_attention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src),
                    "-o", str(out), str(src / "flash_attention.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, f, f,
                   i, i, vp]
    fn.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "other_flash_attention",
        other / "src/repro_torch/kernels/flash_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return fn, mod.route


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--digests", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    build.build_all()
    other, other_route = _build_other(args.other.resolve())

    def old(q, k, v, causal=True, window=None, softcap=None, q_offset=None,
            k_lengths=None):
        B, Sq, H, hd = q.shape
        out = torch.empty_like(q)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        r = other_route(q.dtype, hd, all(p % 16 == 0 for p in ptrs))
        build.check(other(*ptrs,
                          None if q_offset is None else q_offset.data_ptr(),
                          None if k_lengths is None
                          else k_lengths.data_ptr(),
                          B, Sq, k.shape[1], H, k.shape[2], hd, hd,
                          int(causal), window or 0, softcap or 0.0,
                          hd ** -0.5, fa._DTYPES[q.dtype], fa._CODES[r],
                          build.cuda_stream(q)), "other flash_attention")
        return out

    cases, equal, compared = [], 0, 0
    for row in CASES:
        c = dict(zip(KEYS, row))
        q, k, v, kw = case_inputs(c, dev)
        a, b = old(q, k, v, **kw), ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        dt = q.dtype
        c.update(route=fa.route(dt, c["hd"], True),
                 other_route=other_route(dt, c["hd"], True))
        same = c["route"] == c["other_route"]
        bitwise = torch.equal(a, b) if same else None
        compared += same
        equal += bool(bitwise)
        c.update(bitwise=bitwise, sha256=digest(b),
                 other_vs_plain=(a.float() - want).abs().max().item(),
                 this_vs_plain=(b.float() - want).abs().max().item())
        print(f"[ab] {row} {c['other_route']} -> {c['route']}: bitwise "
              f"{bitwise if same else 'not compared (route changed)'}; vs "
              f"plain other {c['other_vs_plain']:.3e} this "
              f"{c['this_vs_plain']:.3e}", flush=True)
        cases.append(c)
        del q, k, v, a, b, want
        torch.cuda.empty_cache()

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
        t = [cs.graph_ms(fn, sets, 50)
             for fn in (old, ops.flash_attention, ops.flash_attention, old)]
        row = {"at": f"{arch}: q [{B},{S},{H},{hd}], k, v [{B},{S},{KH},"
                     f"{hd}] bf16, causal",
               "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
        print(f"[ab] {row['at']}: other {row['other_ms']} this "
              f"{row['this_ms']} ms", flush=True)
        rows.append(row)
        del sets
        torch.cuda.empty_cache()
    for name, B, S, H, KH, hd, window, softcap in WIDE:
        kw = dict(causal=True, window=window, softcap=softcap)
        qkv = [tuple(torch.randn(B, S, h, hd, generator=g, device=dev)
                     .to(torch.bfloat16) for h in (H, KH, KH))]
        t = [cs.graph_ms(lambda q, k, v, f=f: f(q, k, v, **kw), qkv, n)
             for f, n in ((old, 2), (ops.flash_attention, 10),
                          (ops.flash_attention, 10), (old, 2))]
        bf = torch.bfloat16
        row = {"at": f"{name}: q [{B},{S},{H},{hd}], k, v [{B},{S},{KH},"
                     f"{hd}] bf16, causal"
                     + (f", window {window}" if window else "")
                     + (f", softcap {softcap}" if softcap else ""),
               "other_route": other_route(bf, hd, True),
               "route": fa.route(bf, hd, True),
               "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
        print(f"[ab] {row['at']}: other ({row['other_route']}) "
              f"{row['other_ms']} this ({row['route']}) {row['this_ms']} ms",
              flush=True)
        rows.append(row)
        del qkv
        torch.cuda.empty_cache()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "other": str(args.other),
              "bitwise": f"{equal}/{compared} of the cases whose route is "
                         f"unchanged ({len(cases)} cases)",
              "cases": cases, "rows": rows}
    for path, obj in ((args.json, result),
                      (args.digests, {"card": card, "cases": [
                          {k: c[k] for k in KEYS + ("route", "sha256")}
                          for c in cases]})):
        if path:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(obj, indent=1))
    print(card)
    print(json.dumps(result))
    return 0 if equal == compared else 1


if __name__ == "__main__":
    sys.exit(main())
