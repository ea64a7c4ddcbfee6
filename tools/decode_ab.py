"""The decode template of this checkout against another checkout's, bitwise,
at the launches of at most 8 query heads a KV head that the served models
make (head groups change nothing there), on one card.

  python3 tools/decode_ab.py OTHER_CHECKOUT [--json FILE]

Each side runs in its own process (``--side DIR --out FILE``), with
``DIR/src`` first on ``sys.path``: it builds its own kernels, draws the
inputs from one seeded card generator (the drawing code is this file's,
so both sides see the same bytes) and saves every output.  The shapes:
pt-6b-d4's paged decode (8 tracks x 8 rows, G 4, hd 128, 576 live of a
592-token capacity; bf16, int8 and fp32), dense-6b's paged and
contiguous decode (G 4 over 8 KV heads), the speculative drafter's
contiguous rows (32 x 4 heads on 1), gemma3-4b's global paged decode (hd
320, G 2) and its 1024-slot rings, gemma2-2b's paged decode (hd 288,
softcap 50), each with and without a sweep cut.  Needs one CUDA GPU.
Prints the card line and one JSON object: per shape, whether the two
sides' outputs are bitwise equal.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (tag, paged, n, B, H, KH, hd, live, capacity, dtype, int8, softcap)
SHAPES = [
    ("pt-6b-d4 paged", True, 8, 8, 4, 1, 128, 576, 592, "bf16", False, None),
    ("pt-6b-d4 paged int8", True, 8, 8, 4, 1, 128, 576, 592, "bf16", True,
     None),
    ("pt-6b-d4 paged fp32", True, 8, 8, 4, 1, 128, 576, 592, "fp32", False,
     None),
    ("dense-6b paged", True, 1, 8, 32, 8, 128, 576, 592, "bf16", False, None),
    ("dense-6b contiguous", False, 1, 8, 32, 8, 128, 576, 584, "bf16", False,
     None),
    ("drafter contiguous", False, 1, 32, 4, 1, 128, 576, 584, "bf16", False,
     None),
    ("gemma3-4b global paged", True, 1, 8, 8, 4, 320, 1600, 1608, "bf16",
     False, None),
    ("gemma3-4b ring", False, 1, 8, 8, 4, 320, 1024, 1024, "bf16", False,
     None),
    ("gemma2-2b paged softcap", True, 1, 8, 8, 4, 288, 544, 552, "bf16",
     False, 50.0),
]


def side(src: Path, out: Path) -> None:
    sys.path.insert(0, str(src / "src"))
    import torch

    from repro_torch.kernels import build, ops
    from repro_torch.common.quant import quantize_rows
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(27)
    outs = {}
    for (tag, paged, n, B, H, KH, hd, live, cap, dt, int8,
         softcap) in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        lengths = torch.full((B,), live, dtype=torch.int32, device=dev)
        lengths[0] = 1
        if paged:
            nmax = cap // 16
            N = B * nmax + 1
            perm = torch.randperm(N - 1, generator=g, device=dev)
            table = (perm[:B * nmax].reshape(B, nmax) + 1).to(torch.int32)
            shape, qshape = (n, N, 16, KH, hd), (n, B, H, hd)
        else:
            shape, qshape = (B, cap, KH, hd), (B, H, hd)
        q = torch.randn(qshape, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
        scales = {}
        if int8:
            (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
            scales = {"k_scale": ks, "v_scale": vs}
        else:
            k, v = k.to(dtype), v.to(dtype)
        for cut in (None, cap // 2):
            if paged:
                o = ops.paged_decode_attention(q, k, v, table, lengths,
                                               max_len=cut, softcap=softcap,
                                               **scales)
            else:
                o = ops.decode_attention(q, k, v, lengths, max_len=cut,
                                         softcap=softcap, **scales)
            outs[f"{tag}, cut {cut}"] = o.cpu()
    torch.cuda.synchronize()
    torch.save(outs, out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--side", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.side is not None:
        side(args.side.resolve(), args.out)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs
    card = cs.card_line()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        files = {k: Path(tmp) / f"{k}.pt" for k in ("other", "this")}
        procs = [subprocess.Popen([sys.executable, __file__, "--side",
                                   str(d), "--out", str(files[k])])
                 for k, d in (("other", args.other.resolve()),
                              ("this", ROOT))]
        if any(p.wait() for p in procs):
            print("decode_ab: a side failed", file=sys.stderr)
            return 1
        a, b = (torch.load(files[k]) for k in ("other", "this"))
    result = {tag: {"bitwise": torch.equal(a[tag], b[tag]),
                    "max_abs_diff": (a[tag].float() - b[tag].float())
                    .abs().max().item()} for tag in a}
    out = {"card": card, "shapes": result,
           "all_bitwise": all(r["bitwise"] for r in result.values())}
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    return 0 if out["all_bitwise"] else 1


if __name__ == "__main__":
    sys.exit(main())
