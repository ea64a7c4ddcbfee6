"""The RMSNorm routes of this checkout against the unfused sequence of
another checkout (the Triton RMSNorm kernel with the PyTorch ops around
it), on one card.

  python3 tools/rmsnorm_ab.py OTHER_CHECKOUT [--json FILE]

OTHER_CHECKOUT's ``src/repro_torch/kernels/rmsnorm.py`` is loaded as a
standalone module (it imports only torch, and triton inside its launch).
At the serve shapes of ``chip_smoke.py`` phase 3 (pt-6b-d4 decode x
[8,8,1,1408] and prefill [8,8,512,1408]; dense-6b decode [8,1,4096] and
prefill [8,512,4096]; bf16), each route of ``csrc/rmsnorm.cu`` against
the ops it replaced:

* ``norm``: the fused row spread to the tracks by a contiguous copy
  (PT only), then the Triton norm;
* ``add_norm``: ``x + delta``, then the Triton norm;
* ``fuse_norm`` (PT): ``x + delta``, the fp32 track mean and its cast,
  the spread copy, then the Triton norm under the next block's per-track
  scale rows.

For each: the max |difference| of every output (bitwise equality
reported), and both sides timed in turns (other, this, this, other) as
device work (the calls replayed from a CUDA graph,
``chip_smoke.graph_ms``) over inputs cycled past the 50 MB L2.  Needs
one CUDA GPU.  Prints the card line and one JSON object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _other_norm(other: Path):
    path = other / "src/repro_torch/kernels/rmsnorm.py"
    spec = importlib.util.spec_from_file_location("other_rmsnorm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.rmsnorm


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_ab: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    build.build_all()
    old_norm = _other_norm(args.other.resolve())
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    pcfg, dcfg = get_config(cs.ARCH), get_config(cs.DENSE_ARCH)
    n = pcfg.pt.n_tracks
    rows = []
    for tracks, cfg, phase, bs, iters in (
            (n, pcfg, "decode", (cs.SLOTS, 1), 200),
            (None, dcfg, "decode", (cs.SLOTS, 1), 200),
            (n, pcfg, "prefill", (cs.SLOTS, cs.PROMPT), 30),
            (None, dcfg, "prefill", (cs.SLOTS, cs.PROMPT), 30)):
        arch = cs.ARCH if tracks else cs.DENSE_ARCH
        d, eps = cfg.d_model, cfg.norm_eps
        lead = ((tracks,) if tracks else ()) + bs
        s = torch.randn(*((tracks,) if tracks else ()), d, generator=g,
                        device=dev) * 0.1
        one = 2 * cs.nbytes(torch.empty(*lead, d, dtype=bf))
        sets = [(torch.randn(*bs, d, generator=g, device=dev).to(bf),
                 torch.randn(*lead, d, generator=g, device=dev).to(bf),
                 torch.randn(*lead, d, generator=g, device=dev).to(bf))
                for _ in range(cs.copies_for(2 * one))]

        def spread(f):
            return f[None].expand(tracks, *f.shape)

        pairs = {
            "norm": (lambda f, x, dl: (old_norm(
                        spread(f).contiguous() if tracks else f, s, eps=eps),),
                     lambda f, x, dl: (ops.rmsnorm(
                        spread(f) if tracks else f, s, eps=eps),)),
            "add_norm": (lambda f, x, dl: ((x + dl),
                                            old_norm(x + dl, s, eps=eps)),
                         lambda f, x, dl: ops.add_rmsnorm(x, dl, s,
                                                          eps=eps))}
        if tracks:
            def old_fuse(f, x, dl):
                fu = torch.mean(x + dl, dim=0, dtype=torch.float32).to(bf)
                return fu, old_norm(spread(fu).contiguous(), s, eps=eps)

            pairs["fuse_norm"] = (old_fuse, lambda f, x, dl: ops.fuse_rmsnorm(
                x, dl, s, eps=eps))
        for route, (old, new) in pairs.items():
            a, b = old(*sets[0]), new(*sets[0])
            torch.cuda.synchronize()
            t = [cs.graph_ms(fn, sets, iters) for fn in (old, new, new, old)]
            row = {"at": f"{route}: x [{','.join(map(str, lead))},{d}] bf16 "
                         f"({arch} {phase})",
                   "bitwise_equal": all(torch.equal(u, v)
                                        for u, v in zip(a, b)),
                   "max_abs_diff": max((u.float() - v.float()).abs().max()
                                       .item() for u, v in zip(a, b)),
                   "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
            print(f"[ab] {row['at']}: bitwise {row['bitwise_equal']} (max "
                  f"{row['max_abs_diff']:.3e}); other {row['other_ms']} "
                  f"this {row['this_ms']} ms", flush=True)
            rows.append(row)
        del sets
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
