"""Where the flash prefill route's time goes, on one card.

  python3 tools/flash_attention_variants.py [--shape B,S,H,KH] [--hd HD]
      [--variants NAME,...] [--json FILE]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``,
each with parts of the ``wgmma_tma`` route taken out or its rings
deepened by editing a copy of the source (every edit must match as often
as it says, or the script stops), and times each at the shape (default:
pt-6b-d4's prefill, q [64,512,4,128], k, v [64,512,1,128] bf16, causal;
``--hd`` any width the route takes, e.g. ``--shape 8,2048,16,1 --hd
256`` for recurrentgemma-9b's prefill), beside SDPA on the same inputs
(K / V expanded and transposed beforehand):

  whole         the route as it is
  no_pingpong   the consumer warpgroups issue their products without
                taking turns
  no_softmax    no softmax (the scores go to P as they are; no mask)
  no_store      no TMA store of the output (the tile is still staged)
  no_mma        no products: loads, softmax, staging and store
  loads_only    the TMA loads and their waits alone
  q3, k3        a third Q buffer, a third K stage (the shared memory
                allows either at hd 64 and 128 only; k3 at the other
                widths fails to launch)
  overlapped    the wide widths issue k-tile j's Q K^T and k-tile j - 1's
                P V as ``fa::kOverlapped`` (the softmax of j under the
                P V), as the narrower ones do, not ``kJoint``
                (``Smem::kIssue``)
  q_early       (one Q buffer only, garbage) the buffer goes back to the
                producer after the tile's last Q K^T, the output staged
                over the next Q and not stored: what the next tile's Q
                load costs at the tile boundary (with no output read,
                ptxas would drop the P V products)
  regs240       consumers at 240 registers, the producer at 24 (232 and
                40 as built)
  drop_tile     (a fault, the control of the error checks) the last
                q-tile of each head skips the key tile before its
                diagonal tile, as if it were never visited

The variants ``no_softmax``, ``no_store``, ``no_mma`` and ``loads_only``
compute garbage; only their times mean anything.  The others are held
against the plain version on the first input set: max |err| and
``max_row_rel_err`` (``chip_smoke.row_rel_err``: the largest of each
output row's error norm over the plain row's norm), which ``drop_tile``
shows a dropped key tile moving where max |err| may not.  Every variant named
(default all) is built with the port's nvcc flags into
``build/variants/`` in parallel, its ptxas spill line for the ``--hd``
instantiations printed, and timed as device work (the calls replayed
from a CUDA graph, ``chip_smoke.graph_ms``).  Needs one CUDA GPU.  Prints
the card line and one JSON object.
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
               ("turn_pass(cw);\n", "\n", 3)]
NO_SOFTMAX = [("float c2, float pre,\n" + " " * 47 + "float cap) {\n",
               "float c2, float pre,\n" + " " * 47 + "float cap) {\n"
               "  return make_float2(1.f, 1.f);\n", 1)]
NO_STORE = [("        tma_store_4d(&omap,", "        if (0) tma_store_4d(&omap,",
             1)]
# every wgmma helper (SS n128 / n64 / n48, RS n128 / n64) issues nothing
NO_MMA = [("  asm volatile(\n      \"{\\n.reg .pred p;\\nsetp.ne.b32 p",
           "  if (0) asm volatile(\n      \"{\\n.reg .pred p;\\nsetp.ne.b32 p",
           5)]

# the variants whose output means nothing
GARBAGE = ("no_softmax", "no_store", "no_mma", "loads_only", "q_early")


VARIANTS = {"whole": [],
            "no_pingpong": NO_PINGPONG,
            "no_softmax": NO_SOFTMAX,
            "no_store": NO_STORE,
            "no_mma": NO_MMA,
            "loads_only": NO_MMA + NO_SOFTMAX + NO_STORE,
            "q3": [("bytes(2) <= kMaxSmem ? 2 : 1",
                    "bytes(3) <= kMaxSmem ? 3 : 1", 1)],
            "k3": [("constexpr int kKStages = 2;",
                    "constexpr int kKStages = 3;", 1),
                   # past 227 KB at hd 192 and up: those fail to launch
                   ("  static_assert(fa::Smem<HD, DV>::kBytes <= "
                    "fa::kMaxSmem, \"shared memory\");\n", "", 1)],
            "overlapped": [("HD <= 192 ? kOverlapped : kJoint;",
                            "kOverlapped;", 1)],
            "q_early": [("    // the last k-tile's P V\n    {\n",
                         "    // the last k-tile's P V\n"
                         "    if (leader) mbar_arrive(&q_empty[qb]);\n    {\n",
                         1),
                        ("        asm volatile(\"cp.async.bulk.wait_group.read "
                         "0;\\n\" ::: \"memory\");\n        mbar_arrive("
                         "&q_empty[qb]);\n", "", 1)] + NO_STORE,
            "regs240": [("setmaxnreg.inc.sync.aligned.u32 232",
                         "setmaxnreg.inc.sync.aligned.u32 240", 1),
                        ("setmaxnreg.dec.sync.aligned.u32 40",
                         "setmaxnreg.dec.sync.aligned.u32 24", 1)],
            "drop_tile": [("      const int k0 = (j0 + j) * BK;\n",
                           "      if (q0 + BQ >= Sq && j == n - 2)\n"
                           "        for (int c = 0; c < BK / 2; ++c) "
                           "s[c] = -INFINITY;\n"
                           "      const int k0 = (j0 + j) * BK;\n", 1)]}


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
    ap.add_argument("--hd", type=int, default=128)
    ap.add_argument("--variants", default=",".join(VARIANTS))
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
    hd = args.hd
    names = args.variants.split(",")
    # the instantiation a width runs (288 on the 320-wide one)
    inst = f"wgmma_kernelILi{320 if hd == 288 else hd}E"
    out_dir = ROOT / "build/variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        src = out_dir / f"flash_{name}.cu"
        src.write_text(_edit(text, VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out_dir / f"flash_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spills = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Potential Performance Loss" in ln:
                print(f"[variants] {name}: {ln.strip()}")
            if "Function properties" in ln and inst in ln:
                spills.setdefault(name, []).append(lines[i + 1].strip())
        print(f"[variants] {name} ptxas: {spills.get(name)}")
    card = cs.card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(1)
    one = 2 * B * S * (H + KH) * hd * 2
    sets = [tuple(torch.randn(B, S, h, hd, generator=g, device=dev)
                  .to(torch.bfloat16) for h in (H, KH, KH))
            for _ in range(cs.copies_for(one))]
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    from repro_torch.kernels import ref
    plain = ref.flash_attention_plain(*sets[0], causal=True).float()
    rows, errs, rel = {}, {}, {}
    for name in names:
        fn = ctypes.CDLL(str(out_dir / f"flash_{name}.so")
                         ).flash_attention_launch
        fn.argtypes = [vp] * 6 + [i] * 9 + [f, f, i, i, vp]
        fn.restype = i

        def call(q, k, v, fn=fn, name=name):
            out = torch.empty_like(q)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), None, None, B, S, S, H, KH, hd,
                           hd, 1, 0, 0.0, hd ** -0.5, 1, 0,
                           build.cuda_stream(q)), name)
            return out
        rows[name] = cs.graph_ms(call, sets, 50)
        if name not in GARBAGE:
            q, k, v = sets[0]
            out = call(q, k, v).float()
            errs[name] = (out - plain).abs().max().item()
            rel[name] = cs.row_rel_err(out, plain)
        print(f"[variants] {name}: {rows[name]:.4f} ms; against the plain "
              f"version max |err| {errs.get(name, 'not computed')}, "
              f"max_row_rel_err {rel.get(name, 'not computed')}",
              flush=True)
    lib_sets = [(q.transpose(1, 2).contiguous(),
                 k.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous(),
                 v.repeat_interleave(H // KH, 2).transpose(1, 2).contiguous())
                for q, k, v in sets]
    rows["sdpa"] = cs.graph_ms(
        lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), lib_sets, 50)
    print(f"[variants] sdpa: {rows['sdpa']:.4f} ms", flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "shape": [B, S, H, KH, hd], "ms": rows, "max_abs_err": errs,
              "max_row_rel_err": rel,
              "ptxas": spills}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
