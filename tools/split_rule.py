"""The decode template's split plan by capacity against the plan by sweep
bound, timed at the serve shapes on one card.

  python3 tools/split_rule.py [--json FILE]

``kernels/decode_attention.py::split_plan`` sizes a split from the
cache's capacity (rule "capacity": the split size that gives about two
blocks per SM when the whole capacity is swept), so that a wider sweep
bound only adds empty splits and changes no bit.  The plan it replaces
sized the split from the sweep bound itself (rule "bound"), which packs
short sweeps into more, shorter splits.  Also timed: the capacity rule
aiming at four blocks per SM ("capacity4", half the split size).

Layouts (bf16, hd 128, G 4): pt-6b-d4's paged cache (8 tracks x 8 slots,
1 KV head, block 16) at capacities 592, 1104 and 4096; dense-6b's paged
cache (8 slots x 8 KV heads) at the same; dense-6b's contiguous cache at
584, 1096 and 4096; the speculative drafter's contiguous cache (4 tracks
x 8 slots folded, 1 KV head) at 584, 1096 and 4096.  For each sweep
bound from 64 to the capacity (every row's live length within 15 tokens
below it), each rule's kernel time as device work (100 calls replayed
from a CUDA graph, inputs cycled past the L2), the rules in turns.
Needs one CUDA GPU.  Prints the card line, one line per shape and one
JSON object: the grid and, per rule, the mean and worst time against
the bound rule's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = {   # name: (paged, tracks, slots, KV heads, capacities)
    "pt_paged": (True, 8, 8, 1, (592, 1104, 4096)),
    "dense_paged": (True, 1, 8, 8, (592, 1104, 4096)),
    "dense_contig": (False, 1, 8, 8, (584, 1096, 4096)),
    "draft_contig": (False, 4, 8, 1, (584, 1096, 4096))}
G, HD, BS = 4, 128, 16
RULES = ("bound", "capacity", "capacity4")


def _plan_rule(da, plan, rule: str):
    """A ``split_plan`` that follows ``rule``, from the module's own
    ``plan``."""

    def planned(sweep, base, page=None, sms=da.H100_SMS, capacity=None):
        if rule == "bound":
            return plan(sweep, base, page, sms)
        if rule == "capacity4":
            keep, da._BLOCKS_PER_SM = da._BLOCKS_PER_SM, 4
            try:
                return plan(sweep, base, page, sms, capacity)
            finally:
                da._BLOCKS_PER_SM = keep
        return plan(sweep, base, page, sms, capacity)

    return planned


def _shape(dev, g, layout: str, capacity: int, sweep: int):
    """The call (a closure over cycled input sets) at one sweep bound."""
    import chip_smoke as cs
    from repro_torch.kernels import ops
    paged, n, B, KH, caps = LAYOUTS[layout]
    bf = torch.bfloat16
    lengths = (sweep - torch.randint(0, 16, (n * B if not paged else B,),
                                     generator=torch.Generator()
                                     .manual_seed(sweep))).clamp(min=1)
    lengths = lengths.to(torch.int32).to(dev)
    if paged:
        nmax = capacity // BS
        N = B * nmax + 1
        table = (torch.randperm(N - 1, generator=torch.Generator()
                                .manual_seed(capacity))[:B * nmax]
                 .reshape(B, nmax) + 1).to(torch.int32).to(dev)
        shape, qshape = (n, N, BS, KH, HD), (n, B, KH * G, HD)
    else:
        shape, qshape = (n * B, capacity, KH, HD), (n * B, KH * G, HD)
    one = 2 * int(np.prod(shape)) * 2
    sets = [tuple(torch.randn(s, generator=g, device=dev).to(bf)
                  for s in (qshape, shape, shape))
            for _ in range(min(20, cs.copies_for(one)))]
    if paged:
        def call(q, k, v):
            return ops.paged_decode_attention(q, k, v, table, lengths,
                                              max_len=sweep)
    else:
        def call(q, k, v):
            return ops.decode_attention(q, k, v, lengths, max_len=sweep)
    return call, sets, (n * B * KH, BS if paged else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_rule: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    plan = da.split_plan
    grid = []
    try:
        for layout, (paged, n, B, KH, caps) in LAYOUTS.items():
            for cap in caps:
                for sweep in sorted({s for s in (64, 128, 256, 512, 1024,
                                                 2048, cap) if s <= cap}):
                    call, sets, (base, page) = _shape(dev, g, layout, cap,
                                                      sweep)
                    swept = (da._sweep_blocks(cap // BS, BS, sweep) * BS
                             if paged else da._sweep_cols(cap, 512, sweep))
                    row = {"layout": layout, "capacity": cap,
                           "sweep": sweep, "base": base, "ms": {},
                           "plan": {}}
                    for rule in RULES + RULES[::-1]:     # in turns
                        da.split_plan = _plan_rule(da, plan, rule)
                        ms = cs.graph_ms(call, sets, 100)
                        row["ms"].setdefault(rule, []).append(ms)
                        row["plan"][rule] = da.split_plan(
                            swept, base, page, sms, cap)
                    da.split_plan = plan
                    row["ms"] = {k: float(np.mean(v))
                                 for k, v in row["ms"].items()}
                    grid.append(row)
                    print(f"[split] {layout} capacity {cap} sweep {sweep}: "
                          + ", ".join(f"{r} {row['ms'][r]:.4f} ms "
                                      f"{row['plan'][r]}" for r in RULES),
                          flush=True)
                    del sets
                    torch.cuda.empty_cache()
    finally:
        da.split_plan = plan
    rules = {}
    for rule in RULES:
        ratio = [r["ms"][rule] / r["ms"]["bound"] for r in grid]
        worst = int(np.argmax(ratio))
        rules[rule] = {"mean_vs_bound": float(np.mean(ratio)),
                       "worst_vs_bound": ratio[worst],
                       "worst_at": {k: grid[worst][k] for k in
                                    ("layout", "capacity", "sweep")}}
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "sms": sms, "grid": grid, "rules": rules}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps({"rules": rules}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
