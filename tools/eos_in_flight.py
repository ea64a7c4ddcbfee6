"""An EOS that fires on the longest lane while a step is in flight: the
pipelined engine's streams and logits against the sync engine's, on one
card.

  python3 tools/eos_in_flight.py [--json FILE]

pt-6b-d4 at full width, bf16, seeded random weights, 8 slots, block 16,
64 new tokens: lane 0 gets a 520-token prompt and lanes 1-7 400-token
prompts, so lane 0 alone sets the decode kernels' sweep bound: 592
positions (the serve cell's capacity of 584) or 1024 (a capacity of
1096) against 512 for the others.  The decode kernels size their splits
from the cache's capacity (``split_plan``: 128 tokens at capacity 584,
256 at 1096), so a wider bound only adds splits that hold no live token
of the other lanes.  For each capacity: a sync run
without EOS picks the EOS token: the first token of lane 0's stream,
from its 8th on, that no other stream and no earlier token of its own
holds.  Then the same prompts with that EOS, by the sync engine and by
``Engine(pipeline_depth=1, preplan=True)``: the pipelined engine has
dispatched the step after the EOS before it reads the EOS, so that step
still counts lane 0 and takes the wider bound, where the sync step takes
the narrower one (more splits of the decode kernels).  Every
decode step's logits are kept per request (a device copy taken right
after the step, before the next one runs).  The same pair again without
the EOS is the control: the bounds then agree at every step.  Reported
for each pair: each run's bounds by step, streams equal or not, per
request the max |logit difference| over its steps, whether they are
bitwise equal, the first step and token that differ.  Needs one CUDA
GPU.
Prints the card line and one JSON list, a case per capacity.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LONG, SHORT = 520, 400
CAPACITY = 1096                 # lane 0's bound 1024 positions


def _recorded(eng, store):
    """Wrap the runner's decode dispatch: each step's bound key and, per
    request on an active lane, a copy of its logits row."""
    r = eng.runner
    inner = r.dispatch_decode

    def dispatch(toks, pos, active, *a, **k):
        h = inner(toks, pos, active, *a, **k)
        logits = h["logits"].float().clone()
        lanes = {s: q.rid for s, q in eng.scheduler.active_slots()}
        store["keys"].append(h["key"])
        for s in np.flatnonzero(np.asarray(active, bool)):
            store["rows"].setdefault(lanes[int(s)], []).append(logits[s])
        return h

    r.dispatch_decode = dispatch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eos_in_flight: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.track import init_pt
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    cfg = get_config(cs.ARCH)
    params = init_pt(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=(LONG if i == 0
                                                     else SHORT,)).tolist()
               for i in range(cs.SLOTS)]
    results = [_case(cfg, params, prompts, cap, dev)
               for cap in (cs.PROMPT + cs.NEW + 8, CAPACITY)]
    for r in results:
        r.update(card=card, device=torch.cuda.get_device_name(0))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1))
    print(card)
    print(json.dumps([{k: ({kk: vv for kk, vv in v.items()
                            if not kk.startswith("keys_")}
                           if isinstance(v, dict) and "requests" in v
                           else v) for k, v in r.items()}
                      for r in results]))
    return 0


def _case(cfg, params, prompts, capacity: int, dev):
    import chip_smoke as cs
    from repro_torch.serving.engine import Engine
    kw = dict(max_slots=cs.SLOTS, max_seq_len=capacity,
              block_size=cs.BLOCK, device=dev)
    plain = Engine(cfg, params, **kw).generate(prompts, cs.NEW)
    others = {t for s in plain[1:] for t in s}
    pick = [i for i, t in enumerate(plain[0]) if i >= 8
            and t not in others and t not in plain[0][:i]]
    if not pick:
        raise SystemExit("eos_in_flight: no token of lane 0 is unique to "
                         "it")
    at = pick[0]
    eos = plain[0][at]
    result = {"capacity": capacity, "eos": int(eos),
              "eos_at_output_index": at}
    for case, stop in (("eos", eos), ("no_eos", None)):
        runs = {}
        for name, extra in (("sync", {}), ("planned", dict(
                pipeline_depth=1, preplan=True))):
            eng = Engine(cfg, params, **kw, **extra)
            store = {"keys": [], "rows": {}}
            _recorded(eng, store)
            reqs = [eng.submit(p, cs.NEW, eos_id=stop) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            runs[name] = {"streams": [q.output for q in reqs],
                          "rids": [q.rid for q in reqs],
                          "keys": store["keys"], "rows": store["rows"]}
            del eng
        result[case] = _compare(runs["sync"], runs["planned"],
                                f"capacity {capacity}, "
                                f"{'EOS ' + str(eos) if stop else 'no EOS'}")
    return result


def _compare(a, b, what: str):
    """Per request: the logits of the sync run ``a`` against the planned
    run ``b``, step by step."""
    per_req = []
    for i, (ra, rb) in enumerate(zip(a["rids"], b["rids"])):
        xa, xb = a["rows"][ra], b["rows"][rb]
        k = min(len(xa), len(xb))
        diffs = [(u - v).abs().max().item() for u, v in zip(xa[:k], xb[:k])]
        first = next((j for j, dd in enumerate(diffs) if dd), -1)
        per_req.append({"lane": i, "steps_sync": len(xa),
                        "steps_planned": len(xb), "compared": k,
                        "max_abs_diff": max(diffs) if diffs else 0.0,
                        "bitwise_equal": not any(diffs),
                        "first_differing_step": first,
                        "diff_there": diffs[first] if first >= 0 else 0.0,
                        "stream_equal": a["streams"][i] == b["streams"][i],
                        "first_differing_token": next(
                            (j for j, (u, v) in enumerate(zip(
                                a["streams"][i], b["streams"][i]))
                             if u != v), -1)})
    split = next((j for j, (u, v) in enumerate(zip(a["keys"], b["keys"]))
                  if u != v), -1)
    result = {"lane0_tokens": {"sync": len(a["streams"][0]),
                               "planned": len(b["streams"][0])},
              "keys_sync": [list(k) for k in a["keys"]],
              "keys_planned": [list(k) for k in b["keys"]],
              "first_step_with_other_bound": split,
              "streams_equal": a["streams"] == b["streams"],
              "requests": per_req}
    print(f"[eos] {what}: lane 0 emits "
          f"{result['lane0_tokens']}; first step with another bound: "
          f"{split} (sync {a['keys'][split] if split >= 0 else '-'}, "
          f"planned {b['keys'][split] if split >= 0 else '-'}); streams "
          f"equal: {result['streams_equal']}", flush=True)
    for q in per_req:
        print(f"[eos]   lane {q['lane']}: {q['compared']} steps compared, "
              f"max |logit diff| {q['max_abs_diff']:.3e}, bitwise "
              f"{q['bitwise_equal']} (first differing step "
              f"{q['first_differing_step']}, |diff| {q['diff_there']:.3e}"
              f"), stream equal {q['stream_equal']} (first differing "
              f"token {q['first_differing_token']})", flush=True)
    return result


if __name__ == "__main__":
    sys.exit(main())
