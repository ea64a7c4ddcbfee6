"""PT served on track ranks over ``torch.distributed`` (gloo, CPU) against
one process of the port and against the JAX package.

One JAX ``init_pt`` tree of ``reduced_pt(2)`` (4 tracks, 8 layers, D = 2,
so R = 4 track blocks; fp32) is carried to every rank by
``from_jax_params`` + ``shard_tracks``.  Two spawned runs, W = 2 and
W = 4 ranks, each with its own join timeout, run:

  * the model functions: ``pt_forward`` prefill, paged and contiguous
    ``pt_decode_step``, ``pt_chunk_step`` as the (K+1)-token verify,
    ``pt_draft_step`` on the replicated drafter, and int8 weights + int8
    KV prefill and paged decode;
  * ``Engine(par=...).generate``: greedy whole-prompt, chunk 8,
    contiguous, int8 weights + KV and ``speculate_k=2, draft_tracks=2``,
    and a batch with one sampled request.

Gates: logits equal to the one-process port's (``RANK_TOL``: bitwise, as
the gathered fusion sums the tracks in one process's order and a CPU
batched GEMM computes each track alone); every rank bitwise equal to the
others; greedy streams identical to one process's and to the JAX
engine's; exactly R collectives per forward, decode and verify and none
per draft step, by the port's counter and by a wrapper on the
``torch.distributed`` functions; each rank's parameter bytes its share
of the blocks plus the replicated leaves.  The reference's own compiled
programs (``repro.common.compat.make_mesh`` over 8 host devices, in a
subprocess) give the count per track block that the port's per-step
count must equal times R.

The rank processes import this module to find ``_rank``: JAX and the
JAX package are imported inside the fixtures that use them, so that
each rank starts with torch and the port alone.
"""
import collections
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.common.quant import quantize_params
from repro_torch.configs.pt_paper import reduced_pt
from repro_torch.core import track
from repro_torch.kernels.rmsnorm import fuse_rmsnorm, fuse_rmsnorm_plain
from repro_torch.launch.steps import model_fns
from repro_torch.runtime.parallel import NO_PARALLEL, Parallelism, spawn
from repro_torch.serving.cache import PagedKVCache, insert_rows
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleParams
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
RANK_TOL = 0.0          # rank logits vs one process: bitwise
JOIN_TIMEOUT = 240.0    # seconds, for each spawned run
B, S, CAP, BLOCK, K = 2, 8, 16, 4, 2
PROMPTS = [[5, 9, 2, 7, 1], [3, 1, 4, 1, 5, 9, 2, 6, 5], [8] * 12]
NEW = 6
ENGINE = dict(max_slots=4, max_seq_len=32, block_size=4, min_bucket=8)
ENGINE_ARMS = {"whole": {}, "chunk8": {"prefill_chunk": 8},
               "contiguous": {"paged": False},
               "int8": {"weight_dtype": "int8", "kv_dtype": "int8"},
               "spec": {"speculate_k": 2, "draft_tracks": 2},
               "sampled": {}}
GREEDY_ARMS = ("whole", "chunk8", "contiguous", "spec")
# every collective of torch.distributed a port could call
COLLECTIVES = ("all_gather_single", "all_gather_into_tensor", "all_gather",
               "all_reduce", "broadcast", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "gather", "scatter", "barrier", "send", "recv", "isend",
               "irecv", "batch_isend_irecv", "all_gather_object",
               "broadcast_object_list")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# what every rank (and one process) runs
# ---------------------------------------------------------------------------

def _count_dist_calls() -> collections.Counter:
    """Wrap every collective of ``torch.distributed`` (both namespaces)
    with a counter, independent of the port's own; a call made inside
    another wrapped call counts once."""
    calls = collections.Counter()
    depth = [0]

    def wrap(fn, name):
        def counted(*args, **kwargs):
            if depth[0] == 0:
                calls[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return counted

    for mod in (dist, dist.distributed_c10d):
        for name in COLLECTIVES:
            if hasattr(mod, name):
                setattr(mod, name, wrap(getattr(mod, name), name))
    return calls


def _storage_bytes(tree) -> int:
    seen = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif hasattr(t, "payload"):
            walk(t.payload)
            walk(t.scale)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    walk(tree)
    return sum(seen.values())


def _model_arms(par: Parallelism, tree, calls) -> dict:
    """Prefill, paged and contiguous decode, the verify, the drafter and
    int8 weights + KV on the model functions: {arm: [logits]} and
    {arm: [(port's count, wrapper's count) per call]}."""
    cfg = reduced_pt(2)
    full = from_jax_params(tree, cfg, "cpu")
    p = track.shard_tracks(full, cfg, par)
    fns = model_fns(cfg, par)
    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    logits, counts = collections.defaultdict(list), \
        collections.defaultdict(list)

    def run(arm, fn, *args, **kwargs):
        c0, w0 = par.counts.collectives, sum(calls.values())
        lg, cache = fn(*args, **kwargs)
        counts[arm].append((par.counts.collectives - c0,
                            sum(calls.values()) - w0))
        if lg is not None:
            logits[arm].append(lg.numpy().copy())
        return cache

    def toks(*shape):
        return torch.from_numpy(rng.integers(1, V, shape))

    prompt = toks(B, S)
    pre = run("prefill", fns["forward"], p, {"inputs": prompt}, cfg)
    slots = list(range(B))
    kv = PagedKVCache(cfg, max_slots=B, max_seq_len=CAP, block_size=BLOCK,
                      device="cpu", par=par)
    for s in slots:
        kv.allocate(s, CAP)
    kv.insert_prefill(pre, slots, kv.table_rows(slots))
    contig = fns["init_cache"](cfg, B, CAP, "cpu")
    insert_rows(contig, pre, slots)
    for step in range(2):
        tok, pos = toks(B), torch.full((B,), S + step, dtype=torch.int32)
        run("paged_decode", fns["decode"], p, kv.engine_cache(), tok, pos,
            cfg, block_table=kv.table())
        run("contiguous_decode", fns["decode"], p, contig, tok, pos, cfg)
    run("verify", fns["chunk"], p, kv.engine_cache(), toks(B, K + 1),
        torch.full((B,), S + 2, dtype=torch.int32), cfg,
        block_table=kv.table(), kv_max_len=CAP)
    # the drafter: tracks [0, 2) replicated, its cache filled by the
    # draft prefill, then two draft steps
    dcfg = track.pt_draft_config(cfg, 2)
    dp = track.pt_draft_params(full, cfg, 2)
    _, dpre = track.pt_forward(dp, {"inputs": prompt}, dcfg, head=False,
                               par=par.without_axis("track"))
    dcache = track.pt_init_cache(dcfg, B, CAP, "cpu")
    insert_rows(dcache, dpre, slots)
    for step in range(2):
        run("draft", track.pt_draft_step, dp, dcache, toks(B),
            torch.full((B,), S + step, dtype=torch.int32), dcfg, par=par)
    # int8 weights (quantized after the shard) and int8 KV
    q, _ = quantize_params(p)
    pre8 = run("int8_prefill", fns["forward"], q, {"inputs": prompt}, cfg)
    kv8 = PagedKVCache(cfg, max_slots=B, max_seq_len=CAP, block_size=BLOCK,
                       kv_dtype="int8", device="cpu", par=par)
    for s in slots:
        kv8.allocate(s, CAP)
    kv8.insert_prefill(pre8, slots, kv8.table_rows(slots))
    for step in range(2):
        run("int8_decode", fns["decode"], q, kv8.engine_cache(), toks(B),
            torch.full((B,), S + step, dtype=torch.int32), cfg,
            block_table=kv8.table())
    blocks = _storage_bytes(full["blocks"])
    replicated = _storage_bytes({k: v for k, v in full.items()
                                 if k != "blocks"})
    return {"logits": dict(logits), "counts": dict(counts),
            "param_bytes": _storage_bytes(p),
            "want_bytes": blocks // par.world + replicated,
            "kv_tracks": kv.data[0].shape[2]}


def _engine_arms(par: Parallelism, tree, calls) -> dict:
    """Each engine arm's streams, its collectives (port's counter and the
    wrapper's) and the device calls that should make them: R per
    prefill, chunk and decode or spec step."""
    cfg = reduced_pt(2)
    full = from_jax_params(tree, cfg, "cpu")
    out = {}
    for arm, knobs in ENGINE_ARMS.items():
        c0, w0, a0 = (par.counts.collectives, sum(calls.values()),
                      par.counts.local_adds)
        eng = Engine(cfg, full, device="cpu", par=par, **ENGINE, **knobs)
        if arm == "sampled":
            reqs = [eng.submit(PROMPTS[0], NEW),
                    eng.submit(PROMPTS[1], NEW,
                               params=SampleParams(0.8, 20, 0.9), seed=7)]
            eng.run()
            streams = [r.output for r in reqs]
        else:
            streams = eng.generate(PROMPTS, NEW)
        r = eng.runner
        out[arm] = {"streams": streams,
                    "collectives": par.counts.collectives - c0,
                    "wrapped": sum(calls.values()) - w0,
                    "adds": par.counts.local_adds - a0,
                    "calls": r.prefill_calls + r.chunk_calls
                    + r.decode_transfers,
                    "spec_steps": eng.metrics.summary().get("spec_steps", 0),
                    "param_bytes": _storage_bytes(r.params),
                    "kinds": sorted(calls)}
    return out


def _rank(par: Parallelism, tree) -> dict:
    torch.set_num_threads(1)
    calls = _count_dist_calls()
    return {"rank": par.rank, "model": _model_arms(par, tree, calls),
            "engine": _engine_arms(par, tree, calls)}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

_REFERENCE_PROGRAMS = textwrap.dedent(r"""
    import json, re
    import jax, jax.numpy as jnp
    from repro.common.compat import make_mesh
    from repro.common.paged import wrap_paged
    from repro.configs import pt_paper
    from repro.core import track as pt_lib
    from repro.launch import steps as S
    from repro.runtime import sharding as sh
    from repro.serving.cache import PagedKVCache

    cfg = pt_paper.reduced_pt(2).replace(remat=False)   # 8 layers, D = 2
    mesh = make_mesh((2, cfg.pt.n_tracks), ('data', 'track'))
    par = S.build_parallelism(cfg, 'decode', mesh)
    fns = S.model_fns(cfg)
    ps = jax.eval_shape(lambda: fns['init'](jax.random.PRNGKey(0), cfg))
    psh = sh.param_shardings(ps, cfg, par)
    B, SL, K = 8, 32, 3
    kv = PagedKVCache(fns['init_cache'], cfg, max_slots=B, max_seq_len=SL,
                      block_size=8)
    for s in range(B):
        kv.allocate(s, 16)
    cache = jax.eval_shape(lambda: wrap_paged(kv.data, kv.pageable))
    tok = jax.ShapeDtypeStruct((B,), jnp.int32)
    seq = jax.ShapeDtypeStruct((B, K + 1), jnp.int32)
    pos = jax.ShapeDtypeStruct((B,), jnp.int32)
    tbl = jax.ShapeDtypeStruct(kv.table_np.shape, jnp.int32)

    def decode(p, c, t, q, tb):
        return fns['decode'](p, c, t, q, cfg, par, block_table=tb)

    draft, dcfg = S.make_draft_step(cfg, par, draft_tracks=2)
    dps = jax.eval_shape(lambda: pt_lib.pt_draft_params(
        pt_lib.init_pt(jax.random.PRNGKey(0), cfg), cfg, 2))
    dcache = jax.eval_shape(lambda: pt_lib.pt_init_cache(dcfg, B, SL))
    txts = {
        'decode': jax.jit(decode, in_shardings=(psh, None, None, None, None))
        .lower(ps, cache, tok, pos, tbl).compile().as_text(),
        'verify': jax.jit(S.make_verify_step(cfg, par),
                          in_shardings=(psh, None, None, None, None))
        .lower(ps, cache, seq, pos, tbl).compile().as_text(),
        'draft': jax.jit(draft).lower(dps, dcache, tok, pos).compile()
        .as_text()}

    # tests/test_multidevice.py's own counting: the HLO split into named
    # computations, all-reduces counted in each while body
    ar = re.compile(r'=\s*\S+\s+all-reduce(?:-start)?\(')
    out = {'n_tracks': cfg.pt.n_tracks,
           'n_blocks': cfg.n_layers // cfg.pt.block_depth}
    for name, txt in txts.items():
        comps, cur = {}, None
        for line in txt.splitlines():
            if line and not line[0].isspace() and '{' in line:
                m = re.match(r'(?:ENTRY\s+)?%?([\w\.\-]+)', line.strip())
                cur = m.group(1) if m else None
                comps[cur] = []
            elif cur is not None:
                comps[cur].append(line)
        bodies = set(re.findall(r'body=%?([\w\.\-]+)', txt))
        per_body = {b: sum(1 for l in comps.get(b, ()) if ar.search(l))
                    for b in bodies}
        sizes = []
        for b in bodies:
            for l in comps.get(b, ()):
                if ar.search(l):
                    g = re.search(r'replica_groups=\{\{([\d,]+)\}', l)
                    if g:
                        sizes.append(len(g.group(1).split(',')))
                    g = re.search(r'replica_groups=\[\d+,(\d+)\]<=', l)
                    if g:
                        sizes.append(int(g.group(1)))
        out[name] = {'per_body': sorted(per_body.values()),
                     'group_sizes': sizes,
                     'all_reduces': sum(1 for l in txt.splitlines()
                                        if ar.search(l))}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_counts():
    """The all-reduces of the reference's compiled decode, verify and
    draft programs over a (data 2, track 4) mesh of 8 host devices,
    built in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_PROGRAMS],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tree():
    """The JAX ``init_pt`` tree of reduced_pt(2), numpy leaves."""
    import jax
    from repro.configs import pt_paper as j_pt_paper
    from repro.core import track as jtrack
    jcfg = j_pt_paper.reduced_pt(2)
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def single(tree):
    """The one-process port on the same tree."""
    return {"model": _model_arms(NO_PARALLEL, tree, collections.Counter()),
            "engine": _engine_arms(NO_PARALLEL, tree, collections.Counter())}


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def ranks(request, tree):
    """One spawned run of W ranks: each rank's results, by rank."""
    return request.param, spawn(_rank, request.param, (tree,),
                                timeout=JOIN_TIMEOUT)


@pytest.fixture(scope="module")
def jax_streams(tree):
    """The JAX engine's greedy streams on the same tree."""
    import jax
    from repro.configs import pt_paper as j_pt_paper
    from repro.serving.engine import Engine as JEngine
    eng = JEngine(j_pt_paper.reduced_pt(2), jax.tree_util.tree_map(
        jax.numpy.asarray, tree), prefix_cache=False, **ENGINE)
    return eng.generate(PROMPTS, max_new_tokens=NEW)


# ---------------------------------------------------------------------------
# the fused norm under a rank's scale rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("final", [False, True])
def test_fuse_rmsnorm_plain_takes_a_ranks_scale_rows(dtype, final):
    """k < n scale rows: y is the k rows of the n-row result, f the same,
    bitwise; with delta None over x + delta added first (a rank's
    gathered rows), the same bits again."""
    g = torch.Generator().manual_seed(0)
    n, d = 8, 32
    x = torch.randn(n, 3, 1, d, generator=g).to(dtype)
    delta = torch.randn(n, 3, 1, d, generator=g).to(dtype)
    scale = torch.randn((d,) if final else (n, d), generator=g) * 0.1
    f, y = fuse_rmsnorm_plain(x, delta, scale)
    assert y.shape == ((3, 1, d) if final else (n, 3, 1, d))
    for a, b in ((0, 4), (4, 8), (2, 3)):
        s = scale if final else scale[a:b]
        for got in (fuse_rmsnorm(x, delta, s),
                    fuse_rmsnorm(x + delta, None, s)):
            assert torch.equal(got[0], f)
            assert torch.equal(got[1], y if final else y[a:b])
    for bad in (torch.zeros(n + 1, d), torch.zeros(0, d),
                torch.zeros(2, d + 1)):
        with pytest.raises(ValueError, match="scale"):
            fuse_rmsnorm(x, delta, bad)


# ---------------------------------------------------------------------------
# shards, refusals
# ---------------------------------------------------------------------------

def test_shard_tracks_keeps_copies_of_a_ranks_tracks(tree):
    cfg = reduced_pt(2)
    full = from_jax_params(tree, cfg, "cpu")
    par = Parallelism(group="stand-in", rank=1, world=2)
    assert par.track_range(cfg) == (2, 4) and par.local_tracks(cfg) == 2
    mine = track.shard_tracks(full, cfg, par)
    wq, fwq = mine["blocks"]["mixer"]["wq"], full["blocks"]["mixer"]["wq"]
    assert torch.equal(wq, fwq[:, :, 2:4])
    assert wq.untyped_storage().data_ptr() != \
        fwq.untyped_storage().data_ptr()
    assert mine["embed"] is full["embed"] and mine["head"] is full["head"]
    assert track.shard_tracks(full, cfg, NO_PARALLEL) is full
    with pytest.raises(ValueError, match="full tree"):      # a share
        track.shard_tracks(mine, cfg, par)
    # int8: the share of the quantized tree is the quantized share
    q = track.shard_tracks(quantize_params(full)[0], cfg, par)
    q2 = quantize_params(mine)[0]
    for a, b in ((q["blocks"]["mlp"]["wo"], q2["blocks"]["mlp"]["wo"]),):
        assert torch.equal(a.payload, b.payload)
        assert torch.equal(a.scale, b.scale)
    three = Parallelism(group="stand-in", rank=0, world=3)
    with pytest.raises(ValueError, match="divide"):
        track.shard_tracks(full, cfg, three)
    with pytest.raises(ValueError, match="tracks"):
        track.pt_decode_step(full, {"blocks": (None, None)},
                             torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, dtype=torch.int32), cfg, par=par)


@pytest.mark.parametrize("paged", [True, False], ids=["paged",
                                                      "contiguous"])
def test_rank_decode_plans_its_split_for_all_tracks(tree, monkeypatch,
                                                    paged):
    """A decode layer over a rank's n/W tracks asks the decode kernel for
    the split plan of all n (``plan_scale`` W), so that on the card each
    rank sums attention as one process's launch does; one process and
    the drafter (its d tracks all local) plan for their own; a track
    count that is no share of n is refused."""
    from repro_torch.common.paged import PagedLeaf
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    cfg = reduced_pt(2)
    full = from_jax_params(tree, cfg, "cpu")
    asked = []
    name = "paged_decode_attention" if paged else "decode_attention"
    kernel = getattr(ops, name)

    def spy(*args, **kwargs):
        asked.append(kwargs["plan_scale"])
        return kernel(*args, **kwargs)

    monkeypatch.setattr(ops, name, spy)
    g = torch.Generator().manual_seed(0)
    KH, hd, N = cfg.n_kv_heads, cfg.head_dim, B * CAP // BLOCK + 1
    table = torch.arange(1, N, dtype=torch.int32).reshape(B, -1)
    pos = torch.tensor([3, 9], dtype=torch.int32)

    def decode(c, lp, tracks):
        x = torch.randn(tracks, B, 1, cfg.d_model, generator=g)
        shape = ((tracks, N, BLOCK, KH, hd) if paged
                 else (tracks, B, CAP, KH, hd))
        k, v = (torch.randn(shape, generator=g) for _ in range(2))
        cache = (PagedLeaf(k), PagedLeaf(v)) if paged else (k, v)
        attention.attention_decode(lp, x, cache, spec=c.spec("full"),
                                   cfg=c, pos=pos, block_table=table)

    for W in (1, 2, 4):
        share = track.shard_tracks(full, cfg, Parallelism(
            "stand-in", W - 1, W) if W > 1 else NO_PARALLEL)
        decode(cfg, track._layer(share["blocks"], 0, 0)["mixer"], 4 // W)
    dcfg = track.pt_draft_config(cfg, 2)
    decode(dcfg, track._layer(track.pt_draft_params(full, cfg, 2)["blocks"],
                              0, 0)["mixer"], 2)
    assert asked == [1, 2, 4, 1]
    lp = track._layer(track.pt_draft_params(full, cfg, 3)["blocks"], 0, 0)
    with pytest.raises(ValueError, match="share"):
        decode(cfg, lp["mixer"], 3)


def test_ranks_refuse_what_they_cannot_serve(tree):
    cfg = reduced_pt(2)
    full = from_jax_params(tree, cfg, "cpu")
    par = Parallelism(group="stand-in", rank=0, world=2)
    for knobs in ({"pipeline_depth": 1}, {"preplan": True}):
        with pytest.raises(NotImplementedError, match="item 7b"):
            Engine(cfg, full, device="cpu", par=par, **ENGINE, **knobs)
    with pytest.raises(ValueError, match="no tracks"):
        model_fns(reduced_pt(2).replace(pt=None), par)
    with pytest.raises(ValueError, match="track group"):
        NO_PARALLEL.gather_tracks(torch.zeros(1))
    with pytest.raises(ValueError, match="axis"):
        par.without_axis("data")
    # a rank's share: the runner cuts its share, and the drafter's
    # copies, from the full tree only
    mine = track.shard_tracks(full, cfg, Parallelism("stand-in", 1, 2))
    with pytest.raises(ValueError, match="full tree"):
        Engine(cfg, mine, device="cpu", par=Parallelism("stand-in", 1, 2),
               speculate_k=2, draft_tracks=2, **ENGINE)


# ---------------------------------------------------------------------------
# W ranks against one process
# ---------------------------------------------------------------------------

def test_rank_logits_equal_one_process(ranks, single):
    W, res = ranks
    want = single["model"]["logits"]
    for r in res:
        got = r["model"]["logits"]
        assert set(got) == set(want)
        for arm, calls in want.items():
            assert len(got[arm]) == len(calls), arm
            for a, b in zip(got[arm], calls):
                np.testing.assert_allclose(a, b, rtol=RANK_TOL,
                                           atol=RANK_TOL, err_msg=arm)


def test_ranks_bitwise_equal_to_each_other(ranks):
    W, res = ranks
    assert [r["rank"] for r in res] == list(range(W))
    for r in res[1:]:
        for arm, calls in res[0]["model"]["logits"].items():
            for a, b in zip(r["model"]["logits"][arm], calls):
                assert np.array_equal(a, b), arm
        for arm, e in res[0]["engine"].items():
            assert r["engine"][arm]["streams"] == e["streams"], arm


def test_collectives_one_per_track_block_none_in_the_draft(ranks, single):
    W, res = ranks
    cfg = reduced_pt(2)
    R = track.pt_sync_points(cfg.n_layers, cfg.pt.block_depth)
    assert R == 4
    gather = ("all_gather_single" if hasattr(dist, "all_gather_single")
              else "all_gather_into_tensor")
    for r in res:
        for arm, per_call in r["model"]["counts"].items():
            want = 0 if arm == "draft" else R
            assert per_call == [(want, want)] * len(per_call), arm
        for arm, e in r["engine"].items():
            n = R * e["calls"]
            assert e["collectives"] == e["wrapped"] == e["adds"] == n, arm
        assert r["engine"]["spec"]["spec_steps"] > 0
        # the gather, and no other collective
        assert r["engine"]["whole"]["kinds"] == [gather]
    # one process: no collective at all
    for arm, per_call in single["model"]["counts"].items():
        assert per_call == [(0, 0)] * len(per_call), arm
    assert all(e["collectives"] == 0 for e in single["engine"].values())


def test_rank_holds_its_share_of_the_blocks(ranks, single):
    W, res = ranks
    cfg = reduced_pt(2)
    for r in res:
        m = r["model"]
        assert m["param_bytes"] == m["want_bytes"]
        assert m["kv_tracks"] == cfg.pt.n_tracks // W
        assert r["engine"]["whole"]["param_bytes"] == m["want_bytes"]
    assert single["model"]["kv_tracks"] == cfg.pt.n_tracks


def test_rank_streams_equal_one_process_and_the_jax_engine(ranks, single,
                                                           jax_streams):
    W, res = ranks
    one = single["engine"]
    assert one["whole"]["streams"] == jax_streams
    for arm in GREEDY_ARMS:
        assert one[arm]["streams"] == jax_streams, arm
    for r in res:
        for arm, e in r["engine"].items():
            assert e["streams"] == one[arm]["streams"], arm
        for arm in GREEDY_ARMS:
            assert r["engine"][arm]["streams"] == jax_streams, arm
    assert [len(s) for s in one["sampled"]["streams"]] == [NEW, NEW]


def test_port_count_equals_the_reference_compiled_count(reference_counts,
                                                        ranks):
    """The reference's decode and verify programs carry one cross-track
    all-reduce per track-block scan body (group size n), its draft
    program none; the port's per-step count is that times R."""
    W, res = ranks
    ref = reference_counts
    R = ref["n_blocks"]
    for prog in ("decode", "verify"):
        pb = ref[prog]["per_body"]
        assert pb.count(1) == 1 and max(pb) == 1, (prog, ref)
        assert ref[prog]["group_sizes"] == [ref["n_tracks"]], (prog, ref)
    assert ref["draft"]["all_reduces"] == 0, ref
    for r in res:
        counts = r["model"]["counts"]
        for arm, prog in (("paged_decode", "decode"),
                          ("contiguous_decode", "decode"),
                          ("int8_decode", "decode"), ("verify", "verify")):
            assert {c for c, _ in counts[arm]} == {max(ref[prog]["per_body"])
                                                   * R}, arm
        assert {c for c, _ in counts["draft"]} == \
            {ref["draft"]["all_reduces"]}
