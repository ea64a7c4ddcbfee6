"""The port's pipelined engine and its pre-planned step programs on the
CPU: ``advance_decode`` / ``advance_spec`` bitwise against the
reference's; ``Engine(pipeline_depth=1, 2)``, with and without
``preplan=True``, emitting the sync engine's greedy streams bitwise on
the paged cache, the contiguous cache, chunked prefill, int8 weights +
int8 KV, falcon-mamba's state rows and the speculative arm, with more
requests than slots, staggered lengths and EOS stops that land while a
step is in flight; ``plan_programs`` leaving every live cache byte
unchanged; the static step buffers staying put; the launch counters'
replayed delta; the pipelined metrics; one stream against the JAX
engine's pipelined stream; the serve CLI.

On the CPU a "replay" runs the step program eagerly on the same static
buffers, so these tests exercise the buffers, the carry and the
bookkeeping; the graphs themselves are held against eager steps on the
card (tests/test_torch_gpu.py, chip_smoke.py).  The bitwise equality of
pipelined and sync streams also rests on the plain attention of the CPU
path giving the same bits for any sweep bound that covers the live
rows (a pipelined step may take a larger bound than the sync step at
the same position), which ``test_plain_attention_ignores_a_wider_bound``
holds."""
import functools
import gc
import os
import re
import subprocess
import sys
import time
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.serving import sampler as jsampler
from repro.serving import engine as jengine
from repro_torch.common.paged import PagedLeaf
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    decode_attention_plain, paged_decode_attention_plain)
from repro_torch.launch.steps import StepGraph, model_fns
from repro_torch.models.attention import attention_chunk
from repro_torch.serving import sampler
from repro_torch.serving.cache import _leaves
from repro_torch.serving.engine import Engine, RequestState
from repro_torch.weights import from_jax_params

REPO = Path(__file__).resolve().parents[1]
PT, DENSE, MAMBA = "pt-6b-d4", "dense-6b", "falcon-mamba-7b"
# arm -> (arch, engine knobs); every arm serves 5 requests on 3 slots
ARMS = {"paged": (PT, {}),
        "contiguous": (DENSE, {"paged": False}),
        "chunk4": (PT, {"prefill_chunk": 4}),
        "w8kv8": (PT, {"weight_dtype": "int8", "kv_dtype": "int8"}),
        "mamba": (MAMBA, {"prefill_chunk": 4}),
        "spec": (PT, {"speculate_k": 3, "draft_tracks": 2})}
VARIANTS = [(0, True), (1, False), (2, False), (1, True), (2, True)]
LENS, NEWS = (5, 19, 11, 3, 8), (7, 4, 9, 8, 6)
EOS_AT = {1: 1, 3: 2}      # request -> index of the token that is its EOS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    cfg = reduced_config(arch)
    return cfg, model_fns(cfg)["init"](torch.Generator().manual_seed(0), cfg,
                                       "cpu")


def _engine(arm: str, depth: int = 0, preplan: bool = False) -> Engine:
    arch, knobs = ARMS[arm]
    cfg, params = _params(arch)
    return Engine(cfg, params, max_slots=3, max_seq_len=40, block_size=8,
                  device="cpu", pipeline_depth=depth, preplan=preplan,
                  **knobs)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab_size, size=(n,)).tolist()
            for n in LENS]


def _serve(eng: Engine, eos=None):
    eos = eos or {}
    reqs = [eng.submit(p, m, eos_id=eos.get(i))
            for i, (p, m) in enumerate(zip(_prompts(eng.cfg), NEWS))]
    eng.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    return reqs


@functools.lru_cache(maxsize=None)
def _sync(arm: str):
    """(EOS ids, streams) of the sync engine: request i of EOS_AT stops at
    the token its EOS-free stream emits at EOS_AT[i] (or earlier, where
    that token came before)."""
    probe = [r.output for r in _serve(_engine(arm))]
    eos = {i: probe[i][j] for i, j in EOS_AT.items()}
    return eos, [r.output for r in _serve(_engine(arm), eos)]


def test_advance_matches_reference_bitwise():
    """The device-side carry of both step kinds against the reference's
    functions on the same numpy inputs, every override pattern."""
    rng = np.random.default_rng(0)
    B, K = 6, 3
    i32 = lambda *s: rng.integers(-3, 50, size=s).astype(np.int32)
    ovr = np.asarray([1, 0, 0, 1, 0, 0], bool)
    packed, tok, pos, cnt, rem = i32(2, B), i32(B), i32(B), i32(B), i32(B)
    host = [i32(B) for _ in range(4)]
    want = jsampler.advance_decode(packed, tok, pos, cnt, rem, ovr, *host)
    got = sampler.advance_decode(*map(torch.as_tensor, (
        packed, tok, pos, cnt, rem, ovr, *host)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    spacked = i32(K + 2, B)
    spacked[-1] = [0, 1, 4, 2, 0, 3]                    # counts m in 0..K+1
    want = jsampler.advance_spec(spacked, tok, pos, cnt, ovr, *host[:3])
    got = sampler.advance_spec(*map(torch.as_tensor, (
        spacked, tok, pos, cnt, ovr, *host[:3])))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("depth,preplan", VARIANTS)
@pytest.mark.parametrize("arm", list(ARMS))
def test_pipelined_streams_equal_sync_bitwise(arm, depth, preplan):
    """Every arm, every depth, with and without the planned programs:
    the sync engine's greedy streams, EOS stops landing while the next
    step is in flight included.  A preplanned run replays a program at
    every decode / spec step (one host transfer each), and the static
    step buffers stay where they were."""
    eos, want = _sync(arm)
    eng = _engine(arm, depth, preplan)
    r = eng.runner
    bufs = [t for t in (r.step_in, r.step_table, r.step_out) if t is not None]
    ptrs = [t.data_ptr() for t in bufs]
    reqs = _serve(eng, eos)
    assert [q.output for q in reqs] == want
    for i, j in EOS_AT.items():
        assert reqs[i].output[-1] == eos[i] and len(reqs[i].output) <= j + 1
    assert [t.data_ptr() for t in bufs] == ptrs
    assert r.planned_hits == (r.decode_transfers if preplan else 0)
    assert r.decode_transfers > 0 and not eng._inflight
    if preplan:
        kinds = {k[0] for k in r.programs}
        assert kinds == {"spec" if arm == "spec" else "decode"}
    if r.paged:
        assert r.kv.free_blocks == r.kv.num_blocks - 1
        r.kv.check_invariants()


def _live_bytes(eng: Engine):
    """Every cache byte a request owns: the allocated blocks of each pool
    (block 0 is the trash block, which idle lanes write by design), the
    state rows, the contiguous rows and the drafter's rows."""
    r = eng.runner
    blocks = None
    if r.paged:
        blocks = torch.as_tensor(sorted(set(r.kv.table_np.ravel()) - {0}),
                                 dtype=torch.long)
    out = []
    for leaf, axis in _leaves(r.cache):
        if isinstance(leaf, PagedLeaf):
            for t in (leaf.pool, leaf.scale):
                if t is not None:
                    out.append(t.index_select(axis, blocks).clone())
        else:
            out.append(leaf.clone())
    if r.speculate_k:
        out += [t.clone() for t in r.draft_cache["blocks"]]
    return out


@pytest.mark.parametrize("arm", ["paged", "contiguous", "w8kv8", "mamba",
                                 "spec"])
def test_plan_programs_leaves_live_cache_bytes_unchanged(arm):
    """Planned mid-run, with requests decoding and one mid-chunked-
    prefill: the warm-up steps (all lanes idle) change no live byte, and
    the rest of the run still emits the sync streams."""
    eos, want = _sync(arm)
    eng = _engine(arm)
    reqs = [eng.submit(p, m, eos_id=eos.get(i))
            for i, (p, m) in enumerate(zip(_prompts(eng.cfg), NEWS))]
    for _ in range(3):
        eng.step()
    assert any(q.state is RequestState.DECODE for q in reqs)
    before = _live_bytes(eng)
    assert eng.runner.plan_programs() == len(eng.runner.programs) > 0
    for a, b in zip(before, _live_bytes(eng)):
        assert torch.equal(a, b)
    eng.run()
    assert [q.output for q in reqs] == want


class _NoGraph(StepGraph):
    """A StepGraph whose "graph" records nothing and replays nothing:
    what stays is the counters' bookkeeping."""

    def _record(self):
        return type("G", (), {"replay": lambda self: None})(), self.fn()


def test_step_graph_replays_the_counters_change_of_its_capture(monkeypatch):
    def stub():
        pass

    stub.launches = 5
    monkeypatch.setitem(ops.KERNELS, "stub", stub)
    monkeypatch.setitem(ops.int8_matmul.routes, "mma_m16", 7)
    before = ops.counters()

    def step():
        stub.launches += 2
        ops.int8_matmul.routes["mma_m16"] += 1
        return "out"

    g = _NoGraph(step, torch.device("cuda"))
    g.capture()
    assert ops.counters() == before           # the capture launched nothing
    assert g.delta == {"stub": 2, "int8_matmul/mma_m16": 1}
    for _ in range(3):
        assert g.replay() == "out"
    after = ops.counters()
    assert after["stub"] == 11
    assert after["int8_matmul/mma_m16"] == 10


def test_a_dropped_engine_frees_its_programs_without_the_collector():
    """No reference cycle runs through the planned programs: dropping a
    preplanned engine frees its runner (and, on the card, its CUDA
    graphs) at once, never in a later collection that could land inside
    another engine's capture."""
    eng = _engine("paged", 1, preplan=True)
    _serve(eng)
    runner = weakref.ref(eng.runner)
    gc.disable()
    try:
        del eng
        assert runner() is None
    finally:
        gc.enable()


def test_pipelined_metrics_and_tpot_stamped_at_completion(monkeypatch):
    """``steps_in_flight`` and ``dispatch_gap_ms`` in the summary; with a
    simulated device taking ``s`` per step, one after another, the
    pipelined TPOT still reports at least ``s``: tokens are stamped when
    their transfer lands, not at dispatch."""
    s = 0.02
    eng = _engine("paged", 1)
    r = eng.runner
    done_at = [0.0]
    dispatch, wait = r._dispatch_step, r._wait

    def timed_dispatch(*a):
        h = dispatch(*a)
        done_at[0] = h["t_done"] = max(time.perf_counter(), done_at[0]) + s
        return h

    def timed_wait(h):
        time.sleep(max(0.0, h["t_done"] - time.perf_counter()))
        return wait(h)

    monkeypatch.setattr(r, "_dispatch_step", timed_dispatch)
    monkeypatch.setattr(r, "_wait", timed_wait)
    reqs = _serve(eng)
    m = eng.metrics.summary()
    assert m["steps_in_flight"] == 2
    assert len(eng.metrics.dispatch_gaps) == r.decode_transfers - 1
    assert m["dispatch_gap_ms"]["mean"] > 0
    assert m["tpot_ms"]["mean"] >= 0.9 * s * 1e3
    assert all(q.t_done > q.t_first > q.t_submit for q in reqs)
    sync = _engine("paged")
    _serve(sync)
    assert sync.metrics.summary()["steps_in_flight"] == 0


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy argument first.  On
    the CPU backend ``jnp.asarray`` of a 64-byte-aligned numpy array
    aliases its memory, and the JAX engine's pipelined dispatch hands it
    host arrays that it updates in place once the previous step lands:
    when the next step's carry (``advance_decode`` over the aliased
    ``remaining``) runs after that update, two requests end one token
    early.  Whether it shows depends on where numpy's allocator put the
    arrays and on timing: rarely, and more under load."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return jnp.asarray(x.copy() if isinstance(x, np.ndarray) else x,
                           *args, **kwargs)


def test_pipelined_stream_equals_the_jax_engine(monkeypatch):
    """One JAX ``init_pt`` tree of reduced pt-6b-d4 in both packages: the
    port's pipelined, preplanned engine and the JAX engine with
    ``pipeline_depth=1`` emit the same streams (the JAX engine handed
    copies of its host arrays, ``_CopyingJnp``)."""
    monkeypatch.setattr(jengine, "jnp", _CopyingJnp())
    jcfg, cfg = j_reduced_config(PT), reduced_config(PT)
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    kw = dict(max_slots=2, max_seq_len=40, pipeline_depth=1)
    work = list(zip(_prompts(cfg)[:4], NEWS[:4]))
    jeng = jengine.Engine(jcfg, jparams, prefix_cache=False, **kw)
    jreqs = [jeng.submit(p, m) for p, m in work]
    jeng.run()
    eng = Engine(cfg, params, device="cpu", preplan=True, **kw)
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run()
    assert [q.output for q in reqs] == [q.output for q in jreqs]
    assert eng.runner.planned_hits == eng.runner.decode_transfers


def test_plain_attention_ignores_a_wider_bound():
    """The plain decode attention of both layouts and the chunk
    program's causal softmax give the same bits for every sweep bound
    that covers the live rows: each sums over the whole row and masks
    the columns past the cut."""
    g = torch.Generator().manual_seed(0)
    n, B, KH, G, hd, bs, nmax = 4, 3, 2, 2, 8, 8, 5
    N = B * nmax + 1
    q = torch.randn(n, B, KH * G, hd, generator=g)
    k, v = (torch.randn(n, N, bs, KH, hd, generator=g) for _ in range(2))
    table = (torch.randperm(N - 1, generator=g)[:B * nmax] + 1).reshape(
        B, nmax).to(torch.int32)
    lengths = torch.tensor([3, bs + 1, 5], dtype=torch.int32)
    outs = [paged_decode_attention_plain(q, k, v, table, lengths, max_len=m)
            for m in (2 * bs, 4 * bs, nmax * bs, None)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    dk, dv = (t.permute(1, 0, 2, 3, 4).reshape(N, n * bs, KH, hd)[:B]
              for t in (k, v))
    outs = [decode_attention_plain(q[0], dk, dv, lengths, block_s=8,
                                   max_len=m) for m in (16, 24, None)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    cfg, params = _params(PT)
    layer = {k: w[0, 0] for k, w in params["blocks"]["mixer"].items()}
    nt, d = cfg.pt.n_tracks, cfg.d_model
    pools = [torch.randn(nt, N, bs, cfg.n_kv_heads, cfg.head_dim,
                         generator=g) for _ in range(2)]
    x = torch.randn(nt, B, 4, d, generator=g)
    pos = torch.tensor([0, 9, 2], dtype=torch.int32)
    outs = [attention_chunk(
        layer, x, tuple(PagedLeaf(p.clone()) for p in pools),
        spec=cfg.spec(cfg.pattern_unit[0]), cfg=cfg, pos=pos,
        block_table=table, kv_max_len=m)[0] for m in (16, 32, None)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_serve_cli_pipelined_preplanned_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", PT,
         "--reduced", "--device", "cpu", "--requests", "3", "--input-len",
         "8", "--output-len", "4", "--slots", "2", "--pipeline-depth", "1",
         "--preplan"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "finished 3/3 requests" in out.stdout
    hits = re.search(r"step programs: (\d+) planned, replayed (\d+) of "
                     r"(\d+) steps", out.stdout)
    assert hits and int(hits[1]) > 0 and hits[2] == hits[3] != "0"


@pytest.mark.parametrize("knob", [{"max_queue": 4},
                                  {"fault_plan": object()}])
def test_unported_robustness_knobs_still_raise(knob):
    cfg, params = _params(PT)
    with pytest.raises(NotImplementedError, match="item 8"):
        Engine(cfg, params, device="cpu", **knob)
