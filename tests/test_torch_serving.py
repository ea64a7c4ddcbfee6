"""The port's serving stack against the JAX package on the CPU: block
accounting of the paged cache, greedy token streams of the whole engine
on ``reduced_config("pt-6b-d4")`` (one JAX ``init_pt`` tree loaded into
both), the serve CLI, and the entry points' device rule."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.serving.cache import PagedKVCache as JPagedKVCache
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import reduced_config
from repro_torch.core.track import init_pt
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import Engine, ModelRunner, RequestState
from repro_torch.serving.sampler import SampleParams
from repro_torch.weights import from_jax_params

ARCH = "pt-6b-d4"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jcfg, cfg, jparams, params


def test_paged_cache_accounting_matches_reference():
    """The same random allocate / append / free sequence on both caches
    (prefix cache off) leaves identical tables and free counts, and both
    pass their own invariant checks after every op."""
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    kw = dict(max_slots=4, max_seq_len=40, block_size=4, num_blocks=24)
    ref = JPagedKVCache(lambda c, b, s: jtrack.pt_init_cache(c, b, s), jcfg,
                        prefix_cache=False, **kw)
    mine = PagedKVCache(cfg, device="cpu", **kw)
    assert tuple(mine.data[0].shape) == tuple(
        jax.tree_util.tree_leaves(ref.data)[0].shape)
    rng = np.random.default_rng(0)
    held = {}
    for _ in range(200):
        slot = int(rng.integers(4))
        if slot in held and rng.random() < 0.4:
            ref.free_slot(slot)
            mine.free_slot(slot)
            del held[slot]
        elif slot in held:
            n = min(40, held[slot] + int(rng.integers(1, 9)))
            fits = mine.blocks_for(n) - len(mine._blocks[slot]) \
                <= mine.free_blocks
            if fits:
                ref.append(slot, n)
                mine.append(slot, n)
                held[slot] = n
        else:
            n = int(rng.integers(1, 41))
            assert mine.can_allocate(n) == ref.can_allocate(n)
            if mine.can_allocate(n):
                toks = rng.integers(1, 99, size=n).tolist()
                assert ref.allocate(slot, n, tokens=toks) == 0
                mine.allocate(slot, n)
                held[slot] = n
        assert np.array_equal(mine.table_np, ref.table_np)
        assert mine.free_blocks == ref.free_blocks
        ref_u = ref.utilization()
        assert mine.utilization() == {k: ref_u[k] for k in mine.utilization()}
        mine.check_invariants()
        ref.check_invariants()
    with pytest.raises(MemoryError):
        for s in range(4):
            if s not in held:
                mine.allocate(s, 40)
                held[s] = 40


def _workload(cfg, eos_id=None):
    rng = np.random.default_rng(1)
    lens, news = (5, 20, 12, 9), (6, 3, 8, 5)
    return [(rng.integers(1, cfg.vocab_size, size=(L,)).tolist(), m,
             eos_id if i == 3 else None)
            for i, (L, m) in enumerate(zip(lens, news))]


def _serve(engine, work):
    reqs = [engine.submit(p, m, eos_id=e) for p, m, e in work]
    engine.run()
    return reqs


def test_engine_greedy_streams_match_reference(model):
    """More requests than slots, two prefill buckets, an EOS stop and
    per-request budgets: the port's Engine(device='cpu') and the JAX
    Engine(prefix_cache=False) emit identical token streams."""
    jcfg, cfg, jparams, params = model
    kw = dict(max_slots=2, max_seq_len=48)
    probe = _serve(Engine(cfg, params, device="cpu", **kw), _workload(cfg))
    eos = probe[3].output[2]                 # request 3 stops at its 3rd
    eng = Engine(cfg, params, device="cpu", **kw)
    reqs = _serve(eng, _workload(cfg, eos))
    jreqs = _serve(JEngine(jcfg, jparams, prefix_cache=False, **kw),
                   _workload(cfg, eos))
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert reqs[3].output[-1] == eos and len(reqs[3].output) <= 3
    assert [len(r.output) for r in reqs[:3]] == [6, 3, 8]
    assert all(r.state is RequestState.DONE for r in reqs)
    r = eng.runner
    assert {b for _, b in r.prefill_shapes} == {16, 32}
    # every step of this workload decodes: one host transfer per step
    assert r.decode_transfers == eng.steps_run
    assert r.kv.free_blocks == r.kv.num_blocks - 1
    r.kv.check_invariants()


def test_decode_table_is_cached_until_the_table_or_active_set_changes(model):
    _, cfg, _, params = model
    r = ModelRunner(cfg, params, max_slots=2, max_seq_len=32, device="cpu")
    r.kv.allocate(0, 20)
    act = np.asarray([True, False])
    t1 = r._masked_table(act)
    assert t1 is r.step_table               # the step programs' one table
    assert r._table_rows(act) is None       # unchanged: nothing to copy
    assert t1[1].abs().sum() == 0 and t1[0, 0] == r.kv.table_np[0, 0]
    both = np.asarray([True, True])
    assert r._masked_table(both) is t1 and t1[1].abs().sum() == 0
    assert r._table_rows(both) is None
    r.kv.allocate(1, 5)                     # a new table version
    assert r._masked_table(both) is t1 and t1[1, 0] == r.kv.table_np[1, 0]
    assert r._live_max_len(np.asarray([17, 3]), act) == 32


def test_engine_rejects_invalid_requests_and_unported_features(model):
    _, cfg, _, params = model
    eng = Engine(cfg, params, max_slots=2, max_seq_len=32, device="cpu")
    assert eng.submit([], 4).state is RequestState.REJECTED
    assert eng.submit([1] * 40, 4).state is RequestState.REJECTED
    assert eng.submit([1, 2], 0).state is RequestState.REJECTED
    # the prefix cache is ported, and on by default as in the reference
    assert eng.runner.prefix_cache and eng.runner.kv.prefix_cache
    assert not Engine(cfg, params, max_slots=2, max_seq_len=32,
                      device="cpu", prefix_cache=False).runner.prefix_cache
    # the robustness layer is ported: a bounded queue sheds past it
    small = Engine(cfg, params, max_slots=2, max_seq_len=32, device="cpu",
                   max_queue=1)
    assert small.submit([1, 2], 4).state is RequestState.QUEUED
    assert "overload shed" in small.submit([3, 4], 4).finish_reason
    sampled = eng.submit([1, 2], 4, params=SampleParams(temperature=0.7))
    assert sampled.state is RequestState.QUEUED   # sampling is ported
    assert eng.submit([1, 2], 4, priority=1).priority == 1
    for kw in ({"kv_dtype": "fp8"}, {"weight_dtype": "int4"},
               {"prefill_chunk": -1}):
        with pytest.raises(ValueError):
            Engine(cfg, params, device="cpu", **kw)
    assert eng.cancel(sampled) and sampled.state is RequestState.CANCELLED
    with pytest.raises(ValueError, match="decoding"):   # fork is ported
        eng.fork(sampled, 1)
    whisper = reduced_config("whisper-medium")    # the model is ported;
    with pytest.raises(ValueError, match="decoder-only"):   # the engine,
        Engine(whisper, params, device="cpu")       # as the reference's,
                                                    # serves decoder-only


def test_entry_points_without_device_refuse_to_run_on_cpu(model):
    """With no GPU, an entry point called without ``device`` raises; it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    _, cfg, _, params = model
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, max_slots=2, max_seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRunner(cfg, params, max_slots=2, max_seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_pt(torch.Generator(), cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])


@pytest.mark.parametrize("extra", [[], ["--shared-prefix", "16"],
                                   ["--num-blocks", "1", "--priority-mix",
                                    "2", "--fault-transfer-p", "0.3"]],
                         ids=["plain", "shared_prefix", "robust"])
def test_serve_cli_smoke_on_cpu(extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "3", "--input-len",
         "8", "--output-len", "4", "--slots", "2"] + extra,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "finished 3/3 requests" in out.stdout
    assert "TTFT ms" in out.stdout and "kernel launches" in out.stdout
    if "--shared-prefix" in extra:
        # the first two prompts are admitted together, cold; the third
        # finds the shared block the first committed
        assert "prefix cache: 16 of 72 prompt tokens" in out.stdout
    if "--num-blocks" in extra:
        # one request at a time fits the pool: the priority-1 one
        # preempts, and the faulted transfers are retried
        assert "fault injection armed" in out.stdout
        assert re.search(r"robustness: done=3 \| preemptions [1-9]",
                         out.stdout) and "transfer_faults 0" not in out.stdout
