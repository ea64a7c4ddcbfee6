"""The port's sampled serving against the JAX package on the CPU: the
threefry stream of ``repro_torch.common.prng`` against ``jax.random``
(jax's defaults: threefry2x32, partitionable), the samplers of
``repro_torch.serving.sampler`` against ``repro.serving.sampler``, and
the engine's sampled streams (plain, chunked prefill, speculative)
against the JAX engine's on the reduced paper PT config in fp32; then,
within the port, a sampled request's independence from its batch, the
default seeds, pipelined = sync with sampled lanes, and the decode
kernels' split plan, whose split size follows the capacity and not the
sweep.

Tolerances: keys, random bits and uniforms bitwise; Gumbel noise within
2 ulp of max(|g|, 1) (each ``log`` may differ in its last bit between
torch and XLA, and g = -log(-log(u)) carries the inner one's absolute
error); filtered logits at 1e-6 (abs) with the masked (NEG) positions
equal; tokens and packed accept results exact; engine token streams
identical.  The JAX engine runs once per arm, in the module-scoped
``jax_streams`` fixture."""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.serving import sampler as jsampler
from repro.serving.engine import Engine as JEngine
from repro_torch.common import prng
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.configs import reduced_config
from repro_torch.core import track
from repro_torch.kernels import decode_attention as da
from repro_torch.serving import sampler
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampler import SampleParams
from repro_torch.weights import from_jax_params

ARCH = "pt-6b-d4"          # reduced: reduced_pt(4), fp32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest-xdist worker (the shapes here are
    too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _words(keys) -> torch.Tensor:
    """JAX raw keys (uint32 [..., 2]) as the port's int64 words."""
    return _t(np.asarray(keys).astype(np.int64))


# ---------------------------------------------------------------------------
# (i) the threefry stream
# ---------------------------------------------------------------------------

SEEDS = np.array([0, 1, 2 ** 31 - 1, 2 ** 32 - 1], np.uint32)
COUNTERS = np.arange(301, dtype=np.int32)


@pytest.mark.parametrize("salt", [sampler.SALT_SAMPLE, sampler.SALT_ACCEPT,
                                  sampler.SALT_DRAFT])
def test_row_keys_bitwise(salt):
    """``row_keys`` for seeds 0, 1, 2**31 - 1, 2**32 - 1 by counters
    0..300: bitwise the reference's, from uint32 seeds and from the int32
    bit patterns the engine stages."""
    s = np.repeat(SEEDS, len(COUNTERS))
    c = np.tile(COUNTERS, len(SEEDS))
    want = np.asarray(jax.jit(lambda a, b: jsampler.row_keys(a, b, salt))(
        s, c))
    for seeds in (_t(s.astype(np.int64)), _t(s.view(np.int32))):
        got = sampler.row_keys(seeds, _t(c), salt)
        assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(
        sampler.prefill_keys(_t(s.astype(np.int64)), _t(c)).numpy(),
        np.asarray(jsampler.prefill_keys(s, c)).astype(np.int64))


def _three_keys():
    return np.asarray(jsampler.row_keys(SEEDS[1:], COUNTERS[5:8], 0))


@pytest.mark.parametrize("shape", [(1000,), (7, 13)])
def test_random_bits_and_uniform_bitwise(shape):
    """32-bit words and float32 uniforms (on [0, 1) and on [tiny, 1))
    of three keys, [3, 1000] and an odd [3, 7, 13]: bitwise
    ``jax.random.bits`` / ``uniform``."""
    keys = _three_keys()
    tiny = float(np.finfo(np.float32).tiny)
    bits = np.stack([np.asarray(jax.random.bits(k, shape)) for k in keys])
    assert np.array_equal(prng.random_bits(_words(keys), shape).numpy(),
                          bits.astype(np.int64))
    for lo in (0.0, tiny):
        want = np.stack([np.asarray(jax.random.uniform(k, shape, minval=lo))
                         for k in keys])
        got = prng.uniform(_words(keys), shape, lo, 1.0).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # a scalar draw (the accept step's uniforms) hashes the counter (0, 0)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))
    assert np.array_equal(prng.uniform(_words(keys)).numpy(), want)


def test_gumbel_within_two_ulp():
    keys = _three_keys()
    want = np.stack([np.asarray(jax.random.gumbel(k, (4000,)))
                     for k in keys]).astype(np.float64)
    got = prng.gumbel(_words(keys), (4000,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()


def test_categorical_tokens_equal():
    """Per-row keys over [64, 500] logits: the tokens of
    ``jax.vmap(jax.random.categorical)``."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((64, 500)) * 3).astype(np.float32)
    keys = np.asarray(jsampler.row_keys(np.arange(64, dtype=np.uint32),
                                        np.full(64, 9, np.int32), 0))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = prng.categorical(_words(keys), _t(logits))
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (ii) the samplers, on the same inputs
# ---------------------------------------------------------------------------

# per row: (temperature, top_k, top_p); row 0 greedy
PARAMS = [(0.0, 0, 1.0), (0.8, 5, 0.9), (1.3, 0, 1.0), (0.7, 0, 0.6),
          (1.0, 20, 1.0), (0.5, 3, 0.95)]


def _params(rows):
    t, k, p = (np.asarray(x) for x in zip(*rows))
    return (t.astype(np.float32), k.astype(np.int32), p.astype(np.float32))


def test_filter_logits_matches_reference():
    """Filtered logits at 1e-6 and the support (the positions left
    un-masked) equal, for every mix of temperature, top-k and top-p."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((len(PARAMS), 64)) * 2).astype(np.float32)
    t, k, p = _params(PARAMS)
    want = np.asarray(jax.jit(jsampler.filter_logits)(logits, t, k, p))
    got = sampler.filter_logits(_t(logits), _t(t), _t(k), _t(p)).numpy()
    assert np.array_equal(got == np.float32(sampler.NEG),
                          want == np.float32(jsampler.NEG))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _row_inputs(B=len(PARAMS), V=64, seed=2):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, B).astype(np.uint32)
    counts = rng.integers(0, 1000, B).astype(np.int32)
    return logits, seeds, counts


def test_sample_rows_and_step_match_reference():
    """``sample_rows`` with per-row keys and the packed ``sample_step``
    (inactive lanes, an EOS, a spent budget): equal to the reference's."""
    logits, seeds, counts = _row_inputs()
    t, k, p = _params(PARAMS)
    keys = jsampler.row_keys(seeds, counts, sampler.SALT_SAMPLE)
    mkeys = sampler.row_keys(_t(seeds.astype(np.int64)), _t(counts),
                             sampler.SALT_SAMPLE)
    want = np.asarray(jax.jit(jsampler.sample_rows)(logits, keys, t, k, p))
    got = sampler.sample_rows(_t(logits), mkeys, _t(t), _t(k), _t(p))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got[0] == logits[0].argmax()           # the greedy row
    B = len(PARAMS)
    active = np.array([True, True, False, True, True, True])
    eos = np.full(B, -1, np.int32)
    eos[3] = want[3]
    rem = np.array([5, 1, 5, 5, 5, 5], np.int32)
    want = np.asarray(jsampler.sample_step(logits, keys, t, k, p, active,
                                           eos, rem))
    got = sampler.sample_step(_t(logits), mkeys, _t(t), _t(k), _t(p),
                              _t(active), _t(eos), _t(rem))
    assert np.array_equal(got.numpy(), want)
    assert list(got[1].numpy()) == [0, 1, 0, 1, 0, 0]


def test_sample_and_sample_batched_match_reference():
    """The one-key samplers kept for tests and tools: ``sample`` over a
    grid of one SampleParams, ``sample_batched`` with per-row
    parameters."""
    logits, _, _ = _row_inputs(B=5, seed=3)
    key = jax.random.PRNGKey(11)
    for sp in (SampleParams(), SampleParams(0.7), SampleParams(1.0, 3),
               SampleParams(0.9, 0, 0.8), SampleParams(1.2, 16, 0.9)):
        jsp = jsampler.SampleParams(sp.temperature, sp.top_k, sp.top_p)
        want = np.asarray(jsampler.sample(logits, key, jsp))
        got = sampler.sample(_t(logits), _words(key), sp)
        assert np.array_equal(got.numpy(), want), sp
    t, k, p = _params(PARAMS[:5])
    want = np.asarray(jsampler.sample_batched(logits, key, t, k, p))
    got = sampler.sample_batched(_t(logits), _words(key), _t(t), _t(k),
                                 _t(p))
    assert np.array_equal(got.numpy(), want)


def test_fork_seeds_match_reference():
    """The seeds of fork children (for the fork arm of ROADMAP item 5):
    the reference's, distinct, never the parent's."""
    for base, n in ((0, 4), (2 ** 32 - 1, 3), (1234, 8)):
        got = sampler.fork_seeds(base, n)
        assert got == jsampler.fork_seeds(base, n)
        assert len(set(got)) == n and base & 0xFFFFFFFF not in got


@pytest.mark.parametrize("case", [0, 1, 2])
def test_sampled_accept_step_matches_reference(case):
    """Rejection sampling over B 4, K 3, V 64 with greedy and sampled
    rows mixed (and an inactive one): the packed [K+2, B] result equals
    the reference's; the draft logits are the target's plus noise, so
    some drafts are accepted and some rejected."""
    B, K, V = 4, 3, 64
    rng = np.random.default_rng(10 + case)
    tgt = (rng.standard_normal((B, K + 1, V)) * 2).astype(np.float32)
    dlg = (tgt[:, :K] + rng.standard_normal((B, K, V))).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31, B).astype(np.uint32)
    counts = rng.integers(1, 500, B).astype(np.int32)
    t, k, p = _params([PARAMS[0], PARAMS[1 + case], PARAMS[2], PARAMS[3]])
    drafts = np.stack([np.asarray(jsampler.sample_rows(
        dlg[:, j], jsampler.row_keys(seeds, counts + j, sampler.SALT_DRAFT),
        t, k, p)) for j in range(K)], axis=1)
    active = np.array([True, True, True, case != 2])
    want = np.asarray(jax.jit(jsampler.accept_step)(
        tgt, dlg, drafts, seeds, counts, t, k, p, active))
    got = sampler.accept_step(_t(tgt), _t(dlg), _t(drafts),
                              _t(seeds.astype(np.int64)), _t(counts), _t(t),
                              _t(k), _t(p), _t(active))
    assert got.dtype == torch.int32 and tuple(got.shape) == (K + 2, B)
    assert np.array_equal(got.numpy(), want)
    # the greedy row accepts exactly the drafts equal to the target argmax
    best = tgt[0].argmax(-1)
    n_acc = int(np.cumprod(drafts[0] == best[:K]).sum())
    assert got[-1, 0] == n_acc + 1 and got[n_acc, 0] == best[n_acc]


# ---------------------------------------------------------------------------
# (iii) the engine against the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 7], [11, 3, 1, 8, 4, 2], [17, 23], [4, 4, 4, 4, 4]]
REQ_PARAMS = [SampleParams(0.8, 5, 0.9), SampleParams(),
              SampleParams(1.3, 0, 1.0), SampleParams(0.7, 0, 0.8)]
REQ_SEEDS = [7, 0, 2 ** 31 - 1, 123]
ENGINE = dict(max_slots=4, max_seq_len=32)
ARMS = {"sync": {}, "chunk4": {"prefill_chunk": 4},
        "spec2": {"speculate_k": 2, "draft_tracks": 2}}
NEW = 4


def _submit(eng, params_cls=SampleParams):
    return [eng.submit(p, NEW, params=params_cls(sp.temperature, sp.top_k,
                                                 sp.top_p), seed=s)
            for p, sp, s in zip(PROMPTS, REQ_PARAMS, REQ_SEEDS)]


@pytest.fixture(scope="module")
def paper():
    """One weight tree in both packages: the reference ``init_pt``'s
    leaves, shapes and dtypes, drawn N(0, 0.02^2) from a seed with numpy
    (tracing ``init_pt`` costs seconds of compile and buys nothing
    here)."""
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: jtrack.init_pt(k, jcfg),
                            jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(
        lambda s: (0.02 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, host)
    return jcfg, cfg, jparams, from_jax_params(host, cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_streams(paper):
    """Each arm's JAX engine, run once: its sampled streams."""
    jcfg, _, jparams, _ = paper
    out = {}
    for arm, knobs in ARMS.items():
        eng = JEngine(jcfg, jparams, prefix_cache=False, **ENGINE, **knobs)
        reqs = _submit(eng, jsampler.SampleParams)
        eng.run()
        out[arm] = [q.output for q in reqs]
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_sampled_streams_match_reference(arm, paper, jax_streams):
    """Four requests with mixed SampleParams (one greedy) and seeds: the
    port's streams equal the JAX engine's, whole-prompt, chunked (4) and
    speculative (K 2 of 2 tracks, the rejection-sampling accept)."""
    _, cfg, _, params = paper
    eng = Engine(cfg, params, device="cpu", **ENGINE, **ARMS[arm])
    reqs = _submit(eng)
    eng.run()
    assert [q.output for q in reqs] == jax_streams[arm]
    assert [q.seed for q in reqs] == REQ_SEEDS
    if arm == "spec2":
        assert eng.runner.speculate_k == 2
        assert eng.metrics.summary()["spec_steps"] > 0
    else:
        # the greedy request's stream is every arm's
        assert reqs[1].output == jax_streams["sync"][1]


# ---------------------------------------------------------------------------
# (iv) within the port, on a small PT model (4 tracks, D 2, vocab 512)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = track.pt_ify(ModelConfig(
        name="pt-sampling-test", family="dense", n_layers=4, d_model=32,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=512,
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu")},
        pattern_unit=("full",), tie_embeddings=False, dtype="float32"),
        4, 2, width_mult=8)
    return cfg, track.init_pt(torch.Generator().manual_seed(0), cfg, "cpu")


def test_sampled_request_independent_of_batch(small):
    """A sampled request replays its tokens whether it runs alone or
    beside other, differently sampled requests (its keys are its seed
    and counter); two identical engines are equal end to end."""
    cfg, params = small
    sp = SampleParams(temperature=0.9, top_k=20)
    solo = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                  seed=0)
    r_solo = solo.submit([1, 2, 3, 4], 6, params=sp, seed=1234)
    solo.run()
    runs = []
    for _ in range(2):
        mixed = Engine(cfg, params, device="cpu", max_slots=2,
                       max_seq_len=32, seed=99)
        other = mixed.submit([9, 8, 7, 6, 5], 6,
                             params=SampleParams(temperature=1.3), seed=777)
        same = mixed.submit([1, 2, 3, 4], 6, params=sp, seed=1234)
        mixed.run()
        runs.append((other.output, same.output))
    assert runs[0][1] == r_solo.output
    assert all(0 <= t < cfg.vocab_size for t in runs[0][0])
    assert runs[0] == runs[1]


def test_default_seeds_deterministic_per_engine_seed(small):
    """Without explicit seeds, a request's seed is (engine seed *
    1_000_003 + request id) & 0x7FFFFFFF, so outputs are a function of
    the engine seed and the submission order."""
    cfg, params = small
    outs = []
    for seed in (5, 5, 6):
        eng = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                     seed=seed)
        outs.append(eng.generate([[1, 2, 3], [4, 5, 6]], 5,
                                 params=SampleParams(temperature=1.0)))
        assert eng.submit([1], 2).seed == (seed * 1_000_003 + 2) & 0x7FFFFFFF
    assert outs[0] == outs[1] and outs[0] != outs[2]


@pytest.mark.parametrize("knobs", [{}, {"speculate_k": 2}],
                         ids=["decode", "spec"])
def test_pipelined_sampled_matches_sync(small, knobs):
    """``pipeline_depth=1`` with the planned programs (greedy and sampled
    variants) emits the sync engine's sampled streams bitwise, the keys
    derived on the device from the carried counts."""
    cfg, params = small
    outs, engines = [], []
    for extra in ({}, {"pipeline_depth": 1, "preplan": True}):
        eng = Engine(cfg, params, device="cpu", **ENGINE, **knobs, **extra)
        reqs = _submit(eng)
        eng.run()
        outs.append([q.output for q in reqs])
        engines.append(eng)
    assert outs[0] == outs[1]
    r = engines[1].runner
    assert r.planned_hits == r.decode_transfers > 0
    assert {k[-1] for k in r.programs} == {False, True}


@pytest.mark.parametrize("knobs", [{}, {"speculate_k": 2}],
                         ids=["decode", "spec"])
def test_greedy_steps_run_no_sampling_ops(small, knobs):
    """A step whose lanes are all greedy runs the greedy program (the
    argmax alone: no threefry word op, no sort); a step with one sampled
    lane runs the sampled variant, greedy lanes included."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = small

    def step_ops(sampled):
        eng = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                     **knobs)
        sp = SampleParams(0.9, 20) if sampled else SampleParams()
        eng.submit([1, 2, 3], 6, params=sp)
        eng.submit([4, 5], 6)
        eng.step()                        # admission and a first step
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.step()
        return {e.name for e in prof.events()}

    greedy, sampled = step_ops(False), step_ops(True)
    for op in ("aten::sort", "aten::bitwise_xor", "aten::log"):
        assert op not in greedy and op in sampled, op


# ---------------------------------------------------------------------------
# (v) the decode kernels' split plan follows the capacity
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.integers(1, 8192), st.integers(1, 512),
       st.sampled_from([None, 8, 16, 32]), st.data())
def test_split_plan_split_size_ignores_the_sweep(capacity, base, page, data):
    """For a fixed capacity, base and page, every sweep from 1 to the
    capacity gets the same tokens per split; only the number of splits
    (ceil(sweep / c)) follows the sweep, so a wider bound only adds
    splits after the same boundaries."""
    if page is not None:
        capacity = -(-capacity // page) * page
    _, c = da.split_plan(capacity, base, page, capacity=capacity)
    sweeps = data.draw(st.lists(st.integers(1, capacity), min_size=1,
                                max_size=8))
    for sweep in sweeps + [1, capacity]:
        n, c2 = da.split_plan(sweep, base, page, capacity=capacity)
        assert c2 == c and n == -(-sweep // c) <= da._MAX_SPLITS
    with pytest.raises(ValueError):
        da.split_plan(capacity + 1, base, page, capacity=capacity)


def test_serve_cli_temperature_on_cpu(capsys):
    """``--temperature``, as the reference's CLI has it: every request
    sampled under its own default seed."""
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                       "--input-len", "4", "--output-len", "3", "--slots",
                       "2", "--temperature", "0.8"]) == 0
    out = capsys.readouterr().out
    assert "temperature 0.8" in out and "finished 2/2 requests" in out
