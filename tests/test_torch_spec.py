"""The port's track-speculative serving arm against the JAX package on
the CPU: the track-subset drafter (``pt_draft_config`` /
``pt_draft_params`` / ``pt_draft_step``), the contiguous-cache chunk
branch of ``attention_chunk`` (the reference's ``_dense_chunk``), the
greedy ``accept_step``, and the engine's greedy streams with
``speculate_k``, all in fp32 with one JAX ``init_pt`` tree loaded into
both packages.

Tolerances: parameter slices bitwise; packed accept results exact;
whole-model logits and caches 1e-4, as tests/test_torch_model.py; token
streams identical.  Each JAX engine configuration runs once, in the
module-scoped ``jax_streams`` fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import LayerSpec as JLayerSpec
from repro.common.types import ModelConfig as JModelConfig
from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.models import attention as jattn
from repro.serving import sampler as jsampler
from repro.serving.engine import Engine as JEngine
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.configs import reduced_config
from repro_torch.core import track
from repro_torch.models import attention
from repro_torch.serving import sampler
from repro_torch.serving.engine import Engine, RequestState
from repro_torch.serving.sampler import SampleParams
from repro_torch.weights import from_jax_params

MODEL_TOL = 1e-4
ARCH = "pt-6b-d4"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spec_cfgs(vocab: int = 64):
    """The reference tests' small 4-track PT config (D = 2, tiny vocab),
    PT-ified by each package's own ``pt_ify``."""
    kw = dict(name="pt-spec-test", family="dense", n_layers=4, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=vocab,
              pattern_unit=("full",), tie_embeddings=False, dtype="float32")
    jcfg = jtrack.pt_ify(JModelConfig(
        layer_specs={"full": JLayerSpec(mixer="gqa", mlp="swiglu")}, **kw),
        4, 2, width_mult=8)
    cfg = track.pt_ify(ModelConfig(
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu")}, **kw),
        4, 2, width_mult=8)
    return jcfg, cfg


def _load(jcfg, cfg, seed=0):
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(seed))
    return jparams, from_jax_params(_np(jparams), cfg, device="cpu")


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = _spec_cfgs()
    return (jcfg, cfg) + _load(jcfg, cfg)


@pytest.fixture(scope="module")
def paper():
    jcfg, cfg = j_reduced_config(ARCH), reduced_config(ARCH)
    return (jcfg, cfg) + _load(jcfg, cfg)


# ---------------------------------------------------------------------------
# (i) the drafter
# ---------------------------------------------------------------------------

def test_draft_params_and_config_match_reference(paper):
    jcfg, cfg, jparams, params = paper
    n = cfg.pt.n_tracks
    for d in (1, 2, n):
        dcfg, jdcfg = track.pt_draft_config(cfg, d), \
            jtrack.pt_draft_config(jcfg, d)
        assert dcfg.name == jdcfg.name == f"{cfg.name}-draft{d}"
        assert dcfg.pt.n_tracks == jdcfg.pt.n_tracks == d
        mine = track.pt_draft_params(params, cfg, d)
        want = _np(jtrack.pt_draft_params(jparams, jcfg, d))
        for (path, a), b in zip(
                jax.tree_util.tree_leaves_with_path(mine),
                jax.tree_util.tree_leaves(want)):
            assert np.array_equal(a.numpy(), b), (d, path)
        # the slices are views of the target's blocks; the rest is shared
        wq = mine["blocks"]["mixer"]["wq"]
        assert wq.data_ptr() == params["blocks"]["mixer"]["wq"].data_ptr()
        assert mine["head"] is params["head"]
    for bad in (0, n + 1):
        with pytest.raises(ValueError, match="draft_tracks"):
            track.pt_draft_config(cfg, bad)
        with pytest.raises(ValueError, match="draft_tracks"):
            track.pt_draft_params(params, cfg, bad)


def test_draft_step_matches_reference(paper):
    """Prefill the drafter's contiguous cache, then three draft steps with
    a frozen lane in the second: logits and cache within 1e-4."""
    jcfg, cfg, jparams, params = paper
    d, B, S = 2, 3, 24
    dcfg, jdcfg = track.pt_draft_config(cfg, d), \
        jtrack.pt_draft_config(jcfg, d)
    dp = track.pt_draft_params(params, cfg, d)
    jdp = jtrack.pt_draft_params(jparams, jcfg, d)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(B, 10)).astype(np.int32)
    _, pre = track.pt_forward(dp, {"inputs": torch.from_numpy(toks)}, dcfg,
                              head=False)
    cache = track.pt_init_cache(dcfg, B, S, device="cpu")
    for leaf, src in zip(cache["blocks"], pre["blocks"]):
        leaf[:, :, :, :, :10] = src
    jcache = {"blocks": tuple(jnp.asarray(leaf.numpy())
                              for leaf in cache["blocks"]), "tail": ()}
    jstep = jax.jit(lambda p, c, t, pos, a: jtrack.pt_draft_step(
        p, c, t, pos, jdcfg, active=a))
    pos = np.asarray([10, 10, 10], np.int32)
    for k in range(3):
        t = rng.integers(1, cfg.vocab_size, size=(B,)).astype(np.int32)
        act = np.asarray([True, k != 1, True])
        lg, cache = track.pt_draft_step(
            dp, cache, torch.from_numpy(t), torch.from_numpy(pos + k), dcfg,
            active=torch.from_numpy(act), kv_max_len=16)
        jlg, jcache = jstep(jdp, jcache, jnp.asarray(t),
                            jnp.asarray(pos + k), jnp.asarray(act))
        _close(lg, jlg)
        for leaf, jleaf in zip(cache["blocks"], jcache["blocks"]):
            _close(leaf, jleaf)
    # head=False writes the same K/V and returns no logits
    again = {"blocks": tuple(leaf.clone() for leaf in cache["blocks"])}
    lg, _ = track.pt_draft_step(dp, again, torch.from_numpy(t),
                                torch.from_numpy(pos + 3), dcfg, head=False)
    _, ref = track.pt_draft_step(dp, cache, torch.from_numpy(t),
                                 torch.from_numpy(pos + 3), dcfg)
    assert lg is None
    for a, b in zip(again["blocks"], ref["blocks"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (ii) the contiguous chunk branch (the reference's _dense_chunk)
# ---------------------------------------------------------------------------

def test_contiguous_attention_chunk_matches_reference(paper):
    """One layer, a 5-token chunk at ragged positions, the last row's
    tail past S (dropped): rows and outputs within 1e-4."""
    jcfg, cfg, jparams, params = paper
    n, B, C, S = cfg.pt.n_tracks, 3, 5, 12
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(3)
    k0, v0 = (rng.standard_normal((n, B, S, KH, hd)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((n, B, C, cfg.d_model)).astype(np.float32)
    pos = np.asarray([4, 0, 9], np.int32)          # row 2 writes 9..13
    lp = jax.tree_util.tree_map(lambda l: l[1, 2],
                                jparams["blocks"])["mixer"]
    mine = (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    tp = jax.tree_util.tree_map(lambda l: l[1, 2], params["blocks"])["mixer"]
    out, _ = attention.attention_chunk(
        tp, torch.from_numpy(x), mine, spec=cfg.spec("full"), cfg=cfg,
        pos=torch.from_numpy(pos))
    jout, (jk, jv) = jax.jit(jax.vmap(lambda p, h, k, v: jattn.attention_chunk(
        p, h, (k, v), spec=jcfg.spec("full"), cfg=jcfg,
        pos=jnp.asarray(pos))))(lp, jnp.asarray(x), jnp.asarray(k0),
                                jnp.asarray(v0))
    _close(out, jout)
    _close(mine[0], jk)
    _close(mine[1], jv)
    # rows past S dropped, rows outside the chunk untouched
    assert np.array_equal(mine[0][:, 1, C:].numpy(), k0[:, 1, C:])
    assert np.array_equal(mine[0][:, 0, :4].numpy(), k0[:, 0, :4])


def test_contiguous_pt_chunk_step_matches_reference(paper):
    """Whole model, two chunks back to back into the contiguous cache with
    no block table (the second attends to the first, and runs past S):
    logits of every row and the cache."""
    jcfg, cfg, jparams, params = paper
    B, C, S = 2, 6, 16
    rng = np.random.default_rng(5)
    cache = track.pt_init_cache(cfg, B, S, device="cpu")
    jcache = jtrack.pt_init_cache(jcfg, B, S)
    jstep = jax.jit(lambda p, c, t, pos: jtrack.pt_chunk_step(
        p, c, t, pos, jcfg))
    pos = np.asarray([0, 5], np.int32)
    for _ in range(2):
        toks = rng.integers(1, cfg.vocab_size, size=(B, C)).astype(np.int32)
        lg, cache = track.pt_chunk_step(params, cache, torch.from_numpy(toks),
                                        torch.from_numpy(pos), cfg)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks),
                            jnp.asarray(pos))
        _close(lg, jlg)
        pos = pos + C
    for leaf, jleaf in zip(cache["blocks"], jcache["blocks"]):
        _close(leaf, jleaf)


# ---------------------------------------------------------------------------
# (iii) greedy accept
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["all", "none", "mid", "inactive"])
def test_accept_step_matches_reference(case):
    B, K, V = 4, 3, 11
    rng = np.random.default_rng({"all": 1, "none": 2, "mid": 3,
                                 "inactive": 4}[case])
    tgt = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    dlg = rng.standard_normal((B, K, V)).astype(np.float32)
    best = tgt.argmax(-1).astype(np.int32)
    drafts = {"all": best[:, :K],
              "none": (best[:, :K] + 1) % V,
              "mid": np.where(np.arange(K)[None] == np.arange(B)[:, None]
                              % K, (best[:, :K] + 1) % V, best[:, :K]),
              "inactive": best[:, :K]}[case].astype(np.int32)
    active = np.asarray([True, case != "inactive", True, case != "inactive"])
    mine = sampler.accept_step(torch.from_numpy(tgt), torch.from_numpy(dlg),
                               torch.from_numpy(drafts), None, None, None,
                               None, None, torch.from_numpy(active))
    z = jnp.zeros((B,), jnp.float32)
    want = jsampler.accept_step(
        jnp.asarray(tgt), jnp.asarray(dlg), jnp.asarray(drafts),
        jnp.zeros((B,), jnp.uint32), jnp.zeros((B,), jnp.int32), z,
        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32),
        jnp.asarray(active))
    assert mine.dtype == torch.int32 and tuple(mine.shape) == (K + 2, B)
    assert np.array_equal(mine.numpy(), np.asarray(want))
    m = mine[-1].numpy()
    assert {"all": (m == K + 1).all(), "none": (m == 1).all(),
            "mid": (m == np.arange(B) % K + 1).all(),
            "inactive": list(m) == [K + 1, 0, K + 1, 0]}[case]
    # with temperature 0.5 the rejection sampler, against the reference's
    seeds, counts = np.arange(B, dtype=np.uint32), np.full(B, 3, np.int32)
    half, top_k, top_p = (np.full(B, 0.5, np.float32),
                          np.zeros(B, np.int32), np.ones(B, np.float32))
    mine = sampler.accept_step(
        *(torch.from_numpy(a) for a in (tgt, dlg, drafts)),
        torch.from_numpy(seeds.astype(np.int64)),
        *(torch.from_numpy(a) for a in (counts, half, top_k, top_p, active)))
    want = jsampler.accept_step(
        jnp.asarray(tgt), jnp.asarray(dlg), jnp.asarray(drafts),
        jnp.asarray(seeds), jnp.asarray(counts), jnp.asarray(half),
        jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(active))
    assert np.array_equal(mine.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# (iv) the engine against the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 7], [11, 3, 1, 8, 4, 2], [17, 23]]
ARMS = {"small": ("small", {}, 10), "paper": ("paper", {}, 5),
        "chunk4": ("small", {"prefill_chunk": 4}, 6),
        "w8kv8": ("small", {"weight_dtype": "int8", "kv_dtype": "int8"}, 6)}
SPEC = dict(max_slots=2, max_seq_len=48, speculate_k=3, draft_tracks=2)


@pytest.fixture(scope="module")
def jax_streams(small, paper):
    """Each arm's JAX engine, run once: (streams, speculate_k)."""
    out = {}
    for arm, (which, knobs, n_new) in ARMS.items():
        jcfg, _, jparams, _ = small if which == "small" else paper
        eng = JEngine(jcfg, jparams, prefix_cache=False, **SPEC, **knobs)
        out[arm] = (eng.generate(PROMPTS, max_new_tokens=n_new),
                    eng.runner.speculate_k)
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_spec_streams_match_reference_and_plain(arm, jax_streams,
                                                       small, paper):
    which, knobs, n_new = ARMS[arm]
    _, cfg, _, params = small if which == "small" else paper
    eng = Engine(cfg, params, device="cpu", **SPEC, **knobs)
    assert eng.runner.speculate_k == 3 and eng.runner.draft_tracks == 2
    out = eng.generate(PROMPTS, max_new_tokens=n_new)
    jout, jk = jax_streams[arm]
    assert jk == 3
    assert out == jout
    plain = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=48,
                   **knobs)
    assert out == plain.generate(PROMPTS, max_new_tokens=n_new)
    m = eng.metrics.summary()
    assert m["spec_steps"] > 0 and 0.0 <= m["acceptance_rate"] <= 1.0
    r = eng.runner
    # one host transfer per engine step, every step a speculative one
    assert r.decode_transfers == eng.steps_run
    assert r.kv.free_blocks == r.kv.num_blocks - 1
    r.kv.check_invariants()
    if "prefill_chunk" in knobs:
        assert r.draft_chunk_shapes and not r.draft_prefill_shapes
    else:
        assert r.draft_prefill_shapes and not r.draft_chunk_shapes


# ---------------------------------------------------------------------------
# (v) the engine's own invariants
# ---------------------------------------------------------------------------

def _tied(params):
    """Every track a copy of track 0, written in place."""
    def tie(tree):
        if isinstance(tree, dict):
            return {k: tie(v) for k, v in tree.items()}
        out = tree.clone()
        out[:, :, 1:] = out[:, :, :1]
        return out
    return dict(params, blocks=tie(params["blocks"]))


def test_tied_tracks_accept_everything(small):
    """With identical tracks the drafter is the target model: acceptance
    is 1.0, every step advances K + 1 tokens, and the streams equal plain
    decode; also when every budget is shorter than K."""
    _, cfg, _, params = small
    params = _tied(params)
    prompts = [[1, 2, 3, 4]] * 2
    plain = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=64)
    ref = plain.generate(prompts, max_new_tokens=16)
    spec = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=64,
                  speculate_k=4, draft_tracks=1)
    assert spec.generate(prompts, max_new_tokens=16) == ref
    m = spec.metrics.summary()
    assert m["acceptance_rate"] == 1.0 and m["tokens_per_slot_step"] == 5.0
    assert spec.steps_run * 3 < plain.steps_run
    early = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=64,
                   speculate_k=4, draft_tracks=1)
    early.generate([[1, 2, 3, 4]] * 3, max_new_tokens=2)
    m = early.metrics.summary()
    assert m["spec_steps"] > 0 and m["acceptance_rate"] == 1.0


def test_eos_and_capacity_truncation_equal_plain_decode(small):
    _, cfg, _, params = small
    params = _tied(params)         # accepted runs, so EOS lands inside one
    probe = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=48)
    out = probe.generate([[1, 2, 3]], max_new_tokens=8)[0]
    eng = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=48,
                 speculate_k=4, draft_tracks=2)
    req = eng.submit([1, 2, 3], 8, eos_id=out[3])
    eng.run()
    assert req.output == out[:out.index(out[3]) + 1]
    assert req.state is RequestState.DONE
    assert eng.metrics.summary()["acceptance_rate"] == 1.0
    # capacity clamp: prompt 12 leaves room for 5 positions only
    plain = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=16)
    ref = plain.submit([1] * 12, max_new_tokens=50)
    plain.run()
    spec = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=16,
                  speculate_k=3, draft_tracks=2)
    r = spec.submit([1] * 12, max_new_tokens=50)
    spec.run()
    assert r.truncated and r.output == ref.output


def test_verify_overflow_lands_only_in_trash_block(small):
    """Near the end of a reservation the K+1-row verify runs past the
    allocated blocks: those rows fall through the zeroed table columns
    into trash block 0, never into a block another request could get."""
    _, cfg, _, params = small
    eng = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=64,
                 block_size=8, num_blocks=16, speculate_k=4, draft_tracks=2)
    # reservation 4 + 3 - 1 = 6 tokens = 1 block; the verify writes 5
    # rows from pos <= 5, so rows 8..9 land in table column 1 (trash)
    req = eng.submit([1, 2, 3, 4], max_new_tokens=3)
    eng.run()
    assert req.state is RequestState.DONE
    kv = eng.runner.kv
    kv.check_invariants()
    for pool in kv.data:
        blocks = pool.movedim(3, 0)
        assert not blocks[-1].any() and not blocks[-2].any()
        assert blocks[0].any()


def test_spec_gating_falls_back_with_reasons(small):
    """speculate_k falls back to 0, with the reference's capability
    reason, where the draft / verify structure does not exist: a non-PT
    config, the contiguous cache, a recurrent config."""
    jcfg, cfg, jparams, params = small
    eng = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=32,
                 paged=False, speculate_k=4)
    assert eng.runner.speculate_k == 0
    assert eng.runner.quant_fallbacks == [
        "speculate_k=4: needs the paged cache; serving plain decode"]
    assert JEngine(jcfg, jparams, max_slots=1, max_seq_len=32, paged=False,
                   speculate_k=4).runner.speculate_k == 0
    from repro.serving.engine import arch_capabilities as j_caps
    from repro_torch.launch.steps import model_fns
    for arch in ("dense-6b", "falcon-mamba-7b"):
        c = reduced_config(arch)
        why = j_caps(j_reduced_config(arch))["speculative"].reason
        p = model_fns(c)["init"](torch.Generator().manual_seed(0), c, "cpu")
        eng = Engine(c, p, device="cpu", max_slots=1, max_seq_len=32,
                     speculate_k=4)
        assert eng.runner.speculate_k == 0
        assert eng.runner.quant_fallbacks == [
            f"speculate_k=4: {why}; serving plain decode"]
        assert len(eng.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3
    eng = Engine(cfg, params, device="cpu", max_slots=1, max_seq_len=32,
                 speculate_k=2)
    assert eng.runner.draft_tracks == cfg.pt.n_tracks // 2
    sampled = eng.submit([1, 2], 4, params=SampleParams(temperature=0.7))
    eng.run()
    assert sampled.state is RequestState.DONE and len(sampled.output) == 4


def test_serve_cli_speculative_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--input-len", "8",
                       "--output-len", "4", "--slots", "2",
                       "--speculate-k", "3", "--draft-tracks", "2"]) == 0
    out = capsys.readouterr().out
    assert "speculative: K=3, drafter of 2/4 tracks" in out
    assert "acceptance rate" in out and "finished 3/3 requests" in out
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "2", "--input-len", "8",
                       "--output-len", "3", "--slots", "2", "--contiguous",
                       "--speculate-k", "3"]) == 0
    out = capsys.readouterr().out
    assert "fallback: speculate_k=3: needs the paged cache" in out
