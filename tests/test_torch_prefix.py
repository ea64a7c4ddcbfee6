"""The port's prefix cache, n-way fork and copy-on-write blocks against
the JAX package on the CPU.

  (a) one seeded random op sequence (allocate with tokens, commit,
      append, fork, ``ensure_writable``, free, eviction from the LRU
      under pressure) drives the reference's ``PagedKVCache`` and the
      port's side by side: tables, refcounts, matched lengths, copy
      pairs, the free and cached-free lists and ``utilization()`` equal
      after every op, both invariant checks holding;
  (b, c) the engine's warm hits and forks (greedy and sampled children)
      against the JAX engine with its prefix cache on, on a small PT
      config in fp32 (plain, chunk 8, speculative K 3 of 2 tracks, int8
      weights + int8 KV) and reduced tinyllama (plain, chunk 8, int8):
      streams, ``cached_prefix``, ``prefix_hit_tokens`` and
      ``cow_copies`` equal; the contiguous cache refuses ``fork``;
  (d) the reference's random fork / copy-on-write / decode property
      against a contiguous mirror (``tests/test_prefix_cache.py``), fp
      and int8: every live slot's pool rows through its table equal the
      mirror bitwise (int8: the scale rows move with their payloads),
      and a decode step over the pools equals one over the mirror;
  (e) the pipelined engine with planned programs (eager on the CPU;
      every program, or those of the scenario's live lengths) equal to
      the sync engine with warm hits and forks, bitwise;
  (f) falcon-mamba: the prefix cache off by capability, fork children
      (state rows copied) equal to the parent;
  (g) a copy-on-write on an exhausted pool preempts, as the reference
      does: the writer evicts its fork child, which resumes later; the
      streams, preemptions and copies are the JAX engine's.

Each JAX engine runs once, in the module fixture ``jax_runs``."""
import jax
import numpy as np
import pytest
import torch

from repro.common.types import LayerSpec as JLayerSpec
from repro.common.types import ModelConfig as JModelConfig
from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.models.decoder import init_lm as j_init_lm
from repro.serving.cache import PagedKVCache as JPagedKVCache
from repro.serving.engine import Engine as JEngine
from repro.serving.sampler import SampleParams as JSampleParams
from repro_torch.common.paged import token_to_pool
from repro_torch.common.quant import dequantize_rows, quantize_rows
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.configs import reduced_config
from repro_torch.core import track
from repro_torch.models.attention import pool_write
from repro_torch.serving.cache import PagedKVCache
from repro_torch.serving.engine import Engine, RequestState
from repro_torch.serving.sampler import SampleParams, fork_seeds
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs on several pytest-xdist workers at once: one
    intra-op thread keeps torch's idle pool threads off the cores the
    other workers use (the shapes here are too small to gain from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pt_cfgs():
    """The reference tests' small 4-track PT config (D = 2, vocab 64),
    PT-ified by each package's own ``pt_ify``."""
    kw = dict(name="pt-prefix-test", family="dense", n_layers=4, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
              pattern_unit=("full",), tie_embeddings=False, dtype="float32")
    jcfg = jtrack.pt_ify(JModelConfig(
        layer_specs={"full": JLayerSpec(mixer="gqa", mlp="swiglu")}, **kw),
        4, 2, width_mult=8)
    cfg = track.pt_ify(ModelConfig(
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu")}, **kw),
        4, 2, width_mult=8)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX tree, port tree) by name: the small
    PT config and reduced tinyllama, one seeded JAX tree each."""
    jcfg, cfg = _pt_cfgs()
    jpt = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(jax.random.PRNGKey(0))
    jtl_cfg = j_reduced_config("tinyllama-1.1b")
    jtl = jax.jit(lambda k: j_init_lm(k, jtl_cfg))(jax.random.PRNGKey(0))
    tl_cfg = reduced_config("tinyllama-1.1b")
    return {"pt": (jcfg, cfg, jpt, from_jax_params(_np(jpt), cfg, "cpu")),
            "tinyllama": (jtl_cfg, tl_cfg, jtl,
                          from_jax_params(_np(jtl), tl_cfg, "cpu"))}


# ---------------------------------------------------------------------------
# (a) the block accounting, op for op
# ---------------------------------------------------------------------------

def _same_state(ref, mine) -> None:
    assert np.array_equal(mine.table_np, ref.table_np)
    assert mine._ref == ref._ref
    assert mine._blocks == ref._blocks
    assert mine._free == ref._free
    assert list(mine._cached_free) == list(ref._cached_free)
    assert mine._committed == ref._committed
    assert mine._hash_of == ref._hash_of
    got, want = mine.utilization(), ref.utilization()
    shared = set(got) & set(want)
    assert {"cached_free_blocks", "prefix_hit_tokens", "cow_copies",
            "prefix_queries", "prefix_lookup_tokens"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    mine.check_invariants()
    ref.check_invariants()


def test_block_accounting_matches_reference_op_for_op():
    """A seeded random sequence over four slots and a pool that runs dry:
    every op gives the same result (or the same MemoryError) on both
    caches and leaves the same host state."""
    jcfg, cfg = j_reduced_config("pt-6b-d4"), reduced_config("pt-6b-d4")
    kw = dict(max_slots=4, max_seq_len=40, block_size=4, num_blocks=26)
    ref = JPagedKVCache(lambda c, b, s: jtrack.pt_init_cache(c, b, s), jcfg,
                        **kw)
    mine = PagedKVCache(cfg, device="cpu", **kw)
    assert mine.prefix_cache and ref.prefix_cache
    rng = np.random.default_rng(3)
    bases = [rng.integers(1, 50, size=40).tolist() for _ in range(3)]
    seqs = {}                                  # slot -> its token ids
    kinds = dict.fromkeys(("alloc", "hit", "append", "fork", "cow",
                           "evict", "free", "oom"), 0)

    def both(op, *args, **kwargs):
        outs = []
        for c in (ref, mine):
            try:
                outs.append(("ok", getattr(c, op)(*args, **kwargs)))
            except MemoryError:
                outs.append(("oom", None))
        assert outs[0] == outs[1], (op, args, outs)
        kinds["oom"] += outs[0][0] == "oom"
        return outs[1]

    for _ in range(400):
        slot = int(rng.integers(4))
        held = slot in seqs
        u = rng.random()
        evicted0 = len(ref._cached_free)
        if held and u < 0.15:
            both("free_slot", slot)
            del seqs[slot]
            kinds["free"] += 1
        elif held and u < 0.3:
            dst = next((d for d in range(4) if d not in seqs), None)
            if dst is not None:
                # the writer's watermark first, as Engine.fork does
                both("commit_tokens", slot, seqs[slot])
                assert mine.fork_cost(slot) == ref.fork_cost(slot)
                st, _ = both("fork", slot, dst)
                if st == "ok":
                    seqs[dst] = list(seqs[slot])
                    kinds["fork"] += 1
        elif held and u < 0.5:
            lo = int(rng.integers(0, len(seqs[slot]) + 1))
            hi = lo + int(rng.integers(1, 9))
            st, pairs = both("ensure_writable", slot, lo, hi)
            kinds["cow"] += bool(pairs)
        elif held and u < 0.7:
            n = min(40, len(seqs[slot]) + int(rng.integers(1, 9)))
            st, _ = both("append", slot, n)
            if st == "ok":
                seqs[slot] += rng.integers(1, 50, size=n
                                           - len(seqs[slot])).tolist()
                both("commit_tokens", slot, seqs[slot][:int(
                    rng.integers(len(seqs[slot]) // 2, n + 1))])
                kinds["append"] += 1
        elif not held:
            base = bases[int(rng.integers(len(bases)))]
            m = int(rng.integers(2, 33))
            toks = base[:m] + rng.integers(50, 99, size=int(
                rng.integers(0, 5))).tolist()
            n = min(40, len(toks) + int(rng.integers(0, 6)))
            assert mine.match_prefix(toks) == ref.match_prefix(toks)
            assert mine.can_allocate(n, tokens=toks) == \
                ref.can_allocate(n, tokens=toks)
            st, matched = both("allocate", slot, n, tokens=toks)
            if st == "ok":
                seqs[slot] = list(toks)
                kinds["alloc"] += 1
                kinds["hit"] += matched > 0
                both("commit_tokens", slot, toks)
            else:
                both("free_slot", slot)        # the engine's rollback
        kinds["evict"] += len(ref._cached_free) < evicted0 and u >= 0.15
        _same_state(ref, mine)
    assert all(kinds.values()), kinds


# ---------------------------------------------------------------------------
# (b, c) warm hits and forks against the JAX engine
# ---------------------------------------------------------------------------

SHARED = [7, 3, 9, 1, 4, 4, 8, 2, 6, 5, 3, 1]           # three blocks of 4
TAILS = [[11, 12, 13], [21, 22, 23, 24, 25], [31, 32, 33, 34, 35, 36]]
ENGINE = dict(max_slots=7, max_seq_len=48, block_size=4, min_bucket=8)
SAMPLED = (0.8, 20, 0.9)
ARMS = {"pt plain": ("pt", {}), "pt chunk8": ("pt", {"prefill_chunk": 8}),
        "pt spec": ("pt", {"speculate_k": 3, "draft_tracks": 2}),
        "pt int8": ("pt", {"weight_dtype": "int8", "kv_dtype": "int8"}),
        "tinyllama plain": ("tinyllama", {}),
        "tinyllama chunk8": ("tinyllama", {"prefill_chunk": 8}),
        "tinyllama int8": ("tinyllama", {"weight_dtype": "int8",
                                         "kv_dtype": "int8"})}


def _scenario(eng, sample_params) -> dict:
    """A seed request (the shared prefix and a tail of its own) served to
    the end; then three requests on the shared prefix with distinct
    tails (one sampled, seed 7), three engine steps, a greedy fork of
    the first into two and a sampled fork of the second into two, and
    the rest of the run.  Works on either package's engine."""
    seed = eng.submit(SHARED + [40, 41, 42, 43], 6)
    eng.run()
    reqs = [eng.submit(SHARED + TAILS[0], 12),
            eng.submit(SHARED + TAILS[1], 12, params=sample_params(
                *SAMPLED), seed=7),
            eng.submit(SHARED + TAILS[2], 12)]
    while sum(len(r.output) for r in reqs) + 3 * len(eng._inflight) < 9:
        eng.step()
    kids = eng.fork(reqs[0], 2) + eng.fork(reqs[1], 2)
    eng.run()
    kv = eng.runner.kv
    kv.check_invariants()
    return {"streams": [r.output for r in [seed] + reqs + kids],
            "cached": [r.cached_prefix for r in [seed] + reqs + kids],
            "seeds": [r.seed for r in kids],
            "states": [r.state.value for r in [seed] + reqs + kids],
            "hits": kv.prefix_hit_tokens, "queries": kv.prefix_queries,
            "lookups": kv.prefix_lookup_tokens, "cow": kv.cow_copies,
            "free": kv.free_blocks}


@pytest.fixture(scope="module")
def jax_runs(models):
    out = {}
    for arm, (name, knobs) in ARMS.items():
        jcfg, _, jparams, _ = models[name]
        eng = JEngine(jcfg, jparams, **ENGINE, **knobs)
        out[arm] = _scenario(eng, JSampleParams)
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_warm_hits_and_forks_match_the_jax_engine(arm, models, jax_runs):
    name, knobs = ARMS[arm]
    _, cfg, _, params = models[name]
    eng = Engine(cfg, params, device="cpu", **ENGINE, **knobs)
    assert eng.runner.prefix_cache
    got = _scenario(eng, SampleParams)
    want = jax_runs[arm]
    assert got == want
    # the scenario did what it is for: three warm hits on the shared
    # prefix, greedy children equal to their parent, sampled ones apart
    assert got["cached"][1:4] == [len(SHARED)] * 3
    assert got["hits"] == 3 * len(SHARED) and got["queries"] == 4
    assert got["cow"] >= 3
    s = got["streams"]
    assert s[4] == s[5] == s[1]
    assert s[6] != s[7] and got["seeds"][2:] == fork_seeds(7, 2)
    assert set(got["states"]) == {"done"}
    if "speculate_k" in knobs:
        assert eng.runner.speculate_k == 3
    if "prefill_chunk" in knobs:
        assert eng.runner.chunk_shapes and not eng.runner.prefill_shapes
    else:
        assert eng.runner.chunk_calls >= 1


def test_fork_refusals(models):
    _, cfg, _, params = models["pt"]
    eng = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                 block_size=4)
    req = eng.submit([1, 2, 3, 4, 5], 4)
    with pytest.raises(ValueError, match="decoding"):      # still queued
        eng.fork(req, 1)
    eng.step()
    with pytest.raises(ValueError, match="free slots"):
        eng.fork(req, 2)
    with pytest.raises(ValueError, match="seeds"):
        eng.fork(req, 1, seeds=[1, 2])
    dense = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                   paged=False)
    assert not dense.runner.prefix_cache
    r2 = dense.submit([1, 2, 3], 4)
    dense.step()
    with pytest.raises(ValueError, match="paged"):
        dense.fork(r2, 1)


# ---------------------------------------------------------------------------
# (d) random fork / copy-on-write / decode against a contiguous mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_random_fork_cow_decode_matches_contiguous_mirror(quantized, models):
    """Random allocate(tokens=) / append / commit / fork / free, every
    write gated by ``ensure_writable`` + ``copy_blocks`` and mirrored
    into a contiguous per-slot cache; after every op the invariants
    hold, and at the end every live slot's pool rows through its table
    (dequantized for int8) equal the mirror bitwise.  A decode step over
    the pools then equals one over the mirror: bitwise in fp; int8 to
    2e-2, as the reference, since the decode quantizes the new token's
    row on the paged side only."""
    _, cfg, _, params = models["pt"]
    B, S, bs = 4, 32, 8
    R, D, n = 2, 2, 4
    KH, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(11)
    for trial in range(3):
        kv = PagedKVCache(cfg, max_slots=B, max_seq_len=S, block_size=bs,
                          num_blocks=3 * B, device="cpu",
                          kv_dtype="int8" if quantized else None)
        leaves = kv.engine_cache()["blocks"]
        mirror = tuple(torch.zeros((R, D, n, B, S, KH, hd))
                       for _ in range(2))
        lengths = np.zeros((B,), np.int64)
        toks = [None] * B
        prompts = [rng.integers(1, 50, size=S).tolist() for _ in range(2)]

        def pool_rows(slot, upto):
            """[R, D, n, upto, KH, hd] of each leaf through the table."""
            blocks = torch.as_tensor(kv._blocks[slot][:kv.blocks_for(upto)])
            out = []
            for leaf in leaves:
                rows = leaf.pool[:, :, :, blocks].float()
                if leaf.scale is not None:
                    rows = dequantize_rows(rows, leaf.scale[:, :, :,
                                                            blocks])
                out.append(rows.reshape(R, D, n, -1, KH, hd)[:, :, :, :upto])
            return out

        def write(slot, lo, hi):
            kv.copy_blocks(kv.ensure_writable(slot, lo, hi))
            pos = torch.arange(lo, hi)[None]
            idx = token_to_pool(kv.table_rows([slot]), pos, bs)[0]
            for leaf, m in zip(leaves, mirror):
                new = torch.as_tensor(rng.normal(
                    size=(R, D, n, hi - lo, KH, hd)), dtype=torch.float32)
                if quantized:
                    new = dequantize_rows(*quantize_rows(new))
                for r in range(R):
                    for j in range(D):
                        pool_write(leaf[r, j], new[r, j], idx)
                m[:, :, :, slot, lo:hi] = new
            if quantized:
                # mirror what the pool dequantizes to (a requantization
                # may move a scale by an ulp): read back, do not predict
                for m, rows in zip(mirror, pool_rows(slot, hi)):
                    m[:, :, :, slot, lo:hi] = rows[:, :, :, lo:hi]

        for op in range(30):
            slot = int(rng.integers(B))
            u = rng.random()
            if u < 0.2 and lengths[slot]:
                kv.free_slot(slot)
                lengths[slot] = 0
                toks[slot] = None
            elif u < 0.35 and lengths[slot]:
                free = [d for d in range(B) if lengths[d] == 0]
                if free and kv.fork_cost(slot) <= kv.free_blocks:
                    dst = free[0]
                    kv.fork(slot, dst)
                    for m in mirror:
                        m[:, :, :, dst] = m[:, :, :, slot]
                    lengths[dst] = lengths[slot]
                    toks[dst] = list(toks[slot])
                    # the uncommitted tail took fresh blocks: the engine
                    # rewrites those positions before any read; so here
                    shared = min(kv.blocks_for(kv.committed(slot)) * bs,
                                 int(lengths[dst]))
                    if shared < lengths[dst]:
                        write(dst, shared, int(lengths[dst]))
            elif lengths[slot] == 0:
                ids = list(prompts[int(rng.integers(2))])
                L = int(rng.integers(2, S // 2))
                if kv.can_allocate(L, tokens=ids[:L]):
                    matched = kv.allocate(slot, L, tokens=ids[:L])
                    toks[slot] = ids[:L]
                    if matched:
                        # the cached prefix is in the pool already
                        for m, rows in zip(mirror, pool_rows(slot, matched)):
                            m[:, :, :, slot, :matched] = rows
                    write(slot, matched, L)
                    kv.commit_tokens(slot, toks[slot])
                    lengths[slot] = L
            else:
                lo = int(lengths[slot])
                hi = int(min(S - 1, lo + rng.integers(1, bs + 1)))
                if kv.blocks_for(hi) - len(kv._blocks[slot]) \
                        <= kv.free_blocks:
                    kv.append(slot, hi)
                    toks[slot] = (toks[slot] + [0] * hi)[:hi]
                    write(slot, lo, hi)
                    lengths[slot] = hi
            kv.check_invariants()

        # the decode writes each live slot's new row at pos: the engine's
        # copy-on-write gate first, as Engine.step runs it
        for slot in range(B):
            if lengths[slot]:
                kv.copy_blocks(kv.ensure_writable(
                    slot, int(lengths[slot]) - 1, int(lengths[slot])))
        kv.check_invariants()
        live = lengths > 0
        assert live.any()
        for slot in np.flatnonzero(live):
            L = int(lengths[slot])
            for m, rows in zip(mirror, pool_rows(slot, L)):
                assert torch.equal(rows, m[:, :, :, slot, :L])
        pos = torch.as_tensor(np.maximum(lengths, 1) - 1, dtype=torch.int32)
        tok = torch.as_tensor(rng.integers(1, 64, size=B))
        contiguous = {"blocks": tuple(m.clone() for m in mirror),
                      "tail": ()}
        out_c, _ = track.pt_decode_step(params, contiguous, tok, pos, cfg)
        out_p, _ = track.pt_decode_step(params, kv.engine_cache(), tok, pos,
                                        cfg, block_table=kv.table())
        if quantized:
            np.testing.assert_allclose(out_p[live], out_c[live], rtol=2e-2,
                                       atol=2e-2)
        else:
            assert torch.equal(out_p[live], out_c[live])


# ---------------------------------------------------------------------------
# (e) pipelined = sync, (f) falcon-mamba, (g) copy-on-write out of blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [{}, {"speculate_k": 3,
                                        "draft_tracks": 2}],
                         ids=["decode", "spec"])
def test_pipelined_warm_hits_and_forks_equal_sync(knobs, models):
    _, cfg, _, params = models["pt"]
    sync = _scenario(Engine(cfg, params, device="cpu", **ENGINE, **knobs),
                     SampleParams)
    eng = Engine(cfg, params, device="cpu", pipeline_depth=1, preplan=True,
                 **ENGINE, **knobs)
    piped = _scenario(eng, SampleParams)
    assert piped == sync
    assert eng.runner.planned_hits == eng.runner.decode_transfers > 0
    assert eng.metrics.steps_in_flight == 2
    # the programs of the live lengths the scenario takes, and no other
    eng = Engine(cfg, params, device="cpu", pipeline_depth=1, **ENGINE,
                 **knobs)
    r, lengths = eng.runner, range(15, ENGINE["max_seq_len"] + 1)
    assert r.plan_programs(lengths=lengths) == len(
        r._program_keys(lengths)) < len(r._program_keys())
    assert _scenario(eng, SampleParams) == sync
    assert r.planned_hits == r.decode_transfers > 0


def test_falcon_mamba_has_no_prefix_cache_and_forks_its_state_rows():
    from repro_torch.models.decoder import init_lm
    cfg = reduced_config("falcon-mamba-7b")
    params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = Engine(cfg, params, device="cpu", max_slots=4, max_seq_len=40,
                 block_size=4)
    r = eng.runner
    assert not r.prefix_cache and not r.kv.prefix_cache
    assert r.capabilities["prefix_cache"].reason.startswith("recurrent")
    prompt = list(range(3, 15))
    eng.generate([prompt], 4)
    again = eng.submit(prompt, 10)
    for _ in range(3):
        eng.step()
    assert again.cached_prefix == 0 and r.kv.prefix_hit_tokens == 0
    kids = eng.fork(again, 2)
    assert [k.cached_prefix for k in kids] == [len(prompt) + 3] * 2
    eng.run()
    assert kids[0].output == kids[1].output == again.output
    assert len(again.output) == 10
    r.kv.check_invariants()


def test_cow_out_of_blocks_raises_item_8_and_leaves_the_cache(models):
    """A fork that takes every block of the pool (its children share the
    parent's blocks, partial block included); the next decode's
    copy-on-write finds no free block.  Where the port raised item 8's
    NotImplementedError before the robustness layer, it now preempts as
    the reference does: the writer evicts the child (equal priority, the
    newest), whose release leaves the partial block the writer's alone,
    so no copy is needed; the child resumes once the parent is done.
    Streams, preemptions, copies and events equal the JAX engine's."""
    def run(engine_cls, cfg, params, **kw):
        eng = engine_cls(cfg, params, max_slots=2, max_seq_len=16,
                         block_size=4, num_blocks=2, **kw)
        events = []
        req = eng.submit([1, 2, 3, 4, 5, 6], 3,        # 8 positions: 2
                         on_event=lambda r, why: events.append(why))
        eng.step()
        kids = eng.fork(req, 1)
        kv = eng.runner.kv
        assert kv.free_blocks == 0 and kv.refcount(kv._blocks[0][1]) == 2
        eng.step()
        assert kids[0].state.value == "queued"
        eng.run()
        kv.check_invariants()
        return {"streams": [req.output, kids[0].output],
                "states": [req.state.value, kids[0].state.value],
                "preemptions": [req.preemptions, kids[0].preemptions],
                "cow": kv.cow_copies, "events": events,
                "used": kv.utilization()["used_blocks"]}

    jcfg, cfg, jparams, params = models["pt"]
    got = run(Engine, cfg, params, device="cpu")
    assert got == run(JEngine, jcfg, jparams)
    assert got["preemptions"] == [0, 1] and got["states"] == ["done"] * 2
    assert got["streams"][0] == got["streams"][1] and got["used"] == 0
