"""The port's serving robustness layer on the CPU: preempt-and-recompute
under block exhaustion, priorities, deadlines and cancellation, terminal
states delivered through ``on_event``, the bounded queue, the stall
watchdog and the deterministic ``FaultPlan`` (allocation faults,
transfer faults, slow steps).

  * the behaviour of each test of ``tests/test_robustness.py`` on the
    port, on the same one-layer ``_tiny_cfg`` and reduced tinyllama, the
    parameters the JAX package's initialisers draw, loaded with
    ``weights.from_jax_params`` (the reference's model-free stub runner
    becomes the tiny model, whose steps take milliseconds here too);
  * the port's own cases: a synchronous transfer fault frees the step's
    staging slot, and the retry recomputes the step bitwise; a fork
    short of blocks preempts a lower-priority decoder; deadlines are
    refused on track ranks (item 7f);
  * cross-checks: the reference ``Engine`` and the port's
    ``Engine(device="cpu")`` driven through one script (submissions of
    mixed priorities and deadlines, ``step()`` calls, cancels, a small
    pool, a bounded queue and one ``FaultPlan`` seed of allocation,
    transfer and slow faults), sync and pipelined, plain (the tiny
    model) and speculative (a small 4-track PT config): per request the
    state, ``finish_reason``, output, ``preemptions`` and
    ``cached_prefix``, every ``on_event`` call, the robustness metrics, ``plan.events``,
    ``plan.transfer_sites``, ``steps_run`` and the pool equal, both
    invariant checks holding.  The clock both engines read is one fake
    clock patched over each engine module's ``time`` (it moves only when
    a slow step sleeps or the script advances it), so that deadlines,
    the step-time EMA and the victims' order are the same decisions in
    both; the JAX pipelined engine gets copies of its host arrays
    (``_CopyingJnp``, ROADMAP §3).  Each JAX engine runs once, in the
    module fixture ``jax_runs``.
"""
import functools
import time as real_time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import LayerSpec as JLayerSpec
from repro.common.types import ModelConfig as JModelConfig
from repro.configs import reduced_config as j_reduced_config
from repro.launch import steps as jsteps
from repro.serving import engine as jengine
from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch.common.types import LayerSpec, ModelConfig
from repro_torch.configs import reduced_config
from repro_torch.runtime.parallel import Parallelism
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Engine, EngineStallError, RequestState
from repro_torch.serving.faults import FaultPlan
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


def _tiny_kw():
    """The reference test's one-layer toy model: cheap engine chaos."""
    return dict(name="robust-test", family="dense", n_layers=1, d_model=16,
                n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=64,
                pattern_unit=("full",), tie_embeddings=False,
                dtype="float32")


@functools.lru_cache(maxsize=None)
def _model(name: str):
    """(JAX config, port config, JAX tree, port tree): the JAX package's
    initialiser draws the tree (key 0), the port loads it."""
    if name == "tiny":
        jcfg = JModelConfig(layer_specs={"full": JLayerSpec(
            mixer="gqa", mlp="swiglu")}, **_tiny_kw())
        cfg = ModelConfig(layer_specs={"full": LayerSpec(
            mixer="gqa", mlp="swiglu")}, **_tiny_kw())
    else:
        jcfg, cfg = j_reduced_config(name), reduced_config(name)
    jparams = jax.jit(lambda k: jsteps.model_fns(jcfg)["init"](k, jcfg))(
        jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _tiny_engine(**kw):
    _, cfg, _, params = _model("tiny")
    return cfg, Engine(cfg, params, device="cpu", **kw)


def _tinyllama_engine(**kw):
    _, cfg, _, params = _model("tinyllama-1.1b")
    return cfg, Engine(cfg, params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# validation and overload shedding: REJECTED through on_event, never raised
# ---------------------------------------------------------------------------

def test_submit_rejects_invalid_requests_without_raising():
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8)
    events = []
    cb = lambda r, why: events.append((r.rid, why))
    bad = [eng.submit([], 4, on_event=cb),
           eng.submit([1, 2, 3], 0, on_event=cb),
           eng.submit([1] * 40, 4, on_event=cb)]
    for req in bad:
        assert req.state is RequestState.REJECTED
        assert req.finished and req.finish_reason
    assert "empty prompt" in bad[0].finish_reason
    assert "max_new_tokens" in bad[1].finish_reason
    assert "exceeds engine capacity" in bad[2].finish_reason
    assert [rid for rid, _ in events] == [r.rid for r in bad]
    assert not eng.scheduler.has_work()
    eng.run()                          # nothing queued, returns at once
    assert eng.metrics.summary()["rejected"] == 3


def test_bounded_queue_sheds_overload():
    cfg, eng = _tiny_engine(max_slots=1, max_seq_len=32, block_size=8,
                            max_queue=2)
    reqs = [eng.submit([1, 2, 3, 4], 4) for _ in range(4)]
    shed = [r for r in reqs if r.state is RequestState.REJECTED]
    assert len(shed) == 2 and all("overload shed" in r.finish_reason
                                  for r in shed)
    m = eng.metrics.summary()
    assert m["shed"] == 2
    assert m["rejected"] == 0          # shed is counted separately
    eng.run()
    assert all(r.state is RequestState.DONE for r in reqs[:2])


# ---------------------------------------------------------------------------
# cancellation and deadlines
# ---------------------------------------------------------------------------

def test_cancel_queued_and_decoding_reclaims_blocks():
    cfg, eng = _tiny_engine(max_slots=1, max_seq_len=32, block_size=8)
    a = eng.submit([1, 2, 3, 4, 5], 8)
    b = eng.submit([6, 7, 8, 9], 8)
    eng.step()                         # a decoding, b queued behind it
    assert a.state is RequestState.DECODE
    assert b.state is RequestState.QUEUED
    assert eng.cancel(b) and b.state is RequestState.CANCELLED
    assert eng.cancel(a) and a.state is RequestState.CANCELLED
    assert not eng.cancel(a)           # already terminal
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0
    assert not eng.scheduler.has_work()
    assert eng.metrics.summary()["cancelled"] == 2


def test_cancel_from_streaming_callback_mid_step():
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8)

    def stop_after_two(req, tok):
        if len(req.output) >= 2:
            eng.cancel(req, "client disconnected")

    a = eng.submit([1, 2, 3], 16, on_token=stop_after_two)
    b = eng.submit([4, 5, 6], 4)
    eng.run()
    assert a.state is RequestState.CANCELLED
    assert a.finish_reason == "client disconnected"
    assert len(a.output) == 2
    assert b.state is RequestState.DONE and len(b.output) == 4
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0


def test_deadline_times_out_queued_and_active_requests():
    cfg, eng = _tiny_engine(max_slots=1, max_seq_len=32, block_size=8)
    events = []
    late = eng.submit([1, 2, 3], 8, deadline_s=0.0,
                      on_event=lambda r, why: events.append(why))
    live = eng.submit([4, 5, 6], 8)
    eng.step()                         # expires `late` before admission
    assert late.state is RequestState.TIMED_OUT
    assert "deadline" in late.finish_reason and "deadline" in events[0]
    assert live.state is RequestState.DECODE
    live.deadline_s = 1e-9             # now expire a decoding request
    eng.step()
    assert live.state is RequestState.TIMED_OUT
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0
    assert eng.metrics.summary()["timed_out"] == 2


# ---------------------------------------------------------------------------
# preempt-and-recompute
# ---------------------------------------------------------------------------

def test_admission_preempts_lower_priority_and_both_finish():
    """The pool holds one request at a time: a higher-priority submission
    evicts the decoding request, which resumes by recompute after the
    intruder finishes; both complete, the blocks all come back, and the
    victim's stream is the one it emits uncontended."""
    cfg, eng = _tinyllama_engine(max_slots=2, max_seq_len=48, block_size=8,
                                 num_blocks=4)   # 3 usable: one at a time
    rng = np.random.default_rng(3)
    events = []
    vprompt = rng.integers(1, cfg.vocab_size, 16).tolist()
    victim = eng.submit(vprompt, 6, priority=0,
                        on_event=lambda r, why: events.append(why))
    for _ in range(3):
        eng.step()                     # victim decodes a few tokens
    assert victim.state is RequestState.DECODE
    assert len(victim.output) >= 1
    iprompt = rng.integers(1, cfg.vocab_size, 16).tolist()
    intruder = eng.submit(iprompt, 6, priority=1)
    eng.run()
    assert victim.state is RequestState.DONE
    assert intruder.state is RequestState.DONE
    assert victim.preemptions == 1
    assert any("preempted" in why for why in events)
    m = eng.metrics.summary()
    assert m["preemptions"] == 1 and m["resumes"] >= 1
    assert len(victim.output) == 6 and len(intruder.output) == 6
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0
    _, alone = _tinyllama_engine(max_slots=2, max_seq_len=48, block_size=8)
    assert alone.generate([vprompt, iprompt], 6) == [victim.output,
                                                     intruder.output]


def test_equal_priority_never_preempted_on_admission():
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8,
                            num_blocks=3)  # 2 usable
    a = eng.submit([1, 2, 3, 4, 5, 6], 8)  # 2 blocks: fills the pool
    eng.step()
    assert a.state is RequestState.DECODE
    b = eng.submit([7, 8, 9], 8)           # same priority: waits
    eng.run()
    assert eng.metrics.summary()["preemptions"] == 0
    assert a.state is RequestState.DONE and b.state is RequestState.DONE


def test_preemption_cap_rejects_instead_of_livelock():
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8,
                            num_blocks=3, max_preemptions=0)
    victim = eng.submit([1, 2, 3, 4, 5, 6], 8, priority=0)
    eng.step()
    assert victim.state is RequestState.DECODE
    eng.submit([7, 8, 9, 10, 11, 12], 8, priority=1)
    eng.run()
    assert victim.state is RequestState.REJECTED
    assert "gave up" in victim.finish_reason
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0


def test_fork_short_of_blocks_preempts_a_lower_priority_decoder():
    """Where the port raised MemoryError before, a fork short of blocks
    evicts a strictly lower-priority decoder first; with none it still
    raises, the cache whole.  The victim resumes to its own stream."""
    def pair():
        cfg, eng = _tiny_engine(max_slots=3, max_seq_len=32, block_size=4,
                                num_blocks=6)     # two 3-block requests
        low = eng.submit([1, 2, 3, 4, 5], 8, priority=0)
        high = eng.submit([6, 7, 8, 9, 10], 8, priority=1)
        eng.step()
        assert low.state is high.state is RequestState.DECODE
        assert eng.runner.kv.free_blocks == 0
        return eng, low, high

    eng, low, high = pair()
    with pytest.raises(MemoryError, match="fork needs 1 blocks, free 0"):
        eng.fork(low, 1)               # no one of lower priority to evict
    eng.runner.kv.check_invariants()
    assert low.state is RequestState.DECODE and low.preemptions == 0
    eng.run()
    eng2, low2, high2 = pair()
    kids = eng2.fork(high2, 1)         # low2 is evicted first
    assert low2.state is RequestState.QUEUED and low2.preemptions == 1
    eng2.run()
    assert all(r.state is RequestState.DONE
               for r in [low, high, low2, high2] + kids)
    assert (low2.output, high2.output, kids[0].output) == (
        low.output, high.output, high.output)
    assert eng2.metrics.summary()["resumes"] == 1
    eng2.runner.kv.check_invariants()
    assert eng2.runner.kv.utilization()["used_blocks"] == 0


# ---------------------------------------------------------------------------
# the stall watchdog and run()'s diagnostics
# ---------------------------------------------------------------------------

def test_watchdog_rejects_head_with_diagnostic_under_alloc_faults():
    """Every allocation faulting means admission never progresses; the
    watchdog sheds the head with a diagnostic instead of spinning."""
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8,
                            watchdog_patience=3,
                            fault_plan=FaultPlan(alloc_p=1.0))
    req = eng.submit([1, 2, 3, 4], 4)
    eng.run(max_steps=50)              # drains: the head is shed
    assert req.state is RequestState.REJECTED
    assert "watchdog" in req.finish_reason
    assert "queued=" in req.finish_reason     # the stall summary
    assert eng.metrics.summary()["watchdog_fires"] >= 1
    assert not eng.scheduler.has_work()


def test_run_raises_stall_error_with_diagnostic():
    """A transfer-fault storm the watchdog cannot fix surfaces as
    EngineStallError from run(), the snapshot attached, unless the
    caller passes allow_incomplete."""
    cfg, eng = _tiny_engine(max_slots=1, max_seq_len=32, block_size=8,
                            watchdog_patience=10_000,
                            fault_plan=FaultPlan(transfer_p=1.0))
    req = eng.submit([1, 2, 3], 4)
    with pytest.raises(EngineStallError) as ei:
        eng.run(max_steps=20)
    diag = ei.value.diagnostic
    assert diag["queued"] + diag["active_prefill"] >= 1
    assert diag["transfer_faults"] > 0
    assert "free_blocks" in diag
    assert not req.finished            # intact: retry is still possible
    eng.run(max_steps=20, allow_incomplete=True)   # silent variant
    assert eng.metrics.summary()["transfer_faults"] > 0


# ---------------------------------------------------------------------------
# fault injection: determinism and bitwise transparency
# ---------------------------------------------------------------------------

def _tinyllama_run(plan, depth=0, **kw):
    _, cfg, _, _ = _model("tinyllama-1.1b")
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, cfg.vocab_size, 12).tolist()
    _, eng = _tinyllama_engine(max_slots=2, max_seq_len=32, block_size=8,
                               fault_plan=plan, pipeline_depth=depth, **kw)
    req = eng.submit(prompt, 8)
    eng.run()
    return req, eng


def test_transfer_faults_are_bitwise_transparent():
    """Injected transfer faults on the prefill and mid-decode retry the
    step next tick; the greedy stream equals the fault-free run's."""
    ref, _ = _tinyllama_run(None)
    assert ref.state is RequestState.DONE
    # op 0 is the prefill transfer; later ops are decode steps
    plan = FaultPlan(transfer_ops=frozenset({0, 2, 5}))
    faulted, eng = _tinyllama_run(plan)
    assert faulted.state is RequestState.DONE
    assert faulted.output == ref.output
    assert eng.metrics.summary()["transfer_faults"] == 3
    assert [s for s, _ in plan.events] == ["transfer"] * 3
    eng.runner.kv.check_invariants()


def test_sync_transfer_fault_frees_the_stage_and_recomputes():
    """A synchronous step whose transfer faults leaves no busy staging
    slot (the next tick's dispatch would raise 'more steps in flight'):
    the step is dropped, its lanes' host values are authoritative again,
    and the recompute writes the same K/V bytes, so the stream and the
    pool equal the fault-free run's, every step of the same length."""
    plain, eng0 = _tinyllama_run(None)
    plan = FaultPlan(transfer_ops=frozenset({1, 2, 4}))   # decode waits
    faulted, eng = _tinyllama_run(plan)
    r = eng.runner
    assert faulted.output == plain.output
    assert [lbl for _, lbl in plan.transfer_sites] == ["decode"] * 3
    assert not any(st.busy for st in r._stages) and not eng._inflight
    assert (eng._ahead == 0).all()
    assert eng.steps_run == eng0.steps_run + 3
    assert r.decode_transfers == eng0.runner.decode_transfers
    for a, b in zip(r.kv.data, eng0.runner.kv.data):
        assert torch.equal(a, b)


def test_fault_plan_schedule_is_deterministic():
    def drive(cls, seed):
        plan = cls(seed=seed, alloc_p=0.3, transfer_p=0.3, slow_p=0.3,
                   slow_s=0.0)
        for _ in range(30):
            plan.take_alloc()
            plan.take_transfer()
            plan.take_slow()
        return list(plan.events)

    assert drive(FaultPlan, 7) == drive(FaultPlan, 7)
    assert drive(FaultPlan, 7) != drive(FaultPlan, 8)
    # the port's copy draws the reference's schedule
    assert drive(FaultPlan, 7) == drive(JFaultPlan, 7)
    plan = FaultPlan(seed=7, alloc_p=1.0, max_faults=2)
    assert [plan.take_alloc() for _ in range(5)] == [True, True, False,
                                                     False, False]
    assert plan.summary()["injected"] == 2
    assert plan.summary()["alloc_calls"] == 5


def test_slow_step_injection_drives_deadlines():
    cfg, eng = _tiny_engine(max_slots=1, max_seq_len=32, block_size=8,
                            fault_plan=FaultPlan(slow_p=1.0, slow_s=0.02))
    req = eng.submit([1, 2, 3], 16, deadline_s=0.01)
    eng.run()
    assert req.state is RequestState.TIMED_OUT
    assert eng.faults.slow_calls > 0


# ---------------------------------------------------------------------------
# chaos: block exhaustion and mixed faults, everything still terminates
# ---------------------------------------------------------------------------

def test_every_request_terminates_under_block_exhaustion_chaos():
    """An oversubscribed pool, mixed priorities, a bounded fault storm and
    cancels mid-flight: every request ends in exactly one terminal
    state, the invariants hold throughout and the pool ends empty."""
    cfg, eng = _tiny_engine(
        max_slots=3, max_seq_len=32, block_size=8, num_blocks=8,
        max_queue=16, watchdog_patience=8, max_preemptions=2,
        fault_plan=FaultPlan(seed=5, alloc_p=0.15, transfer_p=0.1,
                             max_faults=6))
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(10):
        reqs.append(eng.submit(
            rng.integers(1, cfg.vocab_size,
                         int(rng.integers(2, 14))).tolist(),
            int(rng.integers(1, 8)), priority=int(rng.integers(0, 3)),
            deadline_s=None if i % 4 else 5.0))
        if i == 6:
            eng.cancel(reqs[2])
        eng.step()
        eng.runner.kv.check_invariants()
    eng.run(max_steps=2000, allow_incomplete=True)
    assert all(r.finished for r in reqs), \
        [(r.rid, r.state) for r in reqs if not r.finished]
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0
    m = eng.metrics.summary()
    done = sum(r.state is RequestState.DONE for r in reqs)
    assert done == m["requests"]
    assert (done + m["rejected"] + m["shed"] + m["cancelled"]
            + m["timed_out"]) == len(reqs)


# ---------------------------------------------------------------------------
# steps in flight (the pipelined loop)
# ---------------------------------------------------------------------------

def test_pipelined_transfer_fault_bounces_completing_step():
    """With steps in flight, a transfer fault surfaces at the WAIT on the
    completing step, one step after its dispatch.  The retry re-reads
    the same result, so the stream is bitwise the fault-free run's."""
    ref, _ = _tinyllama_run(None)
    plan = FaultPlan(transfer_ops=frozenset({2, 5}))
    faulted, eng = _tinyllama_run(plan, 1, preplan=True)
    assert faulted.state is RequestState.DONE
    assert faulted.output == ref.output
    assert eng.metrics.summary()["transfer_faults"] == 2
    # both faults fired at the decode WAIT site, never at dispatch
    assert [lbl for _, lbl in plan.transfer_sites] == ["decode"] * 2
    eng.runner.kv.check_invariants()
    assert not eng._inflight
    r = eng.runner
    assert r.planned_hits == r.decode_transfers > 0


def test_cancel_discards_in_flight_emission():
    """Cancelling a request whose next step is already dispatched drops
    that step's emission for it: the output ends where the cancel saw
    it, and the pool returns to empty."""
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8,
                            num_blocks=32, pipeline_depth=1)
    req = eng.submit([1, 2, 3], 16)
    other = eng.submit([4, 5, 6], 6)
    for _ in range(3):
        eng.step()
    assert req.state is RequestState.DECODE
    assert len(eng._inflight) == 1      # req's next token is in flight
    seen = len(req.output)
    assert eng.cancel(req)
    assert eng._ahead[0] == 0
    eng.run()
    assert req.state is RequestState.CANCELLED
    assert len(req.output) == seen      # in-flight emission discarded
    assert other.state is RequestState.DONE
    assert len(other.output) == 6       # bystander unaffected
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0


def test_deadline_expiry_discards_in_flight_emission():
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=40, block_size=8,
                            num_blocks=32, pipeline_depth=1)
    req = eng.submit([1, 2, 3], 32, deadline_s=0.5)
    for _ in range(3):
        eng.step()
    assert req.state is RequestState.DECODE
    assert len(eng._inflight) == 1
    seen = len(req.output)
    real_time.sleep(0.55)              # deadline passes mid-flight
    eng.run(max_steps=50, allow_incomplete=True)
    assert req.state is RequestState.TIMED_OUT
    assert len(req.output) == seen     # in-flight emission discarded
    eng.runner.kv.check_invariants()
    assert eng.runner.kv.utilization()["used_blocks"] == 0


def test_watchdog_counts_in_flight_steps_as_progress():
    """A step that only DISPATCHES (the pipeline still filling) is
    progress: the watchdog must not fire on work the device is already
    running, even at patience 1."""
    cfg, eng = _tiny_engine(max_slots=2, max_seq_len=32, block_size=8,
                            num_blocks=32, pipeline_depth=2,
                            watchdog_patience=1)
    reqs = [eng.submit([i + 1] * 3, 6) for i in range(3)]
    eng.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    assert eng.metrics.watchdog_fires == 0


def test_deadline_on_track_ranks_raises_item_7f():
    """Each rank would read its own clock: deadlines are refused there,
    naming ROADMAP item 7f; the rest of the layer is deterministic."""
    from repro_torch.configs.pt_paper import reduced_pt
    from repro_torch.launch.steps import model_fns
    cfg = reduced_pt(2)
    params = model_fns(cfg)["init"](torch.Generator().manual_seed(0), cfg,
                                    "cpu")
    eng = Engine(cfg, params, device="cpu", max_slots=2, max_seq_len=32,
                 block_size=4, par=Parallelism("stand-in", 0, 2))
    with pytest.raises(NotImplementedError, match="item 7f"):
        eng.submit([1, 2, 3], 4, deadline_s=1.0)
    req = eng.submit([1, 2, 3], 4, priority=2, on_event=lambda r, w: None)
    assert req.state is RequestState.QUEUED and eng.cancel(req)


# ---------------------------------------------------------------------------
# cross-checks against the reference engine
# ---------------------------------------------------------------------------

class _Clock:
    """The one clock both engines read: ``perf_counter`` and ``time``
    return ``t``, which moves only when an injected slow step sleeps or
    the script advances it."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy argument first: on
    the CPU backend ``jnp.asarray`` can alias a 64-byte-aligned numpy
    array that the JAX pipelined engine then updates in place while the
    next step's carry may still read it (ROADMAP §3)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return jnp.asarray(x.copy() if isinstance(x, np.ndarray) else x,
                           *args, **kwargs)


# arm -> (model, engine knobs); every arm runs _script
CROSS = {"sync": ("tiny", {}),
         "pipelined": ("tiny", {"pipeline_depth": 1}),
         "spec sync": ("small pt", {"speculate_k": 2, "draft_tracks": 2}),
         "spec pipelined": ("small pt", {"speculate_k": 2,
                                         "draft_tracks": 2,
                                         "pipeline_depth": 1})}
CROSS_ENGINE = dict(max_slots=3, max_seq_len=32, block_size=4, num_blocks=13,
                    min_bucket=32, max_queue=4, watchdog_patience=5,
                    max_preemptions=2)
CROSS_PLAN = dict(seed=3, alloc_p=0.15, transfer_p=0.12, slow_p=0.3,
                  slow_s=0.05)


def _script(engine_cls, plan_cls, cfg, params, knobs, clock) -> dict:
    """Two low-priority requests fill most of the pool; a burst of seven
    past ``max_queue`` (two shed) whose head, of priority 2, needs more
    blocks than are free and preempts the newer one, one of them with a
    deadline the admission estimate rejects, another given a short one
    after its admission (it times out); a cancel of the last request still queued
    and, three steps on, of the first decoding; a deadline unmeetable at
    the load the step-time EMA has seen; then the run to the end.
    Returns everything the decisions show."""
    plan = plan_cls(**CROSS_PLAN)
    kw = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(cfg, params, fault_plan=plan, **CROSS_ENGINE, **knobs,
                     **kw)
    events = []
    rng = np.random.default_rng(17)
    reqs = []

    def submit(n, new, priority, deadline=None):
        reqs.append(eng.submit(
            rng.integers(1, cfg.vocab_size, n).tolist(), new,
            priority=priority, deadline_s=deadline,
            on_event=lambda r, why: events.append((r.rid, why))))
        clock.t += 0.001

    def steps(k):
        for _ in range(k):
            eng.step()
            eng.runner.kv.check_invariants()

    def first(state, order=1):  # either package's RequestState
        return next(r for r in reqs[::order] if r.state.value == state)

    submit(9, 10, 0)                   # 18 positions: 5 blocks
    submit(11, 10, 0)                  # 20: 5 blocks, 3 of 13 left
    steps(3)
    for n, new, pri, dl in ((12, 8, 2, None), (6, 4, 0, 0.08), (5, 6, 1, None),
                            (4, 6, 1, None), (10, 3, 0, None),
                            (6, 4, 1, None), (7, 4, 0, None)):
        submit(n, new, pri, dl)
    reqs[4].deadline_s = 0.02          # past the admission estimate
    steps(2)
    eng.cancel(first("queued", -1), "client went away")
    steps(3)
    eng.cancel(first("decode"))
    steps(2)
    submit(8, 9, 0, 0.01)              # unmeetable at this load
    submit(5, 5, 2, 3.0)
    eng.run(max_steps=600, allow_incomplete=True)
    eng.runner.kv.check_invariants()
    m = eng.metrics.summary()
    keys = ("requests", "rejected", "shed", "cancelled", "timed_out",
            "preemptions", "resumes", "watchdog_fires", "transfer_faults")
    return {"requests": [(r.rid, r.state.value, r.finish_reason, r.output,
                          r.preemptions, r.cached_prefix) for r in reqs],
            "events": events, "metrics": {k: m[k] for k in keys},
            "plan": (list(plan.events), list(plan.transfer_sites),
                     plan.summary()),
            "steps_run": eng.steps_run,
            "pool": eng.runner.kv.utilization()["used_blocks"],
            "capabilities": eng.capabilities()}


def _cross_model(name: str):
    """The tiny model, or a small 4-track PT config (4 layers, D = 2, d
    32) for the speculative arms: on the CPU the JAX engine's speculative
    step at ``reduced_pt`` takes ~1 s, five times the whole file's budget
    over a run."""
    if name == "tiny":
        return _model("tiny")
    from repro.core import track as jtrack
    from repro_torch.core import track
    kw = dict(name="pt-robust-test", family="dense", n_layers=4, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
              pattern_unit=("full",), tie_embeddings=False, dtype="float32")
    jcfg = jtrack.pt_ify(JModelConfig(
        layer_specs={"full": JLayerSpec(mixer="gqa", mlp="swiglu")}, **kw),
        4, 2, width_mult=8)
    cfg = track.pt_ify(ModelConfig(
        layer_specs={"full": LayerSpec(mixer="gqa", mlp="swiglu")}, **kw),
        4, 2, width_mult=8)
    jparams = jax.jit(lambda k: jtrack.init_pt(k, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _cross_models():
    return {name: _cross_model(name) for name in ("tiny", "small pt")}


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "jnp", _CopyingJnp())
        for arm, (name, knobs) in CROSS.items():
            jcfg, _, jparams, _ = _cross_models()[name]
            clock = _Clock()
            mp.setattr(jengine, "time", clock)
            out[arm] = _script(jengine.Engine, JFaultPlan, jcfg, jparams,
                               knobs, clock)
    return out


@pytest.mark.parametrize("arm", list(CROSS))
def test_decisions_match_the_reference_engine(arm, jax_runs, monkeypatch):
    name, knobs = CROSS[arm]
    _, cfg, _, params = _cross_models()[name]
    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    got = _script(Engine, FaultPlan, cfg, params, knobs, clock)
    want = jax_runs[arm]
    for key in ("plan", "steps_run", "metrics", "events", "requests",
                "pool", "capabilities"):
        assert got[key] == want[key], (arm, key)
    # the script did what it is for: every kind of fault and decision
    m, states = got["metrics"], {r[1] for r in got["requests"]}
    fs = got["plan"][2]
    assert fs["alloc_faults"] and fs["transfer_faults"] and fs["slow_steps"]
    assert m["preemptions"] and m["resumes"] and m["cancelled"] == 2
    assert m["timed_out"] and m["shed"] and m["rejected"]
    assert {"done", "rejected", "cancelled", "timed_out"} <= states
    assert got["pool"] == 0


def _fork_fault_script(engine_cls, plan_cls, cfg, params, clock,
                       num_blocks) -> dict:
    """A pipelined engine (depth 1) on a small pool: a priority-0 request
    and a priority-1 one decode; the latter is forked 2 ways (the
    children share its blocks); the very next transfer of the engine
    faults (back-pressure on the step in flight), then the run goes on
    under block pressure: copy-on-write copies and preemptions.  Returns
    every decision it shows."""
    plan = plan_cls()
    kw = {"device": "cpu"} if engine_cls is Engine else {}
    eng = engine_cls(cfg, params, fault_plan=plan, max_slots=4,
                     max_seq_len=32, block_size=4, num_blocks=num_blocks,
                     min_bucket=32, pipeline_depth=1, **kw)
    rng = np.random.default_rng(29)
    low = eng.submit(rng.integers(1, cfg.vocab_size, 7).tolist(), 10,
                     priority=0)
    parent = eng.submit(rng.integers(1, cfg.vocab_size, 10).tolist(), 12,
                        priority=1)
    for _ in range(3):
        eng.step()
        clock.t += 0.001
    kids = eng.fork(parent, 2)
    plan.transfer_ops = frozenset({plan.transfer_calls})
    eng.run(max_steps=300, allow_incomplete=True)
    eng.runner.kv.check_invariants()
    m = eng.metrics.summary()
    return {"requests": [(r.rid, r.state.value, r.finish_reason, r.output,
                          r.preemptions, r.cached_prefix)
                         for r in [low, parent] + kids],
            "cow_copies": eng.runner.kv.cow_copies,
            "plan": (list(plan.events), list(plan.transfer_sites)),
            "steps_run": eng.steps_run,
            "metrics": {k: m[k] for k in ("preemptions", "resumes",
                                          "transfer_faults")},
            "pool": eng.runner.kv.utilization()["used_blocks"]}


@pytest.mark.parametrize("num_blocks", [12, 14])
def test_fork_after_pipelined_transfer_fault_matches_reference(num_blocks,
                                                                monkeypatch):
    """Copy-on-write after a pipelined transfer fault: the port's ``_cow``
    runs at dispatch and skips lanes that finished in flight, the
    reference's every tick; on a fork that shares blocks, a transfer
    fault on the next step and a pool short of blocks, both engines take
    the same copies, preemptions, faults and end states."""
    jcfg, cfg, jparams, params = _model("tiny")
    runs = []
    for mod, eng_cls, plan_cls, p, c in (
            (jengine, jengine.Engine, JFaultPlan, jparams, jcfg),
            (engine_mod, Engine, FaultPlan, params, cfg)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        if mod is jengine:
            monkeypatch.setattr(jengine, "jnp", _CopyingJnp())
        runs.append(_fork_fault_script(eng_cls, plan_cls, c, p, clock,
                                       num_blocks))
    want, got = runs
    for key in want:
        assert got[key] == want[key], key
    assert got["cow_copies"] and got["metrics"]["transfer_faults"] == 1
    assert got["metrics"]["preemptions"] and got["pool"] == 0
    assert all(r[1] == "done" for r in got["requests"])
