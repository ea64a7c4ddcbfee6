"""The port's train path against the JAX package on the CPU: batches,
tree paths, blockwise attention, losses and grads, both optimizers,
clipping and the schedule, the train step, checkpoints across the two
packages, resume, the elastic helpers and the CLIs.  One parameter tree
from the reference's ``init_pt`` / ``init_lm`` (fixed key) is loaded
into both packages (``weights.from_jax_params``; a whole train state
through ``weights.from_jax_state``).

Tolerances (fp32):
- single ops (blockwise attention) 2e-5, as tests/test_kernels.py; its
  q-grads 2e-5 relative with 2e-4 absolute (grads of the outputs' sum
  of squares, entries up to ~3.4);
- losses 2e-5 relative; every grad leaf within 1e-4 x that leaf's max
  |g| (a few hundred fp32 products and sums, ordered differently by XLA
  and by PyTorch, against the size of the leaf's gradient);
- one optimizer update 1e-6 relative (elementwise fp32 arithmetic, op
  for op; XLA may contract a multiply-add and ``b ** t`` may differ in
  the last place);
- three train steps: losses 1e-5 relative; params within 2 x the sum of
  the steps' learning rates, and 99.9 % of every leaf within 1e-5:
  Adam moves a parameter by about lr whatever the size of its grad, so
  an element whose grad is within rounding of zero can take a step of
  the other sign in each package.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.common import pytree as jpytree
from repro.configs import reduced_config as j_reduced_config
from repro.core import track as jtrack
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import decoder as jdec
from repro import optim as joptim
from repro.runtime import elastic as jelastic
from repro_torch import optim
from repro_torch.checkpoint import store
from repro_torch.common import pytree
from repro_torch.configs import reduced_config
from repro_torch.core import track
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, decoder
from repro_torch.runtime.elastic import RetryPolicy, StragglerMonitor
from repro_torch.weights import from_jax_params, from_jax_state

OP_TOL = 2e-5
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a pytest-xdist worker (see test_torch_model)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _by_path(tree, torch_side: bool):
    if torch_side:
        return {p: _torch_np(l) for p, l in pytree.tree_paths(tree)}
    return {p: np.asarray(l) for p, l in jpytree.tree_paths(tree)}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        inp = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inp = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt[0, :3] = -1                       # padding is masked out
    return inp, tgt


ARCHS = ["pt-6b-d4", "dense-6b", "gemma2-2b", "nemotron-4-15b",
         "qwen2-vl-72b"]


@pytest.fixture(scope="module")
def ref():
    """Each reference program built once: per arch the JAX tree (numpy)
    and jax.value_and_grad of its loss on the arch's batch; the JAX
    train step on reduced PT over three data-pipeline batches at
    microbatches 1 and 2."""
    out = {}
    for arch in ARCHS:
        jcfg = j_reduced_config(arch)
        init = jtrack.init_pt if jcfg.pt else jdec.init_lm
        loss = jtrack.pt_loss if jcfg.pt else jdec.lm_loss
        jp = jax.jit(lambda k: init(k, jcfg))(jax.random.PRNGKey(0))
        inp, tgt = _batch(jcfg)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: loss(p, b, jcfg), has_aux=True))(
            jp, {"inputs": jnp.asarray(inp), "targets": jnp.asarray(tgt)})
        out[arch] = {"tree": _np(jp), "loss": float(jl),
                     "grads": _by_path(jg, False)}
    jcfg = j_reduced_config("pt-6b-d4")
    par = jsteps.build_parallelism(jcfg, "train", None)
    dcfg = jpipe.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                            global_batch=4, seed=1)
    out["step"] = {"batches": [jpipe.sample_batch(dcfg, s)
                               for s in range(3)]}
    jp = jax.tree_util.tree_map(jnp.asarray, out["pt-6b-d4"]["tree"])
    for mb in (1, 2):
        fn, opt_init, _ = jsteps.make_train_step(
            jcfg, par, microbatches=mb, peak_lr=3e-3, warmup=2,
            total_steps=3)
        fn = jax.jit(fn)
        p, st = jp, opt_init(jp)
        losses, lrs = [], []
        for b in out["step"]["batches"]:
            p, st, m = fn(p, st, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
        out["step"][mb] = {"losses": losses, "lrs": lrs,
                           "state": _by_path({"params": p, "opt": st},
                                             False)}
    return out


def _port(arch, ref, dtype=None):
    cfg = reduced_config(arch)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    return cfg, from_jax_params(ref[arch]["tree"], cfg, device="cpu")


# ---------------------------------------------------------------------------
# data, trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (11, 123456)])
def test_batches_bitwise_reference(seed, step):
    kw = dict(vocab_size=1000, seq_len=40, global_batch=3, seed=seed)
    got = pipeline.sample_batch(pipeline.DataConfig(**kw), step)
    want = jpipe.sample_batch(jpipe.DataConfig(**kw), step)
    for k in ("inputs", "targets"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    loader = pipeline.DataLoader(pipeline.DataConfig(**kw), start_step=step)
    assert np.array_equal(next(loader)["inputs"], want["inputs"])
    assert loader.step == step + 1


def test_tree_paths_and_norm_match_reference(ref):
    cfg, params = _port("gemma2-2b", ref)
    jtree = ref["gemma2-2b"]["tree"]
    got = [(p, tuple(l.shape)) for p, l in pytree.tree_paths(params)]
    want = [(p, l.shape) for p, l in jpytree.tree_paths(jtree)]
    assert got == want
    assert pytree.count_params(params) == jpytree.count_params(jtree)
    gn = pytree.global_norm(params)
    jgn = jpytree.global_norm(jax.tree_util.tree_map(jnp.asarray, jtree))
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    doubled = pytree.map_with_path(lambda p, l: (p, l.shape), params)
    assert doubled["unit"][0]["mixer"]["wq"][0] == "unit/0/mixer/wq"


# ---------------------------------------------------------------------------
# blockwise attention, losses, grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(window=12),
    dict(window=12, softcap=20.0), dict(dv=8), dict(q_start=16, Sq=16),
])
def test_blockwise_attention_matches_reference(case):
    rng = np.random.default_rng(4)
    Sq, Sk, H, hd = case.get("Sq", 48), 48, 4, 16
    dv = case.get("dv", hd)
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((2, Sk, H, dv)).astype(np.float32)
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              softcap=case.get("softcap"), q_start=case.get("q_start", 0),
              chunk_q=16, chunk_k=16)
    tq = torch.from_numpy(q).requires_grad_(True)
    out = attention.blockwise_attention(tq, torch.from_numpy(k),
                                        torch.from_numpy(v), **kw)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=OP_TOL, atol=OP_TOL)
    out.square().sum().backward()
    jgq = jax.grad(lambda a: jnp.sum(jnp.square(jattn.blockwise_attention(
        a, jnp.asarray(k), jnp.asarray(v), **kw))))(jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq),
                               rtol=OP_TOL, atol=OP_TOL * 10)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, ref):
    cfg, params = _port(arch, ref)
    inp, tgt = _batch(cfg)
    loss_fn = track.pt_loss if cfg.pt else decoder.lm_loss
    loss, grads = steps.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg), params,
        {"inputs": torch.from_numpy(inp), "targets": torch.from_numpy(tgt)})
    np.testing.assert_allclose(float(loss), ref[arch]["loss"],
                               rtol=LOSS_TOL)
    want = ref[arch]["grads"]
    got = dict(pytree.tree_paths(grads))
    assert sorted(got) == sorted(want)
    for p, g in got.items():
        scale = max(float(np.abs(want[p]).max()), 1e-30)
        err = float(np.abs(g.numpy() - want[p]).max())
        assert err <= GRAD_TOL * scale, (p, err, scale)


def test_remat_policies_change_no_bit(ref):
    """Activation checkpointing recomputes the same ops: remat off,
    'nothing' and 'dots' give bitwise the same loss and grads."""
    cfg0, params = _port("gemma2-2b", ref)
    inp, tgt = _batch(cfg0)
    batch = {"inputs": torch.from_numpy(inp), "targets": torch.from_numpy(tgt)}
    outs = []
    for kw in (dict(remat=False), dict(remat_policy="nothing"),
               dict(remat_policy="dots")):
        cfg = cfg0.replace(**kw)
        outs.append(steps.value_and_grad(
            lambda p, b: decoder.lm_loss(p, b, cfg), params, batch))
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for a, b in zip(pytree.tree_leaves(grads),
                        pytree.tree_leaves(outs[0][1])):
            assert torch.equal(a, b)


def test_train_mode_reaches_no_kernel_wrapper(ref, monkeypatch):
    """Every kernel wrapper raises: train mode's loss and grads still run,
    on plain ops only: gemma3-4b (qk-norm, windows, softcaps), and on the
    port's own trees falcon-mamba-7b (Mamba), recurrentgemma-9b (RG-LRU
    beside windowed MQA) and deepseek-v2 / -v3 (MLA with and without a q
    latent, both MoE routers)."""
    def boom(*a, **k):
        raise AssertionError("train mode called a kernel wrapper")

    for name in ("rmsnorm", "add_rmsnorm", "fuse_rmsnorm", "flash_attention",
                 "int8_matmul", "ssm_scan", "selective_scan",
                 "paged_decode_attention", "decode_attention"):
        monkeypatch.setattr(ops, name, boom)
    cfg = reduced_config("gemma3-4b")
    jcfg = j_reduced_config("gemma3-4b")
    tree = _np(jax.jit(lambda k: jdec.init_lm(k, jcfg))(
        jax.random.PRNGKey(1)))
    params = from_jax_params(tree, cfg, device="cpu")
    trees = [(cfg, params)]
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b", "deepseek-v2-236b",
                 "deepseek-v3-671b"):
        c = reduced_config(arch)
        trees.append((c, decoder.init_lm(torch.Generator().manual_seed(0), c,
                                         "cpu", padded=True)))
    for cfg, params in trees:
        inp, tgt = _batch(cfg)
        loss, grads = steps.value_and_grad(
            lambda p, b: decoder.lm_loss(p, b, cfg), params,
            {"inputs": torch.from_numpy(inp),
             "targets": torch.from_numpy(tgt)})
        assert torch.isfinite(loss), cfg.name
        assert all(torch.isfinite(g).all() for g in pytree.tree_leaves(grads))


# ---------------------------------------------------------------------------
# optimizers, clipping, schedule
# ---------------------------------------------------------------------------

def _opt_tree(dtype, seed):
    """A small tree like a model's: matrices in ``dtype``, fp32 vectors,
    and a leaf of 1e-8-sized values (where AdamW's eps and Adafactor's
    eps2 floor decide the update)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"w": f(6, 5, 8), "blocks": ({"a": f(3, 7)}, {"a": f(3, 7)}),
            "scale": f(8), "tiny": f(4, 5) * np.float32(1e-8)}
    if dtype == "bfloat16":
        tree["w"] = tree["w"].astype(ml_dtypes.bfloat16)
        tree["blocks"] = tuple({"a": b["a"].astype(ml_dtypes.bfloat16)}
                               for b in tree["blocks"])
    return tree


def _to_t(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy()),
        tree)


def _assert_state_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        g = got[p]
        assert g.dtype == w.dtype, p
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(
                                       w.astype(np.float32)).max())),
                                   err_msg=p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_reference(kind, dtype):
    """Three updates on identical numpy grads.  bf16 params: AdamW's
    fp32 master within 1e-6 and the params its cast (Adafactor keeps no
    master: its bf16 params within one bf16 rounding)."""
    init, upd = {"adamw": (optim.adamw_init, optim.adamw_update),
                 "adafactor": (optim.adafactor_init,
                               optim.adafactor_update)}[kind]
    jinit, jupd = {"adamw": (joptim.adamw_init, joptim.adamw_update),
                   "adafactor": (joptim.adafactor_init,
                                 joptim.adafactor_update)}[kind]
    tree = _opt_tree(dtype, 0)
    params = _to_t(tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    st, jst = init(params), jinit(jparams)
    for i in range(3):
        g = _opt_tree("float32", i + 1)
        lr = 1e-2 * (i + 1)
        params, st = upd(_to_t(g), st, params,
                         torch.tensor(lr, dtype=torch.float32))
        jparams, jst = jax.jit(jupd)(
            jax.tree_util.tree_map(jnp.asarray, g), jst, jparams,
            jnp.float32(lr))
    got = _by_path({"p": params, "s": st}, True)
    want = _by_path({"p": jparams, "s": jst}, False)
    params_tol = 2 ** -8 if dtype == "bfloat16" else OPT_TOL
    _assert_state_close({k: v for k, v in got.items() if k.startswith("s/")},
                        {k: v for k, v in want.items()
                         if k.startswith("s/")}, OPT_TOL)
    _assert_state_close({k: v for k, v in got.items() if k.startswith("p/")},
                        {k: v for k, v in want.items()
                         if k.startswith("p/")}, params_tol)
    if kind == "adamw" and dtype == "bfloat16":
        for p, m in pytree.tree_paths(st["master"]):
            leaf = dict(pytree.tree_paths(params))[p]
            assert torch.equal(leaf, m.to(leaf.dtype))


def test_clip_and_schedule_match_reference():
    g = _opt_tree("bfloat16", 5)
    for max_norm in (1.0, 1e3):
        got, gn = optim.clip_by_global_norm(_to_t(g), max_norm)
        want, jgn = joptim.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        _assert_state_close(_by_path(got, True), _by_path(want, False),
                            2 ** -8)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        got = optim.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                  peak_lr=3e-3, warmup=10, total=100)
        want = joptim.warmup_cosine(jnp.int32(step), peak_lr=3e-3,
                                    warmup=10, total=100)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert optim.make_optimizer(reduced_config("pt-6b-d4"), 10)[2] == "adamw"
    assert optim.make_optimizer(reduced_config("pt-6b-d4"),
                                int(31e9))[2] == "adafactor"


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(mb, ref):
    cfg = reduced_config("pt-6b-d4")
    jtree = ref["pt-6b-d4"]["tree"]
    state = from_jax_state(
        {"params": jtree, "opt": _np(joptim.adamw_init(
            jax.tree_util.tree_map(jnp.asarray, jtree)))}, cfg, "cpu")
    fn, _, name = steps.make_train_step(cfg, microbatches=mb, peak_lr=3e-3,
                                        warmup=2, total_steps=3)
    assert name == "adamw"
    params, st = state["params"], state["opt"]
    losses, lrs = [], []
    for b in ref["step"]["batches"]:
        params, st, m = fn(params, st, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    want = ref["step"][mb]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    np.testing.assert_allclose(lrs, want["lrs"], rtol=1e-6)
    got = _by_path({"params": params, "opt": st}, True)
    assert sorted(got) == sorted(want["state"])
    atol = 2 * sum(lrs)
    for p, w in want["state"].items():
        if not p.startswith("params/"):
            continue
        err = np.abs(got[p] - w)
        assert float(err.max()) <= atol, (p, float(err.max()))
        assert float((err > 1e-5).mean()) <= 1e-3, p
    assert int(st["step"]) == 3


# ---------------------------------------------------------------------------
# checkpoints, resume, elastic helpers, CLIs
# ---------------------------------------------------------------------------

def _bf16_state(ref):
    """A bf16 reduced-PT train state, the reference's and the port's."""
    cfg = reduced_config("pt-6b-d4").replace(dtype="bfloat16")
    jtree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "scale" in jax.tree_util.keystr(path)
        else np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
        ref["pt-6b-d4"]["tree"])
    jstate = {"params": jtree, "opt": _np(joptim.adamw_init(
        jax.tree_util.tree_map(jnp.asarray, jtree)))}
    return cfg, jstate, from_jax_state(jstate, cfg, "cpu")


def test_checkpoints_read_across_packages(ref, tmp_path):
    """The port's checkpoint restores bitwise in the reference and the
    reference's in the port (bf16 leaves as uint16 bits, fp32 master,
    int32 step), with the same manifest."""
    cfg, jstate, state = _bf16_state(ref)
    with torch.no_grad():
        state["opt"]["m"]["embed"].add_(0.5)       # not all zeros
    store.save(tmp_path / "port", 7, state, extra={"next_step": 7})
    like = jax.tree_util.tree_map(jnp.asarray, jstate)
    back = jstore.restore(tmp_path / "port", like)
    assert _by_path(back, False).keys() == _by_path(state, True).keys()
    for p, a in _by_path(state, True).items():
        b = _by_path(back, False)[p]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
    assert jstore.manifest_extra(tmp_path / "port") == {"next_step": 7}

    jstore.save(tmp_path / "ref", 9, like, extra={"next_step": 9})
    mine = store.restore(tmp_path / "ref", state)
    for p, a in _by_path(like, False).items():
        b = _by_path(mine, True)[p]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
    assert store.latest_step(tmp_path / "ref") == 9
    m_port = json.loads((tmp_path / "port" / "step_000000007"
                         / "manifest.json").read_text())
    m_ref = json.loads((tmp_path / "ref" / "step_000000009"
                        / "manifest.json").read_text())
    assert m_port["leaves"] == m_ref["leaves"]


def test_keep_k_partial_and_stale_tmp_dirs(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.ones(2, dtype=torch.bfloat16),),
            "step": torch.tensor(4, dtype=torch.int32)}
    for s in range(5):
        store.save(tmp_path, s, tree, keep=2)
    kept = sorted(d.name for d in tmp_path.iterdir())
    assert kept == ["step_000000003", "step_000000004"]
    (tmp_path / "step_000000009").mkdir()            # no manifest
    fresh = tmp_path / "step_000000008.tmp-fresh"
    stale = tmp_path / "step_000000007.tmp-stale"
    fresh.mkdir()
    stale.mkdir()
    old = time.time() - 120
    os.utime(stale, (old, old))
    assert store.latest_step(tmp_path) == 4
    store.save(tmp_path, 5, tree, keep=2)
    assert not stale.exists() and fresh.exists()
    out = store.restore(tmp_path, tree)
    assert int(out["step"]) == 4 and out["b"][0].dtype == torch.bfloat16
    bigger = dict(tree, new=torch.zeros(1))
    with pytest.raises(KeyError):
        store.restore(tmp_path, bigger)


def test_async_checkpointer_writes_a_snapshot(tmp_path):
    """An in-place update right after ``save`` does not reach the file."""
    tree = {"w": torch.zeros(1 << 16)}
    ac = store.AsyncCheckpointer(tmp_path, keep=2)
    ac.save(1, tree, extra={"next_step": 1})
    tree["w"].add_(1.0)
    ac.wait()
    assert float(store.restore(tmp_path, tree)["w"].abs().max()) == 0.0
    for s in (2, 3):
        ac.save(s, tree)
    ac.wait()
    assert store.latest_step(tmp_path) == 3


def _equal_trees(a, b):
    pa, pb = dict(pytree.tree_paths(a)), dict(pytree.tree_paths(b))
    assert pa.keys() == pb.keys()
    return all(torch.equal(pa[k], pb[k]) for k in pa)


def test_resume_bitwise_uninterrupted(tmp_path):
    """3 steps, a checkpoint, a fresh loop that resumes, 3 more steps:
    params and optimizer state bitwise the 6 uninterrupted steps'."""
    cfg = reduced_config("gemma2-2b")
    kw = dict(batch=2, seq=16, device="cpu", log_every=1,
              print_fn=lambda *_: None)
    whole = train.train_loop(cfg, steps=6, **kw)
    train.train_loop(cfg, steps=3, ckpt_dir=str(tmp_path), ckpt_every=3,
                     **kw)
    assert store.latest_step(tmp_path) == 3
    resumed = train.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path), **kw)
    assert resumed["losses"][0][0] == 3
    assert _equal_trees(whole["params"], resumed["params"])
    assert _equal_trees(whole["opt_state"], resumed["opt_state"])


def test_straggler_monitor_flags_persistent_outlier():
    for cls in (StragglerMonitor, jelastic.StragglerMonitor):
        mon = cls(threshold=1.5, patience=3)
        flagged = []
        for _ in range(3):
            flagged = mon.observe({"h0": 1.0, "h1": 1.05, "h2": 4.0})
        assert flagged == ["h2"]
        mon.observe({"h0": 1.0, "h1": 1.0, "h2": 1.0})
        assert mon.observe({"h0": 1.0, "h1": 1.0, "h2": 5.0}) == []


@pytest.mark.parametrize("fails,max_restarts,ok", [(2, 5, True),
                                                   (3, 2, False)])
def test_retry_policy(fails, max_restarts, ok):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise RuntimeError("device fell over")
        return "ok"

    restarts = []
    pol = RetryPolicy(max_restarts=max_restarts, backoff_s=0.0)
    if ok:
        assert pol.run(flaky, lambda n, e: restarts.append(n)) == "ok"
        assert restarts == list(range(1, fails + 1))
    else:
        with pytest.raises(RuntimeError):
            pol.run(flaky, lambda n, e: restarts.append(n))
        assert restarts == list(range(1, max_restarts + 1))


def test_train_cli_then_serve_the_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "pt-6b-d4", "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", ck]
    assert train.main(args) == 0
    assert store.latest_step(ck) == 4
    # the reference's restore reads the port's checkpoint
    jcfg = j_reduced_config("pt-6b-d4")
    like = jax.eval_shape(lambda: jtrack.init_pt(jax.random.PRNGKey(0),
                                                  jcfg))
    like = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), like)
    got = jstore.restore(ck, {"params": like,
                              "opt": joptim.adamw_init(like)})
    assert int(got["opt"]["step"]) == 4
    assert train.main(args[:4] + ["6"] + args[5:]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert serve.main(["--reduced", "--device", "cpu", "--ckpt-dir", ck,
                       "--requests", "2", "--input-len", "8",
                       "--output-len", "4"]) == 0
    out = capsys.readouterr().out
    assert f"loaded params from {ck}" in out
    assert "finished 2/2 requests" in out
    with pytest.raises(NotImplementedError, match="item 9c"):
        train.main(args + ["--data-parallel", "2"])
