"""The train modes of the Mamba, RG-LRU, MLA and MoE layers against the
JAX package on the CPU: falcon-mamba-7b, recurrentgemma-9b,
deepseek-v2-236b and deepseek-v3-671b (reduced), and deepseek-v2 with
its 8 experts stored padded to 16 (the full config stores 160 as 256).
One parameter tree per model is drawn with numpy from the port's train
specs (``lm_param_specs(padded=True)``, whose paths and shapes are the
reference's ``init_lm``'s) and handed to both packages; each model's
``jax.value_and_grad(lm_loss)`` is compiled once (module fixture) and
also serves the reference's train steps.

Tolerances (fp32), as tests/test_torch_train.py's: losses 2e-5
relative, every grad leaf within 1e-4 x that leaf's max |g|, the MoE's
auxiliary loss 1e-5 relative (the aux-free router's: exactly 0), one
optimizer update 1e-6, the scan 2e-5 (values and grads); two train
steps: losses 1e-5 relative, params within 2 x the summed learning
rates with 99.9 % of every leaf within 1e-5 (Adam's sign on grads
within rounding of zero).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import store as jstore
from repro.common import pytree as jpytree
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch import steps as jsteps
from repro.models import decoder as jdec
from repro.models.ssm import _chunked_linear_scan
from repro_torch import optim
from repro_torch.checkpoint import store
from repro_torch.common import pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve, steps, train
from repro_torch.models import decoder
from repro_torch.models.params import map_leaves
from repro_torch.models.ssm import linear_scan
from repro_torch.optim import adafactor
from repro_torch.weights import (drop_expert_padding, from_jax_params,
                                 from_jax_state)

OP_TOL = 2e-5
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
AUX_TOL = 1e-5
OPT_TOL = 1e-6
B, S = 2, 32
ARCHS = ["falcon-mamba-7b", "recurrentgemma-9b", "deepseek-v2-236b",
         "deepseek-v3-671b"]
PADDED = "deepseek-v2-236b padded"
MOE_LEAVES = ("router", "e_bias", "w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a pytest-xdist worker (see test_torch_model)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    """(the reference's config, the port's) of ``name``; PADDED is the
    reduced deepseek-v2 with its experts stored padded to 16."""
    arch = name.split()[0]
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    if name == PADDED:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    n_experts_padded=16))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  n_experts_padded=16))
    return jcfg, cfg


def _tree(cfg, seed=0):
    """The train tree drawn with numpy: normal x the spec's std, constants
    (norm scales, A_log, D, dt_bias, lam) as the spec fills them, and a
    nonzero e_bias (so that the bias steers the top k)."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if leaf.std is None:
            a = leaf.make(None, torch.float32, torch.device("cpu")).numpy()
            if len(leaf.shape) == 1 and not a.any():
                a = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
            return a
        return (leaf.std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return map_leaves(draw, decoder.lm_param_specs(cfg, padded=True))


def _batch(cfg, seed=0, rows=B):
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)
    tgt[0, :3] = -1                       # padding is masked out
    return {"inputs": inp, "targets": tgt}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _by_path(tree, torch_side: bool):
    if torch_side:
        return {p: l.detach().numpy() for p, l in pytree.tree_paths(tree)}
    return {p: np.asarray(l) for p, l in jpytree.tree_paths(tree)}


@pytest.fixture(scope="module")
def ref():
    """Per model: the numpy tree, the compiled reference value_and_grad
    (B x S batches) and its loss, aux and grads on the model's batch."""
    out = {}
    for name in ARCHS + [PADDED]:
        jcfg, cfg = _cfgs(name)
        tree = _tree(cfg)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, jcfg=jcfg: jdec.lm_loss(p, b, jcfg), has_aux=True))
        (loss, metrics), grads = vg(_jnp(tree), _jnp(_batch(cfg)))
        out[name] = {"tree": tree, "vg": vg, "loss": float(loss),
                     "aux": float(metrics["aux"]),
                     "grads": _by_path(grads, False)}
    return out


def _port_loss(name, params, batch):
    _, cfg = _cfgs(name)
    got = {}

    def loss_fn(p, b):
        loss, metrics = decoder.lm_loss(p, b, cfg)
        got["aux"] = metrics["aux"].detach()
        return loss, metrics

    loss, grads = steps.value_and_grad(
        loss_fn, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, got["aux"], grads


# ---------------------------------------------------------------------------
# losses, the auxiliary loss, grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS + [PADDED])
def test_loss_aux_and_grads_match_reference(name, ref):
    """The train tree's paths, shapes and dtypes are the reference's
    ``init_lm``'s; loss, aux and every grad leaf (tree paths equal)
    against ``jax.value_and_grad(lm_loss)``.  The softmax router's aux within
    1e-5; the aux-free router's exactly 0 with e_bias's grad exactly 0;
    the padded store's padded experts' grads exactly 0 in both."""
    jcfg, cfg = _cfgs(name)
    r = ref[name]
    jshapes = jax.eval_shape(lambda: jdec.init_lm(jax.random.PRNGKey(0),
                                                  jcfg))
    assert [(p, tuple(l.shape), l.dtype.name)
            for p, l in jpytree.tree_paths(jshapes)] == [
        (p, a.shape, a.dtype.name) for p, a in jpytree.tree_paths(r["tree"])]
    params = from_jax_params(r["tree"], cfg, device="cpu", padded=True)
    loss, aux, grads = _port_loss(name, params, _batch(cfg))
    np.testing.assert_allclose(float(loss), r["loss"], rtol=LOSS_TOL)
    if cfg.moe is not None and cfg.moe.router == "softmax":
        assert r["aux"] > 0
        np.testing.assert_allclose(float(aux), r["aux"], rtol=AUX_TOL)
    else:
        assert float(aux) == 0.0 and r["aux"] == 0.0
    want = r["grads"]
    got = {p: g.numpy() for p, g in pytree.tree_paths(grads)}
    assert sorted(got) == sorted(want)
    for p, g in got.items():
        scale = max(float(np.abs(want[p]).max()), 1e-30)
        err = float(np.abs(g - want[p]).max())
        assert err <= GRAD_TOL * scale, (p, err, scale)
        if p.endswith("e_bias"):
            assert not g.any() and not want[p].any(), p
    if name == PADDED:
        E = cfg.moe.n_routed_experts
        for p, g in got.items():
            key = p.rsplit("/", 1)[-1]
            if key in MOE_LEAVES:
                axis = -1 if key == "router" else -3
                for a in (g, want[p]):
                    pad = np.take(a, np.arange(E, a.shape[axis]), axis=axis)
                    assert pad.size and not pad.any(), p


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-v2-236b"])
def test_remat_policies_change_no_bit(arch, ref):
    """Remat off, 'nothing' and 'dots' recompute the same ops around the
    plain scan's hand-written backward and the MoE's dispatch: bitwise
    the same loss and grads."""
    _, cfg0 = _cfgs(arch)
    params = from_jax_params(ref[arch]["tree"], cfg0, device="cpu",
                             padded=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg0).items()}
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


# ---------------------------------------------------------------------------
# the plain scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_,feat", [(32, (6, 4)), (20, (6,))])
def test_linear_scan_matches_chunked_linear_scan(S_, feat):
    """``linear_scan`` against the reference's ``_chunked_linear_scan``
    at chunk 8: S a multiple of it (4 chunks) with a d_state axis (the
    Mamba layout), and S not (one chunk of S) without (RG-LRU's): h,
    h_last and the grads of a, b and h0 (of sum(h w) + sum(h_last w'))."""
    rng = np.random.default_rng(S_ + len(feat))
    a = rng.uniform(0.5, 1.0, (2, S_) + feat).astype(np.float32)
    b = rng.standard_normal((2, S_) + feat).astype(np.float32)
    h0 = rng.standard_normal((2,) + feat).astype(np.float32)
    w = rng.standard_normal((2, S_) + feat).astype(np.float32)
    w2 = rng.standard_normal((2,) + feat).astype(np.float32)

    def jloss(a, b, h0):
        h, last = _chunked_linear_scan(a, b, h0, 8)
        return jnp.sum(h * w) + jnp.sum(last * w2), (h, last)

    (_, (jh, jlast)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (a, b, h0)))
    ta, tb, th0 = (torch.from_numpy(x).requires_grad_(True)
                   for x in (a, b, h0))
    h = linear_scan(ta, tb, th0)
    last = h[:, -1]
    (torch.sum(h * torch.from_numpy(w))
     + torch.sum(last * torch.from_numpy(w2))).backward()
    for got, want in ((h, jh), (last, jlast), (ta.grad, jgrads[0]),
                      (tb.grad, jgrads[1]), (th0.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=OP_TOL, atol=OP_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@jax.jit
def _clip_adamw(grads, st, p, lr):
    return joptim.adamw_update(joptim.clip_by_global_norm(grads, 1.0)[0],
                               st, p, lr)


def _ref_steps(r, batches, mb, peak_lr, warmup, total):
    """The reference's train step as ``repro.launch.steps.make_train_step``
    composes it (AdamW: the reduced trees are far below 30 B params),
    with the module's compiled value_and_grad on each microbatch: the
    grads summed in fp32 and divided by the count, the loss the mean,
    then ``clip_by_global_norm``, ``warmup_cosine`` at the optimizer's
    step and ``adamw_update``."""
    p = _jnp(r["tree"])
    st = joptim.adamw_init(p)
    losses, lrs = [], []
    for b in batches:
        lrs.append(float(joptim.warmup_cosine(st["step"], peak_lr=peak_lr,
                                              warmup=warmup, total=total)))
        n = b["targets"].shape[0] // mb
        gsum, lsum = None, 0.0
        for i in range(mb):
            (loss, _), g = r["vg"](p, _jnp({k: v[i * n:(i + 1) * n]
                                            for k, v in b.items()}))
            g32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
            gsum = g32 if gsum is None else jax.tree_util.tree_map(
                jnp.add, gsum, g32)
            lsum = lsum + loss
        grads = (gsum if mb == 1 else
                 jax.tree_util.tree_map(lambda x: x / mb, gsum))
        losses.append(float(lsum / mb))
        p, st = _clip_adamw(grads, st, p, jnp.float32(lrs[-1]))
    return losses, lrs, _by_path(p, False)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v2-236b"])
def test_train_step_matches_reference(arch, mb, ref):
    """Two ``make_train_step`` steps (AdamW, warmup 1) at microbatches 1
    (batches of B rows) and 2 (batches of 2 B rows) against the
    reference's step."""
    _, cfg = _cfgs(arch)
    r = ref[arch]
    batches = [_batch(cfg, seed=s, rows=B * mb) for s in (1, 2)]
    kw = dict(peak_lr=3e-3, warmup=1, total=2)
    want_losses, want_lrs, want = _ref_steps(r, batches, mb, **kw)
    state = from_jax_state({"params": r["tree"], "opt": _np(
        joptim.adamw_init(_jnp(r["tree"])))}, cfg, "cpu")
    fn, _, name = steps.make_train_step(cfg, microbatches=mb, peak_lr=3e-3,
                                        warmup=1, total_steps=2)
    assert name == "adamw"
    params, st = state["params"], state["opt"]
    losses, lrs = [], []
    for b in batches:
        params, st, m = fn(params, st, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(lrs, want_lrs, rtol=1e-6)
    got = _by_path(params, True)
    assert sorted(got) == sorted(want)
    atol = 2 * sum(lrs)
    for p, w in want.items():
        err = np.abs(got[p] - w)
        assert float(err.max()) <= atol, (p, float(err.max()))
        assert float((err > 1e-5).mean()) <= 1e-3, p
    assert int(st["step"]) == 2


def test_counts_microbatches_and_optimizer_match_reference():
    """The train tree's parameter count (padded experts included: the
    full deepseek-v2 stores 256 of its 160), so the optimizer picked, and
    the default microbatches of the four full configs equal the
    reference's."""
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        n = jpytree.count_params(jsteps.param_specs(jcfg))
        assert steps._n_params(cfg) == n, arch
        assert (optim.make_optimizer(cfg, n)[2]
                == joptim.make_optimizer(jcfg, n)[2]), arch
        assert (steps.cfg_default_microbatches(cfg)
                == jsteps.cfg_default_microbatches(jcfg)), arch
    assert optim.make_optimizer(
        get_config("deepseek-v2-236b"),
        steps._n_params(get_config("deepseek-v2-236b")))[2] == "adafactor"


# ---------------------------------------------------------------------------
# the padded store: Adafactor and checkpoints
# ---------------------------------------------------------------------------

def _adafactor_states(ref):
    """One Adafactor step on the padded tree from the reference's grads:
    the reference's, the port's, and the port's a slice of 3 experts at
    a time (two passes)."""
    _, cfg = _cfgs(PADDED)
    r = ref[PADDED]
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(_jnp(r["tree"])),
        [r["grads"][p] for p, _ in jpytree.tree_paths(r["tree"])])
    jp = _jnp(r["tree"])
    jp1, jst1 = jax.jit(joptim.adafactor_update)(
        _jnp(grads), joptim.adafactor_init(jp), jp, jnp.float32(1e-2))
    params = from_jax_params(r["tree"], cfg, device="cpu", padded=True)
    tgrads = from_jax_params(_np(grads), cfg, device="cpu", padded=True)
    lr = torch.tensor(1e-2, dtype=torch.float32)
    out = {"ref": (jp1, jst1)}
    for tag, numel in (("whole", adafactor._SLICE_NUMEL),
                       ("sliced", 3 * 64 * 32)):
        with mock.patch.object(adafactor, "_SLICE_NUMEL", numel):
            out[tag] = optim.adafactor_update(
                tgrads, optim.adafactor_init(params), params, lr)
    return cfg, out


def test_padded_adafactor_step_matches_reference(ref):
    """The padded deepseek-v2's expert stacks [R, 16, 64, 32] (8 real):
    one Adafactor update, per-expert factored statistics and whole-leaf
    clip and step size over all 16, equal to the reference's within 1e-6
    (params and statistics), whole and by slices of 3 experts (whose
    two-pass sums are held to the whole leaf's means at 1e-6)."""
    _, out = _adafactor_states(ref)
    jp1, jst1 = out["ref"]
    want = _by_path({"p": jp1, "s": jst1["stats"]}, False)
    for tag in ("whole", "sliced"):
        p1, st1 = out[tag]
        got = _by_path({"p": p1, "s": st1["stats"]}, True)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=OPT_TOL,
                                       atol=OPT_TOL * max(1.0, float(
                                           np.abs(w).max())), err_msg=k)
        assert int(st1["step"]) == int(jst1["step"]) == 1
    assert tuple(out["whole"][0]["unit"][0]["mlp"]["w_gate"].shape[-3:]) == (
        16, 64, 32)


def test_padded_checkpoints_restore_across_packages(ref, tmp_path):
    """The padded train state (params and Adafactor statistics after one
    step) saved by the port restores bitwise in the reference, and the
    reference's in the port; the served tree drops the padding as the
    bridge does."""
    cfg, out = _adafactor_states(ref)
    params, st = out["whole"]
    state = {"params": params, "opt": st}
    store.save(tmp_path / "port", 1, state)
    jp1, jst1 = out["ref"]
    like = {"params": jp1, "opt": jst1}
    back = _by_path(jstore.restore(tmp_path / "port", like), False)
    mine = _by_path(state, True)
    assert sorted(back) == sorted(mine)
    for p, a in mine.items():
        assert a.dtype == back[p].dtype and a.tobytes() == back[p].tobytes(), p
    jstore.save(tmp_path / "ref", 1, like)
    got = _by_path(store.restore(tmp_path / "ref", state), True)
    for p, a in _by_path(like, False).items():
        assert a.dtype == got[p].dtype and a.tobytes() == got[p].tobytes(), p
    served = drop_expert_padding(store.restore(tmp_path / "ref",
                                               state)["params"], cfg)
    want = from_jax_params(_np(jp1), cfg, device="cpu")
    for (p, a), (_, b) in zip(pytree.tree_paths(served),
                              pytree.tree_paths(want)):
        assert torch.equal(a, b), p
    assert served["unit"][0]["mlp"]["router"].shape[-1] == 8


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_then_serve_falcon_mamba(tmp_path, capsys):
    """``launch/train.py --arch falcon-mamba-7b --reduced`` (4 steps, a
    checkpoint every 2), then ``serve.py --ckpt-dir`` on its newest."""
    ck = str(tmp_path / "ck")
    assert train.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps",
                       "4", "--batch", "2", "--seq", "16", "--ckpt-every",
                       "2", "--device", "cpu", "--ckpt-dir", ck]) == 0
    assert store.latest_step(ck) == 4
    out = capsys.readouterr().out
    assert "optimizer=adamw" in out and "done: loss" in out
    assert serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device",
                       "cpu", "--ckpt-dir", ck, "--requests", "2",
                       "--input-len", "8", "--output-len", "4"]) == 0
    out = capsys.readouterr().out
    assert f"loaded params from {ck}" in out
    assert "finished 2/2 requests" in out
