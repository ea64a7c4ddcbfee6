"""whisper-medium in the port against the JAX package on the CPU: the
config field for field, the sinusoid positions, the parameter tree, the
encoder, prefill logits and the cross-attending layers' cache ((k, v),
(enc_k, enc_v)), ``pad_cache`` then chained ``lm_decode_step``s with
their greedy stream, a 4-token ``lm_chunk_step``, the train loss and its
grads (no kernel wrapper reached), one AdamW train step, the plain
versions of the two kernels on cross-attention's paths (flash with no
causal mask at Sq != Sk, the contiguous decode at G 1 over encoder rows)
and the engine's refusal of encoder-decoder models.

One tree from the reference's ``init_lm`` (fixed key, reduced config: 2
encoder and 3 decoder layers, d 64, 4 heads of 64, fp32), its norm
scales and biases moved by seeded numpy noise so that each LayerNorm's
bias counts, is loaded into both packages (``weights.from_jax_params``);
inputs are drawn with numpy.  The reference's programs run once, in the
module fixture ``ref``.

Tolerances (fp32): single ops 2e-5, as tests/test_kernels.py, the
sinusoid 1e-6; the encoder's output 2e-5; whole-model logits and caches
1e-4, as tests/test_torch_model.py; greedy streams identical; loss,
grads and the train step as tests/test_torch_train.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import pytree as jpytree
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs import whisper_medium as j_whisper
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import decoder as jdec
from repro.serving.cache import pad_cache as j_pad_cache
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import arch_capabilities as j_arch_capabilities
from repro_torch.common import pytree
from repro_torch.configs import get_config, reduced_config, whisper_medium
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve, steps
from repro_torch.models import attention as attn
from repro_torch.models import decoder
from repro_torch.models.layers import _track1
from repro_torch.serving.cache import pad_cache
from repro_torch.serving.engine import Engine, ModelRunner, arch_capabilities
from repro_torch.weights import from_jax_params, from_jax_state

OP_TOL = 2e-5
MODEL_TOL = 1e-4
LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
ARCH = "whisper-medium"
B, S, SE = 2, 6, 36          # rows, prompt tokens, encoder frames
CAP = S + 12                 # the decode cache's capacity
STEPS, CHUNK = 8, 4
REFUSAL = "engine serves decoder-only models"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a pytest-xdist worker (see test_torch_model)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@functools.lru_cache(maxsize=None)
def _tree():
    """The reference's init_lm tree (numpy), norm leaves moved by noise."""
    jcfg = j_reduced_config(ARCH)
    tree = _np(jax.jit(lambda k: jdec.init_lm(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)

    def move(path, a):
        keys = jax.tree_util.keystr(path)
        if "ln" in keys or "final_norm" in keys:
            return (a + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, tree)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt[0, :2] = -1                       # padding is masked out
    chunk = rng.integers(0, cfg.vocab_size, (B, CHUNK)).astype(np.int32)
    return {"enc": enc, "tok": tok, "tgt": tgt, "chunk": chunk}


@pytest.fixture(scope="module")
def ref():
    """Each reference program run once on the tree and the inputs: the
    encoder, the prefill, pad_cache + STEPS greedy decode steps, a chunk
    of CHUNK tokens after the prefill, the loss and its grads, and one
    AdamW train step at microbatches 2 (the batch's enc_inputs split)."""
    jcfg = j_reduced_config(ARCH)
    tree = _tree()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    x = _inputs(jcfg)
    enc, tok = jnp.asarray(x["enc"]), jnp.asarray(x["tok"])
    out = {"tree": tree, "inputs": x}
    out["encode"] = np.asarray(jax.jit(
        lambda p, e: jdec.encode(p, e, jcfg))(jp, enc))
    logits, cache, _ = jax.jit(lambda p, b: jdec.lm_forward(
        p, b, jcfg, mode="prefill"))(jp, {"inputs": tok, "enc_inputs": enc})
    out["prefill"] = (np.asarray(logits), _np(cache))
    padded = j_pad_cache(cache, jcfg, CAP)
    step = jax.jit(lambda p, c, t, pos: jdec.lm_decode_step(p, c, t, pos,
                                                            jcfg))
    t = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    c, steps_out = padded, []
    for i in range(STEPS):
        lg, c = step(jp, c, t, jnp.full((B,), S + i, jnp.int32))
        steps_out.append((np.asarray(t), np.asarray(lg)))
        t = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    out["decode"] = steps_out
    lg, c = jax.jit(lambda p, c, t, pos: jdec.lm_chunk_step(p, c, t, pos,
                                                           jcfg))(
        jp, padded, jnp.asarray(x["chunk"]), jnp.full((B,), S, jnp.int32))
    out["chunk"] = (np.asarray(lg), _np(c))
    batch = {"inputs": tok, "targets": jnp.asarray(x["tgt"]),
             "enc_inputs": enc}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jdec.lm_loss(p, b, jcfg), has_aux=True))(jp, batch)
    out["loss"] = (float(loss), dict(jpytree.tree_paths(_np(grads))))
    par = jsteps.build_parallelism(jcfg, "train", None)
    fn, opt_init, _ = jsteps.make_train_step(jcfg, par, microbatches=2,
                                             peak_lr=3e-3, warmup=0,
                                             total_steps=3)
    st = opt_init(jp)
    out["opt0"] = _np(st)
    p1, st1, m = jax.jit(fn)(jp, st, batch)
    out["step"] = {"loss": float(m["loss"]), "lr": float(m["lr"]),
                   "params": dict(jpytree.tree_paths(_np(p1)))}
    return out


def _port(ref):
    cfg = reduced_config(ARCH)
    return cfg, from_jax_params(ref["tree"], cfg, device="cpu")


def _prefill(ref):
    cfg, params = _port(ref)
    x = ref["inputs"]
    with torch.no_grad():
        logits, cache = decoder.lm_forward(
            params, {"inputs": _t(x["tok"]), "enc_inputs": _t(x["enc"])},
            cfg)
    return cfg, params, logits, cache


# ---------------------------------------------------------------------------
# config, positions, parameters
# ---------------------------------------------------------------------------

def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_matches_reference(size):
    """Every field of the port's config equals the reference's, the
    encoder sub-config and both layer specs among them."""
    cfg = get_config(ARCH) if size == "full" else reduced_config(ARCH)
    jcfg = j_get_config(ARCH) if size == "full" else j_reduced_config(ARCH)
    for f in dataclasses.fields(cfg):
        assert _fields(getattr(cfg, f.name)) == \
            _fields(getattr(jcfg, f.name)), f.name
    assert _fields(cfg.encdec) == {"n_enc_layers": 24 if size == "full"
                                   else 2, "cross_attn": True,
                                   "enc_window": None}
    assert whisper_medium.ENC_FRAMES == j_whisper.ENC_FRAMES == 1500


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoid_matches_reference(d):
    """Positions 0-15 (the decoder's) at 1e-6.  Past them the limit grows
    with the position p: XLA's fp32 exp and PyTorch's round a few of the
    frequencies one ulp apart (frequencies within 1.2e-7 relative), so an
    angle p x freq may differ by p ulps of 1, and its sine or cosine as
    much: 1e-6 + p x 2^-22 at the encoder's positions up to 1499."""
    rng = np.random.default_rng(d)
    pos = np.concatenate([np.arange(16)[None].repeat(2, 0),
                          rng.integers(16, 1500, (2, 16)),
                          np.full((2, 1), 1499)], 1).astype(np.int32)
    got = decoder._sinusoid(_t(pos), d).numpy()
    want = np.asarray(jdec._sinusoid(jnp.asarray(pos), d))
    np.testing.assert_allclose(got[:, :16], want[:, :16], rtol=0, atol=1e-6)
    limit = 1e-6 + pos[..., None] * 2.0 ** -22
    assert (np.abs(got - want) <= limit).all()
    one = np.ones((1, 1), np.int32)            # the frequencies themselves
    np.testing.assert_allclose(decoder._sinusoid(_t(one), d).numpy(),
                               np.asarray(jdec._sinusoid(jnp.asarray(one),
                                                         d)), rtol=1.2e-7,
                               atol=0)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_init_lm_tree_matches_reference(size):
    """Keys, shapes and dtypes of the port's tree (full width: its specs,
    nothing allocated) against the reference's init_lm (abstractly); the
    bridge refuses a tree without the encoder."""
    cfg = get_config(ARCH) if size == "full" else reduced_config(ARCH)
    jcfg = j_get_config(ARCH) if size == "full" else j_reduced_config(ARCH)
    want = {p: (tuple(l.shape), str(l.dtype)) for p, l in jpytree.tree_paths(
        jax.eval_shape(lambda: jdec.init_lm(jax.random.PRNGKey(0), jcfg)))}
    if size == "full":
        dtype = decoder.model_dtype(cfg)
        got = {p: (tuple(l.shape), str(l.dtype(dtype)).split(".")[1])
               for p, l in pytree.tree_paths(decoder.lm_param_specs(cfg))}
    else:
        tree = decoder.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
        got = {p: (tuple(l.shape), str(l.dtype).split(".")[1])
               for p, l in pytree.tree_paths(tree)}
        bad = _np(jax.jit(lambda k: jdec.init_lm(k, jcfg))(
            jax.random.PRNGKey(0)))
        del bad["enc"]
        with pytest.raises(ValueError, match="enc"):
            from_jax_params(bad, cfg, device="cpu")
    assert got == want
    assert any(p.startswith("enc/layers/") for p in got)
    assert "unit/0/cross/wq" in got and "unit/0/ln_x/bias" in got


# ---------------------------------------------------------------------------
# the model: encoder, prefill, decode, chunk
# ---------------------------------------------------------------------------

def test_encode_matches_reference(ref):
    cfg, params = _port(ref)
    with torch.no_grad():
        got = decoder.encode(params, _t(ref["inputs"]["enc"]), cfg)
    _close(got, ref["encode"], OP_TOL)


def test_prefill_logits_and_cross_cache_match_reference(ref):
    """Logits and every cache leaf: each decoder layer's own K/V [R, B,
    S, KH, hd] and the encoder's projected once [R, B, S_enc, KH, hd]."""
    cfg, _, logits, cache = _prefill(ref)
    want_logits, want_cache = ref["prefill"]
    _close(logits, want_logits, MODEL_TOL)
    (k, v), (ek, ev) = cache["unit"][0]
    R, KH, hd = cfg.pattern_repeat, cfg.n_kv_heads, cfg.head_dim
    assert k.shape == v.shape == (R, B, S, KH, hd)
    assert ek.shape == ev.shape == (R, B, SE, KH, hd)
    got = dict(pytree.tree_paths(cache))
    want = dict(jpytree.tree_paths(want_cache))
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        _close(got[p], w, MODEL_TOL)


def test_chained_decode_matches_reference(ref):
    """pad_cache to CAP (the encoder K/V keep their S_enc rows; the tree
    is init_cache(enc_len=)'s and the reference's), then STEPS decode
    steps fed the port's own greedy tokens: every step's
    logits within 1e-4 of the reference's, the token streams equal, and
    the encoder K/V never written."""
    cfg, params, logits, cache = _prefill(ref)
    cache = pad_cache(cache, cfg, CAP)
    (k, _), (ek, ev) = cache["unit"][0]
    assert k.shape[2] == CAP and ek.shape[2] == SE
    # init_cache(enc_len=) lays out the same tree as the reference's
    zero = decoder.init_cache(cfg, B, CAP, device="cpu", enc_len=SE)
    want = {p: tuple(l.shape) for p, l in jpytree.tree_paths(jax.eval_shape(
        lambda: jdec.init_cache(j_reduced_config(ARCH), B, CAP,
                                enc_len=SE)))}
    for tree in (zero, cache):
        assert {p: tuple(l.shape)
                for p, l in pytree.tree_paths(tree)} == want
    enc_kv = (ek.clone(), ev.clone())
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    with torch.no_grad():
        for i, (want_tok, want) in enumerate(ref["decode"]):
            assert tok.tolist() == want_tok.tolist(), i
            lg, cache = decoder.lm_decode_step(
                params, cache, tok, torch.full((B,), S + i,
                                               dtype=torch.int32), cfg)
            _close(lg, want, MODEL_TOL)
            tok = lg.argmax(-1).to(torch.int32)
    assert torch.equal(ek, enc_kv[0]) and torch.equal(ev, enc_kv[1])


def test_chunk_step_matches_reference(ref):
    """One lm_chunk_step of CHUNK tokens at position S on the padded
    prefill cache: logits and the whole cache within 1e-4."""
    cfg, params, _, cache = _prefill(ref)
    cache = pad_cache(cache, cfg, CAP)
    with torch.no_grad():
        lg, cache = decoder.lm_chunk_step(
            params, cache, _t(ref["inputs"]["chunk"]),
            torch.full((B,), S, dtype=torch.int32), cfg)
    want_logits, want_cache = ref["chunk"]
    _close(lg, want_logits, MODEL_TOL)
    want = dict(jpytree.tree_paths(want_cache))
    for p, leaf in pytree.tree_paths(cache):
        _close(leaf, want[p], MODEL_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference(ref, monkeypatch):
    """lm_loss and every grad leaf (the encoder's too) against
    jax.value_and_grad, with every kernel wrapper patched to raise: the
    train mode, encoder and cross-attention included, runs plain ops."""
    def boom(*a, **k):
        raise AssertionError("train mode called a kernel wrapper")

    for name in ("rmsnorm", "add_rmsnorm", "fuse_rmsnorm", "flash_attention",
                 "int8_matmul", "ssm_scan", "selective_scan",
                 "paged_decode_attention", "decode_attention"):
        monkeypatch.setattr(ops, name, boom)
    cfg, params = _port(ref)
    x = ref["inputs"]
    loss, grads = steps.value_and_grad(
        lambda p, b: decoder.lm_loss(p, b, cfg), params,
        {"inputs": _t(x["tok"]), "targets": _t(x["tgt"]),
         "enc_inputs": _t(x["enc"])})
    want_loss, want = ref["loss"]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_TOL)
    got = dict(pytree.tree_paths(grads))
    assert sorted(got) == sorted(want)
    assert any(p.startswith("enc/") for p in got)
    for p, g in got.items():
        scale = max(float(np.abs(want[p]).max()), 1e-30)
        err = float(np.abs(g.numpy() - want[p]).max())
        assert err <= GRAD_TOL * scale, (p, err, scale)


def test_train_step_matches_reference(ref):
    """One AdamW step of make_train_step at microbatches 2 (the batch's
    enc_inputs split with the rest; no warmup, so the step moves every
    param by about lr) from the reference's state: loss and lr, the
    params within 2 x lr with 99.9 % of each leaf within 1e-5, and every
    leaf moved in both."""
    cfg = reduced_config(ARCH)
    state = from_jax_state({"params": ref["tree"], "opt": ref["opt0"]}, cfg,
                           "cpu")
    fn, _, name = steps.make_train_step(cfg, microbatches=2, peak_lr=3e-3,
                                        warmup=0, total_steps=3)
    assert name == "adamw"
    x = ref["inputs"]
    params, st, m = fn(state["params"], state["opt"],
                       {"inputs": _t(x["tok"]), "targets": _t(x["tgt"]),
                        "enc_inputs": _t(x["enc"])})
    want = ref["step"]
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6)
    got = dict(pytree.tree_paths(params))
    before = dict(jpytree.tree_paths(ref["tree"]))
    assert sorted(got) == sorted(want["params"])
    moved = sum(not np.array_equal(w, before[p])
                for p, w in want["params"].items())
    assert moved == len(got)
    for p, w in want["params"].items():
        err = np.abs(got[p].numpy() - w)
        assert float(err.max()) <= 2 * want["lr"], (p, float(err.max()))
        assert float((err > 1e-5).mean()) <= 1e-3, p
    assert int(st["step"]) == 1


# ---------------------------------------------------------------------------
# cross-attention: the kernels' plain versions, the module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk", [(1, 37), (6, 37), (5, 48)])
def test_plain_cross_attention_paths_match_reference(Sq, Sk):
    """Cross-attention's two kernels, by their plain versions, against the
    reference's ``blockwise_attention`` (no mask, chunks of 16): flash at
    Sq != Sk with Sk not a multiple of 8 (or of 16), and for one query
    row the contiguous decode at G 1 over the encoder rows, every row's
    length Sk and no max_len cut.  Then the port's
    ``cross_attention_apply`` in each mode (prefill and chunk on flash,
    decode on the decode kernel, train on blockwise attention) against
    the reference's, on one reduced layer's weights."""
    H, hd = 4, 16
    rng = np.random.default_rng(Sq * 100 + Sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, hd), (B, Sk, H, hd), (B, Sk, H, hd)))
    want = np.asarray(jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        chunk_q=16, chunk_k=16))
    _close(flash_attention_plain(_t(q), _t(k), _t(v), causal=False), want,
           OP_TOL)
    if Sq == 1:
        lengths = torch.full((B,), Sk, dtype=torch.int32)
        _close(decode_attention_plain(_t(q)[:, 0], _t(k), _t(v), lengths),
               want[:, 0], OP_TOL)
    cfg = reduced_config(ARCH)
    jcfg = j_reduced_config(ARCH)
    jl = jax.tree_util.tree_map(lambda a: a[1], _tree()["unit"][0]["cross"])
    tl = _track1({n: _t(a) for n, a in jl.items()})
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, Sk, cfg.d_model)).astype(np.float32)
    jkv = jattn.cross_kv({n: jnp.asarray(a) for n, a in jl.items()},
                         jnp.asarray(enc))
    want = jattn.cross_attention_apply(
        {n: jnp.asarray(a) for n, a in jl.items()}, jnp.asarray(x), jkv,
        cfg=jcfg)
    kv = attn.cross_kv(tl, _t(enc)[None])
    _close(kv[0][0], jkv[0], OP_TOL)
    modes = ("decode", "train") if Sq == 1 else ("prefill", "chunk", "train")
    for mode in modes:
        got = attn.cross_attention_apply(tl, _t(x)[None], kv, cfg=cfg,
                                         mode=mode)
        _close(got[0], want, OP_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_refuses_encoder_decoder_models(ref):
    """The port's Engine and ModelRunner raise the reference's ValueError
    before any other check (no device given: it would otherwise refuse
    the CPU), as the JAX engine does; the serve CLI exits with it; the
    capability table's paged verdict is the reference's."""
    cfg, params = _port(ref)
    with pytest.raises(ValueError, match=REFUSAL):
        JEngine(j_reduced_config(ARCH), jax.tree_util.tree_map(
            jnp.asarray, ref["tree"]), max_slots=2, max_seq_len=32)
    for cls in (Engine, ModelRunner):
        with pytest.raises(ValueError, match=REFUSAL):
            cls(cfg, params, max_slots=2, max_seq_len=32)
        with pytest.raises(ValueError, match=REFUSAL):
            cls(cfg, params, max_slots=2, max_seq_len=32, device="cpu")
    with pytest.raises(ValueError, match=REFUSAL):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    caps, jcaps = arch_capabilities(cfg), j_arch_capabilities(
        j_reduced_config(ARCH))
    for k, c in caps.items():
        assert (c.supported, c.reason) == (jcaps[k].supported,
                                           jcaps[k].reason), k
