"""Port parity: the encoder-decoder family (whisper-tiny) through
``repro_torch.models.encdec`` and ``launch.steps`` against
``repro.models.encdec`` / ``repro.launch.steps`` on the smoke config, with
the JAX weights carried over by ``repro_torch.interop``.

Encoder states, logits and caches agree within 1e-4 (absolute and
relative): both sides compute in f32; the reference attends with the jnp
``chunked_attention``, the port through its flash kernel's plain version on
the CPU, and the sinusoid positions may differ by an ulp (``jnp.sin`` and
``torch.sin``).  Greedy tokens through the serve steps are equal."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.placement import Placement as JPlacement  # noqa: E402
from repro.core.placement import PlacementPlan as JPlan  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.placement import Placement, PlacementPlan  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).smoke()
    params = jenc.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tget(ARCH).smoke(), params


@pytest.fixture(scope="module")
def trees(model):
    """{bits (None: dense): (JAX tree, port tree)}."""
    cfg, tcfg, params = model
    out = {None: (params, _carry(params, tcfg))}
    for bits in (8, 4):
        packed = jfreeze(params, bits=bits)
        out[bits] = (packed, _carry(packed, tcfg))
    return out


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _engine(bits):
    return None if bits is None else dict(scenario="l1mram", mode="xla",
                                          bits=bits)


def _frames(cfg, b, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, expect):
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_init_params_has_the_reference_structure(model):
    cfg, tcfg, params = model
    tparams = encdec.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    ref = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
           for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): (tuple(x.shape),
                                     str(x.dtype).replace("torch.", ""))
           for p, x in jax.tree_util.tree_leaves_with_path(tparams)}
    assert got == ref
    assert tparams["dec_pos"].shape == (4096 + 32768, cfg.d_model)
    assert abs(tparams["dec_pos"].std().item() - 0.01) < 1e-3
    again = encdec.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["dec_layers"]["xattn"]["wk"],
                       tparams["dec_layers"]["xattn"]["wk"])


def test_sinusoid_at_full_width():
    """whisper-tiny's 1,500 x 384 table: ``jnp.sin`` / ``jnp.cos`` and the
    torch ones round a few entries differently (at most 4e-6 here)."""
    expect = np.asarray(jenc._sinusoid(1500, 384))
    np.testing.assert_allclose(encdec._sinusoid(1500, 384).numpy(), expect,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_encode(model, trees, bits):
    cfg, tcfg, _ = model
    jtree, ttree = trees[bits]
    fr = _frames(cfg, 2)
    _close(encdec.encode(ttree, _t(fr), tcfg, engine=_engine(bits)),
           jenc.encode(jtree, jnp.asarray(fr), cfg, engine=_engine(bits)))


@pytest.mark.parametrize("bits", [None, 8])
def test_decode(model, trees, bits):
    """The cache-free decoder (causal self-attention + cross-attention)."""
    cfg, tcfg, _ = model
    jtree, ttree = trees[bits]
    enc = _frames(cfg, 2, seed=4) * 0.5
    toks = _tokens((2, 9))
    got = encdec.decode(ttree, _t(toks).long(), _t(enc), tcfg,
                        engine=_engine(bits))
    assert got.shape == (2, 9, cfg.vocab_size)
    _close(got, jenc.decode(jtree, jnp.asarray(toks), jnp.asarray(enc), cfg,
                            engine=_engine(bits)))


def test_precompute_cross_kv(model, trees):
    cfg, tcfg, _ = model
    jtree, ttree = trees[8]
    enc = _frames(cfg, 2, seed=5)
    jc = jenc.precompute_cross_kv(jtree, jnp.asarray(enc), cfg,
                                  jenc.init_serve_cache(cfg, 2, 16),
                                  engine=_engine(8))
    tc = encdec.precompute_cross_kv(
        ttree, _t(enc), tcfg,
        encdec.init_serve_cache(tcfg, 2, 16, device="cpu"),
        engine=_engine(8))
    for name in ("xk", "xv"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        _close(tc[name], jc[name])


@pytest.mark.parametrize("bits", [8, 4])
def test_step_prefill_then_decode(model, trees, bits):
    """Prefill at position 0, then decode steps: logits and the
    self-attention cache agree."""
    cfg, tcfg, _ = model
    jtree, ttree = trees[bits]
    eng = _engine(bits)
    fr, toks = _frames(cfg, 2, seed=6), _tokens((2, 5), seed=7)
    jenc_out = jenc.encode(jtree, jnp.asarray(fr), cfg, engine=eng)
    tenc_out = encdec.encode(ttree, _t(fr), tcfg, engine=eng)
    jc = jenc.precompute_cross_kv(jtree, jenc_out, cfg,
                                  jenc.init_serve_cache(cfg, 2, 16),
                                  engine=eng)
    tc = encdec.precompute_cross_kv(
        ttree, tenc_out, tcfg,
        encdec.init_serve_cache(tcfg, 2, 16, device="cpu"), engine=eng)
    jl, jc = jenc.step(jtree, jnp.asarray(toks), jc, jnp.int32(0), cfg,
                       engine=eng)
    tl, tc = encdec.step(ttree, _t(toks).long(), tc, 0, tcfg, engine=eng)
    _close(tl, jl)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = jenc.step(jtree, jnp.asarray(nxt), jc, jnp.int32(5 + i),
                           cfg, engine=eng)
        tl, tc = encdec.step(ttree, _t(nxt).long(), tc, 5 + i, tcfg,
                             engine=eng)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["kv"][name], jc["kv"][name])


def _greedy(prefill, decode, tree, first, cache, start, n, to_host,
            as_tokens, as_pos):
    logits, cache = prefill(tree, *first, cache)
    out = []
    for i in range(n):
        nxt = to_host(logits[:, -1]).argmax(-1).astype(np.int32)[:, None]
        out.append(nxt[:, 0].tolist())
        logits, cache = decode(tree, as_tokens(nxt), cache,
                               as_pos(start + i))
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_serve_steps_greedy_tokens(model, trees, bits):
    """frames -> encode -> precompute_cross_kv -> step through
    ``make_prefill_step``, then 8 greedy ``make_decode_step`` steps."""
    cfg, tcfg, _ = model
    jtree, ttree = trees[bits]
    fr, toks = _frames(cfg, 2, seed=8), _tokens((2, 4), seed=9)
    jplan = JPlan.uniform("l1mram", bits=bits)
    plan = PlacementPlan.uniform("l1mram", bits=bits)
    expect = _greedy(jsteps.make_prefill_step(cfg, jplan),
                     jsteps.make_decode_step(cfg, jplan), jtree,
                     (jnp.asarray(fr), jnp.asarray(toks)),
                     jenc.init_serve_cache(cfg, 2, 16), 4, 8, np.asarray,
                     jnp.asarray, jnp.int32)
    got = _greedy(steps.make_prefill_step(tcfg, plan),
                  steps.make_decode_step(tcfg, plan), ttree,
                  (_t(fr), _t(toks).long()),
                  encdec.init_serve_cache(tcfg, 2, 16, device="cpu"), 4, 8,
                  lambda t: t.numpy(), lambda a: _t(a).long(), int)
    assert got == expect


def test_per_row_positions_equal_scalar(model, trees):
    """A (B,) position tensor of equal rows decodes as the scalar does."""
    cfg, tcfg, _ = model
    _, ttree = trees[8]
    fr, toks = _frames(cfg, 2, seed=10), _tokens((2, 4), seed=11)
    prefill = steps.make_prefill_step(tcfg)
    decode = steps.make_decode_step(tcfg)
    outs = []
    for pos in (4, torch.tensor([4, 4])):
        cache = encdec.init_serve_cache(tcfg, 2, 16, device="cpu")
        logits, cache = prefill(ttree, _t(fr), _t(toks).long(), cache)
        nxt = logits[:, -1].argmax(-1)[:, None]
        outs.append(decode(ttree, nxt, cache, pos)[0])
    assert torch.equal(outs[0], outs[1])


def test_mixed_plan_matches_uniform(model):
    """The port's case of ``test_placement.py::
    test_encdec_mixed_plan_matches_uniform``: a plan that cools the
    cross-attention weights is bit-exact vs the uniform plan, and both equal
    JAX's within the tolerance."""
    cfg, tcfg, params = model
    tparams = _carry(params, tcfg)
    packed = freeze_for_serving(tparams, bits=8, device="cpu")
    jpacked = jfreeze(params, bits=8)
    rng = np.random.default_rng(12)
    frames = rng.normal(size=(1, cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    outs = {}
    for name, plan, jplan in (
            ("uniform", PlacementPlan.uniform(), JPlan.uniform()),
            ("mixed", PlacementPlan.uniform("l1mram").with_rule(
                "dec_layers/xattn/*", Placement("l3mram", 8, "paged")),
             JPlan.uniform("l1mram").with_rule(
                 "dec_layers/xattn/*", JPlacement("l3mram", 8, "paged")))):
        enc_out = encdec.encode(packed, _t(frames), tcfg, engine=plan)
        outs[name] = encdec.decode(packed, _t(tokens).long(), enc_out, tcfg,
                                   engine=plan)
        jenc_out = jenc.encode(jpacked, jnp.asarray(frames), cfg,
                               engine=jplan)
        _close(outs[name], jenc.decode(jpacked, jnp.asarray(tokens),
                                       jenc_out, cfg, engine=jplan))
    assert torch.equal(outs["uniform"], outs["mixed"])


def test_interop_checks_both_stacks(model):
    cfg, tcfg, params = model
    tree = jax.tree_util.tree_map(np.asarray, params)
    for key in ("enc_layers", "dec_layers"):
        bad = dict(tree, **{key: jax.tree_util.tree_map(
            lambda a: np.concatenate([a, a]), tree[key])})
        with pytest.raises(ValueError, match=f"stacked {key} axis"):
            interop.params_from_numpy(bad, tcfg, device="cpu")
    back = interop.params_to_numpy(_carry(params, tcfg))
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                              jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_training_and_the_decoder_only_paths_refuse(model):
    _, tcfg, _ = model
    from repro_torch import optim
    from repro_torch.models import transformer as tfm

    # training is no longer refused: it takes seq2seq_loss
    assert steps._loss_fn(tcfg) is encdec.seq2seq_loss
    steps.make_train_step(tcfg, optim.adamw())
    with pytest.raises(NotImplementedError, match="models.encdec"):
        tfm.init_params(tcfg, device="cpu")
    assert steps._init_fn(tcfg) is encdec.init_params
