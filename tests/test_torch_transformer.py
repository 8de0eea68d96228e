"""Port parity: the dense LM (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the qwen3-0.6b smoke config, with the JAX
weights carried over by ``repro_torch.interop``.

Logits and caches agree within 1e-4 (absolute and relative): both sides
compute in f32 and differ only in summation order.  The reference runs
``mode="xla"``; one case also runs its Pallas kernels in interpret mode."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tget(ARCH).smoke(), params


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _engine(scenario, bits, mode="xla"):
    return dict(scenario=scenario, mode=mode, bits=bits)


def test_forward_dense_weights(model):
    cfg, tcfg, params = model
    toks = _tokens((2, 16))
    expect = jtfm.forward(params, jnp.asarray(toks), cfg)
    got = tfm.forward(_carry(params, tcfg), torch.from_numpy(toks).long(),
                      tcfg)
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("scenario,bits,mode", [
    ("l1mram", 8, "xla"), ("l1mram", 4, "xla"), ("l1mram", 2, "xla"),
    ("l1mram", 4, "interpret"), ("l2mram", 8, "xla"), ("l3mram", 8, "xla"),
])
def test_forward_packed(model, scenario, bits, mode):
    cfg, tcfg, params = model
    packed = jfreeze(params, bits=bits)
    toks = _tokens((2, 12))
    expect = jtfm.forward(packed, jnp.asarray(toks), cfg,
                          engine=_engine(scenario, bits, mode))
    got = tfm.forward(_carry(packed, tcfg), torch.from_numpy(toks).long(),
                      tcfg, engine=_engine(scenario, bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_prefill_then_decode_step(model, bits):
    """Scalar-pos prefill, a per-row chunked prefill at different offsets,
    then per-batch-pos decode: logits and both caches match."""
    cfg, tcfg, params = model
    packed = jfreeze(params, bits=bits)
    tparams = _carry(packed, tcfg)
    eng = _engine("l1mram", bits)
    b, max_len = 2, 32
    jcache = jtfm.init_serve_cache(cfg, b, max_len)
    tcache = tfm.init_serve_cache(tcfg, b, max_len, device="cpu")

    def both(toks, pos):
        nonlocal jcache, tcache
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = (torch.tensor(pos, dtype=torch.int32)
                if isinstance(pos, list) else pos)
        jl, jcache = jtfm.step(packed, jnp.asarray(toks), jcache, jpos, cfg,
                               engine=eng)
        tl, tcache = tfm.step(tparams, torch.from_numpy(toks).long(), tcache,
                              tpos, tcfg, engine=eng)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache["kv"][n].numpy(),
                                       np.asarray(jcache["kv"][n]), **TOL)

    both(_tokens((b, 8), 2), 0)                 # prefill, scalar pos
    both(_tokens((b, 4), 3), [8, 5])            # chunk at per-row offsets
    for t in range(3):                          # decode, per-batch pos
        both(_tokens((b, 1), 4 + t), [12 + t, 9 + t])


def test_interop_round_trip(model):
    cfg, tcfg, params = model
    for tree in (params, jfreeze(params, bits=4)):
        np_tree = jax.tree_util.tree_map(np.asarray, tree)
        back = interop.params_to_numpy(interop.params_from_numpy(
            np_tree, tcfg, device="cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(np_tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)
            assert flat_b[path].dtype == leaf.dtype


def test_interop_checks_the_layer_axis(model):
    cfg, tcfg, params = model
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="n_layers"):
        interop.params_from_numpy(np_tree, tcfg.replace(n_layers=3),
                                  device="cpu")


def test_init_params_has_the_reference_structure(model):
    cfg, tcfg, params = model
    tparams = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    ref_shapes = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                  for p, x in jax.tree_util.tree_leaves_with_path(params)}
    got_shapes = {jax.tree_util.keystr(p): (tuple(x.shape),
                                           str(x.dtype).replace("torch.", ""))
                  for p, x in jax.tree_util.tree_leaves_with_path(tparams)}
    assert got_shapes == ref_shapes
    wq = tparams["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.01
    again = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(again["embed"], tparams["embed"])


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-tiny"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tfm.init_params(tget(arch).smoke(), device="cpu")


# C6: the reference computes decode, chunked and windowed attention in
# cfg.attn_dtype; the port's attention kernels compute in f32 only, so its
# entry points refuse any other value instead of running it in f32.

@pytest.fixture(scope="module")
def bf16_attention_logits(model):
    cfg, tcfg, params = model
    toks = jnp.asarray(_tokens((2, 16)))
    f32 = np.asarray(jtfm.forward(params, toks, cfg))
    bf16 = np.asarray(jtfm.forward(params, toks,
                                   cfg.replace(attn_dtype="bfloat16")))
    return f32, bf16


def test_reference_attn_dtype_moves_the_logits(bf16_attention_logits):
    f32, bf16 = bf16_attention_logits
    assert np.abs(bf16 - f32).max() > TOL["atol"]


@pytest.mark.parametrize("entry", ["init_params", "forward", "engine"])
def test_attn_dtype_other_than_f32_is_refused(model, entry):
    cfg, tcfg, params = model
    bcfg = tcfg.replace(attn_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="attn_dtype.*ROADMAP C6"):
        if entry == "init_params":
            tfm.init_params(bcfg, device="cpu")
        elif entry == "forward":
            tfm.forward(_carry(params, tcfg),
                        torch.from_numpy(_tokens((2, 16))).long(), bcfg)
        else:
            ServingEngine(bcfg, _carry(params, tcfg), device="cpu")


def test_other_dense_archs_match(model):
    """qkv bias (qwen2.5), non-parametric LN (olmo) and GeGLU with the
    embedding scale (gemma) through the same dense path."""
    for arch in ("qwen2.5-3b", "olmo-1b", "gemma-7b"):
        cfg = get_config(arch).smoke()
        params = jtfm.init_params(cfg, jax.random.PRNGKey(1))
        packed = jfreeze(params, bits=8)
        toks = _tokens((1, 10))
        expect = jtfm.forward(packed, jnp.asarray(toks), cfg)
        got = tfm.forward(_carry(packed, tget(arch).smoke()),
                          torch.from_numpy(toks).long(), tget(arch).smoke())
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
