"""Port parity: the other dense archs served.  qwen2.5-3b (qkv bias, GQA),
olmo-1b (non-parametric LayerNorm) and gemma-7b (GeGLU, the embedding
scale, head dim 256 at full width) at their smoke configs, and gemma-7b's
smoke config at its own head dim of 256, through ``ServingEngine`` on the
CPU and through the prefill / decode ``step``, against the JAX package on
the same weights (drawn by JAX, carried over by ``interop``).  Greedy
tokens are equal; logits and caches agree within the transformer tests'
1e-4 (both sides compute in f32, in another summation order)."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_transformer.py's
# (arch, head dim replacing the smoke config's 16, or None)
ARCHS = [("qwen2.5-3b", None), ("olmo-1b", None), ("gemma-7b", None),
         ("gemma-7b", 256)]
IDS = ["qwen2.5-3b", "olmo-1b", "gemma-7b", "gemma-7b-hd256"]


def _configs(arch, head_dim):
    jcfg, tcfg = jget(arch).smoke(), tget(arch).smoke()
    if head_dim is not None:
        jcfg, tcfg = (c.replace(head_dim=head_dim) for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def trees():
    """{(arch, head dim): (JAX cfg, port cfg, JAX f32 tree)}, drawn once."""
    out = {}
    for arch, hd in ARCHS:
        jcfg, tcfg = _configs(arch, hd)
        out[arch, hd] = (jcfg, tcfg, jtfm.init_params(jcfg,
                                                      jax.random.PRNGKey(2)))
    return out


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch,head_dim", ARCHS, ids=IDS)
def test_engine_tokens_equal_jax(trees, arch, head_dim):
    """Five requests on four slots, prompts of 5-19 tokens in chunks of 8
    (several pow2 buckets at per-row offsets), 6 new tokens each."""
    jcfg, tcfg, params = trees[arch, head_dim]
    packed = jfreeze(params, bits=8)
    engine = dict(scenario="l1mram", mode="xla", bits=8)
    prompts = _prompts(5, [5, 19, 8, 12, 7])
    jeng = JEngine(jcfg, packed, batch_slots=4, max_len=64, engine=engine,
                   prefill_chunk=8)
    teng = ServingEngine(tcfg, _carry(packed, tcfg), batch_slots=4,
                         max_len=64, engine=engine, prefill_chunk=8,
                         device="cpu")
    for uid, p in enumerate(prompts):
        jeng.submit(JRequest(uid=uid, prompt=p, max_new_tokens=6))
        teng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    want = {r.uid: r.generated for r in jeng.run_until_done()}
    got = {r.uid: r.generated for r in teng.run_until_done()}
    assert got == want
    assert set(got) == set(range(5)) and all(len(t) == 6
                                             for t in got.values())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch,head_dim", ARCHS, ids=IDS)
def test_prefill_and_decode_logits_equal_jax(trees, arch, head_dim, bits):
    """The engine's model calls: a prefill at position 0, a chunk at
    per-row offsets, then decode at per-row positions; logits and the KV
    cache within TOL at each."""
    jcfg, tcfg, params = trees[arch, head_dim]
    packed = jfreeze(params, bits=bits)
    tparams = _carry(packed, tcfg)
    engine = dict(scenario="l1mram", mode="xla", bits=bits)
    b, max_len = 2, 32
    jcache = jtfm.init_serve_cache(jcfg, b, max_len)
    tcache = tfm.init_serve_cache(tcfg, b, max_len, device="cpu")

    def both(toks, pos):
        nonlocal jcache, tcache
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = (torch.tensor(pos, dtype=torch.int32)
                if isinstance(pos, list) else pos)
        jl, jcache = jtfm.step(packed, jnp.asarray(toks), jcache, jpos, jcfg,
                               engine=engine)
        tl, tcache = tfm.step(tparams, torch.from_numpy(toks).long(),
                              tcache, tpos, tcfg, engine=engine)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache["kv"][n].numpy(),
                                       np.asarray(jcache["kv"][n]), **TOL)

    both(_tokens((b, 8), 2), 0)                 # prefill, scalar pos
    both(_tokens((b, 4), 3), [8, 5])            # chunk at per-row offsets
    for t in range(3):                          # decode, per-row pos
        both(_tokens((b, 1), 4 + t), [12 + t, 9 + t])
    if head_dim is not None:
        assert tcache["kv"]["k"].shape[-1] == head_dim
