"""Port parity: the plain flash attention against the reference Pallas kernel
(interpret mode) and its oracle on the cases of ``test_kernels.py``
(tolerance 3e-5, the reference test's), and against the reference
``chunked_attention`` / ``decode_attention`` with the GQA fold and per-row
query offsets that model prefill and decode use."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (37, 37, True, None), (17, 80, True, None),
    (64, 64, True, 16), (50, 50, False, None), (1, 64, True, None),
])
def test_flash_attention_matches_reference_kernel(rng, sq, sk, causal, window):
    q = rng.normal(size=(3, sq, 16)).astype(np.float32)
    k = rng.normal(size=(3, sk, 16)).astype(np.float32)
    v = rng.normal(size=(3, sk, 16)).astype(np.float32)
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, bq=16, bk=16,
                    interpret=True)
    oracle = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert got.shape == (3, sq, 16)
    for expect in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def _gqa(rng, b=2, hq=4, hkv=2, sq=8, sk=32, d=16):
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("q_offset", [0, 24, (3, 17)])
def test_gqa_offsets_match_chunked_attention(rng, window, q_offset):
    q, k, v = _gqa(rng)
    off_j = jnp.asarray(q_offset, jnp.int32)
    off_t = torch.tensor(q_offset, dtype=torch.int32)
    expect = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window, q_offset=off_j, block=8)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window,
                        q_offset=off_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    # the port's own blocked version of chunked_attention agrees too
    chunked = attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, q_offset=off_t, block=8)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(expect), **TOL)


def test_folded_form_is_the_unoffset_equal_heads_case(rng):
    q, k, v = _gqa(rng, hq=2, hkv=2, sq=8, sk=20)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    four = ref.flash_attention(tq, tk, tv, q_offset=None)
    three = ref.flash_attention(tq.reshape(4, 8, 16), tk.reshape(4, 20, 16),
                                tv.reshape(4, 20, 16))
    np.testing.assert_allclose(three.reshape(2, 2, 8, 16).numpy(),
                               four.numpy(), rtol=0, atol=0)
    offset = ref.flash_attention(tq, tk, tv, q_offset=12)
    np.testing.assert_array_equal(offset.numpy(), four.numpy())


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_per_batch_lengths(rng, window):
    q, k, v = _gqa(rng, sq=1, sk=24)
    lens = np.array([5, 24], np.int32)
    expect = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lens),
                                    window=window)
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_update_cache_per_batch_positions(rng):
    cache = {n: np.zeros((2, 2, 16, 4), np.float32) for n in ("k", "v")}
    k_new = rng.normal(size=(2, 2, 3, 4)).astype(np.float32)
    v_new = rng.normal(size=(2, 2, 3, 4)).astype(np.float32)
    for pos in (np.array([0, 15], np.int32), 14):
        expect = jattn.update_cache({n: jnp.asarray(c) for n, c in
                                     cache.items()}, jnp.asarray(k_new),
                                    jnp.asarray(v_new), jnp.asarray(pos))
        tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        got = attention.update_cache(tcache, torch.from_numpy(k_new),
                                     torch.from_numpy(v_new), tpos)
        for n in ("k", "v"):
            np.testing.assert_array_equal(got[n].numpy(),
                                          np.asarray(expect[n]))
