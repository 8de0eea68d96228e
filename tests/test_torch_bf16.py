"""Port parity at bfloat16: the bf16 contracts of the three float kernels'
plain versions (B2 ``flash_attention``, B3 ``qmatmul_f32_blockscale``, B7
``selective_scan``), the attention functions at a bf16 compute dtype, and the
decoder-only families (dense qwen3-0.6b, SSM falcon-mamba-7b, hybrid
hymba-1.5b) and whisper-tiny with ``dtype`` / ``attn_dtype`` /
``scan_dtype = "bfloat16"``, held against the JAX package on the CPU.

Tolerances.  The port rounds where the reference rounds (the activations
follow XLA's op-by-op bf16 arithmetic, ``models/layers.py``): with XLA's
``--xla_allow_excess_precision=false`` the bf16 forward of all three smoke
configs is bit-equal to the reference's (``test_bf16_forward_is_bit_equal_
without_excess_precision``).  Under XLA's default a fused bf16 chain skips
some of those roundings, so logits differ by a few bf16 ulps: the tests
hold them to BF16_ULPS ulps of the largest logit (2^-8 of it an ulp).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.qmatmul import qmatmul_f32_blockscale as jblockscale  # noqa: E402
from repro.kernels.ssm_scan import selective_scan_fused as jscan  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

BF16 = "bfloat16"
# logits: BF16_ULPS bf16 ulps (2^-8 of the magnitude) of the largest logit.
# The three smoke configs' largest differences under XLA's default are 1.5
# (qwen3-0.6b), 2.3 (falcon-mamba-7b) and 2.5 (hymba-1.5b) ulps
BF16_ULPS = 4
# serve steps: decode reads the bf16 KV cache that earlier steps wrote, so
# the roundings XLA skips compound (4.04 ulps at hymba-1.5b's third decode
# step); with excess precision off the prefill is bit-equal here too
STEP_ULPS = 8
# a kernel's plain version at bf16 against the Pallas kernel (interpret) or
# its jnp counterpart: both widen the same bf16 inputs and compute in f32,
# then round the output to bf16, so they differ by the f32 tolerance before
# that rounding, which may move it by one bf16 ulp: two ulps of the output
BF16_OUT = dict(rtol=2 ** -7, atol=1e-5)
ARCHS = ("qwen3-0.6b", "falcon-mamba-7b", "hymba-1.5b")


def _ulps_close(got, expect, ulps=BF16_ULPS):
    got = np.asarray(got, np.float32)
    expect = np.asarray(expect, np.float32)
    assert got.shape == expect.shape
    tol = ulps * np.abs(expect).max() * 2.0 ** -8
    err = np.abs(got - expect).max()
    assert err <= tol, f"max abs err {err} > {ulps} bf16 ulps ({tol})"


def _np(t):
    return t.to(torch.float32).numpy()


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def bf16_model(request):
    """(JAX cfg, port cfg, JAX tree) of the arch's smoke config at
    ``dtype="bfloat16"``, seed 0."""
    arch = request.param
    cfg = get_config(arch).smoke().replace(dtype=BF16)
    return cfg, tget(arch).smoke().replace(dtype=BF16), \
        jtfm.init_params(cfg, jax.random.PRNGKey(0))


# --- the kernels' plain versions at bf16 ---

@pytest.mark.parametrize("sq,sk,d,window,causal", [
    (16, 16, 64, None, True), (8, 40, 32, 12, True), (24, 24, 16, None, False),
    (5, 33, 128, None, True)])
def test_plain_flash_takes_bf16_as_the_pallas_kernel(rng, sq, sk, d, window,
                                                    causal):
    """B2's plain version at bf16 q, k, v: f32 inside, the output in q's
    dtype, as the Pallas kernel (interpret mode) computes it."""
    q, k, v = (rng.normal(size=(3, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    expect = jflash(jq, jk, jv, causal=causal, window=window, bq=8, bk=8,
                    interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jq, jk, jv))
    got = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and expect.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(expect, np.float32),
                               **BF16_OUT)
    assert torch.equal(ops.attention(tq, tk, tv, causal=causal,
                                     window=window), got)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k", [(4, 64), (3, 70)])
def test_plain_blockscale_takes_bf16_x(rng, bits, m, k):
    """B3's plain version at bf16 x against the Pallas kernel (interpret
    mode) at the same bf16 x: f32 out, the f32 kernel test's tolerance."""
    n = 9
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
    levels, scales = jquantize.quantize_blockwise(
        rng.normal(size=(n, k)).astype(np.float32), bits)
    packed = np.array(jpacking.pack(levels, bits))
    expect = jblockscale(x, jnp.asarray(packed), jnp.asarray(scales),
                         bits=bits, k_orig=k, bm=16, bn=16, bk=64,
                         interpret=True)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    got = ops.quant_matmul_blockscale(tx, torch.from_numpy(packed),
                                      torch.from_numpy(scales), bits=bits,
                                      k_orig=k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bsz,s,di,n", [(2, 16, 24, 4), (1, 40, 16, 16)])
def test_plain_scan_takes_bf16_as_the_pallas_kernel(rng, bsz, s, di, n):
    """B7's plain version at bf16 x, dt, B, C (f32 A, D): f32 inside, y in
    x's dtype, as the Pallas kernel (interpret mode) computes it."""
    x, B, C = (rng.normal(size=sh).astype(np.float32)
               for sh in ((bsz, s, di), (bsz, s, n), (bsz, s, n)))
    dt = rng.uniform(0.001, 0.1, (bsz, s, di)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (di, n)).astype(np.float32)
    D = rng.normal(size=(di,)).astype(np.float32)
    jx, jdt, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, dt, B, C))
    expect = jscan(jx, jdt, jnp.asarray(A), jB, jC, jnp.asarray(D), chunk=8,
                   di_block=8, interpret=True)
    tx, tdt, tB, tC = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jx, jdt, jB, jC))
    y, h = ops.selective_scan(tx, tdt, torch.from_numpy(A), tB, tC,
                              torch.from_numpy(D))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(expect, np.float32),
                               **BF16_OUT)


# --- the attention functions at a bf16 compute dtype ---

def _attn_inputs(rng, dtype, b=2, hq=4, hkv=2, sq=12, sk=20, d=16):
    arrs = [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    js = [jnp.asarray(a, jdt) for a in arrs]
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in js]
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", BF16])
@pytest.mark.parametrize("fn", ["chunked", "windowed", "decode"])
def test_attention_at_bf16_compute_matches_jax(rng, fn, dtype):
    """``chunked_attention`` (per-row offsets, a window, blocks of 8),
    ``windowed_attention`` and ``decode_attention`` (per-row lengths) at
    ``compute_dtype=bf16``, on f32 and on bf16 (a bf16 ``dtype``) inputs:
    the port rounds q * scale, k, v and P to bf16 where the reference does
    and sums in f32, so the outputs agree within the f32 parity tolerance,
    plus one ulp of a bf16 output."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(rng, dtype)
    cdt = dict(compute_dtype=jnp.bfloat16), dict(compute_dtype=torch.bfloat16)
    if fn == "chunked":
        off = np.array([8, 3], np.int32)
        expect = jattn.chunked_attention(jq, jk, jv, window=6, block=8,
                                         q_offset=jnp.asarray(off), **cdt[0])
        got = attention.chunked_attention(tq, tk, tv, window=6, block=8,
                                          q_offset=torch.from_numpy(off),
                                          **cdt[1])
    elif fn == "windowed":
        expect = jattn.windowed_attention(jq, jk[:, :, :12], jv[:, :, :12],
                                          window=5, bq=4, **cdt[0])
        got = attention.windowed_attention(tq, tk[:, :, :12], tv[:, :, :12],
                                           window=5, bq=4, **cdt[1])
    else:
        lens = np.array([20, 9], np.int32)
        expect = jattn.decode_attention(jq[:, :, :1], jk, jv,
                                        jnp.asarray(lens), window=7, **cdt[0])
        got = attention.decode_attention(tq[:, :, :1], tk, tv,
                                         torch.from_numpy(lens), window=7,
                                         **cdt[1])
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=2 ** -8, atol=1e-4) if dtype == BF16 else \
        dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(expect, np.float32), **tol)
    # the bf16 compute dtype moves the output beyond that tolerance
    f32 = (attention.decode_attention(tq[:, :, :1], tk, tv,
                                      torch.tensor([20, 9]), window=7)
           if fn == "decode" else None)
    if f32 is not None and dtype == "float32":
        assert (f32 - got).abs().max() > 1e-5


@pytest.mark.parametrize("dtype", ["float32", BF16])
@pytest.mark.parametrize("compute", ["float32", BF16])
def test_kernel_attention_is_the_reference_chunked_attention(rng, dtype,
                                                              compute):
    """``kernels.ops.attention`` (the flash kernel's wrapper, its plain
    version on the CPU) at each compute dtype, on f32 and on bf16 inputs,
    against the reference's ``chunked_attention`` over one block of keys
    (per-row offsets, a window): q scaled in f32 and rounded to the compute
    dtype, k and v rounded, P rounded where the compute dtype is bf16 and
    kept f32 where it is f32, so the two compute one function and differ
    by sums in another order: within the f32 parity tolerance, and one
    ulp where the output is bf16."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(rng, dtype)
    off = np.array([8, 3], np.int32)
    expect = jattn.chunked_attention(
        jq, jk, jv, window=6, block=32, q_offset=jnp.asarray(off),
        compute_dtype=getattr(jnp, compute))
    got = ops.attention(tq, tk, tv, window=6,
                        q_offset=torch.from_numpy(off),
                        compute_dtype=getattr(torch, compute))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == BF16 else \
        dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(expect, np.float32), **tol)


# --- the decoder-only families at dtype = bfloat16 ---

def test_bf16_forward_matches_jax(bf16_model):
    cfg, tcfg, params = bf16_model
    toks = _tokens((2, 16))
    expect = jtfm.forward(params, jnp.asarray(toks), cfg)
    got = tfm.forward(_carry(params, tcfg), torch.from_numpy(toks).long(),
                      tcfg)
    assert got.dtype == torch.bfloat16
    _ulps_close(_np(got), np.asarray(expect, np.float32))


_EXACT_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import transformer as jtfm
out = {}
for arch in sys.argv[2:]:
    cfg = get_config(arch).smoke().replace(dtype="bfloat16")
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    out[arch] = np.asarray(jtfm.forward(params, jnp.asarray(toks), cfg),
                           np.float32)
np.savez(sys.argv[1], **out)
"""


def test_bf16_forward_is_bit_equal_without_excess_precision(tmp_path):
    """With XLA's bf16 excess precision off (every op rounded to bf16, as
    the port's ops round), the reference's bf16 forward of each family's
    smoke config equals the port's bit for bit: the port rounds where the
    reference rounds (ROADMAP C13)."""
    out = tmp_path / "logits.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _EXACT_SCRIPT, str(out), *ARCHS],
                   env=env, check=True, timeout=600)
    expect = np.load(out)
    toks = torch.from_numpy(_tokens((2, 16))).long()
    for arch in ARCHS:
        cfg = get_config(arch).smoke().replace(dtype=BF16)
        tcfg = tget(arch).smoke().replace(dtype=BF16)
        params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
        got = _np(tfm.forward(_carry(params, tcfg), toks, tcfg))
        np.testing.assert_array_equal(got, expect[arch], err_msg=arch)


def test_bf16_activations_tighten_parity_under_default_xla(bf16_model,
                                                          monkeypatch):
    """Under XLA's default flags (bf16 excess precision on, how the
    reference runs), the port's op-by-op bf16 activations (``layers.silu``,
    ``gelu_tanh``, ``softplus``) bring its bf16 forward closer to the
    reference's than PyTorch's fused ops at bf16 do: a smaller mean logit
    difference on 2 x 64 tokens (qwen3-0.6b 8 %, falcon-mamba-7b 24 %,
    hymba-1.5b 15 % smaller); the readings are printed."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    cfg, tcfg, params = bf16_model
    toks = _tokens((2, 64))
    expect = np.asarray(jtfm.forward(params, jnp.asarray(toks), cfg),
                        np.float32)
    tparams = _carry(params, tcfg)
    errs = {}
    for name in ("op by op", "fused"):
        got = _np(tfm.forward(tparams, torch.from_numpy(toks).long(), tcfg))
        errs[name] = (np.abs(got - expect).mean(),
                      np.abs(got - expect).max() / np.abs(expect).max() * 256)
        monkeypatch.setattr(layers, "silu", F.silu)
        monkeypatch.setattr(layers, "gelu_tanh",
                            lambda x: F.gelu(x, approximate="tanh"))
        monkeypatch.setattr(layers, "softplus", lambda x: torch.logaddexp(
            x, torch.zeros((), dtype=x.dtype)))
    print(f"{cfg.name}: mean |diff|, max in ulps of the largest logit: "
          + ", ".join(f"{k} {m:.3e} {u:.2f}" for k, (m, u) in errs.items()))
    assert errs["op by op"][0] < errs["fused"][0]


def test_bf16_prefill_then_decode_step_matches_jax(bf16_model):
    """``step`` at a bf16 ``dtype``: a scalar-pos prefill, a per-row chunk,
    then per-row decode, frozen at 8 bits; logits and the bf16 KV cache (and
    the f32 SSM state) within the bf16 tolerance."""
    cfg, tcfg, params = bf16_model
    packed = jfreeze(params, bits=8)
    tparams = _carry(packed, tcfg)
    b, max_len = 2, 48
    jcache = jtfm.init_serve_cache(cfg, b, max_len)
    tcache = tfm.init_serve_cache(tcfg, b, max_len, device="cpu")

    def both(toks, pos):
        nonlocal jcache, tcache
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = (torch.tensor(pos, dtype=torch.int32)
                if isinstance(pos, list) else pos)
        jl, jcache = jtfm.step(packed, jnp.asarray(toks), jcache, jpos, cfg)
        tl, tcache = tfm.step(tparams, torch.from_numpy(toks).long(), tcache,
                              tpos, tcfg)
        _ulps_close(_np(tl), np.asarray(jl, np.float32), STEP_ULPS)
        for part in ("kv", "ssm"):
            for name, c in tcache.get(part, {}).items():
                assert c.dtype == getattr(torch, str(jcache[part][name].dtype))
                _ulps_close(_np(c), np.asarray(jcache[part][name], np.float32),
                            STEP_ULPS)

    prefix = cfg.n_meta_tokens
    both(_tokens((b, 8), 2), 0)
    if cfg.family != "hybrid":                  # chunks after the first
        both(_tokens((b, 4), 3), [8, 5])
        start = [12, 9]
    else:
        start = [prefix + 8, prefix + 8]
    for t in range(3):
        both(_tokens((b, 1), 4 + t), [p + t for p in start])


def test_bf16_serve_steps_match_jax(bf16_model):
    """``launch/steps.make_prefill_step`` / ``make_decode_step`` at a bf16
    ``dtype``: the prefill's logits, then 4 greedy decode steps' logits, and
    the tokens wherever the reference's top-2 margin exceeds the
    tolerance."""
    cfg, tcfg, params = bf16_model
    packed = jfreeze(params, bits=8)
    tparams = _carry(packed, tcfg)
    toks = _tokens((2, 10), 5)
    jl, jcache = jsteps.make_prefill_step(cfg)(packed, jnp.asarray(toks),
                                               jtfm.init_serve_cache(cfg, 2,
                                                                     32))
    tl, tcache = steps.make_prefill_step(tcfg)(
        tparams, torch.from_numpy(toks).long(),
        tfm.init_serve_cache(tcfg, 2, 32, device="cpu"))
    pos = cfg.n_meta_tokens + 10
    for i in range(4):
        jlast = np.asarray(jl[:, -1], np.float32)
        _ulps_close(_np(tl[:, -1]), jlast, STEP_ULPS)
        top2 = np.sort(jlast, -1)[:, -2:]
        tol = STEP_ULPS * np.abs(jlast).max() * 2.0 ** -8
        nxt = jlast.argmax(-1).astype(np.int32)[:, None]
        sure = top2[:, 1] - top2[:, 0] > 2 * tol
        assert np.array_equal(_np(tl[:, -1]).argmax(-1)[sure], nxt[sure, 0])
        jl, jcache = jsteps.make_decode_step(cfg)(
            packed, jnp.asarray(nxt), jcache, jnp.int32(pos + i))
        tl, tcache = steps.make_decode_step(tcfg)(
            tparams, torch.from_numpy(nxt).long(), tcache, pos + i)


# --- whisper-tiny: attn_dtype is not read by the encoder-decoder ---

def test_whisper_ignores_attn_dtype_as_the_reference(rng):
    """whisper-tiny's smoke config with ``attn_dtype="bfloat16"``: the
    reference's encoder-decoder never reads the field and computes in f32,
    and so does the port (ROADMAP C14): the serve steps' logits match JAX's
    within the f32 tolerance, equal the f32 config's, and give the same
    greedy tokens."""
    cfg = get_config("whisper-tiny").smoke().replace(attn_dtype=BF16)
    tcfg = tget("whisper-tiny").smoke().replace(attn_dtype=BF16)
    params = jfreeze(jenc.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    tparams = _carry(params, tcfg)
    frames = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)
    toks = _tokens((2, 4), 9)
    jl, jc = jsteps.make_prefill_step(cfg)(
        params, jnp.asarray(frames), jnp.asarray(toks),
        jenc.init_serve_cache(cfg, 2, 16))
    tl, tc = steps.make_prefill_step(tcfg)(
        tparams, torch.from_numpy(frames), torch.from_numpy(toks).long(),
        encdec.init_serve_cache(tcfg, 2, 16, device="cpu"))
    f32 = tcfg.replace(attn_dtype="float32")
    tl32, _ = steps.make_prefill_step(f32)(
        tparams, torch.from_numpy(frames), torch.from_numpy(toks).long(),
        encdec.init_serve_cache(f32, 2, 16, device="cpu"))
    assert torch.equal(tl, tl32)
    jtoks, ttoks = [], []
    for i in range(6):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        jn = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)[:, None]
        tn = tl[:, -1].argmax(-1, keepdim=True)
        jtoks.append(jn[:, 0].tolist())
        ttoks.append(tn[:, 0].tolist())
        jl, jc = jsteps.make_decode_step(cfg)(params, jnp.asarray(jn), jc,
                                              jnp.int32(4 + i))
        tl, tc = steps.make_decode_step(tcfg)(tparams, tn, tc, 4 + i)
    assert ttoks == jtoks


_DEEP_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import transformer as jtfm
bf = "bfloat16"
cfg = get_config("hymba-1.5b").smoke().replace(n_layers=32)
params = jtfm.init_params(cfg.replace(dtype=bf, attn_dtype=bf,
                                      scan_dtype=bf), jax.random.PRNGKey(0))
toks = np.random.default_rng(1).integers(0, 256, (2, 64)).astype(np.int32)
out = {name: np.asarray(jtfm.forward(params, jnp.asarray(toks),
                                     cfg.replace(**rep)), np.float32)
       for name, rep in (("dtype", dict(dtype=bf)),
                         ("compute", dict(dtype=bf, attn_dtype=bf)))}
np.savez(sys.argv[1], **out)
"""
# hymba-1.5b's smoke config at its 32 layers, port against reference at
# XLA's bf16 excess precision off (the rounding order the port follows):
# bf16 roundings that fall one ulp apart carry through 32 layers; the
# readings are 12.2 (dtype) and 15.8 (all three) ulps of the largest logit
DEEP_ULPS = 20


def test_deep_hybrid_bf16_forward_matches_the_reference(tmp_path):
    """hymba-1.5b's smoke config at its full 32 layers, 2 x 64 tokens: the
    port's bf16 forward (``dtype`` bf16; and ``dtype``, ``attn_dtype`` and
    ``scan_dtype`` bf16) against the reference's at the same dtypes, the
    reference run with XLA's bf16 excess precision off, the rounding order
    the port follows (ROADMAP C13).  The port's bf16 scan is the Pallas
    kernel's contract (f32 inside), so the reference computes its scan in
    f32 there.  Within DEEP_ULPS ulps of the largest logit, and closer than
    the reference comes to itself between XLA's two precision settings
    (its default run in this process): deep bf16 drift is rounding order,
    the model's own, and no error of the port."""
    out = tmp_path / "deep.npz"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _DEEP_SCRIPT, str(out)], env=env,
                   check=True, timeout=600)
    exact = np.load(out)
    arch, layers = "hymba-1.5b", 32
    bf = dict(dtype=BF16, attn_dtype=BF16, scan_dtype=BF16)
    cfg = get_config(arch).smoke().replace(n_layers=layers)
    tcfg = tget(arch).smoke().replace(n_layers=layers)
    params = jtfm.init_params(cfg.replace(**bf), jax.random.PRNGKey(0))
    toks = _tokens((2, 64))

    def ulps(got, expect):
        return np.abs(got - expect).max() / np.abs(expect).max() * 256

    for name, rep, jrep in (
            ("dtype", dict(dtype=BF16), dict(dtype=BF16)),
            ("compute", bf, dict(dtype=BF16, attn_dtype=BF16))):
        got = _np(tfm.forward(_carry(params, tcfg.replace(**rep)),
                              torch.from_numpy(toks).long(),
                              tcfg.replace(**rep)))
        default = np.asarray(jtfm.forward(params, jnp.asarray(toks),
                                          cfg.replace(**jrep)), np.float32)
        port, self_ = ulps(got, exact[name]), ulps(default, exact[name])
        print(f"{name}: port vs reference {port:.2f} ulps, reference at "
              f"XLA's default vs excess precision off {self_:.2f} ulps")
        assert port <= DEEP_ULPS, name
        assert port < self_, name


def test_deep_hybrid_bf16_drift_is_the_reference_s():
    """hymba-1.5b's smoke config at its full 32 layers: bf16 (``dtype``,
    ``attn_dtype`` and ``scan_dtype``) moves the reference's own logits by
    more than 5 % of the largest from its f32 forward on the same weights
    (11 % on these tokens), and the port's bf16 forward moves by no more
    than twice that (14 %): deep bf16 drift is the model's, not a kernel's
    (the card's bf16 serve of the full-width model agrees with its f32
    serve on fewer greedy tokens than qwen3-0.6b's)."""
    arch, layers = "hymba-1.5b", 32
    bf = dict(dtype=BF16, attn_dtype=BF16, scan_dtype=BF16)
    cfg = get_config(arch).smoke().replace(n_layers=layers)
    tcfg = tget(arch).smoke().replace(n_layers=layers)
    pbf = jtfm.init_params(cfg.replace(**bf), jax.random.PRNGKey(0))
    p32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        pbf)
    toks = _tokens((2, 64))
    j32 = np.asarray(jtfm.forward(p32, jnp.asarray(toks), cfg), np.float32)
    jbf = np.asarray(jtfm.forward(pbf, jnp.asarray(toks), cfg.replace(**bf)),
                     np.float32)
    t32 = _np(tfm.forward(_carry(p32, tcfg), torch.from_numpy(toks).long(),
                          tcfg))
    tbf = _np(tfm.forward(_carry(pbf, tcfg.replace(**bf)),
                          torch.from_numpy(toks).long(), tcfg.replace(**bf)))
    ref_drift = np.abs(jbf - j32).max() / np.abs(j32).max()
    port_drift = np.abs(tbf - t32).max() / np.abs(t32).max()
    assert ref_drift > 0.05
    assert port_drift <= 2 * ref_drift
