"""Port parity: the selective scan and the Mamba-1 mixer
(``repro_torch.kernels.ssm_scan`` / ``ref.selective_scan``,
``repro_torch.models.ssm``) against ``repro.models.ssm`` and the Pallas
kernel ``repro.kernels.ssm_scan.selective_scan_fused`` in interpret mode.

Tolerances are the reference's own: 5e-4 on y against the fused kernel and
the chunked scan (``test_ssm_kernel.py``), 2e-4 on h_last and on the decode
step (``test_moe_ssm.py``); the port scans one step after another, the
reference by a chunked associative scan, so the f32 sums differ in order.
The pad no-op is exact (``torch.equal``)."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels import ssm_scan as jscan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops, ref, ssm_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

Y_TOL = dict(rtol=5e-4, atol=5e-4)
H_TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, bsz, s, di, n, h0=False):
    rng = np.random.default_rng(seed)
    out = dict(
        x=rng.normal(size=(bsz, s, di)).astype(np.float32),
        dt=rng.uniform(0.001, 0.1, (bsz, s, di)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, (di, n)).astype(np.float32),
        B=rng.normal(size=(bsz, s, n)).astype(np.float32),
        C=rng.normal(size=(bsz, s, n)).astype(np.float32),
        D=rng.normal(size=(di,)).astype(np.float32))
    out["h0"] = (rng.normal(size=(bsz, di, n)).astype(np.float32)
                 if h0 else None)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# the sweep of tests/test_ssm_kernel.py:11-16 (chunk, di_block of the
# Pallas kernel), with and without an initial state
SWEEP = [(2, 20, 12, 4, 8, 8), (1, 64, 32, 16, 16, 16),
         (2, 33, 24, 8, 16, 8), (1, 7, 8, 4, 16, 32)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("bsz,s,di,n,chunk,dib", SWEEP)
def test_plain_scan_matches_the_reference(bsz, s, di, n, chunk, dib, h0):
    a = _inputs(bsz * 100 + s, bsz, s, di, n, h0)
    names = ("x", "dt", "A", "B", "C", "D", "h0")
    y, h = ops.selective_scan(*(_t(a[k]) for k in names))
    y_ref, h_ref = jssm.selective_scan(*(_j(a[k]) for k in names), chunk=7)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **Y_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **H_TOL)
    if not h0:                     # the TPU kernel starts from a zero state
        y_fused = jscan.selective_scan_fused(
            *(_j(a[k]) for k in names[:-1]), chunk=chunk, di_block=dib,
            interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_fused), **Y_TOL)


def test_pads_are_exact_state_no_ops():
    """dt = 0 at the pads: h_last equals the real tokens' h_last bit for
    bit, whatever the pads' x, B and C hold."""
    a = _inputs(3, 2, 24, 16, 16, h0=True)
    real = 13
    x, dt, A, B, C, D, h0 = (_t(a[k]) for k in
                             ("x", "dt", "A", "B", "C", "D", "h0"))
    dt_pad = dt.clone()
    dt_pad[:, real:] = 0
    _, h_pad = ops.selective_scan(x, dt_pad, A, B, C, D, h0)
    _, h_real = ops.selective_scan(x[:, :real], dt[:, :real], A,
                                   B[:, :real], C[:, :real], D, h0)
    assert torch.equal(h_pad, h_real)


def test_causal_conv_matches_and_streams():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    y, st = ssm.causal_conv1d(_t(x), _t(w), _t(b))
    y_ref, st_ref = jssm.causal_conv1d(_j(x), _j(w), _j(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    state = torch.zeros((2, 3, 6))
    ys = []
    for t in range(10):                  # one token at a time, carrying state
        y_t, state = ssm.causal_conv1d(_t(x[:, t:t + 1]), _t(w), _t(b), state)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(state, st)


def test_decode_step_continues_the_scan():
    """The decode step from the scan's final state matches the reference's
    decode step and the scan over the longer sequence; the scan at S = 1
    (the mixer's decode) is that one step, bit for bit on the CPU."""
    a = _inputs(5, 2, 13, 8, 4)
    names = ("x", "dt", "A", "B", "C", "D")
    x, dt, A, B, C, D = (_t(a[k]) for k in names)
    y_full, h_full = ops.selective_scan(x, dt, A, B, C, D)
    _, h_pre = ops.selective_scan(x[:, :12], dt[:, :12], A, B[:, :12],
                                  C[:, :12], D)
    y_step, h_step = ref.ssm_decode_step(x[:, 12], dt[:, 12], A, B[:, 12],
                                         C[:, 12], D, h_pre)
    jy, jh = jssm.ssm_decode_step(*(_j(a[k][:, 12]) for k in ("x", "dt")),
                                  _j(a["A"]), _j(a["B"][:, 12]),
                                  _j(a["C"][:, 12]), _j(a["D"]),
                                  jnp.asarray(h_pre.numpy()))
    np.testing.assert_allclose(y_step.numpy(), np.asarray(jy), **H_TOL)
    np.testing.assert_allclose(h_step.numpy(), np.asarray(jh), **H_TOL)
    np.testing.assert_allclose(y_step.numpy(), y_full[:, 12].numpy(), **H_TOL)
    np.testing.assert_allclose(h_step.numpy(), h_full.numpy(), **H_TOL)
    # the mixer's decode reaches it through the scan at S = 1, writing the
    # state over h0 as the serve cache does
    h_cache = h_pre.clone()
    y1, h1 = ops.selective_scan(x[:, 12:], dt[:, 12:], A, B[:, 12:],
                                C[:, 12:], D, h_cache, h_out=h_cache)
    assert h1 is h_cache
    assert torch.equal(y1[:, 0], y_step) and torch.equal(h1, h_step)


# C7 (closed): the reference scans prefill and forward in cfg.scan_dtype;
# so does the port.  Its serving scan at scan_dtype="bfloat16" is the
# Pallas kernel's bf16 contract (bf16 x, dt, B, C widened to f32 inside),
# more exact than the reference's bf16 jnp scan, which also rounds dA, dBx
# and h to bf16: the two are held to the reference's own bf16 scan
# tolerance (SCAN_BF16_TOL, tests/test_ssm_kernel.py:46; on these inputs
# the logits differ by 2.0e-3, about what bf16 moves the reference's own,
# 1.9e-3).  The training scan computes in the scan dtype as the
# reference's does, and its logits agree within SCAN_MIRROR_TOL (2.3e-6 on
# these inputs).
SCAN_BF16_TOL = dict(rtol=0.05, atol=0.05)
SCAN_MIRROR_TOL = dict(rtol=0, atol=1e-4)

@pytest.fixture(scope="module")
def falcon_smoke():
    cfg = get_config("falcon-mamba-7b").smoke()
    return cfg, jtfm.init_params(cfg, jax.random.PRNGKey(0))


def test_reference_scan_dtype_moves_the_logits(falcon_smoke):
    cfg, params = falcon_smoke
    toks = jnp.asarray(np.random.default_rng(1).integers(0, 256, (2, 16)),
                       jnp.int32)
    f32 = np.asarray(jtfm.forward(params, toks, cfg))
    bf16 = np.asarray(jtfm.forward(params, toks,
                                   cfg.replace(scan_dtype="bfloat16")))
    assert np.abs(bf16 - f32).max() > 1e-4


@pytest.mark.parametrize("entry", ["init_params", "forward", "engine"])
def test_scan_dtype_bf16_matches_jax(falcon_smoke, entry):
    """init_params (bit-equal to the f32 config's tree: the scan dtype is
    not a parameter dtype), forward (logits, serving and training scans)
    and the serving engine (prefill and decode logits through ``step``,
    and the SSM state) at scan_dtype="bfloat16" against JAX."""
    cfg, params = falcon_smoke
    tcfg = tget("falcon-mamba-7b").smoke()
    bcfg = tcfg.replace(scan_dtype="bfloat16")
    jcfg = cfg.replace(scan_dtype="bfloat16")
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    if entry == "init_params":
        got = tfm.init_params(bcfg, torch.Generator().manual_seed(0),
                              device="cpu")
        want = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert torch.equal(a, b)
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, got)) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda t: 0, jtfm.init_params(jcfg, jax.random.PRNGKey(0))))
    elif entry == "forward":
        toks = np.random.default_rng(1).integers(0, 256, (2, 16))
        expect = np.asarray(jtfm.forward(params, jnp.asarray(toks, jnp.int32),
                                         jcfg))
        got = tfm.forward(tparams, torch.from_numpy(toks), bcfg)
        np.testing.assert_allclose(got.numpy(), expect, **SCAN_BF16_TOL)
        with torch.no_grad():
            mirror = tfm.forward(tparams, torch.from_numpy(toks), bcfg,
                                 train=True)
        np.testing.assert_allclose(mirror.numpy(), expect, **SCAN_MIRROR_TOL)
    else:
        packed = jfreeze(params, bits=8)
        tpacked = interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, packed), tcfg, device="cpu")
        eng = ServingEngine(bcfg, tpacked, batch_slots=2, max_len=32,
                            device="cpu")
        jc = jtfm.init_serve_cache(jcfg, 2, 32)
        toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(
            np.int32)
        for part, pos in ((toks, 0), (toks[:, -1:], 12), (toks[:, :1], 13)):
            jl, jc = jtfm.step(packed, jnp.asarray(part), jc, jnp.int32(pos),
                               jcfg)
            tl, eng.cache = tfm.step(tpacked, torch.from_numpy(part).long(),
                                     eng.cache, pos, bcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **SCAN_BF16_TOL)
        np.testing.assert_allclose(eng.cache["ssm"]["h"].numpy(),
                                   np.asarray(jc["ssm"]["h"]),
                                   **SCAN_BF16_TOL)
        # and the engine serves requests at this config to the end
        eng = ServingEngine(bcfg, tpacked, batch_slots=2, max_len=32,
                            device="cpu")
        for uid in range(3):
            eng.submit(Request(uid=uid, prompt=toks[uid % 2, :5 + uid],
                               max_new_tokens=4))
        done = []
        while eng.pending:
            done += eng.step()
        assert sorted(len(r.generated) for r in done) == [4, 4, 4]


@pytest.fixture(scope="module")
def mamba_layer():
    cfg = get_config("falcon-mamba-7b").smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    layer = jax.tree_util.tree_map(lambda t: np.asarray(t[0]),
                                   params["layers"]["ssm"])
    return cfg, layer


@pytest.mark.parametrize("bits", [None, 8])
def test_mamba_mixer_with_lengths_matches_the_reference(mamba_layer, bits):
    """A right-padded prefill chunk with per-row lengths from a carried
    state, then a decode step: outputs at real positions and the new states
    match the reference's mixer."""
    cfg, layer = mamba_layer
    if bits is not None:
        layer = jax.tree_util.tree_map(
            np.asarray, jfreeze({"ssm": layer}, bits=bits))["ssm"]
    kw = dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
              dt_rank=cfg.dt_rank, conv_k=cfg.ssm_conv)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 8, cfg.d_model)).astype(np.float32)
    lengths = np.array([8, 5, 2], np.int32)
    state = dict(h=rng.normal(size=(3, cfg.d_inner, cfg.ssm_state)).astype(
                     np.float32) * 0.1,
                 conv=rng.normal(size=(3, cfg.ssm_conv - 1,
                                       cfg.d_inner)).astype(np.float32))
    tlayer = interop.params_from_numpy(layer, cfg, device="cpu")
    out, new = ssm.mamba_mixer(_t(x), tlayer, state={k: _t(v) for k, v in
                                                    state.items()},
                               lengths=torch.from_numpy(lengths), **kw)
    jout, jnew = jssm.mamba_mixer(_j(x), jax.tree_util.tree_map(_j, layer),
                                  state={k: _j(v) for k, v in state.items()},
                                  lengths=_j(lengths), chunk=cfg.ssm_chunk,
                                  **kw)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(out[b, :n].numpy(),
                                   np.asarray(jout)[b, :n], **H_TOL)
    np.testing.assert_allclose(new["h"].numpy(), np.asarray(jnew["h"]),
                               **H_TOL)
    np.testing.assert_array_equal(new["conv"].numpy(),
                                  np.asarray(jnew["conv"]))
    # a 1-token chunk with a state is a decode step in both
    x1 = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    out1, new1 = ssm.mamba_mixer(_t(x1), tlayer, state=new, lengths=None,
                                 **kw)
    jout1, jnew1 = jssm.mamba_mixer(_j(x1), jax.tree_util.tree_map(_j, layer),
                                    state=jnew, **kw)
    np.testing.assert_allclose(out1.numpy(), np.asarray(jout1), **H_TOL)
    np.testing.assert_allclose(new1["h"].numpy(), np.asarray(jnew1["h"]),
                               **H_TOL)


def test_mixer_in_place_equals_the_fresh_state(mamba_layer):
    """``in_place`` (the serve cache's path) writes the same state into the
    given tensors that the functional call returns."""
    cfg, layer = mamba_layer
    kw = dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
              dt_rank=cfg.dt_rank, conv_k=cfg.ssm_conv)
    rng = np.random.default_rng(9)
    tlayer = interop.params_from_numpy(layer, cfg, device="cpu")
    state = dict(h=torch.from_numpy(rng.normal(size=(
                     2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)),
                 conv=torch.from_numpy(rng.normal(size=(
                     2, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)))
    for s, lengths in ((6, torch.tensor([6, 3])), (1, None)):
        x = torch.from_numpy(rng.normal(size=(2, s, cfg.d_model)).astype(
            np.float32))
        out, new = ssm.mamba_mixer(x, tlayer, state=state, lengths=lengths,
                                   **kw)
        cache = {k: v.clone() for k, v in state.items()}
        out_ip, new_ip = ssm.mamba_mixer(x, tlayer, state=cache,
                                         lengths=lengths, in_place=True, **kw)
        assert new_ip is cache and torch.equal(out_ip, out)
        assert all(torch.equal(cache[k], new[k]) for k in ("h", "conv"))
        state = new


def test_traffic_model_is_the_reference_s():
    for di, n in ((8192, 16), (3200, 16), (64, 4)):
        assert ssm_scan.hbm_bytes_per_token(di, n) == \
            jscan.hbm_bytes_per_token(di, n)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_blockwise_freeze_is_byte_identical(mamba_layer, monkeypatch, bits):
    """Freezing a block of output rows at a time (a few rows a block here)
    gives the reference's whole-leaf carriers and scales, byte for byte."""
    cfg, _layer = mamba_layer
    params = jtfm.init_params(cfg, jax.random.PRNGKey(2))
    monkeypatch.setattr(sharding, "FREEZE_BLOCK_ELEMS", 3 * 128)
    expect = jax.tree_util.tree_map(np.asarray, jfreeze(params, bits=bits))
    got = interop.params_to_numpy(sharding.freeze_for_serving(
        interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tget(cfg.name).smoke(), device="cpu"),
        bits=bits, device="cpu"))
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(expect)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)
        assert flat[path].dtype == leaf.dtype


def test_scan_wrapper_checks_its_inputs():
    a = _inputs(7, 1, 4, 8, 4)
    x, dt, A, B, C, D = (_t(a[k]) for k in ("x", "dt", "A", "B", "C", "D"))
    with pytest.raises(ValueError, match="one CUDA device"):
        ssm_scan.selective_scan(x.to("meta"), dt, A, B, C, D)
    # a CPU tensor takes the plain version
    y, h = ssm_scan.selective_scan(x, dt, A, B, C, D)
    y_ref, h_ref = ref.selective_scan(x, dt, A, B, C, D)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


# --- the Hopper kernel's arithmetic and route rule, on the CPU ---
#
# csrc/ssm_scan.cu takes one MUFU op a state step: A is scaled by log2(e)
# once, and each step's decay is ex2.approx(dt * A log2(e)).  The emulation
# follows its f32 operations; ex2.approx is modelled as exact exp2 rounded
# to f32, moved by a relative bias of +-2^-22 (about 2 ulp, the size of the
# approximation's error) in the same direction at every step, the worst
# case for a long recurrence.

LOG2E = np.float32(1.4426950408889634)
SCAN_TOL = dict(rtol=5e-4, atol=5e-4)     # chip_smoke.py's, the reference's


def emulate_scan(x, dt, A, B, C, D, h0=None, bias=0.0):
    bsz, s, di = x.shape
    a2 = (A * LOG2E).astype(np.float32)
    h = (np.zeros((bsz, di, A.shape[1]), np.float32) if h0 is None
         else h0.copy())
    y = np.empty_like(x)
    for t in range(s):
        arg = (dt[:, t, :, None] * a2[None]).astype(np.float32)
        decay = (np.exp2(arg.astype(np.float64)) * (1.0 + bias)
                 ).astype(np.float32)
        dx = dt[:, t] * x[:, t]
        h = (decay.astype(np.float64) * h
             + (dx[..., None] * B[:, t, None, :])).astype(np.float32)
        y[:, t] = (h * C[:, t, None, :]).sum(-1, dtype=np.float32) \
            + x[:, t] * D
    return y, h


@pytest.mark.parametrize("bias", [0.0, 2.0 ** -22, -2.0 ** -22])
@pytest.mark.parametrize("bsz,s,di,n,h0", [(2, 20, 12, 4, False),
                                           (1, 64, 32, 16, True),
                                           (2, 33, 24, 8, True),
                                           (1, 1163, 16, 16, True),
                                           (2, 37, 10, 32, False)])
def test_exp2_emulation_holds_the_tolerance(bsz, s, di, n, h0, bias):
    """exp2(dt * A log2 e) in f32, even with a 2 ulp bias at every step of
    hymba's longest prompt, stays within SCAN_TOL of the reference's
    scan."""
    a = _inputs(bsz * 7 + s, bsz, s, di, n, h0)
    names = ("x", "dt", "A", "B", "C", "D", "h0")
    y, h = emulate_scan(*(a[k] for k in names), bias=bias)
    y_ref, h_ref = jssm.selective_scan(*(_j(a[k]) for k in names), chunk=7)
    np.testing.assert_allclose(y, np.asarray(y_ref), **SCAN_TOL)
    np.testing.assert_allclose(h, np.asarray(h_ref), **SCAN_TOL)


def test_exp2_of_a_pad_is_exactly_one():
    """dt = 0: the decay's argument is -0 and ex2(-0) = 1, the update is 0,
    so a pad leaves every state's bits as they were."""
    a = _inputs(11, 2, 24, 16, 16, h0=True)
    arg = np.float32(0) * (a["A"] * LOG2E).astype(np.float32)
    assert (np.exp2(arg) == 1).all()
    dt = a["dt"].copy()
    dt[:, 13:] = 0
    names = ("x", "A", "B", "C", "D", "h0")
    _, h_pad = emulate_scan(a["x"], dt, *(a[k] for k in names[1:]))
    _, h_real = emulate_scan(a["x"][:, :13], dt[:, :13], a["A"],
                             a["B"][:, :13], a["C"][:, :13], a["D"],
                             a["h0"])
    np.testing.assert_array_equal(h_pad, h_real)


def test_route_rule_by_s():
    """S up to STEP_MAX_S (decode) takes the step route, longer S the
    chunked ring; every default plan fits the kernel's block and state
    limits, and lanes it cannot take are refused."""
    edge = ssm_scan.STEP_MAX_S
    for s in range(1, edge + 1):
        assert ssm_scan.scan_plan(s, 16).route == "step"
    for s in (edge + 1, 64, 1163):
        assert ssm_scan.scan_plan(s, 16).route == "chunked"
    for n in ssm_scan.N_STATES:
        for s in (1, 64):
            p = ssm_scan.scan_plan(s, n)
            assert 1 <= n // p.lanes <= ssm_scan.MAX_STATES
            threads = p.block if p.route == "step" else p.block * p.lanes
            assert threads <= ssm_scan.MAX_THREADS and threads % 32 == 0
            assert p.route == "step" or (p.block % 4 == 0 and p.chunk > 0)
    for n, lanes in ((16, 3), (32, 1), (4, 8)):
        with pytest.raises(ValueError, match="lanes"):
            ssm_scan.scan_plan(64, n, lanes=lanes)


def test_cpu_calls_launch_nothing(rng):
    """On the CPU the wrapper computes the plain version: its launch count
    and its split by route stay as they were."""
    fn = ssm_scan.selective_scan
    before = fn.launches, dict(fn.launches_by_route)
    x, dt = (torch.from_numpy(rng.random((1, 3, 8), np.float32))
             for _ in range(2))
    A = -torch.from_numpy(rng.random((8, 4), np.float32))
    B, C = (torch.from_numpy(rng.normal(size=(1, 3, 4)).astype(np.float32))
            for _ in range(2))
    fn(x, dt, A, B, C, torch.ones(8))
    assert (fn.launches, fn.launches_by_route) == before
