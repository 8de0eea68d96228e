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


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (37, 80, True, 16), (50, 50, False, None),
])
def test_head_dim_256_matches_reference_kernel(rng, sq, sk, causal, window):
    """gemma-7b's head dim: the folded form against the reference Pallas
    kernel in interpret mode and its oracle, causal, windowed and not."""
    q = rng.normal(size=(2, sq, 256)).astype(np.float32)
    k = rng.normal(size=(2, sk, 256)).astype(np.float32)
    v = rng.normal(size=(2, sk, 256)).astype(np.float32)
    pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, bq=16, bk=16,
                    interpret=True)
    oracle = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    assert got.shape == (2, sq, 256)
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


# --- the Hopper kernel's arithmetic and launch plan, emulated on the CPU ---
#
# csrc/flash_attention.cu runs QK^T and PV as mma.sync.m16n8k8 TF32 with each
# f32 operand split into a TF32 hi part and a lo part.  The emulation below
# follows it step by step: the plan's row tiles (query-major over the GQA
# group) and kv slices, each slice's tiles in order, each 8-wide k step's
# passes (lo.hi, hi.lo, hi.hi) summed exactly and rounded toward zero into
# the f32 accumulator (a model no kinder than the tensor core's), the
# softmax's ex2 of log2(e)-scaled scores, each tile's PV folded into the
# output by one FMA, the slices added in slice order, and rows that see no
# key given the mean of v.  ex2 is modelled as exact and rounded to f32; the
# card's ex2.approx is within 2 ulp of that, far below the tolerance.

from repro_torch.kernels import flash_attention as fa  # noqa: E402

LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)
SMS = 132                  # an H100 SXM's SMs, for the default plans


def _tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, ties away from zero."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _rz(x64):
    """An exact sum rounded to f32 toward zero."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _bf16(x):
    """f32 -> bf16 (as f32), round to nearest even (``__float2bfloat16_rn``,
    PyTorch's cast)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def _mma(acc, a, b, passes, step=8):
    """acc (R, C) f32 += a (R, K) @ b (K, C) as ``step``-wide k steps of
    MMAs: three TF32 passes (lo.hi, hi.lo, hi.hi), or hi.hi alone (1; bf16
    operands are exact in TF32, and their m16n8k16 MMA is one pass of
    16-wide steps)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if passes == 3 else [(ah, bh)]
    for k0 in range(0, a.shape[1], step):
        for x, y in terms:
            acc = _rz(acc.astype(np.float64)
                      + x[:, k0:k0 + step].astype(np.float64)
                      @ y[k0:k0 + step].astype(np.float64))
    return acc


def _ex2(x):
    return np.exp2(x.astype(np.float64)).astype(np.float32)


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_flash(q, k, v, offsets, causal, window, plan, *, passes=3,
                  row_tiles=None, order=None, bf16=False, p_round=True):
    """The kernel's output for q (B, Hq, Sq, D), k, v (B, Hkv, Sk, D) and
    per-row ``offsets``, at ``plan``; rows of the row tiles not emulated
    stay NaN.  ``order`` permutes the order in which the slices finish.
    ``bf16``: the bf16 route (``flash_fwd_bf16``) on bf16-valued q, k, v:
    one 16-deep MMA pass, o rescaled by alpha before PV accumulates into
    it, P rounded to bf16 (``p_round``) or else a bf16 hi and lo part (lo
    first, a 16-key step at a time), the output rounded to bf16."""
    step = 16 if bf16 else 8
    passes = 1 if bf16 else passes
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g, bk, rows = hq // hkv, plan.block_keys, plan.rows
    sl2 = np.float32(np.float32(1.0 / d ** 0.5) * LOG2E)
    out = np.full(q.shape, np.nan, np.float32)
    for bb in range(b):
        for hk in range(hkv):
            kpad = np.zeros((plan.kv_tiles * bk, d), np.float32)
            vpad = np.zeros_like(kpad)
            kpad[:sk], vpad[:sk] = k[bb, hk], v[bb, hk]
            for rt in (row_tiles if row_tiles is not None
                       else range(plan.row_tiles)):
                r = rt * rows + np.arange(rows)
                real = r < sq * g
                qi, h = r // g, hk * g + r % g
                qr = np.zeros((rows, d), np.float32)
                qr[real] = q[bb, h[real], qi[real]]
                qpos = offsets[bb] + qi
                lo, hi = fa.visible_tiles(plan, g, sq, sk, causal, window,
                                          offsets[bb], rt)
                live = list(fa.live_slices(plan, lo, hi))
                parts = {}
                for s in (order(live) if order else live):
                    m = np.full(rows, NEG)
                    l_ = np.zeros(rows, np.float32)
                    o = np.zeros((rows, d), np.float32)
                    for t in fa.slice_tiles(plan, lo, hi, s):
                        keys = t * bk + np.arange(bk)
                        kt, vt = kpad[keys], vpad[keys]
                        x = _mma(np.zeros((rows, bk), np.float32), qr, kt.T,
                                 passes, step) * sl2
                        vis = np.broadcast_to(keys < sk, x.shape).copy()
                        if causal:
                            vis &= keys[None] <= qpos[:, None]
                        if window:
                            vis &= keys[None] > qpos[:, None] - window
                        x = np.where(vis, x, NEG)
                        mn = np.maximum(m, x.max(1))
                        base = np.where(mn == NEG, np.float32(0), mn)
                        alpha = _ex2(m - base)
                        p = _ex2(x - base[:, None])
                        l_ = _fma(l_, alpha, p.sum(1, dtype=np.float32))
                        if bf16 and p_round:
                            o = _mma(o * alpha[:, None], _bf16(p), vt, 1, 16)
                        elif bf16:
                            p_hi = _bf16(p)
                            p_lo = _bf16(p - p_hi)
                            o = o * alpha[:, None]
                            for k0 in range(0, bk, 16):
                                for part in (p_lo, p_hi):
                                    o = _mma(o, part[:, k0:k0 + 16],
                                             vt[k0:k0 + 16], 1, 16)
                        else:
                            pv = _mma(np.zeros((rows, d), np.float32), p, vt,
                                      passes)
                            o = _fma(o, alpha[:, None], pv)
                        m = mn
                    parts[s] = (m, l_, o)
                if len(live) == 1:
                    m, l_, o = parts[live[0]]
                else:
                    m = np.max([parts[s][0] for s in live], axis=0)
                    base = np.where(m == NEG, np.float32(0), m)
                    l_ = np.zeros(rows, np.float32)
                    o = np.zeros((rows, d), np.float32)
                    for s in live:
                        w = _ex2(parts[s][0] - base)
                        l_ = _fma(w, parts[s][1], l_)
                        o = _fma(w[:, None], parts[s][2], o)
                res = o * (np.float32(1) / np.maximum(l_, np.float32(1e-30))
                           )[:, None]
                res[m == NEG] = v[bb, hk].sum(0, dtype=np.float32) / sk
                out[bb, h[real], qi[real]] = res[real]
    return _bf16(out) if bf16 else out


def _case(rng, b, hq, hkv, sq, sk, d):
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    return q, k, v


def _plain(q, k, v, offsets, causal, window):
    return ref.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
        q_offset=torch.tensor(offsets, dtype=torch.int32)).numpy()


# chip_smoke.py's FLASH_CASES, cut to a few heads (and hymba's long prompt
# to one batch row and five of its 91 row tiles): b, hq, hkv, sq, sk, d,
# window, offsets, causal, row tiles emulated (None: all)
EMULATED = [
    (4, 4, 2, 64, 512, 128, None, (0, 64, 192, 448), True, None),
    (4, 2, 1, 16, 256, 128, None, (3, 40, 77, 240), True, None),
    (4, 2, 1, 64, 512, 128, 96, (0, 100, 300, 448), True, None),
    (1, 5, 1, 1163, 2048, 64, 1024, (0,), True, (0, 1, 45, 89, 90)),
    (2, 4, 2, 100, 24, 64, None, (-76, -76), True, None),
    (2, 2, 2, 32, 64, 32, 16, (0, 70), True, None),
    (1, 2, 2, 64, 280, 16, 40, (256,), False, None),
    # gemma-7b's prefill chunk (head dim 256, no GQA), two of its 16 heads
    (4, 2, 2, 64, 512, 256, None, (0, 64, 192, 448), True, None),
]


@pytest.mark.parametrize("split", ["plan", "unsplit"])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "x".join(
    map(str, c[:6])) + f"-w{c[6]}-{'c' if c[8] else 'nc'}")
def test_split_tf32_emulation_holds_the_tolerance(case, split):
    """Three TF32 passes a multiply-add, the kernel's tile order, split and
    combine: within FLASH_TOL (3e-5) of the plain version at every case;
    the largest error is printed."""
    b, hq, hkv, sq, sk, d, window, offsets, causal, tiles = case
    q, k, v = _case(np.random.default_rng(sq + sk), b, hq, hkv, sq, sk, d)
    plan = fa.flash_plan(b, hq, hkv, sq, sk, d, SMS)
    if split == "unsplit":
        plan = fa.flash_plan(b, hq, hkv, sq, sk, d, SMS,
                             split_tiles=plan.kv_tiles)
        assert plan.splits == 1
    got = emulate_flash(q, k, v, offsets, causal, window, plan,
                        row_tiles=tiles)
    expect = _plain(q, k, v, offsets, causal, window)
    done = ~np.isnan(got)
    assert done.any()
    # the error each case shows (pytest -s prints it)
    print(f"{split} ({plan.splits} slices): max abs err "
          f"{np.abs(got[done] - expect[done]).max():.3e}")
    np.testing.assert_allclose(got[done], expect[done], **TOL)


def flash_bf16_bound(expect, p_rounded):
    """chip_smoke.py's bound on |B2 bf16 - plain|, elementwise: both round
    the output to bf16 and may land one ulp apart (2^-7 of |o|, 1e-5 near
    0); with P rounded to bf16 the kernel rounds each weight at its running
    max, the plain version at the row's final max, which moves o by about
    2^-9 of the row's typical |o|: 2^-7 of the row's largest |o| on top."""
    bound = np.abs(expect) * 2 ** -7 + 1e-5
    if p_rounded:
        bound = bound + 2 ** -7 * np.abs(expect).max(-1, keepdims=True)
    return bound


@pytest.mark.parametrize("p_round", [True, False], ids=["P-bf16", "P-split"])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "x".join(
    map(str, c[:6])) + f"-w{c[6]}-{'c' if c[8] else 'nc'}")
def test_bf16_route_emulation_holds_the_tolerance(case, p_round):
    """The bf16 route's arithmetic (``flash_fwd_bf16``: bf16 MMAs of 16
    head dims or keys, P rounded to bf16 in registers or kept as a bf16 hi
    and lo part, the output in bf16) at the kernel's plan, within
    ``flash_bf16_bound`` of the plain version on the same bf16 inputs at
    the same P dtype; the largest share of the bound is printed (0.53 with
    P rounded; with P split the two differ by one output ulp at most, up
    to 0.98 of the bound)."""
    b, hq, hkv, sq, sk, d, window, offsets, causal, tiles = case
    q, k, v = (_bf16(a) for a in _case(np.random.default_rng(sq + sk), b,
                                        hq, hkv, sq, sk, d))
    plan = fa.flash_plan(b, hq, hkv, sq, sk, d, SMS)
    got = emulate_flash(q, k, v, offsets, causal, window, plan,
                        row_tiles=tiles, bf16=True, p_round=p_round)
    expect = ref.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal, window=window,
        q_offset=torch.tensor(offsets, dtype=torch.int32),
        p_dtype=torch.bfloat16 if p_round else torch.float32
    ).float().numpy()
    rows = ~np.isnan(got).any(-1)
    assert rows.any()
    share = (np.abs(got[rows] - expect[rows])
             / flash_bf16_bound(expect[rows], p_round)).max()
    print(f"bf16 ({plan.splits} slices): max err / bound {share:.3f}")
    assert share <= 1


def test_one_tf32_pass_misses_the_tolerance():
    """Why three passes: hi.hi alone (plain TF32) is ~1e-3 off."""
    b, hq, hkv, sq, sk, d, window, offsets, causal, _ = EMULATED[0]
    q, k, v = _case(np.random.default_rng(sq + sk), b, hq, hkv, sq, sk, d)
    plan = fa.flash_plan(b, hq, hkv, sq, sk, d, SMS)
    expect = _plain(q, k, v, offsets, causal, window)
    one = emulate_flash(q, k, v, offsets, causal, window, plan, passes=1)
    assert np.abs(one - expect).max() > 10 * TOL["atol"]


def test_slices_are_added_in_slice_order():
    """The last block to arrive adds the slices in slice order: the bits do
    not depend on the order in which the slices finish."""
    b, hq, hkv, sq, sk, d, window, offsets, causal, _ = EMULATED[0]
    q, k, v = _case(np.random.default_rng(5), b, hq, hkv, sq, sk, d)
    plan = fa.flash_plan(b, hq, hkv, sq, sk, d, SMS, split_tiles=2)
    assert plan.splits > 1
    first = emulate_flash(q, k, v, offsets, causal, window, plan)
    again = emulate_flash(q, k, v, offsets, causal, window, plan,
                          order=lambda s: s[::-1])
    np.testing.assert_array_equal(first, again)


@pytest.mark.parametrize("trial", range(40))
def test_plan_walks_each_visible_tile_once(trial):
    """Every (row tile, kv tile) that holds a visible (query, key) pair is
    walked by exactly one slice, no other tile is walked (no wholly masked
    tile, nothing outside the window), and a row tile with no visible pair
    has slice 0 alone, walking nothing."""
    rng = np.random.default_rng(trial)
    d = int(rng.choice(fa.HEAD_DIMS))
    g, hkv = int(rng.choice([1, 2, 5])), int(rng.integers(1, 3))
    sq, sk = int(rng.integers(1, 150)), int(rng.integers(1, 300))
    causal = bool(rng.integers(2))
    window = None if rng.integers(2) else int(rng.integers(1, 120))
    offset = int(rng.integers(-sq, sk + 60))
    plan = fa.flash_plan(1, g * hkv, hkv, sq, sk, d, SMS)
    if rng.integers(2):
        plan = fa.flash_plan(1, g * hkv, hkv, sq, sk, d, SMS,
                             split_tiles=int(rng.integers(1, plan.kv_tiles
                                                          + 1)))
    bk, keys = plan.block_keys, np.arange(sk)
    for rt in range(plan.row_tiles):
        r = rt * plan.rows + np.arange(plan.rows)
        qpos = offset + r[r < sq * g] // g
        vis = np.ones((qpos.size, sk), bool)
        if causal:
            vis &= keys[None] <= qpos[:, None]
        if window:
            vis &= keys[None] > qpos[:, None] - window
        needed = sorted(set((keys[vis.any(0)] // bk).tolist()))
        lo, hi = fa.visible_tiles(plan, g, sq, sk, causal, window, offset,
                                  rt)
        live = list(fa.live_slices(plan, lo, hi))
        walked = [t for s in live for t in fa.slice_tiles(plan, lo, hi, s)]
        assert walked == needed
        assert live == sorted(live) and 0 <= live[0] and live[-1] < plan.splits
        assert all(fa.slice_tiles(plan, lo, hi, s) for s in live) or not needed
        if not needed:
            assert live == [0]


def test_default_plans():
    """A long kv span (more than SHORT_TILES tiles): slices of at least
    SLICE_WORK keys x head dim a row, 64 keys at qwen3-0.6b's D = 128 (its
    512-key chunk in 8 slices); longer where the row tiles alone fill the
    card (hymba-1.5b's long prompt, D = 64: 1,820 row tiles, its 2,048-key
    span in 2 slices; its 267-token prompt in 128-key slices).  A short
    one: about one block an SM (qwen3-0.6b's serving chunks, 32 or 64 row
    tiles: 4 or 2 slices; hymba-1.5b's 153-token prompt, 240 row tiles:
    unsplit).  Every plan covers its kv tiles."""
    qwen = fa.flash_plan(4, 16, 8, 64, 512, 128, SMS)
    assert qwen.rows * qwen.row_tiles == 64 * 2
    assert qwen.split_tiles * qwen.block_keys == 64 and qwen.splits == 8
    hymba = fa.flash_plan(4, 25, 5, 1163, 2048, 64, SMS)
    assert 4 * 5 * hymba.row_tiles == 1820 and hymba.splits == 2
    mid = fa.flash_plan(4, 25, 5, 267, 512, 64, SMS)
    assert mid.split_tiles * mid.block_keys == 128
    short = {(sq, sk): fa.flash_plan(4, 16, 8, sq, sk, 128, SMS)
             for sq, sk in ((32, 32), (64, 64), (32, 128), (64, 128),
                            (16, 256), (64, 256))}
    assert {key: p.splits for key, p in short.items()} == {
        (32, 32): 1, (64, 64): 2, (32, 128): 4, (64, 128): 2, (16, 256): 4,
        (64, 256): 2}
    prompt = fa.flash_plan(4, 25, 5, 153, 256, 64, SMS)
    assert prompt.kv_tiles == fa.SHORT_TILES and prompt.splits == 1
    # gemma-7b's chunk at D = 256: 32-key tiles, one row tile a (row, head),
    # its 512-key span in 4 slices of 128 keys (WIDE_SLICE_WORK / 256)
    gemma = fa.flash_plan(4, 16, 16, 64, 512, 256, SMS)
    assert (gemma.block_keys, gemma.row_tiles, gemma.kv_tiles) == (32, 1, 16)
    assert gemma.split_tiles * gemma.block_keys == 128 and gemma.splits == 4
    for p in (qwen, hymba, mid, prompt, gemma, *short.values()):
        assert p.splits * p.split_tiles >= p.kv_tiles
        assert (p.splits - 1) * p.split_tiles < p.kv_tiles
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_plan(1, 1, 1, 8, 8, 48, SMS)


def test_cpu_calls_launch_nothing(rng):
    """On the CPU the wrapper computes the plain version: its launch count
    and its split by shape stay as they were."""
    before = fa.flash_attention.launches, dict(
        fa.flash_attention.launches_by_shape)
    q, k, v = _case(rng, 1, 2, 1, 8, 16, 32)
    fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v))
    assert (fa.flash_attention.launches,
            fa.flash_attention.launches_by_shape) == before


# --- C1: rows that see no key ---

@pytest.mark.parametrize("sq,sk", [(40, 24), (300, 256), (600, 512)])
def test_rows_that_see_no_key_take_the_mean_of_v(rng, sq, sk):
    """Causal with Sq > Sk (queries at the end of the kv sequence), the
    first Sq - Sk rows see no key.  The plain version (which the kernel
    follows) gives them the mean of v, and so does the Pallas kernel where
    its 256-key blocks cover Sk exactly (Sk <= 256 or a multiple of 256)."""
    q = rng.normal(size=(2, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 16)).astype(np.float32)
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True).numpy()
    empty = sq - sk
    np.testing.assert_allclose(
        got[:, :empty], np.broadcast_to(v.mean(1, keepdims=True),
                                        (2, empty, 16)), **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_pallas_counts_its_pads_beyond_256(rng):
    """Sk = 300: the Pallas kernel pads k and v to 512 keys and its rows that
    see no key average over all 512, pads included; the port does not copy
    that quirk (ROADMAP C1)."""
    q = rng.normal(size=(1, 310, 16)).astype(np.float32)
    k = rng.normal(size=(1, 300, 16)).astype(np.float32)
    v = rng.normal(size=(1, 300, 16)).astype(np.float32)
    pallas = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(pallas[0, :10], np.broadcast_to(
        v[0].sum(0) / 512, (10, 16)), **TOL)
    np.testing.assert_allclose(got[0, :10], np.broadcast_to(
        v[0].mean(0), (10, 16)), **TOL)
    np.testing.assert_allclose(got[0, 10:], pallas[0, 10:], **TOL)
