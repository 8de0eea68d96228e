"""Port parity: the MoE family (``models/moe.py``, its transformer branches,
the grouped packed linear and the engine's MoE prefill).

Every case starts from seeded numpy inputs; model weights are drawn by the
JAX package and carried across with ``interop``.  Floats are held at f32
tolerance, integers (routing indices, dispatch slots, packed carriers)
exactly.  The smoke config: qwen2-moe-a2.7b cut to 2 layers, 8 experts,
top-2, d_model 64, with its shared expert."""

import pytest

torch = pytest.importorskip("torch")
# smoke shapes: one intra-op thread is quicker than many, and leaves
# the other cores to the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.kernels import qmatmul as jqmm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import packing, paging, placement, quantize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qmatmul import (  # noqa: E402
    qmatmul_f32_blockscale_grouped, qmatmul_f32_grouped)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402
from repro_torch.serving import Request, Scheduler, ServingEngine  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_INT = ("e_sorted", "slot", "tok_sorted", "keep")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX f32 tree, JAX packed tree, port cfg, port f32 tree,
    port packed tree)."""
    jcfg, tcfg = jget(ARCH).smoke(), tget(ARCH).smoke()
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    packed = jfreeze(params, bits=8)
    return (jcfg, params, packed, tcfg,
            interop.params_from_numpy(_np(params), tcfg, device="cpu"),
            interop.params_from_numpy(_np(packed), tcfg, device="cpu"))


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["moe"])


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(t, d, seed=0):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def test_capacity_equals_the_reference():
    for args in [(4, 60, 4, 1.25), (16, 60, 4, 1.25), (256, 60, 4, 1.25),
                 (1, 8, 2, 1.25), (100, 8, 2, 2.0), (7, 3, 2, 0.5)]:
        assert moe.capacity(*args) == jmoe.capacity(*args)
    assert moe.capacity(4, 60, 4, 1.25) == 8
    assert moe.capacity(256, 60, 4, 1.25) == 24


@pytest.mark.parametrize("t", [1, 5, 40])
def test_route_equals_the_reference(model, t):
    jcfg, params, *_ = model
    router = np.asarray(_layer0(params)["router"])
    x = _x(t, jcfg.d_model, seed=t)
    jg, ji = jmoe.route(jnp.asarray(x), jnp.asarray(router), 2)
    tg, ti = moe.route(_t(x), _t(router), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_route_breaks_ties_to_the_lower_expert_as_top_k():
    # rows of equal logits: jax.lax.top_k takes the lower index first
    x = np.ones((6, 4), np.float32)
    router = np.zeros((8, 4), np.float32)
    router[[1, 2, 5, 6]] = 1.0                 # four experts tie at the top
    router[3] = 2.0
    x[3:] = -1.0                               # ... and at the bottom
    for k in (1, 2, 3):
        jg, ji = jmoe.route(jnp.asarray(x), jnp.asarray(router), k)
        tg, ti = moe.route(_t(x), _t(router), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("t,cap", [(6, 8), (40, 8), (40, 24)])
def test_dispatch_and_combine_equal_the_reference(model, t, cap):
    """With capacity drops (40 tokens x top-2 over 8 experts at cap 8)."""
    jcfg, params, *_ = model
    router = np.asarray(_layer0(params)["router"])
    x = _x(t, jcfg.d_model, seed=100 + t)
    jg, ji = jmoe.route(jnp.asarray(x), jnp.asarray(router), 2)
    jbuf, jaux = jmoe.dispatch(jnp.asarray(x), jg, ji, 8, cap)
    tbuf, taux = moe.dispatch(_t(x), _t(jg), _t(ji).long(), 8, cap)
    for name in AUX_INT:
        np.testing.assert_array_equal(taux[name].numpy(),
                                      np.asarray(jaux[name]), name)
    np.testing.assert_array_equal(taux["g_sorted"].numpy(),
                                  np.asarray(jaux["g_sorted"]))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert tbuf.is_contiguous()
    if t == 40 and cap == 8:
        assert not taux["keep"].all()          # the case drops assignments
    eo = np.random.default_rng(t).normal(
        size=(8, cap, jcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        moe.combine(_t(eo), taux, t).numpy(),
        np.asarray(jmoe.combine(jnp.asarray(eo), jaux, t)), **TOL)
    tb, tcomb = moe.dispatch_combine(_t(x), _t(jg), _t(ji).long(), 8, cap)
    np.testing.assert_array_equal(tb.numpy(), tbuf.numpy())
    np.testing.assert_array_equal(tcomb(_t(eo)).numpy(),
                                  moe.combine(_t(eo), taux, t).numpy())


@pytest.mark.parametrize("tree", ["f32", "packed"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_equals_the_reference(model, tree, shared, groups):
    jcfg, params, packed, tcfg, tparams, tpacked = model
    jp = _layer0(params if tree == "f32" else packed)
    tp = {k: v for k, v in interop.params_from_numpy(
        _np(jp), tcfg, device="cpu").items() if shared or k != "shared"}
    if not shared:
        jp = {k: v for k, v in jp.items() if k != "shared"}
    x = np.random.default_rng(groups).normal(
        size=(2, 10, jcfg.d_model)).astype(np.float32)
    kw = dict(n_experts=8, k=2, capacity_factor=1.25, act="swiglu",
              groups=groups)
    expect = jmoe.moe_apply(jnp.asarray(x), jp, **kw)
    got = moe.moe_apply(_t(x), tp, **kw)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_moe_apply_dense_residual_as_arctic(model):
    """arctic's parallel dense MLP under p["dense"] (arctic-480b's smoke
    config keeps it)."""
    jcfg = jget("arctic-480b").smoke()
    tcfg = tget("arctic-480b").smoke()
    assert jcfg.dense_residual_d_ff
    params = jtfm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = interop.params_from_numpy(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9))
    np.testing.assert_allclose(
        tfm.forward(tparams, _t(toks), tcfg).numpy(),
        np.asarray(jtfm.forward(params, jnp.asarray(toks), jcfg)), **TOL)


def test_grouped_moe_refuses_data_parallel_axes(model):
    """Under ``dp_axes`` the grouped dispatch runs the reference's expert
    einsums (the sharded train step's path) and gives the reference's
    values; packed experts, which the reference's branch cannot take,
    are refused there."""
    from repro.launch.mesh import make_test_mesh as jmesh

    *_, tcfg, tparams, _tp = model
    tp = interop.params_from_numpy(_np(_layer0(model[1])), tcfg,
                                   device="cpu")
    x = _x(8, tcfg.d_model, seed=4)
    kw = dict(n_experts=8, k=2, groups=2, engine=dict(dp_axes=("data",)))
    with jmesh((1, 1), ("data", "model")):
        want = jmoe.moe_apply(jnp.asarray(x), _layer0(model[1]), **kw)
    np.testing.assert_allclose(moe.moe_apply(_t(x), tp, **kw).numpy(),
                               np.asarray(want), **TOL)
    packed = interop.params_from_numpy(_np(_layer0(model[2])), tcfg,
                                       device="cpu")
    with pytest.raises(ValueError, match="dense experts"):
        moe.moe_apply(_t(x), packed, **kw)


def test_router_aux_loss_equals_the_reference(model):
    jcfg, params, *_ = model
    router = np.asarray(_layer0(params)["router"])
    x = _x(12, jcfg.d_model, seed=9)
    _g, idx = jmoe.route(jnp.asarray(x), jnp.asarray(router), 2)
    expect = jmoe.router_aux_loss(jnp.asarray(x), jnp.asarray(router), idx, 8)
    got = moe.router_aux_loss(_t(x), _t(router), _t(idx).long(), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


# --- the grouped packed linear ---------------------------------------------

def _vmapped_pallas(x, packed, scale, bits, k):
    return jax.vmap(lambda xx, pp, ss: jqmm.qmatmul_f32(
        xx, pp, ss, bits=bits, k_orig=k, interpret=True))(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("c,k", [(8, 64), (24, 64), (8, 83)])
def test_grouped_qmatmul_plain_equals_vmapped_pallas(bits, c, k):
    rng = np.random.default_rng(bits * 100 + c + k)
    e, n = 5, 48
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(e * n, k)).astype(np.float32))
    packed, scale = ops.prep_linear(w, bits)
    packed, scale = packed.reshape(e, n, -1), scale.reshape(e, n)
    expect = _vmapped_pallas(x, packed.numpy(), scale.numpy(), bits, k)
    got = qmatmul_f32_grouped(_t(x), packed, scale, bits=bits, k_orig=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        got.numpy(), ref.qmatmul_f32_grouped(_t(x), packed, scale, bits=bits,
                                             k_orig=k).numpy())
    assert qmatmul_f32_grouped.launches == 0     # the CPU launches nothing
    # quant_matmul routes a stack of experts to the grouped version
    np.testing.assert_array_equal(
        ops.quant_matmul(_t(x), packed, scale, bits=bits, k_orig=k).numpy(),
        got.numpy())


def test_quant_matmul_rejects_shapes_that_disagree():
    packed = torch.zeros((3, 16, 8), dtype=torch.uint8)
    scale = torch.ones((3, 16))
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        ops.quant_matmul(torch.zeros((4, 8)), packed, scale, bits=8, k_orig=8)
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        ops.quant_matmul(torch.zeros((2, 4, 8)), packed, scale, bits=8,
                         k_orig=8)
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        ops.quant_matmul(torch.zeros((3, 4, 8)), packed, scale[:, :8],
                         bits=8, k_orig=8)
    with pytest.raises(ValueError, match="packed"):
        ops.quant_matmul(torch.zeros((4, 8)), packed[None], scale, bits=8,
                         k_orig=8)
    with pytest.raises(ValueError, match=r"\(E, C, K\)"):
        ops.quant_matmul_blockscale(torch.zeros((2, 4, 8)), packed,
                                    torch.ones((3, 16, 1)), bits=8, k_orig=8)
    with pytest.raises(ValueError, match=r"\(E, N, nblk\)"):
        ops.quant_matmul_blockscale(torch.zeros((3, 4, 8)), packed,
                                    torch.ones((3, 16)), bits=8, k_orig=8)
    with pytest.raises(ValueError, match="scales"):
        ops.quant_matmul_blockscale(torch.zeros((4, 8)), packed[0],
                                    torch.ones((3, 16, 1)), bits=8, k_orig=8)


@pytest.mark.parametrize("scenario", ["l1mram", "l2mram", "l3flash"])
def test_grouped_linear_dispatch_equals_the_reference(model, scenario):
    """``layers.linear`` on (E, C, K) x packed experts, under each weight
    path, equals the reference's vmapped ``linear``."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    jcfg, _p, packed, tcfg, _tp, tpacked = model
    jw = _layer0(packed)["w_gate"]
    tw = {k: v[0] for k, v in tpacked["layers"]["moe"]["w_gate"].items()}
    x = np.random.default_rng(4).normal(
        size=(8, 8, jcfg.d_model)).astype(np.float32)
    eng = dict(scenario=scenario, mode="xla", bits=8)
    expect = jax.vmap(lambda xx, pp, ss: jlayers.linear(
        xx, dict(packed=pp, scale=ss), engine=eng,
        path="layers/moe/w_gate"))(jnp.asarray(x), jw["packed"], jw["scale"])
    got = layers.linear(_t(x), tw, engine=eng, path="layers/moe/w_gate")
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_frozen_experts_byte_equal_the_reference(model, bits):
    _jcfg, params, _pk, tcfg, tparams, _tpk = model
    expect = _np(jfreeze(params, bits=bits))["layers"]["moe"]
    got = freeze_for_serving(tparams, bits=bits,
                             device="cpu")["layers"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        for leaf in ("packed", "scale"):
            g = got[name][leaf].numpy()
            assert g.shape == expect[name][leaf].shape, (name, leaf)
            assert g.tobytes() == expect[name][leaf].tobytes(), (name, leaf)
    assert got["router"].dtype == torch.float32       # routers stay f32
    for leaf in ("packed", "scale"):
        assert (got["shared"]["w_up"][leaf].numpy().tobytes()
                == expect["shared"]["w_up"][leaf].tobytes())


def test_init_params_tree_matches_the_reference(model):
    jcfg, params, _pk, tcfg, *_ = model
    got = tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(params))

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return tuple(t.shape)
    assert walk(got) == shapes
    # the experts keep the reference's init scale (std d^-0.5 / f^-0.5)
    w = got["layers"]["moe"]["w_gate"]
    assert abs(float(w.std()) - jcfg.d_model ** -0.5) < 0.01


@pytest.mark.parametrize("tree", ["f32", "packed"])
def test_forward_equals_the_reference(model, tree):
    jcfg, params, packed, tcfg, tparams, tpacked = model
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 12))
    jp, tp = (params, tparams) if tree == "f32" else (packed, tpacked)
    np.testing.assert_allclose(
        tfm.forward(tp, _t(toks), tcfg).numpy(),
        np.asarray(jtfm.forward(jp, jnp.asarray(toks), jcfg)), **TOL)


# --- serving ----------------------------------------------------------------

def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lens]


def _serve(side, model, prompts, max_new=6, slots=4, sched=False, kv=None):
    jcfg, _p, packed, tcfg, _tp, tpacked = model
    port = side == "port"
    eng = (ServingEngine(tcfg, tpacked, batch_slots=slots, max_len=64,
                         device="cpu") if port else
           JEngine(jcfg, packed, batch_slots=slots, max_len=64))
    if kv is not None:
        eng.attach_kv_paging(kv)
    make = Request if port else JRequest
    reqs = [make(uid=uid, prompt=p, max_new_tokens=max_new)
            for uid, p in enumerate(prompts)]
    if sched:
        s = (Scheduler if port else JScheduler)(eng, prefill_chunk=8)
        for r in reqs:
            s.submit(r)
        done = s.run_until_done()
    else:
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_done()
    if kv is not None:
        eng.kv_table.close()
    return {r.uid: r.generated for r in done}


def test_engine_greedy_tokens_equal_jax_per_uid(model):
    """Six requests of two lengths on four slots: exact-length one-slot
    prefills, decode over all four rows (idle rows route and take
    capacity, as in the reference)."""
    prompts = _prompts([7, 12, 7, 12, 7, 12])
    got = _serve("port", model, prompts)
    assert got == _serve("jax", model, prompts)
    assert set(got) == set(range(6))
    assert all(len(t) == 6 for t in got.values())


def test_lone_request_on_a_four_slot_engine_equals_jax(model):
    """As ``tests/test_serving_sched.py``'s lone MoE request: the prefill
    token equals offline forward, and every token equals the reference
    engine's (its decode rows include the three idle slots')."""
    jcfg, _p, packed, tcfg, _tp, tpacked = model
    prompt = _prompts([12], seed=7)[0]
    got = _serve("port", model, [prompt], max_new=4)
    assert got == _serve("jax", model, [prompt], max_new=4)
    logits = tfm.forward(tpacked, _t(prompt)[None].long(), tcfg)
    assert got[0][0] == int(torch.argmax(logits[0, -1]))


def test_scheduler_serves_the_moe_engine_as_jax(model):
    prompts = _prompts([7, 12, 7, 12, 7], seed=2)
    got = _serve("port", model, prompts, sched=True)
    assert got == _serve("jax", model, prompts, sched=True)


def test_kv_paging_a_moe_engine_keeps_its_tokens(model):
    """``attach_kv_paging`` pages attention KV only: a MoE engine's
    tokens do not move."""
    prompts = _prompts([7, 12, 7, 12, 7], seed=4)
    assert (_serve("port", model, prompts, kv=4)
            == _serve("port", model, prompts))


FAST = dict(backoff_s=1e-5, backoff_cap_s=1e-4)     # tests/test_faults.py:32
CHAOS = dict(seed=3, fail_rate=0.2, bitflip_rate=0.2, **FAST)
WIRE_KEYS = ("swap_count", "miss_count", "n_pages", "bytes_streamed_wire",
             "bytes_streamed_raw", "decode_skipped_bytes")
EXPERT_GROUPS = {"layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down"}


@pytest.fixture(scope="module")
def wire_store(model):
    """The smoke store frozen at 4 bits by JAX and carried over, for
    wire-served paging (int8 pages of a 4-bit store)."""
    jcfg, params, _packed, tcfg, _tp, _tpk = model
    packed = jfreeze(params, bits=4)
    return packed, interop.params_from_numpy(_np(packed), tcfg, device="cpu")


def _expert_wire_plan(pl, sizes):
    """The experts' three linears int8-paged (wire-served) and every other
    packed group pinned, in either package."""
    hot = pl.Placement("l1mram", 4, "resident")
    cold = pl.Placement("l1mram", 4, "paged", 8)
    return pl.PlacementPlan(default=cold, rules=tuple(
        (n, hot) for n in sorted(sizes) if n not in EXPERT_GROUPS))


def _wire_serve(side, model, store, faults=None):
    jcfg, *_r, tcfg, _tp, _tpk = model
    port = side == "port"
    pl = placement if port else jplacement
    tree = store[1] if port else store[0]
    plan = _expert_wire_plan(pl, pl.packed_sizes(tree))
    eng = (ServingEngine(tcfg, tree, batch_slots=2, max_len=64, plan=plan,
                         device="cpu") if port else
           JEngine(jcfg, tree, batch_slots=2, max_len=64, plan=plan))
    fplan = None if faults is None else (
        tfaults if port else jfaults).FaultPlan(**faults)
    eng.attach_paging(wire_serve=True, faults=fplan)
    make = Request if port else JRequest
    for uid, p in enumerate(_prompts([8, 8, 8, 8], seed=9)):
        eng.submit(make(uid=uid, prompt=p, max_new_tokens=5))
    toks = {r.uid: r.generated for r in eng.run_until_done()}
    out = (toks, eng.paging_summary(), eng.faults_summary(),
           set(eng.pager.wire_served), eng.pager.decode_s)
    eng.pager.close()
    return out


@pytest.mark.parametrize("chaos", [False, True])
def test_wire_served_paging_of_a_moe_store_matches_jax(model, wire_store,
                                                       chaos):
    """``attach_paging(wire_serve=True)`` on a MoE store: its cold expert
    pages arrive in wire form and the grouped blockscale linear multiplies
    them (the reference's vmapped ``quant_matmul_blockscale``).  Tokens,
    swaps, misses, wire and raw bytes, the fault counters and the
    wire-served set equal the JAX engine's."""
    faults = CHAOS if chaos else None
    toks, pg, fs, served, decode_s = _wire_serve("port", model, wire_store,
                                                 faults)
    jtoks, jpg, jfs, jserved, jdecode_s = _wire_serve("jax", model,
                                                      wire_store, faults)
    assert toks == jtoks
    assert all(len(t) == 5 for t in toks.values()) and len(toks) == 4
    assert {k: pg[k] for k in WIRE_KEYS} == {k: jpg[k] for k in WIRE_KEYS}
    assert pg["swap_count"] > 0 and pg["decode_skipped_bytes"] > 0
    assert served == jserved == EXPERT_GROUPS
    assert decode_s == 0.0 == jdecode_s       # no fetch decode ran
    assert fs == jfs
    if chaos:
        assert fs["injected"] > 0
        assert fs["checksum_failures"] == fs["refetches"]


def test_wire_served_moe_equals_a_resident_engine_on_the_wire_tree(
        model, wire_store):
    """The pager changes where the expert bytes come from, not what is
    computed: an engine holding the cold expert groups already in wire form,
    with no pager, serves the same tokens; its experts' linears take the
    grouped blockscale path (``ops.quant_matmul_blockscale`` on a stack of
    experts)."""
    *_r, tcfg, _tp, _tpk = model
    tree = wire_store[1]
    plan = _expert_wire_plan(placement, placement.packed_sizes(tree))
    toks = _wire_serve("port", model, wire_store)[0]
    eng = ServingEngine(tcfg, tree, batch_slots=2, max_len=64, plan=plan,
                        device="cpu")
    eng.attach_paging(wire_serve=True)
    wire_tree = paging.thread_packed(tree, {**eng.pager.resident,
                                            **eng.pager.template_view()})
    eng.pager.close()
    assert wire_tree["layers"]["moe"]["w_gate"]["scale"].ndim == 4
    calls = []
    real = ops._qmm.qmatmul_f32_blockscale_grouped

    def rec(x, packed, scales, **kw):
        calls.append(tuple(x.shape))
        return real(x, packed, scales, **kw)

    ops._qmm.qmatmul_f32_blockscale_grouped = rec
    try:
        resident = ServingEngine(tcfg, wire_tree, batch_slots=2, max_len=64,
                                 plan=plan.replace(wire_serve=True),
                                 device="cpu")
        for uid, p in enumerate(_prompts([8, 8, 8, 8], seed=9)):
            resident.submit(Request(uid=uid, prompt=p, max_new_tokens=5))
        got = {r.uid: r.generated for r in resident.run_until_done()}
    finally:
        ops._qmm.qmatmul_f32_blockscale_grouped = real
    assert got == toks
    # three expert linears a layer, 2 layers, every prefill and decode step
    assert calls and len(calls) % 6 == 0
    assert {c[0] for c in calls} == {tcfg.n_experts}


def _vmapped_blockscale(x, packed, scales, bits, k):
    return jax.vmap(lambda xx, pp, ss: jqmm.qmatmul_f32_blockscale(
        xx, pp, ss, bits=bits, k_orig=k, interpret=True))(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("c,k", [(8, 64), (24, 64), (8, 83)])
def test_grouped_blockscale_plain_equals_vmapped_pallas(bits, c, k):
    """``ops.quant_matmul_blockscale`` on a stack of experts (wire form:
    levels at ``bits`` and per-32 scales) against the reference's Pallas
    kernel vmapped over the experts in interpret mode, within B3's 1e-4;
    an expert with no rows gives zeros; the CPU launches nothing."""
    rng = np.random.default_rng(bits * 100 + c + k + 1)
    e, n = 5, 48
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    x[3] = 0.0                              # an expert that got no rows
    w = rng.normal(size=(e * n, k)).astype(np.float32) * k ** -0.5
    levels, scales = quantize.quantize_blockwise(w, bits)
    packed = packing.pack(torch.from_numpy(levels), bits).reshape(e, n, -1)
    scales = torch.from_numpy(scales).reshape(e, n, -1)
    expect = _vmapped_blockscale(x, packed.numpy(), scales.numpy(), bits, k)
    got = ops.quant_matmul_blockscale(_t(x), packed, scales, bits=bits,
                                      k_orig=k)
    assert got.shape == (e, c, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               rtol=1e-4, atol=1e-4)
    assert not got[3].any()
    np.testing.assert_array_equal(
        got.numpy(), ref.qmatmul_f32_blockscale_grouped(
            _t(x), packed, scales, bits=bits, k_orig=k).numpy())
    # each expert is the 2-D plain version on its own rows
    for i in range(e):
        np.testing.assert_array_equal(
            got[i].numpy(), ref.qmatmul_f32_blockscale(
                _t(x[i]), packed[i], scales[i], bits=bits,
                k_orig=k).numpy())
    assert qmatmul_f32_blockscale_grouped.launches == 0
