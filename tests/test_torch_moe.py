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
from repro.kernels import qmatmul as jqmm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.parallel.sharding import freeze_for_serving as jfreeze  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qmatmul import qmatmul_f32_grouped  # noqa: E402
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
    *_, tcfg, tparams, _tp = model
    tp = interop.params_from_numpy(_np(_layer0(model[1])), tcfg,
                                   device="cpu")
    x = torch.zeros((4, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        moe.moe_apply(x, tp, n_experts=8, k=2, groups=2,
                      engine=dict(dp_axes=("data",)))


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
    with pytest.raises(NotImplementedError, match="ROADMAP B item 6"):
        ops.quant_matmul_blockscale(torch.zeros((3, 4, 8)), packed,
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


def test_wire_served_paging_of_a_moe_store_is_refused(model):
    *_, tcfg, _tp, tpacked = model
    sizes = placement.packed_sizes(tpacked)
    plan = placement.plan_for_budget(sizes, sum(sizes.values()) // 2)
    eng = ServingEngine(tcfg, tpacked, batch_slots=2, max_len=64, plan=plan,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP B item 6"):
        eng.attach_paging(wire_serve=True)
    assert eng.pager is None
