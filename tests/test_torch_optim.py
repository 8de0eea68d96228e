"""Port parity: ``repro_torch.optim`` against ``repro.optim`` on the CPU.

The same trees (nested dicts whose insertion order is not the sorted
order, with 1-D, 2-D and 3-D leaves) and the same gradients, drawn from a
seeded numpy generator, go through both packages' optimizers for three
updates.  Both compute in f32 and differ only in the order of a few sums
and in ``pow`` / ``rsqrt`` rounding, so params and states agree within
1e-6 relative (``TOL``); ``count`` is equal.  The reference side runs
under ``jax.jit``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jopt  # noqa: E402

from repro_torch import interop, optim  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng):
    # insertion order differs from the sorted order jax.tree_util uses
    return dict(w=rng.normal(size=(6, 5)).astype(np.float32),
                b=rng.normal(size=(5,)).astype(np.float32),
                layers=dict(z=rng.normal(size=(2, 3, 4)).astype(np.float32),
                            c=rng.normal(size=(3,)).astype(np.float32)))


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_close(got, expect, **tol):
    got_flat = T.flatten_with_paths(interop.params_to_numpy(got))
    exp_flat = jax.tree_util.tree_flatten_with_path(expect)[0]
    assert len(got_flat) == len(exp_flat)
    for (path, a), (jpath, b) in zip(got_flat, exp_flat):
        assert path == tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in jpath)
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("kwargs", [{}, dict(weight_decay=0.05)])
def test_three_updates_match_jax(name, kwargs):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jo, to = getattr(jopt, name)(**kwargs), getattr(optim, name)(**kwargs)
    jupd = jax.jit(jo.update)
    jp, jst = _to_jax(params), jo.init(_to_jax(params))
    tp, tst = _to_torch(params), to.init(_to_torch(params))
    lr = 0.05
    for g in grads:
        jp, jst = jupd(_to_jax(g), jst, jp, jnp.asarray(lr, jnp.float32))
        tp, tst = to.update(_to_torch(g), tst, tp,
                            torch.tensor(lr, dtype=torch.float32))
        _assert_trees_close(tp, jp, **TOL)
        _assert_trees_close(tst, jst, **TOL)
        assert tst["count"].dtype == torch.int32
        assert int(tst["count"]) == int(jst["count"])


def test_adafactor_state_follows_sorted_key_order():
    """The flat ``v`` list lines up with the params' leaves in sorted-key
    order, as the reference's ``tree_flatten``, not insertion order."""
    params = _tree(np.random.default_rng(1))
    jst = jopt.adafactor().init(_to_jax(params))
    tst = optim.adafactor().init(_to_torch(params))
    shapes = [tuple(p.shape) for p in jax.tree_util.tree_leaves(params)]
    assert shapes == [(5,), (3,), (2, 3, 4), (6, 5)]     # b, layers/c, z, w
    assert [set(s) for s in tst["v"]] == [set(s) for s in jst["v"]]
    for ts, js in zip(tst["v"], jst["v"]):
        for k in js:
            assert tuple(ts[k].shape) == js[k].shape


def test_adafactor_state_carries_over_from_jax():
    """A JAX Adafactor state after one update, carried into the port by
    ``interop``, gives the JAX second update."""
    rng = np.random.default_rng(2)
    params, g1, g2 = _tree(rng), _tree(rng), _tree(rng)
    jo, to = jopt.adafactor(), optim.adafactor()
    lr = jnp.asarray(0.01, jnp.float32)
    jp, jst = jo.update(_to_jax(g1), jo.init(_to_jax(params)),
                        _to_jax(params), lr)
    tst = interop.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), device="cpu")
    tp, tst = to.update(_to_torch(g2), tst,
                        _to_torch(jax.tree_util.tree_map(np.asarray, jp)),
                        torch.tensor(0.01))
    jp, jst = jo.update(_to_jax(g2), jst, jp, lr)
    _assert_trees_close(tp, jp, **TOL)
    _assert_trees_close(tst, jst, **TOL)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])       # clips / does not
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(np.random.default_rng(3))
    jc, jn = jopt.clip_by_global_norm(_to_jax(grads), max_norm)
    tc, tn = optim.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _assert_trees_close(tc, jc, **TOL)


def test_schedules_match_jax():
    for step in range(0, 40, 3):
        for s in (step, torch.tensor(step),
                  torch.tensor(step, dtype=torch.int32)):
            np.testing.assert_allclose(
                float(optim.linear_warmup(s, 10, 3e-4)),
                float(jopt.linear_warmup(step, 10, 3e-4)), **TOL)
            np.testing.assert_allclose(
                float(optim.cosine_schedule(s, 10, 30, 3e-4)),
                float(jopt.cosine_schedule(step, 10, 30, 3e-4)), **TOL)


@pytest.mark.parametrize("total,chips", [(10 ** 6, 1), (10 ** 9, 1),
                                         (480 * 10 ** 9, 256),
                                         (10 ** 11, 8)])
def test_pick_optimizer_matches_jax(total, chips):
    assert (optim.pick_optimizer(total, n_chips=chips).name
            == jopt.pick_optimizer(total, n_chips=chips).name)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    opt = getattr(optim, name)()
    params = dict(w=torch.tensor([[2.0, -3.0], [1.0, 4.0]]),
                  b=torch.tensor([1.0, -1.0]))
    state = opt.init(params)
    loss = lambda p: torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)
    l0 = float(loss(params))
    for _ in range(50):
        grads = dict(w=2 * params["w"], b=2 * params["b"])
        params, state = opt.update(grads, state, params, torch.tensor(0.05))
    assert float(loss(params)) < 0.2 * l0
