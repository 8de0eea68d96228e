"""Port parity: training over ``torch.distributed`` ranks
(``launch/dist_steps.make_distributed_train_step``), the elastic
restore (``checkpoint`` ``restore(shardings=)``), ``Trainer(shardings=)``
and ``moe_apply`` under ``dp_axes``, against the JAX package on the CPU.

The ranks are ``gloo`` processes started by ``run_ranks`` (``spawn``, a
``file://`` rendezvous in a fresh temporary directory); one group of 4
ranks runs every (2, 2) and (4, 1) case of this module and one of 2 ranks
the MoE cases on (2, 1), each once a module.  The JAX side is the
reference's own case (``tests/test_multidevice.py:121-145``): its
``jax.jit(make_train_step)`` on one CPU device, whose values GSPMD keeps
on a mesh, with the JAX weights carried over by ``interop``.

Tolerances are the reference's mesh-vs-one-device ones: the loss within
1e-4, every leaf within rtol = atol = 2e-3.  A first AdamW step moves an
element by about lr = 3e-4 whatever its gradient, below that leaf
tolerance, so each case also holds the step's global gradient norm (the
all-reduced gradient's, before the clip) within a relative 1e-5 of one
device's, and each leaf's change from the start (after the case's
steps) within 5 % of one device's change, in norm.  Checkpoints restore
bit for bit, and the restarted Trainer ends on the uninterrupted run's
bits.
"""

import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402,E501
from repro.checkpoint.manager import restore_pytree as jrestore  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch.mesh import make_test_mesh as jmesh  # noqa: E402
from repro.launch.steps import make_train_step as jmake  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro import optim as jopt  # noqa: E402

from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.parallel import distributed as D  # noqa: E402

from torch_dist_ranks import (ARCH, CKPT_ARCH, LAYER_MESHES,  # noqa: E402,E501
                              LAYERED_DEPTH, MOE_ARCH, MOE_GROUPS,
                              N_STEPS, _batch, _cfg, _fail_on_rank_1,
                              _moe_cfg, _ranks_4, _ranks_moe, _sleep,
                              _tbatch)

LOSS_TOL = 1e-4
LEAF_TOL = dict(rtol=2e-3, atol=2e-3)
GNORM_RTOL = 1e-5
DELTA_RTOL = 0.05
TIMEOUT_S = 240


def _np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the JAX side and the rank groups, once a module
# ---------------------------------------------------------------------------

def _jax_step(cfg, opt, params, batch, n_steps=1, engine=None):
    step = jax.jit(jmake(cfg, opt, engine=engine))
    state = opt.init(params)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, gnorms = [], []
    for _ in range(n_steps):
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    return params, losses, gnorms


@pytest.fixture(scope="module")
def runs():
    jcfg = _cfg(jget)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    ref = dict(adamw=_jax_step(jcfg, jopt.adamw(), jparams, _batch(),
                               N_STEPS["adamw"]),
               masked=_jax_step(jcfg, jopt.adamw(), jparams,
                                _batch(masked=True), N_STEPS["masked"]))
    # Adafactor: the port's single-rank step (test_torch_optim holds it
    # against JAX)
    tcfg = _cfg(tget)
    tparams = interop.params_from_numpy(params_np, tcfg, device="cpu")
    opt = optim.adafactor()
    step1 = steps.make_train_step(tcfg, opt)
    p, o, losses, gnorms = tparams, opt.init(tparams), [], []
    for _ in range(N_STEPS["adafactor"]):
        p, o, met = step1(p, o, _tbatch(_batch()))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    ref["adafactor"] = (interop.params_to_numpy(p), losses, gnorms)

    # the layer-at-a-time cases: JAX's one device and the port's one rank
    lcfg = _cfg(jget).replace(n_layers=LAYERED_DEPTH)
    lparams = jtfm.init_params(lcfg, jax.random.PRNGKey(0))
    layered_np = jax.tree_util.tree_map(np.asarray, lparams)
    ref["layered"] = _jax_step(lcfg, jopt.adamw(), lparams, _batch(),
                               N_STEPS["adamw"])
    tlcfg = _cfg(tget).replace(n_layers=LAYERED_DEPTH)
    p = interop.params_from_numpy(layered_np, tlcfg, device="cpu")
    opt = optim.adamw()
    step1 = steps.make_train_step(tlcfg, opt)
    o, losses, gnorms = opt.init(p), [], []
    for _ in range(N_STEPS["adamw"]):
        p, o, met = step1(p, o, _tbatch(_batch()))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    ref["layered_port"] = (interop.params_to_numpy(p), losses, gnorms)

    ocfg = jget(CKPT_ARCH).smoke()
    ckpt_params = jtfm.init_params(ocfg, jax.random.PRNGKey(1))
    with tempfile.TemporaryDirectory() as tmp:
        JCheckpointManager(Path(tmp) / "jax", async_save=False).save(
            3, dict(params=ckpt_params))
        out = D.run_ranks(_ranks_4, 4, params_np, layered_np,
                          str(Path(tmp) / "jax"),
                          tmp, device="cpu", timeout_s=TIMEOUT_S)
        # the port's (2, 2) checkpoint restores in the JAX package
        back = jrestore(dict(params=ckpt_params), out[0]["restore"][
            "port_dir"])
        restored_in_jax = _np(back["params"])
    moe_ref = {}
    moe_np = {}
    for groups in MOE_GROUPS:
        mcfg = _moe_cfg(jget, groups)
        mparams = jtfm.init_params(mcfg, jax.random.PRNGKey(0))
        moe_np[groups] = jax.tree_util.tree_map(np.asarray, mparams)
        with jmesh((1, 1), ("data", "model")):
            moe_ref[groups] = _jax_step(mcfg, jopt.adamw(), mparams,
                                        _batch(), N_STEPS["moe"],
                                        engine=dict(dp_axes=("data",)))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(moe_np[2]),
        jax.tree_util.tree_leaves(moe_np[4])))
    moe = D.run_ranks(_ranks_moe, 2, moe_np[2], device="cpu",
                      timeout_s=TIMEOUT_S)
    return dict(ref=ref, out=out, moe=moe, moe_ref=moe_ref,
                params0=_np(params_np), layered0=_np(layered_np),
                moe0={g: _np(t) for g, t in
                                              moe_np.items()},
                ckpt=_np(ckpt_params), restored_in_jax=restored_in_jax)


def _check_step(res, ref, start):
    """The sharded run ``res`` against one device's ``ref`` (params,
    losses, gradient norms), both from the leaves ``start``."""
    ref_params, ref_losses, ref_gnorms = ref
    assert len(res["losses"]) == len(ref_losses)
    for a, b in zip(res["losses"], ref_losses):
        assert abs(a - b) < LOSS_TOL, (res["losses"], ref_losses)
    np.testing.assert_allclose(res["grad_norms"], ref_gnorms,
                               rtol=GNORM_RTOL)
    got = jax.tree_util.tree_leaves(res["params"])
    want = jax.tree_util.tree_leaves(ref_params)
    assert len(got) == len(want) == len(start)
    for i, (a, b, a0) in enumerate(zip(got, want, start)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, **LEAF_TOL)
        moved, ref_moved = a - a0, b - a0
        err = float(np.linalg.norm(moved - ref_moved))
        assert err <= DELTA_RTOL * float(np.linalg.norm(ref_moved)), (
            f"leaf {i} {a.shape}: change {np.linalg.norm(moved)} vs one "
            f"device's {np.linalg.norm(ref_moved)}, apart by {err}")


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["adamw", "adafactor", "masked"])
def test_sharded_step_matches_one_device(runs, case):
    """(2, 2) ranks against one device: the reference's case under AdamW
    (JAX), Adafactor (the port's single-rank step: its whole-leaf means
    come through the ``mean`` hook) and a loss_mask that differs between
    the two data shards (JAX: a mean of the shards' means would miss)."""
    _check_step(runs["out"][0][case], runs["ref"][case], runs["params0"])


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("shape", LAYER_MESHES)
@pytest.mark.parametrize("against", ["jax", "port"])
def test_layer_at_a_time_step_matches_one_device(runs, shape, remat,
                                                 against):
    """A layer's leaves gathered just before its use, its gradient reduced
    as its backward ends, the leaves outside the layers once: 3 AdamW
    steps at 4 layers on (2, 2) and (4, 1), remat on and off, against
    JAX's one device and the port's one rank."""
    res = runs["out"][0]["layered"][shape, remat]
    _check_step(res, runs["ref"]["layered" if against == "jax"
                                 else "layered_port"], runs["layered0"])


def test_layer_leaves_alive_at_once(runs):
    """Counted through the gather, on every rank: with remat at most two
    layers' gathered leaves (on (2, 2) the rank's "model" blocks of the
    matmul weights, gathered over "data"; on (4, 1) whole leaves) are
    alive at once, each layer gathered twice a step (the forward, then
    again in the backward); without it autograd keeps every gathered
    layer for its backward, which the count shows."""
    for r in runs["out"]:
        for shape in LAYER_MESHES:
            on, off = r["layered"][shape, True], r["layered"][shape, False]
            assert on["alive"] <= 2, (shape, on["alive"])
            assert off["alive"] == LAYERED_DEPTH, (shape, off["alive"])
            assert on["gathers"] == [2 * LAYERED_DEPTH] * N_STEPS["adamw"]
            assert off["gathers"] == [LAYERED_DEPTH] * N_STEPS["adamw"]


def test_masked_step_is_not_a_mean_of_means(runs):
    """The masked batch's data shards hold 10 and 64 tokens: the mean of
    the two shards' mean losses is another number than the batch's mean,
    which the sharded step gives."""
    cfg = _cfg(tget)
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtfm.init_params(
            _cfg(jget), jax.random.PRNGKey(0))), cfg, device="cpu")
    b = _tbatch(_batch(masked=True))
    with torch.no_grad():
        means = [float(steps.tfm.lm_loss(
            params, {k: v[rows] for k, v in b.items()}, cfg))
            for rows in (slice(0, 2), slice(2, 4))]
    got = runs["out"][0]["masked"]["losses"][0]
    assert abs(got - runs["ref"]["masked"][1][0]) < LOSS_TOL
    assert abs(got - sum(means) / 2) > 100 * LOSS_TOL


@pytest.mark.parametrize("case", ["adamw", "adafactor"])
def test_each_rank_holds_its_blocks(runs, case):
    """Every rank holds the bytes its specs give (each leaf over its shard
    count) of the params and the optimizer state, and no more."""
    for r in runs["out"]:
        assert r[case]["held"] == r[case]["want"], (r[case]["held"],
                                                    r[case]["want"])
    total = sum(r[case]["held"] for r in runs["out"])
    assert total < 4 * runs["out"][0][case]["want"] * 1.0001


def test_local_rows_split_over_data(runs):
    """The rows go over "data" (``batch_pspec``): ranks (0, m) hold rows
    0-1, ranks (1, m) rows 2-3."""
    assert [r["rows"] for r in runs["out"]] == [[[0, 1]], [[0, 1]],
                                                [[2, 3]], [[2, 3]]]


@pytest.mark.parametrize("groups", MOE_GROUPS)
def test_moe_step_matches_jax_dp_dispatch(runs, groups):
    """The MoE smoke config on (2, 1): each rank dispatches its
    ``moe_groups / 2`` groups, against JAX's one-device step with the same
    ``moe_groups`` and ``dp_axes``."""
    _check_step(runs["moe"][0][groups], runs["moe_ref"][groups],
                runs["moe0"][groups])


# ---------------------------------------------------------------------------
# moe_apply under dp_axes, in process (its constraints are no-ops on 1 x 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
def test_moe_apply_dp_axes_matches_reference(groups):
    cfg = jget(MOE_ARCH).smoke()
    jp = jtfm.init_params(cfg, jax.random.PRNGKey(0))["layers"]["moe"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jp)
    x = np.random.default_rng(1).normal(size=(4, 8, cfg.d_model)).astype(
        np.float32)
    kw = dict(n_experts=cfg.n_experts, k=cfg.n_experts_active,
              capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
              groups=groups, engine=dict(dp_axes=("data",)))
    with jmesh((1, 1), ("data", "model")):
        want = np.asarray(jax.jit(lambda x, p: jmoe.moe_apply(x, p, **kw))(
            jnp.asarray(x), jp))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    got = tmoe.moe_apply(torch.from_numpy(x), tp, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = tmoe.moe_apply(torch.from_numpy(x), tp,
                           **dict(kw, engine=None)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_moe_apply_dp_axes_refuses_packed_experts():
    cfg = tget(MOE_ARCH).smoke()
    p = {n: dict(packed=torch.zeros(cfg.n_experts, 8, 8, dtype=torch.uint8),
                 scale=torch.ones(cfg.n_experts, 8))
         for n in ("w_gate", "w_up", "w_down")}
    p["router"] = torch.zeros(cfg.n_experts, 8)
    with pytest.raises(ValueError, match="dense experts"):
        tmoe.moe_apply(torch.zeros(2, 8, 8), p, n_experts=cfg.n_experts,
                       k=cfg.n_experts_active, groups=2,
                       engine=dict(dp_axes=("data",)))


# ---------------------------------------------------------------------------
# elastic restore and the Trainer
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_onto_rank_mesh(runs):
    """A checkpoint the JAX ``CheckpointManager`` wrote, restored onto
    (2, 2) with ``shardings=``: each rank holds its blocks, and the
    gathered tree equals the saved one bit for bit."""
    res = runs["out"][0]["restore"]
    assert res["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(res["from_jax"]),
                    runs["ckpt"]):
        np.testing.assert_array_equal(a, b)
    full = [tuple(x.shape) for x in runs["ckpt"]]
    assert any(tuple(b) != f for b, f in zip(res["blocks"], full))


def test_rank_checkpoint_restores_onto_other_mesh(runs):
    """Saved from (2, 2) (rank 0 writes the gathered leaves), restored onto
    (4, 1): bit-equal, each rank a quarter of the "data"-sharded leaves;
    and the same directory restores in the JAX package bit for bit."""
    res = runs["out"][0]["restore"]
    assert res["step41"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(res["on41"]), runs["ckpt"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs["restored_in_jax"], runs["ckpt"]):
        np.testing.assert_array_equal(a, b)
    assert res["blocks"] != res["blocks41"]


def test_trainer_restart_on_ranks_equals_uninterrupted(runs):
    """``Trainer(shardings=)`` with a failure injected at step 2 restarts
    every rank once from the step-1 checkpoint, restored onto the mesh,
    and ends on the uninterrupted run's params and state bit for bit."""
    for r in runs["out"]:
        t = r["trainer"]
        assert t["restarts"] == [0, 1]
        assert t["steps"] == [[0, 1, 2, 3], [0, 1, 2, 3]]
        assert t["sharded"] and t["equal"], t


def test_run_ranks_reports_a_failed_rank():
    """A rank that raises fails the call with its traceback, and every
    rank is stopped (the others would wait in the barrier forever)."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1:.*ValueError: boom"):
        D.run_ranks(_fail_on_rank_1, 2, device="cpu", timeout_s=60)


def test_run_ranks_times_out():
    with pytest.raises(TimeoutError, match="outlived"):
        D.run_ranks(_sleep, 2, 60.0, device="cpu", timeout_s=4)
