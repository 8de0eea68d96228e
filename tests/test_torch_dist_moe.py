"""Port parity: a MoE trained on ``torch.distributed`` ranks at any
``moe_groups`` (``launch/dist_steps.make_distributed_train_step``,
``models/moe.moe_apply``'s gathered route), against the JAX package's
one-device step on the CPU.

Where ``moe_groups`` is not a multiple of the dp size (0, 1, or 3 on a
dp of 2) each MoE layer gathers the router's rows over the dp groups and
routes, caps and dispatches the whole batch's tokens, so every drop is
the one device's.  The ranks are ``gloo`` processes (``run_ranks``): one
group of 2 ranks runs every (2, 1) case, one of 4 the (2, 2) case.  The
JAX side is ``jax.jit(make_train_step)`` on one CPU device with the same
``moe_groups``, the JAX weights carried over by ``interop``; the bf16
case (the reference's train cell: bf16 weights, Adafactor, ``moe_groups``
0) is held against the port's single-rank step, which
``test_torch_train_bf16.py`` holds against JAX.

Tolerances are ``test_torch_dist_train.py``'s (the reference's mesh-vs-
one-device ones): the loss within 1e-4, each step's global gradient norm
within a relative 1e-5, every leaf within rtol = atol = 2e-3 and its change
from the start within 5 % of one device's change, in norm.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.mesh import make_test_mesh as jmesh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro import optim as jopt  # noqa: E402

from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel import distributed as D  # noqa: E402

from test_torch_dist_train import (LEAF_TOL, LOSS_TOL,  # noqa: E402
                                   TIMEOUT_S, _check_step, _jax_step, _np)
from torch_dist_ranks import (DIST_MOE, DIST_MOE_22, N_STEPS,  # noqa: E402
                              _batch, _ranks_dist_moe, _tbatch,
                              dist_moe_cfg, dist_moe_params)

# a dp step at bf16 against one rank: the dp sum of two bf16-rounded
# gradients against one rounding of the whole batch's (1.3e-4 here; the
# dense smoke config's two halves summed 6.5e-5 from its whole batch)
BF16_GNORM_RTOL = 1e-3


@pytest.fixture(scope="module")
def runs():
    params, refs = {}, {}
    for name, (_, _, _, opt) in DIST_MOE.items():
        jcfg = dist_moe_cfg(jget, name)
        jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        params[name] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jp)
        if name == "bf16":              # held step by step below
            continue
        with jmesh((1, 1), ("data", "model")):
            refs[name] = _jax_step(jcfg, getattr(jopt, opt)(), jp, _batch(),
                                   N_STEPS[opt],
                                   engine=dict(dp_axes=("data",)))
    out = {(2, 1): D.run_ranks(_ranks_dist_moe, 2, params, (2, 1),
                               list(DIST_MOE), device="cpu",
                               timeout_s=TIMEOUT_S)[0]}
    out[2, 2] = D.run_ranks(_ranks_dist_moe, 4,
                            {n: params[n] for n in DIST_MOE_22}, (2, 2),
                            DIST_MOE_22, device="cpu",
                            timeout_s=TIMEOUT_S)[0]
    return dict(out=out, refs=refs, params0={n: _np(p)
                                             for n, p in params.items()})


@pytest.mark.parametrize("name", ["groups0", "groups1", "groups3", "drops",
                                  "arctic"])
def test_moe_on_a_dp_pair_matches_one_device(runs, name):
    """(2, 1): moe_groups 0, 1 and 3 (none a multiple of the dp size: the
    gathered route), a capacity that drops, and arctic's dense
    residual."""
    _check_step(runs["out"][2, 1][name], runs["refs"][name],
                runs["params0"][name])


@pytest.mark.parametrize("name", DIST_MOE_22)
def test_moe_on_2x2_matches_one_device(runs, name):
    """(2, 2): the rows split over "data", the experts' weights sharded
    over "model" as well; the router's rows gathered over "data" only,
    each rank running its 2 of the 8 experts' slots."""
    _check_step(runs["out"][2, 2][name], runs["refs"][name],
                runs["params0"][name])


def test_drops_depend_on_the_other_half():
    """The "drops" case is one where a rank routing its own rows would
    drop other tokens: the batch's mean loss on one device differs from
    the mean of its two data halves' losses, each routed alone (attention
    and every other op act row by row, so only the MoE's capacity can make
    them differ)."""
    cfg = dist_moe_cfg(tget, "drops")
    params = dist_moe_params(jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(dist_moe_cfg(jget, "drops"),
                                     jax.random.PRNGKey(0))), cfg)
    b = _tbatch(_batch())
    with torch.no_grad():
        whole = float(tfm.lm_loss(params, b, cfg))
        halves = [float(tfm.lm_loss(params, {k: v[rows] for k, v in
                                             b.items()}, cfg))
                  for rows in (slice(0, 2), slice(2, 4))]
    assert abs(whole - sum(halves) / 2) > 1e-3, (whole, halves)


def test_bf16_train_cell_on_a_dp_pair_matches_one_rank(runs):
    """The reference's train cell (bf16 weights, Adafactor, moe_groups 0)
    on (2, 1), each step against one rank's step from the same state:
    the loss within 1e-4, the global gradient norm within a relative
    BF16_GNORM_RTOL, every leaf within rtol = atol = 2e-3.  A rank's bf16
    gradient is rounded before the dp sum adds it to the other's, where one
    rank rounds the whole batch's sum once, so the changes are not held in
    norm (``test_torch_train_bf16.py``: ROADMAP C21); their distance is
    printed."""
    res = runs["out"][2, 1]["bf16"]
    cfg = dist_moe_cfg(tget, "bf16")
    opt = optim.adafactor()
    step = steps.make_train_step(cfg, opt)
    ends = res["starts"][1:] + [(res["params"], None)]
    worst = []
    for k, ((p0, s0), (p1, _)) in enumerate(zip(res["starts"], ends)):
        want, _, met = step(dist_moe_params(p0, cfg),
                            T.tree_map(torch.from_numpy, s0),
                            _tbatch(_batch()))
        assert abs(res["losses"][k] - float(met["loss"])) < LOSS_TOL
        gn = float(met["grad_norm"])
        assert abs(res["grad_norms"][k] - gn) <= BF16_GNORM_RTOL * gn
        for (path, a), b, a0 in zip(T.flatten_with_paths(p1),
                                    T.leaves(interop.params_to_numpy(want)),
                                    T.leaves(p0)):
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, **LEAF_TOL, err_msg=str(path))
            worst.append((float(np.linalg.norm(a - b) / max(
                np.linalg.norm(b - a0), 1e-30)), k, "/".join(path)))
    print(f"bf16 train cell on (2, 1) vs one rank: losses {res['losses']}, "
          f"the largest change apart, in norm: {max(worst)}")
