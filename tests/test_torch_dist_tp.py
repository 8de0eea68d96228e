"""Port parity: the train step's compute split over "model"
(``launch/dist_steps.make_distributed_train_step`` with each layer matmul
weight as the rank's ``ModelBlock``), against the JAX package's one-device
step on the CPU.

The reference runs ``jax.jit(make_train_step)`` on trees placed by
``param_shardings`` and GSPMD splits every matmul whose weight "model"
shards (``tests/test_multidevice.py:108-147``).  The port's ranks compute
the same share: column blocks of the dense weights, the attention by heads
where both head counts divide the "model" size (else q, k and v gathered
and attention whole), the MLP over F / M, the MoE's experts
expert-parallel (E divides) or over F / M (TP-in-expert, ``w_down``'s rows
summed over "model"), on the gathered route split again over "data"
(ROADMAP C22), and the embedding, the logits and the loss by vocab rows.

The cases are the dense, MoE, SSM, hybrid and encoder-decoder smoke
configs (``torch_dist_ranks.DIST_TP``).  The ranks are ``gloo`` processes
(``run_ranks``): one group of 4 runs every (2, 2) and (1, 4) case, one of
2 the (1, 2) case.  The JAX side is
``jax.jit(make_train_step)`` on one CPU device (a MoE's with its
``dp_axes``), the JAX weights carried over by ``interop``.  Tolerances are
the reference's mesh-vs-one-device ones, as in
``test_torch_dist_train.py``: the loss within 1e-4, each step's global
gradient norm within a relative 1e-5, every leaf within rtol = atol = 2e-3
and its change from the start within 5 % of one device's, in norm.

Each case also asserts the rank's share, from ``metrics["comm"]``: every
layer linear computed on a block of its weight; the ranks' layer
multiply-adds (the linears' and the routed experts', counted from the
shapes) adding up to one device's, a rank's being one device's over
dp * M where the split is even; no leaf that "model" shards gathered
whole over "model" but ``conv_w``, ``A_log``, ``router`` and the norms'
``scale`` (no matmul reads them); a rank's
logits (tokens, V / M); and the routed experts' slots adding up to one
device's (a rank's 1 / (dp * M) where that divides E; M times, each over
F / M, where "model" splits the experts over F).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.mesh import make_test_mesh as jmesh  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro import optim as jopt  # noqa: E402

from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.parallel import distributed as D  # noqa: E402

from test_torch_dist_train import (TIMEOUT_S, _check_step,  # noqa: E402
                                   _jax_step, _np)
from torch_dist_ranks import (DIST_TP, TP_STEPS, _ranks_tp,  # noqa: E402
                              tp_batch, tp_cfg)

GROUP_4 = [n for n, c in DIST_TP.items() if c[1] != (1, 2)]
GROUP_2 = [n for n, c in DIST_TP.items() if c[1] == (1, 2)]
# the leaves "model" shards that a rank gathers whole, by family: no
# matmul reads them.  A norm's ``scale`` is among them because the
# reference's rule places it on "model" too (its packed-``scale`` branch
# catches the name, ``repro/parallel/sharding.py:65-71``)
OVER_MODEL = {"dense": ["scale"], "encdec": ["scale"],
              "moe": ["router", "scale"],
              "ssm": ["A_log", "conv_w", "scale"],
              "hybrid": ["A_log", "conv_w", "scale"]}


def _ref_key(name):
    """Cases with one config and optimizer share one JAX run."""
    arch, _, over, opt = DIST_TP[name]
    return arch, tuple(sorted(over.items())), opt


@pytest.fixture(scope="module")
def runs():
    params, refs = {}, {}
    for name in DIST_TP:
        key = _ref_key(name)
        jcfg = tp_cfg(jget, name)
        init = (jencdec.init_params if jcfg.family == "encdec"
                else jtfm.init_params)
        jp = init(jcfg, jax.random.PRNGKey(0))
        params[name] = jax.tree_util.tree_map(np.asarray, jp)
        if key in refs:
            continue
        opt = getattr(jopt, DIST_TP[name][3])()
        if jcfg.family == "moe":
            with jmesh((1, 1), ("data", "model")):
                refs[key] = _jax_step(jcfg, opt, jp, tp_batch(jcfg),
                                      TP_STEPS,
                                      engine=dict(dp_axes=("data",)))
        else:
            refs[key] = _jax_step(jcfg, opt, jp, tp_batch(jcfg), TP_STEPS)
    out = {}
    for names, world in ((GROUP_4, 4), (GROUP_2, 2)):
        ranks = D.run_ranks(_ranks_tp, world, {n: params[n] for n in names},
                            names, device="cpu", timeout_s=TIMEOUT_S)
        for n in names:
            out[n] = [r[n] for r in ranks]
    return dict(out=out, refs=refs,
                params0={n: _np(p) for n, p in params.items()})


def _one_device(cfg, name):
    """One device's forward layer multiply-adds and routed expert slots
    for the (4, 32) batch, from the config's shapes."""
    d, L = cfg.d_model, cfg.n_layers
    tokens = 4 * (32 + cfg.n_meta_tokens)
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
    if cfg.family == "encdec":      # gelu MLPs; cross-attention's k, v
        frames = 4 * cfg.n_audio_frames     # on the encoder's frames
        mlp = 2 * d * cfg.d_ff
        return (cfg.n_encoder_layers * frames * (attn + mlp)
                + L * (tokens * (attn + 2 * d * cfg.q_dim + mlp)
                       + frames * 2 * d * cfg.kv_dim)), 0
    per_token = 0
    if cfg.n_heads:
        per_token += attn
    if cfg.d_inner:
        di, r, n = cfg.d_inner, cfg.dt_rank, cfg.ssm_state
        per_token += 2 * d * di + di * (r + 2 * n) + r * di + di * d
    if cfg.family == "moe":
        per_token += 3 * d * cfg.shared_d_ff
    elif cfg.d_ff:
        per_token += 3 * d * cfg.d_ff
    slots = 0
    if cfg.n_experts:
        g = cfg.moe_groups if cfg.moe_groups > 1 else 1
        slots = g * cfg.n_experts * tmoe.capacity(
            tokens // g, cfg.n_experts, cfg.n_experts_active,
            cfg.capacity_factor)
    passes = 2 if cfg.remat else 1         # remat runs each forward again
    macs = L * (tokens * per_token + slots * 3 * d * cfg.moe_d_ff)
    return passes * macs, passes * L * slots


@pytest.mark.parametrize("name", list(DIST_TP))
def test_split_step_matches_one_device(runs, name):
    """Every case against the JAX package's one-device step."""
    _check_step(runs["out"][name][0], runs["refs"][_ref_key(name)],
                runs["params0"][name])


@pytest.mark.parametrize("name", list(DIST_TP))
def test_each_rank_computes_its_share(runs, name):
    """A rank's share of the step, from its last step's ``comm``: every
    layer linear on a block, the ranks' multiply-adds and expert slots
    adding up to one device's (none computed twice), the gathers over
    "model" only of the leaves no matmul reads, the logits (tokens, V / M)
    and the attention split by heads where the head counts divide."""
    cfg = tp_cfg(jget, name)
    _, (dp, m), _, _ = DIST_TP[name]
    comms = [r["comm"] for r in runs["out"][name]]
    macs, slots = _one_device(cfg, name)
    for c in comms:
        assert c["linears_whole"] == 0 and c["linears_block"] > 0, c
        assert c["layer_macs_one_device"] == macs, (c, macs)
        # a router of 5 experts is not split over 2 ranks, so not gathered
        assert c["over_model"] == [n for n in OVER_MODEL[cfg.family] if
                                   n != "router" or cfg.n_experts % m == 0]
        assert c["logits"] == (4 // dp, 32 + cfg.n_meta_tokens,
                               cfg.vocab_size // m), c["logits"]
        heads_divide = cfg.n_heads and cfg.n_kv_heads % m == 0
        attention = (cfg.n_layers * (2 if cfg.family == "encdec" else 1)
                     + cfg.n_encoder_layers if cfg.n_heads else 0)
        assert c["attention_split" if heads_divide else "attention_whole"] \
            == attention * (1 + cfg.remat)
        assert c["act_calls"] > 0 and c["act_bytes"] > 0
    assert sum(c["layer_macs"] for c in comms) == macs
    # TP-in-expert: every model rank runs its slots over F / M
    tp = m if cfg.n_experts % m else 1
    assert sum(c["expert_slots"] for c in comms) == slots * tp
    if not cfg.n_experts or cfg.n_experts % (dp * m) == 0:
        assert all(c["layer_macs"] * dp * m == macs for c in comms)
    if cfg.n_experts % m == 0 and cfg.moe_groups == 0:
        # C22 closed: a rank runs 1 / (dp * M) of one device's slots
        assert all(c["expert_slots"] * dp * m == slots for c in comms)


def test_dp_gathers_and_layers_alive(runs):
    """On (2, 2) a layer's blocks are gathered over "data" only: a rank
    receives the other data rank's half of its model block of each layer
    weight, so with remat every layer is gathered twice a step and at most
    two layers' gathered leaves are alive at once."""
    for r in runs["out"]["dense_remat"]:
        assert r["gathers"] == [4] * TP_STEPS          # 2 layers, twice
        assert r["alive"] <= 2
    for r in runs["out"]["dense"]:
        assert r["gathers"] == [2] * TP_STEPS
        assert r["alive"] == 2
