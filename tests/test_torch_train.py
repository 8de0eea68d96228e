"""Port parity: the training path (``lm_loss``, ``launch/steps``, the QAT
half of ``core/quantize``, the parameter counts) against the JAX package
on the CPU, on the qwen3-0.6b smoke config with the JAX weights carried
over by ``interop``; the reference side runs under ``jax.jit``.

Tolerances, both sides in f32 (they differ in summation order only):

- the loss within 1e-6 relative;
- each gradient leaf within 1e-5 of the leaf's largest element;
- after 1-3 AdamW steps at lr 1e-3 the params within 1e-4 absolute: the
  first Adam steps move each element by about lr * g / |g|, so an element
  whose gradient is near zero moves by a different fraction of lr when its
  gradient differs in the last bits; the moments within 1e-4 of the
  leaf's largest element, for the same reason;
- after 1-3 Adafactor steps (no such sign step) the params within 1e-6;
- ``fake_quant_weights``' values bit for bit, its gradient as the model's.

Also: the C9 check that the Hopper kernel wrappers make, C10
(``freeze_for_serving`` detaches), one train step of every smoke config
(the port's ``test_arch_smoke``), and training at a bf16 attention or
scan compute dtype (C6 / C7) against JAX.  The other families' parity is
``test_torch_train_families.py``'s.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.data import SyntheticLMDataset as JData  # noqa: E402
from repro.launch.steps import make_train_step as jmake  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402

from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.launch import forward_only  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.sharding import freeze_for_serving  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

ARCH = "qwen3-0.6b"
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5                   # of the leaf's largest |grad|
ADAM_PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
ADAM_STATE_TOL = 1e-4             # of the leaf's largest element
ADAFACTOR_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).smoke()
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tget(ARCH).smoke(), params


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _batch(step, mask=False):
    b = SyntheticLMDataset(256, 32, 4, seed=0).batch(step)
    if mask:
        b["loss_mask"] = (np.random.default_rng(step).random((4, 32))
                          > 0.3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_leaves_close(got, expect, rel):
    """Each leaf within ``rel`` of the expected leaf's largest element."""
    got = T.flatten_with_paths(interop.params_to_numpy(got))
    expect = jax.tree_util.tree_leaves(expect)
    assert len(got) == len(expect)
    for (path, a), b in zip(got, expect):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, path


@pytest.mark.parametrize("mask", [False, True])
def test_lm_loss_and_grads_match_jax(model, mask):
    cfg, tcfg, params = model
    jb, tb = _batch(0, mask)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.lm_loss(p, b, cfg)))(params, jb)
    tp = _carry(params, tcfg)
    tl, tg = steps.loss_and_grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _assert_leaves_close(tg, jg, GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in T.leaves(tg))
    # the caller's params are left as they were
    assert not any(p.requires_grad for p in T.leaves(tp))


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_jax(model, name, n_steps):
    cfg, tcfg, params = model
    jo, to = getattr(jopt, name)(), getattr(optim, name)()
    jstep = jax.jit(jmake(cfg, jo, lr=LR))
    tstep = steps.make_train_step(tcfg, to, lr=LR)
    jp, js = params, jo.init(params)
    tp = _carry(params, tcfg)
    ts = to.init(tp)
    for i in range(n_steps):
        jb, tb = _batch(i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    tol = ADAM_PARAM_TOL if name == "adamw" else ADAFACTOR_PARAM_TOL
    for (path, a), b in zip(T.flatten_with_paths(tp),
                            jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=str(path), **tol)
    assert int(ts["count"]) == int(js["count"]) == n_steps
    _assert_leaves_close({k: v for k, v in ts.items() if k != "count"},
                         {k: v for k, v in js.items() if k != "count"},
                         ADAM_STATE_TOL if name == "adamw" else 1e-5)
    assert not any(p.requires_grad for p in T.leaves(tp))


def test_trainer_matches_jax_trainer(model, tmp_path):
    """The slice as a whole: four steps of each package's ``Trainer``
    (AdamW, step-indexed data, a checkpoint every 2 steps) from the same
    weights give the same losses and final params."""
    cfg, tcfg, params = model
    tcfg_ = TrainerConfig(total_steps=4, checkpoint_every=2, log_every=100,
                          checkpoint_dir=str(tmp_path / "torch"))
    jcfg_ = JTrainerConfig(total_steps=4, checkpoint_every=2, log_every=100,
                           checkpoint_dir=str(tmp_path / "jax"))
    jo, to = jopt.adamw(), optim.adamw()
    jout = JTrainer(jcfg_, jax.jit(jmake(cfg, jo, lr=LR)),
                    lambda: dict(params=params, opt_state=jo.init(params)),
                    JData(256, 32, 4, seed=1)).run()

    def init_state():
        p = _carry(params, tcfg)
        return dict(params=p, opt_state=to.init(p))

    tout = Trainer(tcfg_, steps.make_train_step(tcfg, to, lr=LR), init_state,
                   SyntheticLMDataset(256, 32, 4, seed=1),
                   device="cpu").run()
    np.testing.assert_allclose([m["loss"] for m in tout["metrics"]],
                               [m["loss"] for m in jout["metrics"]],
                               rtol=LOSS_RTOL)
    for a, b in zip(T.leaves(tout["params"]),
                    jax.tree_util.tree_leaves(jout["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ADAM_PARAM_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal(arch):
    jcfg, tcfg = JARCHS[arch], ARCHS[arch]
    assert tfm.active_param_count(tcfg) == jtfm.active_param_count(jcfg)
    assert tfm.total_param_count(tcfg) == jtfm.total_param_count(jcfg)
    if tcfg.family in tfm.FAMILIES:
        jshapes = jax.eval_shape(functools.partial(
            jtfm.init_params, jcfg.smoke()), jax.random.PRNGKey(0))
        tparams = tfm.init_params(tcfg.smoke(), device="cpu")
        assert tfm.count_params(tparams) == jtfm.count_params(jshapes)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape,axis", [((16, 40), 0), ((24, 3, 8), 1)])
def test_fake_quant_weights_and_ste_gradient_match_jax(bits, shape, axis):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    w[0] = 0.0                       # a channel of zeros (scale 1.0)
    jf = lambda w: jnp.sum(jq.fake_quant_weights(w, bits, axis) * r)
    jv = jq.fake_quant_weights(jnp.asarray(w), bits, axis)
    jg = jax.grad(jf)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    tv = tq.fake_quant_weights(tw, bits, axis)
    (tv * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    # the gradient through the scale sums over a channel: GRAD_TOL of the
    # largest element, as the model's gradients
    jg = np.asarray(jg)
    np.testing.assert_allclose(tw.grad.numpy(), jg, rtol=0,
                               atol=GRAD_TOL * np.abs(jg).max())


def test_ste_round_passes_the_gradient_through():
    x = torch.tensor([0.4, 1.5, 2.5, -0.6], requires_grad=True)
    y = tq._ste_round(x)
    y.sum().backward()
    assert y.tolist() == [0.0, 2.0, 2.0, -1.0]        # half to even
    assert x.grad.tolist() == [1.0, 1.0, 1.0, 1.0]


def test_remat_on_and_off_give_equal_gradients(model):
    _, tcfg, params = model
    _, tb = _batch(2)
    tp = _carry(params, tcfg)
    la, ga = steps.loss_and_grads(tp, tb, tcfg.replace(remat=True))
    lb, gb = steps.loss_and_grads(tp, tb, tcfg.replace(remat=False))
    assert torch.equal(la, lb)
    for a, b in zip(T.leaves(ga), T.leaves(gb)):
        assert torch.equal(a, b)


def test_training_path_does_not_reach_the_flash_wrapper(model, monkeypatch):
    """``lm_loss`` picks ``chunked_attention`` by its own call, not by grad
    mode or device; serving's ``forward`` keeps the flash wrapper."""
    _, tcfg, params = model
    tp = _carry(params, tcfg)
    calls = []
    real = kops.attention
    monkeypatch.setattr(kops, "attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tb = _batch(0)
    steps.loss_and_grads(tp, tb, tcfg)
    assert calls == []
    with torch.no_grad():
        tfm.forward(tp, tb["tokens"], tcfg)
    assert len(calls) == tcfg.n_layers


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_smoke_trains(arch):
    """The port's counterpart of ``tests/test_arch_smoke.py``: each smoke
    config takes one ``_loss_fn`` and one AdamW ``make_train_step`` on the
    CPU; the loss, the grad norm and the params stay finite and the params
    move."""
    tcfg = ARCHS[arch].smoke()
    params = steps._init_fn(tcfg)(tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    rng = np.random.default_rng(0)
    b, s = 2, 32
    batch = dict(tokens=torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                                      (b, s))),
                 labels=torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                                      (b, s))))
    if tcfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            b, tcfg.n_audio_frames, tcfg.d_model)).astype(np.float32))
    if tcfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(size=(
            b, tcfg.n_patches, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        loss = steps._loss_fn(tcfg)(params, batch, tcfg)
    assert torch.isfinite(loss), arch
    opt = optim.adamw()
    new, _, metrics = steps.make_train_step(tcfg, opt)(
        params, opt.init(params), batch)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])
    assert all(torch.isfinite(p).all() for p in T.leaves(new)), arch
    assert any(not torch.equal(a, b)
               for a, b in zip(T.leaves(params), T.leaves(new))), arch


# C6 / C7 (closed): training computes attention in cfg.attn_dtype and the
# scan in cfg.scan_dtype, as the reference's lm_loss does (whisper's
# encoder-decoder reads neither field, in both packages).  The port's
# chunked attention and training scan round where the reference's do; the
# loss agrees within BF16_LOSS_RTOL (2.5e-6 at most on these batches) and
# each gradient leaf within BF16_GRAD_TOL of its largest element: the
# backward passes through the bf16 roundings differ in order and in where
# XLA keeps f32 inside its fusions (3.3e-3 at the bf16 attention's wq / wk,
# 1.5e-2 at falcon-mamba-7b's dt_bias through the bf16 scan; whisper-tiny,
# which reads neither field, 1.4e-6)
BF16_LOSS_RTOL = 1e-5
BF16_GRAD_TOL = 3e-2


@pytest.mark.parametrize("arch,field", [
    ("qwen3-0.6b", "attn_dtype"), ("hymba-1.5b", "attn_dtype"),
    ("hymba-1.5b", "scan_dtype"), ("falcon-mamba-7b", "scan_dtype"),
    ("whisper-tiny", "attn_dtype")])
def test_training_at_bf16_compute_matches_jax(arch, field):
    """The loss and its gradients (``loss_and_grads``, the train step's) at
    a bf16 attention or scan compute dtype against ``jax.value_and_grad``
    of the reference's loss, and one AdamW step runs."""
    from repro.models import encdec as jenc

    cfg = get_config(arch).smoke().replace(**{field: "bfloat16"})
    tcfg = tget(arch).smoke().replace(**{field: "bfloat16"})
    init = jenc.init_params if cfg.family == "encdec" else jtfm.init_params
    jloss = jenc.seq2seq_loss if cfg.family == "encdec" else jtfm.lm_loss
    params = init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = dict(tokens=rng.integers(0, 256, (2, 16)).astype(np.int32),
                 labels=rng.integers(0, 256, (2, 16)).astype(np.int32))
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(2, cfg.n_audio_frames,
                                           cfg.d_model)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jloss(p, b, cfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _carry(params, tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tg = steps.loss_and_grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)
    _assert_leaves_close(tg, jg, BF16_GRAD_TOL)
    opt = optim.adamw()
    new, _, metrics = steps.make_train_step(tcfg, opt)(tp, opt.init(tp), tb)
    assert torch.isfinite(metrics["loss"])
    assert all(torch.isfinite(p).all() for p in T.leaves(new))


def test_forward_only_check():
    """C9: the check each Hopper kernel wrapper makes before it launches."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only.*ROADMAP A10"):
        forward_only("flash_attention", torch.ones(3), x)
    with torch.no_grad():
        forward_only("flash_attention", x)
    forward_only("qmatmul_f32", torch.ones(3), None,
                 torch.ones(3, dtype=torch.uint8))
    # on the CPU the wrappers take the differentiable plain versions
    q = torch.randn(1, 2, 4, 16, requires_grad=True)
    assert kops.attention(q, q.detach(), q.detach()).requires_grad


def test_freeze_for_serving_detaches(model):
    """C10: a trained tree that requires grad freezes into one that does
    not, with the same bytes."""
    _, tcfg, params = model
    tp = _carry(params, tcfg)
    want = freeze_for_serving(tp, bits=8, device="cpu")
    for p in T.leaves(tp):
        p.requires_grad_()
    got = freeze_for_serving(tp, bits=8, device="cpu")
    assert not any(t.requires_grad for t in T.leaves(got))
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert torch.equal(a, b)
