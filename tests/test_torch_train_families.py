"""Port parity: training of the MoE, SSM, hybrid, VLM and encoder-decoder
families against the JAX package on the CPU, on the smoke configs of
qwen2-moe-a2.7b, arctic-480b (dense residual), falcon-mamba-7b, hymba-1.5b
(unsegmented and with ``segmented_window_scan``), llava-next-34b and
whisper-tiny, the JAX weights carried over by ``interop`` and the JAX side
run under ``jax.jit``.

The SSM and hybrid cases also run at S = 32 (+ hymba's 8 meta tokens) with
``ssm_chunk`` 8, so the state is carried across chunks, and 12, so the last
chunk is zero-padded.  The port's training scan (``models/ssm.selective_scan``)
follows ``jax.lax.associative_scan``'s tree of products, so the dense
family's tolerances hold for every family (both sides in f32, differing in
summation order only):

- the loss within 1e-6 relative;
- each gradient leaf within 1e-5 of the leaf's largest element;
- after 1-3 AdamW steps at lr 1e-3 the params within 1e-4 absolute and the
  moments within 1e-4 of the leaf's largest element (the first Adam steps
  move an element by about lr * g / |g|; see ``test_torch_train.py``);
- so the two packages' trajectories part by up to 1e-4 in such elements:
  the loss and grad norm of a later step agree within 1e-5 and 1e-4
  relative (arctic's third step: 1.9e-6 and 1.4e-5), and the moments are
  compared after the first step only; the port's loss and grad norm on the
  params the reference's step took in stay within 1e-6 and 1e-5.

The scan alone is held within 1e-6 (y, h_last) and 1e-5 of the largest
element (its gradients).  Also: the MoE block's parts (``route``'s top-k,
the dropped assignments' trash row, ``groups > 1``, the dense residual,
``router_aux_loss``) against ``jax.grad``; the training path reaches neither
the flash nor the scan wrapper; an encoder-decoder and a MoE tree
checkpoint and restart bit for bit.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch.steps import _init_fn as jinit_fn  # noqa: E402
from repro.launch.steps import _loss_fn as jloss_fn  # noqa: E402
from repro.launch.steps import make_train_step as jmake  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro import optim as jopt  # noqa: E402

from repro_torch import interop, optim  # noqa: E402
from repro_torch.checkpoint import restore_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import (FailureInjector, Trainer,  # noqa: E402
                                 TrainerConfig)

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5                   # of the leaf's largest |grad|
ADAM_PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
ADAM_STATE_TOL = 1e-4             # of the leaf's largest element
SCAN_TOL = dict(rtol=1e-6, atol=1e-6)
LR = 1e-3

# (id, arch, config overrides, text positions)
CASES = {
    "qwen2-moe": ("qwen2-moe-a2.7b", {}, 16),
    "arctic": ("arctic-480b", {}, 16),
    "falcon-mamba": ("falcon-mamba-7b", {}, 16),
    "falcon-mamba-chunk8": ("falcon-mamba-7b", dict(ssm_chunk=8), 32),
    "falcon-mamba-chunk12": ("falcon-mamba-7b", dict(ssm_chunk=12), 32),
    "hymba": ("hymba-1.5b", {}, 16),
    "hymba-segmented": ("hymba-1.5b", dict(segmented_window_scan=True), 32),
    "hymba-chunk8": ("hymba-1.5b", dict(ssm_chunk=8), 32),
    "hymba-chunk12": ("hymba-1.5b", dict(ssm_chunk=12), 32),
    "llava": ("llava-next-34b", {}, 16),
    "whisper": ("whisper-tiny", {}, 16),
}
# the cases that also take AdamW steps against the reference's
STEP_CASES = ("qwen2-moe", "arctic", "falcon-mamba-chunk8", "hymba",
              "hymba-segmented", "llava", "whisper")
# a leaf the loss never reads: hymba's SSM heads take the attention's
# normalised input, so ``ssm_norm`` has a zero gradient in both packages
UNREAD = {("layers", "ssm_norm", "scale")}


def _configs(case):
    arch, kw, seq = CASES[case]
    return (get_config(arch).smoke().replace(**kw),
            tget(arch).smoke().replace(**kw), seq)


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    cfg, _, _ = _configs(case)
    return jinit_fn(cfg)(cfg, jax.random.PRNGKey(0))


def _carry(tree, tcfg):
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                     tcfg, device="cpu")


def _batch(cfg, seq, step, mask=False):
    b = SyntheticLMDataset(cfg.vocab_size, seq, 2, seed=0, family=cfg.family,
                           d_model=cfg.d_model, n_frames=cfg.n_audio_frames,
                           n_patches=cfg.n_patches).batch(step)
    if mask:
        b["loss_mask"] = (np.random.default_rng(step).random((2, seq))
                          > 0.3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_leaves_close(got, expect, rel, zero=frozenset()):
    """Each leaf within ``rel`` of the expected leaf's largest element, and
    non-zero unless its path is in ``zero``."""
    got = T.flatten_with_paths(interop.params_to_numpy(got))
    expect = jax.tree_util.tree_leaves(expect)
    assert len(got) == len(expect)
    for (path, a), b in zip(got, expect):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, path
        assert (float(np.abs(a).max()) > 0) != (path in zero), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(case):
    cfg, tcfg, seq = _configs(case)
    params = _jax_params(case)
    jb, tb = _batch(cfg, seq, 0, mask=True)
    loss_fn = jloss_fn(cfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg)))(params, jb)
    tp = _carry(params, tcfg)
    tl, tg = steps.loss_and_grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    _assert_leaves_close(tg, jg, GRAD_TOL,
                         UNREAD if cfg.family == "hybrid" else frozenset())
    assert not any(p.requires_grad for p in T.leaves(tp))


@pytest.mark.parametrize("case", STEP_CASES)
def test_adamw_steps_match_jax(case):
    """Three AdamW steps of each package's ``make_train_step``; the loss
    and grad norm are compared at each step, on each package's own params
    and on the reference's, the params after the first and the third step,
    the moments after the first."""
    cfg, tcfg, seq = _configs(case)
    params = _jax_params(case)
    jo, to = jopt.adamw(), optim.adamw()
    jstep = jax.jit(jmake(cfg, jo, lr=LR))
    tstep = steps.make_train_step(tcfg, to, lr=LR)
    jp, js = params, jo.init(params)
    tp = _carry(params, tcfg)
    ts = to.init(tp)
    for i in range(3):
        jb, tb = _batch(cfg, seq, i)
        on_jax = steps.loss_and_grads(_carry(jp, tcfg), tb, tcfg)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(on_jax[0]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            float(torch.sqrt(sum(torch.sum(g * g)
                                 for g in T.leaves(on_jax[1])))),
            float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL if i == 0 else 1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-5 if i == 0 else 1e-4)
        if i in (0, 2):
            for (path, a), b in zip(T.flatten_with_paths(tp),
                                    jax.tree_util.tree_leaves(jp)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           err_msg=str(path),
                                           **ADAM_PARAM_TOL)
        if i == 0:
            for moment in ("mu", "nu"):
                _assert_leaves_close(ts[moment], js[moment], ADAM_STATE_TOL,
                                     UNREAD if cfg.family == "hybrid"
                                     else frozenset())
    assert int(ts["count"]) == int(js["count"]) == 3


# ---------------------------------------------------------------------------
# the training scan alone
# ---------------------------------------------------------------------------

def _scan_inputs(rng, b, s, di, n, h0):
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, di))) * 0.1).astype(np.float32)
    A = -np.exp(rng.normal(size=(di, n))).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    D = rng.normal(size=(di,)).astype(np.float32)
    H = rng.normal(size=(b, di, n)).astype(np.float32) if h0 else None
    return [x, dt, A, B, C, D, H]


@pytest.mark.parametrize("s,chunk,h0", [(32, 8, True), (37, 8, False),
                                        (5, 256, True), (64, 64, False),
                                        (1, 4, True)])
def test_training_scan_matches_reference(rng, s, chunk, h0):
    """``ssm.selective_scan`` against ``repro.models.ssm.selective_scan``:
    y, h_last, and the gradients of a random projection of both with
    respect to every input, at chunks that carry, pad, or hold it all."""
    args = _scan_inputs(rng, 2, s, 16, 4, h0)
    ry = rng.normal(size=(2, s, 16)).astype(np.float32)
    rh = rng.normal(size=(2, 16, 4)).astype(np.float32)
    idx = [i for i, a in enumerate(args) if a is not None]

    def jloss(*xs):
        full = list(args)
        for i, v in zip(idx, xs):
            full[i] = v
        y, h = jssm.selective_scan(*full, chunk=chunk)
        return jnp.sum(y * ry) + jnp.sum(h * rh), (y, h)

    (_, (jy, jh)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(idx))), has_aux=True))(
        *[args[i] for i in idx])
    targs = [None if a is None else torch.from_numpy(a).requires_grad_()
             for a in args]
    ty, th = ssm.selective_scan(*targs, chunk=chunk)
    (torch.sum(ty * torch.from_numpy(ry))
     + torch.sum(th * torch.from_numpy(rh))).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **SCAN_TOL)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **SCAN_TOL)
    for i, g in zip(idx, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(targs[i].grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=f"input {i}")


def test_associative_scan_matches_jax_bit_for_bit(rng):
    """The odd / even recursion gives ``jax.lax.associative_scan``'s bits
    at lengths from 1 to 20, odd and even at each depth."""
    for n in (1, 2, 3, 6, 7, 20):
        a = rng.random((2, n, 3)).astype(np.float32)
        b = rng.normal(size=(2, n, 3)).astype(np.float32)
        ja, jb = jax.lax.associative_scan(
            lambda p, q: (p[0] * q[0], q[0] * p[1] + q[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        ta, tb = ssm._associative_scan(torch.from_numpy(a),
                                       torch.from_numpy(b))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


# the training scan at a bf16 compute dtype (ROADMAP C7, closed): dA, dBx
# and the chunk's scan in bf16 as the reference computes them; XLA keeps
# some bf16 products in f32 inside its fusions, so y agrees within one bf16
# ulp of its largest element (1.8e-3 of it on these inputs; h_last equal)
BF16_SCAN_TOL = 2 ** -8


@pytest.mark.parametrize("s,chunk,h0", [(32, 8, True), (37, 8, False)])
def test_training_scan_at_bf16_matches_reference(rng, s, chunk, h0):
    """``ssm.selective_scan(compute_dtype=bfloat16)`` against the
    reference's, on f32 and on bf16 inputs."""
    args = _scan_inputs(rng, 2, s, 16, 4, h0)
    for dt_in in (jnp.float32, jnp.bfloat16):
        jargs = [None if a is None else jnp.asarray(a, dt_in if i in (0, 1, 3, 4)
                                                   else jnp.float32)
                 for i, a in enumerate(args)]
        jy, jh = jax.jit(lambda *xs: jssm.selective_scan(
            *xs, chunk=chunk, compute_dtype=jnp.bfloat16))(*jargs)
        targs = [None if a is None else torch.from_numpy(
            np.array(a.astype(jnp.float32))).to(
                torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
            for a in jargs]
        ty, th = ssm.selective_scan(*targs, chunk=chunk,
                                    compute_dtype=torch.bfloat16)
        for got, want in ((ty, jy), (th, jh)):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(
                got.float().numpy(), want, rtol=0,
                atol=BF16_SCAN_TOL * np.abs(want).max(), err_msg=str(dt_in))


# ---------------------------------------------------------------------------
# the MoE block's parts against jax.grad
# ---------------------------------------------------------------------------

def _moe_tree(rng, e, d, f, shared, dense):
    w = lambda *shape: (rng.normal(size=shape) * shape[-1] ** -0.5
                        ).astype(np.float32)
    p = dict(router=w(e, d), w_gate=w(e, f, d), w_up=w(e, f, d),
             w_down=w(e, d, f))
    mlp = lambda ff: dict(w_gate=w(ff, d), w_up=w(ff, d), w_down=w(d, ff))
    if shared:
        p["shared"] = mlp(shared)
    if dense:
        p["dense"] = mlp(dense)
    return p


def _torch_tree(tree):
    return T.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), tree)


@pytest.mark.parametrize("groups,factor,shared,dense", [
    (1, 1.25, 16, 0), (1, 0.5, 0, 0), (2, 1.25, 0, 24), (2, 0.5, 16, 24)])
def test_moe_apply_gradients_match_jax(rng, groups, factor, shared, dense):
    """``moe_apply``'s gradients with respect to x and every leaf, with the
    shared expert, arctic's dense residual, ``groups > 1`` and a capacity
    factor that drops assignments."""
    e, d, f, k, t = 8, 16, 12, 2, 32
    tree = _moe_tree(rng, e, d, f, shared, dense)
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    r = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    kw = dict(n_experts=e, k=k, capacity_factor=factor, groups=groups)

    def jloss(x, p):
        y = jmoe.moe_apply(x, p, **kw)
        return jnp.sum(y * r), y

    (jgx, jgp), jy = jax.jit(jax.grad(jloss, argnums=(0, 1),
                                      has_aux=True))(x, tree)
    jy = np.asarray(jy)
    tx, tp = torch.from_numpy(x).requires_grad_(), _torch_tree(tree)
    ty = moe.moe_apply(tx, tp, **kw)
    torch.sum(ty * torch.from_numpy(r)).backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=0,
                               atol=GRAD_TOL * np.abs(jy).max())
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=0,
                               atol=GRAD_TOL * np.abs(jgx).max())
    for (path, a), b in zip(T.flatten_with_paths(tp),
                            jax.tree_util.tree_leaves(jgp)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=0,
                                   atol=GRAD_TOL * np.abs(b).max(),
                                   err_msg=str(path))


def test_route_passes_the_gradient_to_the_chosen_logits(rng):
    """``route``'s stable sort gives ``jax.lax.top_k``'s indices and sends
    the gates' gradient to the chosen logits only."""
    x = rng.normal(size=(24, 16)).astype(np.float32)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    r = rng.normal(size=(24, 3)).astype(np.float32)
    def jloss(x, w):
        g, i = jmoe.route(x, w, 3)
        return jnp.sum(g * r), i

    (_, jidx), (jgx, jgw) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    gates, idx = moe.route(tx, tw, 3)
    torch.sum(gates * torch.from_numpy(r)).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for a, b in ((tx.grad, jgx), (tw.grad, jgw)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_TOL * np.abs(b).max())
    # the logits' gradient: zero off the chosen experts
    logits = (tx.detach() @ tw.detach().T).requires_grad_()
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    torch.sum(torch.softmax(top.values[:, :3], -1)
              * torch.from_numpy(r)).backward()
    chosen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, idx, True)
    assert torch.all(logits.grad[~chosen] == 0)
    assert torch.all(logits.grad.abs().sum(-1) > 0)


def test_dropped_assignments_give_their_token_a_zero_gradient(rng):
    """Every token routed to one expert of capacity 8: the tokens past the
    first 8 are written to the trash row, and dispatch -> experts ->
    combine gives them a zero gradient, as in the reference."""
    e, d, f, t, cap = 4, 8, 6, 20, 8
    tree = _moe_tree(rng, e, d, f, 0, 0)
    x = rng.normal(size=(t, d)).astype(np.float32)
    gates = np.ones((t, 1), np.float32)
    idx = np.zeros((t, 1), np.int32)

    def jloss(x, p):
        buf, aux = jmoe.dispatch(x, jnp.asarray(gates), jnp.asarray(idx), e,
                                 cap)
        return jnp.sum(jmoe.combine(jmoe.expert_ffn(buf, p), aux, t))

    jgx = np.asarray(jax.jit(jax.grad(jloss))(x, tree))
    tx, tp = torch.from_numpy(x).requires_grad_(), _torch_tree(tree)
    buf, aux = moe.dispatch(tx, torch.from_numpy(gates),
                            torch.from_numpy(idx).long(), e, cap)
    torch.sum(moe.combine(moe.expert_ffn(buf, tp), aux, t)).backward()
    assert int((~aux["keep"]).sum()) == t - cap
    assert torch.all(tx.grad[cap:] == 0) and np.all(jgx[cap:] == 0)
    assert torch.all(tx.grad[:cap].abs().sum(-1) > 0)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=0,
                               atol=GRAD_TOL * np.abs(jgx).max())


def test_router_aux_loss_gradient_matches_jax(rng):
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    idx = rng.integers(0, 8, (24, 2))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda x, w: jmoe.router_aux_loss(x, w, idx, 8), argnums=(0, 1)))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tl = moe.router_aux_loss(tx, tw, torch.from_numpy(idx), 8)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for a, b in ((tx.grad, jg[0]), (tw.grad, jg[1])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_TOL * np.abs(b).max())


# ---------------------------------------------------------------------------
# the training path runs no Hopper kernel wrapper
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                "hymba-1.5b", "hymba-1.5b-segmented", "llava-next-34b",
                "whisper-tiny")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_training_path_reaches_no_kernel_wrapper(arch, monkeypatch):
    """Training's loss and gradients take ``chunked_attention`` /
    ``windowed_attention`` and ``ssm.selective_scan`` by their own call, not
    by grad mode or device: ``kops.attention`` and ``kops.selective_scan``
    are never called, while serving's forward calls them."""
    seg = arch.endswith("-segmented")
    tcfg = tget(arch.replace("-segmented", "")).smoke().replace(
        segmented_window_scan=seg)
    calls = []
    for name in ("attention", "selective_scan"):
        real = getattr(kops, name)
        monkeypatch.setattr(kops, name, functools.partial(
            lambda real, name, *a, **k: calls.append(name) or real(*a, **k),
            real, name))
    params = steps._init_fn(tcfg)(tcfg, device="cpu")
    _, tb = _batch(tcfg, 16, 0)
    loss, grads = steps.loss_and_grads(params, tb, tcfg)
    assert calls == [] and torch.isfinite(loss)
    with torch.no_grad():
        if tcfg.family == "encdec":
            encdec.encode(params, tb["frames"], tcfg)
        else:
            tfm.forward(params, tb["tokens"], tcfg,
                        extra_embeds=tb.get("patches"))
    assert calls


# ---------------------------------------------------------------------------
# checkpoints and restart of the new families' trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-moe-a2.7b"])
def test_checkpoint_and_restart_equal_the_uninterrupted_run(arch, tmp_path):
    """An encoder-decoder tree (``enc_layers`` / ``dec_layers``) and a MoE
    tree save and restore equal, and a ``Trainer`` run crashed at step 3
    and resumed from its step-2 checkpoint ends on the uninterrupted run's
    params and AdamW state, bit for bit."""
    tcfg = tget(arch).smoke()
    init = steps._init_fn(tcfg)
    params = init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    save_pytree(params, tmp_path / "tree")
    back = restore_pytree(params, tmp_path / "tree")
    assert [p for p, _ in T.flatten_with_paths(back)] == \
        [p for p, _ in T.flatten_with_paths(params)]
    for a, b in zip(T.leaves(back), T.leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    opt = optim.adamw()

    def run(name, fail_at):
        def init_state():
            p = init(tcfg, torch.Generator().manual_seed(0), device="cpu")
            return dict(params=p, opt_state=opt.init(p))
        return Trainer(
            TrainerConfig(total_steps=5, checkpoint_every=2, log_every=100,
                          checkpoint_dir=str(tmp_path / name)),
            steps.make_train_step(tcfg, opt, lr=LR), init_state,
            SyntheticLMDataset(tcfg.vocab_size, 16, 2, seed=1,
                               family=tcfg.family, d_model=tcfg.d_model,
                               n_frames=tcfg.n_audio_frames,
                               n_patches=tcfg.n_patches),
            failure_injector=FailureInjector(fail_at), device="cpu").run()

    torch.use_deterministic_algorithms(True)
    try:
        clean, crashed = run("clean", []), run("crashed", [3])
    finally:
        torch.use_deterministic_algorithms(False)
    assert clean["restarts"] == 0 and crashed["restarts"] == 1
    assert [m["step"] for m in crashed["metrics"]] == [0, 1, 2, 2, 3, 4]
    for a, b in zip(T.leaves(dict(p=clean["params"], o=clean["opt_state"])),
                    T.leaves(dict(p=crashed["params"],
                                  o=crashed["opt_state"]))):
        assert torch.equal(a, b)
