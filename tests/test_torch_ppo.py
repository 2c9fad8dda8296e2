"""The port's PPO learner (``microrts_tpu_torch.train.ppo`` ``_gae``,
``_loss``, the optimizer of ``train/optim.py``; plain path on the CPU)
against the JAX package's (``microrts_tpu.train.ppo`` and optax).

Inputs are made with numpy from a seed, or come from a port rollout on
basesWorkers8x8; the policy is a ``GridnetPolicy`` of width 16 with one
block, its parameters crossing with ``params_from_flax``.  The whole
update is in test_torch_ppo_update.py.

Tolerances:
* ``_gae``: advantages and returns 1e-6 relative + 1e-7 absolute (the
  same float32 operations in the same order, but XLA contracts the
  body's multiply-adds into fused ones: an ulp apart);
* ``_loss`` on an fp32 model: the loss and its four terms 1e-5 relative,
  every parameter's gradient 1e-5 relative + 1e-6 x max|g| absolute
  (float32 sums in another order); on a bf16 model (flax and the port
  round the activations to bf16 at the same places, but cuDNN-free CPU
  convolutions of the two frameworks sum in other orders, so a value can
  land on the other side of a bf16 rounding): 1e-2 relative for the loss
  terms, 5e-2 x max|g| absolute for the gradients;
* one clip + Adam minibatch step of the trainer (a step moves a weight by
  about lr): every parameter within 1e-2 x lr where JAX's gradient
  exceeds 1e-6 in magnitude, and within 2 x lr (a sign flip of a
  near-zero gradient) everywhere;
* the optimizer against optax over 3 steps on fixed gradients: the
  parameters' displacement 1e-6 relative + 1e-5 x lr absolute (the
  global norm sums in another order, and Adam's mu / sqrt(nu) cancels
  where a gradient changed sign between steps).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from microrts_tpu.train import ppo as JPPO
from microrts_tpu_torch.models.gridnet_policy import (ActionSpace,
                                                      GridnetPolicy,
                                                      flax_order,
                                                      params_from_flax,
                                                      params_to_flax)
from microrts_tpu_torch.train import optim
from microrts_tpu_torch.train.ppo import PPOConfig, PPOTrainer, Transition

from torch_rollout_parity import (_py_scan, flax_params, jax_noise,
                                  trainer_pair)

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"


@pytest.mark.parametrize("reverse", [False, True])
def test_py_scan_matches_lax_scan(reverse):
    """The tests' Python-loop stand-in for ``lax.scan`` (with ``xs``, the
    length taken from them, and ``reverse``) against ``lax.scan``."""
    def f(c, x):
        c = c * 0.5 + x["a"]
        return c, (c * x["b"], c)

    rng = np.random.default_rng(0)
    xs = dict(a=jnp.asarray(rng.random((5, 3), dtype=np.float32)),
              b=jnp.asarray(rng.random((5, 3), dtype=np.float32)))
    init = jnp.ones(3, jnp.float32)
    want = jax.lax.scan(f, init, xs, reverse=reverse)
    got = _py_scan(f, init, xs, reverse=reverse)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6)
    # no xs: a fixed length
    wc, wy = jax.lax.scan(lambda c, _: (c + 1.0, c), init, None, length=4,
                          reverse=reverse)
    gc, gy = _py_scan(lambda c, _: (c + 1.0, c), init, None, length=4,
                      reverse=reverse)
    np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))
    np.testing.assert_array_equal(np.asarray(gy), np.asarray(wy))


def test_gae_matches_jax():
    rng = np.random.default_rng(1)
    T, N = 6, 5
    reward = rng.normal(size=(T, N)).astype(np.float32)
    value = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.random((T, N)) < 0.3
    last = rng.normal(size=N).astype(np.float32)
    jtr = SimpleNamespace(cfg=JPPO.PPOConfig())
    jadv, jret = JPPO.PPOTrainer._gae(
        jtr, JPPO.Transition(None, None, None, None, jnp.asarray(value),
                             jnp.asarray(reward), jnp.asarray(done)),
        jnp.asarray(last))
    tr = SimpleNamespace(cfg=PPOConfig())
    adv, ret = PPOTrainer._gae(
        tr, Transition(None, None, None, None, torch.from_numpy(value),
                       torch.from_numpy(reward), torch.from_numpy(done)),
        torch.from_numpy(last))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-6,
                               atol=1e-7)


def _grads_flax(tr, grads):
    return params_to_flax(dict(zip(tr.param_names, grads)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype):
    """``_loss`` and its gradient with respect to every parameter, on a
    minibatch of a port rollout with normalised advantages drawn from a
    seed, against ``jax.value_and_grad(PPOTrainer._loss)``."""
    jtr, jts, tr, ts = trainer_pair(MAP, n=4, steps=4,
                                    opponent="RandomBiasedAI", tx="sgd",
                                    seed=3, dtype=dtype)
    noise = jax_noise(jts, 4, 4, tr.env.h, tr.env.w, tr.space.sizes, False)
    _, traj, _, _ = tr._rollout(ts, noise=lambda t: noise[t])
    rng = np.random.default_rng(2)
    batch = Transition(*[tr.minibatch(x, 1) for x in traj])
    n = batch.obs.shape[0]
    adv = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    ret = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    # old logprobs a little off the current ones, so the ratio clips
    batch = batch._replace(logprob=batch.logprob + torch.from_numpy(
        rng.normal(scale=0.3, size=n).astype(np.float32)))
    assert not batch.mask[..., :6].any(-1).all()   # cells that cannot act

    loss, aux = tr._loss(batch, adv, ret)
    grads = torch.autograd.grad(loss, tr.params())
    jbatch = JPPO.Transition(*[jnp.asarray(x.numpy()) for x in batch])
    (jloss, jaux), jgrads = jax.value_and_grad(jtr._loss, has_aux=True)(
        jts.params, jbatch, jnp.asarray(adv.numpy()),
        jnp.asarray(ret.numpy()))

    rtol, gtol = (1e-5, 1e-6) if dtype == "float32" else (1e-2, 5e-2)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=rtol)
    for k in ("pg_loss", "v_loss", "entropy", "ratio"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    got = jax.tree.leaves(_grads_flax(tr, grads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=rtol if dtype == "float32"
                                   else 0, atol=gtol * scale + 1e-30)


@pytest.mark.parametrize("tx", ["clip+adam", "clip+sgd", "adam"])
def test_optimizer_matches_optax(tx):
    """3 steps on fixed gradients (large enough, at the second step, to
    clip) from the same parameters, in the flax tree's leaf order."""
    space = ActionSpace(7, 7)
    model = GridnetPolicy(space, 27, width=8, blocks=1,
                          dtype=torch.float32).init_params(
        torch.Generator().manual_seed(0))
    names = flax_order([n for n, _ in model.named_parameters()])
    named = dict(model.named_parameters())
    params = [named[n].detach().clone() for n in names]
    start = [p.clone() for p in params]
    jparams = params_to_flax(dict(zip(names, params)))
    jstart = jparams
    lr = 1e-2
    make = dict(adam=lambda m: m.adam(lr), sgd=lambda m: m.sgd(lr))
    inner = tx.split("+")[-1]
    if tx.startswith("clip"):
        ttx = optim.chain(optim.clip_by_global_norm(0.5), make[inner](optim))
        jtx = optax.chain(optax.clip_by_global_norm(0.5), make[inner](optax))
    else:
        ttx, jtx = make[inner](optim), make[inner](optax)
    state, jstate = ttx.init(params), jtx.init(jparams)
    rng = np.random.default_rng(4)
    for step, scale in enumerate((1e-3, 10.0, 0.1)):
        # step 1's gradients have a global norm far above 0.5 (clipped)
        grads = [torch.from_numpy(rng.normal(scale=scale, size=p.shape)
                                  .astype(np.float32)) for p in params]
        jgrads = params_to_flax(dict(zip(names, grads)))
        upd, state = ttx.update(grads, state)
        optim.apply_updates(params, upd)
        jupd, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        # the parameters' total displacement (the parameters themselves
        # round to their own ulp, far below a step of lr)
        moved = {n: (p - p0).numpy() for n, p, p0 in zip(names, params,
                                                           start)}
        jmoved = params_from_flax(jax.tree.map(
            lambda a, b: np.asarray(a) - np.asarray(b), jparams, jstart))
        for n in names:
            np.testing.assert_allclose(moved[n], jmoved[n].numpy(),
                                       rtol=1e-6, atol=1e-5 * lr,
                                       err_msg=f"step {step} {n}")


def test_adam_minibatch_step_matches_jax():
    """One clip + Adam step on one minibatch of a port rollout, from the
    same parameters and optimizer state."""

    jtr, jts, tr, ts = trainer_pair(MAP, n=4, steps=4, opponent="WorkerRush",
                                    tx="adam", seed=6)
    lr = tr.cfg.lr
    noise = jax_noise(jts, 4, 4, tr.env.h, tr.env.w, tr.space.sizes, False)
    _, traj, last, _ = tr._rollout(ts, noise=lambda t: noise[t])
    adv, ret = tr._gae(traj, last)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    batch = Transition(*[tr.minibatch(x, 0) for x in traj])
    badv, bret = tr.minibatch(adv, 0), tr.minibatch(ret, 0)

    loss, _ = tr._loss(batch, badv, bret)
    params = tr.params()
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        upd, _ = tr.tx.update(list(grads), ts.opt_state)
        for p, u in zip(params, upd):
            p.add_(u)

    jbatch = JPPO.Transition(*[jnp.asarray(x.numpy()) for x in batch])
    (_, _), jgrads = jax.value_and_grad(jtr._loss, has_aux=True)(
        jts.params, jbatch, jnp.asarray(badv.numpy()),
        jnp.asarray(bret.numpy()))
    jupd, _ = jtr.tx.update(jgrads, jts.opt_state, jts.params)
    jp = params_from_flax(jax.tree.map(
        np.asarray, optax.apply_updates(jts.params, jupd)))
    jg = params_from_flax(jax.tree.map(np.asarray, jgrads))
    got = params_from_flax(flax_params(tr))
    for k in jp:
        diff = np.abs(got[k].numpy() - jp[k].numpy())
        big = np.abs(jg[k].numpy()) > 1e-6
        assert big.any(), k
        assert (diff[big] <= 1e-2 * lr).all(), (k, diff[big].max())
        assert (diff <= 2 * lr).all(), (k, diff.max())
