"""Helpers of the rollout parity tests: the JAX package's
``PPOTrainer._rollout`` and the port's, side by side on the same envs,
parameters and noise (see test_torch_rollout.py for what is compared)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots.scripted import random_bot as jax_random_bot
from microrts_tpu.models import gridnet_policy as JP
from microrts_tpu.train import ppo as JPPO
from microrts_tpu_torch.bots.scripted import random_opponent
from microrts_tpu_torch.engine.types import state_from_numpy
from microrts_tpu_torch.models.gridnet_policy import (ActionSpace,
                                                      GridnetPolicy,
                                                      params_from_flax)
from microrts_tpu_torch.train.ppo import PPOConfig, PPOTrainer, StepNoise

from torch_parity import (BIAS, assert_eq, assert_state_eq, envs, jax_fns,
                          leaves)


def _py_scan(f, init, xs, length=None, reverse=False):
    """``lax.scan`` as a Python loop (eager body).  The length comes from
    ``xs`` when not given; with ``reverse`` the loop walks the inputs
    backwards and stacks the outputs in the inputs' order, as
    ``lax.scan(..., reverse=True)`` does."""
    if length is None:
        length = jax.tree.leaves(xs)[0].shape[0]
    order = range(length - 1, -1, -1) if reverse else range(length)
    carry, ys = init, [None] * length
    for i in order:
        carry, ys[i] = f(carry, None if xs is None else
                         jax.tree.map(lambda x: x[i], xs))
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _draws(h, w, sizes):
    """Vmapped replicas of JAX's per-env draws, run eagerly so that they
    reuse the compiled ``_gumbel`` of ``sample_action``'s categoricals."""
    def gumbels(keys):
        ks = jax.vmap(lambda k: jax.random.split(k, 7))(keys)
        return jnp.concatenate(
            [jax.vmap(lambda k: jax.random.gumbel(k, (h, w, s)))(ks[:, i])
             for i, s in enumerate(sizes)], -1)
    return (jax.vmap(lambda k: jax.random.split(k, 3)), gumbels,
            jax.vmap(lambda k: jax.random.uniform(k, (h, w, 2))))


def jax_noise(jts, n, steps, h, w, sizes, selfplay):
    """The per-step noise JAX's ``_rollout`` draws, as StepNoise."""
    split3, gumbels, uniforms = _draws(h, w, sizes)
    base = jax.random.fold_in(jts.key, jts.update_count)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(n, dtype=jnp.uint32))
    out = []
    for _ in range(steps):
        ks3 = split3(keys)
        skeys, okeys, keys = ks3[:, 0], ks3[:, 1], ks3[:, 2]
        opp = gumbels(okeys) if selfplay else uniforms(okeys)
        out.append(StepNoise(torch.from_numpy(np.array(gumbels(skeys))),
                             torch.from_numpy(np.array(opp))))
    return out


def _masked_keyed(logits, mask, g, space):
    """Per component: masked logits + gumbel (numpy)."""
    out = []
    for lg, mk, gg in zip(JP.split_components(logits, space),
                          JP.split_components(mask, space),
                          JP.split_components(g, space)):
        has = mk.any(-1, keepdims=True)
        out.append(np.where(mk | ~has, lg, np.float32(-1e9)) + gg)
    return out


def _top2_margin(keyed):
    m = np.inf
    for k in keyed:
        if k.shape[-1] < 2:
            continue
        s = np.sort(k, -1)
        m = min(m, float((s[..., -1] - s[..., -2]).min()))
    return m


def run_pair(map_rel, n, steps, max_steps, selfplay, seed):
    jenv, env = envs(map_rel)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    jenv.masks = jax.jit(jenv.masks)
    ecfg = jenv.cfg.engine
    jspace = JP.ActionSpace(ecfg.num_types, 2 * ecfg.max_range + 1)
    jmodel = JP.GridnetPolicy(jspace, dtype=jnp.float32)
    cfg = dict(num_envs=n, rollout_len=steps, max_steps=max_steps)
    opp = None if selfplay else jax.jit(jax_random_bot(jenv, BIAS))
    jtr = JPPO.PPOTrainer(jenv, JPPO.PPOConfig(**cfg), opponent=opp,
                          selfplay=selfplay, model=jmodel)
    jts = jtr.init(jax.random.PRNGKey(seed))

    tr = PPOTrainer(env, PPOConfig(**cfg), selfplay=selfplay,
                    opponent=None if selfplay else random_opponent(env, BIAS),
                    model=GridnetPolicy(
                        ActionSpace(ecfg.num_types, 2 * ecfg.max_range + 1),
                        20 + ecfg.num_types, dtype=torch.float32))
    tr.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jts.params)))
    ts = tr.init(seed=None)
    ts = dataclasses.replace(
        ts, env_states=state_from_numpy(leaves(jts.env_states)),
        env_steps=torch.from_numpy(np.array(jts.env_steps)))
    noise = jax_noise(jts, n, steps, env.h, env.w, jspace.sizes, selfplay)

    jscan = jax.lax.scan
    jax.lax.scan = _py_scan
    try:
        jts2, jtraj, jlast, jwins = jtr._rollout(
            jts, jnp.arange(n, dtype=jnp.uint32))
    finally:
        jax.lax.scan = jscan
    ts2, traj, last, wins = tr._rollout(ts, noise=lambda t: noise[t])
    return dict(jenv=jenv, jtr=jtr, jts=jts, jts2=jts2, jtraj=jtraj,
                jlast=jlast, jwins=jwins, tr=tr, ts2=ts2, traj=traj,
                last=last, wins=wins, noise=noise, jspace=jspace)


def check_pair(r):
    jt, t = r["jtraj"], r["traj"]
    assert_eq(jt.obs, t.obs, "obs")
    assert_eq(jt.mask, t.mask, "mask")
    assert_eq(jt.action, t.action, "action")
    assert_eq(jt.reward, t.reward, "reward")
    assert_eq(jt.done, t.done, "done")
    np.testing.assert_allclose(t.logprob.numpy(), np.asarray(jt.logprob),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(t.value.numpy(), np.asarray(jt.value),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(r["last"].numpy(), np.asarray(r["jlast"]),
                               rtol=0, atol=1e-4)
    assert int(r["wins"]) == int(r["jwins"])
    assert_state_eq(r["jts2"].env_states, r["ts2"].env_states, "final")
    assert_eq(r["jts2"].env_steps, r["ts2"].env_steps, "final steps")

    # actions are exact because no sampled cell is near a tie
    jtr, jts = r["jtr"], r["jts"]
    apply = jax.jit(jtr.model.apply)
    worst_diff, margin = 0.0, np.inf
    for s in range(t.obs.shape[0]):
        jl, _ = apply(jts.params, jt.obs[s])
        with torch.no_grad():
            tl, _ = r["tr"].model(t.obs[s])
        worst_diff = max(worst_diff, float(np.abs(
            tl.numpy() - np.asarray(jl)).max()))
        margin = min(margin, _top2_margin(_masked_keyed(
            np.asarray(jl), np.asarray(jt.mask[s]),
            r["noise"][s].gumbel.numpy(), r["jspace"])))
    assert margin > worst_diff, (margin, worst_diff)
    return margin, worst_diff


# ----------------------------------------------------------------------
# a whole PPO update in both packages

def jax_opponent(name, jenv):
    """The JAX package's bot ``name`` (jitted), or None for no opponent."""
    from microrts_tpu.config import make_bot as jax_make_bot
    return jax.jit(jax_make_bot(name, jenv))


class _JitModel:
    """A flax module whose ``apply`` is jitted (the rollout's forward)."""

    def __init__(self, module):
        self.module = module
        self.apply = jax.jit(module.apply)


def trainer_pair(map_rel, n, steps, opponent, tx, seed, width=16, blocks=1,
                 max_steps=50, epochs=2, minibatches=2, lr=2.5e-4,
                 dtype="float32"):
    """(JAX trainer, its TrainState, port trainer, its TrainState) on the
    same envs and parameters; ``tx`` names the optimizer ("sgd" or
    "adam", each after clip_by_global_norm(0.5))."""
    import optax

    from microrts_tpu_torch.config import make_bot
    from microrts_tpu_torch.train import optim

    jenv, env = envs(map_rel)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    jenv.masks = jax.jit(jenv.masks)
    ecfg = jenv.cfg.engine
    jspace = JP.ActionSpace(ecfg.num_types, 2 * ecfg.max_range + 1)
    jdt = dict(float32=jnp.float32, bfloat16=jnp.bfloat16)[dtype]
    tdt = dict(float32=torch.float32, bfloat16=torch.bfloat16)[dtype]
    cfg = dict(num_envs=n, rollout_len=steps, max_steps=max_steps,
               epochs=epochs, minibatches=minibatches, lr=lr)
    jtx = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.sgd(lr) if tx == "sgd" else optax.adam(lr))
    ttx = optim.chain(optim.clip_by_global_norm(0.5),
                      optim.sgd(lr) if tx == "sgd" else optim.adam(lr))
    jtr = JPPO.PPOTrainer(
        jenv, JPPO.PPOConfig(**cfg), opponent=jax_opponent(opponent, jenv),
        model=JP.GridnetPolicy(jspace, width=width, blocks=blocks,
                               dtype=jdt), tx=jtx)
    jtr._loss = jax.jit(jtr._loss)
    jts = jtr.init(jax.random.PRNGKey(seed))
    jtr.model = _JitModel(jtr.model)
    tr = PPOTrainer(env, PPOConfig(**cfg), opponent=make_bot(opponent, env),
                    model=GridnetPolicy(
                        ActionSpace(ecfg.num_types, 2 * ecfg.max_range + 1),
                        20 + ecfg.num_types, width=width, blocks=blocks,
                        dtype=tdt), tx=ttx)
    tr.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jts.params)))
    ts = tr.init(seed=None)
    ts = dataclasses.replace(
        ts, env_states=state_from_numpy(leaves(jts.env_states)),
        env_steps=torch.from_numpy(np.array(jts.env_steps)))
    return jtr, jts, tr, ts


_jit_sample = jax.jit(JP.sample_action, static_argnums=3)


def run_update(jtr, jts, tr, ts):
    """One update in each package from the same start: JAX's ``update``
    unjitted with its scans as Python loops, the port's with the noise
    JAX's key tree draws.  Returns (JAX TrainState, JAX metrics, port
    TrainState, port metrics, the JAX trajectory, the port trajectory)."""
    n = tr.cfg.num_envs
    noise = jax_noise(jts, n, tr.cfg.rollout_len, tr.env.h, tr.env.w,
                      tr.space.sizes, False)
    jtrajs, ttrajs = [], []
    jroll, troll = jtr._rollout, tr._rollout

    def jrec(*a):
        out = jroll(*a)
        jtrajs.append(out[1])
        return out

    def trec(*a, **k):
        out = troll(*a, **k)
        ttrajs.append(out[1])
        return out

    jtr._rollout, tr._rollout = jrec, trec
    jscan, jsample = jax.lax.scan, JPPO.sample_action
    jax.lax.scan = _py_scan
    JPPO.sample_action = _jit_sample
    try:
        jts2, jm = jtr.update(jts, jnp.arange(n, dtype=jnp.uint32))
        ts2, tm = tr.update(ts, noise=lambda t: noise[t])
    finally:
        jax.lax.scan, JPPO.sample_action = jscan, jsample
        jtr._rollout, tr._rollout = jroll, troll
    return jts2, jm, ts2, tm, jtrajs[0], ttrajs[0]


def flax_params(tr):
    """The port model's parameters as a flax tree of numpy arrays."""
    from microrts_tpu_torch.models.gridnet_policy import params_to_flax
    return params_to_flax(tr.model.state_dict())
