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


def _py_scan(f, init, xs, length=None, **_):
    """``lax.scan`` as a Python loop (eager body)."""
    carry, ys = init, []
    for i in range(length):
        carry, y = f(carry, None if xs is None else
                     jax.tree.map(lambda x: x[i], xs))
        ys.append(y)
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
    assert_eq(jt.mask, t.mask[..., 1:] != 0, "mask")
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
