"""The port's per-env failure detector (``env.vec.env_health``, plain path
on the CPU) and ``VecGridnetEnv(quarantine=True)`` vs the JAX package.

``env_health`` on the corruption cases of ``tests/test_quarantine.py``
(hp -3, a type past the UTT, a negative stockpile, NaN rewards) and the
rest of its rules (hp above the UTT's largest, negative ticks on a busy
cell, a stockpile above 10^6, an infinite reward), one per lane.  The
quarantined vec step side by side with JAX's on basesWorkers8x8 with
faults planted in some lanes mid-run: every output equal at every step
(states, steps, observations, rewards, dones, reset mask), the faulty
lanes reset and the healthy ones running on.  Tolerance: exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.env.vec import VecGridnetEnv as JaxVec
from microrts_tpu.env.vec import env_health as jax_env_health
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.env.vec import VecGridnetEnv, env_health

from torch_parity import (BIAS, assert_eq, assert_state_eq, draw, envs,
                          jax_fns, jax_state, port_trajectory)

MAP = "maps/8x8/basesWorkers8x8.xml"


def corrupt(s, lane, kind, cfg):
    """Plant fault ``kind`` in ``lane`` of the port State ``s`` (in place
    on a clone)."""
    s = s.clone()
    occ = (s.utype[lane] > 0).nonzero()[0]   # on these maps a resource
    if kind == "hp_low":
        s.hp[lane, occ[0], occ[1]] = -3
    elif kind == "hp_high":
        s.hp[lane, occ[0], occ[1]] = max(cfg.hp) + 1
    elif kind == "type":
        s.utype[lane, 0, 0] = cfg.num_types + 5
    elif kind == "ticks":
        s.busy[lane, occ[0], occ[1]] = True
        s.aticks[lane, occ[0], occ[1]] = -2
    elif kind == "res_low":
        s.resources[lane, 0] = -1
    elif kind == "res_high":
        s.resources[lane, 1] = 1_000_001
    return s


def test_env_health_matches_jax():
    jenv, env = envs(MAP)
    cfg = env.cfg.engine
    kinds = ["none", "hp_low", "hp_high", "type", "ticks", "res_low",
             "res_high", "none", "none"]
    B = len(kinds)
    s = port_trajectory(env, B, 13, seed=2, keep={12})[12]
    for b, k in enumerate(kinds):
        s = corrupt(s, b, k, cfg)
    rew = torch.zeros((B, 2 * 8))
    rew[7, 3] = float("nan")
    rew[8, 11] = float("inf")
    want = torch.tensor([k != "none" for k in kinds])
    want[7:] = True
    got = env_health(s, rew, cfg)
    assert torch.equal(got, want)
    jgot = jax.vmap(jax_env_health, in_axes=(0, 0, None))(
        jax_state(s), jnp.asarray(rew.numpy()), jenv.cfg.engine)
    assert_eq(jgot, got, "env_health")
    healthy = env.reset(2)
    assert not env_health(healthy, torch.zeros((2, 8)), cfg).any()


def test_vec_quarantine_matches_jax():
    jenv, env = envs(MAP)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    cfg = env.cfg.engine
    B = 5
    jvec = JaxVec(jenv, B, max_steps=200, quarantine=True)
    vec = VecGridnetEnv(env, B, max_steps=200, quarantine=True)
    key = jax.random.PRNGKey(4)
    key, k = jax.random.split(key)
    js, jsteps = jvec.reset(k)
    s, steps = vec.reset()
    bot = random_bot(env, BIAS)
    # faults the cycle does not clear (a resource node's hp: nodes never
    # die of damage; a unit at hp <= 0 dies, and a busy cell's action
    # completes, in the step's own cycle)
    plant = {3: (2, "hp_low"), 5: (0, "type"), 6: (4, "res_low"),
             8: (1, "res_high")}
    resets = []
    for t in range(12):
        if t in plant:
            lane, kind = plant[t]
            s = corrupt(s, lane, kind, cfg)
            js = js.replace(**{f: jnp.asarray(getattr(s, f).numpy())
                               for f in ("utype", "hp", "busy", "aticks",
                                         "resources")})
        key, k0, k1 = jax.random.split(key, 3)
        (ks0, u0), (ks1, u1) = draw(fns, k0, B), draw(fns, k1, B)
        a0, a1 = fns.bot(js, 0, ks0), fns.bot(js, 1, ks1)
        js, jsteps, jobs, jrew, jdn, jrm = jvec.step(js, jsteps, a0, a1)
        s, steps, obs, rew, dn, rm = vec.step(
            s, steps, bot(s, 0, torch.from_numpy(u0)),
            bot(s, 1, torch.from_numpy(u1)))
        assert_state_eq(js, s, f"t{t}")
        for name, a, b in (("steps", jsteps, steps), ("obs", jobs, obs),
                           ("rewards", jrew, rew), ("dones", jdn, dn),
                           ("reset_mask", jrm, rm)):
            assert_eq(a, b, f"t{t} {name}")
        resets.append(rm.clone())
        if t in plant:
            lane = plant[t][0]
            assert rm[lane] and int(steps[lane]) == 0
            assert rm.sum() == 1, "healthy lanes run on"
            assert not env_health(s, torch.zeros((B, 1)), cfg).any()
    assert int(torch.stack(resets).sum()) == len(plant)


def test_vec_quarantine_resets_failed_lane():
    """tests/test_quarantine.py's case on the port: a lane corrupted
    mid-flight resets, its rewards stay finite, the others run on."""
    env = envs(MAP)[1]
    vec = VecGridnetEnv(env, num_envs=4, quarantine=True)
    states, steps = vec.reset()
    states = corrupt(states, 2, "hp_low", env.cfg.engine)
    zero = torch.zeros((4, env.h, env.w, 7), dtype=torch.int32)
    states2, steps2, obs, rew, dones, reset_mask = vec.step(
        states, steps, zero, zero)
    assert reset_mask.tolist() == [False, False, True, False]
    assert torch.isfinite(rew).all()
    assert int(steps2[2]) == 0 and int(steps2[0]) == 1
    assert not env_health(states2, torch.zeros((4, 8)),
                          env.cfg.engine).any()
    plain = VecGridnetEnv(env, num_envs=4)
    assert not plain.step(states, steps, zero, zero)[5].any()
