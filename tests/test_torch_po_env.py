"""The port's partially observable env (``GridnetEnv(partial_obs=True)``,
``VecGridnetEnv``; plain path on the CPU) against the JAX package's PO
env (its own ``step`` code, eager under ``vmap`` around jitted parts).

Covers 64 ticks of RandomBiasedAI self-play at 8 envs with auto-resets
(states bit-equal; 8-plane observations, the one-hot of each player's
view, rewards, dones and reset masks equal, as test_torch_port.py holds
slice 1), and pins three behaviours of the JAX package that the port
reproduces: the PO step ignores ``frame_skip``, masks read the full
state, and ``step_vs`` has no PO branch.  Tolerance: exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.env.vec import VecGridnetEnv as JaxVec
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine import fog
from microrts_tpu_torch.env.vec import VecGridnetEnv

from torch_parity import (BIAS, assert_eq, assert_state_eq, draw, envs,
                          jax_state, port_trajectory,
                          torch_one_thread)  # noqa: F401
from torch_po_parity import JaxPOFns

MAP = "maps/8x8/basesWorkers8x8.xml"
B = 8


def test_po_vec_env_matches_jax(monkeypatch, torch_one_thread):
    jenv, env = envs(MAP, partial_obs=True)
    fns = JaxPOFns(jenv)
    fns.patch(jenv, monkeypatch)
    jvec = JaxVec(jenv, B, max_steps=24)
    vec = VecGridnetEnv(env, B, max_steps=24)
    key = jax.random.PRNGKey(11)
    key, k = jax.random.split(key)
    js, jsteps = jvec.reset(k)
    s, steps = vec.reset()
    bot = random_bot(env, BIAS)
    resets = hidden = 0
    for t in range(64):
        key, k0, k1 = jax.random.split(key, 3)
        (ks0, u0), (ks1, u1) = draw(fns.fns, k0, B), draw(fns.fns, k1, B)
        a0, a1 = fns.fns.bot(js, 0, ks0), fns.fns.bot(js, 1, ks1)
        ta0 = bot(s, 0, torch.from_numpy(u0))
        ta1 = bot(s, 1, torch.from_numpy(u1))
        assert_eq(a0, ta0, f"t{t} actions p0")
        assert_eq(a1, ta1, f"t{t} actions p1")
        if t % 16 == 0:   # masks: the full state's, under fog too
            assert_eq(fns.masks(js), vec.masks(s), f"t{t} masks")
        js, jsteps, jobs, jrew, jdn, jrm = jvec.step(js, jsteps, a0, a1)
        s, steps, obs, rew, dn, rm, oh = vec.step(s, steps, ta0, ta1,
                                                  onehot=(0, 1))
        assert_state_eq(js, s, f"t{t}")
        assert obs.shape == (2, B, 8, env.h, env.w)
        for name, a, b in (("steps", jsteps, steps), ("obs", jobs, obs),
                           ("rewards", jrew, rew), ("dones", jdn, dn),
                           ("reset_mask", jrm, rm)):
            assert_eq(a, b, f"t{t} {name}")
        for p in (0, 1):
            assert_eq(fns.onehot(js, p), oh[p], f"t{t} one-hot p{p}")
        resets += int(rm.sum())
        enemy = (s.utype > 0) & (s.owner == 1)
        hidden += int((enemy & ~fog.visibility(s, 0, env.cfg.engine)).sum())
    assert resets > 0 and hidden > 0, (resets, hidden)


def test_po_step_ignores_frame_skip_and_onehot_reads_view(monkeypatch,
                                                         torch_one_thread):
    """JAX's PO branch returns before its frame-skip loop
    (gridnet.py:378, :393): a PO env with ``frame_skip=3`` steps one tick,
    as JAX's does.  ``observation_onehot`` is built from the view (it
    differs from the full state's where enemies are hidden)."""
    jenv, env = envs(MAP, partial_obs=True, frame_skip=3)
    _, env1 = envs(MAP, partial_obs=True)
    _, full = envs(MAP)
    fns = JaxPOFns(jenv)
    fns.patch(jenv, monkeypatch)
    states = port_trajectory(env1, B, 41, seed=4, keep={20, 40})
    rng = np.random.default_rng(0)
    bot = random_bot(env, BIAS)
    differ = 0
    for s in states.values():
        u = [torch.from_numpy(rng.random((B, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0, a1 = bot(s, 0, u[0]), bot(s, 1, u[1])
        n3, r3, d3 = env.step(s, a0, a1)
        n1, r1, d1 = env1.step(s, a0, a1)
        assert n3.equal(n1) == (True, "")
        assert torch.equal(r3, r1) and torch.equal(d3, d1)
        assert torch.equal(n3.time, s.time + 1)
        js = jax_state(s)
        jn, jr, jd = jax.vmap(jenv.step)(js, jnp.asarray(a0.numpy()),
                                         jnp.asarray(a1.numpy()))
        assert_state_eq(jn, n3, "frame_skip 3")
        assert_eq(jr, r3, "rewards")
        for p in (0, 1):
            oh = env.observation_onehot(s, p)
            assert_eq(fns.onehot(js, p), oh, f"one-hot p{p}")
            differ += int(not torch.equal(oh, full.observation_onehot(s, p)))
    assert differ > 0


def test_step_vs_has_no_po_branch(torch_one_thread):
    """``step_vs`` of a PO env is the full-observation ``step_vs``
    (gridnet.py:400-418 has no PO branch): decode against full claims,
    ``issue_env``."""
    _, env = envs(MAP, partial_obs=True)
    _, full = envs(MAP)
    states = port_trajectory(full, B, 31, seed=5, keep={10, 30})
    rng = np.random.default_rng(1)
    bot = random_bot(env, BIAS)
    for s in states.values():
        u = [torch.from_numpy(rng.random((B, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0 = bot(s, 0, u[0])

        def opp(st, p):
            return bot(st, p, u[1])
        n, r, d = env.step_vs(s, a0, opp)
        fn, fr, fd = full.step_vs(s, a0, opp)
        assert n.equal(fn) == (True, "")
        assert torch.equal(r, fr) and torch.equal(d, fd)
