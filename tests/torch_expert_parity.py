"""Helpers of the expert-interface parity tests: the JAX package's
``ExpertEnv`` pieces jitted (vmapped over envs, the player and the macro
traced: one compile a board size), the draws its ``macro_to_gridnet``
makes from a key handed to the port as an ``ExpertNoise``, and JAX's own
``step``/``step_vs`` run eagerly around jitted parts."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import scripted as JS
from microrts_tpu.env import expert as JE
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.env.expert import ExpertNoise, ExpertRoles

from torch_parity import assert_eq, assert_state_eq, envs, jax_fns, jax_state


@functools.lru_cache(maxsize=None)
def expert_envs(map_rel):
    """(JAX ExpertEnv, port ExpertEnv on the CPU, jitted JAX functions)."""
    from microrts_tpu_torch.env.expert import ExpertEnv
    jenv, env = envs(map_rel)
    jex = JE.ExpertEnv(jenv)
    H, W = env.h, env.w
    v = jax.vmap

    def noise(key):
        k_alloc, k_quad, _ = jax.random.split(key, 3)
        return (jax.random.uniform(k_alloc, (H, W)),
                jax.random.randint(k_quad, (), 0, max(W // 2, 1)),
                jax.random.randint(jax.random.fold_in(k_quad, 1), (), 0,
                                   max(H // 2, 1)))

    fns = dict(
        macro=jax.jit(v(jex.macro_to_gridnet, in_axes=(0, 0, None, 0, 0))),
        mask=jax.jit(v(jex.action_mask, in_axes=(0, None, None))),
        noise=jax.jit(v(noise)),
        split=jax.jit(v(jax.random.split)))
    return jex, ExpertEnv(env), fns


def jax_roles(r: ExpertRoles):
    return JE.ExpertRoles(*[jnp.asarray(getattr(r, f).numpy())
                            for f in ExpertRoles.FIELDS])


def port_roles(jr) -> ExpertRoles:
    return ExpertRoles(*[torch.from_numpy(np.array(getattr(jr, f)))
                         for f in ExpertRoles.FIELDS])


def port_noise(fns, keys) -> ExpertNoise:
    r, rx, ry = fns["noise"](keys)
    return ExpertNoise(torch.from_numpy(np.array(r)),
                       torch.from_numpy(np.array(rx)).int(),
                       torch.from_numpy(np.array(ry)).int())


def random_roles(rng, B, H, W) -> ExpertRoles:
    """Role tables with every kind of entry: half the uids harvesters,
    half with a target on the board."""
    T = JE.TABLE
    return ExpertRoles(
        torch.from_numpy(rng.random((B, T)) < 0.5),
        torch.from_numpy(rng.random((B, T)) < 0.5),
        torch.from_numpy(rng.integers(0, W, (B, T)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, H, (B, T)).astype(np.int32)))


@functools.lru_cache(maxsize=None)
def patched_jax_expert(map_rel):
    """A JAX ExpertEnv whose own ``step``/``step_vs`` run eagerly under
    ``vmap`` around jitted parts: its env's (``torch_parity.JaxFns.patch``)
    and its ``macro_to_gridnet``."""
    jenv, _ = envs(map_rel)
    jax_fns(jenv).patch(jenv)
    jex = JE.ExpertEnv(jenv)
    jex.macro_to_gridnet = jax.jit(jex.macro_to_gridnet)
    return jex


MAP = "maps/8x8/basesWorkers8x8.xml"
B = 8
TICKS = 100


def _legal_macros(rng, mask):
    m = mask.numpy()
    return np.array([rng.choice(np.flatnonzero(row)) for row in m],
                    np.int32)


def _roles_eq(jr, r, where):
    for f in ExpertRoles.FIELDS:
        assert_eq(getattr(jr, f), getattr(r, f), f"{where} roles.{f}")


def expert_game(mode):
    """``mode`` "step_vs" or "step" of the port's plain path against
    JAX's for TICKS ticks of B envs, everything compared every tick."""
    _, ex, fns = expert_envs(MAP)
    jex = patched_jax_expert(MAP)
    env = ex.env
    jrush_one = jax.jit(JS.worker_rush(jex.env))
    rush = make_bot("WorkerRush", env)
    if mode == "step":
        jstep = jax.vmap(jex.step)
    else:
        jstep = jax.vmap(lambda s, r, m, k: jex.step_vs(s, r, m, jrush_one,
                                                        k))
    rng = np.random.default_rng(len(mode))
    key = jax.random.PRNGKey(len(mode))
    s = env.reset(B)
    js = jax_state(s)
    roles = [ExpertRoles.init(B, "cpu") for _ in (0, 1)]
    jroles = [jax_roles(r) for r in roles]
    acted = trained = 0
    for t in range(TICKS):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, B)
        ks = fns["split"](keys)             # JAX's k0, k1 of each env
        macros = [_legal_macros(rng, ex.action_mask(s, roles[p], p))
                  for p in (0, 1)]
        if mode == "step":
            js, jroles[0], jroles[1], jr, jd = jstep(
                js, jroles[0], jroles[1], macros[0], macros[1], keys)
            s, roles[0], roles[1], r, d = ex.step(
                s, roles[0], roles[1], torch.from_numpy(macros[0]),
                torch.from_numpy(macros[1]), port_noise(fns, ks[:, 0]),
                port_noise(fns, ks[:, 1]))
        else:
            js, jroles[0], jr, jd = jstep(js, jroles[0], macros[0], keys)
            s, roles[0], r, d = ex.step_vs(s, roles[0],
                                           torch.from_numpy(macros[0]),
                                           rush, port_noise(fns, ks[:, 0]))
        assert_state_eq(js, s, f"t{t}")
        _roles_eq(jroles[0], roles[0], f"t{t} p0")
        if mode == "step":
            _roles_eq(jroles[1], roles[1], f"t{t} p1")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-6)
        assert_eq(jd, d, f"t{t} done")
        acted += int((s.busy & (s.owner == 0)).sum())
        trained += int(((s.atype == 4) & s.busy & (s.owner == 0)).sum())
    assert acted > 0 and trained > 0
    assert roles[0].harvester.any() and roles[0].has_target.any()
