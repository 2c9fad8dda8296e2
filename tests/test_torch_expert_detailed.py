"""The expert interface's detailed mode (``detailed_to_gridnet``): the
port's plain path against the JAX package's.  JAX's
``test_expert_detailed_mode`` setup (basesWorkers8x8, tile logits 4 on
the south-east corner, type logits 3 on Worker, player 0 detailed
against PassiveAI) for 8 envs and 60 ticks with JAX's own Gumbel noise
handed over (``gumbel(k_tile)``, ``gumbel(k_type)``), every state plane
bit-equal; then both players on random-play states of 8x8 and 16x16 with seeded per-env logits.  Tolerance: exact
(the argmaxes read the same float32 sums)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.env import expert as JE
from microrts_tpu_torch.env.expert import (DetailedNoise, ExpertEnv,
                                           detailed_to_gridnet)

from torch_parity import (assert_eq, assert_state_eq, envs, jax_fns,
                          jax_state, port_trajectory,
                          torch_one_thread)  # noqa: F401

MAPS = ("maps/8x8/basesWorkers8x8.xml",)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

_FNS = {}


def _fns(map_rel):
    if map_rel not in _FNS:
        jenv, env = envs(map_rel)
        jex = JE.ExpertEnv(jenv)
        H, W, T = env.h, env.w, env.cfg.engine.num_types

        def gumbels(key):
            k_tile, k_type, _ = jax.random.split(key, 3)
            return (jax.random.gumbel(k_tile, (H, W, H * W)),
                    jax.random.gumbel(k_type, (H, W, T)))

        det = jax.jit(jax.vmap(
            lambda s, p, tl, ml, k: JE.detailed_to_gridnet(jex, s, p, tl, ml,
                                                           k),
            in_axes=(0, None, 0, 0, 0)))
        _FNS[map_rel] = (jenv, ExpertEnv(env), jax.jit(jax.vmap(gumbels)),
                         det)
    return _FNS[map_rel]


def _noise(gumbels, keys):
    gt, gy = gumbels(keys)
    return DetailedNoise(torch.from_numpy(np.array(gt)),
                         torch.from_numpy(np.array(gy)))


def _check(map_rel, s, seed):
    jenv, ex, gumbels, det = _fns(map_rel)
    B, H, W = s.utype.shape
    T = ex.cfg.engine.num_types
    rng = np.random.default_rng(seed)
    tl = rng.normal(size=(B, T)).astype(np.float32) * 2
    ml = rng.normal(size=(B, H, W)).astype(np.float32) * 2
    acted = 0
    for p in (0, 1):
        keys = jax.random.split(jax.random.PRNGKey(seed + p), B)
        ja = det(jax_state(s), p, tl, ml, keys)
        a = detailed_to_gridnet(ex, s, p, torch.from_numpy(tl),
                                torch.from_numpy(ml), _noise(gumbels, keys))
        assert_eq(ja, a, f"detailed p{p}")
        acted += int((a[..., 0] > 0).sum())
    return acted


def test_detailed_mode_game_matches_jax():
    map_rel = MAPS[0]
    jenv, ex, gumbels, det = _fns(map_rel)
    jax_fns(jenv).patch(jenv)
    env = ex.env
    B, T = 8, env.cfg.engine.num_types
    tile = np.zeros((B, 8, 8), np.float32)
    tile[:, 6:, 5:] = 4.0
    typ = np.zeros((B, T), np.float32)
    typ[:, env.cfg.worker_id] = 3.0
    jstep = jax.vmap(jenv.step)
    s = env.reset(B)
    js = jax_state(s)
    key = jax.random.PRNGKey(6)
    zeros = torch.zeros((B, 8, 8, 7), dtype=torch.int32)
    kinds = set()
    for t in range(60):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, B)
        ja = det(js, 0, typ, tile, keys)
        a = detailed_to_gridnet(ex, s, 0, torch.from_numpy(typ),
                                torch.from_numpy(tile), _noise(gumbels, keys))
        assert_eq(ja, a, f"t{t} actions")
        kinds |= set(a[..., 0].unique().tolist())
        js, jr, jd = jstep(js, ja, jnp.zeros((B, 8, 8, 7), jnp.int32))
        s, r, d = env.step(s, a, zeros)
        assert_state_eq(js, s, f"t{t}")
        assert_eq(jd, d, f"t{t} done")
    assert {1, 4} <= kinds               # moves and produces


def test_detailed_mode_on_random_play_matches_jax():
    _, ex, _, _ = _fns(MAPS[0])
    for t, s in port_trajectory(ex.env, 8, 61, 3, {30, 60}).items():
        assert _check(MAPS[0], s, 11 + t) > 0


def test_detailed_mode_on_16x16_matches_jax():
    map_rel = "maps/16x16/basesWorkers16x16.xml"
    _, ex, _, _ = _fns(map_rel)
    s = port_trajectory(ex.env, 4, 41, 5, {40})[40]
    assert _check(map_rel, s, 21) > 0
