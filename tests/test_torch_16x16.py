"""The port at 16x16 (basesWorkers16x16, the main path's map) against the
JAX package: the engine functions on states recorded from one short
random-bot trajectory and decode with garbage actions.  (The short 16x16
``VecGridnetEnv`` run is in test_torch_engine.py, which has the room;
long trajectories run on 8x8.)  Tolerance: exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from microrts_tpu_torch.bots.scripted import random_bot

from torch_parity import (BIAS, assert_cand_eq, check_cycle_gameover_winner,
                          check_legal_masks, check_validate_eta_issue_env,
                          envs, garbage, jax_fns, jax_state, port_trajectory)

MAP = "maps/16x16/basesWorkers16x16.xml"
B = 4


@pytest.fixture(scope="module")
def case():
    jenv, env = envs(MAP)
    traj = port_trajectory(env, B, 41, seed=16, keep={40})
    return jenv, env, jax_fns(jenv), [traj[40]]


def test_recorded_state_is_busy(case):
    assert int(case[3][0].busy.sum()) > 0


def test_legal_masks(case):
    jenv, env, fns, states = case
    check_legal_masks(env, fns, states)


def test_validate_eta_issue_env(case):
    jenv, env, fns, states = case
    check_validate_eta_issue_env(env, fns, states, seed=16)


def test_cycle_gameover_winner(case):
    jenv, env, fns, states = case
    check_cycle_gameover_winner(env, fns, states)


def test_decode_garbage(case):
    jenv, env, fns, states = case
    rng = np.random.default_rng(16)
    s = states[0]
    for p in (0, 1):
        u = torch.from_numpy(rng.random((B, env.h, env.w, 2), dtype=np.float32))
        base = random_bot(env, BIAS)(s, p, u).numpy()
        a = garbage(rng, env.action_nvec(), (B, env.h, env.w), 0.5, base)
        jc, _, _ = fns.decode(jax_state(s), jnp.asarray(a), p)
        assert_cand_eq(jc, env.decode(s, torch.from_numpy(a), p), f"p{p}")

