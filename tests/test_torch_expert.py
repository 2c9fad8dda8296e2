"""The expert macro interface (``env/expert.py``): the port's plain
``action_mask`` and ``macro_to_gridnet`` against the JAX package's on
WorkerRush-vs-LightRush records of basesWorkers8x8, every macro 0-12
and both players, with random role tables and JAX's own draws (its
``k_alloc`` uniforms and ``k_quad`` randints, handed over as an
``ExpertNoise``); the quadrant one-hot's duplicate-index slot 0 with a
planted attacker of uid 1024.  Tolerance: exact (actions and the four
role tables)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu_torch.env.expert import NUM_MACROS, ExpertRoles

from torch_expert_parity import (expert_envs, jax_roles, port_noise,
                                 random_roles)
from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa
from torch_rush_parity import MAPS, recorded_states

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = MAPS[0]


def _check(s, roles, player, macro, key):
    jex, ex, fns = expert_envs(MAP)
    B = s.batch
    keys = jax.random.split(key, B)
    js = jax_state(s)
    macros = np.broadcast_to(np.asarray(macro, np.int32), (B,)).copy()
    ja, jr = fns["macro"](js, jax_roles(roles), player, jnp.asarray(macros),
                          keys)
    a, r = ex.macro_to_gridnet(s, roles, player, torch.from_numpy(macros),
                               port_noise(fns, keys))
    assert_eq(ja, a, f"macro {macro} p{player} actions")
    for f in ExpertRoles.FIELDS:
        assert_eq(getattr(jr, f), getattr(r, f), f"macro {macro} p{player} "
                  f"roles.{f}")
    return a, r


def test_action_mask_matches_jax():
    env, _, s = recorded_states()
    jex, ex, fns = expert_envs(MAP)
    roles = ExpertRoles.init(s.batch, "cpu")
    for p in (0, 1):
        m = ex.action_mask(s, roles, p)
        assert_eq(fns["mask"](jax_state(s), jax_roles(roles), p), m,
                  f"action_mask p{p}")
        assert m.any(0).sum() >= 9


@pytest.mark.parametrize("macro", range(NUM_MACROS))
def test_macro_matches_jax(macro):
    env, _, s = recorded_states()
    rng = np.random.default_rng(macro)
    roles = random_roles(rng, s.batch, env.h, env.w)
    acted = 0
    for p in (0, 1):
        a, r = _check(s, roles, p, macro, jax.random.PRNGKey(100 + macro))
        acted += int((a[..., 0] > 0).sum())
    assert acted > 0


@pytest.mark.parametrize("last", [False, True])
def test_quad_onehot_slot0_matches_jax(last):
    """An attacker of uid 1024 scatters to slot 0 with every non-attacker
    cell: slot 0 is the last row-major writer's flag (XLA's CPU scatter).
    With ``last``, the env's last cell holds a second attacker of uid
    2048, so slot 0 ends True; else a planted uid-1024 attacker earlier
    in the board ends False."""
    env, _, s = recorded_states()
    s = s.clone()
    B = 8
    from microrts_tpu_torch.engine.types import State
    s = State(**{f: getattr(s, f)[:B].clone() for f in vars(s)})
    light = env.cfg.light_id + 1
    for b in range(B):
        for (y, x), uid in (((3, 3), 1024),) + ((((7, 7), 2048),) if last
                                                 else ()):
            s.utype[b, y, x] = light
            s.owner[b, y, x] = b % 2
            s.hp[b, y, x] = 4
            s.uid[b, y, x] = uid
            s.busy[b, y, x] = False
            s.carried[b, y, x] = 0
    roles = ExpertRoles.init(B, "cpu")
    for p in (0, 1):
        _, r = _check(s, roles, p, 4, jax.random.PRNGKey(7))
        want = np.arange(B) % 2 == p
        if last:
            assert (r.has_target[:, 0].numpy() == want).all()
        else:
            assert not r.has_target[:, 0].any()
