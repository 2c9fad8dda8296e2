"""BS3_NaiveMCTS's believe-state memory (``bots/believestate.py``, level
3: inference and relocation; plain path on the CPU) against the JAX
package's at every tick of the recorded games of
tests/torch_believe_parity.py, the three levels on the second map
(basesWorkersBarracks8x8, whose start hides the enemy's barracks too),
and JAX's three believe-state scenarios (tests/test_po_search.py:31-110)
through both packages.  Tolerance: exact.
"""

import functools

import numpy as np
import pytest

from microrts_tpu_torch.engine import fog

from torch_believe_parity import (BARRACKS_MAP, assert_mem_eq, check_level,
                                  identity_bot, jax_bot, trajectory)
from torch_parity import assert_state_eq, jax_state, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_bs3_memory_matches_jax_at_every_tick():
    check_level(3)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_believe_memory_matches_jax_on_the_barracks_map(level):
    check_level(level, BARRACKS_MAP)


def _both(jm, m, y, x, t, hp, uid):
    jm = jm._replace(b_utype=jm.b_utype.at[0, y, x].set(t),
                     b_hp=jm.b_hp.at[0, y, x].set(hp),
                     b_uid=jm.b_uid.at[0, y, x].set(uid))
    for f, v in (("b_utype", t), ("b_hp", hp), ("b_uid", uid)):
        getattr(m, f)[0, y, x] = v
    return jm, m


@functools.lru_cache(maxsize=None)
def _reset():
    """(the envs, the reset state in as many lanes as the recorded games,
    player 0's visibility there); only lane 0 is changed."""
    jenv, env, states = trajectory()
    s = env.reset(states[0].batch)
    return jenv, env, s, fog.visibility(s, 0, env.cfg.engine)[0].numpy()


def test_believe_init_remembers_hidden_units():
    jenv, env, s, vis = _reset()
    jinit, _ = jax_bot(jenv, 3, 0)
    m = identity_bot(3, env).init(s, 0)
    jm = jinit(jax_state(s))
    assert_mem_eq(jm, m, "init")
    hidden = ((s.utype[0] > 0) & (s.owner[0] == 1)).numpy() & ~vis
    assert hidden.any()
    np.testing.assert_array_equal(m.b_utype[0].numpy() > 0, hidden)
    view = fog.po_state(s, 0, env.cfg.engine)
    assert not ((view.utype > 0) & (view.owner == 1)).any()


def test_believe_relocates_wrong_guess_into_fog():
    jenv, env, s, vis = _reset()
    jinit, jstep = jax_bot(jenv, 3, 0)
    bot = identity_bot(3, env)
    y, x = np.argwhere(vis & (s.utype[0].numpy() == 0))[0]
    jm, m = _both(jinit(jax_state(s)), bot.init(s, 0), y, x, 2, 1, 777)
    jworld, jm = jstep(jax_state(s), jm)
    m, world = bot.update(s, m, 0)
    assert_mem_eq(jm, m, "relocation")
    assert_state_eq(jworld, world, "relocation: world")
    assert m.b_utype[0, y, x] == 0
    where = (m.b_uid[0] == 777).nonzero()
    assert len(where) == 1 and not vis[tuple(where[0].tolist())]


def test_believe_forgets_reappeared_uid():
    jenv, env, s, vis = _reset()
    jinit, jstep = jax_bot(jenv, 3, 0)
    bot = identity_bot(3, env)
    ey, ex = np.argwhere((s.utype[0] > 0).numpy()
                         & (s.owner[0] == 1).numpy())[0]
    real_uid = int(s.uid[0, ey, ex])
    gy, gx = np.argwhere(~vis & (s.utype[0].numpy() == 0))[0]
    jm, m = _both(jinit(jax_state(s)), bot.init(s, 0), gy, gx, 2, 1,
                  real_uid)
    vy, vx = np.argwhere(vis & (s.utype[0].numpy() == 0)
                         & (s.terrain[0].numpy() == 0))[0]
    s2 = s.clone()
    for f, a, b in (("utype", 0, 2), ("owner", -1, 1), ("hp", 0, 1),
                    ("uid", 0, real_uid)):
        getattr(s2, f)[0, ey, ex] = a
        getattr(s2, f)[0, vy, vx] = b
    jworld, jm = jstep(jax_state(s2), jm)
    m, world = bot.update(s2, m, 0)
    assert_mem_eq(jm, m, "forget by uid")
    assert_state_eq(jworld, world, "forget by uid: world")
    assert not (m.b_uid[0] == real_uid).any()


