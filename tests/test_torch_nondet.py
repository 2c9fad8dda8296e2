"""UTT v3's random damage in the port (plain path on the CPU).

Bit-parity against the JAX package with JAX's own draws fed in: ``cycle``
at every tick of random-bot runs on melee4x4light2 and basesWorkers8x8
(the uniforms of ``uniform(split(key)[1], (H, W))`` per env and cycle),
(``GridnetEnv.step``/``step_vs`` in ``test_torch_nondet_step.py``).
Tolerance: exact, every plane.
The loops that JAX draws inside its jitted code are held to the
distributional contract in ``test_torch_nondet_loops.py``.
"""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.types import ATTACK
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

from torch_nondet_parity import BW8, MELEE, cycle_u01, v3_envs, with_keys
from torch_parity import (BIAS, assert_eq, assert_state_eq, jax_fns,
                          torch_one_thread)  # noqa: F401

B = 6


def damage_above_min(env, s, u01):
    """Completing attacks of ``s`` whose drawn damage exceeds their type's
    minimum."""
    cfg = env.cfg.engine
    t = (s.utype.long() - 1).clamp(0, cfg.num_types - 1)
    lo = torch.tensor(cfg.min_damage)[t]
    hi = torch.tensor(cfg.max_damage)[t]
    comp = s.busy & (s.aticks <= 1) & (s.atype == ATTACK)
    dmg = torch.where(hi > lo, lo + (u01 * (hi - lo + 1)).to(torch.int32), lo)
    return int((comp & (dmg > lo)).sum())


@pytest.mark.parametrize("map_rel,ticks", [(MELEE, 120), (BW8, 160)],
                         ids=["melee4x4light2", "basesWorkers8x8"])
def test_cycle_matches_jax(map_rel, ticks, torch_one_thread):
    """Every cycle of a random-bot run (decode and issue on the port)
    against JAX's ``cycle`` on the same state and key: all planes and
    gameover bit-equal, some damage above the minimum."""
    jenv, env = v3_envs(map_rel)
    fns = jax_fns(jenv)
    rng = np.random.default_rng(len(map_rel))
    bot = random_bot(env, BIAS)
    eng = env.engine
    s = env.reset(B)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    above = 0
    for t in range(ticks):
        u = [torch.from_numpy(rng.random((B, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        c0 = env.decode(s, bot(s, 0, u[0]), 0)
        s1 = eng.issue_env(s, c0)
        s2 = eng.issue_env(s1, env.decode(s1, bot(s1, 1, u[1]), 1))
        nkeys, u01 = cycle_u01(keys, env.h, env.w)
        js, jd = fns.cycle(with_keys(s2, keys))
        s, done = eng.cycle(s2, u01=u01)
        assert_state_eq(js, s, f"tick {t}")
        assert_eq(jd, done, f"gameover tick {t}")
        assert np.array_equal(np.asarray(js.key), np.asarray(nkeys))
        above += damage_above_min(env, s2, u01)
        keys = nkeys
        if bool(done.all()):
            break
    assert t >= 100 or bool(done.all())
    assert above > 0


def test_u01_is_required_and_checked():
    env = GridnetEnv(asset_path(BW8), UnitTypeTable(3), device="cpu")
    s = env.reset(2)
    with pytest.raises(ValueError, match="needs u01"):
        env.engine.cycle(s)
    with pytest.raises(ValueError, match="u01 must be"):
        env.engine.cycle(s, u01=torch.rand(2, 4, 4))
    env2 = GridnetEnv(asset_path(BW8), device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        env2.engine.cycle(env2.reset(2), u01=torch.rand(2, 8, 8))
    gen = torch.Generator()
    assert env2.draw_u01(gen, 3, 2) is None and env2.draw_coins(gen, 2) is None
    assert env.draw_u01(gen, 3, 2).shape == (3, 2, 8, 8)
