"""The port's map pool (``env/pool.py``: ``pad_pgs``, ``MapPoolVecEnv``;
plain path on the CPU) against the JAX package's: the padded maps, and
pools of basesWorkers8x8, NoWhereToRun9x8 and FourBasesWorkers8x8 (the
pool of tests/test_pool_es_socket.py) stepped side by side with the same
RandomBiasedAI actions, under full and partial observation, across
resets to each env's own map.  Tolerance: exact.
"""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.engine.pgs import PhysicalGameState as JPGS
from microrts_tpu.engine.utt import UnitTypeTable as JUTT
from microrts_tpu.env.pool import MapPoolVecEnv as JaxPool
from microrts_tpu.env.pool import pad_pgs as jax_pad_pgs
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.pgs import PhysicalGameState
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.env.pool import MapPoolVecEnv, pad_pgs
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import (BIAS, assert_eq, assert_state_eq, draw,
                          torch_one_thread)  # noqa: F401
from torch_po_parity import JaxPOFns

MAPS = ("maps/8x8/basesWorkers8x8.xml", "maps/NoWhereToRun9x8.xml",
        "maps/8x8/FourBasesWorkers8x8.xml")
N = 6


def test_pad_pgs_matches_jax():
    for rel in MAPS + ("maps/16x16/TwoBasesBarracks16x16.xml",):
        a = pad_pgs(PhysicalGameState.load(asset_path(rel),
                                           UnitTypeTable(2)), 16, 17)
        b = jax_pad_pgs(JPGS.load(jax_asset_path(rel), JUTT(2)), 16, 17)
        assert (a.height, a.width) == (b.height, b.width) == (16, 17)
        assert np.array_equal(np.asarray(a.terrain), np.asarray(b.terrain))
        assert [vars(u) for u in a.units] == [vars(u) for u in b.units]
        assert [vars(p) for p in a.players] == [vars(p) for p in b.players]
    with pytest.raises(ValueError):
        pad_pgs(PhysicalGameState.load(asset_path(MAPS[1]),
                                       UnitTypeTable(2)), 8, 8)


@pytest.mark.parametrize("partial_obs", [False, True], ids=["full", "po"])
def test_map_pool_matches_jax(partial_obs, monkeypatch, torch_one_thread):
    jpool = JaxPool([jax_asset_path(m) for m in MAPS], N, max_steps=10,
                    partial_obs=partial_obs)
    pool = MapPoolVecEnv([asset_path(m) for m in MAPS], N, max_steps=10,
                         partial_obs=partial_obs, device="cpu")
    assert (pool.h, pool.w) == (jpool.h, jpool.w) == (8, 9)
    fns = JaxPOFns(jpool.env)
    if partial_obs:
        fns.patch(jpool.env, monkeypatch)
    else:
        fns.fns.patch(jpool.env)
    key = jax.random.PRNGKey(2)
    key, k = jax.random.split(key)
    js, jsteps = jpool.reset(k)
    s, steps = pool.reset()
    assert_state_eq(js, s, "reset")
    bot = random_bot(pool.env, BIAS)
    resets = 0
    for t in range(24):
        key, k0, k1 = jax.random.split(key, 3)
        (ks0, u0), (ks1, u1) = draw(fns.fns, k0, N), draw(fns.fns, k1, N)
        a0, a1 = fns.fns.bot(js, 0, ks0), fns.fns.bot(js, 1, ks1)
        ta0 = bot(s, 0, torch.from_numpy(u0))
        ta1 = bot(s, 1, torch.from_numpy(u1))
        assert_eq(a0, ta0, f"t{t} actions p0")
        assert_eq(a1, ta1, f"t{t} actions p1")
        js, jsteps, jobs, jrew, jdn, jrm = jpool.step(js, jsteps, a0, a1)
        s, steps, obs, rew, dn, rm = pool.step(s, steps, ta0, ta1)
        assert_state_eq(js, s, f"t{t}")
        for name, a, b in (("steps", jsteps, steps), ("obs", jobs, obs),
                           ("rewards", jrew, rew), ("dones", jdn, dn),
                           ("reset_mask", jrm, rm)):
            assert_eq(a, b, f"t{t} {name}")
        resets += int(rm.sum())
        # a reset env is back on its own map
        for i in rm.nonzero().flatten().tolist():
            m = i % len(MAPS)
            assert torch.equal(s.utype[i], pool.bank.utype[m])
            assert torch.equal(s.terrain[i], pool.bank.terrain[m])
    assert resets >= N
    assert obs.shape[2] == (8 if partial_obs else 6)
    # padding: the env of the 8x8 map has a wall column at x = 8
    assert (s.terrain[0][:, 8] == 1).all()
