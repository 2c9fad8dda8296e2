"""Port engine (``microrts_tpu_torch.engine``, plain path on the CPU) vs
the JAX engine on the same states and candidates, on 8x8 maps (the 16x16
function checks are in test_torch_16x16.py), plus the short 16x16
``VecGridnetEnv`` run with resets.

States come from short random-bot trajectories of the port; candidates are
garbage (every component drawn over its range), so illegal actions, the
select-dir quirk and out-of-box attack targets are all exercised.
Tolerance: exact, every plane.
"""

import dataclasses

import numpy as np
import pytest
import torch

from microrts_tpu.engine import types as JT
from microrts_tpu.engine.pgs import PhysicalGameState as JPgs
from microrts_tpu.engine.utt import UnitTypeTable as JUtt
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.engine import types as TT
from microrts_tpu_torch.engine.kernel import make_engine
from microrts_tpu_torch.engine.pgs import PhysicalGameState
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import (check_cycle_gameover_winner, check_legal_masks,
                          check_validate_eta_issue_env, envs, jax_fns, leaves,
                          port_trajectory, vec_trajectory)

CASES = [("maps/8x8/basesWorkersBarracks8x8.xml", 6, (0, 40)),
         ("maps/8x8/melee8x8Mixed6.xml", 6, (8, 24))]
MAPS = [c[0] for c in CASES] + ["maps/8x8/basesWorkers8x8.xml",
                                "maps/16x16/basesWorkers16x16.xml"]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0].split("/")[-1])
def case(request):
    """(jax env, port env, jax fns, [port State batch per recorded tick])."""
    map_rel, batch, ticks = request.param
    jenv, env = envs(map_rel)
    traj = port_trajectory(env, batch, max(ticks) + 1, seed=len(map_rel),
                           keep=set(ticks))
    return jenv, env, jax_fns(jenv), [traj[t] for t in ticks]


def test_legal_masks(case):
    jenv, env, fns, states = case
    check_legal_masks(env, fns, states)


def test_validate_eta_issue_env(case):
    jenv, env, fns, states = case
    check_validate_eta_issue_env(env, fns, states, seed=7)


def test_cycle_gameover_winner(case):
    jenv, env, fns, states = case
    check_cycle_gameover_winner(env, fns, states)


def test_vec_short_run_16x16():
    """The main path's map: VecGridnetEnv + random_bot for a few ticks with
    resets, every output against the JAX package."""
    assert vec_trajectory("maps/16x16/basesWorkers16x16.xml", batch=3,
                          ticks=8, max_steps=5) > 0


def test_recorded_states_are_busy(case):
    """The states above are not vacuous: units are mid-action."""
    _, _, _, states = case
    assert sum(int(s.busy.sum()) for s in states) > 0


@pytest.mark.parametrize("version", [1, 2, 3])
def test_utt_copy(version):
    a, b = JUtt(version), UnitTypeTable(version)
    assert [u.name for u in a.unit_types] == [u.name for u in b.unit_types]
    for f in ("cost", "hp", "min_damage", "max_damage", "attack_range",
              "produce_time", "move_time", "attack_time", "harvest_time",
              "return_time", "harvest_amount", "is_resource", "is_stockpile",
              "can_harvest", "can_move", "can_attack", "produces_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("map_rel", MAPS)
def test_state_from_pgs(map_rel):
    ju, tu = JUtt(2), UnitTypeTable(2)
    jp = JPgs.load(jax_asset_path(map_rel), ju)
    tp = PhysicalGameState.load(asset_path(map_rel), tu)
    jcfg = JT.EngineConfig.from_utt(ju, jp.height, jp.width)
    tcfg = TT.EngineConfig.from_utt(tu, tp.height, tp.width)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    js = JT.state_from_pgs(jp, jcfg)
    ts = TT.state_from_pgs(tp, tcfg, 3, "cpu")
    one = TT.state_to_numpy(ts)
    for f, v in leaves(js).items():
        for b in range(3):
            np.testing.assert_array_equal(v, one[f][b], f)
            assert v.dtype == one[f].dtype, f
    single = TT.state_from_numpy(leaves(js))     # one env -> batch of 1
    assert single.batch == 1
    assert ts.equal(ts.select(torch.ones(3, dtype=torch.bool),
                              single)) == (True, "")


def test_state_numpy_roundtrip():
    env = envs("maps/8x8/basesWorkers8x8.xml")[1]
    s = port_trajectory(env, 2, 25, seed=3, keep={24})[24]
    assert TT.state_from_numpy(TT.state_to_numpy(s)).equal(s) == (True, "")


def test_cycle_random_damage_raises():
    """UTT v3's random damage needs the cycle's uniforms: without them
    ``cycle`` raises, with them it runs (tests/test_torch_nondet.py holds
    it against the JAX package)."""
    utt = UnitTypeTable(3)
    eng = make_engine(TT.EngineConfig.from_utt(utt, 8, 8))
    pgs = PhysicalGameState.load(asset_path("maps/8x8/basesWorkers8x8.xml"),
                                 utt)
    s = TT.state_from_pgs(pgs, eng.cfg, 1, "cpu")
    with pytest.raises(ValueError, match="needs u01"):
        eng.cycle(s)
    s2, done = eng.cycle(s, u01=torch.rand(1, 8, 8))
    assert int(s2.time[0]) == 1 and not bool(done[0])


def test_missing_card_raises(monkeypatch):
    """Entry points default to CUDA and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.resolve_device("cuda")
    assert TT.resolve_device("cpu").type == "cpu"
