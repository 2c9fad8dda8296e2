"""Port gridnet env and bots (``microrts_tpu_torch.env``/``bots``, plain path
on the CPU) vs the JAX package on the same states, actions and uniforms.

Covers decode with garbage actions (every component uniform over
``action_nvec``: Java's flat row-wrap claims and the select-dir quirk),
the ``max_produce_scan`` cap with more than 16 idle bases, random_bot with
edge uniforms, and ``GridnetEnv.step`` with observation, masks, dones and
all six ported rewards.  Tolerance: exact (rewards are counts and +-1 in
float32).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.engine import types as JT
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.pgs import (HostPlayer, HostUnit,
                                          PhysicalGameState)
from microrts_tpu_torch.engine.types import (PRODUCE, EngineConfig,
                                             state_from_numpy, state_from_pgs,
                                             state_to_numpy)
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import (BIAS, assert_cand_eq, assert_eq, assert_state_eq,
                          draw, envs, garbage, jax_fns, jax_state,
                          port_trajectory)

MAPS = ["maps/8x8/basesWorkers8x8.xml", "maps/8x8/basesWorkersBarracks8x8.xml",
        "maps/8x8/melee8x8Mixed6.xml"]
B = 6


@pytest.fixture(scope="module", params=MAPS, ids=lambda m: m.split("/")[-1])
def case(request):
    jenv, env = envs(request.param)
    traj = port_trajectory(env, B, 31, seed=11, keep={0, 30})
    return jenv, env, jax_fns(jenv), [traj[0], traj[30]]


def test_inflight_claims_and_spent(case):
    jenv, env, fns, states = case
    for s in states:
        js = jax_state(s)
        assert_eq(fns.claims(js), env._inflight_claims(s), "claims")
        for p in (0, 1):
            assert_eq(fns.spent(js, p), env._inflight_spent(s, p), "spent")


@pytest.mark.parametrize("rate", [1.0, 0.3])
def test_decode_garbage(case, rate):
    jenv, env, fns, states = case
    rng = np.random.default_rng(int(rate * 10))
    bot = random_bot(env, BIAS)
    for i, s in enumerate(states):
        js = jax_state(s)
        for p in (0, 1):
            u = torch.from_numpy(rng.random((B, env.h, env.w, 2),
                                            dtype=np.float32))
            base = bot(s, p, u).numpy()
            a = garbage(rng, env.action_nvec(), (B, env.h, env.w), rate, base)
            jc, _, _ = fns.decode(js, jnp.asarray(a), p)
            assert_cand_eq(jc, env.decode(s, torch.from_numpy(a), p),
                           f"state {i} p{p}")


def _many_bases(resources, inflight):
    """8x8 board with 20 idle player-0 bases (more than max_produce_scan)
    and one player-1 worker; ``inflight`` bases already produce."""
    utt = UnitTypeTable(2)
    pgs = PhysicalGameState(8, 8)
    pgs.players = [HostPlayer(0, resources), HostPlayer(1, 5)]
    base, worker = utt.get_unit_type("Base"), utt.get_unit_type("Worker")
    cells = [(x, y) for y in (0, 2, 4, 6) for x in (0, 2, 4, 6)]
    cells += [(1, 1), (3, 3), (5, 5), (1, 5)]
    for i, (x, y) in enumerate(cells):
        pgs.add_unit(HostUnit(i, 0, base.ID, x, y, 0, base.hp))
    pgs.add_unit(HostUnit(99, 1, worker.ID, 7, 3, 0, worker.hp))
    cfg = EngineConfig.from_utt(utt, 8, 8)
    leaves_ = state_to_numpy(state_from_pgs(pgs, cfg, 1, "cpu"))
    for (x, y), d in zip(cells[:inflight], (1, 2, 1, 2)):
        leaves_["busy"][0, y, x] = True
        leaves_["atype"][0, y, x] = PRODUCE
        leaves_["aparam"][0, y, x] = d
        leaves_["aptype"][0, y, x] = worker.ID
        leaves_["aticks"][0, y, x] = 30
        leaves_["atime"][0, y, x] = 0
    return utt, cells, leaves_


@pytest.mark.parametrize("resources,inflight", [(1000, 0), (1000, 2), (7, 2),
                                                (0, 0)])
def test_decode_produce_cap(resources, inflight):
    """More than max_produce_scan (16) produce candidates: the ones past
    the 16th are dropped, the zero-skip lets a first produce through at
    zero spend, same-slot produces block each other, and moves win slots
    only at lower rank."""
    utt, cells, lv = _many_bases(resources, inflight)
    jenv, env = envs("maps/8x8/basesWorkers8x8.xml")
    fns = jax_fns(jenv)
    rng = np.random.default_rng(resources + inflight)
    wid = utt.get_unit_type("Worker").ID
    a = np.zeros((1, 8, 8, 7), np.int32)
    for x, y in cells:
        a[0, y, x] = [PRODUCE, 0, 0, 0, rng.integers(0, 4), wid, 0]
    a[0, 3, 7] = [1, 3, 0, 0, 0, 0, 0]          # p1's worker moves left
    s = state_from_numpy(lv)
    js = JT.State(**{k: jnp.asarray(v) for k, v in lv.items()},
                  key=jnp.zeros((1, 2), jnp.uint32))
    for p in (0, 1):
        jc, _, _ = fns.decode(js, jnp.asarray(a), p)
        tc = env.decode(s, torch.from_numpy(a), p)
        assert_cand_eq(jc, tc, f"p{p}")
    tc0 = env.decode(s, torch.from_numpy(a), 0)
    kept = int((tc0.atype == PRODUCE).sum())
    if resources == 1000:
        assert 0 < kept <= 16
    if resources == 0 and inflight == 0:
        assert kept == 1                          # the zero-skip


_FED = {}


def _uniform_fed_bot(jenv, monkeypatch):
    """JAX random_bot taking its uniforms in place of its key: traced once
    per config while jax.random.uniform returns its key argument."""
    if jenv.cfg not in _FED:
        from microrts_tpu.bots import scripted as jbots
        monkeypatch.setattr(jbots.jax.random, "uniform",
                            lambda key, shape=(), *a, **k: key)
        fn = jax.jit(jax.vmap(jbots.random_bot(jenv, BIAS),
                              in_axes=(0, None, 0)))
        z = jnp.zeros((B, jenv.h, jenv.w, 2), jnp.float32)
        fn(jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B)),
           0, z)                                  # trace and compile now
        monkeypatch.undo()
        _FED[jenv.cfg] = fn
    return _FED[jenv.cfg]


@pytest.mark.parametrize("kind", ["keys", "zero", "max", "mixed"])
def test_random_bot(case, kind, monkeypatch):
    jenv, env, fns, states = case
    bot = random_bot(env, BIAS)
    H, W = env.h, env.w
    top = np.nextafter(np.float32(1), np.float32(0))
    rng = np.random.default_rng(3)
    if kind != "keys":
        jbot = _uniform_fed_bot(jenv, monkeypatch)
    for i, s in enumerate(states):
        js = jax_state(s)
        for p in (0, 1):
            if kind == "keys":
                ks, u = draw(fns, jax.random.PRNGKey(10 * i + p), B)
                ja = fns.bot(js, p, ks)
            else:
                u = {"zero": np.zeros((B, H, W, 2), np.float32),
                     "max": np.full((B, H, W, 2), top, np.float32),
                     "mixed": np.where(rng.random((B, H, W, 2)) < 0.5,
                                       np.float32(0), top)}[kind]
                ja = jbot(js, p, jnp.asarray(u))
            assert_eq(ja, bot(s, p, torch.from_numpy(np.array(u))),
                      f"{kind} state {i} p{p}")


def test_step_obs_masks_dones_rewards(case):
    """GridnetEnv.step (JAX's own step code, around jitted parts) vs the
    port, 8 ticks from each recorded state, with observation,
    observation_onehot, masks and dones on every result."""
    jenv, env, fns, states = case
    fns.patch(jenv)
    step = jax.vmap(jenv.step)
    bot = random_bot(env, BIAS)
    key = jax.random.PRNGKey(5)
    for s in states:
        js = jax_state(s)
        for t in range(8):
            key, k0, k1 = jax.random.split(key, 3)
            (ks0, u0), (ks1, u1) = draw(fns, k0, B), draw(fns, k1, B)
            a0, a1 = fns.bot(js, 0, ks0), fns.bot(js, 1, ks1)
            ta0 = bot(s, 0, torch.from_numpy(u0))
            ta1 = bot(s, 1, torch.from_numpy(u1))
            assert_eq(a0, ta0, f"t{t} a0")
            js, jr, jd = step(js, a0, a1)
            s, tr, td = env.step(s, ta0, ta1)
            assert_state_eq(js, s, f"t{t}")
            assert_eq(jr, tr, f"t{t} rewards")
            assert_eq(jd, td, f"t{t} done")
        assert_eq(jax.vmap(jenv.dones)(js), env.dones(s), "dones")
        for p in (0, 1):
            assert_eq(jax.vmap(lambda x: jenv.observation(x, p))(js),
                      env.observation(s, p), f"obs p{p}")
            assert_eq(jax.vmap(lambda x: jenv.observation_onehot(x, p))(js),
                      env.observation_onehot(s, p), f"onehot p{p}")
            assert_eq(fns.legal(js, p)[1], env.masks(s, p), f"masks p{p}")


def test_per_lane_player_masks_and_decode(case):
    """``Engine.legal_masks``, ``GridnetEnv.masks``, ``_inflight_spent`` and
    ``decode`` with a mixed per-env player vector (int32 ``[B]``, as the
    tree search's nodes have) equal the two single-player calls merged by
    lane."""
    jenv, env, fns, states = case
    rng = np.random.default_rng(5)
    pl = torch.arange(B, dtype=torch.int32) % 2
    one = pl == 1

    def merged(a, b):
        return torch.where(one.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)
    for s in states:
        m = env.engine.legal_masks(s, pl)
        ms = [env.engine.legal_masks(s, p) for p in (0, 1)]
        for k in m:
            assert torch.equal(m[k], merged(ms[0][k], ms[1][k])), k
        assert torch.equal(env.masks(s, pl),
                           merged(env.masks(s, 0), env.masks(s, 1)))
        assert torch.equal(env._inflight_spent(s, pl), merged(
            env._inflight_spent(s, 0), env._inflight_spent(s, 1)))
        shape = tuple(s.utype.shape)
        a = torch.from_numpy(garbage(rng, env.action_nvec(), shape, 0.5,
                                     garbage(rng, env.action_nvec(), shape,
                                             1.0)))
        c = env.decode(s, a, pl, 10)
        cs = [env.decode(s, a, p, 10) for p in (0, 1)]
        for f in ("atype", "aparam", "atx", "aty", "aptype", "rank"):
            assert torch.equal(getattr(c, f), merged(getattr(cs[0], f),
                                                     getattr(cs[1], f))), f
        assert (c.atype >= 0).any()


def test_frame_skip():
    jenv, env = envs(MAPS[1], frame_skip=3)
    fns = jax_fns(jenv)
    fns.patch(jenv)
    s = env.reset(B)
    js = jax_state(s)
    bot = random_bot(env, BIAS)
    key = jax.random.PRNGKey(9)
    for t in range(4):
        key, k0, k1 = jax.random.split(key, 3)
        (ks0, u0), (ks1, u1) = draw(fns, k0, B), draw(fns, k1, B)
        js, jr, jd = jax.vmap(jenv.step)(js, fns.bot(js, 0, ks0),
                                         fns.bot(js, 1, ks1))
        s, tr, td = env.step(s, bot(s, 0, torch.from_numpy(u0)),
                             bot(s, 1, torch.from_numpy(u1)))
        assert_state_eq(js, s, f"t{t}")
        assert_eq(jr, tr, "rewards")
    assert int(s.time[0]) == 12


def test_not_ported_options_raise():
    """The closer rewards construct (every JAX reward is ported); a name
    the JAX package does not know is refused."""
    path = asset_path(MAPS[0])
    env = GridnetEnv(path, reward_fns=("winloss", "closertoenemybase",
                                       "closertoenemyunit"), device="cpu")
    s = env.reset(2)
    z = torch.zeros((2, env.h, env.w, 7), dtype=torch.int32)
    _, r, _ = env.step(s, z, z)
    assert r.shape == (2, 2, 3) and r.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown reward"):
        GridnetEnv(path, reward_fns=("winloss", "closertoenemy"),
                   device="cpu")


def test_reset_batch():
    env = GridnetEnv(asset_path(MAPS[0]), device="cpu")
    s = env.reset(5)
    assert s.utype.shape == (5, 8, 8) and s.resources.shape == (5, 2)
    assert all(v.is_contiguous() for v in vars(s).values())
    assert (s.utype == s.utype[:1]).all()


def test_passive_bot(case):
    from microrts_tpu.bots.scripted import passive_bot as jax_passive_bot
    from microrts_tpu_torch.bots.scripted import passive_bot
    jenv, env, fns, states = case
    s = states[-1]
    ja = jax.vmap(lambda x: jax_passive_bot(jenv)(x, 1, None))(jax_state(s))
    assert_eq(ja, passive_bot(env)(s, 1), "passive_bot")
