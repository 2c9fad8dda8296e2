"""The port's full ``issue`` (``Engine.issue``, plain path on the CPU)
against the JAX package's ``make_engine.issue``: the three move-conflict
policies on the scenario of tests/test_engine_device.py
(``test_conflict_policies``), with CANCEL_RANDOM's coins drawn from JAX's
keys as its ``issue`` draws them; random candidate tables over recorded
partially observable 8x8 states under all three policies, where every
conflict kind occurs and is counted (16x16: test_torch_issue_16x16.py);
and the
shortcut the port's playouts and searches take, ``issue_env`` equal to
``issue`` on decode-vetted full-observation candidates.  Tolerance:
exact, whole states.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.engine import kernel as JK
from microrts_tpu.engine.pgs import HostPlayer as JHostPlayer
from microrts_tpu.engine.pgs import HostUnit as JHostUnit
from microrts_tpu.engine.pgs import PhysicalGameState as JPGS
from microrts_tpu.engine.types import Candidates as JCandidates
from microrts_tpu.engine.types import INF
from microrts_tpu.engine.types import state_from_pgs as jax_state_from_pgs
from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.engine.types import (Candidates, state_from_numpy,
                                             state_to_numpy)
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import (BIAS, assert_state_eq, leaves,
                          torch_one_thread)  # noqa: F401
from torch_po_parity import (POLICIES, cat_states, check_random_tables,
                             coins_of, jax_issue, po_records, port_engine)


def _scenario(policy, seed):
    """Two workers of a 5x5 board moving into the same cell
    (tests/test_engine_device.py:79-106): (JAX state with key, JAX
    candidates)."""
    from microrts_tpu.engine.types import EngineConfig as JEC
    from microrts_tpu.engine.utt import UnitTypeTable as JUTT
    utt = JUTT(2, policy)
    pgs = JPGS(5, 5)
    pgs.players = [JHostPlayer(0, 5), JHostPlayer(1, 5)]
    wid = utt.get_unit_type("Worker").ID
    pgs.add_unit(JHostUnit(0, 0, wid, 1, 2, 0, 1))
    pgs.add_unit(JHostUnit(1, 1, wid, 3, 2, 0, 1))
    s = jax_state_from_pgs(pgs, JEC.from_utt(utt, 5, 5))
    at = np.full((5, 5), -1, np.int32)
    ap = np.zeros((5, 5), np.int32)
    rk = np.full((5, 5), INF, np.int32)
    at[2, 1], ap[2, 1], rk[2, 1] = 1, 1, 0
    at[2, 3], ap[2, 3], rk[2, 3] = 1, 3, 1
    z = np.zeros((5, 5), np.int32)
    return (s.replace(key=jax.random.PRNGKey(seed)),
            [at, ap, z, z, z, rk])


def test_conflict_policies_match_jax(torch_one_thread):
    seen = {}
    for policy in POLICIES:
        cfg, _ = jax_issue(5, 5, policy)
        jissue = jax.jit(JK.make_engine(cfg).issue)
        eng = port_engine(5, 5, policy)
        for seed in range(8):
            js, c = _scenario(policy, seed)
            jn = jissue(js, JCandidates(*map(jnp.asarray, c)))
            s = state_from_numpy(leaves(js))
            tc = Candidates(*[torch.from_numpy(v[None]) for v in c])
            jb = jax.tree.map(lambda x: x[None], js)
            coins = coins_of(jb) if policy == 2 else None
            n = eng.issue(s, tc, coins)
            assert_state_eq(jax.tree.map(lambda x: x[None], jn), n,
                            f"policy {policy} seed {seed}")
            out = state_to_numpy(n)
            seen.setdefault(policy, set()).add(
                (int(out["atype"][0, 2, 1]), int(out["atype"][0, 2, 3]),
                 int(out["cancel_ctr"][0])))
    assert seen[1] == {(0, 0, 0)}                  # CANCEL_BOTH
    assert seen[2] == {(0, 1, 0), (1, 0, 0)}       # RANDOM: both ways
    assert seen[3] == {(1, 0, 1)}                  # ALTERNATING
    with pytest.raises(ValueError, match="coins"):
        port_engine(5, 5, 2).issue(s, tc)


def test_issue_matches_jax_on_random_tables_8x8(torch_one_thread):
    """Random candidate tables on recorded PO states of melee8x8Mixed6
    (crowded: chains) and basesWorkers8x8 (produces: resource cancels)."""
    env = GridnetEnv(asset_path("maps/8x8/melee8x8Mixed6.xml"),
                     partial_obs=True, device="cpu")
    env2 = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                      partial_obs=True, device="cpu")
    s = cat_states([r[0] for r in po_records(env, 6, 40, seed=1, every=5)]
                   + [r[0] for r in po_records(env2, 6, 60, seed=2,
                                               every=6)])
    check_random_tables(env, s, seed=5)


def test_issue_env_is_issue_on_decode_vetted_full_obs(torch_one_thread):
    """The port's counterpart of tests/test_engine_device.py
    ``test_issue_env_fast_path``: ``issue_env`` equals the full ``issue``
    on candidates that came through decode against full-observation
    claims, tick by tick over 120 ticks of RandomBiasedAI self-play on
    basesWorkersBarracks8x8 (the shortcut of ``ops/playout.py`` and
    ``bots/treesearch.py``)."""
    env = GridnetEnv(asset_path("maps/8x8/basesWorkersBarracks8x8.xml"),
                     device="cpu")
    eng = env.engine
    bot = random_bot(env, BIAS)
    rng = np.random.default_rng(3)
    s = env.reset(8)
    counts, claims = {}, 0
    for t in range(120):
        u = [torch.from_numpy(rng.random((8, env.h, env.w, 2),
                                         dtype=np.float32)) for _ in (0, 1)]
        a0, a1 = bot(s, 0, u[0]), bot(s, 1, u[1])
        c0 = env.decode(s, a0, 0)
        s1 = eng.issue_env(s, c0)
        assert s1.equal(eng.issue_plain(s, c0, counts=counts)) == (True, ""), t
        c1 = env.decode(s1, a1, 1)
        s2 = eng.issue_env(s1, c1)
        assert s2.equal(eng.issue_plain(s1, c1, counts=counts)) == (True, ""), t
        claims += int(((c0.atype == 1) | (c0.atype == 4)
                       | (c1.atype == 1) | (c1.atype == 4)).sum())
        s, _ = eng.cycle(s2)
    assert claims > 100 and not any(counts.values()), (claims, counts)
