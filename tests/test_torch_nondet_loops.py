"""UTT v3's random damage and CANCEL_RANDOM's coins in the port's loops
(plain path on the CPU).

Where JAX draws inside a jitted loop (playouts, tournaments, the stateful
loop), the contract is the distributional one of ``tests/test_nondet.py``:
every hit's damage lies in [min, max] of its attacker's type (summed over
the hits a unit takes in one cycle), some hit lands above the minimum,
the same generator seed reproduces exactly and different seeds diverge.
Also: the CANCEL_RANDOM PO round robin and stateful loop, which draw
their coins per frame, and a MonteCarlo decision under v3.
"""

import numpy as np
import pytest
import torch

from microrts_tpu_torch.bots.believestate import (play_matches_stateful,
                                                  stateless)
from microrts_tpu_torch.bots.search import monte_carlo_bot
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.engine.types import ATTACK, MOVE, state_to_numpy
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.eval.tournament import (_games_fn, play_matches,
                                                round_robin)
from microrts_tpu_torch.ops.playout import make_playout, playout_noise
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import torch_one_thread  # noqa: F401

MELEE = "maps/melee4x4light2.xml"
BW8 = "maps/8x8/basesWorkers8x8.xml"


# ----------------------------------------------------------------------
# the distributional contract on the paths that draw inside their loops

class DamageProbe:
    """Wraps ``env.engine.cycle`` to check every hit on a standing unit:
    its hp drop lies between the sums of its attackers' min and max
    damage; counts the drops above the minimum."""

    def __init__(self, env, monkeypatch):
        self.cfg = env.cfg.engine
        self.hits = self.above = self.bad = 0
        eng = env.engine
        orig = eng.cycle

        def cycle(state, active=None, u01=None):
            new, done = orig(state, active, u01)
            self.record(state, new, active)
            return new, done
        monkeypatch.setattr(eng, "cycle", cycle)

    def record(self, s, new, active):
        cfg = self.cfg
        T = cfg.num_types
        t = (s.utype.long() - 1).clamp(0, T - 1)
        lo_t = torch.tensor(cfg.min_damage, dtype=torch.int32)
        hi_t = torch.tensor(cfg.max_damage, dtype=torch.int32)
        comp = s.busy & (s.aticks <= 1)
        atk = comp & (s.atype == ATTACK)
        if active is not None:
            atk = atk & active[:, None, None]
        B, H, W = s.utype.shape
        lo = torch.zeros((B, H * W), dtype=torch.int32)
        hi = torch.zeros_like(lo)
        n = torch.zeros_like(lo)
        b, y, x = atk.nonzero(as_tuple=True)
        tx, ty = s.atx[b, y, x].long(), s.aty[b, y, x].long()
        ok = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
        b, tgt, tt = b[ok], (ty * W + tx)[ok], t[b, y, x][ok]
        lo.index_put_((b, tgt), lo_t[tt], accumulate=True)
        hi.index_put_((b, tgt), hi_t[tt], accumulate=True)
        n.index_put_((b, tgt), torch.ones_like(tt, dtype=torch.int32),
                      accumulate=True)
        lo, hi, n = (v.reshape(B, H, W) for v in (lo, hi, n))
        stand = ((s.utype > 0) & ~(comp & (s.atype == MOVE)) & (n > 0)
                 & (new.uid == s.uid) & (new.utype == s.utype))
        drop = (s.hp - new.hp).to(torch.int32)
        self.hits += int(stand.sum())
        self.bad += int((stand & ((drop < lo) | (drop > hi))).sum())
        self.above += int((stand & (drop > lo)).sum())

    def check(self):
        assert self.hits > 0 and self.bad == 0 and self.above > 0, (
            self.hits, self.bad, self.above)


@pytest.fixture
def melee3():
    return GridnetEnv(asset_path(MELEE), UnitTypeTable(3), device="cpu")


def _final(seed, env, max_cycles=50):
    w, s, _ = _games(env, seed, max_cycles)
    return w, state_to_numpy(s)


def _games(env, seed, max_cycles):
    bots = [make_bot("RandomBiasedAI", env), make_bot("LightRush", env)]
    run = _games_fn(env, bots, max_cycles, fixed_pair=True)
    z = torch.zeros(8, dtype=torch.int64)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return run(z, z + 1, gen)


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_tournament_damage_reproduces_and_diverges(melee3, monkeypatch,
                                                    torch_one_thread):
    probe = DamageProbe(melee3, monkeypatch)
    w0, s0 = _final(0, melee3)
    probe.check()
    w0b, s0b = _final(0, melee3)
    w1, s1 = _final(1, melee3)
    assert np.array_equal(w0, w0b) and _same(s0, s0b)
    assert not _same(s0, s1)
    assert len(play_matches(melee3, make_bot("RandomBiasedAI", melee3),
                            make_bot("WorkerRush", melee3), 4,
                            max_cycles=30)) == 4


def test_stateful_loop_damage_reproduces_and_diverges(melee3, monkeypatch,
                                                       torch_one_thread):
    probe = DamageProbe(melee3, monkeypatch)
    b0 = stateless(make_bot("RandomBiasedAI", melee3))
    b1 = stateless(make_bot("LightRush", melee3))

    def run(seed):
        w, s, _ = play_matches_stateful(melee3, b0, b1, 8, max_cycles=50,
                                        seed=seed)
        return w.numpy(), state_to_numpy(s)
    w0, s0 = run(0)
    probe.check()
    w0b, s0b = run(0)
    _, s1 = run(1)
    assert np.array_equal(w0, w0b) and _same(s0, s0b)
    assert not _same(s0, s1)


def test_playout_damage_reproduces_and_diverges(melee3, monkeypatch,
                                                torch_one_thread):
    probe = DamageProbe(melee3, monkeypatch)
    play = make_playout(melee3, 60, lambda s, p: s.hp.sum((1, 2)).float())
    s = melee3.reset(16)
    gen = torch.Generator()
    gen.manual_seed(0)
    nz = playout_noise(melee3, gen, play.n_decisions, 16)
    vals = []
    for seed in (0, 0, 1):
        gen.manual_seed(seed)
        u01 = melee3.draw_u01(gen, play.n_cycles, 16)
        vals.append(play(s, 0, s.time, nz, u01=u01))
    probe.check()
    assert torch.equal(vals[0], vals[1])
    assert not torch.equal(vals[0], vals[2])
    with pytest.raises(ValueError, match="needs u01"):
        play(s, 0, s.time, nz)


def test_monte_carlo_decision_v3(melee3, torch_one_thread):
    mc = monte_carlo_bot(melee3, n_candidates=3, playout_len=16)
    s = melee3.reset(4)
    outs = []
    for seed in (0, 0):
        gen = torch.Generator()
        gen.manual_seed(seed)
        nz = mc.draw(gen, 4)
        # the first tick's cycle, then 4 decisions and 2 coasting cycles,
        # on 4 games x 3 candidates
        assert nz.u01.shape == (7, 12, 4, 4) and nz.coins is None
        outs.append(mc(s, 0, nz))
    assert torch.equal(outs[0], outs[1])


# ----------------------------------------------------------------------
# CANCEL_RANDOM under fog: the per-frame coins of the loops

@pytest.fixture
def po_random():
    return GridnetEnv(asset_path(BW8), UnitTypeTable(2, 2),
                      partial_obs=True, device="cpu")


def test_po_cancel_random_round_robin(po_random, torch_one_thread):
    assert po_random.random_coins and not po_random.random_damage
    bots = {n: make_bot(n, po_random)
            for n in ("POWorkerRush", "RandomBiasedAI")}

    def table(seed):
        return round_robin(po_random, bots, games_per_pair=2,
                           max_cycles=60, seed=seed)
    a, b = table(0), table(0)
    assert np.array_equal(a.wins, b.wins) and np.array_equal(a.ties, b.ties)
    assert a.games.sum() == 8


def test_po_cancel_random_stateful_loop(po_random, torch_one_thread):
    b0 = stateless(make_bot("RandomBiasedAI", po_random))
    b1 = stateless(make_bot("POWorkerRush", po_random))

    def run(seed):
        w, s, _ = play_matches_stateful(po_random, b0, b1, 4,
                                        max_cycles=40, seed=seed)
        return state_to_numpy(s)
    a, b, c = run(0), run(0), run(1)
    assert _same(a, b) and not _same(a, c)
