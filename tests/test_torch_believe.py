"""The port's believe-state memory (``bots/believestate.py``: ``init``, the
update and ``sample_world`` of BS1 and BS2_NaiveMCTS; plain path on the
CPU) against the JAX package's ``believe_state_bot`` at every tick of the
recorded games of tests/torch_believe_parity.py, and ``step``; level 3
and JAX's scenarios are in tests/test_torch_believe3.py.  Memories (planes,
seen types, previous view and visibility) and sampled worlds must be
equal at every tick, and every rule of the level must fire.  Tolerance:
exact.
"""

import pytest
import torch

from microrts_tpu.bots import believestate as JB
from microrts_tpu_torch.bots import believestate as BS
from microrts_tpu_torch.bots import scripted as S

from torch_believe_parity import GAMES, check_level, trajectory
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("level", [1, 2])
def test_believe_memory_matches_jax_at_every_tick(level):
    check_level(level)


def test_believe_step_plays_the_inner_bot_on_the_world():
    """``step`` = the update, then the inner bot on the sampled world (here
    WorkerRush, which draws nothing), and ``live`` keeps the others'
    memories."""
    jenv, env, states = trajectory()
    inner = S.Opponent(S.worker_rush(env))
    bot = BS.believe_state_bot(env, inner, level=3)
    s0, s1 = states[0], states[10]
    m = bot.init(s0, 0)
    mem, world = bot.update(s1, m, 0)
    act, m2 = bot.step(s1, m, 0, None)
    assert torch.equal(act, inner(world, 0)) and (act[..., 0] > 0).any()
    for f in BS.BelieveMem.PLANES:
        assert torch.equal(getattr(m2, f), getattr(mem, f)), f
    live = torch.arange(2 * GAMES) % 2 == 0
    _, m3 = bot.step(s1, m, 0, None, live=live)
    for f in ("b_utype", "b_hp", "b_uid", "prev_vis"):
        a, b, old = getattr(m3, f), getattr(mem, f), getattr(m, f)
        assert torch.equal(a[live], b[live]) and torch.equal(a[~live],
                                                             old[~live]), f
    ok, _ = m3.prev.select(live, m.prev).equal(m.prev)
    assert ok


def test_make_bot_builds_the_stateful_bots():
    """The four stateful names at the JAX registry's settings
    (microrts_tpu/config.py:212-225) on basesWorkers16x16: the believe
    levels around the default NaiveMCTS (64 playouts, 96 nodes, 16
    children, depth 10) and tree reuse at the same defaults."""
    from microrts_tpu_torch.config import (JAVA_AI_ALIASES, PORTED_BOTS,
                                           STATEFUL_BOTS, _NOT_PORTED,
                                           make_bot)
    from microrts_tpu_torch.env.gridnet import GridnetEnv
    from microrts_tpu_torch.utils.assets import asset_path
    env = GridnetEnv(asset_path("maps/16x16/basesWorkers16x16.xml"),
                     device="cpu")
    assert set(STATEFUL_BOTS) <= set(PORTED_BOTS)
    assert not set(STATEFUL_BOTS) & set(_NOT_PORTED)
    for java, short in JAVA_AI_ALIASES.items():
        if short.startswith("BS"):
            bot = make_bot(java, env)
            assert isinstance(bot, BS.StatefulBot)
            assert bot.level == int(short[2]) and bot.inner.bot.dims == (
                96, 16, 10) and bot.inner.bot.n_playouts == 64
    bot = make_bot("ContinuingNaiveMCTS", env)
    assert isinstance(bot, BS.StatefulBot)
    assert bot.base.bot.dims == (96, 16, 10)
    assert bot.base.bot.n_playouts == 64
    s = env.reset(2)
    tree = bot.init(s, 0)
    assert tree.tacc.shape == (2, 97, 16, 16, 90)


def test_spiral_offsets_are_jax():
    for r in (1, 3, 6):
        assert BS.spiral_offsets(r) == JB._spiral_offsets(r)
    assert len(BS.spiral_offsets(6)) == 168
