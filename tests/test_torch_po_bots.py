"""The port's partially observable rushes (``bots/scripted.py``
``po_worker_rush``, ``po_light_rush``, ``po_heavy_rush``,
``po_ranged_rush``: the fog-of-war view, then the unchanged rush bot;
plain path on the CPU) against the JAX package's ``po_*_rush`` on the
recorded rush states of tests/torch_rush_parity.py (both players), and
``make_bot`` of the four names.  Tolerance: exact.
"""

import pytest
import torch

from microrts_tpu_torch.bots.scripted import Opponent
from microrts_tpu_torch.config import (JAVA_AI_ALIASES, PO_BOTS, PORTED_BOTS,
                                       _NOT_PORTED, make_bot)

from torch_parity import assert_eq, torch_one_thread  # noqa: F401
from torch_rush_parity import jax_actions, port_bot, recorded_states

pytestmark = pytest.mark.usefixtures("torch_one_thread")

NAMES = ("POWorkerRush", "POLightRush", "POHeavyRush", "PORangedRush")


@pytest.mark.parametrize("name", NAMES)
def test_po_rush_matches_jax(name):
    env, _, s = recorded_states()
    want = jax_actions(NAMES)
    bot = port_bot(name, env)
    full = port_bot(name[2:], env)
    differ = 0
    for p in (0, 1):
        got = bot(s, p)
        assert_eq(want[(name, p)], got, f"{name} p{p}")
        assert (got[..., 0] > 0).any()
        # the fog changes what the rush does in some states
        differ += int((got != full(s, p)).any((1, 2, 3)).sum())
    assert differ > 0


def test_make_bot_builds_the_po_rushes():
    env, _, s = recorded_states()
    assert set(PO_BOTS) == set(NAMES) and set(NAMES) <= set(PORTED_BOTS)
    assert not set(NAMES) & set(_NOT_PORTED)
    # the JAX registry's 54 names: 45 built, 9 refused with their item
    assert len(PORTED_BOTS) == 45 and len(_NOT_PORTED) == 9
    for java, short in JAVA_AI_ALIASES.items():
        if short in NAMES:
            a, b = make_bot(java, env), make_bot(short, env)
            assert isinstance(a, Opponent) and a.draw(None, 3) is None
            assert torch.equal(a(s, 1), b(s, 1))
