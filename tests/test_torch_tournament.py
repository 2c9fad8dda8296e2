"""Tournaments (eval/tournament.py): the port's plain ``play_matches``
against the JAX package's game loop on basesWorkers8x8: winners equal
(the fixed-pair runner with RandomBiasedAI in
test_torch_tournament_random.py, ``play_matches_both`` in
test_torch_play_both.py, ``round_robin`` in test_torch_round_robin.py).

The reference is JAX's ``chunk_fn`` (tournament.py:81-107) followed line
by line with its jitted pieces (tests/torch_tournament_parity.py); JAX's
whole ``play_matches`` is not compiled (minutes of CPU).  The port takes
the uniforms of JAX's key tree (``split(PRNGKey(seed), n)`` per game for
the fixed pairs, ``fold_in(PRNGKey(seed), lane)`` for the round robin,
then ``k, k0, k1 = split(k, 3)`` every frame) through its ``noise``
source (the rushes draw nothing).  The cap is short (``max_cycles``
300)."""

import numpy as np
import pytest
import jax

from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.eval import tournament as TN

from torch_parity import torch_one_thread, assert_eq
from torch_playout_parity import patched_envs
from torch_tournament_parity import jax_games

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"
CAP = 300
CHUNK = 16


def test_play_matches_rush_vs_rush_matches_jax():
    """``play_matches`` from its own generator (the rushes draw nothing)."""
    names = ("WorkerRush", "LightRush")
    z = np.zeros(2, np.int64)
    jw, _, _ = jax_games(MAP, names, z, z + 1,
                         jax.random.split(jax.random.PRNGKey(0), 2), CAP)
    _, env = patched_envs(MAP)
    w = TN.play_matches(env, make_bot(names[0], env), make_bot(names[1], env),
                        2, CAP, chunk=CHUNK)
    assert_eq(jw, w, "play_matches")
    assert (w >= 0).all()          # the rushes finish before the cap
