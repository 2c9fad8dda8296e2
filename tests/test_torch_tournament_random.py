"""Tournaments (eval/tournament.py): the port's fixed-pair runner
(``_games_fn``, under ``play_matches``) with RandomBiasedAI against
WorkerRush, against the JAX package's game loop on basesWorkers8x8:
winners and final states equal (``play_matches`` of two rushes in
test_torch_tournament.py).

The reference is JAX's ``chunk_fn`` (tournament.py:81-107) followed line
by line with its jitted pieces (tests/torch_tournament_parity.py); JAX's
whole ``play_matches`` is not compiled (minutes of CPU).  The port takes
the uniforms of JAX's key tree (``split(PRNGKey(seed), n)`` per game,
then ``k, k0, k1 = split(k, 3)`` every frame) through its ``noise``
source.  The cap is short (``max_cycles`` 300): some games end with a
winner, others at the cap."""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.eval import tournament as TN

from torch_parity import torch_one_thread, assert_eq, assert_state_eq
from torch_playout_parity import patched_envs
from torch_tournament_parity import jax_games

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"
CAP = 300
CHUNK = 16


def _fixed_pair(names, n, keys):
    _, env = patched_envs(MAP)
    z = np.zeros(n, np.int64)
    jw, js, noise = jax_games(MAP, names, z, z + 1, keys, CAP)
    run = TN._games_fn(env, [make_bot(nm, env) for nm in names], CAP, CHUNK,
                       fixed_pair=True)
    w, s, _ = run(torch.zeros(n, dtype=torch.int64),
                  torch.ones(n, dtype=torch.int64), noise=noise)
    return jw, js, w, s, noise


def test_games_random_vs_rush_match_jax():
    """The fixed-pair runner with JAX's draws: winners and final states."""
    names = ("RandomBiasedAI", "WorkerRush")
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jw, js, w, s, _ = _fixed_pair(names, 4, keys)
    assert_eq(jw, w, "winners")
    assert_state_eq(js, s, "final states")
    assert len(set(s.time.tolist())) > 1      # lanes drift in game time
