"""``play_matches_both`` (eval/tournament.py): WorkerRush and
RandomBiasedAI in both positions on basesWorkers8x8, two games each way,
the port's plain path against the JAX package's game loop (the reference
and draws of test_torch_tournament.py, tests/torch_tournament_parity.py:
JAX's ``split(PRNGKey(seed), 2n)``, the first ``n`` keys for bot0-vs-bot1
and the rest for bot1-vs-bot0): both winner vectors equal."""

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


def test_play_matches_both_matches_jax():
    names = ("WorkerRush", "RandomBiasedAI")
    n = 2
    keys = jax.random.split(jax.random.PRNGKey(5), 2 * n)
    z = np.zeros(n, np.int64)
    jw01, _, noise01 = jax_games(MAP, names, z, z + 1, keys[:n], CAP)
    jw10, _, noise10 = jax_games(MAP, names[::-1], z, z + 1, keys[n:], CAP)
    _, env = patched_envs(MAP)
    w01, w10 = TN.play_matches_both(env, make_bot(names[0], env),
                                    make_bot(names[1], env), n, CAP,
                                    chunk=CHUNK, noise=(noise01, noise10))
    assert_eq(jw01, w01, "w01")
    assert_eq(jw10, w10, "w10")
