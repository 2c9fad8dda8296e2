"""``round_robin`` (eval/tournament.py) over RandomBiasedAI, WorkerRush
and LightRush on basesWorkers8x8, one game per ordered pair (six lanes of
one pool batch, each pool bot run only on its lanes): the port's plain
path against the JAX package's game loop, the table equal to JAX's tally
of JAX's winners.  The reference and the draws are those of
test_torch_tournament.py (tests/torch_tournament_parity.py): JAX's
``chunk_fn`` followed line by line with its jitted pieces, the lanes'
keys ``fold_in(PRNGKey(seed), lane)``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from microrts_tpu.eval.tournament import TournamentResult as JaxResult
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.eval import tournament as TN

from torch_parity import torch_one_thread, assert_eq
from torch_playout_parity import patched_envs
from torch_tournament_parity import jax_games

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"
CAP = 300
CHUNK = 16


def test_round_robin_matches_jax():
    names = ("RandomBiasedAI", "WorkerRush", "LightRush")
    ii, jj = TN.pairings(3, 1)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(0), jnp.arange(len(ii), dtype=jnp.uint32))
    jw, js, noise = jax_games(MAP, names, ii, jj, keys, CAP)
    _, env = patched_envs(MAP)
    bots = {nm: make_bot(nm, env) for nm in names}
    res = TN.round_robin(env, bots, games_per_pair=1, max_cycles=CAP,
                         chunk=CHUNK, noise=noise)
    # JAX's tally (tournament.py:223-233) of JAX's winners
    wins, ties, games = (np.zeros((3, 3), np.int64) for _ in range(3))
    for g, (i, j) in enumerate(zip(ii, jj)):
        if jw[g] == 0:
            wins[i, j] += 1
        elif jw[g] == 1:
            wins[j, i] += 1
        else:
            ties[i, j] += 1
            ties[j, i] += 1
        games[i, j] += 1
        games[j, i] += 1
    for name, a, b in (("wins", wins, res.wins), ("ties", ties, res.ties),
                       ("games", games, res.games)):
        assert_eq(a, b, name)
    assert res.table() == JaxResult(list(names), wins, ties, games).table()
    assert wins.sum() > 0
