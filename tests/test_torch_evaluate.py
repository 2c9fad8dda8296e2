"""``evaluate`` (train/run.py, JAX train/run.py:95): the win-rate of a
seeded fp32 policy (width 16, one block) sampled with JAX's gumbel draws
against WorkerRush on basesWorkers8x8, four games at ``max_cycles`` 300,
equal to the JAX package's, game by game.

JAX's own ``evaluate`` runs with its ``play_matches`` replaced by the
line-by-line game loop of tests/torch_tournament_parity.py (the whole one
compiles for minutes of CPU); the port's ``evaluate`` takes the same
per-frame draws as its ``noise`` source, and its ``play_matches`` is
wrapped to read the winners."""

import numpy as np
import pytest
import jax

from microrts_tpu.eval import tournament as JTN
from microrts_tpu.train.run import evaluate as jax_evaluate
from microrts_tpu_torch.config import make_bot
from microrts_tpu_torch.eval import tournament as TN
from microrts_tpu_torch.train import run

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)
from torch_rollout_parity import jax_opponent, trainer_pair
from torch_tournament_parity import jax_bot_games, named_bot

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"
CAP, N = 300, 4


def test_evaluate_matches_jax(monkeypatch):
    jtr, jts, tr, _ = trainer_pair(MAP, N, 4, "WorkerRush", "sgd", seed=3)
    jax_side, port_side = {}, {}

    def jax_games(env, bot0, bot1, n_games, max_cycles):
        """JAX's play_matches (seed 0) as the line-by-line loop."""
        z = np.zeros(n_games, np.int64)
        keys = jax.random.split(jax.random.PRNGKey(0), n_games)
        w, _, noise = jax_bot_games(
            env, [(jax.jit(jax.vmap(bot0, in_axes=(0, None, 0))), "gumbel"),
                  named_bot(env, "WorkerRush")], z, z + 1, keys, max_cycles)
        jax_side.update(w=w, noise=noise)
        return w

    real = TN.play_matches

    def port_games(*a, **k):
        port_side["w"] = real(*a, **k)
        return port_side["w"]

    monkeypatch.setattr(JTN, "play_matches", jax_games)
    jrate = jax_evaluate(jtr, jts, jax_opponent("WorkerRush", jtr.env), N,
                         CAP)
    monkeypatch.setattr(TN, "play_matches", port_games)
    rate = run.evaluate(tr, make_bot("WorkerRush", tr.env), N, CAP,
                        noise=jax_side["noise"])
    assert rate == jrate
    np.testing.assert_array_equal(port_side["w"], jax_side["w"])
    assert (port_side["w"] == 1).any()
