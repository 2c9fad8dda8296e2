"""``naive_sampling_bot`` and ``uct_bot`` (bots/search.py): the port's
plain path against the JAX package's, for both players.

Naive sampling's actions are held equal.  UCT's UCB1 takes a ``log`` and
a ``sqrt``, which XLA and PyTorch may round an ulp apart: its actions are
held equal in every game where no round chose its arm within 1e-6 of an
arm with other statistics (the test reads those margins off each round's
UCB1 values, by wrapping ``search.ucb1``; arms with the same statistics
tie exactly and the first wins in both), and at least one game must be
held.

JAX's bots run eagerly under ``vmap`` around the env's jitted parts and a
jitted RandomBiasedAI (tests/torch_search_parity.py); the port takes every
uniform JAX's key tree draws (the fields of ``MCNoise``, ``NaiveNoise``,
``UCTNoise``).  The games are recorded 8x8 states of RandomBiasedAI
self-play in which both players have idle units; the budget is small
(``playout_len`` 8: two decisions per playout)."""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.bots import search as JSE
from microrts_tpu_torch.bots import search as SE

from torch_parity import torch_one_thread, assert_eq, jax_state
from torch_search_parity import (L, N_DEC, games, jax_bot, naive_noise,
                                 uct_noise)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

UCT_MARGIN = 1e-6


def test_naive_sampling_bot_matches_jax():
    jenv, env, s = games()
    R = 3
    jbot = jax_bot(JSE.naive_sampling_bot, jenv, n_rounds=R)
    bot = SE.naive_sampling_bot(env, n_rounds=R, playout_len=L,
                                n_decisions=N_DEC)
    js = jax_state(s)
    for p in (0, 1):
        keys = jax.random.split(jax.random.PRNGKey(20 + p), s.batch)
        want = jbot(js, p, keys)
        got = bot(s, p, naive_noise(keys, R, env.h, env.w))
        assert_eq(want, got, f"naive_sampling_bot p{p}")


def _margin(visits, values, ucb):
    """Per game, the gap between the chosen arm's UCB1 value and the
    largest of the arms whose statistics differ from its own (inf when
    the chosen value is infinite or no arm differs)."""
    rows = torch.arange(ucb.shape[0])
    arm = ucb.argmax(1)
    same = ((visits == visits[rows, arm, None])
            & (values == values[rows, arm, None]))
    best = ucb[rows, arm]
    gap = best - torch.where(same, float("-inf"), ucb).amax(1)
    return torch.where(torch.isinf(best), float("inf"), gap)


def test_uct_bot_matches_jax_under_the_margin_rule(monkeypatch):
    jenv, env, s = games()
    K, R = 3, 5
    jbot = jax_bot(JSE.uct_bot, jenv, n_candidates=K, n_rounds=R)
    held = 0
    js = jax_state(s)
    ucb1 = SE.ucb1
    for p in (0, 1):
        margins = []

        def recording_ucb1(visits, values, c_uct):
            ucb = ucb1(visits, values, c_uct)
            margins.append(_margin(visits, values, ucb))
            return ucb

        monkeypatch.setattr(SE, "ucb1", recording_ucb1)
        bot = SE.uct_bot(env, n_candidates=K, n_rounds=R, playout_len=L,
                         n_decisions=N_DEC)
        keys = jax.random.split(jax.random.PRNGKey(30 + p), s.batch)
        want = jbot(js, p, keys)
        got = bot(s, p, uct_noise(keys, K, R, env.h, env.w)).numpy()
        assert len(margins) == R
        close = (torch.stack(margins).amin(0) < UCT_MARGIN).numpy()
        for g in np.flatnonzero(~close):
            assert_eq(want[g], got[g], f"uct_bot p{p} game {g}")
        held += int((~close).sum())
    assert held > 0
