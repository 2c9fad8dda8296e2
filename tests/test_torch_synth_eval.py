"""Synthesis's batched games (``synth/search.py``): the port's plain
``evaluate_population`` (the scores, and every lane's winner and final
state through its ``out``) against the JAX package's on melee4x4light2
(games end within the cut ``max_cycles``), WorkerRush and LightRush the
opponents and every program deterministic.  The JAX side follows
``evaluate_population`` line by line on jitted pieces
(``torch_synth_parity``); ``synthesize``, ``shrink_program`` and the
cleaner are held in test_torch_synth_search.py, _shrink.py and
_clean.py.  Tolerance: exact (scores are sums of halves)."""

import numpy as np
import pytest

from microrts_tpu_torch.synth import search as Sr
from microrts_tpu_torch.synth.dsl import (SEED_PROGRAM, Attack, Idle, If,
                                          NAllyOfType)

from torch_dsl_parity import to_jax
from torch_parity import (assert_eq, assert_state_eq,
                          torch_one_thread)  # noqa: F401
from torch_synth_parity import jax_evaluate_population, synth_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")

PROGRAMS = (SEED_PROGRAM, (Attack("All", "Weakest"),),
            (If(NAllyOfType("Light", 2, ">="), (Idle("All"),)),
             Attack("Light", "Strongest")))


def test_evaluate_population_matches_jax():
    jenv, jopp, env, opp = synth_pair()
    out = {}
    jf = jax_evaluate_population(jenv, [to_jax(p) for p in PROGRAMS], jopp,
                                 2, 48, 3, out)
    kout = {}
    f = Sr.evaluate_population(env, PROGRAMS, opp, 2, 48, 3, out=kout)
    np.testing.assert_array_equal(jf, f)
    assert_eq(out["winner"], kout["winner"], "winners")
    assert_state_eq(out["state"], kout["state"], "final states")
    assert (kout["winner"] >= 0).sum() >= 6
