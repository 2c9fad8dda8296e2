"""Synthesis's search: the port's plain 2-generation ``synthesize``
(population 3, ``random.Random(0)``'s mutations, none reading noise)
against the JAX package's own, run with the line-by-line JAX
``evaluate_population`` of ``torch_synth_parity`` patched in, on
melee4x4light2 against WorkerRush and LightRush (see
test_torch_synth_eval.py): the same program, fitness and history.
Tolerance: exact."""

import pytest

from microrts_tpu.synth import search as JSr
from microrts_tpu_torch.synth import search as Sr

from torch_dsl_parity import to_jax
from torch_parity import torch_one_thread  # noqa: F401
from torch_synth_parity import jax_evaluate_population, synth_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_synthesize_matches_jax(monkeypatch):
    jenv, jopp, env, opp = synth_pair()
    monkeypatch.setattr(JSr, "evaluate_population", jax_evaluate_population)
    jr = JSr.synthesize(jenv, jopp, generations=2, population=3,
                        games_per_pair=1, max_cycles=40, seed=0)
    r = Sr.synthesize(env, opp, generations=2, population=3,
                      games_per_pair=1, max_cycles=40, seed=0)
    assert to_jax(r.program) == jr.program
    assert r.fitness == jr.fitness and r.history == jr.history
