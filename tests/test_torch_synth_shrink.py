"""Synthesis's fitness shrink: the port's plain ``shrink_program``
(PerformCleanerASTOptim) against the JAX package's own, run with the
line-by-line JAX ``evaluate_population`` of ``torch_synth_parity``
patched in, on melee4x4light2 against WorkerRush and LightRush: the same
program and removed edits.  Tolerance: exact."""

import pytest

from microrts_tpu.synth import clean as JC
from microrts_tpu_torch.synth import clean as C
from microrts_tpu_torch.synth.dsl import SEED_PROGRAM, Harvest, Idle

from torch_dsl_parity import to_jax
from torch_parity import torch_one_thread  # noqa: F401
from torch_synth_parity import jax_evaluate_population, synth_pair

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_shrink_program_matches_jax(monkeypatch):
    jenv, jopp, env, opp = synth_pair()
    monkeypatch.setattr(JC, "evaluate_population", jax_evaluate_population)
    prog = (Harvest(1), Idle("Heavy")) + SEED_PROGRAM[2:]
    jr = JC.shrink_program(jenv, to_jax(prog), jopp, games_per_pair=1,
                           max_cycles=32, seed=1, max_rounds=1)
    r = C.shrink_program(env, prog, opp, games_per_pair=1, max_cycles=32,
                         seed=1, max_rounds=1)
    assert to_jax(r.program) == jr.program and r.removed == jr.removed
    assert (r.nodes_before, r.nodes_after) == (jr.nodes_before,
                                               jr.nodes_after)
    assert r.nodes_after < r.nodes_before
