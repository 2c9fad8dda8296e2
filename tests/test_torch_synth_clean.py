"""Synthesis's behavioral cleaner: the port's plain ``probe_states``,
``mismatch_counts`` and ``clean_program`` (PerformCleanerAST) against
the JAX package's on melee4x4light2 against WorkerRush and LightRush;
JAX's probes and mismatch counts follow clean.py line by line on jitted
pieces (``torch_synth_parity``), and JAX's own ``clean_program`` runs
with them patched in.  Tolerance: exact."""

import numpy as np
import pytest

from microrts_tpu.synth import clean as JC
from microrts_tpu_torch.synth import clean as C
from microrts_tpu_torch.synth.dsl import SEED_PROGRAM, Idle

from torch_dsl_parity import to_jax
from torch_parity import (assert_eq, assert_state_eq,
                          torch_one_thread)  # noqa: F401
from torch_synth_parity import (jax_mismatch_counts, jax_probe_states,
                                synth_pair)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_probes_mismatch_counts_and_clean_program_match_jax(monkeypatch):
    """``probe_states`` (the probes' states and seats), ``mismatch_counts``
    over the single-edit neighbourhood and ``clean_program`` (JAX's own,
    with its probe and mismatch pieces on jitted parts)."""
    jenv, jopp, env, opp = synth_pair()
    prog = SEED_PROGRAM + (Idle("Heavy"),)
    js, jseats, jkeys = jax_probe_states(jenv, to_jax(prog), jopp, 4, 5, 2)
    s, seats, noise = C.probe_states(env, prog, opp, 4, 5, 2)
    assert_state_eq(js, s, "probe states")
    assert_eq(jseats, seats, "probe seats")
    cands = [p for _, p in C.edit_candidates(prog)]
    counts = C.mismatch_counts(env, prog, cands, s, seats, noise)
    np.testing.assert_array_equal(counts, jax_mismatch_counts(
        jenv, to_jax(prog), [to_jax(p) for p in cands], js, jseats, jkeys))
    assert (counts == 0).any() and (counts > 0).any()
    monkeypatch.setattr(JC, "probe_states", jax_probe_states)
    monkeypatch.setattr(JC, "mismatch_counts", jax_mismatch_counts)
    jr = JC.clean_program(jenv, to_jax(prog), jopp, 4, 5, 2)
    r = C.clean_program(env, prog, opp, 4, 5, 2)
    assert to_jax(r.program) == jr.program and r.removed == jr.removed
    assert r.nodes_after < r.nodes_before
