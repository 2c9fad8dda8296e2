"""Synthesis's host side against the JAX package: ``random_command``,
``random_cond``, ``random_program`` and ``mutate`` give the same
programs for the same ``random.Random`` seed; ``node_count`` and
``edit_candidates`` agree; ``export.dumps`` texts are equal and each
package ``loads`` the other's; ``to_module`` emits a module importing
the port, whose ``make(env)`` acts as ``compile_program``; and the CLI
(``python -m microrts_tpu_torch.synth``) runs with ``--cpu``."""

import importlib.util
import random

import pytest
import torch

from microrts_tpu.synth import clean as JC
from microrts_tpu.synth import export as JX
from microrts_tpu.synth import search as JSr
from microrts_tpu_torch.synth import clean as C
from microrts_tpu_torch.synth import export as X
from microrts_tpu_torch.synth import search as Sr
from microrts_tpu_torch.synth.dsl import (SEED_PROGRAM, Attack, For, Harvest,
                                          Idle, If, NAllyOfType,
                                          compile_program)

from torch_dsl_parity import to_jax
from torch_parity import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("seed", range(6))
def test_generators_match_jax(seed):
    r, jr = random.Random(seed), random.Random(seed)
    for _ in range(8):
        assert to_jax(Sr.random_command(r, hw=(8, 8))) == \
            JSr.random_command(jr, hw=(8, 8))
        assert to_jax(Sr.random_cond(r)) == JSr.random_cond(jr)
    prog, jprog = Sr.random_program(r), JSr.random_program(jr)
    assert to_jax(prog) == jprog
    for _ in range(12):
        prog, jprog = Sr.mutate(prog, r), JSr.mutate(jprog, jr)
        assert to_jax(prog) == jprog
    assert r.random() == jr.random()


def test_edit_candidates_and_node_count_match_jax():
    progs = [SEED_PROGRAM,
             SEED_PROGRAM + (If(NAllyOfType("Worker", 3, ">="),
                                (Idle("Worker"), Harvest(2))),
                             For(2, (Attack("Light", "Weakest"),)),
                             For(1, (Harvest(1),)))]
    progs += [Sr.random_program(random.Random(s)) for s in range(6)]
    for p in progs:
        assert C.node_count(p) == JC.node_count(to_jax(p))
        got = C.edit_candidates(p)
        want = JC.edit_candidates(to_jax(p))
        assert [(lab, to_jax(q)) for lab, q in got] == want


def test_dumps_equal_and_cross_loads():
    progs = [SEED_PROGRAM] + [Sr.random_program(random.Random(s))
                              for s in range(8)]
    for p in progs:
        text = X.dumps(p)
        assert text == JX.dumps(to_jax(p))
        assert X.loads(text) == p
        assert JX.loads(text) == to_jax(p)
    with pytest.raises(Exception):
        X.loads("__import__('os').system('true')")


def test_to_module_imports_the_port(tmp_path):
    from microrts_tpu_torch.env.gridnet import GridnetEnv
    from microrts_tpu_torch.utils.assets import asset_path
    prog = SEED_PROGRAM + (If(NAllyOfType("Worker", 3, ">="),
                              (Idle("Worker"),)),)
    X.save_program(prog, str(tmp_path / "p.dslprog"))
    assert X.load_program(str(tmp_path / "p.dslprog")) == prog
    src = X.to_module(prog, "test")
    assert "from microrts_tpu_torch.synth.dsl import" in src
    assert "microrts_tpu." not in src.replace("microrts_tpu_torch", "")
    mp = tmp_path / "synthmod.py"
    mp.write_text(src)
    spec = importlib.util.spec_from_file_location("synthmod", mp)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PROGRAM == prog
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"),
                     device="cpu")
    s = env.reset(2)
    assert torch.equal(mod.make(env)(s, 0), compile_program(env, prog)(s, 0))


def test_cli_cpu(tmp_path, capsys):
    from microrts_tpu_torch.synth.__main__ import main
    out = tmp_path / "w.dslprog"
    assert main(["--map", "maps/8x8/basesWorkers8x8.xml", "--opponents",
                 "WorkerRush", "--generations", "1", "--population", "2",
                 "--games-per-pair", "1", "--max-cycles", "12", "--clean",
                 "fitness", "--cpu", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "search: fitness" in text and "clean(fitness)" in text
    # every 12-cycle game is a draw, so the fitness shrink drops every
    # command; ``dumps`` of the empty program is "(\n ,\n)" in both
    # packages, which ``loads`` refuses
    assert out.read_text() == JX.dumps(())
    assert main(["--map", "maps/8x8/basesWorkers8x8.xml", "--generations",
                 "1", "--population", "1", "--games-per-pair", "1",
                 "--max-cycles", "4", "--clean", "none", "--cpu"]) == 0
    assert X.loads(capsys.readouterr().out.split("\n", 1)[1]) == SEED_PROGRAM
