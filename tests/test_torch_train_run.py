"""The port's training CLI (``python -m microrts_tpu_torch.train.run``)
on the CPU at a tiny size, with ``--eval-every`` (``evaluate`` against
JAX's is in test_torch_evaluate.py), and its checkpoints against the JAX
package's: a checkpoint from either package loads in the other and gives
the same logits (fp32 model: 1e-5 absolute, float32 sums in another
order)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.models import gridnet_policy as JP
from microrts_tpu.utils.checkpoint import load_pytree, save_pytree
from microrts_tpu_torch.models.gridnet_policy import (ActionSpace,
                                                      GridnetPolicy)
from microrts_tpu_torch.train import run
from microrts_tpu_torch.utils.checkpoint import load_params, save_params

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP = "maps/8x8/basesWorkers8x8.xml"
ARGS = ["--cpu", "--map", MAP, "--num-envs", "4", "--rollout-len", "4"]


def test_run_prints_its_update_line_and_round_trips_a_checkpoint(
        tmp_path, capsys):
    ck = str(tmp_path / "p.npz")
    trainer, ts = run.main(ARGS + ["--updates", "2", "--ckpt", ck,
                                   "--ckpt-every", "1"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("update")]
    assert len(lines) == 2 and "params saved" in out
    for ln in lines:
        for word in ("reward/step", "episodes", "wins", "entropy", "ratio",
                     "env-steps/s"):
            assert word in ln
    assert ts.update_count == 2
    trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    # --resume (and no update): the saved parameters
    trainer2, _ = run.main(ARGS + ["--updates", "0", "--resume", ck])
    assert "resumed params" in capsys.readouterr().out
    for k, v in trainer2.model.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_run_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 14"):
        run.main(ARGS + ["--sharded"])
    with pytest.raises(NotImplementedError, match="item 10"):
        run.main(ARGS + ["--opponent", "PortfolioAI"])
    # a stateful bot keeps memory across frames, which the trainer does
    # not carry for its opponent
    for name in ("ContinuingNaiveMCTS", "ai.mcts.believestatemcts."
                 "BS3_NaiveMCTS"):
        with pytest.raises(ValueError, match="stateful"):
            run.main(ARGS + ["--opponent", name])
    # the learned models (item 11) are ported: no longer refused
    _, ts = run.main(ARGS + ["--updates", "1", "--opponent",
                             "UnitActionProbabilityDistributionAI"])
    assert ts.update_count == 1


def test_run_without_cpu_flag_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--map", MAP, "--updates", "1"])


def test_run_with_eval_every_without_cpu_flag_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--map", MAP, "--updates", "1", "--eval-every", "1",
                  "--eval-games", "2"])


def test_run_evaluates_every_update(capsys):
    run.main(ARGS + ["--updates", "1", "--eval-every", "1", "--eval-games",
                     "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "eval: win-rate" in ln]
    assert len(lines) == 1 and lines[0].endswith("vs WorkerRush"), out
    assert 0.0 <= float(lines[0].split()[2]) <= 1.0


def _models(seed=0):
    space = JP.ActionSpace(7, 7)
    jm = JP.GridnetPolicy(space, width=16, blocks=2, dtype=jnp.float32)
    obs = np.random.default_rng(seed).random((2, 8, 8, 27), dtype=np.float32)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.asarray(obs))
    tm = GridnetPolicy(ActionSpace(7, 7), 27, width=16, blocks=2,
                       dtype=torch.float32)
    return jm, jp, tm, obs


def test_checkpoints_cross_between_the_packages(tmp_path):
    jm, jp, tm, obs = _models()
    # JAX -> port
    save_pytree(str(tmp_path / "j.npz"), jp)
    load_params(str(tmp_path / "j.npz"), tm)
    jl, jv = jm.apply(jp, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = tm(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    # port -> JAX (after a change of the port's parameters)
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(0.5).add_(0.01)
        tl, _ = tm(torch.from_numpy(obs))
    save_params(str(tmp_path / "t.npz"), tm)
    jp2 = load_pytree(str(tmp_path / "t.npz"), jp)
    jl2, _ = jm.apply(jp2, jnp.asarray(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl2), atol=1e-5)
    # leaf for leaf, the two files hold the same arrays
    save_pytree(str(tmp_path / "j2.npz"), jp2)
    a, b = np.load(tmp_path / "j2.npz"), np.load(tmp_path / "t.npz")
    n = len(jax.tree.leaves(jp))
    for i in range(n):
        np.testing.assert_array_equal(a[f"leaf_{i}"], b[f"leaf_{i}"])
