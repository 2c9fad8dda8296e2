"""The port as a whole: ``VecGridnetEnv`` + ``random_bot`` trajectories
with auto-resets on 8x8 maps against the JAX package (its own
``VecGridnetEnv.step`` code around jitted parts), and the package's import
isolation.  (The card tests are in test_torch_gpu.py.)  Tolerance: exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

from torch_parity import vec_trajectory

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("map_rel", [
    "maps/8x8/basesWorkers8x8.xml", "maps/8x8/basesWorkersBarracks8x8.xml",
    "maps/8x8/melee8x8Mixed6.xml"])
def test_vec_trajectory_8x8(map_rel):
    assert vec_trajectory(map_rel, batch=6, ticks=30, max_steps=10) > 0


def test_import_loads_no_jax():
    """The port imports torch only: neither jax, flax nor microrts_tpu."""
    code = ("import sys\n"
            "import microrts_tpu_torch, microrts_tpu_torch.kernels\n"
            "import microrts_tpu_torch.env.vec, microrts_tpu_torch.bots.scripted\n"
            "import microrts_tpu_torch.train.ppo, microrts_tpu_torch.profile_step\n"
            "import microrts_tpu_torch.train.run, microrts_tpu_torch.config\n"
            "import microrts_tpu_torch.utils.checkpoint\n"
            "import microrts_tpu_torch.ops.playout, microrts_tpu_torch.ops.evaluation\n"
            "import microrts_tpu_torch.bots.search, microrts_tpu_torch.eval.tournament\n"
            "import microrts_tpu_torch.ops.enumerate, microrts_tpu_torch.ops.branching\n"
            "import microrts_tpu_torch.bots.minimax\n"
            "import microrts_tpu_torch.engine.fog, microrts_tpu_torch.env.pool\n"
            "import microrts_tpu_torch.bots.believestate\n"
            "import microrts_tpu_torch.bots.treesearch\n"
            "import microrts_tpu_torch.env.expert, microrts_tpu_torch.synth.dsl\n"
            "import microrts_tpu_torch.synth.search, microrts_tpu_torch.synth.clean\n"
            "import microrts_tpu_torch.synth.export\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'microrts_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"))
