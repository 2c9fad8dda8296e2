"""microrts_tpu_torch: the PyTorch + CUDA port of ``microrts_tpu``.

The batched gridnet RL step (decode, issue, cycle, auto-reset), the
gridnet policy's rollout and PPO training against the scripted bots
(``train/run.py``) run on ``[B, H, W]`` tensor planes.  Their hot
functions are hand-written Hopper kernels (``kernels/csrc``); each has a
plain PyTorch version beside it, which serves CPU tensors and is the
kernels' oracle on the card.  The package imports neither JAX nor
``microrts_tpu``.
"""

from .engine.pgs import PhysicalGameState  # noqa: F401
from .engine.utt import UnitTypeTable  # noqa: F401
