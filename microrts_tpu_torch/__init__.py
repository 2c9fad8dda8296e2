"""microrts_tpu_torch: the PyTorch + CUDA port of ``microrts_tpu``.

The batched gridnet RL step (RandomBiasedAI actors, decode, issue, cycle,
auto-reset) runs on ``[B, H, W]`` tensor planes.  Its four hot functions
are hand-written Hopper kernels (``kernels/csrc``); each has a plain
PyTorch version beside it, which serves CPU tensors and is the kernels'
oracle on the card.  The package imports neither JAX nor ``microrts_tpu``.
"""

from .engine.pgs import PhysicalGameState  # noqa: F401
from .engine.utt import UnitTypeTable  # noqa: F401
