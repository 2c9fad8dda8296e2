"""Shared helpers of the UTT v3 parity tests: the JAX and port envs under
``UnitTypeTable(3)``, JAX states carrying their keys, and the uniforms
JAX's ``cycle`` draws from a key (``uniform(split(key)[1], (H, W))``)."""

import numpy as np
import jax
import torch

from microrts_tpu.engine import types as JT
from microrts_tpu.engine.utt import UnitTypeTable as JUtt
from microrts_tpu.env.gridnet import GridnetEnv as JaxEnv
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.engine.types import state_to_numpy
from microrts_tpu_torch.engine.utt import UnitTypeTable
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

MELEE = "maps/melee4x4light2.xml"
BW8 = "maps/8x8/basesWorkers8x8.xml"


def v3_envs(map_rel, **kw):
    """(JAX env, port env on the CPU) under UTT v3."""
    return (JaxEnv(jax_asset_path(map_rel), JUtt(3), **kw),
            GridnetEnv(asset_path(map_rel), UnitTypeTable(3), device="cpu",
                       **kw))


def with_keys(s, keys):
    """A port State batch as a batched JAX State carrying ``keys``."""
    return JT.State(**{k: jax.numpy.asarray(v)
                       for k, v in state_to_numpy(s).items()}, key=keys)


_SPLIT = jax.jit(jax.vmap(lambda k: jax.random.split(k)))
_UNIFORM = {}


def cycle_u01(keys, h, w):
    """JAX ``cycle``'s draws: (the keys after the cycle, float32 ``[B, H,
    W]`` uniforms of ``split(key)[1]``)."""
    if (h, w) not in _UNIFORM:
        _UNIFORM[h, w] = jax.jit(jax.vmap(
            lambda k: jax.random.uniform(k, (h, w))))
    ks = _SPLIT(keys)
    return ks[:, 0], torch.from_numpy(np.array(_UNIFORM[h, w](ks[:, 1])))
