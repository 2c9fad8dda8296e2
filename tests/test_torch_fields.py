"""K9 (the part the rush bots use): the port's ``distance_field_plain`` and
``descend_direction_plain`` against the JAX package's ``distance_field``
and ``descend_direction`` (microrts_tpu/ops/fields.py), bit-equal, on
seeded random planes and on a serpentine 8x8 maze whose shortest paths
run longer than H + W: the JAX field is H + W synchronous sweeps, not a
converged BFS, so the far end of the maze stays INF, and the port must
keep it so.  The ``rush`` kernel's own sweeps are held to these plain
versions on the card."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.ops import fields as JF
from microrts_tpu_torch.engine.types import INF
from microrts_tpu_torch.ops.fields import (TIE_ORDER, descend_direction_plain,
                                           distance_field_plain)

from torch_parity import torch_one_thread, assert_eq

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _jax_fields(src, pas, mov, iters):
    d = jax.vmap(lambda s, p: JF.distance_field(s, p, iters))(
        jnp.asarray(src), jnp.asarray(pas))
    return d, jax.vmap(JF.descend_direction)(d, jnp.asarray(mov))


def _check(src, pas, mov, iters):
    jd, jdir = _jax_fields(src, pas, mov, iters)
    d = distance_field_plain(torch.from_numpy(src), torch.from_numpy(pas),
                             iters)
    assert_eq(jd, d, "distance_field")
    assert_eq(jdir, descend_direction_plain(d, torch.from_numpy(mov)),
              "descend_direction")
    return d.numpy()


@pytest.mark.parametrize("hw", [(8, 8), (5, 9), (16, 16)])
def test_fields_match_jax_on_random_planes(hw):
    H, W = hw
    rng = np.random.default_rng(H * 100 + W)
    B = 6
    src = rng.random((B, H, W)) < 0.05
    pas = rng.random((B, H, W)) < 0.75
    src[0] = False                      # no source at all: every cell INF
    src[1, 0, 0] = True
    pas[1, 0, 0] = False                # a source that cannot be walked
    mov = rng.random((B, H, W, 4)) < 0.8
    d = _check(src, pas, mov, H + W)
    assert (d[0] == INF).all()
    assert d[1, 0, 0] == 0
    assert ((d > 0) & (d < INF)).any()
    assert TIE_ORDER == JF.TIE_ORDER


def _serpentine():
    """8x8: walls on rows 1, 3 and 5 with one gap at alternating ends; the
    source in the top-left corner."""
    pas = np.ones((8, 8), bool)
    for row, gap in ((1, 7), (3, 0), (5, 7)):
        pas[row] = False
        pas[row, gap] = True
    src = np.zeros((8, 8), bool)
    src[0, 0] = True
    return src, pas


def test_fields_match_jax_on_a_maze_longer_than_h_plus_w():
    src, pas = _serpentine()
    mov = np.ones((1, 8, 8, 4), bool)
    d = _check(src[None], pas[None], mov, 16)[0]
    # the row-0 corridor, the first gap and row 2 are within 16 steps;
    # the end of the maze (34 steps along the corridor) is not
    assert d[0, 7] == 7 and d[2, 7] == 9 and d[2, 0] == 16
    assert d[4, 0] == INF and d[7, 7] == INF
    # with enough sweeps the whole corridor is reached
    full = _check(src[None], pas[None], mov, 64)[0]
    assert full[7, 0] < INF and full[7, 0] > 16
    assert (full[pas] < INF).all()
