"""K9: the port's ``distance_field_plain`` and
``descend_direction_plain`` against the JAX package's ``distance_field``
and ``descend_direction`` (microrts_tpu/ops/fields.py), bit-equal, on
seeded random planes and on a serpentine 8x8 maze whose shortest paths
run longer than H + W: the JAX field is H + W synchronous sweeps, not a
converged BFS, so the far end of the maze stays INF, and the port must
keep it so.  The same for ``distance_field2_plain`` and
``descend_direction_excluding_plain`` (the nearest two distinct sources,
the DSL's closest-other-ally routing), on random planes, the maze and
JAX's two-nearest case.  The ``fields.cu`` and ``rush`` kernels are held
to these plain versions on the card."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.ops import fields as JF
from microrts_tpu_torch.engine.types import INF
from microrts_tpu_torch.ops.fields import (
    TIE_ORDER, descend_direction_excluding_plain, descend_direction_plain,
    distance_field, distance_field2_plain, distance_field_plain,
    distance_fields)

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


# ----------------------------------------------------------------------
# K9 rest: distance_field2 and descend_direction_excluding (the DSL's
# closest-other-ally routing), and the multi-field form

def _jax_fields2(src, pas, mov, self_id, iters):
    st = jax.vmap(lambda s, p: JF.distance_field2(s, p, iters))(
        jnp.asarray(src), jnp.asarray(pas))
    return st, jax.vmap(JF.descend_direction_excluding)(
        st, jnp.asarray(mov), jnp.asarray(self_id))


def _check2(src, pas, mov, iters, self_id=None):
    B, H, W = src.shape
    if self_id is None:
        self_id = np.broadcast_to(np.arange(H * W, dtype=np.int32)
                                  .reshape(H, W), (B, H, W)).copy()
    jst, jdir = _jax_fields2(src, pas, mov, self_id, iters)
    st = distance_field2_plain(torch.from_numpy(src), torch.from_numpy(pas),
                               iters)
    for name, a, b in zip(("d1", "i1", "d2", "i2"), jst, st):
        assert_eq(a, b, f"distance_field2 {name}")
    assert_eq(jdir, descend_direction_excluding_plain(
        st, torch.from_numpy(mov), torch.from_numpy(self_id)),
        "descend_direction_excluding")
    return [x.numpy() for x in st]


@pytest.mark.parametrize("hw,density", [((8, 8), 0.05), ((8, 8), 0.3),
                                        ((5, 9), 0.15), ((16, 16), 0.08)])
def test_fields2_match_jax_on_random_planes(hw, density):
    H, W = hw
    rng = np.random.default_rng(H * 31 + W + int(density * 100))
    B = 6
    src = rng.random((B, H, W)) < density
    pas = rng.random((B, H, W)) < 0.75
    src[0] = False
    src[1, 0, 0] = True
    pas[1, 0, 0] = False
    mov = rng.random((B, H, W, 4)) < 0.8
    d1, i1, d2, i2 = _check2(src, pas, mov, H + W)
    # some cell holds two distinct sources, and a random self id too
    assert ((i1 >= 0) & (i2 >= 0)).any()
    sid = rng.integers(-1, H * W, (B, H, W)).astype(np.int32)
    _check2(src, pas, mov, H + W, sid)


def test_fields2_match_jax_on_the_maze():
    src, pas = _serpentine()
    src[7, 0] = True                    # a second source at the far end
    mov = np.ones((1, 8, 8, 4), bool)
    d1, i1, d2, i2 = _check2(src[None], pas[None], mov, 16)
    assert d1[0, 2, 0] == 16 and d1[0, 6, 0] == 1 and i1[0, 6, 0] == 56
    assert d2[0, 0, 0] == INF           # the other source: cut at 16 sweeps
    full = _check2(src[None], pas[None], mov, 64)
    assert 16 < full[2][0, 0, 0] < INF and full[3][0, 0, 0] == 56


def test_fields2_two_nearest_case():
    """JAX's two-nearest-distinct case (tests/test_synth.py:196)."""
    H = W = 6
    src = np.zeros((1, H, W), bool)
    src[0, 0, 0] = src[0, 0, 3] = src[0, 5, 5] = True
    pas = np.ones((1, H, W), bool)
    mov = np.ones((1, H, W, 4), bool)
    d1, i1, d2, i2 = [x[0] for x in _check2(src, pas, mov, H + W)]
    assert d1[0, 0] == 0 and i1[0, 0] == 0 and d2[0, 0] == 3
    assert d1[0, 2] == 1 and i1[0, 2] == 3 and d2[0, 2] == 2
    assert i2[0, 2] == 0


@pytest.mark.parametrize("F", [1, 3])
def test_distance_fields_is_each_field(F):
    rng = np.random.default_rng(F)
    src = torch.from_numpy(rng.random((4, F, 8, 8)) < 0.1)
    pas = torch.from_numpy(rng.random((4, 8, 8)) < 0.7)
    got = distance_fields(src, pas, 16)
    for f in range(F):
        assert torch.equal(got[:, f], distance_field_plain(src[:, f], pas,
                                                           16))
    assert torch.equal(distance_field(src[:, 0], pas, 16), got[:, 0])
