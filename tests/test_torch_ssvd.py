"""The SSVD codec and learned evaluation (``models.ssvd``) against the JAX
package's on the CPU: the same seeded genomes and inputs.

Tolerance: the decoded weights are products ``(U * s) @ V.T`` of normal
draws summed over the rank (up to 8 terms of magnitude up to ~3, an ulp
2.4e-7 each) in float32 by XLA and by PyTorch in their own orders, so a
cancelling sum differs by a few ulps of its terms: 1e-6 relative + 1e-6
absolute; the nets' outputs are float32 dot products over
hundreds of inputs: 2e-5 relative + 2e-6 absolute.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.models import ssvd as JS
from microrts_tpu_torch.models import ssvd as TS

from torch_parity import jax_state, torch_one_thread  # noqa: F401
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

DIMS = [(40, 16, 1), (12, 8, 5, 3)]
W_TOL = dict(rtol=1e-6, atol=1e-6)
NET_TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("rank", [2, 8])
def test_decode_and_nets_equal_jax(dims, rank):
    assert TS.ssvd_shapes(dims, rank) == JS.ssvd_shapes(dims, rank)
    G = TS.genome_size(dims, rank)
    assert G == JS.genome_size(dims, rank)
    rng = np.random.default_rng(rank)
    genome = rng.normal(size=G).astype(np.float32)
    x = rng.normal(size=(7, dims[0])).astype(np.float32)
    jl = JS.decode(jnp.asarray(genome), dims, rank)
    tl = TS.decode(torch.from_numpy(genome), dims, rank)
    for (jw, jb), (tw, tb) in zip(jl, tl):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **W_TOL)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    je = jax.vmap(lambda v: JS.eval_net(jnp.asarray(genome), v, dims,
                                        rank))(jnp.asarray(x))
    np.testing.assert_allclose(
        TS.eval_net(torch.from_numpy(genome), torch.from_numpy(x), dims,
                    rank).numpy(), np.asarray(je), **NET_TOL)
    jo = JS.logits_net(jnp.asarray(genome), jnp.asarray(x), dims, rank)
    np.testing.assert_allclose(
        TS.logits_net(torch.from_numpy(genome), torch.from_numpy(x), dims,
                      rank).numpy(), np.asarray(jo), **NET_TOL)


def test_learned_eval_equals_jax_on_recorded_states():
    """``make_learned_eval``'s values on recorded 8x8 states, both
    players: the flattened one-hot observation through a seeded genome."""
    jenv, env, s = recorded("maps/8x8/basesWorkers8x8.xml")
    G = TS.make_learned_eval(env, torch.zeros(1))[1]
    genome = (0.3 * np.random.default_rng(0).normal(size=G)).astype(
        np.float32)
    jfn, jG = JS.make_learned_eval(jenv, jnp.asarray(genome))
    tfn, tG = TS.make_learned_eval(env, torch.from_numpy(genome))
    assert jG == tG == G
    js = jax_state(s)
    jit = jax.jit(jax.vmap(jfn, in_axes=(0, None)))
    for p in (0, 1):
        np.testing.assert_allclose(tfn(s, p).numpy(),
                                   np.asarray(jit(js, p)), **NET_TOL)
