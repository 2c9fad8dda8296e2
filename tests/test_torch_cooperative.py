"""CooperativeAI (``bots.cooperative``, K14c's plain version) against the
JAX package's on the CPU, from JAX's own genomes (carried over with
``utils.checkpoint.learned_from_jax``).

The per-type nets are float32 matmuls (XLA's and PyTorch's, summed in
their own orders), and every later step is integer: a unit's action is
held equal where both its tile and its type logits' winner leads the
runner-up by at least 1e-6 of the winner's magnitude (at least 1e-6);
the units below that margin are counted and their smallest margin
printed.  The nets' outputs agree within 1e-4 absolute (rows of ~1,500
products of magnitude up to ~1).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import cooperative as JC
from microrts_tpu_torch.bots import cooperative as TC
from microrts_tpu_torch.utils.checkpoint import learned_from_jax

from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MARGIN = 1e-6
NET_ATOL = 1e-4


def _gap(x):
    x = x.double()
    top = x.amax(-1, keepdim=True)
    below = torch.where(x < top, x, float("-inf")).amax(-1)
    return top[..., 0] - below, top[..., 0]


@pytest.mark.parametrize("map_rel,seed", [
    ("maps/8x8/melee8x8Mixed6.xml", 0),
    ("maps/16x16/basesWorkers16x16.xml", 1)])
def test_actions_equal_jax_from_jax_genomes(map_rel, seed):
    """JAX's default genomes of ``seed`` (``jax.random.normal``), carried
    over: the nets' rows within 1e-4 and every held unit's action equal on
    recorded states, both players."""
    jenv, env, s = recorded(map_rel)
    T = env.cfg.engine.num_types
    G, dims = TC.cooperative_genome_spec(env)
    assert (G, dims) == JC.cooperative_genome_spec(jenv)
    jg = 0.1 * jax.random.normal(jax.random.PRNGKey(seed), (T, G))
    jbot = jax.jit(jax.vmap(JC.cooperative_bot(jenv, seed=seed),
                            in_axes=(0, None, None)))
    tg = learned_from_jax(jg, env)
    bot = TC.cooperative_bot(env, genomes=tg).bot
    js = jax_state(s)
    H, W = env.h, env.w
    held = skipped = acted = 0
    smallest = np.inf
    for p in (0, 1):
        want = np.asarray(jbot(js, p, jax.random.PRNGKey(0)))
        got = bot(s, p)
        nets = TC.cooperative_nets(env, s, p, tg, dims, 4)
        gt, tt = _gap(nets[..., :H * W])
        gy, ty = _gap(nets[..., H * W:])
        ok = ((gt >= MARGIN * tt.abs().clamp(min=1.0))
              & (gy >= MARGIN * ty.abs().clamp(min=1.0))).reshape(got.shape[:3])
        idle = (s.utype > 0) & (s.owner == p) & ~s.busy
        keep = ok | ~idle
        assert_eq(want[keep.numpy()], got[keep], f"p{p}")
        held += int((idle & ok).sum())
        skipped += int((idle & ~ok).sum())
        acted += int((got[..., 0] > 0).sum())
        if (idle & ~ok).any():
            smallest = min(smallest, float(torch.minimum(gt, gy).reshape(
                idle.shape)[idle & ~ok].min()))
    print(f"{map_rel}: {held} idle units held ({acted} act), {skipped} "
          f"under the margin (smallest gap {smallest})")
    assert held > 0 and acted > 0


def test_nets_equal_jax_and_default_genomes_seeded():
    """The per-type nets' output rows equal JAX's within 1e-4 (one state,
    player 0); the port's default genomes are ``0.1 * randn`` of a seeded
    CPU generator, the same on every call."""
    jenv, env, s = recorded("maps/8x8/melee8x8Mixed6.xml")
    T = env.cfg.engine.num_types
    G, dims = TC.cooperative_genome_spec(env)
    jg = 0.1 * jax.random.normal(jax.random.PRNGKey(2), (T, G))
    js = jax_state(s)
    H, W = env.h, env.w

    def jnets(st):
        from microrts_tpu.models.ssvd import logits_net
        t = jnp.clip(st.utype - 1, 0, T - 1).reshape(-1)
        obs = jenv.observation(st, 0).astype(jnp.float32).reshape(-1) / 10.0
        xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        pos = jnp.stack([xs.reshape(-1) / W, ys.reshape(-1) / H],
                        -1).astype(jnp.float32)
        cell_in = jnp.concatenate([
            jnp.broadcast_to(obs, (H * W,) + obs.shape), pos,
            jax.nn.one_hot(t, T)], -1)
        out = jnp.zeros((H * W, dims[-1]), jnp.float32)
        for ti in range(T):
            o_t = jax.vmap(lambda x: logits_net(jg[ti], x, dims, 4))(cell_in)
            out = jnp.where((t == ti)[:, None], o_t, out)
        return out
    want = np.asarray(jax.jit(jax.vmap(jnets))(js))
    got = TC.cooperative_nets(env, s, 0, learned_from_jax(jg, env), dims, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NET_ATOL)
    a, b = TC.default_genomes(env), TC.default_genomes(env)
    assert a.shape == (T, G) and torch.equal(a, b)
    assert not torch.equal(a, TC.default_genomes(env, seed=1))
