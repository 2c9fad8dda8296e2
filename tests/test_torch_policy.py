"""The port's gridnet policy (``microrts_tpu_torch.models.gridnet_policy``,
on the CPU) vs the JAX package's, on the same seed-made numpy inputs.

* ``params_from_flax`` + the forward at the published width (64, 4 blocks)
  on 8x8 and 16x16 observations, elementwise on logits and value.  The
  flax parameters get random biases first, so the bias layout is checked
  too.  Tolerances: fp32 model 1e-4 absolute (summation order of the
  convolutions); bf16 model 2e-2 absolute on logits and value, which are
  of order 1 (bf16 keeps about 3 significant digits, and XLA and oneDNN
  may round the 9 convolutions at different places; 3.8e-3 was the
  largest difference seen).
* ``sample_action_plain`` / ``greedy_action_plain`` against JAX's
  ``sample_action`` / ``greedy_action`` with JAX-drawn gumbels: actions
  exact, logprob and entropy within 1e-5 (relative and absolute); the
  inputs hold components with no legal class and cells that cannot act.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.models import gridnet_policy as JP
from microrts_tpu_torch import kernels as KN
from microrts_tpu_torch.models.gridnet_policy import (
    ActionSpace, GridnetPolicy, greedy_action, greedy_action_plain,
    gumbel_noise, params_from_flax, sample_action, sample_action_plain)

T, DIAM = 7, 7               # UTT v2 (7 types), attack range 3
SPACE = ActionSpace(T, DIAM)
JSPACE = JP.ActionSpace(T, DIAM)
C = 20 + T                   # one-hot observation width


def _flax_params(model, obs, seed):
    """flax init, then every bias replaced by seeded noise."""
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(obs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
                         if path[-1].key == "bias" else a), params)


def _obs(rng, b, h, w):
    return (rng.random((b, h, w, C)) < 0.3).astype(np.float32)


_FWD = {}


def _jax_forward(dtype):
    if dtype not in _FWD:
        model = JP.GridnetPolicy(JSPACE, dtype=dtype)
        _FWD[dtype] = (model, jax.jit(model.apply))
    return _FWD[dtype]


@pytest.mark.parametrize("hw,b", [(8, 4), (16, 2)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_matches_flax(hw, b, dtype, tol):
    rng = np.random.default_rng(hw)
    obs = _obs(rng, b, hw, hw)
    model, apply = _jax_forward(getattr(jnp, dtype))
    params = _flax_params(model, obs, seed=hw)
    jl, jv = apply(params, jnp.asarray(obs))
    net = GridnetPolicy(SPACE, C, dtype=getattr(torch, dtype))
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        tl, tv = net(torch.from_numpy(obs))
    assert tl.shape == (b, hw, hw, SPACE.total) and tl.dtype == torch.float32
    assert tv.shape == (b,) and tv.dtype == torch.float32
    assert tl.is_contiguous()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol)
    # not a summary match: the logits vary across cells and channels
    assert np.asarray(jl).std() > 0.2


def test_init_params_is_seeded():
    a = GridnetPolicy(SPACE, C).init_params(torch.Generator().manual_seed(3))
    b = GridnetPolicy(SPACE, C).init_params(torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    assert a.conv0.weight.std() > 0 and (a.conv0.bias == 0).all()


# ----------------------------------------------------------------------
# masked factored sampling

B, H, W = 3, 6, 5


def _inputs(seed):
    """Logits, the env's int32 mask [.., 1+A] and the JAX bool mask
    [.., A], with all-false components and cells that cannot act."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, H, W, SPACE.total)).astype(np.float32)
    m = rng.random((B, H, W, SPACE.total)) < 0.4
    m[0, 0, 0, :] = False                      # no legal class anywhere
    m[0, 1, :, 6:10] = False                   # move component all-false
    m[1, 2, 3, 71:] = False                    # attack component all-false
    m[2, :, 0, :6] = False                     # cannot act (type bits off)
    env_mask = np.concatenate(
        [m[..., :6].any(-1, keepdims=True), m], -1).astype(np.int32)
    return logits, env_mask, m


_SAMPLE = {}


def _jax_sample():
    if not _SAMPLE:
        sizes = JSPACE.sizes

        def gumbels(key):
            ks = jax.random.split(key, 7)
            return jnp.concatenate([jax.random.gumbel(k, (H, W, s))
                                    for k, s in zip(ks, sizes)], -1)

        _SAMPLE.update(
            sample=jax.jit(jax.vmap(lambda k, l, m: JP.sample_action(
                k, l, m, JSPACE))),
            greedy=jax.jit(jax.vmap(lambda l, m: JP.greedy_action(
                l, m, JSPACE))),
            gumbels=jax.jit(jax.vmap(gumbels)))
    return _SAMPLE


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_action_matches_jax(seed):
    logits, env_mask, m = _inputs(seed)
    f = _jax_sample()
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    ja, jlp, jent = f["sample"](keys, jnp.asarray(logits), jnp.asarray(m))
    g = np.asarray(f["gumbels"](keys))
    # the replicated gumbels reproduce JAX's draw: argmax(masked + g)
    masked = []
    for lg, mk in zip(JP.split_components(logits, JSPACE),
                      JP.split_components(m, JSPACE)):
        has = mk.any(-1, keepdims=True)
        masked.append(np.where(mk | ~has, lg, np.float32(-1e9)))
    keyed = [x + y for x, y in zip(masked, JP.split_components(g, JSPACE))]
    np.testing.assert_array_equal(
        np.stack([k.argmax(-1) for k in keyed], -1), np.asarray(ja))

    ta, tlp, tent, tenv = sample_action_plain(
        torch.from_numpy(logits), torch.from_numpy(env_mask), SPACE,
        torch.from_numpy(g.copy()))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), rtol=1e-5,
                               atol=1e-5)
    can_act = m[..., :6].any(-1)
    assert (~can_act).any() and can_act.any()
    np.testing.assert_allclose(
        tenv.numpy(), np.where(can_act, np.asarray(jlp), 0).sum((1, 2)),
        rtol=1e-5, atol=1e-5)
    # the dispatcher takes the plain version for CPU tensors
    da = sample_action(torch.from_numpy(logits), torch.from_numpy(env_mask),
                       SPACE, torch.from_numpy(g.copy()))[0]
    assert torch.equal(da, ta)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_action_matches_jax(seed):
    logits, env_mask, m = _inputs(seed)
    ja = _jax_sample()["greedy"](jnp.asarray(logits), jnp.asarray(m))
    ta = greedy_action_plain(torch.from_numpy(logits),
                             torch.from_numpy(env_mask), SPACE)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert torch.equal(greedy_action(torch.from_numpy(logits),
                                     torch.from_numpy(env_mask), SPACE), ta)


def test_sample_kernel_refuses_cpu_tensors():
    logits, env_mask, _ = _inputs(0)
    with pytest.raises(ValueError):
        KN.SAMPLE(SPACE.sizes, torch.from_numpy(logits),
                  torch.from_numpy(env_mask))


def test_gumbel_noise():
    g1 = gumbel_noise((4, 5, 78), torch.Generator().manual_seed(0), "cpu")
    g2 = gumbel_noise((4, 5, 78), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
    # Gumbel(0, 1): mean is the Euler-Mascheroni constant
    assert abs(float(g1.mean()) - 0.5772) < 0.1
