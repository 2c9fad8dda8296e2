"""K7b: the port's ``action_logprob`` (plain path on the CPU) and its
gradient against the JAX package's ``action_logprob`` and ``jax.grad``.

Inputs are made with numpy from a seed at the 16x16 action space (UTT v2:
components [6, 4, 4, 4, 4, 7, 49]): normal logits, random masks with
components that have no legal entry (``~any(mask)``: the component keeps
all its logits), cells that cannot act, and actions on both edges of
every component.

The CUDA kernels cannot run here; their backward formula (written out in
``kernels/csrc/policy_logprob.cu``) is checked in closed form against
``jax.grad``, and the kernels against the plain version and its autograd
on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: lp and ent 1e-5 relative + 1e-5 absolute (float32 sums in
another order; entropies of near-deterministic cells are near 0);
gradients 1e-5 relative + 1e-6 absolute.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.models import gridnet_policy as JP
from microrts_tpu_torch import kernels as KN
from microrts_tpu_torch.models.gridnet_policy import (
    ActionSpace, action_logprob, action_logprob_plain, sample_action_plain,
    split_components)

from torch_parity import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SPACE = ActionSpace(7, 7)
JSPACE = JP.ActionSpace(7, 7)
B, H, W = 3, 5, 4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    A = SPACE.total
    logits = (rng.normal(size=(B, H, W, A)) * 3).astype(np.float32)
    mask = rng.random((B, H, W, A)) < 0.5
    comp = np.repeat(np.arange(7), SPACE.sizes)
    # components with no legal entry, and cells that cannot act at all
    dead = rng.random((B, H, W, 7)) < 0.2
    mask &= ~dead[..., comp]
    mask[0, 0, 0, :6] = False
    mask[1, 2, 3] = False
    acts = np.stack([rng.integers(0, s, (B, H, W)) for s in SPACE.sizes], -1)
    # every component's first and last entry
    acts[0, 1] = 0
    acts[0, 2] = np.array(SPACE.sizes) - 1
    return logits, mask, acts.astype(np.int32)


def _jax_lp(logits, mask, acts):
    return jax.vmap(jax.vmap(jax.vmap(
        lambda l, m, a: JP.action_logprob(l[None], m[None], a[None],
                                          JSPACE))))(
        jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(acts))


def _jax_lp_map(logits, mask, acts):
    lp, ent = _jax_lp(logits, mask, acts)
    return lp[..., 0], ent[..., 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_action_logprob_matches_jax(seed):
    logits, mask, acts = _inputs(seed)
    jlp, jent = jax.jit(_jax_lp_map)(logits, mask, acts)
    lp, ent = action_logprob(torch.from_numpy(logits), torch.from_numpy(mask),
                             torch.from_numpy(acts), SPACE)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(lp.numpy()).all() and (ent.numpy() > -1e-5).all()


def _weights(seed):
    rng = np.random.default_rng(100 + seed)
    return (rng.normal(size=(B, H, W)).astype(np.float32),
            rng.normal(size=(B, H, W)).astype(np.float32))


def _jax_grad(logits, mask, acts, w1, w2):
    def f(lg):
        lp, ent = _jax_lp_map(lg, mask, acts)
        return jnp.sum(w1 * lp + w2 * ent)
    return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(logits)))


@pytest.mark.parametrize("seed", [0, 1])
def test_action_logprob_gradient_matches_jax(seed):
    """torch.autograd through the plain version vs ``jax.grad`` of
    sum(w1 * lp + w2 * ent) with respect to the logits."""
    logits, mask, acts = _inputs(seed)
    w1, w2 = _weights(seed)
    want = _jax_grad(logits, mask, acts, w1, w2)
    lg = torch.from_numpy(logits).requires_grad_(True)
    lp, ent = action_logprob_plain(lg, torch.from_numpy(mask),
                                   torch.from_numpy(acts), SPACE)
    (torch.from_numpy(w1) * lp + torch.from_numpy(w2) * ent).sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    # the masked entries of a component with a legal entry get nothing
    comp = np.repeat(np.arange(7), SPACE.sizes)
    has = np.stack([mask[..., comp == k].any(-1) for k in range(7)], -1)
    cut = ~mask & has[..., comp]
    assert cut.any() and (want[cut] == 0).all()
    assert (~has).any() and (want[~has[..., comp]] != 0).any()


def closed_form_dlogits(logits, mask, acts, g_lp, g_ent):
    """The backward of ``policy_logprob_bwd`` as the kernel computes it,
    in float32 numpy: per component, g_logp_j = g_lp [j == a] - g_ent
    [p_j > 0] p_j (1 + logp_j); dlg_k = g_logp_k - p_k sum_j g_logp_j;
    zero where the entry is masked and the component has a legal one."""
    out = np.zeros_like(logits)
    off = 0
    for k, s in enumerate(SPACE.sizes):
        x = logits[..., off:off + s]
        m = mask[..., off:off + s]
        has = m.any(-1, keepdims=True)
        keep = m | ~has
        v = np.where(keep, x, np.float32(-1e9))
        sh = v - v.max(-1, keepdims=True)
        logp = sh - np.log(np.exp(sh).sum(-1, keepdims=True))
        p = np.exp(logp)
        taken = np.arange(s) == acts[..., k:k + 1]
        g = (np.where(taken, g_lp[..., None], 0)
             - np.where(p > 0, g_ent[..., None] * p * (1 + logp), 0))
        d = g - p * g.sum(-1, keepdims=True)
        out[..., off:off + s] = np.where(keep, d, 0)
        off += s
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_backward_formula_matches_jax(seed):
    logits, mask, acts = _inputs(seed)
    w1, w2 = _weights(seed)
    want = _jax_grad(logits, mask, acts, w1, w2)
    got = closed_form_dlogits(logits, mask, acts, w1, w2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sampler_and_logprob_agree():
    """The sampler's logprob and entropy of the action it draws equal
    ``action_logprob`` of that action (the same arithmetic)."""
    logits, mask, _ = _inputs(2)
    rng = np.random.default_rng(3)
    gum = torch.from_numpy(rng.gumbel(size=logits.shape).astype(np.float32))
    env_mask = torch.from_numpy(np.concatenate(
        [mask[..., :6].any(-1, keepdims=True), mask], -1).astype(np.int32))
    act, slp, sent, _ = sample_action_plain(torch.from_numpy(logits),
                                            env_mask, SPACE, gum)
    lp, ent = action_logprob_plain(torch.from_numpy(logits),
                                   torch.from_numpy(mask), act, SPACE)
    assert torch.equal(lp, slp) and torch.equal(ent, sent)
    assert len(split_components(torch.from_numpy(logits), SPACE)) == 7


def test_kernel_launchers_refuse_cpu_tensors():
    logits, mask, acts = _inputs(0)
    lg, mk, ac = (torch.from_numpy(logits), torch.from_numpy(mask),
                  torch.from_numpy(acts))
    g = torch.zeros((B, H, W))
    with pytest.raises(ValueError, match="expected a tensor on"):
        KN.LOGPROB(SPACE.sizes, lg, mk, ac)
    with pytest.raises(ValueError, match="expected a tensor on"):
        KN.LOGPROB_BWD(SPACE.sizes, lg, mk, ac, g, g)
    assert KN.LOGPROB.launches == 0 and KN.LOGPROB_BWD.launches == 0
