"""The PPO trainer's optimizer: optax's ``chain(clip_by_global_norm, adam)``
and ``sgd``, formula for formula.

The JAX package builds ``optax.chain(optax.clip_by_global_norm(max_norm),
optax.adam(lr))`` (microrts_tpu/train/ppo.py:86-88).  PyTorch's own pieces
group the same arithmetic differently (``clip_grad_norm_`` divides by
``norm + 1e-6`` and clamps; ``torch.optim.Adam`` folds the bias
corrections into the step size), so this module repeats optax's:

* ``clip_by_global_norm``: ``g_norm = sqrt(sum over leaves of sum(g**2))``
  with the leaves in the order given (the flax tree's order, see
  ``models.gridnet_policy.flax_order``); ``g`` is kept when ``g_norm <
  max_norm``, else replaced by ``(g / g_norm) * max_norm``;
* ``adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g**2 + b2 nu``,
  ``mu_hat = mu / (1 - b1**t)``, ``nu_hat = nu / (1 - b2**t)``, update
  ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
* ``sgd``: update ``-lr * g``.

A transformation is ``init(params) -> state`` and ``update(grads, state)
-> (updates, state)`` over lists of tensors; ``apply_updates`` adds the
updates in place.  Everything is float32 tensor arithmetic on the
parameters' device.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch

Tensors = List[torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], Any]
    update: Callable[[Sequence[torch.Tensor], Any], Tuple[Tensors, Any]]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the leaves' sums of squares added in order."""
    total = 0.0
    for g in grads:
        total = total + (g * g).sum()
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state):
        g_norm = global_norm(grads)
        trigger = g_norm < max_norm
        return [torch.where(trigger, g, (g / g_norm) * max_norm)
                for g in grads], state
    return Transform(lambda params: (), update)


class AdamState(NamedTuple):
    count: torch.Tensor     # int32 []
    mu: Tensors
    nu: Tensors


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def init(params):
        dev = params[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        t = count.to(torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        out = [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]
        return out, AdamState(count, mu, nu)

    return Transform(init, update)


def scale(step: float) -> Transform:
    return Transform(lambda params: (),
                     lambda grads, state: ([step * g for g in grads], state))


def chain(*txs: Transform) -> Transform:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state):
        new = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), scale(-lr))


def sgd(lr: float) -> Transform:
    return scale(-lr)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """``p <- p + u`` in place, for every parameter."""
    for p, u in zip(params, updates):
        p.add_(u)
