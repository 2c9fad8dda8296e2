"""SSVD genome <-> weights codec and learned evaluation.

A port of ``microrts_tpu.models.ssvd`` (see its docstring for the Java
sources): a flat genome vector decodes into low-rank ``U diag(s) V^T``
weight matrices of a small MLP.  ``eval_net`` collapses it to a scalar in
(-1, 1) (the search bots' ``eval_fn``), ``logits_net`` returns the last
layer's raw activations (CooperativeAI's per-unit heads).

These are plain matrix products: the JAX package leaves them to XLA
outside any kernel, and the port to ``torch.matmul`` in float32.  On the
card the caller keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32
= False``, PyTorch's default), so the products round as float32 does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32


def ssvd_shapes(layer_dims: Sequence[int], rank: int) -> List[Tuple]:
    """Per-layer (U [m, r], s [r], V [n, r], b [n]) genome segmentation."""
    out = []
    for m, n in zip(layer_dims[:-1], layer_dims[1:]):
        r = min(rank, m, n)
        out.append(((m, r), (r,), (n, r), (n,)))
    return out


def genome_size(layer_dims: Sequence[int], rank: int) -> int:
    total = 0
    for (u, s, v, b) in ssvd_shapes(layer_dims, rank):
        total += int(np.prod(u) + np.prod(s) + np.prod(v) + np.prod(b))
    return total


def decode(genome: torch.Tensor, layer_dims: Sequence[int], rank: int):
    """Genome float32 ``[G]`` -> ``[(W [m, n], b [n])]`` with ``W = (U *
    s) @ V.T``."""
    layers = []
    i = 0
    for (us, ss, vs, bs) in ssvd_shapes(layer_dims, rank):
        nu, ns, nv, nb = (int(np.prod(x)) for x in (us, ss, vs, bs))
        U = genome[i:i + nu].reshape(us)
        i += nu
        s = genome[i:i + ns]
        i += ns
        V = genome[i:i + nv].reshape(vs)
        i += nv
        b = genome[i:i + nb]
        i += nb
        layers.append(((U * s[None, :]) @ V.T, b))
    return layers


def eval_net(genome: torch.Tensor, obs_flat: torch.Tensor,
             layer_dims: Sequence[int], rank: int) -> torch.Tensor:
    """tanh MLP over ``obs_flat [..., n_in]`` -> a scalar a row in (-1,
    1)."""
    x = obs_flat.to(F32)
    for W, b in decode(genome, layer_dims, rank):
        x = torch.tanh(x @ W + b)
    return x[..., 0] if x.shape[-1] == 1 else torch.tanh(x.sum(-1))


def logits_net(genome: torch.Tensor, x: torch.Tensor,
               layer_dims: Sequence[int], rank: int) -> torch.Tensor:
    """The MLP's last layer's raw activations (tanh on the hidden layers
    only)."""
    x = x.to(F32)
    layers = decode(genome, layer_dims, rank)
    for i, (W, b) in enumerate(layers):
        x = x @ W + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def make_learned_eval(env, genome: torch.Tensor, hidden: int = 64,
                      rank: int = 8):
    """(``eval_fn(state, player) -> float32 [B]``, genome length): the
    search bots' evaluation by a genome over the flattened one-hot
    observation (``env.observation_onehot``)."""
    C = 5 + 5 + 3 + (env.cfg.engine.num_types + 1) + 6
    dims = (env.h * env.w * C, hidden, 1)

    def eval_fn(state, player):
        obs = env.observation_onehot(state, player)
        return eval_net(genome, obs.reshape(obs.shape[0], -1), dims, rank)

    return eval_fn, genome_size(dims, rank)
