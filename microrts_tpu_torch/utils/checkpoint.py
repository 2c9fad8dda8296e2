"""Policy checkpoints as npz files in the JAX package's layout.

``microrts_tpu.utils.checkpoint.save_pytree`` writes a flax parameter tree
as ``leaf_{i}`` arrays in ``jax.tree.flatten`` order (sorted keys at every
level) and ``load_pytree`` reads them back in that order.  The port writes
and reads the same ``leaf_{i}`` arrays (through ``params_to_flax`` /
``params_from_flax``, in flax's kernel layouts), so a checkpoint from
either package loads in the other.  The ``__treedef__`` entry (JAX's
printed tree structure, which neither loader reads) holds the leaves'
paths here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.gridnet_policy import params_from_flax, params_to_flax


def _leaves(tree: dict, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """(path, array) of every leaf, in ``jax.tree.flatten`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def save_params(path: str, model: torch.nn.Module) -> None:
    """Write ``model``'s parameters (a ``GridnetPolicy``) as a JAX-layout
    npz."""
    leaves = _leaves(params_to_flax(model.state_dict()))
    names = ";".join("/".join(p) for p, _ in leaves)
    np.savez_compressed(
        path, __treedef__=np.frombuffer(names.encode(), dtype=np.uint8),
        **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})


def load_params(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Load a JAX-layout npz (from either package) into ``model`` in place;
    returns the loaded ``state_dict``."""
    like = _leaves(params_to_flax(model.state_dict()))
    data = np.load(path, allow_pickle=False)
    tree: dict = {}
    for i, (p, a) in enumerate(like):
        leaf = data[f"leaf_{i}"]
        if leaf.shape != a.shape:
            raise ValueError(f"{path}: leaf_{i} ({'/'.join(p)}) has shape "
                             f"{leaf.shape}, the model {a.shape}")
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = leaf
    sd = params_from_flax(tree)
    model.load_state_dict(sd)
    return sd
