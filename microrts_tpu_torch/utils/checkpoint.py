"""Policy checkpoints as npz files in the JAX package's layout, and the
learned models carried over from the JAX package (``learned_from_jax``).

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


def learned_from_jax(obj, env):
    """A learned model of the JAX package as the port's, on ``env.device``:
    an ``ml.pretrained.PretrainedBayes`` (its float32 tables), an
    ``ml.bayes.NaiveBayesModel`` (its counts) or CooperativeAI's ``[T, G]``
    genome matrix (float32).  Read by attribute, without JAX."""
    dev = env.device

    def f32(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32,
                               device=dev)
    if hasattr(obj, "log_prior"):
        from ..ml.pretrained import PretrainedBayes
        from ..ops.arms import arm_space
        cpds = [f32(c) for c in obj.log_cpds]
        return PretrainedBayes(
            cfg=env.cfg.engine, sp=arm_space(env), log_prior=f32(obj.log_prior),
            log_cpds=cpds, log_tf=f32(obj.log_tf), nf_base=f32(obj.nf_base),
            calibration=f32(obj.calibration),
            arm_type=torch.as_tensor(np.array(obj.arm_type),
                                     dtype=torch.int32, device=dev),
            feature_sizes=tuple(int(v) for v in obj.feature_sizes),
            cpd_cat=torch.cat(cpds, -1).contiguous())
    if hasattr(obj, "cpds"):
        from ..ml.bayes import NaiveBayesModel
        return NaiveBayesModel(prior=np.array(obj.prior),
                               cpds=[np.array(c) for c in obj.cpds],
                               calibration=float(obj.calibration))
    return f32(obj)
