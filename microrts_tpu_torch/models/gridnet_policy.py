"""Gridnet actor-critic: per-cell factored-categorical policy + value head.

A port of ``microrts_tpu.models.gridnet_policy``.  The module takes NHWC
observations ``[B, H, W, C]``, as the JAX package does, and runs its 3x3
convolutions channels-last inside (cuDNN on the card: the JAX package
leaves them to XLA too, outside any kernel).  Its dtype flow is flax's:
fp32 parameters; each 3x3 conv casts its input, kernel and bias to the
compute dtype (bf16 by default) and adds the bias in that dtype; the
residual add is in that dtype; after the final relu the activations are
cast to fp32 for the 1x1 logits conv and the value head (mean over H, W
-> Dense 128 -> relu -> Dense 1).

``sample_action`` and ``greedy_action`` (the masked factored categorical,
K7) dispatch by device: CPU tensors take the plain version, CUDA tensors
launch the ``policy_sample`` kernel.  Randomness comes in as gumbel noise
``[B, H, W, A]``: ``jax.random.categorical`` is ``argmax(logits +
gumbel)``, so the same gumbels give the same actions in both packages.
``action_logprob`` (K7b: the logprob and entropy of given actions, for the
PPO loss) dispatches the same way; on CUDA tensors it is the
``ActionLogprob`` autograd function, whose forward and backward are the
``policy_logprob_fwd`` and ``policy_logprob_bwd`` kernels, and on CPU
tensors autograd differentiates the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels as KN

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class ActionSpace:
    """Per-cell component sizes: [6, 4, 4, 4, 4, T, D*D]."""
    num_types: int
    diam: int

    @property
    def sizes(self) -> Tuple[int, ...]:
        return (6, 4, 4, 4, 4, self.num_types, self.diam * self.diam)

    @property
    def total(self) -> int:
        return sum(self.sizes)


def split_components(flat: torch.Tensor, space: ActionSpace
                     ) -> List[torch.Tensor]:
    out, i = [], 0
    for s in space.sizes:
        out.append(flat[..., i:i + s])
        i += s
    return out


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)`` with SAME padding on an NCHW view:
    input and kernel in ``dtype``, then the bias added in ``dtype``."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                 padding=conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


class ResBlock(nn.Module):
    def __init__(self, ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv0, torch.relu(x), self.dtype)
        h = _conv(self.conv1, torch.relu(h), self.dtype)
        return x + h


class GridnetPolicy(nn.Module):
    """obs [B, H, W, C] -> (per-cell logits fp32 [B, H, W, A], value fp32
    [B]).  ``in_ch`` is the one-hot observation width (5+5+3+(T+1)+6)."""

    def __init__(self, space: ActionSpace, in_ch: int, width: int = 64,
                 blocks: int = 4, dtype=torch.bfloat16):
        super().__init__()
        self.space = space
        self.dtype = dtype
        self.conv0 = nn.Conv2d(in_ch, width, 3, padding=1)
        self.blocks = nn.ModuleList([ResBlock(width, dtype)
                                     for _ in range(blocks)])
        self.logits = nn.Linear(width, space.total)   # the 1x1 conv
        self.dense0 = nn.Linear(width, 128)
        self.dense1 = nn.Linear(128, 1)

    def forward(self, obs: torch.Tensor):
        x = obs.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = _conv(self.conv0, x, self.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = torch.relu(x).float().permute(0, 2, 3, 1)       # NHWC, fp32
        logits = F.linear(x, self.logits.weight, self.logits.bias)
        v = self.dense0(x.mean((1, 2)))
        v = self.dense1(torch.relu(v))[..., 0]
        return logits, v

    def init_params(self, generator: torch.Generator) -> "GridnetPolicy":
        """Seeded initialisation like flax's defaults: LeCun-normal
        kernels (truncated at 2 sigma) and zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                    m.bias.zero_()
        return self


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ``GridnetPolicy`` parameters (a nested dict of
    numpy arrays, with or without the top-level ``"params"``) as this
    module's ``state_dict``.  Conv kernels are HWIO and become OIHW; Dense
    kernels (and the 1x1 logits conv) are ``[in, out]`` and become
    ``weight[out, in]``."""
    p = tree.get("params", tree)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def conv(d):
        return t(d["kernel"]).permute(3, 2, 0, 1).contiguous(), t(d["bias"])

    out = {}
    out["conv0.weight"], out["conv0.bias"] = conv(p["Conv_0"])
    i = 0
    while f"ResBlock_{i}" in p:
        for j in (0, 1):
            w, b = conv(p[f"ResBlock_{i}"][f"Conv_{j}"])
            out[f"blocks.{i}.conv{j}.weight"] = w
            out[f"blocks.{i}.conv{j}.bias"] = b
        i += 1
    out["logits.weight"] = t(p["Conv_1"]["kernel"])[0, 0].T.contiguous()
    out["logits.bias"] = t(p["Conv_1"]["bias"])
    for name in ("Dense_0", "Dense_1"):
        key = "dense" + name[-1]
        out[f"{key}.weight"] = t(p[name]["kernel"]).T.contiguous()
        out[f"{key}.bias"] = t(p[name]["bias"])
    return out


def _flax_path(name: str) -> Tuple[str, ...]:
    """The flax tree path (under ``"params"``) of a ``GridnetPolicy``
    parameter: ``blocks.1.conv0.weight`` -> ``ResBlock_1/Conv_0/kernel``."""
    *mod, leaf = name.split(".")
    top = {"conv0": ("Conv_0",), "logits": ("Conv_1",),
           "dense0": ("Dense_0",), "dense1": ("Dense_1",)}
    path = (top[mod[0]] if mod[0] in top
            else (f"ResBlock_{mod[1]}", f"Conv_{mod[2][-1]}"))
    return path + ("kernel" if leaf == "weight" else "bias",)


def flax_order(names) -> List[str]:
    """Parameter names in the order ``jax.tree.flatten`` walks the flax
    tree (sorted keys at every level): the leaf order of the JAX
    package's checkpoints and of optax's ``global_norm`` sum."""
    return sorted(names, key=_flax_path)


def params_to_flax(sd: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_flax``: a ``{"params": ...}`` tree of
    float32 numpy arrays in flax's layout."""
    tree: dict = {}
    for name, v in sd.items():
        a = v.detach().to("cpu", torch.float32)
        if name == "logits.weight":
            a = a.T[None, None]
        elif name.endswith("weight") and a.dim() == 4:
            a = a.permute(2, 3, 1, 0)
        elif name.endswith("weight"):
            a = a.T
        node = tree
        *path, leaf = _flax_path(name)
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a.numpy().copy()
    return {"params": tree}


# ----------------------------------------------------------------------
# masked factored categorical (K7)

def _use_kernel(t: torch.Tensor, plain: bool) -> bool:
    """CUDA tensors launch the kernels unless ``plain``; CPU tensors take
    the plain versions."""
    return not plain and t.device.type != "cpu"


def sample_action(logits: torch.Tensor, mask: torch.Tensor,
                  space: ActionSpace, gumbel: torch.Tensor,
                  plain: bool = False):
    """Sample the 7 factored components with invalid-action masking.

    logits float32 ``[B, H, W, A]``; mask the env's int32 ``[B, H, W,
    1 + A]`` (its channel 0, can act, is skipped); gumbel float32 ``[B, H,
    W, A]``.  Returns (action int32 ``[B, H, W, 7]``, logprob ``[B, H,
    W]``, entropy ``[B, H, W]``, the per-env logprob summed over the cells
    that can act ``[B]``).  ``plain=True`` runs the plain version on any
    device (the kernel's oracle on the card)."""
    if _use_kernel(logits, plain):
        return KN.SAMPLE(space.sizes, logits, mask, gumbel)
    return sample_action_plain(logits, mask, space, gumbel)


def greedy_action(logits: torch.Tensor, mask: torch.Tensor,
                  space: ActionSpace, plain: bool = False) -> torch.Tensor:
    """Per-component argmax with invalid-action masking: int32 ``[B, H,
    W, 7]``."""
    if _use_kernel(logits, plain):
        return KN.SAMPLE(space.sizes, logits, mask)[0]
    return greedy_action_plain(logits, mask, space)


def _masked(logits, mask, space):
    """Per component: the masked logits (``mask | ~any(mask)``)."""
    mk = mask[..., 1:] != 0
    out = []
    for lg, m in zip(split_components(logits, space),
                     split_components(mk, space)):
        has = m.any(-1, keepdim=True)
        out.append(torch.where(m | ~has, lg, torch.tensor(
            NEG_INF, dtype=lg.dtype, device=lg.device)))
    return out, mk[..., :6].any(-1)


def sample_action_plain(logits, mask, space: ActionSpace, gumbel):
    comps, can_act = _masked(logits, mask, space)
    acts, lp_sum, ent_sum = [], 0.0, 0.0
    for lg, g in zip(comps, split_components(gumbel, space)):
        a = torch.argmax(lg + g, -1)
        shifted = lg - lg.max(-1, keepdim=True).values
        logp = shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))
        p = torch.exp(logp)
        lp_sum = lp_sum + torch.gather(logp, -1, a[..., None])[..., 0]
        ent_sum = ent_sum - torch.where(p > 0, p * logp, 0.0).sum(-1)
        acts.append(a)
    env_lp = torch.where(can_act, lp_sum, 0.0).sum((-2, -1))
    return (torch.stack(acts, -1).to(torch.int32), lp_sum, ent_sum, env_lp)


def greedy_action_plain(logits, mask, space: ActionSpace) -> torch.Tensor:
    comps, _ = _masked(logits, mask, space)
    return torch.stack([torch.argmax(lg, -1) for lg in comps],
                       -1).to(torch.int32)


# ----------------------------------------------------------------------
# logprob and entropy of given actions (K7b)

def action_logprob(logits: torch.Tensor, mask: torch.Tensor,
                   action: torch.Tensor, space: ActionSpace,
                   plain: bool = False):
    """Log-prob and entropy of ``action`` under the current logits.

    logits float32 ``[..., A]``; mask bool ``[..., A]`` (the trajectory's
    layout: the env mask without its can-act channel, as the JAX package
    passes it); action int32 ``[..., 7]``.  Returns (lp, ent) float32
    ``[...]``, each summed over the 7 components; both are differentiable
    with respect to the logits.  ``plain=True`` runs the plain version on
    any device (the kernels' oracle on the card)."""
    if _use_kernel(logits, plain):
        return ActionLogprob.apply(logits.contiguous(), mask.contiguous(),
                                   action.contiguous(), space.sizes)
    return action_logprob_plain(logits, mask, action, space)


def action_logprob_plain(logits, mask, action, space: ActionSpace):
    """gridnet_policy.py:116 in PyTorch: per component, the masked logits,
    a log-softmax whose max is a constant (``stop_gradient`` in
    ``jax.nn.log_softmax``), the taken entry and the entropy."""
    lp_sum, ent_sum = 0.0, 0.0
    for i, (lg, m) in enumerate(zip(split_components(logits, space),
                                    split_components(mask, space))):
        has = m.any(-1, keepdim=True)
        lg = torch.where(m | ~has, lg, torch.tensor(
            NEG_INF, dtype=lg.dtype, device=lg.device))
        shifted = lg - lg.max(-1, keepdim=True).values.detach()
        logp = shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))
        p = torch.exp(logp)
        lp_sum = lp_sum + torch.gather(
            logp, -1, action[..., i:i + 1].long())[..., 0]
        ent_sum = ent_sum - torch.where(p > 0, p * logp, 0.0).sum(-1)
    return lp_sum, ent_sum


class ActionLogprob(torch.autograd.Function):
    """``action_logprob`` on the card: the forward launches
    ``policy_logprob_fwd``, the backward ``policy_logprob_bwd`` (which
    recomputes the softmax from the saved logits)."""

    @staticmethod
    def forward(ctx, logits, mask, action, sizes):
        lp, ent = KN.LOGPROB(sizes, logits, mask, action)
        ctx.save_for_backward(logits, mask, action)
        ctx.sizes = sizes
        return lp, ent

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        logits, mask, action = ctx.saved_tensors
        d = KN.LOGPROB_BWD(ctx.sizes, logits, mask, action,
                           g_lp.contiguous(), g_ent.contiguous())
        return d, None, None, None


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """float32 Gumbel(0, 1) noise ``-log(-log(u))``, with ``u`` uniform in
    [tiny, 1) (as ``jax.random.gumbel`` draws it)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u.clamp_(min=torch.finfo(torch.float32).tiny).log_().neg_() \
        .log_().neg_()
