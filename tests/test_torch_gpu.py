"""Card tests of the port: the four CUDA kernels against their plain
PyTorch versions, on the main path with resets.  They skip on a machine
without a CUDA card.  This file imports neither JAX nor the JAX package,
so it runs where only the port is installed::

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: exact.
"""

import pytest
import torch

from microrts_tpu_torch.bots.scripted import random_bot
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.env.vec import VecGridnetEnv
from microrts_tpu_torch.utils.assets import asset_path

BIAS = 5.0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("map_rel", ["maps/8x8/melee8x8Mixed6.xml",
                                     "maps/16x16/basesWorkers16x16.xml"])
def test_kernel_path_equals_plain_on_card(map_rel):
    """The main path through the four kernels equals the plain path on the
    card, tick by tick with resets, and launches each kernel as often as
    the step calls it."""
    _need_card()
    from microrts_tpu_torch import kernels as KN
    dev = torch.device("cuda")
    B, ticks = 64, 80
    kenv = GridnetEnv(asset_path(map_rel), device=dev)
    penv = GridnetEnv(asset_path(map_rel), device=dev, plain=True)
    kvec, pvec = VecGridnetEnv(kenv, B, 30), VecGridnetEnv(penv, B, 30)
    kbot, pbot = random_bot(kenv, BIAS), random_bot(penv, BIAS)
    ks, ksteps = kvec.reset()
    ps, psteps = pvec.reset()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    KN.reset_counts()
    for t in range(ticks):
        u0, u1 = (torch.rand((B, kenv.h, kenv.w, 2), generator=g, device=dev)
                  for _ in (0, 1))
        ka = (kbot(ks, 0, u0), kbot(ks, 1, u1))
        pa = (pbot(ps, 0, u0), pbot(ps, 1, u1))
        kout = kvec.step(ks, ksteps, *ka)
        pout = pvec.step(ps, psteps, *pa)
        (ks, ksteps), (ps, psteps) = kout[:2], pout[:2]
        assert ks.equal(ps) == (True, ""), (t, ks.equal(ps))
        for a, b in zip(ka + kout[1:], pa + pout[1:]):
            assert torch.equal(a, b), t
        assert torch.equal(kvec.masks(ks), pvec.masks(ps)), t
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KN.KERNELS} == dict(
        actor=4 * ticks, decode=2 * ticks, issue_env=2 * ticks, cycle=ticks)


@pytest.mark.gpu
def test_kernel_rejects_bad_input_on_card():
    _need_card()
    from microrts_tpu_torch import kernels as KN
    env = GridnetEnv(asset_path("maps/8x8/basesWorkers8x8.xml"), device="cuda")
    s = env.reset(4)
    with pytest.raises(TypeError):
        KN.CYCLE(env.cfg.engine, s.replace(hp=s.hp.int()))
    with pytest.raises(ValueError):
        KN.ISSUE_ENV(env.cfg.engine, s.replace(utype=s.utype.cpu()),
                     env.decode(s, torch.zeros((4, 8, 8, 7), dtype=torch.int32,
                                               device="cuda"), 0))
    u = torch.rand((4, 8, 8, 2), device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        KN.ACTOR(env.cfg.engine, s, 0, u=u, weights=(1,) * 6)
