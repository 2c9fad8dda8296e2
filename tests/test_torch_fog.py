"""The port's fog of war (``microrts_tpu_torch.engine.fog``, plain path on
the CPU) against the JAX package's ``visibility``, ``po_state`` and
``observation_po`` on states of basesWorkers8x8 (random play) and
basesWorkers16x16 (rush play, whose units meet within sight), for both
players and a per-lane player vector.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from microrts_tpu_torch.engine import fog
from microrts_tpu_torch.engine.types import FIELD_DTYPES

from torch_parity import (assert_eq, assert_state_eq, envs, jax_state,
                          port_trajectory, torch_one_thread)  # noqa: F401
from torch_po_parity import cat_states, jax_fog, players_of, rush_trajectory

B = 6


@pytest.mark.parametrize("map_rel,ticks,play", [
    ("maps/8x8/basesWorkers8x8.xml", (0, 40, 80, 120), port_trajectory),
    ("maps/16x16/basesWorkers16x16.xml", (0,) + tuple(range(150, 230, 10)),
     rush_trajectory)],
    ids=["8x8-random", "16x16-rush"])
def test_fog_matches_jax(map_rel, ticks, play, torch_one_thread):
    jenv, env = envs(map_rel)
    cfg, jcfg = env.cfg.engine, jenv.cfg.engine
    traj = play(env, B, max(ticks) + 1, seed=7, keep=set(ticks))
    s = cat_states([traj[t] for t in ticks])
    js = jax_state(s)
    n = s.batch
    lanes = (torch.arange(n) % 2).to(torch.int32)
    hidden = seen = 0
    for p in (0, 1, lanes):
        jvis, jview, jobs = jax_fog(jcfg)(js, players_of(p, n))
        vis = fog.visibility(s, p, cfg)
        assert_eq(jvis, vis, f"visibility p{p}")
        view = fog.po_state(s, p, cfg)
        assert_state_eq(jview, view, f"po_state p{p}")
        assert_eq(jobs, fog.observation_po(s, p, cfg), f"observation_po p{p}")
        me = torch.as_tensor(p).reshape(-1, 1, 1)
        enemy = (s.utype > 0) & (s.owner >= 0) & (s.owner != me)
        hidden += int((enemy & ~vis).sum())
        seen += int((enemy & vis).sum())
        # own units and terrain always stay; the view's scalars are the
        # state's
        own = (s.utype > 0) & (s.owner == me)
        assert torch.equal(view.utype[own], s.utype[own])
        for f in ("terrain", "time", "resources", "next_id", "order_ctr"):
            assert torch.equal(getattr(view, f), getattr(s, f)), f
    # the states hold enemy units both hidden and seen, and the eighth
    # plane (the visible enemies' sight) is not empty
    assert hidden > 0 and seen > 0, (hidden, seen)
    assert int(np.asarray(jobs)[:, 7].sum()) > 0
    assert set(FIELD_DTYPES) == set(vars(view))
