"""ContinuingNaiveMCTS's re-root (``bots/treesearch.py`` ``mcts_reroot``,
plain path on the CPU) against the JAX package's ``_reroot``
(treesearch.py:507-564), on the trees of JAX's ``naive_mcts_bot`` search
at its small budget (6 playouts, 12 nodes, 4 children, depth 3) of the 4
recorded 8x8 games for both players (tests/torch_treesearch_parity.py),
converted to the port's layout.  The real state each lane re-roots at is
a root child's node state, a grandchild's, or the root's with player
0's stock changed (no node matches), each with the counters the match
leaves out (issue order, next id, cancel counter) moved, as after a real
step.  JAX's ``_reroot`` is reached through ``naive_mcts_continuing``'s
step with its search the identity (a step is then ``_reroot`` and
``best_action``).  Whole trees, the scratch row N included, and the
actions are equal.  Tolerance: exact (the re-root moves values, and
computes none)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import treesearch as JTS
from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State
from microrts_tpu_torch.ops.playout import can_act

from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa: F401
from torch_stateful_parity import eager_continuing, lanes, port_tree
from torch_treesearch_parity import (TINY, _both_players, _jax_trees, _lanes,
                                     assert_tree_eq)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SEED = 40
KINDS = ("child", "grandchild", "miss")


def real_states(tree):
    """(the real state of every lane, its kind): lane i re-roots at a
    node of kind KINDS[i % 3] (a miss where the tree has no grandchild)."""
    B, n1, C = tree.children.shape
    rows, kinds = [], []
    for i in range(B):
        kind = KINDS[i % 3]
        ch = [int(c) for c in tree.children[i, 0, :int(tree.nchild[i, 0])]]
        node = 0
        if kind == "child":
            node = ch[-1]
        elif kind == "grandchild":
            grand = [int(g) for c in ch
                     for g in tree.children[i, c, :int(tree.nchild[i, c])]]
            node = grand[0] if grand else 0
            kind = kind if grand else "miss"
        rows.append(i * n1 + node)
        kinds.append(kind)
    s = State(**{f: getattr(tree.states, f)[torch.tensor(rows)].clone()
                 for f in FIELD_DTYPES})
    miss = torch.tensor([k == "miss" for k in kinds])
    s.resources[miss, 0] += 37
    s.order_ctr += 5
    s.next_id += 11
    s.cancel_ctr += 3
    s.aorder += 2
    return s, kinds


def test_reroot_matches_jax():
    jenv, env, games, js2, players, keys = _both_players(SEED)
    B = games.batch
    jtree, _ = _jax_trees("naive", tuple(sorted(TINY.items())), SEED)
    tree = port_tree(jtree)
    real, kinds = real_states(tree)
    assert set(kinds) == set(KINDS), kinds
    with eager_continuing(jenv, TINY, search=False):
        cont = JTS.naive_mcts_continuing(jenv, **TINY)
        jact, jout = jax.vmap(cont.step)(jax_state(real), jtree, players,
                                         keys)
    bot = TS.naive_mcts_bot(env, **TINY).bot
    N, C, D = bot.dims
    for p in (0, 1):
        rows = list(range(p * B, (p + 1) * B))
        t = lanes(tree, rows)
        s = State(**{f: getattr(real, f)[p * B:(p + 1) * B]
                     for f in FIELD_DTYPES})
        before = t.nnodes.clone()
        TS.mcts_reroot(env, t, s, p, D)
        # JAX's step plays nothing where only the opponent can act
        act = torch.where(can_act(s, p)[:, None, None, None],
                          bot.best_action(t), 0)
        assert_tree_eq(_lanes(jout, p, B), t, np.ones(B, bool),
                       f"reroot p{p}")
        assert_eq(np.asarray(jact)[p * B:(p + 1) * B], act.numpy(),
                  f"reroot p{p}: action")
        for j, r in enumerate(rows):
            k = kinds[r]
            # a hit keeps the node's visits at the root, a miss is fresh
            assert (int(t.nvis[j, 0]) == 0) == (k == "miss"), (k, t.nvis)
            assert 1 <= int(t.nnodes[j]) <= int(before[j])
            ok, f = State(**{f: getattr(t.states, f)[j * (N + 1)][None]
                             for f in FIELD_DTYPES}).equal(State(**{
                                 f: getattr(s, f)[j][None]
                                 for f in FIELD_DTYPES}))
            assert ok, f
    print("kinds", kinds, "nodes kept", jnp.asarray(jout.nnodes).tolist())


def test_reroot_live_lanes_are_the_only_ones_changed():
    """``live`` re-roots its games and leaves the others' trees as they
    were, bit for bit."""
    jenv, env, games, js2, players, keys = _both_players(SEED)
    B = games.batch
    jtree, _ = _jax_trees("naive", tuple(sorted(TINY.items())), SEED)
    tree = port_tree(jtree)
    real, _ = real_states(tree)
    t_all = lanes(tree, list(range(B)))
    t_some = lanes(tree, list(range(B)))
    s = State(**{f: getattr(real, f)[:B] for f in FIELD_DTYPES})
    live = torch.arange(B) % 2 == 1
    D = TINY["max_depth"]
    TS.mcts_reroot(env, t_all, s, 0, D)
    TS.mcts_reroot(env, t_some, s, 0, D, live)
    old = lanes(tree, list(range(B)))
    n1 = tree.nplayer.shape[1]
    srow = torch.arange(B).repeat_interleave(n1)
    for f in TS.NaiveTree.FIELDS:
        a, b, o = getattr(t_some, f), getattr(t_all, f), getattr(old, f)
        assert torch.equal(a[live], b[live]) and torch.equal(a[~live],
                                                             o[~live]), f
    for f in FIELD_DTYPES:
        a, b, o = (getattr(x.states, f) for x in (t_some, t_all, old))
        m = live[srow]
        assert torch.equal(a[m], b[m]) and torch.equal(a[~m], o[~m]), f
