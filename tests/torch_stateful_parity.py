"""Helpers of the stateful-bot parity tests: JAX trees as the port's,
the JAX package's ``naive_mcts_continuing`` run eagerly under ``vmap``
around its jitted parts (as tests/torch_treesearch_parity.py runs
``naive_mcts_bot``), with its search made the identity to reach
``_reroot`` alone, and ``lax.fori_loop`` with a per-lane trip count as a
masked Python loop (the lanes past their count keep their carry, as a
batched while loop does)."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.bots import treesearch as JTS
from microrts_tpu_torch.bots import treesearch as TS
from microrts_tpu_torch.engine.types import FIELD_DTYPES, State

import torch_treesearch_parity as TP


def jax_env_step(jenv):
    """JAX's full-observation ``env.step`` state (decode, ``issue_env``,
    decode, ``issue_env``, ``cycle``) over lanes: ``(s, a0, a1) -> (state,
    done)``."""
    def dec(st, a, p):
        return jenv.decode(st, a, p, jenv._inflight_claims(st),
                           jenv._inflight_spent(st, p))[0]

    def step(s, a0, a1):
        eng = jenv.engine
        s1 = eng.issue_env(s, dec(s, a0, 0))
        return eng.cycle(eng.issue_env(s1, dec(s1, a1, 1)))
    return jax.vmap(step)


def port_tree(jtree) -> TS.NaiveTree:
    """A JAX ``_NaiveTree`` of ``B`` lanes as the port's ``NaiveTree``."""
    st = State(**{f: torch.from_numpy(np.array(
        getattr(jtree.states, f))).flatten(0, 1) for f in FIELD_DTYPES})
    assert st.batch == np.asarray(jtree.nplayer).size
    return TS.NaiveTree(states=st, **{
        f: torch.from_numpy(np.array(getattr(jtree, f)))
        for f in TS.NaiveTree.FIELDS})


def lanes(tree, rows) -> TS.NaiveTree:
    """The port tree of games ``rows`` (a list)."""
    n1 = tree.nplayer.shape[1]
    idx = torch.tensor(rows)
    sidx = (idx[:, None] * n1 + torch.arange(n1)).flatten()
    return TS.NaiveTree(
        states=State(**{f: getattr(tree.states, f)[sidx]
                        for f in FIELD_DTYPES}),
        **{f: getattr(tree, f)[idx].clone() for f in TS.NaiveTree.FIELDS})


def _fori(lower, upper, body, init, **kw):
    """``lax.fori_loop`` as a Python loop; a per-lane (batched) ``upper``
    runs to its largest value, each lane keeping its carry from its own
    count on."""
    if not isinstance(upper, jax.core.Tracer):
        return TP._py_fori(int(lower), int(upper), body, init)
    n = int(np.asarray(upper.val).max())
    v = init
    for i in range(int(lower), n):
        new = body(i, v)
        keep = i < upper
        v = jax.tree.map(lambda a, b: jnp.where(keep, b, a), v, new)
    return v


@contextlib.contextmanager
def eager_continuing(jenv, kw, search=True):
    """JAX's ``naive_mcts_continuing`` parts with its ``naive_mcts_bot``
    (the tests' evaluation, jitted helpers) built from ``kw``; with
    ``search=False`` its search is the identity, so that a step is
    ``_reroot`` then ``best_action``."""
    real = JTS.naive_mcts_bot
    with TP._jitted_parts(jenv):
        base = real(jenv, eval_fn=TP._jax_eval(jenv), **kw)
        if not search:
            def make(env, **k):
                def fake():
                    pass
                fake.init_tree, fake.best_action = (base.init_tree,
                                                    base.best_action)
                fake.search = lambda t, maxp, t0, key, n_iters=None: t
                fake.dims = base.dims
                return fake
        else:
            def make(env, **k):
                return base
        JTS.naive_mcts_bot = make
        try:
            with TP.eager_tree_loops():
                jax.lax.fori_loop = _fori
                yield
        finally:
            JTS.naive_mcts_bot = real
