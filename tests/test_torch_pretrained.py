"""The pretrained Bayes models (``ml.pretrained``, K14a's plain version)
against the JAX package's on the CPU.

The JAX package reads the AIM XMLs from its own assets, the port from its
copy (``microrts_tpu_torch/assets/bayesianmodels/``).  Integers (the Java
catalog map, the features, the arms) must be equal.  Tolerances: the
tables are float32 roundings of the same float64 values: exact; the
calibrated logits sum the same gathered table entries in the same order
but may round the calibration exponent ``1/((1-c) + nf c)`` apart (XLA
may contract the product and the sum): 2e-6 relative (logits reach ~550
in magnitude); the normalised prior sums its exponentials over the arms
in another order: 2e-6 absolute.  A greedy or sampled arm is held equal
where the winner's margin over the runner-up is at least 1e-6 (relative
to the winner for the logits, absolute for the Gumbel-perturbed log
weights); the cells below it are counted and their smallest margin
printed.  The centroid direction bins (``atan2`` in each package) must
be equal on every cell of seeded random boards.
"""

import numpy as np
import pytest
import jax
import torch

from microrts_tpu.env.gridnet import GridnetEnv as JaxEnv
from microrts_tpu.ml import pretrained as JP
from microrts_tpu.ops.arms import arm_masks as jax_arm_masks
from microrts_tpu.utils.assets import asset_path as jax_asset_path
from microrts_tpu_torch.config import pretrained_wr
from microrts_tpu_torch.env.gridnet import GridnetEnv
from microrts_tpu_torch.ml import pretrained as TP
from microrts_tpu_torch.ops.arms import arm_masks_packed, arm_space
from microrts_tpu_torch.utils.assets import asset_path
from microrts_tpu_torch.utils.checkpoint import learned_from_jax

from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP8 = "maps/8x8/basesWorkers8x8.xml"
MAP16 = "maps/16x16/basesWorkers16x16.xml"
MODELS = ("WR", "NaiveMCTS500")
LOGIT_RTOL = 2e-6
PRIOR_ATOL = 2e-6
MARGIN = 1e-6


def _xml(name):
    rel = f"bayesianmodels/ActionInterdependenceModel-{name}.xml"
    return jax_asset_path(rel), asset_path(rel)


def test_catalog_maps_equal_jax():
    jenv, env = JaxEnv(jax_asset_path(MAP8)), GridnetEnv(
        asset_path(MAP8), device="cpu")
    jsp, sp = JP.arm_space(jenv), arm_space(env)
    for ysize in (69, 65):
        assert_eq(JP.java_catalog_to_arms(jenv.cfg.engine, jsp, ysize),
                  TP.java_catalog_to_arms(env.cfg.engine, sp, ysize),
                  f"catalog {ysize}")
    assert_eq(JP.arm_action_types(jsp), TP.arm_action_types(sp), "types")
    assert (JP.java_feature_sizes(jenv.cfg.engine)
            == TP.java_feature_sizes(env.cfg.engine))
    assert pretrained_wr() == _xml("WR")[1]


@pytest.mark.parametrize("name", MODELS)
def test_tables_equal_jax(name):
    """The stacked tables of a shipped model, read by each package from
    its own copy, are equal; so is the JAX model carried over."""
    jenv, env = JaxEnv(jax_asset_path(MAP8)), GridnetEnv(
        asset_path(MAP8), device="cpu")
    jx, tx = _xml(name)
    jm, tm = JP.load_pretrained(jx, jenv), TP.load_pretrained(tx, env)
    for pm in (tm, learned_from_jax(jm, env)):
        for f in ("log_prior", "log_tf", "nf_base", "calibration",
                  "arm_type"):
            a, b = np.asarray(getattr(jm, f)), getattr(pm, f).numpy()
            assert a.dtype == b.dtype, f
            assert_eq(a, b, f)
        assert len(pm.log_cpds) == len(jm.log_cpds) == 8
        for a, b in zip(jm.log_cpds, pm.log_cpds):
            assert_eq(np.asarray(a), b, "log_cpds")
        assert pm.feature_sizes == jm.feature_sizes
        assert_eq(np.concatenate([np.asarray(c) for c in jm.log_cpds], -1),
                  pm.cpd_cat, "cpd_cat")


def _states(map_rel):
    jenv, env, s = recorded(map_rel)
    return jenv, env, s


def _jax_fns(jenv, jm):
    cfg = jenv.cfg.engine
    sp = JP.arm_space(jenv)

    def legal(s, p):
        return jax_arm_masks(sp, jenv.engine.legal_masks(s, p))

    feats = jax.jit(jax.vmap(lambda s, p: JP.compute_features_java(
        s, p, cfg, jm.feature_sizes), in_axes=(0, None)))
    logits = jax.jit(jax.vmap(lambda s, p: JP.predict_arm_logits(
        jm, s, p, legal(s, p)), in_axes=(0, None)))
    prior_fn = JP.make_prior_fn(jenv, jm)
    prior = jax.jit(jax.vmap(lambda s, p: prior_fn(s, p, legal(s, p)),
                             in_axes=(0, None)))
    greedy = jax.jit(jax.vmap(JP.pretrained_bayes_bot(jenv, jm, greedy=True),
                              in_axes=(0, None, 0)))
    sample = jax.jit(jax.vmap(JP.pretrained_bayes_bot(jenv, jm),
                              in_axes=(0, None, 0)))
    return feats, logits, prior, greedy, sample


def _gap(x, legal):
    """Per cell: (top - runner-up) of ``x`` over the legal arms, float64."""
    x = x.double().masked_fill(~legal, float("-inf"))
    top = x.amax(-1, keepdim=True)
    below = torch.where(x < top, x, float("-inf")).amax(-1)
    return (top[..., 0] - below), top[..., 0]


@pytest.mark.parametrize("map_rel", [MAP8, MAP16])
def test_features_logits_priors_and_arms_equal_jax(map_rel):
    """On recorded RandomBiasedAI states (in-flight moves and produces,
    idle copies, a side wiped out), both players: the eight features
    bit-equal, the logits and the prior within their tolerances, the
    greedy and the sampled (JAX's Gumbels) actions equal outside the
    margin."""
    jenv, env, s = _states(map_rel)
    jm = JP.load_pretrained(_xml("WR")[0], jenv)
    pm = TP.load_pretrained(pretrained_wr(), env)
    feats, logits, prior, greedy, sample = _jax_fns(jenv, jm)
    js = jax_state(s)
    sp = arm_space(env)
    keys = jax.random.split(jax.random.PRNGKey(3), s.batch)
    gum = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (env.h, env.w, sp.n_arms)))(keys)))
    skipped, held, smallest = 0, 0, np.inf
    for p in (0, 1):
        assert_eq(feats(js, p),
                  TP.compute_features_java(s, p, env.cfg.engine,
                                           pm.feature_sizes), f"feats p{p}")
        mask = env.masks(s, p)
        lg = TP.aim_predict(pm, s, mask, p, "logits")
        np.testing.assert_allclose(lg.numpy(), np.asarray(logits(js, p)),
                                   rtol=LOGIT_RTOL, atol=0)
        np.testing.assert_allclose(
            TP.aim_predict(pm, s, mask, p, "prior").numpy(),
            np.asarray(prior(js, p)), rtol=0, atol=PRIOR_ATOL)
        can = mask[..., 0].bool()
        legal = arm_masks_packed(sp, mask)
        gap, top = _gap(lg, legal)
        ok_g = gap >= MARGIN * top.abs().clamp(min=1.0)
        ga = TP.aim_predict(pm, s, mask, p, "greedy")[1]
        p_, _ = TP.softmax_legal(lg, legal)
        w = torch.where((p_ > 0).any(-1, keepdim=True), p_, 1.0)
        gap_s, _ = _gap(torch.log(w + 1e-20) + gum,
                        torch.ones_like(legal))
        ok_s = gap_s >= MARGIN
        sa = TP.aim_predict(pm, s, mask, p, "sample", gum)[1]
        for ok, g, got, want in ((ok_g, gap, ga, greedy(js, p, keys)),
                                 (ok_s, gap_s, sa, sample(js, p, keys))):
            keep = ok | ~can
            want = np.asarray(want)
            assert_eq(want[keep.numpy()], got[keep], f"arms p{p}")
            skipped += int((can & ~ok).sum())
            held += int((can & ok).sum())
            if (can & ~ok).any():
                smallest = min(smallest, float(g[can & ~ok].min()))
    print(f"{map_rel}: {held} acting cells held, {skipped} under the "
          f"margin (smallest gap {smallest})")
    assert held > 0


def _random_boards(n, h, w, seed):
    """``n`` boards with units of both players (and neutrals) at seeded
    random cells: a plain ``State`` whose only planes set are the type,
    owner and terrain (what the centroid features read)."""
    rng = np.random.default_rng(seed)
    B = n
    utype = np.zeros((B, h, w), np.int8)
    owner = np.full((B, h, w), -1, np.int8)
    for b in range(B):
        k = rng.integers(1, max(2, h * w // 4))
        cells = rng.choice(h * w, size=k, replace=False)
        utype.reshape(B, -1)[b, cells] = rng.integers(1, 8, size=k)
        owner.reshape(B, -1)[b, cells] = rng.integers(-1, 2, size=k)
    owner[utype == 1] = -1                      # resources are neutral
    env = GridnetEnv(asset_path(MAP16 if h == 16 else MAP8), device="cpu")
    s = env.reset(B)
    return s.replace(utype=torch.from_numpy(utype),
                     owner=torch.from_numpy(owner),
                     busy=torch.zeros_like(s.busy))


@pytest.mark.parametrize("h", [8, 16])
def test_centroid_bins_census(h):
    """The two centroid-direction features of 400 seeded random boards,
    every cell, both players: equal to JAX's bins; the census of bins and
    the smallest distance of ``(atan2 + pi/8) / (pi/4)`` to a bin edge
    printed."""
    s = _random_boards(400, h, h, h)
    jenv = JaxEnv(jax_asset_path(MAP16 if h == 16 else MAP8))
    env = GridnetEnv(asset_path(MAP16 if h == 16 else MAP8), device="cpu")
    jm = JP.load_pretrained(_xml("WR")[0], jenv)
    feats = _jax_fns(jenv, jm)[0]
    js = jax_state(s)
    census = np.zeros(8, np.int64)
    edge = np.inf
    for p in (0, 1):
        got = TP.compute_features_java(s, p, env.cfg.engine,
                                       TP.java_feature_sizes(env.cfg.engine))
        want = np.asarray(feats(js, p))
        assert_eq(want[..., 1:3], got[..., 1:3], f"bins p{p}")
        census += np.bincount(got[..., 1:3].flatten().numpy(), minlength=8)
        for mask in ((s.utype > 0) & (s.owner == p),
                     (s.utype > 0) & (s.owner >= 0) & (s.owner != p)):
            m = mask.double()
            n = m.sum((1, 2), keepdim=True).clamp(min=1)
            ys, xs = torch.meshgrid(torch.arange(h), torch.arange(h),
                                    indexing="ij")
            dx = (m * xs).sum((1, 2), keepdim=True) / n - xs
            dy = (m * ys).sum((1, 2), keepdim=True) / n - ys
            q = (torch.atan2(dx, dy) + np.pi / 8) % (2 * np.pi) / (np.pi / 4)
            d = (q - q.round()).abs()
            edge = min(edge, float(d[(dx != 0) | (dy != 0)].min()))
    print(f"{h}x{h}: bins {census.tolist()}, smallest distance to a bin "
          f"edge {edge:.3e}")
    assert (census > 0).all()
