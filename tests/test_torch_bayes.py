"""The naive-Bayes models (``ml.bayes``, K14b's plain version) against the
JAX package's on the CPU.

Integers (the nine features, the trained counts, the arms) must be equal,
and so must ``fit_calibration``'s exponent.  Tolerance of the log
posterior: JAX takes ``log(cpd + 1) - log(row total)`` inside every call
(XLA's ``log``), the port once in ``nb_tables`` (PyTorch's ``log``), an
ulp apart at most (~5e-7 of a term of magnitude ~5), and the nine terms
times ``c`` add in the same order: 1e-5 absolute.  Greedy and sampled arms
are held equal where the winner's margin is at least 1e-6, the cells
below it counted and their smallest margin printed.
"""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from microrts_tpu.ml import bayes as JB
from microrts_tpu_torch.engine.types import MOVE, NONE, PRODUCE, ATTACK
from microrts_tpu_torch.ml import bayes as TB
from microrts_tpu_torch.ops.arms import arm_masks_packed, arm_space
from microrts_tpu_torch.utils.checkpoint import learned_from_jax

from torch_parity import assert_eq, jax_state, torch_one_thread  # noqa
from torch_playout_parity import recorded

pytestmark = pytest.mark.usefixtures("torch_one_thread")

MAP8 = "maps/8x8/basesWorkers8x8.xml"
MAP16 = "maps/16x16/basesWorkers16x16.xml"
POST_ATOL = 1e-5
MARGIN = 1e-6


def _model(sp, cfg, seed, c=0.35):
    rng = np.random.default_rng(seed)
    return TB.NaiveBayesModel(
        prior=rng.integers(0, 60, sp.n_arms).astype(np.float64),
        cpds=[rng.integers(0, 25, (sp.n_arms, x)).astype(np.float64)
              for x in TB.feature_sizes(cfg)], calibration=c)


def _gap(x, legal):
    x = x.double().masked_fill(~legal, float("-inf"))
    top = x.amax(-1, keepdim=True)
    below = torch.where(x < top, x, float("-inf")).amax(-1)
    return top[..., 0] - below


@pytest.mark.parametrize("map_rel", [MAP8, MAP16])
def test_features_posteriors_and_arms_equal_jax(map_rel):
    """Recorded RandomBiasedAI states, both players: the nine features
    bit-equal, the log posterior within 1e-5, the greedy and sampled
    (JAX's Gumbels) actions of ``bayes_bot`` equal outside the margin."""
    jenv, env, s = recorded(map_rel)
    cfg = env.cfg.engine
    sp = arm_space(env)
    assert TB.feature_sizes(cfg) == JB.feature_sizes(jenv.cfg.engine)
    assert list(cfg.barracks_like) == JB._barracks_like(jenv.cfg.engine)
    model = _model(sp, cfg, 1)
    tab = TB.nb_tables(model, "cpu")
    jcfg = jenv.cfg.engine
    arrays = (jnp.asarray(model.prior, jnp.float32),
              [jnp.asarray(c, jnp.float32) for c in model.cpds])
    feats = jax.jit(jax.vmap(lambda st, p: JB.compute_features(st, p, jcfg),
                             in_axes=(0, None)))
    post = jax.jit(jax.vmap(lambda st, p: JB.predict_log_posterior(
        arrays, JB.compute_features(st, p, jcfg),
        jnp.float32(model.calibration)), in_axes=(0, None)))
    greedy = jax.jit(jax.vmap(JB.bayes_bot(jenv, model, greedy=True),
                              in_axes=(0, None, 0)))
    sample = jax.jit(jax.vmap(JB.bayes_bot(jenv, model),
                              in_axes=(0, None, 0)))
    js = jax_state(s)
    keys = jax.random.split(jax.random.PRNGKey(5), s.batch)
    gum = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (env.h, env.w, sp.n_arms)))(keys)))
    held = skipped = 0
    smallest = np.inf
    for p in (0, 1):
        assert_eq(feats(js, p), TB.compute_features(s, p, cfg), f"p{p}")
        mask = env.masks(s, p)
        lp = TB.nb_predict(tab, cfg, sp, s, mask, p, "logits")
        np.testing.assert_allclose(lp.numpy(), np.asarray(post(js, p)),
                                   rtol=0, atol=POST_ATOL)
        can = mask[..., 0].bool()
        legal = arm_masks_packed(sp, mask)
        mx = lp.masked_fill(~legal, float("-inf")).amax(-1, keepdim=True)
        pr = torch.where(legal, torch.exp(lp - mx), 0.0)
        w = torch.where((pr > 0).any(-1, keepdim=True), pr, 1.0)
        cases = (("greedy", None, _gap(lp, legal), greedy),
                 ("sample", gum, _gap(torch.log(w + 1e-20) + gum,
                                      torch.ones_like(legal)), sample))
        for mode, g, gap, jfn in cases:
            got = TB.nb_predict(tab, cfg, sp, s, mask, p, mode, g)[1]
            ok = gap >= MARGIN
            keep = ok | ~can
            assert_eq(np.asarray(jfn(js, p, keys))[keep.numpy()], got[keep],
                      f"{mode} p{p}")
            held += int((can & ok).sum())
            skipped += int((can & ~ok).sum())
            if (can & ~ok).any():
                smallest = min(smallest, float(gap[can & ~ok].min()))
    print(f"{map_rel}: {held} acting cells held, {skipped} under the margin"
          f" (smallest gap {smallest})")
    assert held > 0


def test_fit_calibration_equals_jax():
    """The line search's exponent on seeded held-out instances equals
    JAX's (and is interior)."""
    env = recorded(MAP8)[1]
    cfg = env.cfg.engine
    sp = arm_space(env)
    sizes = TB.feature_sizes(cfg)
    rng = np.random.default_rng(7)
    model = _model(sp, cfg, 2)
    # labels that follow the model loosely: the arm of the largest count
    # of one feature's value, else a random arm
    held = []
    for _ in range(300):
        f = np.array([rng.integers(0, x) for x in sizes], np.int32)
        a = (int(np.argmax(model.cpds[4][:, f[4]])) if rng.random() < 0.4
             else int(rng.integers(0, sp.n_arms)))
        held.append((f, a))
    c = TB.fit_calibration(model, held)
    assert c == JB.fit_calibration(JB.NaiveBayesModel(
        model.prior, model.cpds), held)
    print(f"calibration {c}")


def _trace_xml(env, s, path, rng):
    """A reference-format trace (``rts.Trace``) of the port states ``s``,
    one entry a state, with seeded unit actions (some attacks out of the
    window, which training skips), written to ``path``."""
    utt = env.utt
    root = ET.Element("rts.Trace")
    u_e = ET.SubElement(root, "rts.units.UnitTypeTable",
                        moveConflictResolutionStrategy="1")
    for ut in utt.unit_types:
        e = ET.SubElement(u_e, "rts.units.UnitType", ID=str(ut.ID),
                          name=ut.name, cost=str(ut.cost), hp=str(ut.hp),
                          minDamage=str(ut.min_damage),
                          maxDamage=str(ut.max_damage),
                          attackRange=str(ut.attack_range),
                          produceTime=str(ut.produce_time),
                          moveTime=str(ut.move_time),
                          attackTime=str(ut.attack_time),
                          harvestTime=str(ut.harvest_time),
                          returnTime=str(ut.return_time),
                          harvestAmount=str(ut.harvest_amount),
                          sightRadius=str(ut.sight_radius),
                          isResource=str(ut.is_resource).lower(),
                          isStockpile=str(ut.is_stockpile).lower(),
                          canHarvest=str(ut.can_harvest).lower(),
                          canMove=str(ut.can_move).lower(),
                          canAttack=str(ut.can_attack).lower())
        for n in ut.produces:
            ET.SubElement(e, "produces", type=n)
        for n in ut.produced_by:
            ET.SubElement(e, "producedBy", type=n)
    entries = ET.SubElement(root, "entries")
    for b in range(s.batch):
        te = ET.SubElement(entries, "rts.TraceEntry",
                           time=str(int(s.time[b])))
        pg = ET.SubElement(te, "rts.PhysicalGameState", width=str(env.w),
                           height=str(env.h))
        ET.SubElement(pg, "terrain").text = "".join(
            str(int(v)) for v in s.terrain[b].flatten())
        pl = ET.SubElement(pg, "players")
        for p in (0, 1):
            ET.SubElement(pl, "rts.Player", ID=str(p),
                          resources=str(int(s.resources[b, p])))
        un = ET.SubElement(pg, "units")
        acts = ET.SubElement(te, "actions")
        ys, xs = np.nonzero(s.utype[b].numpy() > 0)
        for y, x in zip(ys, xs):
            ut = utt.unit_types[int(s.utype[b, y, x]) - 1]
            uid = int(s.uid[b, y, x])
            ET.SubElement(un, "rts.units.Unit", type=ut.name, ID=str(uid),
                          player=str(int(s.owner[b, y, x])), x=str(x),
                          y=str(y), resources=str(int(s.carried[b, y, x])),
                          hitpoints=str(int(s.hp[b, y, x])))
            if int(s.owner[b, y, x]) < 0 or rng.random() < 0.3:
                continue
            at = int(rng.integers(NONE, ATTACK + 1))
            kw = dict(type=str(at), parameter=str(int(rng.integers(0, 4))))
            if at == ATTACK:
                kw.update(x=str(x + int(rng.integers(-4, 5))),
                          y=str(y + int(rng.integers(-4, 5))))
            elif at == PRODUCE:
                kw["unitType"] = utt.unit_types[
                    int(rng.integers(1, len(utt.unit_types)))].name
            elif at == MOVE and rng.random() < 0.5:
                kw["parameter"] = "1"
            a = ET.SubElement(acts, "action", unitID=str(uid))
            ET.SubElement(a, "UnitAction", **kw)
    ET.ElementTree(root).write(path)


def test_train_from_traces_equals_jax(tmp_path):
    """Counts and the calibration trained from a trace XML the test
    writes (recorded 8x8 states, seeded actions, a zipped copy too) equal
    JAX's; the model round-trips the JAX npz layout both ways."""
    jenv, env, s = recorded(MAP8)
    path = str(tmp_path / "trace.xml")
    _trace_xml(env, s, path, np.random.default_rng(3))
    import zipfile
    zpath = str(tmp_path / "trace.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(path, "trace.xml")
    jm = JB.train_from_traces(jenv, [path, zpath], calibrate=True)
    tm = TB.train_from_traces(env, [path, zpath], calibrate=True)
    assert tm.prior.sum() > 0
    assert_eq(jm.prior, tm.prior, "prior")
    for a, b in zip(jm.cpds, tm.cpds):
        assert_eq(a, b, "cpd")
    assert jm.calibration == tm.calibration
    # the npz layout, both ways, and the carry-over
    jm.save(str(tmp_path / "j.npz"))
    back = TB.NaiveBayesModel.load(str(tmp_path / "j.npz"))
    tm.save(str(tmp_path / "t.npz"))
    jback = JB.NaiveBayesModel.load(str(tmp_path / "t.npz"))
    for m in (back, learned_from_jax(jm, env)):
        assert_eq(jm.prior, m.prior, "prior")
        assert m.calibration == jm.calibration
    assert_eq(tm.cpds[3], jback.cpds[3], "cpd3")
    print(f"{int(tm.prior.sum())} labels, calibration {tm.calibration}")
