"""Import and batched inference of the reference's pretrained Bayes models.

A port of ``microrts_tpu.ml.pretrained`` (see its docstring for the Java
sources and the quirks matched).  The host parts are copies: the Java
label catalog mapped onto the arm catalog (``java_catalog_to_arms``),
the XML parse (``_parse_aim``) and the stacked per-unit-type tables
(``load_pretrained``, a ``PretrainedBayes`` of tensors on the env's
device).  The shipped models live in the port's
``assets/bayesianmodels/`` (``ActionInterdependenceModel-*.xml``).

The device part is one function of a batch of states, K14a
(``aim_predict``): the eight features of FeatureGeneratorSimple
(``compute_features_java``: the centroid directions, the barracks flag,
the occupancy codes at four offsets with the cells that in-flight moves
and produces reserve), the calibrated log-scores over the arms
(``predict_arm_logits``), and from them, by ``mode``, the logits, the
normalised prior over the legal arms (``make_prior_fn``), or the bot's
sampled (Gumbel) or greedy arms and their gridnet action
(``pretrained_bayes_bot``).  On CUDA tensors it is the ``aim_predict``
kernel; CPU tensors (or ``plain=True``) take the plain version, which
sums in the kernel's order: the eight CPD terms after the prior, the
interdependence term over the six types one by one, the softmax's total
over the arms one by one.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import kernels as KN
from ..engine.kernel import as_player, iota, shift, push
from ..engine.types import (ATTACK, HARVEST, MOVE, NONE, PRODUCE, RETURN,
                            EngineConfig, State)
from ..models.gridnet_policy import gumbel_noise
from ..ops.arms import (ArmSpace, arm_masks_packed, arm_space,
                        arms_to_action_plain, first_max, sample_arms)
from ..bots.scripted import Opponent

I32 = torch.int32
F32 = torch.float32
N_ACTION_TYPES = 6   # UnitAction.NUMBER_OF_ACTION_TYPES
MODES = ("logits", "prior", "sample", "greedy")
# the occupancy offsets (xo, yo) of FeatureGeneratorSimple.java:87-89
OFFS = ((-2, 0), (0, -2), (2, 0), (0, 2))
# float32 constants rounded as the JAX package's weakly typed Python
# floats round against float32 arrays
PI_8 = float(np.float32(np.pi / 8.0))
TWO_PI = float(np.float32(2 * np.pi))
PI_4 = float(np.float32(np.pi / 4.0))


def _attack_disc(max_range: int) -> List[Tuple[int, int]]:
    """(ox, oy) offsets in the Java catalog order (ox-major,
    BayesianModel.java:164-172)."""
    out = []
    for ox in range(-max_range, max_range + 1):
        for oy in range(-max_range, max_range + 1):
            d = ox * ox + oy * oy
            if 0 < d <= max_range * max_range:
                out.append((ox, oy))
    return out


def java_catalog_to_arms(cfg: EngineConfig, sp: ArmSpace,
                         ysize: int) -> np.ndarray:
    """int32 [Ysize]: Java Y index -> arm id (-1 = unrepresentable).  The
    produce section is 4 * P entries, P inferred from Ysize (all T types
    in the shipped files, the producible ones in fresh catalogs), laid
    out d-major."""
    T = cfg.num_types
    disc = _attack_disc(cfg.max_range)
    P = (ysize - 13 - len(disc)) // 4
    if 13 + 4 * P + len(disc) != ysize:
        raise ValueError(f"cannot lay out Ysize={ysize} "
                         f"(T={T}, disc={len(disc)})")
    if P == T:
        prod_types = list(range(T))
    else:
        prod_types = [t for t in range(T) if any(
            cfg.produces[p][t] for p in range(T))]
        if len(prod_types) != P:
            raise ValueError(f"produce section {P} matches neither all "
                             f"{T} types nor {len(prod_types)} producible")
    m = np.full(ysize, -1, np.int32)
    m[0] = 0                                   # NONE
    for d in range(4):
        m[1 + d] = 1 + d                       # MOVE
        m[5 + d] = 5 + d                       # HARVEST
        m[9 + d] = 9 + d                       # RETURN
    i = 13
    for d in range(4):
        for t in prod_types:
            m[i] = 13 + d * T + t
            i += 1
    R = (sp.diam - 1) // 2
    for (ox, oy) in disc:
        m[i] = sp.attack_base + (R + oy) * sp.diam + (R + ox)
        i += 1
    return m


def arm_action_types(sp: ArmSpace) -> np.ndarray:
    """int32 [A]: UnitAction type id of every arm."""
    T = sp.num_types
    ty = np.zeros(sp.n_arms, np.int32)
    ty[0] = NONE
    ty[1:5] = MOVE
    ty[5:9] = HARVEST
    ty[9:13] = RETURN
    ty[13:13 + 4 * T] = PRODUCE
    ty[sp.attack_base:] = ATTACK
    return ty


@dataclasses.dataclass
class _RawModel:
    """One parsed ActionInterdependenceModel (Java index space)."""
    ysize: int
    calibration: float
    xsizes: List[int]
    selected: List[bool]
    prior: np.ndarray             # [Ysize] probabilities
    cpds: List[np.ndarray]        # per feature: [Ysize, Xj] counts
    type_counts: np.ndarray       # [6] actiontypes_allowed_counts_prior
    type_pairs: np.ndarray        # [6, 6] selected_allowed_actiontype_prior


def _floats(el) -> np.ndarray:
    return np.asarray([float(t) for t in el.text.split()])


def _parse_aim(el) -> _RawModel:
    # every shipped pretrained file uses ESTIMATION_LAPLACE (=2,
    # BayesianModel.java:27); the COUNTS variant is not implemented
    if int(el.get("estimationMethod")) != 2:
        raise ValueError(f"estimationMethod {el.get('estimationMethod')}: "
                         "only Laplace (2) is read")
    ysize = int(el.get("Ysize"))
    nfeat = int(el.get("nfeatures"))
    cal = float(el.get("calibrationFactor"))
    xsizes = [int(t) for t in el.find("Xsizes").text.split()][:nfeat]
    prior = _floats(el.find("priorDistribution"))
    sf = el.find("selectedFeatures")
    selected = ([t == "true" for t in sf.text.split()][:nfeat]
                if sf is not None and sf.text and sf.text.strip()
                else [True] * nfeat)
    cpds = []
    for cpd in el.findall("DiscreteCPD"):
        xv = int(cpd.get("Xvalues"))     # = Ysize (rows)
        yv = int(cpd.get("Yvalues"))     # = feature cardinality (cols)
        vals = np.asarray([float(t) for t in cpd.text.split()])
        cpds.append(vals.reshape(xv, yv))
    tc_el = el.find("actiontypes_allowed_counts_prior")
    tp_el = el.find("selected_allowed_actiontype_prior")
    tc = (_floats(tc_el) if tc_el is not None
          else np.zeros(N_ACTION_TYPES))
    tp = (_floats(tp_el).reshape(N_ACTION_TYPES, N_ACTION_TYPES)
          if tp_el is not None
          else np.zeros((N_ACTION_TYPES, N_ACTION_TYPES)))
    if len(cpds) != nfeat or len(prior) != ysize:
        raise ValueError("malformed ActionInterdependenceModel")
    return _RawModel(ysize, cal, xsizes, selected, prior, cpds, tc, tp)


@dataclasses.dataclass
class PretrainedBayes:
    """Per-unit-type AIM models remapped onto the arm space and stacked
    ``[T, ...]`` (float32 tensors on one device); ``cpd_cat`` is the
    eight ``log_cpds`` concatenated along their value axis, the kernel's
    table."""
    cfg: EngineConfig
    sp: ArmSpace
    log_prior: torch.Tensor       # [T, A]
    log_cpds: List[torch.Tensor]  # per feature: [T, A, S_j]
    log_tf: torch.Tensor          # [T, 6, 6] log((S+1)/(C+2))
    nf_base: torch.Tensor         # [T] 1 + n selected features
    calibration: torch.Tensor     # [T]
    arm_type: torch.Tensor        # int32 [A] action type of each arm
    feature_sizes: Tuple[int, ...]
    cpd_cat: torch.Tensor         # [T, A, sum(feature_sizes)]


def java_feature_sizes(cfg: EngineConfig) -> Tuple[int, ...]:
    """Static per-feature cardinalities of ``compute_features_java`` (the
    carried resources capped at 8: a value past a model's stored
    cardinality predicts 1/Ysize whatever it is)."""
    occ = 3 + 2 * cfg.num_types
    return (8, 8, 8, 2, occ, occ, occ, occ)


def load_pretrained(path: str, env) -> PretrainedBayes:
    """Parse a pretrained BayesianModelByUnitTypeWithDefaultModel XML and
    remap every model in it onto the arm catalog, on ``env.device``."""
    cfg = env.cfg.engine
    sp = arm_space(env)
    A = sp.n_arms
    root = ET.parse(path).getroot()
    if root.tag != "BayesianModelByUnitTypeWithDefaultModel":
        raise ValueError(f"{path}: root {root.tag!r} is not a "
                         "BayesianModelByUnitTypeWithDefaultModel")
    by_type: Dict[int, _RawModel] = {}
    for ut in root.findall("UnitType"):
        by_type[int(ut.get("ID"))] = _parse_aim(
            ut.find("ActionInterdependenceModel"))
    default = _parse_aim(
        root.find("defaultModel").find("ActionInterdependenceModel"))

    sizes = java_feature_sizes(cfg)
    T = cfg.num_types
    EPS = 1e-30

    def remap(raw: _RawModel):
        jmap = java_catalog_to_arms(cfg, sp, raw.ysize)
        prior = np.full(A, EPS)
        for j, a in enumerate(jmap):
            if a >= 0:
                prior[a] = max(raw.prior[j], EPS)
        logcpds = []
        for f in range(len(sizes)):
            counts, stored = raw.cpds[f], raw.cpds[f].shape[1]
            tab = np.full((A, sizes[f]), np.log(1.0 / raw.ysize))
            if raw.selected[f]:
                row_tot = counts.sum(1, keepdims=True)
                lap = (counts + 1.0) / (row_tot + stored)  # beta=1 Laplace
                ours = np.zeros((A, stored))
                for j, a in enumerate(jmap):
                    if a >= 0:
                        ours[a] = lap[j]
                ncols = min(stored, sizes[f])
                tab[:, :ncols] = np.log(np.maximum(ours[:, :ncols], EPS))
            else:
                tab[:] = 0.0          # feature not selected: factor 1
            logcpds.append(tab)
        ltf = np.log((raw.type_pairs + 1.0)
                     / (raw.type_counts[:, None] + 2.0))
        nf = 1.0 + sum(raw.selected)
        return np.log(prior), logcpds, ltf, nf, raw.calibration

    stacks = [remap(by_type.get(t, default)) for t in range(T)]

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(env.device)

    log_cpds = [f32(np.stack([s[1][f] for s in stacks]))
                for f in range(len(sizes))]
    return PretrainedBayes(
        cfg=cfg, sp=sp,
        log_prior=f32(np.stack([s[0] for s in stacks])),
        log_cpds=log_cpds,
        log_tf=f32(np.stack([s[2] for s in stacks])),
        nf_base=f32(np.stack([s[3] for s in stacks])),
        calibration=f32(np.stack([s[4] for s in stacks])),
        arm_type=torch.from_numpy(arm_action_types(sp)).to(env.device),
        feature_sizes=sizes,
        cpd_cat=torch.cat(log_cpds, -1).contiguous())


# ----------------------------------------------------------------------
# the plain versions of K14a

def centroid_dir(mask: torch.Tensor) -> torch.Tensor:
    """int32 ``[B, H, W]``: the bin (0-7) of the direction from each cell
    to the centroid of the cells of bool ``mask [B, H, W]``
    (FeatureGeneratorSimple.java:50-80: ``atan2(dx, dy) + pi/8``, plus
    2 pi where negative, over pi/4, truncated)."""
    B, H, W = mask.shape
    xs, ys = iota(H, W, mask.device)
    xs, ys = xs.to(F32), ys.to(F32)
    n = mask.sum((1, 2), dtype=I32).clamp(min=1).to(F32)[:, None, None]
    zero = torch.zeros((), dtype=F32, device=mask.device)
    cx = torch.where(mask, xs, zero).sum((1, 2), keepdim=True) / n
    cy = torch.where(mask, ys, zero).sum((1, 2), keepdim=True) / n
    ang = torch.atan2(cx - xs, cy - ys) + PI_8
    ang = torch.where(ang < 0, ang + TWO_PI, ang)
    return (ang / PI_4).to(I32).clamp(0, 7)


def _reserved_plane(state: State) -> torch.Tensor:
    """Cells an in-flight MOVE/PRODUCE targets (the complement of
    GameState.free, GameState.java:191-207)."""
    inflight = state.busy & ((state.atype == MOVE)
                             | (state.atype == PRODUCE))
    res = torch.zeros_like(inflight)
    for d in range(4):
        res = res | push(inflight & (state.aparam == d), d, False)
    return res


def compute_features_java(state: State, player, cfg: EngineConfig,
                          sizes: Tuple[int, ...]) -> torch.Tensor:
    """int32 ``[B, H, W, 8]``: FeatureGeneratorSimple.java:21-120 for
    ``player`` (an int or int32 ``[B]``), valid at its units' cells."""
    T = cfg.num_types
    me = as_player(player, state.device)
    t = (state.utype.to(I32) - 1).clamp(0, T - 1)
    exists = state.utype > 0
    owner = state.owner.to(I32)
    mine = exists & (owner == me)
    other = exists & ~mine        # enemies AND neutrals (:92-98)
    friendly = exists & (owner >= 0) & (owner == me)
    enemy_real = exists & (owner >= 0) & (owner != me)
    barr = torch.zeros_like(exists)
    for b in cfg.barracks_like:
        barr = barr | (friendly & (t == b))
    have_barr = barr.flatten(1).any(1).to(I32)[:, None, None]

    reserved = _reserved_plane(state)
    wall = state.terrain != 0
    inb = torch.ones_like(exists)
    occ = []
    for (xo, yo) in OFFS:
        # Java reads the cell (x - xo, y - yo) (:87-89)
        s_t = shift(t, xo, yo, 0)
        f = torch.where(shift(friendly, xo, yo, False), 3 + s_t,
                        torch.where(shift(other, xo, yo, False),
                                    3 + T + s_t,
                                    torch.where(
                                        ~shift(inb, xo, yo, False)
                                        | shift(wall, xo, yo, False), 2,
                                        torch.where(shift(reserved, xo, yo,
                                                          False), 1, 0))))
        occ.append(f)
    return torch.stack([
        state.carried.to(I32).clamp(0, sizes[0] - 1),
        centroid_dir(friendly), centroid_dir(enemy_real),
        have_barr.expand_as(t), *occ], -1).to(I32)


def predict_arm_logits(pm: PretrainedBayes, state: State, player,
                       legal_arms: torch.Tensor) -> torch.Tensor:
    """float32 ``[B, H, W, A]`` calibrated log-scores over the arms
    (AIM.predictDistribution:228-323, before normalisation) from the
    legal arms bool ``[B, H, W, A]``."""
    T = pm.log_prior.shape[0]
    feats = compute_features_java(state, player, pm.cfg,
                                  pm.feature_sizes).long()
    t = (state.utype.long() - 1).clamp(0, T - 1)
    logd = pm.log_prior[t]
    for f, table in enumerate(pm.log_cpds):
        logd = logd + table.permute(0, 2, 1)[t, feats[..., f]]
    # the action-type interdependence over the unit's LEGAL types
    ty = pm.arm_type.long()
    lt = torch.stack([(legal_arms & (ty == j)).any(-1)
                      for j in range(N_ACTION_TYPES)], -1).to(F32)
    tf = pm.log_tf[t]                                   # [B, H, W, 6, 6]
    m_all = tf[..., 0] * lt[..., None, 0]
    for j in range(1, N_ACTION_TYPES):
        m_all = m_all + tf[..., j] * lt[..., None, j]
    diag = torch.diagonal(tf, dim1=-2, dim2=-1)
    contrib = m_all - diag * lt                         # exclude j == i
    logd = logd + contrib[..., ty]
    n_legal = lt.sum(-1)                                # exact
    nf = pm.nf_base[t] + (n_legal - 1.0).clamp(min=0.0)
    c = pm.calibration[t]
    expo = 1.0 / ((1.0 - c) + nf * c)
    return logd * expo[..., None]


def softmax_legal(logits: torch.Tensor, legal: torch.Tensor):
    """(unnormalised ``exp(logits - max)`` over the legal arms, 0
    elsewhere; their total, summed over the arms one by one)."""
    ninf = torch.tensor(float("-inf"), dtype=F32, device=logits.device)
    mx = torch.where(legal, logits, ninf).amax(-1, keepdim=True)
    p = torch.where(legal, torch.exp(logits - mx), 0.0)
    tot = p[..., 0]
    for a in range(1, p.shape[-1]):
        tot = tot + p[..., a]
    return p, tot[..., None]


def aim_predict_plain(pm: PretrainedBayes, state: State, mask, player,
                      mode: str, gumbel=None):
    legal = arm_masks_packed(pm.sp, mask)
    logits = predict_arm_logits(pm, state, player, legal)
    if mode == "logits":
        return logits
    can = mask[..., 0].bool()
    if mode == "greedy":
        ninf = torch.tensor(float("-inf"), dtype=F32, device=logits.device)
        arm = torch.where(can, first_max(torch.where(legal, logits, ninf)),
                          -1).to(I32)
        return arm, arms_to_action_plain(pm.sp, arm)
    p, tot = softmax_legal(logits, legal)
    if mode == "prior":
        uni = legal.to(F32) / legal.sum(-1, keepdim=True,
                                        dtype=I32).clamp(min=1).to(F32)
        return torch.where(tot > 0, p / tot.clamp(min=1e-30), uni)
    arm = sample_arms(pm.sp, gumbel, p, can)
    return arm, arms_to_action_plain(pm.sp, arm)


def aim_predict(pm: PretrainedBayes, state: State, mask: torch.Tensor,
                player, mode: str = "logits",
                gumbel: torch.Tensor = None, plain: bool = False):
    """K14a for ``player`` (an int or int32 ``[B]``) on the env's packed
    mask ``mask`` int32 ``[B, H, W, 23+T+D*D]`` of that player.
    ``mode``: ``"logits"`` (float32 ``[B, H, W, A]``), ``"prior"``
    (``make_prior_fn``'s normalised prior, uniform over the legal arms
    where the model gives them no mass), ``"sample"`` (the bot's draw
    from Gumbel noise float32 ``[B, H, W, A]``) or ``"greedy"``: the last
    two return (arms int32 ``[B, H, W]``, -1 where no unit acts; gridnet
    action int32 ``[B, H, W, 7]``)."""
    if mode not in MODES:
        raise ValueError(f"aim_predict: unknown mode {mode!r}")
    if mode == "sample" and gumbel is None:
        raise ValueError("aim_predict: mode 'sample' needs gumbel noise")
    if not plain and mask.device.type != "cpu":
        return KN.AIM_PREDICT(pm, state, mask, player, MODES.index(mode),
                              gumbel)
    return aim_predict_plain(pm, state, mask, player, mode, gumbel)


# ----------------------------------------------------------------------
# the bots

def _model(env, path_or_model) -> PretrainedBayes:
    return (path_or_model if isinstance(path_or_model, PretrainedBayes)
            else load_pretrained(path_or_model, env))


def pretrained_bayes_bot(env, path_or_model, greedy: bool = False
                         ) -> Opponent:
    """UnitActionProbabilityDistributionAI over a pretrained model: every
    acting unit samples (or argmaxes) its calibrated distribution over
    its legal arms (BayesianModel.filterByPossibleActionIndexes).  Its
    noise is Gumbel float32 ``[B, H, W, A]`` (none when greedy)."""
    pm = _model(env, path_or_model)
    mode = "greedy" if greedy else "sample"

    def bot(state: State, player, gumbel=None) -> torch.Tensor:
        mask = env.masks(state, player)
        return aim_predict(pm, state, mask, player, mode, gumbel,
                           plain=not env.engine._use_kernel(mask))[1]

    def draw(gen: torch.Generator, batch: int):
        if greedy:
            return None
        return gumbel_noise((batch, env.h, env.w, pm.sp.n_arms), gen,
                            env.device)

    return Opponent(bot, draw)


def make_prior_fn(env, path_or_model):
    """``prior_fn(state, player, mask) -> float32 [B, H, W, A]``:
    InformedNaiveMCTS's per-unit exploration bias
    (InformedNaiveMCTSNode.java:66-84, 216), from the env's packed mask
    of ``player`` (an int or int32 ``[B]``)."""
    pm = _model(env, path_or_model)

    def prior_fn(state: State, player, mask: torch.Tensor) -> torch.Tensor:
        return aim_predict(pm, state, mask, player, "prior",
                           plain=not env.engine._use_kernel(mask))

    return prior_fn
