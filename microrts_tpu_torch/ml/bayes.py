"""Naive-Bayes unit-action models: train from traces, play as a stochastic
AI.

A port of ``microrts_tpu.ml.bayes`` (see its docstring for the Java
sources).  The label space is the arm catalog (``ops.arms``); a model is
prior counts ``[A]`` and one count table ``[A, Xj]`` per feature
(``NaiveBayesModel``, saved to and loaded from the JAX package's npz
layout), and the posterior of every cell of a batch of boards is K14b
(``nb_predict``): the nine features of ``compute_features`` (carried
resources, the two centroid directions, the barracks flag, the occupancy
at four offsets, the unit's type) and ``log prior + c * sum_j log cpd_j``.

JAX computes the Laplace-smoothed log tables inside every call; the port
computes them once, in float32 in JAX's order (``log(x + 1) - log(row
total)``), when a model is put on a device (``nb_tables``).  On CUDA
tensors the posterior and the bot's draw are the ``nb_predict`` kernel;
CPU tensors (or ``plain=True``) take the plain version.  The traces are
read through the port's own copy of the trace reader
(``interop.trace``).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels as KN
from ..bots.scripted import Opponent
from ..engine.kernel import as_player, shift
from ..engine.types import (ATTACK, HARVEST, MOVE, PRODUCE, RETURN,
                            EngineConfig, State)
from ..models.gridnet_policy import gumbel_noise
from ..ops.arms import (ArmSpace, arm_masks_packed, arm_space,
                        arms_to_action_plain, first_max, sample_arms)
from .pretrained import OFFS, centroid_dir

I32 = torch.int32
F32 = torch.float32
N_CARRY, N_DIR, N_BARR = 3, 8, 2
MODES = ("logits", "sample", "greedy")


def feature_sizes(cfg: EngineConfig) -> Tuple[int, ...]:
    T = cfg.num_types
    occ = 2 + 2 * T
    return (N_CARRY, N_DIR, N_DIR, N_BARR) + (occ,) * 4 + (T,)


def compute_features(state: State, player, cfg: EngineConfig
                     ) -> torch.Tensor:
    """int32 ``[B, H, W, 9]`` per-cell features for ``player`` (an int or
    int32 ``[B]``; valid where its units stand)."""
    T = cfg.num_types
    me = as_player(player, state.device)
    t = (state.utype.to(I32) - 1).clamp(0, T - 1)
    exists = state.utype > 0
    owner = state.owner.to(I32)
    mine = exists & (owner == me)
    enemy = exists & (owner >= 0) & (owner != me)
    barr = torch.zeros_like(exists)
    for b in cfg.barracks_like:
        barr = barr | (mine & (t == b))
    have_barr = barr.flatten(1).any(1).to(I32)[:, None, None]
    wall = state.terrain != 0
    occ = []
    for (xo, yo) in OFFS:
        # the value AT cell (x - xo, y - yo), read back at (x, y)
        s_t = shift(t, xo, yo, 0)
        occ.append(torch.where(
            shift(mine, xo, yo, False), 2 + s_t,
            torch.where(shift(enemy, xo, yo, False), 2 + T + s_t,
                        torch.where(shift(wall, xo, yo, True), 1, 0))))
    return torch.stack([
        state.carried.to(I32).clamp(0, N_CARRY - 1),
        centroid_dir(mine), centroid_dir(enemy),
        have_barr.expand_as(t), *occ, t], -1).to(I32)


@dataclasses.dataclass
class NaiveBayesModel:
    """Prior counts ``[A]`` + per-feature count tables ``[A, Xj]``
    (Laplace +1 at predict), calibration exponent ``c``
    (CalibratedNaiveBayes fields); numpy arrays, as the JAX package keeps
    them."""
    prior: np.ndarray
    cpds: List[np.ndarray]
    calibration: float = 1.0

    def save(self, path: str) -> None:
        np.savez(path, prior=self.prior, calibration=self.calibration,
                 **{f"cpd{j}": c for j, c in enumerate(self.cpds)})

    @classmethod
    def load(cls, path: str) -> "NaiveBayesModel":
        z = np.load(path)
        cpds = [z[f"cpd{j}"] for j in range(len(z.files) - 2)]
        return cls(prior=z["prior"], cpds=cpds,
                   calibration=float(z["calibration"]))


class NBTables(NamedTuple):
    """A model's log tables on a device: the log prior float32 ``[A]``,
    the per-feature ``log((cpd + 1) / row total)`` concatenated along the
    value axis ``[A, sum Xj]``, each feature's column offset, and ``c``."""
    log_prior: torch.Tensor
    logc: torch.Tensor
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    c: float


def nb_tables(model: NaiveBayesModel, device) -> NBTables:
    """The log tables of ``model`` in float32, in JAX's order
    (ml/bayes.py:223-236): ``log(prior + 1) - log(sum(prior + 1))`` and
    ``log(cpd + 1) - log(sum(cpd + 1, 1))``."""
    prior = torch.as_tensor(np.asarray(model.prior, np.float32))
    lp = torch.log(prior + 1.0) - torch.log(torch.sum(prior + 1.0))
    cols, offs, sizes, o = [], [], [], 0
    for cpd in model.cpds:
        c = torch.as_tensor(np.asarray(cpd, np.float32))
        row_tot = torch.sum(c + 1.0, 1, keepdim=True)
        cols.append(torch.log(c + 1.0) - torch.log(row_tot))
        offs.append(o)
        sizes.append(c.shape[1])
        o += c.shape[1]
    return NBTables(lp.to(device), torch.cat(cols, 1).contiguous().to(device),
                    tuple(offs), tuple(sizes),
                    float(np.float32(model.calibration)))


def predict_log_posterior(tab: NBTables, feats: torch.Tensor
                          ) -> torch.Tensor:
    """log posterior float32 ``[..., A]`` from feature planes int32
    ``[..., F]``: ``log prior + c * log cpd_j`` added feature by feature."""
    c = torch.tensor(tab.c, dtype=F32, device=feats.device)
    logp = tab.log_prior.expand(feats.shape[:-1] + tab.log_prior.shape)
    for j, o in enumerate(tab.offsets):
        logp = logp + c * tab.logc.T[o + feats[..., j].long()]
    return logp


def nb_predict_plain(tab: NBTables, cfg: EngineConfig, sp: ArmSpace,
                     state: State, mask, player, mode: str, gumbel=None):
    logp = predict_log_posterior(tab, compute_features(state, player, cfg))
    if mode == "logits":
        return logp
    legal = arm_masks_packed(sp, mask)
    can = mask[..., 0].bool()
    ninf = torch.tensor(float("-inf"), dtype=F32, device=logp.device)
    if mode == "greedy":
        arm = torch.where(can, first_max(torch.where(legal, logp, ninf)),
                          -1).to(I32)
    else:
        mx = torch.where(legal, logp, ninf).amax(-1, keepdim=True)
        probs = torch.where(legal, torch.exp(logp - mx), 0.0)
        arm = sample_arms(sp, gumbel, probs, can)
    return arm, arms_to_action_plain(sp, arm)


def nb_predict(tab: NBTables, cfg: EngineConfig, sp: ArmSpace,
               state: State, mask: torch.Tensor, player,
               mode: str = "logits", gumbel: torch.Tensor = None,
               plain: bool = False):
    """K14b for ``player`` (an int or int32 ``[B]``) on the env's packed
    mask ``mask`` int32 ``[B, H, W, 23+T+D*D]`` (read by the bot's
    modes): ``"logits"`` the log posterior float32 ``[B, H, W, A]``;
    ``"sample"`` (Gumbel noise float32 ``[B, H, W, A]``) or ``"greedy"``
    (arms int32 ``[B, H, W]``, gridnet action int32 ``[B, H, W, 7]``)."""
    if mode not in MODES:
        raise ValueError(f"nb_predict: unknown mode {mode!r}")
    if mode == "sample" and gumbel is None:
        raise ValueError("nb_predict: mode 'sample' needs gumbel noise")
    if not plain and mask.device.type != "cpu":
        return KN.NB_PREDICT(tab, cfg, sp, state, mask, player,
                             MODES.index(mode), gumbel)
    return nb_predict_plain(tab, cfg, sp, state, mask, player, mode, gumbel)


def bayes_bot(env, model: NaiveBayesModel, greedy: bool = False
              ) -> Opponent:
    """The UnitActionProbabilityDistributionAI analog over a naive-Bayes
    model: each unit samples (or argmaxes) the predicted distribution
    over its legal arms.  Its noise is Gumbel float32 ``[B, H, W, A]``
    (none when greedy)."""
    cfg = env.cfg.engine
    sp = arm_space(env)
    tab = nb_tables(model, env.device)
    mode = "greedy" if greedy else "sample"

    def bot(state: State, player, gumbel=None) -> torch.Tensor:
        mask = env.masks(state, player)
        return nb_predict(tab, cfg, sp, state, mask, player, mode, gumbel,
                          plain=not env.engine._use_kernel(mask))[1]

    def draw(gen: torch.Generator, batch: int):
        if greedy:
            return None
        return gumbel_noise((batch, env.h, env.w, sp.n_arms), gen,
                            env.device)

    return Opponent(bot, draw)


def fit_calibration(model: NaiveBayesModel,
                    held: List[Tuple[np.ndarray, int]]) -> float:
    """Line-search the exponent c maximising the held-out log-likelihood,
    stopping at the first decrease (calibrateProbabilities:86-140)."""
    feats = torch.as_tensor(np.stack([f for f, _ in held]), dtype=I32)
    ys = torch.as_tensor(np.asarray([a for _, a in held])).long()
    base = nb_tables(model, "cpu")

    def loglik(c):
        tab = base._replace(c=float(np.float32(c)))
        lp = predict_log_posterior(tab, feats)
        lp = lp - torch.logsumexp(lp, -1, keepdim=True)
        return float(lp[torch.arange(len(ys)), ys].sum())

    best_c, best_ll = 0.0, -np.inf
    for c in np.arange(0.0, 1.051, 0.05):
        ll = loglik(c)
        if ll > best_ll:
            best_c, best_ll = float(c), ll
        else:
            break
    return best_c


def _labels_from_entry(entry, sp: ArmSpace, h: int, w: int,
                       player: int) -> np.ndarray:
    """int32 ``[H, W]`` arm label per acting cell of ``player``, -1
    elsewhere (the y of TrainingInstance; an AttackLocation becomes the
    relative window index, CalibratedNaiveBayes.calibrateProbabilities
    :96-99)."""
    R = (sp.diam - 1) // 2
    lab = np.full((h, w), -1, np.int32)
    by_id = {u.ID: u for u in entry.pgs.units}
    T = sp.num_types
    for uid, ua in entry.actions:
        u = by_id.get(uid)
        if u is None or u.player != player:
            continue
        if ua.type == MOVE:
            arm = 1 + ua.parameter
        elif ua.type == HARVEST:
            arm = 5 + ua.parameter
        elif ua.type == RETURN:
            arm = 9 + ua.parameter
        elif ua.type == PRODUCE:
            arm = 13 + ua.parameter * T + ua.unit_type
        elif ua.type == ATTACK:
            dx, dy = ua.x - u.x, ua.y - u.y
            if abs(dx) > R or abs(dy) > R:
                continue
            arm = sp.attack_base + (R + dy) * sp.diam + (R + dx)
        else:
            arm = 0
        lab[u.y, u.x] = arm
    return lab


def train_from_traces(env, trace_paths: Sequence[str],
                      calibrate: bool = False,
                      max_entries_per_trace: int = 10 ** 9
                      ) -> NaiveBayesModel:
    """Count-based naive-Bayes training over recorded traces
    (CalibratedNaiveBayes.train:68-84), the features computed on the
    CPU."""
    from ..engine.types import state_from_pgs
    from ..interop.trace import load_trace

    cfg = env.cfg.engine
    sp = arm_space(env)
    A = sp.n_arms
    sizes = feature_sizes(cfg)
    prior = np.zeros(A)
    cpds = [np.zeros((A, x)) for x in sizes]

    held: List[Tuple[np.ndarray, int]] = []   # for calibration
    for path in trace_paths:
        trace = load_trace(path)
        for entry in trace.entries[:max_entries_per_trace]:
            if not entry.actions:
                continue
            st = state_from_pgs(entry.pgs, cfg, 1, "cpu", time=entry.time)
            for player in (0, 1):
                lab = _labels_from_entry(entry, sp, env.h, env.w, player)
                if (lab < 0).all():
                    continue
                f = compute_features(st, player, cfg)[0].numpy()
                ys, xs = np.nonzero(lab >= 0)
                for y, x in zip(ys, xs):
                    a = lab[y, x]
                    prior[a] += 1
                    for j in range(len(sizes)):
                        cpds[j][a, f[y, x, j]] += 1
                    if calibrate:
                        held.append((f[y, x], a))

    model = NaiveBayesModel(prior=prior, cpds=cpds)
    if calibrate and held:
        model.calibration = fit_calibration(model, held)
    return model
