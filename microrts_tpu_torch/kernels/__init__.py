"""The port's hand-written CUDA kernels: build, binding and launchers.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``microrts_tpu_torch/build/``
at first use (all sources at once, one ``nvcc`` each), and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

The launchers (``ACTOR``, ``DECODE``, ``ISSUE_ENV``, ``CYCLE``,
``EPILOGUE``, ``SPLICE_OBS``, ``SAMPLE``, ``LOGPROB``, ``LOGPROB_BWD``,
``RUSH``, ``EVENT_JUMP``, ``EVALUATE``, ``ARM_SAMPLE``,
``ARMS_TO_ACTION``, ``MCTS_DESCEND``, ``MCTS_BACKPROP``, ``ENUM_NEXT``,
``MINIMAX_STEP``, ``ISSUE``, ``PO_STATE``, ``OBS_PO``, ``REROOT``,
``BELIEVE``, ``ENV_HEALTH``, ``DISTANCE_FIELDS``, ``DESCEND``,
``DISTANCE_FIELD2``, ``DESCEND_EXCLUDING``, ``EXPERT_MACRO``,
``EXPERT_DETAILED``, ``RANGE_COVER``, ``DSL_TARGET``, ``AIM_PREDICT``,
``NB_PREDICT``, ``COOPERATIVE_ACT``) take CUDA tensors only: they
check device, dtype, shape and contiguity, allocate the outputs, launch on
PyTorch's current stream, raise if the launch reports a CUDA error, and
count their launches in ``.launches``.  The callers in ``engine``,
``env``, ``bots``, ``ops`` and ``models`` send CPU tensors to the plain
PyTorch versions instead; nothing falls back from a failed build or
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..engine.types import FIELD_DTYPES, Candidates, EngineConfig, State

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
# the kernel sources (csrc/<name>.cu), one shared library each
NAMES = ("actor", "decode", "issue_env", "cycle", "epilogue",
         "splice_obs", "policy_sample", "policy_logprob", "rush", "event",
         "evaluation", "arms", "tree", "enumerate", "minimax", "issue",
         "fog", "believe", "fields", "expert", "synth", "bayes",
         "cooperative")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAXT = 16
MAXNR = 8
NCOMP = 7
MAXOFF = 64
MAXLAD = 3

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # name -> nvcc's -Xptxas -v report


def nvcc_path() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    """The library of ``<name>.cu``, keyed by a hash of that source, every
    shared header (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    for part in ((CSRC / f"{name}.cu").read_bytes(),
                 *[p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))],
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every kernel source not built yet, one ``nvcc`` per source,
    all started together, and load the libraries.  Returns the seconds
    spent; fills ``BUILD_LOG`` with each compiler report."""
    t0 = time.perf_counter()
    todo = [n for n in NAMES if n not in _LIBS]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = _lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            BUILD_LOG[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in todo:
        _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return time.perf_counter() - t0


# ----------------------------------------------------------------------
# C structs (csrc/common.cuh)

class _Cfg(ctypes.Structure):
    _fields_ = [("H", ctypes.c_int), ("W", ctypes.c_int), ("T", ctypes.c_int),
                ("R", ctypes.c_int)] + [
        (f, ctypes.c_int * MAXT) for f in (
            "cost", "hp", "min_damage", "attack_range", "produce_time",
            "move_time", "attack_time", "harvest_time", "harvest_amount",
            "is_resource", "is_stockpile", "can_harvest", "can_move",
            "can_attack", "produces", "sight_radius")] + [
        ("move_conflict_policy", ctypes.c_int),
        ("max_damage", ctypes.c_int * MAXT)]


class _StateP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in FIELD_DTYPES]


class _CandP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in Candidates.FIELDS]


class _EpiCfg(ctypes.Structure):
    _fields_ = [("nr", ctypes.c_int), ("fns", ctypes.c_int * MAXNR)] + [
        (f, ctypes.c_int) for f in ("worker_id", "base_id", "barracks_id",
                                    "light_id", "heavy_id", "ranged_id")]


class _Space(ctypes.Structure):
    _fields_ = [("sizes", ctypes.c_int * NCOMP), ("total", ctypes.c_int)]


class _RushSpec(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "iters", "need_barracks", "mixed", "combat_id", "n_harvesters",
        "max_workers", "rebuild_base", "expand", "expand_radius", "defense",
        "defense_thresh", "worker_id", "base_id", "barracks_id", "nlad")] + [
        ("ladder", ctypes.c_int * MAXLAD), ("noff", ctypes.c_int),
        ("off_dx", ctypes.c_int * MAXOFF), ("off_dy", ctypes.c_int * MAXOFF)]


class _EvalSpec(ctypes.Structure):
    _fields_ = [("fn", ctypes.c_int), ("ids", ctypes.c_int * 6),
                ("w", ctypes.c_float * 8)]


class _ArmCfg(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("H", "W", "T", "D", "A", "M",
                                            "n1")]


class _TreeDims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("H", "W", "T", "Dd", "A", "n1",
                                            "C", "D")]


# the tree tables (bots/treesearch.py NaiveTree / UCTTree) and their types
TREE_DTYPES = dict(
    nplayer=torch.int32, nterm=torch.bool, ndepth=torch.int32,
    nacc=torch.float32, nvis=torch.int32, children=torch.int32,
    carms=torch.int8, nchild=torch.int32, nnodes=torch.int32,
    tacc=torch.float32, tvis=torch.int32, acand=torch.int8,
    avis=torch.int32, aacc=torch.float32, achild=torch.int32)
WALK_FIELDS = ("cur", "found", "leaf", "path", "edge", "plen", "player")
# the NaiveMCTS tables (bots/treesearch.py NaiveTree)
NAIVE_FIELDS = ("nplayer", "nterm", "ndepth", "nacc", "nvis", "children",
                "carms", "nchild", "nnodes", "tacc", "tvis")


class _TreeP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in TREE_DTYPES]


class _WalkP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in WALK_FIELDS + ("live",)]


class _RerootDims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("H", "W", "A", "n1", "C", "D")]


class _BelDims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("level", "me", "nsp", "R")] + [
        ("producer", ctypes.c_int * MAXT)]


# a believe memory's planes (bots/believestate.py BelieveMem) and types
MEM_DTYPES = dict(b_utype=torch.int32, b_hp=torch.int32, b_uid=torch.int32,
                  seen_type=torch.bool)
# the sampled world's overlaid planes
WORLD_FIELDS = ("utype", "owner", "hp", "uid")


class _MemP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in MEM_DTYPES]


class _WorldP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in WORLD_FIELDS]


class _StepP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "done2", "can_max", "can_min", "arms", "coin_g", "pick_g", "coin0",
        "slot", "cands")]


class _EnumDims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("H", "W", "T", "NW", "R")]


class _MMDims(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("H", "W", "T", "D", "M", "NW",
                                            "S")]


# the minimax stack's tables (bots/minimax.py Stack) and their types
STACK_DTYPES = dict(
    alpha=torch.float32, beta=torch.float32, best=torch.float32,
    mover=torch.int32, nextsim=torch.int32, down_arms=torch.int32,
    choice=torch.int32, more=torch.bool, la=torch.int32,
    claimed0=torch.bool, spent0=torch.int32, balance=torch.int32,
    root_arms=torch.int32, root_set=torch.bool, sp=torch.int32,
    done=torch.bool, it=torch.int32, npush=torch.int32)
TRIP_FIELDS = ("live", "finish", "push", "arms", "mask2", "mover2",
               "nextsim2", "leaf2", "best2")


class _StackP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in STACK_DTYPES]


class _TripP(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in TRIP_FIELDS]


class _PoSlot(ctypes.Structure):
    _fields_ = [("player", ctypes.c_int), ("players", ctypes.c_void_p),
                ("obs", ctypes.c_void_p), ("onehot", ctypes.c_void_p)]


class _ExpertSpec(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "iters", "worker_id", "light_id", "heavy_id", "ranged_id", "base_id",
        "barracks_id", "noff")] + [
        ("off_dx", ctypes.c_int * MAXOFF), ("off_dy", ctypes.c_int * MAXOFF)]


class _TargetSpec(ctypes.Structure):
    _fields_ = [("mode", ctypes.c_int), ("noff", ctypes.c_int),
                ("off_dx", ctypes.c_int * MAXOFF),
                ("off_dy", ctypes.c_int * MAXOFF)]


MAXNB = 8     # barracks-like types (csrc/bayes.cu)
NF_PRED = 9   # features of the learned models, at most


class _PredCfg(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("H", "W", "T", "D", "A", "M",
                                            "nbarr")] + [
        ("barr", ctypes.c_int * MAXNB), ("S", ctypes.c_int),
        ("off", ctypes.c_int * NF_PRED), ("carry_max", ctypes.c_int)]


class _AimTabs(ctypes.Structure):
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "log_prior", "cpd", "log_tf", "nf_base", "calib", "arm_type")]


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    cfg, st, cd = (ctypes.POINTER(_Cfg), ctypes.POINTER(_StateP),
                   ctypes.POINTER(_CandP))
    space = ctypes.POINTER(_Space)
    entries = {
        "actor": dict(actor=[cfg, st, _I, _I, _P, _P,
                             ctypes.POINTER(ctypes.c_float), _P, _P, _P]),
        "decode": dict(decode=[cfg, st, _I, _I, _P, _P, _I, _I, cd, st, _P]),
        "issue_env": dict(issue_env=[cfg, st, _I, cd, st, _P]),
        "cycle": dict(cycle=[cfg, st, _I, st, _P, _P, _P, _P]),
        "epilogue": dict(epilogue=[cfg, ctypes.POINTER(_EpiCfg), _I, _P, _P,
                                   cd, cd, _P, _P, _P, _P, _I, _P, _P, _I,
                                   _P, _P, _P],
                         env_health=[cfg, st, _I, _P, _I, _I, _P, _P]),
        "splice_obs": dict(splice_obs=[cfg, st, _I, _P, st, _I, st, _P, _P,
                                       _P, _P, _P]),
        "policy_sample": dict(policy_sample=[space, _I, _I, _P, _P, _P, _P,
                                             _P, _P, _P, _P]),
        "policy_logprob": dict(
            policy_logprob_fwd=[space, _L, _P, _P, _P, _P, _P, _P],
            policy_logprob_bwd=[space, _L, _P, _P, _P, _P, _P, _P, _P]),
        "rush": dict(rush=[cfg, ctypes.POINTER(_RushSpec), st, _I, _I, _P,
                           _P]),
        "event": dict(event_jump=[_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _P, _P, _P, _P, _P]),
        "evaluation": dict(evaluate=[cfg, ctypes.POINTER(_EvalSpec), _P, _P,
                                     _P, _P, _P, _P, _I, _P, _P]),
        "arms": dict(
            arm_sample=[ctypes.POINTER(_ArmCfg), _I, _I, _I, _P, _P, _P, _P,
                        _P, _P, _P, _I, _F, _F, _F, _P, _P, _P, _P],
            arms_to_action=[_I, _I, _I, _P, _P, _P]),
        "tree": dict(
            mcts_descend=[ctypes.POINTER(_TreeDims), _I, _I,
                          ctypes.POINTER(_TreeP), ctypes.POINTER(_WalkP), st,
                          st, ctypes.POINTER(_StepP), _I, _F, _F, _F, _I, _F,
                          _P, _P, st, st, _P],
            mcts_backprop=[ctypes.POINTER(_TreeDims), _I, _I,
                           ctypes.POINTER(_TreeP), ctypes.POINTER(_WalkP), _P,
                           _P],
            mcts_reroot=[ctypes.POINTER(_RerootDims), _I,
                         ctypes.POINTER(_TreeP), st, st, _P, _P, _P, _P]),
        "enumerate": dict(enum_next=[cfg, ctypes.POINTER(_EnumDims), _I, _P,
                                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P]),
        "minimax": dict(minimax_step=[cfg, ctypes.POINTER(_MMDims), _I,
                                      ctypes.POINTER(_StackP),
                                      ctypes.POINTER(_TripP), st, st, st, _I,
                                      _P]),
        "issue": dict(issue=[cfg, st, _I, cd, _P, st, _P]),
        "fog": dict(po_state=[cfg, st, _I, _I, _P, st, _P, _P],
                    obs_po=[cfg, st, _I, ctypes.POINTER(_PoSlot),
                            ctypes.POINTER(_PoSlot), _P]),
        "believe": dict(believe_update=[
            cfg, ctypes.POINTER(_BelDims), _I, _I, st, st, _P, st,
            ctypes.POINTER(_MemP), ctypes.POINTER(_MemP),
            ctypes.POINTER(_WorldP), _P, _P]),
        "fields": dict(
            distance_fields=[_P, _P, _I, _I, _I, _I, _I, _P, _P],
            descend_direction=[_P, _P, _I, _I, _I, _P, _P],
            distance_field2=[_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
            descend_direction_excluding=[_P, _P, _P, _P, _P, _I, _I, _I, _P,
                                         _P]),
        "expert": dict(
            expert_macro=[cfg, ctypes.POINTER(_ExpertSpec), st, _I, _I, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P],
            expert_detailed=[cfg, st, _I, _I, _P, _P, _P, _P, _P, _P, _P]),
        "synth": dict(
            range_cover=[cfg, _P, _P, _I, _P, _P],
            dsl_target=[cfg, ctypes.POINTER(_TargetSpec), st, _I, _I, _P, _P,
                        _P, _P, _P]),
        "bayes": dict(
            aim_predict=[ctypes.POINTER(_PredCfg), st, _I, _I, _P, _P,
                         ctypes.POINTER(_AimTabs), _I, _P, _P, _P, _P, _P],
            nb_predict=[ctypes.POINTER(_PredCfg), st, _I, _I, _P, _P, _P, _P,
                        _F, _I, _P, _P, _P, _P, _P]),
        "cooperative": dict(cooperative_act=[cfg, st, _I, _I, _P, _P, _P,
                                             _P]),
    }[name]
    for entry, argtypes in entries.items():
        fn = getattr(lib, f"{entry}_launch")
        fn.restype = _I
        fn.argtypes = argtypes
    return lib


_CFGS: Dict[EngineConfig, _Cfg] = {}


def _cfg(cfg: EngineConfig) -> _Cfg:
    if cfg not in _CFGS:
        T, R = cfg.num_types, cfg.max_range
        if T > MAXT:
            raise ValueError(f"kernels take at most {MAXT} unit types, got {T}")
        if (2 * R + 1) ** 2 > 64:
            raise ValueError(f"kernels take attack ranges up to 3, got {R}")
        c = _Cfg(H=cfg.height, W=cfg.width, T=T, R=R)
        for f in ("cost", "hp", "min_damage", "attack_range", "produce_time",
                  "move_time", "attack_time", "harvest_time",
                  "harvest_amount", "is_resource", "is_stockpile",
                  "can_harvest", "can_move", "can_attack"):
            getattr(c, f)[:T] = [int(v) for v in getattr(cfg, f)]
        c.produces[:T] = [sum(1 << j for j, v in enumerate(row) if v)
                          for row in cfg.produces]
        c.sight_radius[:T] = [int(v) for v in cfg.sight_radius]
        c.max_damage[:T] = [int(v) for v in cfg.max_damage]
        c.move_conflict_policy = int(cfg.move_conflict_policy)
        _CFGS[cfg] = c
    return _CFGS[cfg]


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")
    return t.data_ptr()


def _state_p(state: State, cfg: EngineConfig) -> Tuple[_StateP, int]:
    B = state.utype.shape[0]
    dev = state.utype.device
    plane = (B, cfg.height, cfg.width)
    shapes = dict(resources=(B, 2), time=(B,), next_id=(B,),
                  order_ctr=(B,), cancel_ctr=(B,))
    ptrs = {f: _check(f, getattr(state, f), dt, shapes.get(f, plane), dev)
            for f, dt in FIELD_DTYPES.items()}
    return _StateP(**ptrs), B


def _cand_p(cand: Candidates, shape, device) -> _CandP:
    return _CandP(**{f: _check(f, getattr(cand, f), torch.int32, shape, device)
                     for f in Candidates.FIELDS})


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _player(player, batch: int, device) -> Tuple[int, Optional[int]]:
    """(the int player, or 0; the int32 ``[batch]`` per-env players'
    pointer, or None) of ``player``, an int or an int32 tensor."""
    if isinstance(player, torch.Tensor):
        return 0, _check("players", player, torch.int32, (batch,), device)
    return int(player), None


class Kernel:
    """One kernel's library entry (``<name>_launch`` in ``csrc/<src>.cu``)
    and launch counter."""

    def __init__(self, name: str, replaces: str, src: Optional[str] = None):
        self.name = name
        self.replaces = replaces
        self.src = src or name
        self.source = f"microrts_tpu_torch/kernels/csrc/{self.src}.cu"
        self.launches = 0

    def _launch(self, *args) -> None:
        build()
        rc = getattr(_LIBS[self.src], f"{self.name}_launch")(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel: CUDA error {rc} at launch")
        self.launches += 1


class _Actor(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, player,
                 u: Optional[torch.Tensor] = None, weights=None,
                 masks: bool = False):
        """Legal masks + RandomBiasedAI sampling for ``player`` (an int, or
        int32 ``[B]``: one per env).  With ``u`` (float32
        ``[B, H, W, 2]``) and ``weights`` (6 class weights) returns the
        int32 ``[B, H, W, 7]`` actions; with ``masks=True`` also the packed
        int32 ``[B, H, W, 23+T+(2R+1)^2]`` mask.  Returns (actions or
        None, mask or None)."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W = cfg.height, cfg.width
        act = mask = None
        w = (ctypes.c_float * 6)(*([0.0] * 6))
        if u is not None:
            _check("u", u, torch.float32, (B, H, W, 2), dev)
            if weights is None or len(weights) != 6:
                raise ValueError("actor: sampling needs 6 class weights")
            w = (ctypes.c_float * 6)(*[float(v) for v in weights])
            act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
        if masks:
            d = 2 * cfg.max_range + 1
            mask = torch.empty((B, H, W, 23 + cfg.num_types + d * d),
                               dtype=torch.int32, device=dev)
        if act is None and mask is None:
            raise ValueError("actor: nothing to compute")
        me, players = _player(player, B, dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         me, players,
                         u.data_ptr() if u is not None else None,
                         w, act.data_ptr() if act is not None else None,
                         mask.data_ptr() if mask is not None else None,
                         _stream(dev))
        return act, mask


class _Decode(Kernel):
    def __call__(self, env_cfg, state: State, actions: torch.Tensor,
                 player, none_duration: Optional[int] = None,
                 view: Optional[State] = None) -> Candidates:
        """Gridnet actions int32 ``[B, H, W, 7]`` of ``player`` (an int, or
        int32 ``[B]``: one per env) ->
        Candidates (six new int32 planes).  With ``none_duration``, every
        NONE candidate gets that parameter (the bot path's padding); with
        ``view`` (a State of the same batch), the in-flight claims are the
        view's."""
        if none_duration is not None and none_duration < 0:
            raise ValueError("decode: none_duration must be >= 0")
        cfg = env_cfg.engine
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W = cfg.height, cfg.width
        _check("actions", actions, torch.int32, (B, H, W, 7), dev)
        out = Candidates(*[torch.empty((B, H, W), dtype=torch.int32,
                                       device=dev)
                           for _ in Candidates.FIELDS])
        me, players = _player(player, B, dev)
        vp = None
        if view is not None:
            vp, vb = _state_p(view, cfg)
            if vb != B:
                raise ValueError(f"decode: view has batch {vb}, not {B}")
            vp = ctypes.byref(vp)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         me, players, actions.data_ptr(),
                         int(env_cfg.max_produce_scan),
                         -1 if none_duration is None else int(none_duration),
                         ctypes.byref(_cand_p(out, (B, H, W), dev)), vp,
                         _stream(dev))
        return out


_ISSUE_OUT = ("busy", "atype", "aparam", "atx", "aty", "aptype", "aticks",
              "aorder", "atime", "order_ctr")
_CYCLE_OUT = ("utype", "owner", "hp", "carried", "uid", "busy", "atype",
              "aparam", "atx", "aty", "aptype", "aticks", "aorder", "atime",
              "time", "resources", "next_id")


def _fresh(state: State, fields) -> State:
    """A State whose ``fields`` are new empty tensors and whose other
    fields are the input's own tensors (shared, not copied)."""
    return state.replace(**{f: torch.empty_like(getattr(state, f))
                            for f in fields})


class _IssueEnv(Kernel):
    def __call__(self, cfg: EngineConfig, state: State,
                 cand: Candidates) -> State:
        """issueSafe fast path.  Returns a new State: new busy, assignment
        planes and order_ctr; the other fields are the input's tensors."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        cp = _cand_p(cand, (B, cfg.height, cfg.width), dev)
        out = _fresh(state, _ISSUE_OUT)
        op, _ = _state_p(out, cfg)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         ctypes.byref(cp), ctypes.byref(op), _stream(dev))
        return out


class _Issue(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, cand: Candidates,
                 coins: Optional[torch.Tensor] = None) -> State:
        """Full issueSafe.  ``coins`` (bool ``[B, H, W, 4]``, by sorted
        claimant slot) decides CANCEL_RANDOM's conflicts and is required
        under that policy (ignored under the others).  Returns a new
        State: new busy, assignment planes, order_ctr and cancel_ctr; the
        other fields are the input's tensors."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W = cfg.height, cfg.width
        cp = _cand_p(cand, (B, H, W), dev)
        kp = None
        if cfg.move_conflict_policy == 2:
            if coins is None:
                raise ValueError("issue: CANCEL_RANDOM needs coins")
            kp = _check("coins", coins, torch.bool, (B, H, W, 4), dev)
        out = _fresh(state, _ISSUE_OUT + ("cancel_ctr",))
        op, _ = _state_p(out, cfg)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         ctypes.byref(cp), kp, ctypes.byref(op), _stream(dev))
        return out


class _Cycle(Kernel):
    def __call__(self, cfg: EngineConfig, state: State,
                 active: Optional[torch.Tensor] = None,
                 u01: Optional[torch.Tensor] = None
                 ) -> Tuple[State, torch.Tensor]:
        """One tick.  Returns (new State, gameover bool [B]); terrain,
        order_ctr and cancel_ctr are the input's tensors.  With ``active``
        (bool ``[B]``), the envs whose flag is off are copied unchanged
        and their gameover reads False.  ``u01`` (float32 ``[B, H, W]``)
        draws UTT v3's damage: required under random damage, refused
        under deterministic damage."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        act = up = None
        if active is not None:
            act = _check("active", active, torch.bool, (B,), dev)
        if cfg.det_damage:
            if u01 is not None:
                raise ValueError("cycle: u01 given, but the UTT's damage is "
                                 "deterministic")
        elif u01 is None:
            raise ValueError("cycle: random damage (UTT v3) needs u01")
        else:
            up = _check("u01", u01, torch.float32,
                        (B, cfg.height, cfg.width), dev)
        out = _fresh(state, _CYCLE_OUT)
        op, _ = _state_p(out, cfg)
        done = torch.empty(B, dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         ctypes.byref(op), done.data_ptr(), act, up,
                         _stream(dev))
        return out, done


# reward function name -> the epilogue kernel's code (csrc/epilogue.cu)
REWARD_CODES = {"winloss": 0, "resourcegather": 1, "produceworker": 2,
                "producebuilding": 3, "producecombat": 4, "attack": 5,
                "closertoenemybase": 6, "closertoenemyunit": 7}
_EPI: Dict[object, _EpiCfg] = {}


def _epi_cfg(env_cfg) -> _EpiCfg:
    if env_cfg not in _EPI:
        fns = env_cfg.reward_fns
        if len(fns) > MAXNR:
            raise ValueError(f"epilogue takes at most {MAXNR} rewards")
        for n in fns:
            if n not in REWARD_CODES:
                raise ValueError(f"epilogue: unknown reward {n!r}")
        e = _EpiCfg(nr=len(fns), **{f: int(getattr(env_cfg, f)) for f in (
            "worker_id", "base_id", "barracks_id", "light_id", "heavy_id",
            "ranged_id")})
        e.fns[:len(fns)] = [REWARD_CODES[n] for n in fns]
        _EPI[env_cfg] = e
    return _EPI[env_cfg]


class _Epilogue(Kernel):
    def __call__(self, env_cfg, post: State, pre: Optional[State] = None,
                 c0: Optional[Candidates] = None,
                 c1: Optional[Candidates] = None,
                 steps: Optional[torch.Tensor] = None, max_steps: int = 0,
                 done_copies: int = 1):
        """Rewards, dones and the auto-reset arithmetic of one step.

        ``post`` is the state after the cycle.  With ``pre`` (the state
        before the step) and both players' candidates, the rewards float32
        ``[B, 2, NR]`` are computed; with ``steps`` (int32 ``[B]``), the
        reset mask bool ``[B]`` and the next steps int32 ``[B]``.  The dones
        bool ``[B, NR]`` are always computed, written ``done_copies`` times
        (``[done_copies, B, NR]`` when above 1).  Returns (rewards or None,
        dones, reset or None, steps' or None)."""
        cfg = env_cfg.engine
        sp, B = _state_p(post, cfg)
        dev = post.utype.device
        plane = (B, cfg.height, cfg.width)
        nr = len(env_cfg.reward_fns)
        rew = reset = nsteps = None
        pre_u = pre_o = cp0 = cp1 = None
        if pre is not None:
            pre_u = _check("pre.utype", pre.utype, torch.int8, plane, dev)
            pre_o = _check("pre.owner", pre.owner, torch.int8, plane, dev)
            cp0 = ctypes.byref(_cand_p(c0, plane, dev))
            cp1 = ctypes.byref(_cand_p(c1, plane, dev))
            rew = torch.empty((B, 2, nr), dtype=torch.float32, device=dev)
        dshape = (B, nr) if done_copies == 1 else (done_copies, B, nr)
        dones = torch.empty(dshape, dtype=torch.bool, device=dev)
        if steps is not None:
            _check("steps", steps, torch.int32, (B,), dev)
            reset = torch.empty(B, dtype=torch.bool, device=dev)
            nsteps = torch.empty(B, dtype=torch.int32, device=dev)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)),
                         ctypes.byref(_epi_cfg(env_cfg)), B, pre_u, pre_o,
                         cp0, cp1, sp.utype, sp.owner, sp.carried,
                         ptr(steps), int(max_steps), ptr(rew),
                         dones.data_ptr(), int(done_copies), ptr(reset),
                         ptr(nsteps), _stream(dev))
        return rew, dones, reset, nsteps


class _EnvHealth(Kernel):
    def __call__(self, cfg: EngineConfig, state: State,
                 rewards: torch.Tensor) -> torch.Tensor:
        """The per-env failure flags bool ``[B]`` of ``state`` and its
        rewards float32 ``[B, NR']`` (any ``NR'``, e.g. both players'
        flattened): an occupied cell's hp outside [1, max hp], a type
        past the UTT, a busy cell's negative ticks, a stockpile below 0
        or above 10^6, a non-finite reward."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        if rewards.dim() != 2:
            raise ValueError(f"env_health: rewards must be [B, NR'], got "
                             f"{tuple(rewards.shape)}")
        nrr = rewards.shape[1]
        _check("rewards", rewards, torch.float32, (B, nrr), dev)
        failed = torch.empty(B, dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         rewards.data_ptr(), nrr, max(cfg.hp),
                         failed.data_ptr(), _stream(dev))
        return failed


class _SpliceObs(Kernel):
    def __call__(self, cfg: EngineConfig, state: State,
                 reset: Optional[torch.Tensor] = None,
                 init: Optional[State] = None, obs=(), onehot=()):
        """The auto-reset splice and the observations.

        With ``reset`` (bool ``[B]``) and ``init`` (a State of batch 1 or
        B: one per env), the spliced State (every field new): ``init``
        where ``reset`` else ``state``.  ``obs`` and ``onehot`` name the players whose int32
        observation ``[len(obs), B, 6, H, W]`` and float32 one-hot
        ``[len(onehot), B, H, W, 20+T]`` of the (spliced) state are
        written.  Returns (State or None, obs or None, onehot or None)."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W, T = cfg.height, cfg.width, cfg.num_types
        out = op = ip = None
        batched = 0     # init holds one row per env
        if reset is not None:
            _check("reset", reset, torch.bool, (B,), dev)
            ip, nb = _state_p(init, cfg)
            if nb not in (1, B):
                raise ValueError(f"splice_obs: init has batch {nb}, not 1 "
                                 f"or {B}")
            ip, batched = ctypes.byref(ip), int(nb != 1)
            out = _fresh(state, FIELD_DTYPES)
            op = ctypes.byref(_state_p(out, cfg)[0])
        ob = oh = None
        ptrs = [None] * 4     # obs p0, obs p1, one-hot p0, one-hot p1
        if obs:
            ob = torch.empty((len(obs), B, 6, H, W), dtype=torch.int32,
                             device=dev)
            for i, p in enumerate(obs):
                ptrs[int(p)] = ob[i].data_ptr()
        if onehot:
            oh = torch.empty((len(onehot), B, H, W, 20 + T),
                             dtype=torch.float32, device=dev)
            for i, p in enumerate(onehot):
                ptrs[2 + int(p)] = oh[i].data_ptr()
        if out is None and ob is None and oh is None:
            raise ValueError("splice_obs: nothing to compute")
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         reset.data_ptr() if reset is not None else None,
                         ip, batched, op, *ptrs, _stream(dev))
        return out, ob, oh


class _Sample(Kernel):
    def __call__(self, sizes, logits: torch.Tensor, mask: torch.Tensor,
                 gumbel: Optional[torch.Tensor] = None):
        """Masked factored categorical over the component ``sizes``.

        ``logits`` float32 ``[B, H, W, A]``, ``mask`` the env's int32
        ``[B, H, W, 1 + A]`` (channel 0 skipped), ``gumbel`` float32
        ``[B, H, W, A]`` or None for the greedy argmax.  Returns (action
        int32 ``[B, H, W, 7]``, logprob float32 ``[B, H, W]``, entropy
        ``[B, H, W]``, per-env logprob over the cells that can act ``[B]``);
        the last three are None when greedy."""
        if len(sizes) != NCOMP:
            raise ValueError(f"sample: expected {NCOMP} components")
        A = sum(sizes)
        dev = logits.device
        if logits.dim() != 4:
            raise ValueError(f"sample: logits must be [B, H, W, A], got "
                             f"{tuple(logits.shape)}")
        B, H, W = logits.shape[:3]
        _check("logits", logits, torch.float32, (B, H, W, A), dev)
        _check("mask", mask, torch.int32, (B, H, W, A + 1), dev)
        act = torch.empty((B, H, W, NCOMP), dtype=torch.int32, device=dev)
        lp = ent = env_lp = None
        if gumbel is not None:
            _check("gumbel", gumbel, torch.float32, (B, H, W, A), dev)
            lp = torch.empty((B, H, W), dtype=torch.float32, device=dev)
            ent = torch.empty((B, H, W), dtype=torch.float32, device=dev)
            env_lp = torch.empty(B, dtype=torch.float32, device=dev)
        space = _space(sizes)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        with torch.cuda.device(dev):
            self._launch(ctypes.byref(space), B, H * W, logits.data_ptr(),
                         mask.data_ptr(), ptr(gumbel), act.data_ptr(),
                         ptr(lp), ptr(ent), ptr(env_lp), _stream(dev))
        return act, lp, ent, env_lp


def _space(sizes) -> _Space:
    if len(sizes) != NCOMP:
        raise ValueError(f"expected {NCOMP} action components, got {sizes}")
    space = _Space(total=sum(sizes))
    space.sizes[:] = [int(s) for s in sizes]
    return space


def _logprob_inputs(name, sizes, logits, mask, action):
    """Checks the shared inputs of the K7b kernels; returns (space, cells)."""
    space = _space(sizes)
    A = space.total
    if logits.dim() < 2 or logits.shape[-1] != A:
        raise ValueError(f"{name}: logits must be [..., {A}], got "
                         f"{tuple(logits.shape)}")
    dev = logits.device
    lead = tuple(logits.shape[:-1])
    _check("logits", logits, torch.float32, lead + (A,), dev)
    _check("mask", mask, torch.bool, lead + (A,), dev)
    _check("action", action, torch.int32, lead + (NCOMP,), dev)
    cells = 1
    for n in lead:
        cells *= n
    return space, cells


class _Logprob(Kernel):
    def __call__(self, sizes, logits: torch.Tensor, mask: torch.Tensor,
                 action: torch.Tensor):
        """Log-probability and entropy of ``action`` (int32 ``[..., 7]``)
        under the masked factored categorical of ``logits`` (float32
        ``[..., A]``) and ``mask`` (bool ``[..., A]``, the trajectory's
        layout without the can-act channel).  Returns (lp, ent), float32
        ``[...]``.  Action entries must lie inside their component."""
        space, cells = _logprob_inputs(self.name, sizes, logits, mask, action)
        dev = logits.device
        lp = torch.empty(logits.shape[:-1], dtype=torch.float32, device=dev)
        ent = torch.empty_like(lp)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(space), cells, logits.data_ptr(),
                         mask.data_ptr(), action.data_ptr(), lp.data_ptr(),
                         ent.data_ptr(), _stream(dev))
        return lp, ent


class _LogprobBwd(Kernel):
    def __call__(self, sizes, logits: torch.Tensor, mask: torch.Tensor,
                 action: torch.Tensor, g_lp: torch.Tensor,
                 g_ent: torch.Tensor) -> torch.Tensor:
        """d(sum(g_lp * lp + g_ent * ent)) / d logits for ``_Logprob``'s
        outputs: float32 ``[..., A]``."""
        space, cells = _logprob_inputs(self.name, sizes, logits, mask, action)
        dev = logits.device
        lead = tuple(logits.shape[:-1])
        _check("g_lp", g_lp, torch.float32, lead, dev)
        _check("g_ent", g_ent, torch.float32, lead, dev)
        out = torch.empty_like(logits)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(space), cells, logits.data_ptr(),
                         mask.data_ptr(), action.data_ptr(), g_lp.data_ptr(),
                         g_ent.data_ptr(), out.data_ptr(), _stream(dev))
        return out


class _Rush(Kernel):
    def __call__(self, cfg: EngineConfig, plan, state: State,
                 player: int) -> torch.Tensor:
        """The rush bot of ``plan`` (``bots.scripted.RushPlan``: the
        RushSpec resolved against the unit type table) for ``player``:
        int32 gridnet actions ``[B, H, W, 7]``."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        if len(plan.offsets) > MAXOFF or len(plan.ladder) > MAXLAD:
            raise ValueError("rush: attack range or ladder too large")
        spec = _RushSpec(**{f: int(getattr(plan, f)) for f, _ in
                            _RushSpec._fields_
                            if f not in ("ladder", "off_dx", "off_dy",
                                         "nlad", "noff")})
        spec.nlad = len(plan.ladder)
        spec.ladder[:len(plan.ladder)] = [int(v) for v in plan.ladder]
        spec.noff = len(plan.offsets)
        spec.off_dx[:spec.noff] = [int(dx) for dx, _ in plan.offsets]
        spec.off_dy[:spec.noff] = [int(dy) for _, dy in plan.offsets]
        act = torch.empty((B, cfg.height, cfg.width, 7), dtype=torch.int32,
                          device=dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(spec),
                         ctypes.byref(sp), B, int(player), act.data_ptr(),
                         _stream(dev))
        return act


class _EventJump(Kernel):
    def __call__(self, state: State, t_end: Optional[torch.Tensor],
                 max_skip: int, done: Optional[torch.Tensor] = None):
        """The closed-form jump to the next action completion.

        ``t_end`` int32 ``[B]`` or None (no cap).  With ``done`` (bool
        ``[B]``) this is ``fast_forward``'s gated event step (lanes done,
        at a decision point or at ``t_end`` stay put), else
        ``playout_step``'s jump.  Returns (the jumped State: new ``time``
        and ``aticks``, the other fields the input's; take bool ``[B]``,
        whether the lane runs the completion tick's cycle; gameover of the
        jumped state bool ``[B]``, or None with ``done``)."""
        B, H, W = state.utype.shape
        dev = state.utype.device
        plane = (B, H, W)
        ptrs = [_check(f, getattr(state, f), FIELD_DTYPES[f], plane, dev)
                for f in ("utype", "owner", "busy", "aticks")]
        ptrs.append(_check("time", state.time, torch.int32, (B,), dev))
        dp = te = None
        if done is not None:
            dp = _check("done", done, torch.bool, (B,), dev)
        if t_end is not None:
            te = _check("t_end", t_end, torch.int32, (B,), dev)
        out = _fresh(state, ("aticks", "time"))
        take = torch.empty(B, dtype=torch.bool, device=dev)
        over = (None if done is not None
                else torch.empty(B, dtype=torch.bool, device=dev))
        with torch.cuda.device(dev):
            self._launch(B, H * W, *ptrs, dp, te, int(max_skip),
                         int(done is not None), out.aticks.data_ptr(),
                         out.time.data_ptr(), take.data_ptr(),
                         None if over is None else over.data_ptr(),
                         _stream(dev))
        return out, take, over


# evaluation function name -> the evaluate kernel's code
# (csrc/evaluation.cu)
EVAL_CODES = {"simple": 0, "sqrt": 1, "sqrt2": 2, "sqrt3": 3, "opt": 4,
              "opt_upper_bound": 5, "lanchester": 6}


class _Evaluate(Kernel):
    def __call__(self, cfg: EngineConfig, fn: str, state: State,
                 player: torch.Tensor, type_ids=(-1,) * 6,
                 weights=(0.0,) * 8) -> torch.Tensor:
        """The evaluation function ``fn`` (``EVAL_CODES``) of every env
        from ``player``'s view (int32 ``[B]`` of 0 or 1): float32
        ``[B]``.  ``type_ids`` (Base, Barracks, Worker, Light, Ranged,
        Heavy type indices, -1 absent) and ``weights`` (base, rax, worker,
        light, ranged, heavy, carried, mined) serve ``lanchester``."""
        B, H, W = state.utype.shape
        dev = state.utype.device
        plane = (B, H, W)
        ptrs = [_check(f, getattr(state, f), FIELD_DTYPES[f], plane, dev)
                for f in ("utype", "owner", "hp", "carried")]
        ptrs.append(_check("resources", state.resources, torch.int32, (B, 2),
                           dev))
        ptrs.append(_check("player", player, torch.int32, (B,), dev))
        spec = _EvalSpec(fn=EVAL_CODES[fn])
        spec.ids[:] = [int(v) for v in type_ids]
        spec.w[:] = [float(v) for v in weights]
        out = torch.empty(B, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(spec), *ptrs,
                         B, out.data_ptr(), _stream(dev))
        return out


class _ArmSample(Kernel):
    def __call__(self, sp, mode: int, mask: torch.Tensor,
                 gumbel: torch.Tensor, tables=None, cur=None, player=None,
                 maxp: int = 0, eps_l: float = 0.0, greedy_w: float = 0.0,
                 ucb_c: float = 0.0, prior: Optional[torch.Tensor] = None):
        """The local bandits of one node per game (``ops.arms.arm_sample``
        with ``mode`` its index in ``ops.arms.MODES``).  ``mask`` int32
        ``[B, H, W, 23+T+D*D]``; uniform mode (0): ``gumbel`` float32 ``[B,
        K, H, W, A]``, returns (arms int32 ``[B, K, H, W]``, None); the
        tree rules: ``gumbel`` ``[B, H, W, A]``, ``tables`` (tvis int32,
        tacc float32 ``[B, N+1, H, W, A]``, nvis int32 ``[B, N+1]``),
        ``cur``/``player`` int32 ``[B]``, the informed mode (4) also
        ``prior`` float32 ``[B, H, W, A]``, returns (arms int32 ``[B, H,
        W]``, action int32 ``[B, H, W, 7]``)."""
        dev = mask.device
        B, H, W = mask.shape[:3]
        T, A = sp.num_types, sp.n_arms
        M = 23 + T + sp.diam * sp.diam
        _check("mask", mask, torch.int32, (B, H, W, M), dev)
        tv = ta = nv = cp = pp = None
        act = None
        if mode == 0:
            K, n1 = gumbel.shape[1], 1
            _check("gumbel", gumbel, torch.float32, (B, K, H, W, A), dev)
            arms = torch.empty((B, K, H, W), dtype=torch.int32, device=dev)
        else:
            K = 1
            tvis, tacc, nvis = tables
            n1 = tvis.shape[1]
            _check("gumbel", gumbel, torch.float32, (B, H, W, A), dev)
            tv = _check("tvis", tvis, torch.int32, (B, n1, H, W, A), dev)
            ta = _check("tacc", tacc, torch.float32, (B, n1, H, W, A), dev)
            nv = _check("nvis", nvis, torch.int32, (B, n1), dev)
            cp = _check("cur", cur, torch.int32, (B,), dev)
            pp = _check("player", player, torch.int32, (B,), dev)
            arms = torch.empty((B, H, W), dtype=torch.int32, device=dev)
            act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
        if (mode == 4) != (prior is not None):
            raise ValueError("arm_sample: the informed mode (and only it) "
                             "takes a prior")
        pr = (_check("prior", prior, torch.float32, (B, H, W, A), dev)
              if prior is not None else None)
        cfg = _ArmCfg(H=H, W=W, T=T, D=sp.diam, A=A, M=M, n1=n1)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(cfg), B, int(mode), K, mask.data_ptr(),
                         gumbel.data_ptr(), tv, ta, nv, cp, pp, int(maxp),
                         float(eps_l), float(greedy_w), float(ucb_c), pr,
                         arms.data_ptr(),
                         act.data_ptr() if act is not None else None,
                         _stream(dev))
        return arms, act


class _ArmsToAction(Kernel):
    def __call__(self, sp, arms: torch.Tensor) -> torch.Tensor:
        """Arm planes int32 ``[B, H, W]`` -> gridnet actions int32 ``[B, H,
        W, 7]`` (``ops.arms.arms_to_action``)."""
        dev = arms.device
        _check("arms", arms, torch.int32, tuple(arms.shape), dev)
        act = torch.empty(tuple(arms.shape) + (7,), dtype=torch.int32,
                          device=dev)
        with torch.cuda.device(dev):
            self._launch(arms.numel(), sp.num_types, sp.diam,
                         arms.data_ptr(), act.data_ptr(), _stream(dev))
        return act


def _tree_p(tree, w, sp=None):
    """(the tree's and the walk's C structs, their dims, B) after checking
    every table's type, shape and device; ``sp`` (the arm space) gives
    the catalog's sizes to the launches that decode arms."""
    B, n1 = tree.nplayer.shape
    dev = tree.nplayer.device
    H, W = tree.states.utype.shape[1:]
    ptrs = {}
    for f, dt in TREE_DTYPES.items():
        t = getattr(tree, f, None)
        if t is not None:
            lead = (B,) if f == "nnodes" else (B, n1)
            ptrs[f] = _check(f, t, dt, lead + tuple(t.shape[len(lead):]),
                             dev)
    naive = getattr(tree, "children", None) is not None
    C = (tree.children if naive else tree.achild).shape[2]
    D = w.path.shape[1] - 2
    wp = {}
    for f in WALK_FIELDS:
        dt = torch.bool if f == "found" else torch.int32
        shape = (B,)
        if f == "path":
            shape = (B, D + 2)
        if f == "edge":
            dt = torch.int8 if naive else torch.int32
            shape = (B, D + 2, H, W) if naive else (B, D + 2)
        wp[f] = _check(f, getattr(w, f), dt, shape, dev)
    if getattr(w, "live", None) is not None:
        wp["live"] = _check("live", w.live, torch.bool, (B,), dev)
    dims = _TreeDims(H=H, W=W, T=sp.num_types if sp else 1,
                     Dd=sp.diam if sp else 1,
                     A=tree.tacc.shape[-1] if naive else 0, n1=n1, C=C, D=D)
    return _TreeP(**ptrs), _WalkP(**wp), dims, B


class _MctsDescend(Kernel):
    def _run(self, mode, tree, w, st2=None, step=None, maxp=0, eps0=0.0,
             eps_g=0.0, c_uct=0.0, fpu=None, slot_out=None, act=None,
             cfg=None, sp=None):
        tp, wp, dims, B = _tree_p(tree, w, sp)
        dev = tree.nplayer.device
        S = cur_st = leaf_st = st2p = None
        if st2 is not None:
            if tree.states.batch != B * dims.n1 or st2.batch != B:
                raise ValueError("mcts_descend: state batch mismatch")
            S = ctypes.byref(_state_p(tree.states, cfg)[0])
            st2p = ctypes.byref(_state_p(st2, cfg)[0])
            cur_st = ctypes.byref(_state_p(w.st, cfg)[0])
            leaf_st = ctypes.byref(_state_p(w.leaf_st, cfg)[0])
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(dims), mode, B, ctypes.byref(tp),
                         ctypes.byref(wp), S, st2p,
                         None if step is None else ctypes.byref(step),
                         int(maxp), float(eps0), float(eps_g), float(c_uct),
                         int(fpu is not None),
                         0.0 if fpu is None else float(fpu),
                         None if slot_out is None else slot_out.data_ptr(),
                         None if act is None else act.data_ptr(), cur_st,
                         leaf_st, _stream(dev))

    @staticmethod
    def _flags(B, dev, done2, can_max, can_min):
        return dict(done2=_check("done2", done2, torch.bool, (B,), dev),
                    can_max=_check("can_max", can_max, torch.bool, (B,), dev),
                    can_min=_check("can_min", can_min, torch.bool, (B,), dev))

    def naive(self, cfg: EngineConfig, tree, w, arms, st2: State, done2,
              can_max, can_min, sn, maxp: int, eps0: float, eps_g: float,
              D: int) -> None:
        """One NaiveMCTS descent step of every game, in place on the tree
        and the walk (``bots.treesearch.mcts_descend``); ``sn`` the step's
        draws (``TreeStep``)."""
        B, dev = arms.shape[0], arms.device
        C = tree.children.shape[2]
        if w.path.shape[1] != D + 2:
            raise ValueError("mcts_descend: the path is not D + 2 long")
        step = _StepP(
            arms=_check("arms", arms, torch.int32,
                        (B, cfg.height, cfg.width), dev),
            coin_g=_check("coin_g", sn.coin_g, torch.float32, (B,), dev),
            pick_g=_check("pick_g", sn.pick_g, torch.int32, (B, C), dev),
            coin0=_check("coin0", sn.coin0, torch.float32, (B,), dev),
            **self._flags(B, dev, done2, can_max, can_min))
        self._run(0, tree, w, st2, step, maxp, eps0, eps_g, cfg=cfg)

    def uct_select(self, sp, tree, w, maxp: int, c_uct: float,
                   fpu: Optional[float]):
        """UCT's choice at the walk's node (``bots.treesearch.uct_select``):
        (slot int32 ``[B]``, the candidate's gridnet action int32 ``[B, H,
        W, 7]``)."""
        B, dev = tree.nplayer.shape[0], tree.nplayer.device
        H, W = tree.acand.shape[-2:]
        slot = torch.empty(B, dtype=torch.int32, device=dev)
        act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
        self._run(1, tree, w, maxp=maxp, c_uct=c_uct, fpu=fpu,
                  slot_out=slot, act=act, sp=sp)
        return slot, act

    def uct(self, cfg: EngineConfig, tree, w, slot, st2: State, done2,
            can_max, can_min, cands, maxp: int, D: int) -> None:
        """One UCT descent step of every game, in place
        (``bots.treesearch.uct_descend``)."""
        B, dev = slot.shape[0], slot.device
        K = tree.achild.shape[2]
        if w.path.shape[1] != D + 2:
            raise ValueError("mcts_descend: the path is not D + 2 long")
        step = _StepP(
            slot=_check("slot", slot, torch.int32, (B,), dev),
            cands=_check("cands", cands, torch.int32,
                         (B, K, cfg.height, cfg.width), dev),
            **self._flags(B, dev, done2, can_max, can_min))
        self._run(2, tree, w, st2, step, maxp, cfg=cfg)


class _MctsBackprop(Kernel):
    def __call__(self, tree, w, v: torch.Tensor) -> None:
        """Credit ``v`` (float32 ``[B]``) along every game's walk, in place
        (``bots.treesearch.mcts_backprop``)."""
        tp, wp, dims, B = _tree_p(tree, w)
        _check("v", v, torch.float32, (B,), v.device)
        with torch.cuda.device(v.device):
            self._launch(ctypes.byref(dims),
                         int(getattr(tree, "children", None) is None), B,
                         ctypes.byref(tp), ctypes.byref(wp), v.data_ptr(),
                         _stream(v.device))


class _EnumNext(Kernel):
    def __call__(self, cfg: EngineConfig, sp, od, ctx, row: torch.Tensor,
                 active: torch.Tensor):
        """One ``next_action`` of every active lane's odometer row
        ``row[b]`` in place (``ops.enumerate.make_enumerator``): ``od``
        choice int32 ``[B, R, HW]``, more bool ``[B, R]``; ``ctx`` la int32
        ``[B, R, HW, NW]``, claimed0 bool ``[B, R, L]``, spent0 / balance
        int32 ``[B, R]``.  Returns (arms int32 ``[B, HW]``, valid bool
        ``[B]``, trips int32 ``[B]``)."""
        B, R, HW = od.choice.shape
        dev = od.choice.device
        H, W = cfg.height, cfg.width
        NW = (sp.n_arms + 31) // 32
        L = HW + 2 * W
        if HW != H * W or HW > 1024:
            raise ValueError(f"enum_next: {HW} cells for a {H}x{W} board "
                             "(at most 1024)")
        ptrs = [_check("choice", od.choice, torch.int32, (B, R, HW), dev),
                _check("more", od.more, torch.bool, (B, R), dev),
                _check("row", row, torch.int32, (B,), dev),
                _check("active", active, torch.bool, (B,), dev),
                _check("la", ctx.la, torch.int32, (B, R, HW, NW), dev),
                _check("claimed0", ctx.claimed0, torch.bool, (B, R, L), dev),
                _check("spent0", ctx.spent0, torch.int32, (B, R), dev),
                _check("balance", ctx.balance, torch.int32, (B, R), dev)]
        arms = torch.empty((B, HW), dtype=torch.int32, device=dev)
        valid = torch.empty(B, dtype=torch.bool, device=dev)
        trips = torch.empty(B, dtype=torch.int32, device=dev)
        dims = _EnumDims(H=H, W=W, T=sp.num_types, NW=NW, R=R)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(dims), B,
                         *ptrs, arms.data_ptr(), valid.data_ptr(),
                         trips.data_ptr(), _stream(dev))
        return arms, valid, trips


class _MinimaxStep(Kernel):
    def __call__(self, cfg: EngineConfig, sp, stk, trip, maxp: int) -> None:
        """One trip's pop or push of every lane's DFS stack, in place
        (``bots.minimax.minimax_step``)."""
        B, n1 = stk.alpha.shape
        dev = stk.alpha.device
        H, W = cfg.height, cfg.width
        HW, L = H * W, H * W + 2 * W
        NW = (sp.n_arms + 31) // 32
        M = 23 + sp.num_types + sp.diam * sp.diam
        tabs = dict(stk.tensors())
        tabs.update({f.split(".", 1)[1]: tabs.pop(f) for f in list(tabs)
                     if "." in f})
        shapes = dict(down_arms=(B, n1, H, W), choice=(B, n1, HW),
                      la=(B, n1, HW, NW), claimed0=(B, n1, L),
                      root_arms=(B, H, W), root_set=(B,), sp=(B,),
                      done=(B,), it=(B,), npush=(B,))
        sptr = _StackP(**{f: _check(f, tabs[f], dt, shapes.get(f, (B, n1)),
                                    dev)
                          for f, dt in STACK_DTYPES.items()})
        if stk.states.batch != B * n1 or stk.cur.batch != B:
            raise ValueError("minimax_step: state batch mismatch")
        tp = dict(live=_check("live", trip.live, torch.bool, (B,), dev),
                  finish=_check("finish", trip.finish, torch.bool, (B,), dev),
                  push=_check("push", trip.push, torch.bool, (B,), dev),
                  arms=_check("arms", trip.arms, torch.int32, (B, H, W),
                              dev))
        st2 = None
        if trip.st2 is not None:
            tp.update(
                mask2=_check("mask2", trip.mask2, torch.int32, (B, H, W, M),
                             dev),
                mover2=_check("mover2", trip.mover2, torch.int32, (B,), dev),
                nextsim2=_check("nextsim2", trip.nextsim2, torch.int32, (B,),
                                dev),
                leaf2=_check("leaf2", trip.leaf2, torch.bool, (B,), dev),
                best2=_check("best2", trip.best2, torch.float32, (B,), dev))
            if trip.st2.batch != B:
                raise ValueError("minimax_step: child state batch mismatch")
            st2 = ctypes.byref(_state_p(trip.st2, cfg)[0])
        elif bool(trip.push.any()):
            raise ValueError("minimax_step: pushing lanes without a child")
        dims = _MMDims(H=H, W=W, T=sp.num_types, D=sp.diam, M=M, NW=NW,
                       S=n1 - 1)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(dims), B,
                         ctypes.byref(sptr), ctypes.byref(_TripP(**tp)),
                         ctypes.byref(_state_p(stk.states, cfg)[0]),
                         ctypes.byref(_state_p(stk.cur, cfg)[0]), st2,
                         int(maxp), _stream(dev))


class _MctsReroot(Kernel):
    def __call__(self, cfg: EngineConfig, tree, state: State,
                 to_move: torch.Tensor, term: torch.Tensor, D: int,
                 live: Optional[torch.Tensor] = None) -> None:
        """Re-root every game's NaiveMCTS tree in place at the node that
        matches ``state`` (``bots.treesearch.mcts_reroot``): ``to_move``
        int32 ``[B]`` the root's player, ``term`` bool ``[B]`` its game
        over, ``D`` the tree's max depth, ``live`` bool ``[B]`` (or None)
        the games re-rooted."""
        B, n1 = tree.nplayer.shape
        dev = tree.nplayer.device
        H, W = cfg.height, cfg.width
        C, A = tree.children.shape[2], tree.tacc.shape[-1]
        shapes = dict(nnodes=(B,), children=(B, n1, C),
                      carms=(B, n1, C, H, W), tacc=(B, n1, H, W, A),
                      tvis=(B, n1, H, W, A))
        ptrs = {f: _check(f, getattr(tree, f), TREE_DTYPES[f],
                          shapes.get(f, (B, n1)), dev)
                for f in NAIVE_FIELDS}
        if n1 > 1024:
            raise ValueError(f"mcts_reroot: at most 1024 rows a game, got {n1}")
        if tree.states.batch != B * n1 or state.batch != B:
            raise ValueError("mcts_reroot: state batch mismatch")
        dims = _RerootDims(H=H, W=W, A=A, n1=n1, C=C, D=int(D))
        with torch.cuda.device(dev):
            self._launch(
                ctypes.byref(dims), B, ctypes.byref(_TreeP(**ptrs)),
                ctypes.byref(_state_p(tree.states, cfg)[0]),
                ctypes.byref(_state_p(state, cfg)[0]),
                _check("to_move", to_move, torch.int32, (B,), dev),
                _check("term", term, torch.bool, (B,), dev),
                None if live is None
                else _check("live", live, torch.bool, (B,), dev),
                _stream(dev))


_SPIRALS: Dict[Tuple[tuple, torch.device], torch.Tensor] = {}


class _Believe(Kernel):
    def __call__(self, cfg: EngineConfig, level: int, spiral, producer,
                 state: State, view: State, vis: torch.Tensor, player: int,
                 mem=None):
        """The believe-state memory planes of observer ``player`` (an int)
        whose fog-of-war ``view`` and visibility ``vis`` (bool
        ``[B, H, W]``) of ``state`` the ``po_state`` kernel gave,
        ``spiral`` the relocation offsets [(dx, dy)], ``producer`` each
        type's producer type (-1 none).  ``mem`` is the memory before
        (anything with the ``MEM_DTYPES`` planes and the previous view
        ``prev``), None for the initial memory.  Returns (the new
        ``MEM_DTYPES`` planes {name: tensor}, the sampled world's
        ``WORLD_FIELDS`` planes {name: tensor}, None without ``mem``)."""
        if level not in (1, 2, 3):
            raise ValueError(f"believe_update: level {level}")
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W, T = cfg.height, cfg.width, cfg.num_types
        if H * W > 1024:
            raise ValueError(f"believe_update: at most 1024 cells, got {H * W}")
        if len(producer) != T:
            raise ValueError(f"believe_update: {len(producer)} producers for "
                             f"{T} types")
        vp = _state_p(view, cfg)[0]
        if view.batch != B:
            raise ValueError("believe_update: view batch mismatch")
        _check("vis", vis, torch.bool, (B, H, W), dev)
        plane = (B, H, W)

        def shape(f):
            return (B, T) if f == "seen_type" else plane

        def mem_p(m):
            return _MemP(**{f: _check(f, m[f], dt, shape(f), dev)
                            for f, dt in MEM_DTYPES.items()})
        out = {f: torch.empty(shape(f), dtype=dt, device=dev)
               for f, dt in MEM_DTYPES.items()}
        key = (tuple(spiral), dev)
        if key not in _SPIRALS:
            _SPIRALS[key] = torch.tensor(list(spiral) or [(0, 0)],
                                         dtype=torch.int32,
                                         device=dev).reshape(-1, 2)
        dims = _BelDims(level=level, me=int(player), nsp=len(spiral),
                        R=max(cfg.attack_range))
        dims.producer[:T] = producer
        wout = None
        if mem is None:
            inp, prev, wp = _MemP(), vp, _WorldP()
        else:
            if mem.prev.batch != B:
                raise ValueError("believe_update: memory batch mismatch")
            inp = mem_p({f: getattr(mem, f) for f in MEM_DTYPES})
            prev = _state_p(mem.prev, cfg)[0]
            wout = {f: torch.empty(plane, dtype=FIELD_DTYPES[f], device=dev)
                    for f in WORLD_FIELDS}
            wp = _WorldP(**{f: t.data_ptr() for f, t in wout.items()})
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(dims),
                         int(mem is None), B, ctypes.byref(sp),
                         ctypes.byref(vp), vis.data_ptr(), ctypes.byref(prev),
                         ctypes.byref(inp), ctypes.byref(mem_p(out)),
                         ctypes.byref(wp), _SPIRALS[key].data_ptr(),
                         _stream(dev))
        return out, wout


# the unit planes of a fog-of-war view (terrain and the scalars shared)
_VIEW_OUT = ("utype", "owner", "hp", "carried", "uid", "busy", "atype",
             "aparam", "atx", "aty", "aptype", "aticks", "aorder", "atime")


class _PoState(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, player,
                 view: bool = True):
        """``player``'s (an int, or int32 ``[B]``: one per env) fog-of-war
        view and visibility.  Returns (the view, a State whose unit planes
        are new and whose terrain and scalars are the input's, or None
        when ``view`` is False; visibility bool ``[B, H, W]``)."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        me, players = _player(player, B, dev)
        out = _fresh(state, _VIEW_OUT) if view else None
        vis = torch.empty((B, cfg.height, cfg.width), dtype=torch.bool,
                          device=dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B, me,
                         players, None if out is None
                         else ctypes.byref(_state_p(out, cfg)[0]),
                         vis.data_ptr(), _stream(dev))
        return out, vis


class _ObsPo(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, players,
                 onehot=(), obs: bool = True):
        """The 8-plane partially observable observation of one or two
        ``players`` (each an int, or int32 ``[B]``: one per env), int32
        ``[len(players), B, 8, H, W]`` (None when ``obs`` is False), and
        the float32 one-hot ``[len(onehot), B, H, W, 20+T]`` of planes 0-4
        of the players at indices ``onehot`` of ``players`` (None when
        empty).  Returns (obs, onehot)."""
        if not 1 <= len(players) <= 2:
            raise ValueError("obs_po: one or two players")
        if not obs and not onehot:
            raise ValueError("obs_po: nothing to compute")
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W, T = cfg.height, cfg.width, cfg.num_types
        ob = (torch.empty((len(players), B, 8, H, W), dtype=torch.int32,
                          device=dev) if obs else None)
        oh = (torch.empty((len(onehot), B, H, W, 20 + T),
                          dtype=torch.float32, device=dev)
              if onehot else None)
        slots = []
        for i in range(2):
            if i >= len(players):
                slots.append(_PoSlot())
                continue
            me, pl = _player(players[i], B, dev)
            slots.append(_PoSlot(
                player=me, players=pl,
                obs=ob[i].data_ptr() if ob is not None else None,
                onehot=(oh[list(onehot).index(i)].data_ptr()
                        if i in onehot else None)))
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B,
                         ctypes.byref(slots[0]), ctypes.byref(slots[1]),
                         _stream(dev))
        return ob, oh


def _offsets_into(spec, offsets) -> None:
    """The attack scan's (d2, dx, dy) offsets, closest first, into a
    spec's ``noff``/``off_dx``/``off_dy``."""
    if len(offsets) > MAXOFF:
        raise ValueError("attack scan: too many offsets")
    spec.noff = len(offsets)
    spec.off_dx[:spec.noff] = [int(dx) for _, dx, _ in offsets]
    spec.off_dy[:spec.noff] = [int(dy) for _, _, dy in offsets]


class _DistanceFields(Kernel):
    def __call__(self, sources: torch.Tensor, passable: torch.Tensor,
                 iters: int) -> torch.Tensor:
        """F BFS fields (ops/fields.py ``distance_field``, ``iters``
        sweeps) of bool ``sources [B, F, H, W]`` over bool ``passable [B,
        H, W]``: int32 ``[B, F, H, W]``."""
        if sources.dim() != 4:
            raise ValueError("distance_fields: sources must be [B, F, H, W]")
        B, F, H, W = sources.shape
        dev = sources.device
        sp = _check("sources", sources, torch.bool, (B, F, H, W), dev)
        pp = _check("passable", passable, torch.bool, (B, H, W), dev)
        out = torch.empty((B, F, H, W), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            self._launch(sp, pp, B, F, H, W, int(iters), out.data_ptr(),
                         _stream(dev))
        return out


class _Descend(Kernel):
    def __call__(self, dist: torch.Tensor, movable: torch.Tensor
                 ) -> torch.Tensor:
        """``descend_direction`` of int32 ``dist [B, H, W]`` gated by bool
        ``movable [B, H, W, 4]``: int32 ``[B, H, W]``."""
        if dist.dim() != 3:
            raise ValueError("descend_direction: dist must be [B, H, W]")
        B, H, W = dist.shape
        dev = dist.device
        dp = _check("dist", dist, torch.int32, (B, H, W), dev)
        mp = _check("movable", movable, torch.bool, (B, H, W, 4), dev)
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            self._launch(dp, mp, B, H, W, out.data_ptr(), _stream(dev))
        return out


class _DistanceField2(Kernel):
    def __call__(self, sources: torch.Tensor, passable: torch.Tensor,
                 iters: int):
        """``distance_field2`` of bool ``sources``/``passable [B, H, W]``:
        (d1, i1, d2, i2), int32 ``[B, H, W]`` each."""
        if sources.dim() != 3:
            raise ValueError("distance_field2: sources must be [B, H, W]")
        B, H, W = sources.shape
        dev = sources.device
        sp = _check("sources", sources, torch.bool, (B, H, W), dev)
        pp = _check("passable", passable, torch.bool, (B, H, W), dev)
        out = tuple(torch.empty((B, H, W), dtype=torch.int32, device=dev)
                    for _ in range(4))
        with torch.cuda.device(dev):
            self._launch(sp, pp, B, H, W, int(iters),
                         *[o.data_ptr() for o in out], _stream(dev))
        return out


class _DescendExcluding(Kernel):
    def __call__(self, st, movable: torch.Tensor, self_id: torch.Tensor
                 ) -> torch.Tensor:
        """``descend_direction_excluding`` of ``st`` (``distance_field2``'s
        four int32 planes; d1, i1 and d2 read) gated by bool ``movable
        [B, H, W, 4]``, excluding int32 ``self_id [B, H, W]``."""
        d1, i1, d2 = st[0], st[1], st[2]
        if d1.dim() != 3:
            raise ValueError("descend_direction_excluding: planes must be "
                             "[B, H, W]")
        B, H, W = d1.shape
        dev = d1.device
        ptrs = [_check(n, t, torch.int32, (B, H, W), dev)
                for n, t in (("d1", d1), ("i1", i1), ("d2", d2))]
        mp = _check("movable", movable, torch.bool, (B, H, W, 4), dev)
        ip = _check("self_id", self_id, torch.int32, (B, H, W), dev)
        out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            self._launch(*ptrs, mp, ip, B, H, W, out.data_ptr(),
                         _stream(dev))
        return out


_EXPERT_TABLE = 1024
_ROLE_DTYPES = dict(harvester=torch.bool, has_target=torch.bool,
                    tgt_x=torch.int32, tgt_y=torch.int32)


class _ExpertMacro(Kernel):
    def __call__(self, env_cfg, state: State, roles, player, macro,
                 noise, offsets):
        """``ExpertEnv.macro_to_gridnet`` for ``player`` (an int or int32
        ``[B]``): ``roles`` an ``env.expert.ExpertRoles`` (``[B, 1024]``
        tables), ``macro`` int32 ``[B]``, ``noise`` an ``ExpertNoise``
        (float32 ``r [B, H, W]``, int32 ``rx``/``ry [B]``), ``offsets``
        the attack scan's (d2, dx, dy).  Returns (int32 ``[B, H, W, 7]``
        actions, the four new role tables as a dict)."""
        cfg = env_cfg.engine
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W = cfg.height, cfg.width
        if noise is None:
            raise ValueError("expert_macro: noise (ExpertNoise) missing")
        rin = [_check(f, getattr(roles, f), dt, (B, _EXPERT_TABLE), dev)
               for f, dt in _ROLE_DTYPES.items()]
        mp = _check("macro", macro, torch.int32, (B,), dev)
        rp = _check("r", noise.r, torch.float32, (B, H, W), dev)
        xp = _check("rx", noise.rx, torch.int32, (B,), dev)
        yp = _check("ry", noise.ry, torch.int32, (B,), dev)
        spec = _ExpertSpec(iters=H + W, worker_id=env_cfg.worker_id,
                           light_id=env_cfg.light_id,
                           heavy_id=env_cfg.heavy_id,
                           ranged_id=env_cfg.ranged_id,
                           base_id=env_cfg.base_id,
                           barracks_id=env_cfg.barracks_id)
        _offsets_into(spec, offsets)
        out = {f: torch.empty((B, _EXPERT_TABLE), dtype=dt, device=dev)
               for f, dt in _ROLE_DTYPES.items()}
        act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
        me, players = _player(player, B, dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(spec),
                         ctypes.byref(sp), B, me, players, mp, rp, xp, yp,
                         *rin, *[o.data_ptr() for o in out.values()],
                         act.data_ptr(), _stream(dev))
        return act, out


class _ExpertDetailed(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, player,
                 type_logits: torch.Tensor, tile_logits: torch.Tensor,
                 noise) -> torch.Tensor:
        """``detailed_to_gridnet`` for ``player`` (an int or int32 ``[B]``):
        float32 ``type_logits [B, T]`` and ``tile_logits [B, H, W]``,
        ``noise`` a ``DetailedNoise`` (``g_tile [B, H, W, H*W]``,
        ``g_type [B, H, W, T]``).  Returns int32 ``[B, H, W, 7]``."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W, T = cfg.height, cfg.width, cfg.num_types
        if noise is None:
            raise ValueError("expert_detailed: noise (DetailedNoise) missing")
        ptrs = [_check("type_logits", type_logits, torch.float32, (B, T), dev),
                _check("tile_logits", tile_logits, torch.float32, (B, H, W),
                       dev),
                _check("g_tile", noise.g_tile, torch.float32,
                       (B, H, W, H * W), dev),
                _check("g_type", noise.g_type, torch.float32, (B, H, W, T),
                       dev)]
        act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
        me, players = _player(player, B, dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(sp), B, me,
                         players, *ptrs, act.data_ptr(), _stream(dev))
        return act


class _RangeCover(Kernel):
    def __call__(self, cfg: EngineConfig, state: State,
                 src: torch.Tensor) -> torch.Tensor:
        """The DSL's ``_range_cover`` of bool ``src [B, H, W]`` (each
        source cell's attack range from ``state.utype``): bool ``[B, H,
        W]``."""
        B = state.utype.shape[0]
        dev = state.utype.device
        H, W = cfg.height, cfg.width
        up = _check("utype", state.utype, torch.int8, (B, H, W), dev)
        sp = _check("src", src, torch.bool, (B, H, W), dev)
        out = torch.empty((B, H, W), dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), up, sp, B, out.data_ptr(),
                         _stream(dev))
        return out


class _DslTarget(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, player, mode: int,
                 u: Optional[torch.Tensor], offsets):
        """The DSL's ``nearest_in_range_target`` under policy ``mode``
        (``synth.dsl.TARGET_MODES``) for ``player`` (an int or int32
        ``[B]``); Random (mode 5) reads float32 ``u [B, D*D, H, W]``.
        Returns (int32 window index ``[B, H, W]``, bool found)."""
        sp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W = cfg.height, cfg.width
        D = 2 * cfg.max_range + 1
        if not 0 <= int(mode) <= 5:
            raise ValueError(f"dsl_target: unknown mode {mode}")
        spec = _TargetSpec(mode=int(mode))
        _offsets_into(spec, offsets)
        upt = None
        if int(mode) == 5:
            if u is None:
                raise ValueError("dsl_target: the Random policy needs u")
            upt = _check("u", u, torch.float32, (B, D * D, H, W), dev)
        rel = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        found = torch.empty((B, H, W), dtype=torch.bool, device=dev)
        me, players = _player(player, B, dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(spec),
                         ctypes.byref(sp), B, me, players, upt,
                         rel.data_ptr(), found.data_ptr(), _stream(dev))
        return rel, found


def _pred_cfg(cfg: EngineConfig, sp, barr, sizes, carry_max) -> _PredCfg:
    """The learned models' kernel config: the board, the arm catalog, the
    barracks-like types and the features' column offsets."""
    if len(barr) > MAXNB or len(sizes) > NF_PRED:
        raise ValueError("learned models: too many barracks types or "
                         "features")
    if sp.n_arms > 128:
        raise ValueError("learned models: at most 128 arms a cell")
    pc = _PredCfg(H=cfg.height, W=cfg.width, T=cfg.num_types, D=sp.diam,
                  A=sp.n_arms, M=23 + cfg.num_types + sp.diam * sp.diam,
                  nbarr=len(barr), S=int(sum(sizes)), carry_max=carry_max)
    pc.barr[:len(barr)] = [int(b) for b in barr]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + int(n))
    pc.off[:len(offs)] = offs
    return pc


def _pred_io(name, state, mask, player, cfg, sp, mode, gumbel, out_modes,
             sample_mode):
    """The learned models' common checks and outputs: (state pointers,
    batch, me, players pointer, mask pointer, gumbel pointer, the float
    output or None, the arms and actions or None)."""
    stp, B = _state_p(state, cfg)
    dev = state.utype.device
    H, W, A = cfg.height, cfg.width, sp.n_arms
    M = 23 + cfg.num_types + sp.diam * sp.diam
    mp = _check("mask", mask, torch.int32, (B, H, W, M), dev)
    if (mode == sample_mode) != (gumbel is not None):
        raise ValueError(f"{name}: gumbel noise is read in the sampling "
                         "mode only")
    gp = (_check("gumbel", gumbel, torch.float32, (B, H, W, A), dev)
          if gumbel is not None else None)
    out = arms = act = None
    if mode in out_modes:
        out = torch.empty((B, H, W, A), dtype=torch.float32, device=dev)
    else:
        arms = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
    me, players = _player(player, B, dev)
    return stp, B, me, players, mp, gp, out, arms, act


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


class _AimPredict(Kernel):
    def __call__(self, pm, state: State, mask: torch.Tensor, player,
                 mode: int, gumbel: Optional[torch.Tensor] = None):
        """K14a (``ml.pretrained.aim_predict`` with ``mode`` its index in
        ``ml.pretrained.MODES``) of ``pm`` (a ``PretrainedBayes`` whose
        tables lie on the state's device) for ``player`` (an int or int32
        ``[B]``): the logits or the prior float32 ``[B, H, W, A]``, or
        (arms int32 ``[B, H, W]``, action int32 ``[B, H, W, 7]``)."""
        cfg, sp = pm.cfg, pm.sp
        dev = state.utype.device
        T, A = cfg.num_types, sp.n_arms
        S = int(sum(pm.feature_sizes))
        ptrs = dict(
            log_prior=_check("log_prior", pm.log_prior, torch.float32,
                             (T, A), dev),
            cpd=_check("cpd_cat", pm.cpd_cat, torch.float32, (T, A, S), dev),
            log_tf=_check("log_tf", pm.log_tf, torch.float32, (T, 6, 6), dev),
            nf_base=_check("nf_base", pm.nf_base, torch.float32, (T,), dev),
            calib=_check("calibration", pm.calibration, torch.float32, (T,),
                         dev),
            arm_type=_check("arm_type", pm.arm_type, torch.int32, (A,), dev))
        tabs = _AimTabs(**ptrs)
        pc = _pred_cfg(cfg, sp, cfg.barracks_like, pm.feature_sizes,
                       pm.feature_sizes[0] - 1)
        stp, B, me, players, mp, gp, out, arms, act = _pred_io(
            "aim_predict", state, mask, player, cfg, sp, mode, gumbel,
            (0, 1), 2)
        if B == 0:
            return out if out is not None else (arms, act)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(pc), ctypes.byref(stp), B, me, players,
                         mp, ctypes.byref(tabs), int(mode), gp, _ptr(out),
                         _ptr(arms), _ptr(act), _stream(dev))
        return out if out is not None else (arms, act)


class _NbPredict(Kernel):
    def __call__(self, tab, cfg: EngineConfig, sp, state: State,
                 mask: torch.Tensor, player, mode: int,
                 gumbel: Optional[torch.Tensor] = None):
        """K14b (``ml.bayes.nb_predict`` with ``mode`` its index in
        ``ml.bayes.MODES``; ``sp`` the arm space) of the model tables
        ``tab`` (an
        ``ml.bayes.NBTables`` on the state's device): the log posterior
        float32 ``[B, H, W, A]``, or (arms int32 ``[B, H, W]``, action
        int32 ``[B, H, W, 7]``)."""
        dev = state.utype.device
        A, S = sp.n_arms, int(sum(tab.sizes))
        lp = _check("log_prior", tab.log_prior, torch.float32, (A,), dev)
        lc = _check("logc", tab.logc, torch.float32, (A, S), dev)
        pc = _pred_cfg(cfg, sp, cfg.barracks_like, tab.sizes, tab.sizes[0] - 1)
        stp, B, me, players, mp, gp, out, arms, act = _pred_io(
            "nb_predict", state, mask, player, cfg, sp, mode, gumbel, (0,),
            1)
        if B == 0:
            return out if out is not None else (arms, act)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(pc), ctypes.byref(stp), B, me, players,
                         mp, lp, lc, float(tab.c), int(mode), gp, _ptr(out),
                         _ptr(arms), _ptr(act), _stream(dev))
        return out if out is not None else (arms, act)


class _CooperativeAct(Kernel):
    def __call__(self, cfg: EngineConfig, state: State, player,
                 nets: torch.Tensor) -> torch.Tensor:
        """K14c (``bots.cooperative.cooperative_act``) for ``player`` (an
        int or int32 ``[B]``) from the per-type networks' output float32
        ``[B, H*W, H*W + T + 1]``: int32 ``[B, H, W, 7]`` actions."""
        stp, B = _state_p(state, cfg)
        dev = state.utype.device
        H, W, T = cfg.height, cfg.width, cfg.num_types
        np_ = _check("nets", nets, torch.float32, (B, H * W, H * W + T + 1),
                     dev)
        act = torch.empty((B, H, W, 7), dtype=torch.int32, device=dev)
        me, players = _player(player, B, dev)
        with torch.cuda.device(dev):
            self._launch(ctypes.byref(_cfg(cfg)), ctypes.byref(stp), B, me,
                         players, np_, act.data_ptr(), _stream(dev))
        return act


# ``replaces``: the JAX function each kernel stands for (file:line)
ACTOR = _Actor("actor", "microrts_tpu/engine/kernel.py:742")  # + scripted.py:69
DECODE = _Decode("decode", "microrts_tpu/env/gridnet.py:139")
ISSUE_ENV = _IssueEnv("issue_env", "microrts_tpu/engine/kernel.py:456")
CYCLE = _Cycle("cycle", "microrts_tpu/engine/kernel.py:508")
# + gridnet.py:467/501, vec.py:73
EPILOGUE = _Epilogue("epilogue", "microrts_tpu/env/gridnet.py:491")
ENV_HEALTH = _EnvHealth("env_health", "microrts_tpu/env/vec.py:23",
                        "epilogue")
# + gridnet.py:446, vec.py:92
SPLICE_OBS = _SpliceObs("splice_obs", "microrts_tpu/env/gridnet.py:424")
# + gridnet_policy.py:103
SAMPLE = _Sample("policy_sample", "microrts_tpu/models/gridnet_policy.py:79")
LOGPROB = _Logprob("policy_logprob_fwd",
                   "microrts_tpu/models/gridnet_policy.py:116",
                   "policy_logprob")
# the gradient jax.grad takes through action_logprob inside _loss
LOGPROB_BWD = _LogprobBwd("policy_logprob_bwd",
                          "microrts_tpu/train/ppo.py:190", "policy_logprob")
# + scripted.py:361/370, ops/fields.py:23/126
RUSH = _Rush("rush", "microrts_tpu/bots/scripted.py:190")
# + playout.py:109 (fast_forward's event step)
EVENT_JUMP = _EventJump("event_jump", "microrts_tpu/ops/playout.py:58",
                        "event")
# ops/evaluation.py:25-167, the seven functions
EVALUATE = _Evaluate("evaluate", "microrts_tpu/ops/evaluation.py:77",
                     "evaluation")
# + ops/arms.py:60/121, treesearch.py:196-274 (local_sample), :646
ARM_SAMPLE = _ArmSample("arm_sample", "microrts_tpu/ops/arms.py:60", "arms")
ARMS_TO_ACTION = _ArmsToAction("arms_to_action",
                               "microrts_tpu/ops/arms.py:82", "arms")
# + treesearch.py:677-744 (UCT's descent step)
MCTS_DESCEND = _MctsDescend("mcts_descend",
                            "microrts_tpu/bots/treesearch.py:300", "tree")
# + treesearch.py:390-392 (the leaf's credit), :751-760 (UCT)
MCTS_BACKPROP = _MctsBackprop("mcts_backprop",
                              "microrts_tpu/bots/treesearch.py:394", "tree")
# + enumerate.py:121 (_arms_of), :141 (_consistency), :167 (_increment)
ENUM_NEXT = _EnumNext("enum_next", "microrts_tpu/ops/enumerate.py:180",
                      "enumerate")
# + minimax.py:159-181 (pop), :194-225 (push), ops/enumerate.py:105 (init)
MINIMAX_STEP = _MinimaxStep("minimax_step",
                            "microrts_tpu/bots/minimax.py:151", "minimax")
# + kernel.py:125 (sort4), :105 (select_dir), :112 (stack_b), :119 (sum2)
ISSUE = _Issue("issue", "microrts_tpu/engine/kernel.py:291")
# + fog.py:27 (visibility)
PO_STATE = _PoState("po_state", "microrts_tpu/engine/fog.py:43", "fog")
# + gridnet.py:446 (the one-hot of its planes 0-4)
OBS_PO = _ObsPo("obs_po", "microrts_tpu/engine/fog.py:67", "fog")
# + treesearch.py:449 (_node_state_matches)
REROOT = _MctsReroot("mcts_reroot", "microrts_tpu/bots/treesearch.py:507",
                     "tree")
# + believestate.py:108 (_targeted_by_attack), :179 (_relocate), :152
# (init), :325 (sample_world)
BELIEVE = _Believe("believe_update", "microrts_tpu/bots/believestate.py:215",
                   "believe")
# the standalone BFS fields (K9 rest)
DISTANCE_FIELDS = _DistanceFields("distance_fields",
                                  "microrts_tpu/ops/fields.py:23", "fields")
DESCEND = _Descend("descend_direction", "microrts_tpu/ops/fields.py:126",
                   "fields")
DISTANCE_FIELD2 = _DistanceField2("distance_field2",
                                  "microrts_tpu/ops/fields.py:42", "fields")
DESCEND_EXCLUDING = _DescendExcluding("descend_direction_excluding",
                                      "microrts_tpu/ops/fields.py:104",
                                      "fields")
# expert.py:107-270 (its BFS fields inside), :292 (_put)
EXPERT_MACRO = _ExpertMacro("expert_macro", "microrts_tpu/env/expert.py:107",
                            "expert")
EXPERT_DETAILED = _ExpertDetailed("expert_detailed",
                                  "microrts_tpu/env/expert.py:304", "expert")
RANGE_COVER = _RangeCover("range_cover", "microrts_tpu/synth/dsl.py:319",
                          "synth")
# + dsl.py:410-420 (the seven target policies)
DSL_TARGET = _DslTarget("dsl_target", "microrts_tpu/synth/dsl.py:382",
                        "synth")
# + pretrained.py:256 (_reserved_plane), :267 (compute_features_java),
# :370-404 (the bot's draw, make_prior_fn's normalisation)
AIM_PREDICT = _AimPredict("aim_predict", "microrts_tpu/ml/pretrained.py:326",
                          "bayes")
# + bayes.py:63 (compute_features), :249-264 (bayes_bot's draw)
NB_PREDICT = _NbPredict("nb_predict", "microrts_tpu/ml/bayes.py:223", "bayes")
COOPERATIVE_ACT = _CooperativeAct("cooperative_act",
                                  "microrts_tpu/bots/cooperative.py:100",
                                  "cooperative")
KERNELS = (ACTOR, DECODE, ISSUE_ENV, CYCLE, EPILOGUE, SPLICE_OBS, SAMPLE,
           LOGPROB, LOGPROB_BWD, RUSH, EVENT_JUMP, EVALUATE, ARM_SAMPLE,
           ARMS_TO_ACTION, MCTS_DESCEND, MCTS_BACKPROP, ENUM_NEXT,
           MINIMAX_STEP, ISSUE, PO_STATE, OBS_PO, REROOT, BELIEVE,
           ENV_HEALTH, DISTANCE_FIELDS, DESCEND, DISTANCE_FIELD2,
           DESCEND_EXCLUDING, EXPERT_MACRO, EXPERT_DETAILED, RANGE_COVER,
           DSL_TARGET, AIM_PREDICT, NB_PREDICT, COOPERATIVE_ACT)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> Dict[str, int]:
    """Each kernel's launches since the last ``reset_counts``."""
    return {k.name: k.launches for k in KERNELS}
