// rush: the scripted rush-bot family (WorkerRush / LightRush / HeavyRush /
// RangedRush, the defense and economy variants, CRush) as gridnet actions.
//
// Replaces the JAX package's rush_bot (microrts_tpu/bots/scripted.py:190,
// with _rank_by_uid :361 and _set :370) and, inside it, the BFS fields of
// microrts_tpu/ops/fields.py: distance_field (:23) and descend_direction
// (:126).  The RushSpec fields are kernel arguments, so one kernel runs
// every non-partially-observable variant.
//
// Per env: the distance fields to the enemy units, the resources and the
// own bases (and, with ``expand``, to the resources far from the own
// bases) are ``iters`` = H+W synchronous sweeps of fields.cuh's device
// BFS (distance_field's semantics, not a converged BFS).  Then
// each cell takes its decisions in rush_bot's order, each later one
// overwriting the columns it sets: train workers, train the combat type,
// rebuild the base, return / walk home / harvest / walk to a resource,
// build the barracks, expand, attack (the closest enemy in range, scanned
// closest-first in the host's stable order) else move toward the enemy.
// A worker's rank is the number of own workers with a smaller unit id
// (ids are unique), from a list of the env's worker ids in shared memory.
//
// Bound at B=1024, 16x16: it reads six state planes (10 B per cell) and
// writes the int32 [B, H, W, 7] actions (28 B per cell): 9.7 MB, 2.9 us
// at 3.35 TB/s; the sweeps are 3 fields x 32 sweeps x 7 int32
// operations per cell, ~176 M operations: about 10.5 us at the card's
// 16.7 T int32 operations/s, so it is bound by operations.
//
// Design: one block per env, one thread per cell up to 1024 cells (more
// cells per thread on larger maps); the fields, the per-cell flags and
// the worker ids live in shared memory (dynamic, above 48 KB on 64x64).
#include "fields.cuh"

#define MAXOFF 64
#define MAXLAD 3
#define NCOMP_ACT 7

struct RushSpec {
  int iters;             // distance_field sweeps (H + W)
  int need_barracks;     // a barracks type exists and the combat type is not Worker
  int mixed;             // train the first affordable of the ladder
  int combat_id;         // the trained combat type when not mixed
  int n_harvesters;      // < 0: every worker harvests
  int max_workers;       // 0: no cap on worker training
  int rebuild_base;
  int expand;
  int expand_radius;     // far resource: d_base > expand_radius
  int defense;           // the defense standoff is on
  int defense_thresh;    // engage only within this distance
  int worker_id, base_id, barracks_id;
  int nlad;              // mixed ladder: light, ranged, heavy (present ones)
  int ladder[MAXLAD];
  int noff;              // attack scan offsets, closest first
  int off_dx[MAXOFF], off_dy[MAXOFF];
};

enum {
  F_MINE = 1, F_IDLE = 2, F_ENEMY = 4, F_RES = 8, F_BASE = 16, F_BARR = 32,
  F_PASS = 64, F_WORKER = 128, F_FAR = 256
};

__global__ void rush_kernel(Cfg cfg, RushSpec sp, StateP s, int me,
                            int32_t* act) {
  const int H = cfg.H, W = cfg.W, R = cfg.R, D = 2 * cfg.R + 1;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint16_t* fl = carve<uint16_t>(p, HW);
  int* wuid = carve<int>(p, HW);
  int* buf[8];
  const int nbuf = sp.expand ? 8 : 6;
  for (int i = 0; i < nbuf; ++i) buf[i] = carve<int>(p, HW);
  __shared__ int s_nw, s_nbase, s_nbarr, s_nfar;
  if (threadIdx.x == 0) s_nw = s_nbase = s_nbarr = s_nfar = 0;
  __syncthreads();

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int ut = s.utype[base + c];
    const int ow = s.owner[base + c];
    const bool exists = ut > 0;
    const int t = tidx(cfg, ut);
    const bool mine = exists && ow == me;
    unsigned f = 0;
    if (mine) f |= F_MINE;
    if (mine && !s.busy[base + c]) f |= F_IDLE;
    if (exists && ow >= 0 && ow != me) f |= F_ENEMY;
    if (exists && cfg.is_resource[t]) f |= F_RES;
    if (mine && cfg.is_stockpile[t]) f |= F_BASE;
    if (sp.need_barracks && mine && t == sp.barracks_id) f |= F_BARR;
    if (s.terrain[base + c] == 0 && !exists) f |= F_PASS;
    if (mine && cfg.can_harvest[t]) {
      f |= F_WORKER;
      wuid[atomicAdd(&s_nw, 1)] = s.uid[base + c];
    }
    if (f & F_BASE) atomicAdd(&s_nbase, 1);
    if (f & F_BARR) atomicAdd(&s_nbarr, 1);
    fl[c] = (uint16_t)f;
  }
  __syncthreads();

  // d_enemy, d_res, d_base
  int* cur[3] = {buf[0], buf[2], buf[4]};
  int* nxt[3] = {buf[1], buf[3], buf[5]};
  const uint16_t srcf[3] = {F_ENEMY, F_RES, F_BASE};
  distance_fields<uint16_t>(3, srcf, cur, nxt, fl, F_PASS, H, W, sp.iters);
  const int* d_enemy = cur[0];
  const int* d_res = cur[1];
  const int* d_base = cur[2];
  const int* d_far = nullptr;
  if (sp.expand) {
    for (int c = threadIdx.x; c < HW; c += blockDim.x)
      if ((fl[c] & F_RES) && d_base[c] > sp.expand_radius) {
        fl[c] |= F_FAR;
        atomicAdd(&s_nfar, 1);
      }
    __syncthreads();
    int* fc[1] = {buf[6]};
    int* fn[1] = {buf[7]};
    const uint16_t ff[1] = {F_FAR};
    distance_fields<uint16_t>(1, ff, fc, fn, fl, F_PASS, H, W, sp.iters);
    d_far = fc[0];
  }

  const int bal = s.resources[2 * b + (me == 1 ? 1 : 0)];
  const int nw = s_nw, nbase = s_nbase, nbarr = s_nbarr, nfar = s_nfar;
  const bool all_harvest = sp.n_harvesters < 0;
  const int cost_worker = cfg.cost[sp.worker_id > 0 ? sp.worker_id : 0];
  // the ladder's pick: the first affordable, else the last entry
  int ctype = sp.combat_id;
  bool can_aff = false;
  if (sp.mixed) {
    ctype = sp.ladder[sp.nlad - 1];
    for (int i = sp.nlad - 1; i >= 0; --i)
      if (bal >= cfg.cost[sp.ladder[i]]) {
        ctype = sp.ladder[i];
        can_aff = true;
      }
  } else {
    can_aff = bal >= cfg.cost[sp.combat_id > 0 ? sp.combat_id : 0];
  }
  const int fighter_min_rank =
      all_harvest ? (1 << 30)
                  : (sp.need_barracks ? sp.n_harvesters + 1 : sp.n_harvesters);
  const int special_rank = all_harvest ? 0 : sp.n_harvesters;

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const unsigned f = fl[c];
    const int t = tidx(cfg, s.utype[base + c]);
    const bool idle = f & F_IDLE;
    const bool worker = f & F_WORKER;
    unsigned free_b = 0, res_b = 0, base_b = 0, far_b = 0;
    for (int d = 0; d < 4; ++d) {
      free_b |= (unsigned)nb_has(fl, H, W, x, y, d, F_PASS) << d;
      res_b |= (unsigned)nb_has(fl, H, W, x, y, d, F_RES) << d;
      base_b |= (unsigned)nb_has(fl, H, W, x, y, d, F_BASE) << d;
      far_b |= (unsigned)nb_has(fl, H, W, x, y, d, F_FAR) << d;
    }
    const int tdir = first_bit(free_b);
    int rank = 0;
    if (worker) {
      const int u = s.uid[base + c];
      for (int i = 0; i < nw; ++i) rank += wuid[i] < u;
    }
    int o[NCOMP_ACT];
    for (int i = 0; i < NCOMP_ACT; ++i) o[i] = 0;

    // base: train workers
    bool train_w = idle && (f & F_BASE) && sp.worker_id >= 0 &&
                   bal >= cost_worker && free_b;
    if (sp.max_workers > 0) train_w = train_w && nw < sp.max_workers;
    if (train_w) { o[0] = A_PRODUCE; o[4] = tdir; o[5] = sp.worker_id; }
    // barracks: train the combat type
    if (sp.need_barracks && idle && (f & F_BARR) && can_aff && free_b) {
      o[0] = A_PRODUCE; o[4] = tdir; o[5] = ctype;
    }
    // base rebuild
    bool build_base = false;
    if (sp.rebuild_base && sp.base_id >= 0) {
      build_base = idle && worker && rank == 0 && nbase == 0 &&
                   bal >= cfg.cost[sp.base_id] && free_b;
      if (build_base) { o[0] = A_PRODUCE; o[4] = tdir; o[5] = sp.base_id; }
    }
    // harvesters
    const bool is_harv = worker && (all_harvest || rank < sp.n_harvesters);
    const bool hu = idle && is_harv && !build_base;
    const bool carrying = s.carried[base + c] > 0;
    if (hu && carrying) {
      if (base_b) {
        o[0] = A_RETURN; o[3] = first_bit(base_b);
      } else {
        const int md = descend(d_base, free_b, H, W, x, y);
        if (md >= 0) { o[0] = A_MOVE; o[1] = md; }
      }
    }
    if (hu && !carrying) {
      if (res_b) {
        o[0] = A_HARVEST; o[2] = first_bit(res_b);
      } else {
        const int md = descend(d_res, free_b, H, W, x, y);
        if (md >= 0) { o[0] = A_MOVE; o[1] = md; }
      }
    }
    // builder: the barracks
    if (sp.need_barracks && idle && worker && rank == special_rank &&
        nbarr == 0 && bal >= cfg.cost[sp.barracks_id > 0 ? sp.barracks_id : 0]
        && free_b) {
      o[0] = A_PRODUCE; o[4] = tdir; o[5] = sp.barracks_id;
    }
    // expansion
    if (sp.expand && sp.base_id >= 0) {
      const bool want = nbarr > 0 && nbase <= 1 && nfar > 0 &&
                        bal >= cfg.cost[sp.base_id];
      const bool expander = idle && worker && rank == special_rank && want &&
                            !build_base;
      const bool exp_build = expander && far_b && free_b;
      if (exp_build) { o[0] = A_PRODUCE; o[4] = tdir; o[5] = sp.base_id; }
      const int mx = descend(d_far, free_b, H, W, x, y);
      if (expander && !exp_build && mx >= 0) { o[0] = A_MOVE; o[1] = mx; }
    }
    // fighters
    bool fighter = idle && cfg.can_attack[t] &&
                   (!worker || rank >= fighter_min_rank);
    if (sp.defense) {
      int den = INF_I, dba = INF_I;
      for (int d = 0; d < 4; ++d) {
        den = min(den, nb_dist(d_enemy, H, W, x, y, d, INF_I));
        dba = min(dba, nb_dist(d_base, H, W, x, y, d, INF_I));
      }
      fighter = fighter && (den + 1 < sp.defense_thresh ||
                            dba + 1 < sp.defense_thresh);
    }
    if (fighter) {
      const int rng = cfg.attack_range[t];
      int best = -1;
      for (int i = 0; i < sp.noff && best < 0; ++i) {
        const int dx = sp.off_dx[i], dy = sp.off_dy[i];
        const int nx = x + dx, ny = y + dy;
        if (dx * dx + dy * dy > rng * rng) continue;
        if (nx < 0 || nx >= W || ny < 0 || ny >= H) continue;
        if (fl[ny * W + nx] & F_ENEMY) best = (R + dy) * D + (R + dx);
      }
      if (best >= 0) {
        o[0] = A_ATTACK; o[6] = best;
      } else {
        const int md = descend(d_enemy, free_b, H, W, x, y);
        if (md >= 0) { o[0] = A_MOVE; o[1] = md; }
      }
    }
    int32_t* out = act + (base + c) * NCOMP_ACT;
    for (int i = 0; i < NCOMP_ACT; ++i) out[i] = o[i];
  }
}

static size_t rush_smem(int HW, int expand) {
  return carve_bytes(2 * HW) + carve_bytes(4 * HW) * (expand ? 9 : 7) + 16;
}

extern "C" int rush_launch(const Cfg* cfg, const RushSpec* sp,
                           const StateP* s, int batch, int player,
                           int32_t* act, void* stream) {
  const int HW = cfg->H * cfg->W;
  if (sp->noff > MAXOFF || sp->nlad > MAXLAD || (sp->mixed && sp->nlad < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rush_smem(HW, sp->expand);
  cudaError_t e = allow_smem(rush_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (batch == 0) return 0;
  rush_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *sp, *s, player, act);
  return (int)cudaGetLastError();
}
