// expert: the expert macro interface of the JAX package's
// microrts_tpu/env/expert.py as gridnet actions.
//
// expert_macro replaces ExpertEnv.macro_to_gridnet (:107-270): the role
// updates of one macro (allocate a harvester, pull them, send attackers to
// a quadrant target) on the env's uid-indexed role tables, then the
// macro's produce or build, the harvest loop and the attackers' attack or
// walk, each cell's first writer kept (_put :292).  Its five BFS fields
// (d_res, d_base, the two build zones, d_enemy; H+W sweeps of fields.cuh,
// distance_field's semantics) are computed inside, so a player's tick is
// one launch.  expert_detailed replaces detailed_to_gridnet (:304-424):
// each cell's argmax over the tile logits + its Gumbel noise (H*W entries)
// and over the type logits + noise, the tile's content, then the puts.
//
// Parity details kept: the allocation slot is the SUM of the uids at the
// maximum score (dropped past the table); the quadrant one-hot's slot 0
// is the attacker flag of the LAST row-major cell whose scatter index is
// 0 (XLA's CPU scatter keeps the last write); the "first" producer or
// builder is the lowest row-major cell; argmax of no free side is 0;
// float argmaxes keep the first maximum, on __fadd_rn sums.
//
// Bound at B=1024, 16x16: expert_macro reads ~10 B of state a cell and
// the 10 KB of role tables an env in and out, writes 28 B of actions a
// cell, ~19 MB, 5.7 us at 3.35 TB/s; its five fields are 5 x 32 sweeps x
// 7 int32 operations a cell, ~294 M operations, ~17.6 us at 16.7 T/s:
// bound by operations.  expert_detailed reads the 268 MB of tile noise:
// ~80 us, bound by bytes.
//
// Design: one block per env; the flags, the role tables (4 x 1024
// entries) and the double-buffered fields in shared memory; block-wide
// atomics for the pick's maximum and sum, slot 0's last writer and the
// first producers.  expert_detailed reads each cell's noise row with one
// warp (coalesced), reduced by shuffles.
#include <math.h>

#include "fields.cuh"

#define MAXOFF 64
#define TABLE 1024
#define NCOMP_ACT 7

struct ExpertSpec {
  int iters;             // distance_field sweeps (H + W)
  int worker_id, light_id, heavy_id, ranged_id, base_id, barracks_id;
  int noff;              // attack scan offsets, closest first
  int off_dx[MAXOFF], off_dy[MAXOFF];
};

enum : uint32_t {
  X_MINE = 1, X_IDLE = 2, X_ENEMY = 4, X_RES = 8, X_BASE = 16, X_BARR = 32,
  X_PASS = 64, X_WORKER = 128, X_HARV = 256, X_ATT = 512, X_Z11 = 1024,
  X_Z12 = 2048, X_Z11S = 4096, X_Z12S = 8192, X_EMPTY = 16384
};

// the expert's _put: write only where no action is chosen yet
__device__ __forceinline__ void xput(int* o, bool m, int at, int col = -1,
                                     int val = 0, int col2 = -1,
                                     int val2 = 0) {
  if (!m || o[0] != 0) return;
  o[0] = at;
  if (col >= 0) o[col] = val;
  if (col2 >= 0) o[col2] = val2;
}

// greedy axis descent toward (dx_, dy_) away (expert.py:246-258)
__device__ __forceinline__ int greedy(int dx_, int dy_, unsigned free_b) {
  const bool prefer_x = abs(dx_) >= abs(dy_);
  const int dir_x = dx_ > 0 ? 1 : 3, dir_y = dy_ > 0 ? 2 : 0;
  const int w1 = (prefer_x && dx_ != 0) ? dir_x : (dy_ != 0 ? dir_y : -1);
  const int w2 = (prefer_x && dy_ != 0) ? dir_y : (dx_ != 0 ? dir_x : -1);
  if (w1 >= 0 && ((free_b >> w1) & 1)) return w1;
  if (w2 >= 0 && ((free_b >> w2) & 1)) return w2;
  return -1;
}

__global__ void expert_macro_kernel(
    Cfg cfg, ExpertSpec sp, StateP s, int me0, const int32_t* players,
    const int32_t* macro, const float* r, const int32_t* rx,
    const int32_t* ry, const uint8_t* harv_in, const uint8_t* hast_in,
    const int32_t* tx_in, const int32_t* ty_in, uint8_t* harv_out,
    uint8_t* hast_out, int32_t* tx_out, int32_t* ty_out, int32_t* act) {
  const int H = cfg.H, W = cfg.W, R = cfg.R, D = 2 * cfg.R + 1;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  const int me = players ? players[b] : me0;
  const int m = macro[b];
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint8_t* harv = carve<uint8_t>(p, TABLE);
  uint8_t* hast = carve<uint8_t>(p, TABLE);
  int* tgx = carve<int>(p, TABLE);
  int* tgy = carve<int>(p, TABLE);
  uint32_t* fl = carve<uint32_t>(p, HW);
  int* uidm = carve<int>(p, HW);
  int* buf[10];
  for (int i = 0; i < 10; ++i) buf[i] = carve<int>(p, HW);
  __shared__ int s_maxbits, s_slot, s_nunfl, s_last0, s_first[3];

  const size_t rb = (size_t)b * TABLE;
  for (int i = threadIdx.x; i < TABLE; i += blockDim.x) {
    harv[i] = harv_in[rb + i];
    hast[i] = hast_in[rb + i];
    tgx[i] = tx_in[rb + i];
    tgy[i] = ty_in[rb + i];
  }
  if (threadIdx.x == 0) {
    s_maxbits = -1;
    s_slot = 0;
    s_nunfl = 0;
    s_last0 = -1;
    s_first[0] = s_first[1] = s_first[2] = HW;
  }
  __syncthreads();

  // the cells' flags, from the roles before this macro
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int ut = s.utype[base + c];
    const int ow = s.owner[base + c];
    const bool exists = ut > 0;
    const int t = tidx(cfg, ut);
    const bool mine = exists && ow == me;
    const int um = exists ? s.uid[base + c] % TABLE : 0;
    uint32_t f = 0;
    if (mine) f |= X_MINE;
    if (mine && !s.busy[base + c]) f |= X_IDLE;
    if (exists && ow >= 0 && ow != me) f |= X_ENEMY;
    if (exists && cfg.is_resource[t]) f |= X_RES;
    if (mine && cfg.is_stockpile[t]) f |= X_BASE;
    if (mine && t == sp.barracks_id) f |= X_BARR;
    if (s.terrain[base + c] == 0 && !exists) f |= X_PASS;
    if (!exists) f |= X_EMPTY;
    const bool worker = mine && cfg.can_harvest[t];
    const bool hflag = worker && harv[um];
    if (worker) f |= X_WORKER;
    if (hflag) f |= X_HARV;
    const bool att = mine && cfg.can_attack[t] && !hflag;
    if (att) f |= X_ATT;
    if (worker && !hflag) {     // unflagged: a candidate of macro 1
      atomicAdd(&s_nunfl, 1);
      atomicMax(&s_maxbits, __float_as_int(r[base + c]));
    }
    if ((att ? um : 0) == 0) atomicMax(&s_last0, c);
    fl[c] = f;
    uidm[c] = um;
  }
  __syncthreads();

  // the pick's slot sum and the first producers and builder
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const uint32_t f = fl[c];
    const int x = c % W, y = c / W;
    bool any_free = false;
    for (int d = 0; d < 4; ++d)
      any_free |= nb_has(fl, H, W, x, y, d, X_PASS);
    if ((f & X_WORKER) && !(f & X_HARV) &&
        __float_as_int(r[base + c]) == s_maxbits)
      atomicAdd(&s_slot, uidm[c]);
    if ((f & X_IDLE) && (f & X_BASE) && any_free) atomicMin(&s_first[0], c);
    if ((f & X_IDLE) && (f & X_BARR) && any_free) atomicMin(&s_first[1], c);
    if ((f & X_IDLE) && (f & X_WORKER) && !(f & X_HARV))
      atomicMin(&s_first[2], c);
  }
  __syncthreads();

  // role updates from the macro
  const int quad = clampi(m - 3, 0, 3);
  const int qx = rx[b] + (quad % 2) * (W / 2);
  const int qy = ry[b] + (quad / 2) * (H / 2);
  const bool is_quad = m >= 3 && m <= 6;
  if (m == 2)
    for (int i = threadIdx.x; i < TABLE; i += blockDim.x) harv[i] = 0;
  if (threadIdx.x == 0) {
    if (m == 1 && s_nunfl > 0 && s_slot < TABLE) harv[s_slot] = 1;
    if (is_quad && s_last0 >= 0 && (fl[s_last0] & X_ATT)) {
      hast[0] = 1;
      tgx[0] = qx;
      tgy[0] = qy;
    }
  }
  if (is_quad)
    for (int c = threadIdx.x; c < HW; c += blockDim.x)
      if ((fl[c] & X_ATT) && uidm[c] != 0) {
        hast[uidm[c]] = 1;
        tgx[uidm[c]] = qx;
        tgy[uidm[c]] = qy;
      }

  // d_res, d_base; the build zones; d_zone11, d_zone12, d_enemy
  int* cur2[2] = {buf[0], buf[2]};
  int* nxt2[2] = {buf[1], buf[3]};
  const uint32_t src2[2] = {X_RES, X_BASE};
  __syncthreads();
  distance_fields<uint32_t>(2, src2, cur2, nxt2, fl, X_PASS, H, W, sp.iters);
  const int* d_res = cur2[0];
  const int* d_base = cur2[1];
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    uint32_t f = fl[c];
    if (d_res[c] <= 3 && d_base[c] > 5) f |= X_Z11 | ((f & X_EMPTY) ? X_Z11S : 0);
    if (d_base[c] <= 5 && d_res[c] > 3) f |= X_Z12 | ((f & X_EMPTY) ? X_Z12S : 0);
    fl[c] = f;
  }
  __syncthreads();
  int* cur3[3] = {buf[4], buf[6], buf[8]};
  int* nxt3[3] = {buf[5], buf[7], buf[9]};
  const uint32_t src3[3] = {X_Z11S, X_Z12S, X_ENEMY};
  distance_fields<uint32_t>(3, src3, cur3, nxt3, fl, X_PASS, H, W, sp.iters);
  const int* d_zone[2] = {cur3[0], cur3[1]};
  const int* d_enemy = cur3[2];

  const int prod_m[4] = {7, 8, 9, 10};
  const int prod_t[4] = {sp.worker_id, sp.light_id, sp.heavy_id,
                         sp.ranged_id};
  const int build_t[2] = {sp.base_id, sp.barracks_id};
  const uint32_t zone_f[2] = {X_Z11, X_Z12};
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const uint32_t f = fl[c];
    const int t = tidx(cfg, s.utype[base + c]);
    unsigned free_b = 0, res_b = 0, base_b = 0;
    for (int d = 0; d < 4; ++d) {
      free_b |= (unsigned)nb_has(fl, H, W, x, y, d, X_PASS) << d;
      res_b |= (unsigned)nb_has(fl, H, W, x, y, d, X_RES) << d;
      base_b |= (unsigned)nb_has(fl, H, W, x, y, d, X_BASE) << d;
    }
    const int tdir = first_bit(free_b);
    int o[NCOMP_ACT];
    for (int i = 0; i < NCOMP_ACT; ++i) o[i] = 0;

    // training macros 7-10: the first producer
    for (int i = 0; i < 4; ++i) {
      if (prod_t[i] < 0) continue;
      const int first = s_first[i == 0 ? 0 : 1];
      xput(o, m == prod_m[i] && c == first, A_PRODUCE, 4, tdir, 5,
           prod_t[i]);
    }
    // build macros 11/12: the first builder builds in the zone, else walks
    for (int i = 0; i < 2; ++i) {
      if (build_t[i] < 0) continue;
      const bool first_b = c == s_first[2];
      const bool in_zone = first_b && (f & zone_f[i]) && free_b;
      xput(o, m == 11 + i && in_zone, A_PRODUCE, 4, tdir, 5, build_t[i]);
      const int md = descend(d_zone[i], free_b, H, W, x, y);
      xput(o, m == 11 + i && first_b && !in_zone && md >= 0, A_MOVE, 1, md);
    }
    // the harvest loop
    const bool hu = (f & X_IDLE) && (f & X_HARV);
    const bool carrying = s.carried[base + c] > 0;
    xput(o, hu && carrying && base_b, A_RETURN, 3, first_bit(base_b));
    const int mb = descend(d_base, free_b, H, W, x, y);
    xput(o, hu && carrying && !base_b && mb >= 0, A_MOVE, 1, mb);
    xput(o, hu && !carrying && res_b, A_HARVEST, 2, first_bit(res_b));
    const int mr = descend(d_res, free_b, H, W, x, y);
    xput(o, hu && !carrying && !res_b && mr >= 0, A_MOVE, 1, mr);
    // attackers: the closest enemy in range, else walk to the target
    const bool au = (f & X_IDLE) && (f & X_ATT) && o[0] == 0;
    if (au) {
      const int rng = cfg.attack_range[t];
      int best = -1;
      for (int i = 0; i < sp.noff && best < 0; ++i) {
        const int dx = sp.off_dx[i], dy = sp.off_dy[i];
        const int nx = x + dx, ny = y + dy;
        if (dx * dx + dy * dy > rng * rng) continue;
        if (nx < 0 || nx >= W || ny < 0 || ny >= H) continue;
        if (fl[ny * W + nx] & X_ENEMY) best = (R + dy) * D + (R + dx);
      }
      if (best >= 0) {
        xput(o, true, A_ATTACK, 6, best);
      } else {
        const int um = uidm[c];
        const int wd = hast[um] ? greedy(tgx[um] - x, tgy[um] - y, free_b)
                                : descend(d_enemy, free_b, H, W, x, y);
        xput(o, wd >= 0, A_MOVE, 1, wd);
      }
    }
    int32_t* out = act + (base + c) * NCOMP_ACT;
    for (int i = 0; i < NCOMP_ACT; ++i) out[i] = o[i];
  }
  for (int i = threadIdx.x; i < TABLE; i += blockDim.x) {
    harv_out[rb + i] = harv[i];
    hast_out[rb + i] = hast[i];
    tx_out[rb + i] = tgx[i];
    ty_out[rb + i] = tgy[i];
  }
}

enum : uint8_t {
  Y_ENEMY = 1, Y_RES = 2, Y_MINE = 4, Y_PASS = 8, Y_BASE = 16
};

__global__ void expert_detailed_kernel(Cfg cfg, StateP s, int me0,
                                       const int32_t* players,
                                       const float* type_logits,
                                       const float* tile_logits,
                                       const float* g_tile,
                                       const float* g_type, int32_t* act) {
  const int H = cfg.H, W = cfg.W, T = cfg.T, R = cfg.R, D = 2 * cfg.R + 1;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  const int me = players ? players[b] : me0;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint8_t* fl = carve<uint8_t>(p, HW);
  float* tl = carve<float>(p, HW);
  int* tix = carve<int>(p, HW);
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int ut = s.utype[base + c];
    const int ow = s.owner[base + c];
    const bool exists = ut > 0;
    const int t = tidx(cfg, ut);
    const bool mine = exists && ow == me;
    uint8_t f = 0;
    if (exists && ow >= 0 && ow != me) f |= Y_ENEMY;
    if (exists && cfg.is_resource[t]) f |= Y_RES;
    if (mine) f |= Y_MINE;
    if (s.terrain[base + c] == 0 && !exists) f |= Y_PASS;
    if (mine && cfg.is_stockpile[t]) f |= Y_BASE;
    fl[c] = f;
    tl[c] = tile_logits[base + c];
  }
  __syncthreads();
  // each cell's tile: one warp per cell, the first maximum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int c = warp; c < HW; c += nwarps) {
    const float* g = g_tile + (base + c) * HW;
    float bv = -INFINITY;
    int bi = HW;
    for (int j = lane; j < HW; j += 32) {
      const float v = __fadd_rn(tl[j], g[j]);
      if (v > bv) {
        bv = v;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) tix[c] = bi < HW ? bi : 0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const uint8_t f = fl[c];
    const int t = tidx(cfg, s.utype[base + c]);
    int o[NCOMP_ACT];
    for (int i = 0; i < NCOMP_ACT; ++i) o[i] = 0;
    const bool idle = (f & Y_MINE) && !s.busy[base + c];
    if (idle) {
      // the unit type: the first maximum of logits + noise
      const float* gt = g_type + (base + c) * T;
      float bv = -INFINITY;
      int tau = 0;
      for (int j = 0; j < T; ++j) {
        const float v = __fadd_rn(type_logits[(size_t)b * T + j], gt[j]);
        if (v > bv) {
          bv = v;
          tau = j;
        }
      }
      const int ti = tix[c];
      const int tx = ti % W, ty = ti / W;
      const uint8_t tf = fl[ti];
      const bool tgt_enemy = tf & Y_ENEMY, tgt_res = tf & Y_RES,
                 tgt_own = tf & Y_MINE;
      const bool tgt_empty = !(tgt_enemy || tgt_res || tgt_own);
      const bool tau_mobile = cfg.can_move[tau];
      const bool harv_t = cfg.can_harvest[t];
      const bool is_building = !harv_t && !cfg.can_move[t];
      const bool is_harv = harv_t;
      const bool is_other = !is_building && !is_harv;
      unsigned free_b = 0, res_b = 0, base_b = 0;
      for (int d = 0; d < 4; ++d) {
        free_b |= (unsigned)nb_has(fl, H, W, x, y, d, Y_PASS) << d;
        res_b |= (unsigned)nb_has(fl, H, W, x, y, d, Y_RES) << d;
        base_b |= (unsigned)nb_has(fl, H, W, x, y, d, Y_BASE) << d;
      }
      const int tdir = first_bit(free_b);
      const bool prod_row = (cfg.produces[t] >> tau) & 1;
      xput(o, is_building && tau_mobile && prod_row && free_b, A_PRODUCE, 4,
           tdir, 5, tau);
      const int dx_ = tx - x, dy_ = ty - y;
      const int gdir = greedy(dx_, dy_, free_b);
      const int rng = cfg.attack_range[t];
      const bool in_range = dx_ * dx_ + dy_ * dy_ <= rng * rng && ti != c;
      const int rel = clampi(R + dy_, 0, D - 1) * D + clampi(R + dx_, 0, D - 1);
      const bool can_atk = cfg.can_attack[t];
      const bool carrying = s.carried[base + c] > 0;
      if (is_harv) {
        xput(o, (tgt_empty || tgt_own) && gdir >= 0, A_MOVE, 1, gdir);
        xput(o, tgt_res && carrying && base_b, A_RETURN, 3,
             first_bit(base_b));
        xput(o, tgt_res && !carrying && res_b, A_HARVEST, 2,
             first_bit(res_b));
        xput(o, tgt_res && gdir >= 0, A_MOVE, 1, gdir);
        xput(o, tgt_enemy && can_atk && in_range, A_ATTACK, 6, rel);
        xput(o, tgt_enemy && gdir >= 0, A_MOVE, 1, gdir);
        xput(o, !tau_mobile && prod_row && free_b, A_PRODUCE, 4, tdir, 5,
             tau);
      }
      if (is_other) {
        xput(o, (tgt_empty || tgt_own) && gdir >= 0, A_MOVE, 1, gdir);
        xput(o, (tgt_enemy || tgt_res) && can_atk && in_range, A_ATTACK, 6,
             rel);
        xput(o, tgt_enemy && gdir >= 0, A_MOVE, 1, gdir);
      }
    }
    int32_t* out = act + (base + c) * NCOMP_ACT;
    for (int i = 0; i < NCOMP_ACT; ++i) out[i] = o[i];
  }
}

static size_t macro_smem(int HW) {
  return carve_bytes(TABLE) * 2 + carve_bytes(4 * TABLE) * 2 +
         carve_bytes(4 * HW) * 12 + 16;
}

static size_t detailed_smem(int HW) {
  return carve_bytes(HW) + carve_bytes(4 * HW) * 2 + 16;
}

extern "C" int expert_macro_launch(
    const Cfg* cfg, const ExpertSpec* sp, const StateP* s, int batch, int me,
    const int32_t* players, const int32_t* macro, const float* r,
    const int32_t* rx, const int32_t* ry, const uint8_t* harv_in,
    const uint8_t* hast_in, const int32_t* tx_in, const int32_t* ty_in,
    uint8_t* harv_out, uint8_t* hast_out, int32_t* tx_out, int32_t* ty_out,
    int32_t* act, void* stream) {
  if (sp->noff > MAXOFF) return (int)cudaErrorInvalidValue;
  const int HW = cfg->H * cfg->W;
  const size_t smem = macro_smem(HW);
  cudaError_t e = allow_smem(expert_macro_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (batch == 0) return 0;
  expert_macro_kernel<<<batch, block_threads(HW), smem,
                        (cudaStream_t)stream>>>(
      *cfg, *sp, *s, me, players, macro, r, rx, ry, harv_in, hast_in, tx_in,
      ty_in, harv_out, hast_out, tx_out, ty_out, act);
  return (int)cudaGetLastError();
}

extern "C" int expert_detailed_launch(const Cfg* cfg, const StateP* s,
                                      int batch, int me,
                                      const int32_t* players,
                                      const float* type_logits,
                                      const float* tile_logits,
                                      const float* g_tile,
                                      const float* g_type, int32_t* act,
                                      void* stream) {
  const int HW = cfg->H * cfg->W;
  const size_t smem = detailed_smem(HW);
  cudaError_t e = allow_smem(expert_detailed_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (batch == 0) return 0;
  expert_detailed_kernel<<<batch, block_threads(HW), smem,
                           (cudaStream_t)stream>>>(
      *cfg, *s, me, players, type_logits, tile_logits, g_tile, g_type, act);
  return (int)cudaGetLastError();
}
