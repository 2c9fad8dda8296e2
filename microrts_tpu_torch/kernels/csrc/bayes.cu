// aim_predict and nb_predict: the learned unit-action models of a batch of
// boards (K14a, K14b).
//
// aim_predict replaces the JAX package's _reserved_plane,
// compute_features_java and predict_arm_logits
// (microrts_tpu/ml/pretrained.py:256-359) and what pretrained_bayes_bot
// and make_prior_fn do with the logits (:370-404): the softmax over the
// legal arms, its normalisation, the Gumbel-max draw or the argmax.
// nb_predict replaces compute_features and predict_log_posterior
// (microrts_tpu/ml/bayes.py:63-112, :223-236) and bayes_bot's draw
// (:249-264).
//
// Bound (16x16, A = 90 arms, B = 1024): the logits and the prior write a
// float a cell and arm (94.4 MB), the draws read one Gumbel a cell and arm
// where a unit acts and every cell's can-act flag: bytes, about 28 us at
// 3.35 TB/s for the full planes.
//
// Design: one block per env.  The per-board reductions (the two centroids'
// counts and coordinate sums, the barracks flag) are shared-memory
// atomics of integers, exact in any order; the cells' classes, types and
// the reserved plane (in-flight MOVE/PRODUCE targets) are staged in shared
// memory so that the four occupancy reads at +-2 are shared loads.  A
// thread a cell computes its features, its legal action types and the
// model's per-cell terms (the interdependence sums, the calibration
// exponent); then a warp a cell, its lanes every 32nd arm, sums the
// tables' terms per arm, and the softmax, the draw and the argmax are warp
// reductions.
//
// Floats: IEEE-rounded __fadd_rn/__fmul_rn/__fdiv_rn, atan2f, expf and
// logf (no fast math), in the order of the plain PyTorch versions
// (ml/pretrained.py, ml/bayes.py), so that the kernels equal them on the
// card bit for bit: the prior, then the eight CPD terms in order, then the
// type term, times the exponent; the interdependence sum over the six
// types one by one; the softmax's total over the arms one by one (lane 0
// of the warp, from a shared row).
#include "arms.cuh"

enum { P_LOGITS = 0, P_PRIOR = 1, P_SAMPLE = 2, P_GREEDY = 3 };
enum { NB_LOGITS = 0, NB_SAMPLE = 1, NB_GREEDY = 2 };

#define NTY 6       // UnitAction.NUMBER_OF_ACTION_TYPES
#define NF_AIM 8    // FeatureGeneratorSimple's features
#define NF_NB 9     // ml/bayes.py's features (+ the unit's type)
#define MAXA 128    // arms a cell
#define MAXNB 8     // barracks-like types

// float32 constants rounded as the JAX package's weakly typed Python
// floats round against float32 arrays: pi/8, 2 pi, pi/4
#define PI_8 0.39269909262657166f
#define TWO_PI 6.2831854820251465f
#define PI_4 0.7853981852531433f

struct PredCfg {
  int H, W, T, D;    // board, unit types, attack window diameter
  int A, M;          // arms, packed mask channels (23 + T + D*D)
  int nbarr;         // barracks-like types
  int barr[MAXNB];
  int S;             // the concatenated table's value columns
  int off[NF_NB];    // each feature's first column
  int carry_max;     // the carried-resources feature's clip
};

// The AIM tables (ml/pretrained.py PretrainedBayes), float32 except arm_type.
struct AimTabs {
  const float* log_prior;  // [T, A]
  const float* cpd;        // [T, A, S] the eight log CPDs concatenated
  const float* log_tf;     // [T, 6, 6]
  const float* nf_base;    // [T]
  const float* calib;      // [T]
  const int32_t* arm_type; // [A]
};

// The centroid direction bin of cell (x, y): FeatureGeneratorSimple's
// atan2(dx, dy) + pi/8 (+ 2 pi where negative) over pi/4, truncated and
// clipped to 0..7; n, sx, sy the mask's count and coordinate sums.
__device__ __forceinline__ int centroid_bin(int n, int sx, int sy, int x,
                                            int y) {
  const float nf = (float)(n > 1 ? n : 1);
  const float dx = __fsub_rn(__fdiv_rn((float)sx, nf), (float)x);
  const float dy = __fsub_rn(__fdiv_rn((float)sy, nf), (float)y);
  float ang = __fadd_rn(atan2f(dx, dy), PI_8);
  if (ang < 0.0f) ang = __fadd_rn(ang, TWO_PI);
  return clampi((int)__fdiv_rn(ang, PI_4), 0, 7);
}

// The per-board staging of both kernels: the class of each cell for the
// occupancy reads (bit 0 the player's unit, bit 1 another unit: an enemy,
// and for the AIM features a neutral too; bit 2 a wall; bit 3 reserved
// by an in-flight move or produce, AIM only), its type index, and the
// centroid sums and barracks flag.
struct Board {
  uint8_t* cls;
  int8_t* t;
  int* red;   // n_mine, sx, sy, n_enemy, sx, sy, have_barr
};

__device__ void stage_board(const PredCfg& pc, const StateP& s, size_t b,
                            int me, bool neutral_other, bool reserved,
                            Board bd, int8_t* s_dir) {
  const int H = pc.H, W = pc.W, HW = H * W, T = pc.T;
  if (threadIdx.x < 7) bd.red[threadIdx.x] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = b * HW + c;
    const int ut = s.utype[i], ow = s.owner[i];
    const int t = clampi(ut - 1, 0, T - 1);
    const bool ex = ut > 0;
    const bool mine = ex && ow >= 0 && ow == me;
    const bool enemy = ex && ow >= 0 && ow != me;
    const bool other = neutral_other ? (ex && !mine) : enemy;
    bd.cls[c] = (mine ? 1 : 0) | (other ? 2 : 0)
                | (s.terrain[i] != 0 ? 4 : 0);
    bd.t[c] = (int8_t)t;
    const int x = c % W, y = c / W;
    if (mine) {
      atomicAdd(&bd.red[0], 1); atomicAdd(&bd.red[1], x);
      atomicAdd(&bd.red[2], y);
      for (int k = 0; k < pc.nbarr; ++k)
        if (t == pc.barr[k]) bd.red[6] = 1;
    }
    if (enemy) {
      atomicAdd(&bd.red[3], 1); atomicAdd(&bd.red[4], x);
      atomicAdd(&bd.red[5], y);
    }
    if (reserved) {
      const int at = s.atype[i], ap = s.aparam[i];
      s_dir[c] = (s.busy[i] && (at == A_MOVE || at == A_PRODUCE) && ap >= 0
                  && ap < 4) ? (int8_t)ap : (int8_t)-1;
    }
  }
  __syncthreads();
  if (!reserved) return;
  // the cells that in-flight actions target (push by aparam)
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    bool r = false;
    for (int d = 0; d < 4; ++d) {
      const int sx = x - dir_dx(d), sy = y - dir_dy(d);
      if (sx >= 0 && sx < W && sy >= 0 && sy < H && s_dir[sy * W + sx] == d)
        r = true;
    }
    if (r) bd.cls[c] |= 8;
  }
  __syncthreads();
}

// The occupancy read at offset k (xo, yo) = (-2,0), (0,-2), (2,0), (0,2):
// the cell (x - xo, y - yo), or -1 off the board.
__device__ __forceinline__ int occ_src(int H, int W, int x, int y, int k) {
  const int xo = k == 0 ? -2 : k == 2 ? 2 : 0;
  const int yo = k == 1 ? -2 : k == 3 ? 2 : 0;
  const int sx = x - xo, sy = y - yo;
  if (sx < 0 || sx >= W || sy < 0 || sy >= H) return -1;
  return sy * W + sx;
}

// The softmax over a warp's cell row held in lanes' registers (vals[j]
// for arm lane + 32 j): writes exp(l - max) of the legal arms (0 of the
// others) into row[] and returns their total, summed over the arms one
// by one by lane 0 and broadcast.
__device__ float softmax_row(const float* vals, const bool* legal, int A,
                             int lane, float* row) {
  const float NEG_INF = __int_as_float(0xff800000);
  float mx = NEG_INF;
  for (int j = 0, a = lane; a < A; ++j, a += 32)
    if (legal[j] && vals[j] > mx) mx = vals[j];
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
  for (int j = 0, a = lane; a < A; ++j, a += 32)
    row[a] = legal[j] ? expf(__fsub_rn(vals[j], mx)) : 0.0f;
  __syncwarp();
  float tot = 0.0f;
  if (lane == 0) {
    tot = row[0];
    for (int a = 1; a < A; ++a) tot = __fadd_rn(tot, row[a]);
  }
  tot = __shfl_sync(FULL_MASK, tot, 0);
  return tot;
}

// The bot's draw (first maximum of logf(w + 1e-20) + g, uniform weights
// where no weight is positive) or argmax (first maximum of the legal
// logits) of a warp's cell; -1 where the cell cannot act.
__device__ int draw_or_argmax(bool greedy, bool can, const float* vals,
                              const bool* legal, const float* row,
                              const float* g, int A, int lane) {
  const float NEG_INF = __int_as_float(0xff800000);
  if (!can) return -1;
  float top = NEG_INF;
  int arm = INF_I;
  if (greedy) {
    for (int j = 0, a = lane; a < A; ++j, a += 32)
      if (legal[j] && vals[j] > top) { top = vals[j]; arm = a; }
  } else {
    bool pos = false;
    for (int a = lane; a < A; a += 32) pos = pos || row[a] > 0.0f;
    pos = __any_sync(FULL_MASK, pos);
    for (int a = lane; a < A; a += 32) {
      const float w = pos ? row[a] : 1.0f;
      const float v = __fadd_rn(logf(__fadd_rn(w, 1e-20f)), g[a]);
      if (v > top) { top = v; arm = a; }
    }
  }
  return warp_first_max(top, arm);
}

#define MAXJ ((MAXA + 31) / 32)

__global__ void aim_predict_kernel(PredCfg pc, StateP s, int me0,
                                   const int32_t* players,
                                   const int32_t* mask, AimTabs tb,
                                   int mode, const float* gumbel,
                                   float* out, int32_t* arms,
                                   int32_t* act) {
  extern __shared__ unsigned char smem[];
  const int H = pc.H, W = pc.W, HW = H * W, T = pc.T, A = pc.A, S = pc.S;
  const size_t b = blockIdx.x;
  const int me = players != nullptr ? players[b] : me0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned char* p = smem;
  Board bd;
  bd.cls = carve<uint8_t>(p, HW);
  bd.t = carve<int8_t>(p, HW);
  int8_t* s_dir = carve<int8_t>(p, HW);
  uint8_t* s_feat = carve<uint8_t>(p, HW * NF_AIM);
  float* s_contrib = carve<float>(p, HW * NTY);
  float* s_expo = carve<float>(p, HW);
  float* s_row = carve<float>(p, nwarps * A);
  __shared__ int red[7];
  bd.red = red;
  stage_board(pc, s, b, me, true, true, bd, s_dir);

  // a thread a cell: the features, the legal types, the per-cell terms
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = b * HW + c;
    const int x = c % W, y = c / W, t = bd.t[c];
    uint8_t* f = s_feat + c * NF_AIM;
    f[0] = (uint8_t)clampi(s.carried[i], 0, pc.carry_max);
    f[1] = (uint8_t)centroid_bin(red[0], red[1], red[2], x, y);
    f[2] = (uint8_t)centroid_bin(red[3], red[4], red[5], x, y);
    f[3] = (uint8_t)red[6];
    for (int k = 0; k < 4; ++k) {
      const int n = occ_src(H, W, x, y, k);
      int v;
      if (n < 0) {
        v = 2;
      } else {
        const int cl = bd.cls[n];
        v = (cl & 1) ? 3 + bd.t[n] : (cl & 2) ? 3 + T + bd.t[n]
            : (cl & 4) ? 2 : (cl & 8) ? 1 : 0;
      }
      f[4 + k] = (uint8_t)v;
    }
    const int32_t* m = mask + i * pc.M;
    unsigned lt = 0;
    for (int a = 0; a < A; ++a)
      if (arm_legal(m, a, T)) lt |= 1u << tb.arm_type[a];
    int nlt = 0;
    float ltf[NTY];
    for (int j = 0; j < NTY; ++j) {
      ltf[j] = (lt >> j) & 1 ? 1.0f : 0.0f;
      nlt += (lt >> j) & 1;
    }
    const float* tf = tb.log_tf + t * NTY * NTY;
    for (int ii = 0; ii < NTY; ++ii) {
      float m_all = __fmul_rn(tf[ii * NTY], ltf[0]);
      for (int j = 1; j < NTY; ++j)
        m_all = __fadd_rn(m_all, __fmul_rn(tf[ii * NTY + j], ltf[j]));
      s_contrib[c * NTY + ii] =
          __fsub_rn(m_all, __fmul_rn(tf[ii * NTY + ii], ltf[ii]));
    }
    const float nf = __fadd_rn(tb.nf_base[t],
                               fmaxf(__fsub_rn((float)nlt, 1.0f), 0.0f));
    const float cc = tb.calib[t];
    s_expo[c] = __fdiv_rn(1.0f, __fadd_rn(__fsub_rn(1.0f, cc),
                                          __fmul_rn(nf, cc)));
  }
  __syncthreads();

  // a warp a cell, a lane every 32nd arm
  float* row = s_row + warp * A;
  for (int c = warp; c < HW; c += nwarps) {
    const size_t i = b * HW + c;
    const int32_t* m = mask + i * pc.M;
    const bool can = m[0] != 0;
    if (mode != P_LOGITS && !can) {
      // no legal arm: a zero prior row, no draw
      if (mode == P_PRIOR) {
        for (int a = lane; a < A; a += 32) out[i * A + a] = 0.0f;
      } else if (lane == 0) {
        arms[i] = -1;
        to_action(-1, T, pc.D, act + i * 7);
      }
      continue;
    }
    const int t = bd.t[c];
    const uint8_t* f = s_feat + c * NF_AIM;
    const float expo = s_expo[c];
    float vals[MAXJ];
    bool legal[MAXJ];
    for (int j = 0, a = lane; a < A; ++j, a += 32) {
      const float* cp = tb.cpd + ((size_t)t * A + a) * S;
      float l = tb.log_prior[t * A + a];
      for (int k = 0; k < NF_AIM; ++k)
        l = __fadd_rn(l, cp[pc.off[k] + f[k]]);
      l = __fadd_rn(l, s_contrib[c * NTY + tb.arm_type[a]]);
      vals[j] = __fmul_rn(l, expo);
      legal[j] = arm_legal(m, a, T);
    }
    if (mode == P_LOGITS) {
      for (int j = 0, a = lane; a < A; ++j, a += 32) out[i * A + a] = vals[j];
      continue;
    }
    float tot = 0.0f;
    if (mode != P_GREEDY) tot = softmax_row(vals, legal, A, lane, row);
    if (mode == P_PRIOR) {
      int nleg = 0;
      for (int j = 0, a = lane; a < A; ++j, a += 32) nleg += legal[j];
      nleg = __reduce_add_sync(FULL_MASK, nleg);
      const float nl = (float)(nleg > 1 ? nleg : 1);
      for (int j = 0, a = lane; a < A; ++j, a += 32)
        out[i * A + a] = tot > 0.0f
            ? __fdiv_rn(row[a], fmaxf(tot, 1e-30f))
            : __fdiv_rn(legal[j] ? 1.0f : 0.0f, nl);
    } else {
      const int arm = draw_or_argmax(
          mode == P_GREEDY, can, vals, legal, row,
          gumbel != nullptr ? gumbel + i * A : nullptr, A, lane);
      if (lane == 0) {
        arms[i] = arm;
        to_action(arm, T, pc.D, act + i * 7);
      }
    }
    __syncwarp();
  }
}

__global__ void nb_predict_kernel(PredCfg pc, StateP s, int me0,
                                  const int32_t* players,
                                  const int32_t* mask,
                                  const float* log_prior, const float* logc,
                                  float c_cal, int mode, const float* gumbel,
                                  float* out, int32_t* arms, int32_t* act) {
  extern __shared__ unsigned char smem[];
  const int H = pc.H, W = pc.W, HW = H * W, T = pc.T, A = pc.A, S = pc.S;
  const size_t b = blockIdx.x;
  const int me = players != nullptr ? players[b] : me0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned char* p = smem;
  Board bd;
  bd.cls = carve<uint8_t>(p, HW);
  bd.t = carve<int8_t>(p, HW);
  uint8_t* s_feat = carve<uint8_t>(p, HW * NF_NB);
  float* s_row = carve<float>(p, nwarps * A);
  __shared__ int red[7];
  bd.red = red;
  stage_board(pc, s, b, me, false, false, bd, nullptr);

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = b * HW + c;
    const int x = c % W, y = c / W;
    uint8_t* f = s_feat + c * NF_NB;
    f[0] = (uint8_t)clampi(s.carried[i], 0, pc.carry_max);
    f[1] = (uint8_t)centroid_bin(red[0], red[1], red[2], x, y);
    f[2] = (uint8_t)centroid_bin(red[3], red[4], red[5], x, y);
    f[3] = (uint8_t)red[6];
    for (int k = 0; k < 4; ++k) {
      const int n = occ_src(H, W, x, y, k);
      int v;
      if (n < 0) {
        v = 1;                      // off the board reads as a wall
      } else {
        const int cl = bd.cls[n];
        v = (cl & 1) ? 2 + bd.t[n] : (cl & 2) ? 2 + T + bd.t[n]
            : (cl & 4) ? 1 : 0;
      }
      f[4 + k] = (uint8_t)v;
    }
    f[8] = (uint8_t)bd.t[c];
  }
  __syncthreads();

  float* row = s_row + warp * A;
  for (int c = warp; c < HW; c += nwarps) {
    const size_t i = b * HW + c;
    const int32_t* m = mask + i * pc.M;
    const bool can = m[0] != 0;
    if (mode != NB_LOGITS && !can) {
      if (lane == 0) {
        arms[i] = -1;
        to_action(-1, T, pc.D, act + i * 7);
      }
      continue;
    }
    const uint8_t* f = s_feat + c * NF_NB;
    float vals[MAXJ];
    bool legal[MAXJ];
    for (int j = 0, a = lane; a < A; ++j, a += 32) {
      const float* lc = logc + (size_t)a * S;
      float l = log_prior[a];
      for (int k = 0; k < NF_NB; ++k)
        l = __fadd_rn(l, __fmul_rn(c_cal, lc[pc.off[k] + f[k]]));
      vals[j] = l;
      legal[j] = arm_legal(m, a, T);
    }
    if (mode == NB_LOGITS) {
      for (int j = 0, a = lane; a < A; ++j, a += 32) out[i * A + a] = vals[j];
      continue;
    }
    if (mode == NB_SAMPLE) softmax_row(vals, legal, A, lane, row);
    const int arm = draw_or_argmax(
        mode == NB_GREEDY, can, vals, legal, row,
        gumbel != nullptr ? gumbel + i * A : nullptr, A, lane);
    if (lane == 0) {
      arms[i] = arm;
      to_action(arm, T, pc.D, act + i * 7);
    }
    __syncwarp();
  }
}

static size_t aim_smem(int HW, int A, int threads) {
  return carve_bytes(HW) * 3 + carve_bytes(HW * NF_AIM)
         + carve_bytes(HW * NTY * 4) + carve_bytes(HW * 4)
         + carve_bytes((threads / 32) * A * 4) + 16;
}

static size_t nb_smem(int HW, int A, int threads) {
  return carve_bytes(HW) * 2 + carve_bytes(HW * NF_NB)
         + carve_bytes((threads / 32) * A * 4) + 16;
}

// players: int32 [B] or null (me0 for every env); mask int32 [B, H, W, M];
// gumbel float32 [B, H, W, A] (P_SAMPLE) or null; out float32 [B, H, W, A]
// (P_LOGITS, P_PRIOR) or arms int32 [B, H, W] and act int32 [B, H, W, 7].
extern "C" int aim_predict_launch(const PredCfg* pc, const StateP* s,
                                  int batch, int me0, const int32_t* players,
                                  const int32_t* mask, const AimTabs* tb,
                                  int mode, const float* gumbel, float* out,
                                  int32_t* arms, int32_t* act, void* stream) {
  if (mode < P_LOGITS || mode > P_GREEDY || pc->A > MAXA
      || pc->nbarr > MAXNB || (mode == P_SAMPLE) != (gumbel != nullptr)
      || ((mode <= P_PRIOR) != (out != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int HW = pc->H * pc->W, threads = block_threads(HW);
  const size_t smem = aim_smem(HW, pc->A, threads);
  cudaError_t e = allow_smem(aim_predict_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  aim_predict_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      *pc, *s, me0, players, mask, *tb, mode, gumbel, out, arms, act);
  return (int)cudaGetLastError();
}

// log_prior float32 [A], logc float32 [A, S] (the per-feature log tables
// concatenated), c the calibration exponent; the rest as aim_predict's.
extern "C" int nb_predict_launch(const PredCfg* pc, const StateP* s,
                                 int batch, int me0, const int32_t* players,
                                 const int32_t* mask, const float* log_prior,
                                 const float* logc, float c_cal, int mode,
                                 const float* gumbel, float* out,
                                 int32_t* arms, int32_t* act, void* stream) {
  if (mode < NB_LOGITS || mode > NB_GREEDY || pc->A > MAXA
      || pc->nbarr > MAXNB || (mode == NB_SAMPLE) != (gumbel != nullptr)
      || ((mode == NB_LOGITS) != (out != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int HW = pc->H * pc->W, threads = block_threads(HW);
  const size_t smem = nb_smem(HW, pc->A, threads);
  cudaError_t e = allow_smem(nb_predict_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  nb_predict_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      *pc, *s, me0, players, mask, log_prior, logc, c_cal, mode, gumbel, out,
      arms, act);
  return (int)cudaGetLastError();
}
