// actor: legality masks fused with RandomBiasedAI sampling.
//
// Replaces the JAX package's make_engine.legal_masks
// (microrts_tpu/engine/kernel.py:742, with _free_at :208, tprop :180 and
// _dir_stack :212) and random_bot.bot (microrts_tpu/bots/scripted.py:69,
// kth_legal :57).
//
// Bound at B=1024, 16x16: it reads utype, owner, terrain, busy, carried
// (6 B/cell), the uniforms (8 B/cell) and writes 7 int32 actions
// (28 B/cell): about 42 B/cell, 11 MB, 3.3 us at 3.35 TB/s.  The packed
// int32 mask, when asked for, adds 79*4 B/cell (83 MB).  It is bound by
// bytes: the per-cell work is a few hundred integer operations.
//
// Design: one block per env.  The three planes read at neighbours
// (utype, owner, free) are staged in shared memory once; each thread then
// builds its cell's masks as bit sets in registers (4-bit directions,
// a 4*T-bit produce-pair set, a 64-bit attack window) and samples from
// them without materialising the masks in memory.  The masks reach
// device memory only when the caller asks for them.
//
// Floats: the threshold walk and u1*n use __fadd_rn/__fmul_rn, which the
// compiler never contracts into FMAs, so the float32 results equal the
// JAX package's (the weights are small integers; the sums are exact).
#include "common.cuh"

struct Weights { float w[6]; };

__device__ __forceinline__ int kth_bit(unsigned long long bits, int j) {
  // index of the (j+1)-th set bit; 0 when there is none
  int cnt = 0;
  while (bits) {
    int k = __ffsll((long long)bits) - 1;
    if (cnt == j) return k;
    ++cnt;
    bits &= bits - 1;
  }
  return 0;
}

__device__ __forceinline__ int pick(unsigned long long bits, float u1) {
  int n = __popcll(bits);
  int j = (int)__fmul_rn(u1, (float)n);
  int hi = n - 1 > 0 ? n - 1 : 0;
  return kth_bit(bits, j < hi ? j : hi);
}

__global__ void actor_kernel(Cfg cfg, StateP s, int player,
                             const int32_t* players, const float* u,
                             Weights wt, int32_t* act, int32_t* mask) {
  const int me = players != nullptr ? players[blockIdx.x] : player;
  const int H = cfg.H, W = cfg.W, T = cfg.T, R = cfg.R, D = 2 * cfg.R + 1;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int8_t* s_utype = carve<int8_t>(p, HW);
  int8_t* s_owner = carve<int8_t>(p, HW);
  uint8_t* s_free = carve<uint8_t>(p, HW);

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    int8_t ut = s.utype[base + c];
    s_utype[c] = ut;
    s_owner[c] = s.owner[base + c];
    s_free[c] = (s.terrain[base + c] == 0) && (ut == 0);
  }
  __syncthreads();
  const int bal = s.resources[2 * b + (me == 1 ? 1 : 0)];

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const int ut = s_utype[c];
    const bool exists = ut > 0;
    const int t = tidx(cfg, ut);
    const bool can_act = exists && s_owner[c] == me && !s.busy[base + c];
    const int carried = s.carried[base + c];

    unsigned free_b = 0, res_b = 0, stock_b = 0;
    for (int d = 0; d < 4; ++d) {
      int nx = x + dir_dx(d), ny = y + dir_dy(d);
      if (nx < 0 || nx >= W || ny < 0 || ny >= H) continue;
      int n = ny * W + nx;
      int nut = s_utype[n];
      int nt = tidx(cfg, nut);
      free_b |= (unsigned)s_free[n] << d;
      res_b |= (unsigned)(nut > 0 && cfg.is_resource[nt]) << d;
      stock_b |= (unsigned)(nut > 0 && cfg.is_stockpile[nt]
                            && s_owner[n] == me) << d;
    }
    unsigned move_b = (can_act && cfg.can_move[t]) ? free_b : 0u;
    unsigned harv_b = (can_act && cfg.can_harvest[t] && carried == 0)
                          ? res_b : 0u;
    unsigned ret_b = (can_act && cfg.can_harvest[t] && carried > 0)
                         ? stock_b : 0u;

    // produce pairs, dir-major: bit d*T + j
    unsigned ptype_ok = 0;
    if (can_act)
      for (int j = 0; j < T; ++j)
        ptype_ok |= (unsigned)(((cfg.produces[t] >> j) & 1)
                               && bal >= cfg.cost[j]) << j;
    unsigned long long pair_b = 0;
    unsigned pdir_b = 0, ptype_b = 0;
    for (int d = 0; d < 4; ++d)
      if ((free_b >> d) & 1) {
        pair_b |= (unsigned long long)ptype_ok << (d * T);
        if (ptype_ok) pdir_b |= 1u << d;
        ptype_b |= ptype_ok;
      }

    // relative attack window, bit (dy+R)*D + (dx+R)
    unsigned long long atk_b = 0;
    if (can_act && cfg.can_attack[t]) {
      const int rng2 = cfg.attack_range[t] * cfg.attack_range[t];
      for (int dy = -R; dy <= R; ++dy)
        for (int dx = -R; dx <= R; ++dx) {
          if (dx * dx + dy * dy > rng2) continue;
          int nx = x + dx, ny = y + dy;
          if (nx < 0 || nx >= W || ny < 0 || ny >= H) continue;
          int n = ny * W + nx;
          int o = s_owner[n];
          if (s_utype[n] > 0 && o >= 0 && o != me)
            atk_b |= 1ull << ((dy + R) * D + (dx + R));
        }
    }
    const bool tmask[6] = {can_act, move_b != 0, harv_b != 0, ret_b != 0,
                           pdir_b != 0, atk_b != 0};

    if (act != nullptr) {
      int out[7] = {0, 0, 0, 0, 0, 0, 0};
      if (can_act) {
        const float u0 = u[(base + c) * 2], u1 = u[(base + c) * 2 + 1];
        float w[6];
        for (int i = 0; i < 6; ++i) w[i] = tmask[i] ? wt.w[i] : 0.0f;
        float tot = w[0];
        for (int i = 1; i < 6; ++i) tot = __fadd_rn(tot, w[i]);
        const float xv = __fmul_rn(u0, tot);
        float acc = 0.0f;
        int at = 0;
        bool chosen = false;
        for (int i = 0; i < 6; ++i) {
          acc = __fadd_rn(acc, w[i]);
          if (!chosen && xv < acc) { at = i; chosen = true; }
        }
        const int pj = pick(pair_b, u1);
        out[0] = at;
        out[1] = pick(move_b, u1);
        out[2] = pick(harv_b, u1);
        out[3] = pick(ret_b, u1);
        out[4] = pj / T;
        out[5] = pj % T;
        out[6] = pick(atk_b, u1);
      }
      int32_t* o = act + (base + c) * 7;
      for (int i = 0; i < 7; ++i) o[i] = out[i];
    }

    if (mask != nullptr) {
      const int M = 23 + T + D * D;
      int32_t* m = mask + (base + c) * M;
      int k = 0;
      m[k++] = can_act;
      for (int i = 0; i < 6; ++i) m[k++] = tmask[i];
      for (int d = 0; d < 4; ++d) m[k++] = (move_b >> d) & 1;
      for (int d = 0; d < 4; ++d) m[k++] = (harv_b >> d) & 1;
      for (int d = 0; d < 4; ++d) m[k++] = (ret_b >> d) & 1;
      for (int d = 0; d < 4; ++d) m[k++] = (pdir_b >> d) & 1;
      for (int j = 0; j < T; ++j) m[k++] = (ptype_b >> j) & 1;
      for (int i = 0; i < D * D; ++i) m[k++] = (int)((atk_b >> i) & 1ull);
    }
  }
}

// players: int32 [batch] (one player per env), or null for `player`
extern "C" int actor_launch(const Cfg* cfg, const StateP* s, int batch,
                            int player, const int32_t* players,
                            const float* u, const float* weights,
                            int32_t* act, int32_t* mask, void* stream) {
  const int HW = cfg->H * cfg->W;
  size_t smem = carve_bytes(HW) * 3 + 16;
  cudaError_t e = allow_smem(actor_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  Weights wt;
  for (int i = 0; i < 6; ++i) wt.w[i] = weights[i];
  actor_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, player, players, u, wt, act, mask);
  return (int)cudaGetLastError();
}
