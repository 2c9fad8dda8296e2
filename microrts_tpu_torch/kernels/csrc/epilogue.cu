// epilogue: the step epilogue's rewards, dones and auto-reset arithmetic.
//
// Replaces the JAX package's GridnetEnv._rewards / _reward_one
// (microrts_tpu/env/gridnet.py:491, :501) for both players, dones (:467),
// and the reset_mask / steps' arithmetic of VecGridnetEnv.step
// (microrts_tpu/env/vec.py:73-105), with the closertoenemybase and
// closertoenemyunit rewards (_closer_reward, gridnet.py:555-584).
//
// Bound at B=1024, 16x16: it reads the pre-step utype and owner (2 B/cell),
// atype, atx, aty and aptype of both players' candidates (32 B/cell) and
// the post-step utype, owner and carried (4 B/cell): about 38 B/cell,
// 10.0 MB, 3.0 us at 3.35 TB/s; the outputs are a few bytes per env.
// Bound by bytes; the closer rewards read no other bytes.
//
// Design: one block per env; each thread counts over its cells the six
// per-player reward counts (harvest/return, produced worker, building,
// combat unit, attacks on enemy and on own units), the two players' unit
// counts (gameover and winner, as engine/kernel.py gameover/winner) and
// the resource nodes still holding resources.  The counts are reduced
// with warp shuffles and shared int32 atomics (exact, order-free); thread
// 0 writes the rewards in the configured reward_fns order, the dones and
// the reset arithmetic.  The attack reward gathers each target cell once
// (a target within the range disc, on the board, read on the pre-step
// board), as the port's plain version does.  The closer rewards take
// two more passes when configured: a block-wide min of the first target
// cell (row-major) of each player on the pre-step board, then float32
// mins of the Euclidean distances from each player's mobile units to it
// on the pre and post boards (atomicMin on the bits of non-negative
// floats orders them as floats; sqrt correctly rounded, as XLA's).
//
// env_health: the per-env failure detector of the quarantined vec step
// (env_health, microrts_tpu/env/vec.py:23-48).  One block per env ORs
// its cells' faults (an occupied cell with hp outside [1, max hp], a
// type past the UTT, a busy cell with negative ticks), its two
// stockpiles' (negative or above 10^6) and its rewards' (non-finite)
// with __syncthreads_or.  Bound at B=1024, 16x16: utype, hp, busy and
// aticks (6 B/cell), the stockpiles and 16 rewards: about 1.65 MB, 0.49
// us at 3.35 TB/s; bound by bytes, in practice by the launch.
#include "common.cuh"
#include <climits>

#define MAXNR 8
enum { R_WINLOSS = 0, R_RESGATHER = 1, R_PRODWORKER = 2, R_PRODBUILDING = 3,
       R_PRODCOMBAT = 4, R_ATTACK = 5, R_CLOSERBASE = 6, R_CLOSERUNIT = 7 };
// per-player counts, then the post-step counts
enum { K_RG = 0, K_PW, K_PB, K_PC, K_APOS, K_ANEG, K_PER = 6 };
enum { K_N0 = 2 * K_PER, K_N1, K_NODES, K_ALL };

struct EpiCfg {
  int nr;
  int fns[MAXNR];
  int worker_id, base_id, barracks_id, light_id, heavy_id, ranged_id;
};

__global__ void epilogue_kernel(Cfg cfg, EpiCfg ec, int batch,
                                const int8_t* pre_utype,
                                const int8_t* pre_owner, CandP c0, CandP c1,
                                const int8_t* utype, const int8_t* owner,
                                const int16_t* carried, const int32_t* steps,
                                int max_steps, float* rewards, uint8_t* dones,
                                int done_copies, uint8_t* reset,
                                int32_t* steps_out) {
  const int H = cfg.H, W = cfg.W, R = cfg.R;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  __shared__ int s_cnt[K_ALL];
  if (threadIdx.x < K_ALL) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  int cnt[K_ALL];
  for (int k = 0; k < K_ALL; ++k) cnt[k] = 0;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int ut = utype[base + c];
    if (ut > 0) {
      const int ow = owner[base + c];
      cnt[K_N0] += ow == 0;
      cnt[K_N1] += ow == 1;
      cnt[K_NODES] += cfg.is_resource[tidx(cfg, ut)] && carried[base + c] > 0;
    }
    if (pre_utype == nullptr) continue;
    const int put = pre_utype[base + c], pow = pre_owner[base + c];
    if (put <= 0 || (pow != 0 && pow != 1)) continue;
    const CandP& cd = pow == 0 ? c0 : c1;
    int* k = cnt + pow * K_PER;
    const int at = cd.atype[base + c];
    if (at == A_HARVEST || at == A_RETURN) k[K_RG] += 1;
    if (at == A_PRODUCE) {
      const int pt = cd.aptype[base + c];
      k[K_PW] += pt == ec.worker_id;
      k[K_PB] += pt == ec.base_id || pt == ec.barracks_id;
      k[K_PC] += pt == ec.light_id || pt == ec.heavy_id || pt == ec.ranged_id;
    }
    if (at == A_ATTACK) {
      const int tx = cd.atx[base + c], ty = cd.aty[base + c];
      const int dx = tx - c % W, dy = ty - c / W;
      if (dx * dx + dy * dy <= R * R && tx >= 0 && tx < W && ty >= 0
          && ty < H) {
        const int n = ty * W + tx;
        if (pre_utype[base + n] > 0) {
          const int o = pre_owner[base + n];
          k[K_APOS] += o == 1 - pow;
          k[K_ANEG] += o == pow;
        }
      }
    }
  }
  for (int k = 0; k < K_ALL; ++k) {
    int v = cnt[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&s_cnt[k], v);
  }

  // the closer rewards: s_tgt[kind * 2 + p] is player p's first target
  // cell (kind 0 an enemy base, 1 any enemy unit), s_dist[(kind * 2 + p)
  // * 2 + board] the bits of the least distance to it (board 0 pre, 1
  // post)
  __shared__ int s_tgt[4], s_dist[8];
  bool closer = false;
  for (int j = 0; j < ec.nr; ++j)
    closer |= ec.fns[j] == R_CLOSERBASE || ec.fns[j] == R_CLOSERUNIT;
  closer &= pre_utype != nullptr;
  if (closer) {
    if (threadIdx.x < 4) s_tgt[threadIdx.x] = INT_MAX;
    if (threadIdx.x < 8) s_dist[threadIdx.x] = __float_as_int(INFINITY);
    __syncthreads();
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const int put = pre_utype[base + c], pow = pre_owner[base + c];
      for (int p = 0; p < 2; ++p) {
        if (pow != 1 - p) continue;
        if (put - 1 == ec.base_id) atomicMin(&s_tgt[p], c);
        if (put > 0) atomicMin(&s_tgt[2 + p], c);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      for (int board = 0; board < 2; ++board) {
        const int ut = board ? utype[base + c] : pre_utype[base + c];
        const int ow = board ? owner[base + c] : pre_owner[base + c];
        const int t = ut - 1;
        const bool mobile = ut > 0 && (t == ec.worker_id || t == ec.light_id
                                       || t == ec.heavy_id
                                       || t == ec.ranged_id);
        if (!mobile || (ow != 0 && ow != 1)) continue;
        for (int kind = 0; kind < 2; ++kind) {
          const int tg = s_tgt[kind * 2 + ow];
          if (tg == INT_MAX) continue;
          const int dx = c % W - tg % W, dy = c / W - tg / W;
          const float d = __fsqrt_rn((float)(dx * dx + dy * dy));
          atomicMin(&s_dist[(kind * 2 + ow) * 2 + board], __float_as_int(d));
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int n0 = s_cnt[K_N0], n1 = s_cnt[K_N1];
  const bool over = (n0 + n1 == 0) || ((n0 == 0) != (n1 == 0));
  const int win = (n0 > 0 && n1 == 0) ? 0 : ((n1 > 0 && n0 == 0) ? 1 : -1);
  bool done0 = false;
  for (int j = 0; j < ec.nr; ++j) {
    const int fn = ec.fns[j];
    const bool d = fn == R_WINLOSS ? over
                   : (fn == R_RESGATHER ? s_cnt[K_NODES] == 0 : false);
    if (j == 0) done0 = d;
    for (int k = 0; k < done_copies; ++k)
      dones[((size_t)k * batch + b) * ec.nr + j] = d;
    if (rewards == nullptr) continue;
    for (int p = 0; p < 2; ++p) {
      const int* k = s_cnt + p * K_PER;
      float r = 0.0f;
      switch (fn) {
        case R_WINLOSS: r = over ? (win == p ? 1.0f : -1.0f) : 0.0f; break;
        case R_RESGATHER: r = (float)k[K_RG]; break;
        case R_PRODWORKER: r = (float)k[K_PW]; break;
        case R_PRODBUILDING: r = (float)k[K_PB]; break;
        case R_PRODCOMBAT: r = (float)k[K_PC]; break;
        case R_ATTACK: r = (float)(k[K_APOS] - k[K_ANEG]); break;
        case R_CLOSERBASE:
        case R_CLOSERUNIT: {
          const int q = (fn - R_CLOSERBASE) * 2 + p;
          const float d_old = __int_as_float(s_dist[q * 2]);
          const float d_new = __int_as_float(s_dist[q * 2 + 1]);
          if (s_tgt[q] != INT_MAX && isfinite(d_old) && isfinite(d_new))
            r = __fsub_rn(d_old, d_new);
          break;
        }
        default: break;
      }
      rewards[((size_t)b * 2 + p) * ec.nr + j] = r;
    }
  }
  if (steps != nullptr) {
    const int s1 = steps[b] + 1;
    const bool rm = done0 || s1 >= max_steps;
    reset[b] = rm;
    steps_out[b] = rm ? 0 : s1;
  }
}

extern "C" int epilogue_launch(const Cfg* cfg, const EpiCfg* ec, int batch,
                               const int8_t* pre_utype,
                               const int8_t* pre_owner, const CandP* c0,
                               const CandP* c1, const int8_t* utype,
                               const int8_t* owner, const int16_t* carried,
                               const int32_t* steps, int max_steps,
                               float* rewards, uint8_t* dones,
                               int done_copies, uint8_t* reset,
                               int32_t* steps_out, void* stream) {
  const int HW = cfg->H * cfg->W;
  CandP none = {};
  epilogue_kernel<<<batch, block_threads(HW), 0, (cudaStream_t)stream>>>(
      *cfg, *ec, batch, pre_utype, pre_owner, c0 ? *c0 : none,
      c1 ? *c1 : none, utype, owner, carried, steps, max_steps, rewards,
      dones, done_copies, reset, steps_out);
  return (int)cudaGetLastError();
}

__global__ void env_health_kernel(Cfg cfg, StateP s, const float* rewards,
                                  int nrr, int max_hp, uint8_t* failed) {
  const int HW = cfg.H * cfg.W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  int bad = 0;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int ut = s.utype[base + c], hp = s.hp[base + c];
    bad |= ut > 0 && (hp <= 0 || hp > max_hp);
    bad |= ut > cfg.T;
    bad |= s.busy[base + c] && s.aticks[base + c] < 0;
  }
  if (threadIdx.x < 2) {
    const int r = s.resources[2 * b + threadIdx.x];
    bad |= r < 0 || r > 1000000;
  }
  for (int j = threadIdx.x; j < nrr; j += blockDim.x)
    bad |= !isfinite(rewards[(size_t)b * nrr + j]);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) failed[b] = bad != 0;
}

extern "C" int env_health_launch(const Cfg* cfg, const StateP* s, int batch,
                                 const float* rewards, int nrr, int max_hp,
                                 uint8_t* failed, void* stream) {
  env_health_kernel<<<batch, block_threads(cfg->H * cfg->W), 0,
                      (cudaStream_t)stream>>>(*cfg, *s, rewards, nrr, max_hp,
                                              failed);
  return (int)cudaGetLastError();
}
