// epilogue: the step epilogue's rewards, dones and auto-reset arithmetic.
//
// Replaces the JAX package's GridnetEnv._rewards / _reward_one
// (microrts_tpu/env/gridnet.py:491, :501) for both players, dones (:467),
// and the reset_mask / steps' arithmetic of VecGridnetEnv.step
// (microrts_tpu/env/vec.py:73-105).
//
// Bound at B=1024, 16x16: it reads the pre-step utype and owner (2 B/cell),
// atype, atx, aty and aptype of both players' candidates (32 B/cell) and
// the post-step utype, owner and carried (4 B/cell): about 38 B/cell,
// 10.0 MB, 3.0 us at 3.35 TB/s; the outputs are a few bytes per env.
// Bound by bytes.
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
// board), as the port's plain version does.
#include "common.cuh"

#define MAXNR 8
enum { R_WINLOSS = 0, R_RESGATHER = 1, R_PRODWORKER = 2, R_PRODBUILDING = 3,
       R_PRODCOMBAT = 4, R_ATTACK = 5 };
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
