// arm_sample and arms_to_action: the search bots' per-cell local bandits
// over the arm catalog (K12b).
//
// Replaces the JAX package's arm_masks (microrts_tpu/ops/arms.py:60),
// naive_mcts_bot's local_sample (microrts_tpu/bots/treesearch.py:196-274,
// the informed branch of InformedNaiveMCTS :259-271 included),
// sample_arms (ops/arms.py:121) and arms_to_action (ops/arms.py:82); in
// uniform mode uct_tree_bot's sample_cands (treesearch.py:646).
//
// Bound (16x16, A=90 arms): every cell's can-act flag (the mask's
// channel 0) is read and its arm and action (32 B) written; only a cell
// that can act needs the rest: its mask row, the node's tvis/tacc rows
// and its Gumbels (4 B each a cell and arm).  In mid-game states few
// cells can act (under 1% of the cells of the recorded 1024-env rush
// states), so the bound is about 36 B a cell: bytes, ~3 us at 1024 envs
// and 3.35 TB/s.
//
// Design: one block per (game, draw).  Its threads walk the cells: a cell
// that cannot act gets -1 and a zero action at once, the others go on a
// shared list.  A warp then takes each listed cell, its lanes every 32nd
// arm: the rule's statistics (legal-arm count, unvisited arms, the greedy
// or UCB1 arm) and the Gumbel-max draw are warp reductions, the first
// maximum kept as a serial scan keeps it.  The node's row is addressed in
// the tree tables by cur[b]: no gathered copy.  MLPS's M (the widest
// unit) is a block maximum taken before the draws; UCTUnitActions' first
// acting cell a block minimum.
//
// Floats: IEEE-rounded __fdiv_rn/__fadd_rn/__fmul_rn, sqrtf and logf (no
// fast math), in the JAX code's order, so that the kernel equals the plain
// PyTorch version on the card bit for bit; the categorical is the first
// maximum of logf(w + 1e-20) + g, as jax.random.categorical takes it.
#include "arms.cuh"

enum { M_UNIFORM = 0, M_EGREEDY = 1, M_UCB = 2, M_UNIT_UCT = 3,
       M_INFORMED = 4 };

struct ArmCfg {
  int H, W, T, D;   // board, unit types, attack window diameter
  int A, M;         // arms, packed mask channels (23 + T + D*D)
  int n1;           // tree rows a game (N + 1)
};

__global__ void arm_sample_kernel(ArmCfg cfg, int mode, int K,
                                  const int32_t* mask, const float* gumbel,
                                  const int32_t* tvis, const float* tacc,
                                  const int32_t* nvis, const int32_t* cur,
                                  const int32_t* player, int maxp,
                                  float eps_l, float greedy_w, float ucb_c,
                                  const float* prior, int32_t* arms,
                                  int32_t* act) {
  extern __shared__ int s_list[];  // the cells that can act
  const int HW = cfg.H * cfg.W, A = cfg.A, T = cfg.T;
  const int b = blockIdx.x / K, k = blockIdx.x % K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float NEG_INF = __int_as_float(0xff800000);
  const float TINY = 1e-20f;
  __shared__ int s_n, s_widest, s_first;
  if (threadIdx.x == 0) { s_n = 0; s_widest = 0; s_first = INF_I; }
  __syncthreads();

  // node row and per-game constants
  size_t row = 0;
  float n = 1.0f;
  bool is_max = true;
  if (mode != M_UNIFORM) {
    row = (size_t)b * cfg.n1 + cur[b];
    const int nv = nvis[row];
    n = (float)(nv > 1 ? nv : 1);
    is_max = player[b] == maxp;
  }
  const size_t base = (size_t)blockIdx.x * HW;  // (game, draw)'s cells

  // a cell that cannot act draws nothing: -1 and a zero action, at once;
  // the others are listed for a warp each
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    if (mask[((size_t)b * HW + c) * cfg.M]) {
      s_list[atomicAdd(&s_n, 1)] = c;
      atomicMin(&s_first, c);
    } else {
      arms[base + c] = -1;
      if (act != nullptr) to_action(-1, T, cfg.D, act + (base + c) * 7);
    }
  }
  __syncthreads();
  const int n_act = s_n, first = s_first;

  // MLPS's M: the widest acting unit (a legal-arm count a warp)
  if (mode == M_UCB) {
    for (int i = warp; i < n_act; i += nwarps) {
      const int32_t* m = mask + ((size_t)b * HW + s_list[i]) * cfg.M;
      int cnt = 0;
      for (int a = lane; a < A; a += 32) cnt += arm_legal(m, a, T);
      cnt = __reduce_add_sync(FULL_MASK, cnt);
      if (lane == 0) atomicMax(&s_widest, cnt);
    }
    __syncthreads();
  }
  const float Mw = (float)s_widest;

  // a warp an acting cell, a lane every 32nd arm: the rule's statistics,
  // then the distribution and the Gumbel-max draw
  for (int i = warp; i < n_act; i += nwarps) {
    const int c = s_list[i];
    const size_t cell = base + c;
    if (mode == M_UNIT_UCT && c != first) {  // one unit a level
      if (lane == 0) {
        arms[cell] = -1;
        if (act != nullptr) to_action(-1, T, cfg.D, act + cell * 7);
      }
      continue;
    }
    const int32_t* m = mask + ((size_t)b * HW + c) * cfg.M;
    const float* g = gumbel + cell * A;
    const int32_t* tv = tvis + (row * HW + c) * A;
    const float* ta = tacc + (row * HW + c) * A;
    int pick = -1;          // one-hot rules: the picked arm
    bool any_w = false;     // any positive weight
    float wv = 0.0f;        // egreedy: the visited-arm weight eps_l / nleg
    int best = 0;           // egreedy: the greedy arm
    bool pri_pos = false;   // informed: some prior weight is positive
    bool any_unv = false;

    const float* pri =
        prior != nullptr ? prior + ((size_t)b * HW + c) * A : nullptr;
    if (mode == M_EGREEDY || mode == M_INFORMED) {
      int nleg = 0;
      float bv = NEG_INF;
      int bi = INF_I;
      for (int a = lane; a < A; a += 32) {
        if (!arm_legal(m, a, T)) continue;
        ++nleg;
        const int v = tv[a];
        if (v == 0) { any_unv = true; continue; }
        float mean = __fdiv_rn(ta[a], (float)v);
        if (!is_max) mean = -mean;
        if (mean > bv) { bv = mean; bi = a; }
      }
      nleg = __reduce_add_sync(FULL_MASK, nleg);
      any_unv = __any_sync(FULL_MASK, any_unv);
      best = warp_first_max(bv, bi);
      wv = __fdiv_rn(eps_l, (float)(nleg > 1 ? nleg : 1));
      any_w = any_unv || (nleg > 0 && (wv > 0.0f
                                       || __fadd_rn(wv, greedy_w) > 0.0f));
      if (mode == M_INFORMED) {
        // the prior's weights; a cell none of whose weights is positive
        // weighs its unvisited legal arms alike (treesearch.py:265-271)
        bool pos = false;
        for (int a = lane; a < A; a += 32) {
          const bool la = arm_legal(m, a, T);
          const float w = any_unv ? ((la && tv[a] == 0) ? pri[a] : 0.0f)
                          : la ? __fadd_rn(__fmul_rn(eps_l, pri[a]),
                                           a == best ? greedy_w : 0.0f)
                               : 0.0f;
          pos = pos || w > 0.0f;
        }
        pri_pos = __any_sync(FULL_MASK, pos);
        any_w = pri_pos || any_unv;
      }
    } else if (mode == M_UCB || mode == M_UNIT_UCT) {
      int last_unv = -1;
      float bv = NEG_INF;
      int bi = INF_I;
      for (int a = lane; a < A; a += 32) {
        if (!arm_legal(m, a, T)) continue;
        const int v = tv[a];
        if (v == 0) { last_unv = a; continue; }
        const float tvf = (float)v;
        float mean = __fdiv_rn(ta[a], tvf);
        if (!is_max) mean = -mean;
        float score;
        if (mode == M_UCB) {
          const float ex = __fmul_rn(Mw, sqrtf(__fdiv_rn(
              __fmul_rn(__fadd_rn(Mw, 1.0f), logf(n)), tvf)));
          score = __fadd_rn(mean, __fmul_rn(ucb_c, ex));
        } else {
          const float lg = logf(__fdiv_rn(n, tvf));
          const float ex = sqrtf(lg > 0.0f ? lg : 0.0f);
          score = __fadd_rn(__fmul_rn(ucb_c, __fmul_rn(
              __fadd_rn(mean, 1.0f), 0.5f)), ex);
        }
        if (score > bv) { bv = score; bi = a; }
      }
      last_unv = __reduce_max_sync(FULL_MASK, last_unv);
      const int arg = warp_first_max(bv, bi);
      pick = last_unv >= 0 ? last_unv : arg;
      any_w = arm_legal(m, pick, T);
    }

    // the distribution and the Gumbel-max draw
    float top = NEG_INF;
    int arm = INF_I;
    for (int a = lane; a < A; a += 32) {
      float w = 1.0f;
      if (mode == M_UNIFORM) {
        w = arm_legal(m, a, T) ? 1.0f : 0.0f;
      } else if (any_w) {
        if (mode == M_INFORMED) {
          const bool la = arm_legal(m, a, T);
          if (!pri_pos) {
            w = (la && tv[a] == 0) ? 1.0f : 0.0f;
          } else if (any_unv) {
            w = (la && tv[a] == 0) ? pri[a] : 0.0f;
          } else {
            w = la ? __fadd_rn(__fmul_rn(eps_l, pri[a]),
                               a == best ? greedy_w : 0.0f) : 0.0f;
          }
        } else if (mode == M_EGREEDY) {
          const bool la = arm_legal(m, a, T);
          if (any_unv) {
            w = (la && tv[a] == 0) ? 1.0f : 0.0f;
          } else {
            w = la ? __fadd_rn(wv, a == best ? greedy_w : 0.0f) : 0.0f;
          }
        } else {
          w = a == pick ? 1.0f : 0.0f;
        }
      }
      const float val = __fadd_rn(logf(__fadd_rn(w, TINY)), g[a]);
      if (val > top) { top = val; arm = a; }
    }
    arm = warp_first_max(top, arm);
    if (lane == 0) {
      arms[cell] = arm;
      if (act != nullptr) to_action(arm, T, cfg.D, act + cell * 7);
    }
  }
}

__global__ void arms_to_action_kernel(int n, int T, int D,
                                      const int32_t* arms, int32_t* act) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) to_action(arms[i], T, D, act + (size_t)i * 7);
}

// mode: M_UNIFORM (K draws, gumbel [B, K, H, W, A], no tables) or one of
// the tree rules (K = 1; tvis/tacc [B, n1, H, W, A], nvis [B, n1], cur and
// player [B]; M_INFORMED also prior [B, H, W, A]); arms [B, K, H, W] out,
// act [B, H, W, 7] out or null.
extern "C" int arm_sample_launch(const ArmCfg* cfg, int batch, int mode,
                                 int K, const int32_t* mask,
                                 const float* gumbel, const int32_t* tvis,
                                 const float* tacc, const int32_t* nvis,
                                 const int32_t* cur, const int32_t* player,
                                 int maxp, float eps_l, float greedy_w,
                                 float ucb_c, const float* prior,
                                 int32_t* arms, int32_t* act,
                                 void* stream) {
  if (mode < M_UNIFORM || mode > M_INFORMED || K < 1
      || (mode != M_UNIFORM && K != 1)
      || ((mode == M_INFORMED) != (prior != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int HW = cfg->H * cfg->W;
  arm_sample_kernel<<<batch * K, block_threads(HW), HW * sizeof(int),
                      (cudaStream_t)stream>>>(
      *cfg, mode, K, mask, gumbel, tvis, tacc, nvis, cur, player, maxp,
      eps_l, greedy_w, ucb_c, prior, arms, act);
  return (int)cudaGetLastError();
}

extern "C" int arms_to_action_launch(int n, int T, int D,
                                     const int32_t* arms, int32_t* act,
                                     void* stream) {
  arms_to_action_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      n, T, D, arms, act);
  return (int)cudaGetLastError();
}
