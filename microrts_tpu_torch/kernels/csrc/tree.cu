// mcts_descend and mcts_backprop: the tree-search bots' node-array updates
// (K12c, K12d).
//
// mcts_descend replaces one step of the JAX package's descent loops:
// naive_mcts_bot's descend (microrts_tpu/bots/treesearch.py:300-381) and
// uct_tree_bot's (:677-744, split in two launches: the UCB1 choice before
// the expansion is simulated, the bookkeeping after).  mcts_backprop
// replaces the leaf's credit and the backprop loops (:390-408, :748-760).
//
// Bound at B=64 games, 16x16, N=96 nodes, C=16 children (a NaiveMCTS
// step): the child compare reads up to C*H*W int8 (4 KB), the node's
// scalars, the expanded state (~3 KB) written into its row and the next
// node's state copied into the per-game scratch (~3 KB each way): ~13 KB
// a game, 0.8 MB, ~0.25 us at 3.35 TB/s.  mcts_backprop reads the path
// and its edge planes ((D+2)*H*W int8) and adds into at most D+2 cells of
// tacc/tvis a cell.  Both are launch-bound.
//
// Design: one block per game, one thread per cell.  Thread 0 runs the
// scalar logic (global bandit, child match, expansion, path, next node)
// from shared flags that the cells fill (a slot's arm plane differs from
// the sampled one: the exact compare of the Java childrenMap key); every
// thread then writes its cells: the expanded state into row widx (the
// scratch row N when nothing expands, as in JAX), the edge arm plane, the
// child's arm plane, and the state of the next node into the scratch
// State the next step reads (no gathered copy on the host).  Each table
// element is added to by one thread in the JAX loop's order, so the float
// sums equal JAX's.
#include "common.cuh"

#define MAXC 64

enum { D_NAIVE = 0, D_UCT_SELECT = 1, D_UCT = 2 };

struct TreeDims {
  int H, W, T, Dd;  // board, unit types, attack window diameter
  int A, n1, C, D;  // arms, rows a game (N + 1), children / candidates,
                    // max depth (the path has D + 2 slots)
};

struct TreeP {
  int32_t* nplayer; uint8_t* nterm; int32_t* ndepth; float* nacc;
  int32_t* nvis; int32_t* children; int8_t* carms; int32_t* nchild;
  int32_t* nnodes; float* tacc; int32_t* tvis; int8_t* acand;
  int32_t* avis; float* aacc; int32_t* achild;
};

struct WalkP {
  int32_t* cur; uint8_t* found; int32_t* leaf; int32_t* path;
  void* edge;  // int8 [B, D+2, H, W] arm planes, or int32 [B, D+2] slots
  int32_t* plen; int32_t* player;
};

struct StepP {  // one descent step's inputs
  const uint8_t* done2; const uint8_t* can_max; const uint8_t* can_min;
  const int32_t* arms;    // naive: the sampled arm plane [B, H, W]
  const float* coin_g; const int32_t* pick_g; const float* coin0;
  const int32_t* slot;    // UCT: the chosen candidate [B]
  const int32_t* cands;   // UCT: the expanded state's candidates
};

// UCT's choice at the walk's node: unexplored candidates first (or the
// first-play urgency), else UCB1 (treesearch.py:680-700).
__global__ void uct_select_kernel(TreeDims dm, TreeP t, WalkP w, int maxp,
                                  float c_uct, int fpu_on, float fpu,
                                  int32_t* slot_out, int32_t* act) {
  const int HW = dm.H * dm.W, K = dm.C, b = blockIdx.x;
  __shared__ int s_slot;
  __shared__ size_t s_row;
  if (threadIdx.x == 0) {
    const size_t row = (size_t)b * dm.n1 + w.cur[b];
    const bool is_max = t.nplayer[row] == maxp;
    const int nv = t.nvis[row];
    const float lnv = logf(__fadd_rn((float)(nv > 1 ? nv : 1), 1.0f));
    const float NEG_INF = __int_as_float(0xff800000);
    int first_unex = -1, arg = 0;
    float best = NEG_INF;
    for (int k = 0; k < K; ++k) {
      const int av = t.avis[row * K + k];
      if (av == 0 && first_unex < 0) first_unex = k;
      const float avf = (float)(av > 1 ? av : 1);
      float mean = __fdiv_rn(t.aacc[row * K + k], avf);
      if (!is_max) mean = -mean;
      float e = __fadd_rn(__fmul_rn(__fadd_rn(mean, 1.0f), 0.5f),
                          __fmul_rn(c_uct, sqrtf(__fdiv_rn(lnv, avf))));
      if (fpu_on && av == 0) e = fpu;
      if (e > best) { best = e; arg = k; }
    }
    s_slot = (!fpu_on && first_unex >= 0) ? first_unex : arg;
    s_row = row;
    slot_out[b] = s_slot;
  }
  __syncthreads();
  const int8_t* cand = t.acand + (s_row * K + s_slot) * HW;
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    to_action(cand[c], dm.T, dm.Dd, act + ((size_t)b * HW + c) * 7);
}

__global__ void descend_kernel(TreeDims dm, int mode, TreeP t, WalkP w,
                               StateP S, StateP st2, StepP sp, int maxp,
                               float eps0, float eps_g, StateP cur_st,
                               StateP leaf_st) {
  const int HW = dm.H * dm.W, C = dm.C, N = dm.n1 - 1, D2 = dm.D + 2;
  const int b = blockIdx.x;
  const size_t g0 = (size_t)b * dm.n1;  // row of node 0
  __shared__ int s_mis[MAXC];
  __shared__ int s_cur, s_nch, s_gslot, s_widx, s_wcur, s_slotc, s_pidx,
      s_nxt, s_move_g, s_leaf_mode;
  const int cur = w.cur[b];
  const bool naive = mode == D_NAIVE;
  if (threadIdx.x == 0) s_nch = naive ? t.nchild[g0 + cur] : 0;
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_mis[i] = 0;
  __syncthreads();

  // child lookup by exact arm-plane compare (NaiveMCTS)
  if (naive) {
    const int8_t* crm = t.carms + (g0 + cur) * C * HW;
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const int8_t a8 = (int8_t)sp.arms[(size_t)b * HW + c];
      for (int k = 0; k < s_nch; ++k)
        if (crm[(size_t)k * HW + c] != a8) s_mis[k] = 1;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int nch = s_nch;
    const bool found = w.found[b] != 0;
    const bool term = t.nterm[g0 + cur] || t.ndepth[g0 + cur] >= dm.D;
    const bool can_max = sp.can_max[b], can_min = sp.can_min[b];
    const int cplayer = can_max ? maxp : 1 - maxp;
    const bool cterm = sp.done2[b] || (!can_max && !can_min);
    const int new_id = t.nnodes[b];
    bool do_exp, need_exp, room, move_g = false, move_m = false;
    int gslot = 0, gchild = 0, mchild = 0, child = -1, slot = 0;
    if (naive) {
      // global MAB (selectFromAlreadySampledEpsilonGreedy)
      const bool is_max = t.nplayer[g0 + cur] == maxp;
      const float NEG_INF = __int_as_float(0xff800000);
      const int32_t* crow = t.children + (g0 + cur) * C;
      float best = NEG_INF;
      int arg = 0;
      for (int k = 0; k < C; ++k) {
        const int ch = crow[k] > 0 ? crow[k] : 0;
        const int cv = t.nvis[g0 + ch];
        float mean = __fdiv_rn(t.nacc[g0 + ch], (float)(cv > 1 ? cv : 1));
        const float score = k < nch ? (is_max ? mean : -mean) : NEG_INF;
        if (score > best) { best = score; arg = k; }
      }
      gslot = sp.coin_g[b] < eps_g
                  ? sp.pick_g[(size_t)b * C + (nch > 1 ? nch : 1) - 1] : arg;
      gchild = crow[gslot];
      const bool use_global = nch > 0 && sp.coin0[b] >= eps0 && !term
                              && !found;
      int mslot = -1;
      for (int k = 0; k < nch && mslot < 0; ++k)
        if (!s_mis[k]) mslot = k;
      const bool matched = mslot >= 0;
      mchild = crow[matched ? mslot : 0];
      need_exp = !found && !term && !use_global && !matched;
      room = new_id < N && nch < C;
      move_g = use_global;
      move_m = !found && !term && !use_global && matched;
    } else {
      slot = sp.slot[b];
      child = t.achild[(g0 + cur) * C + slot];
      need_exp = !found && !term && child < 0;
      room = new_id < N;
    }
    do_exp = need_exp && room;
    const int widx = do_exp ? new_id : N;
    const int wcur = do_exp ? cur : N;
    // expansion (row N when nothing expands)
    t.nplayer[g0 + widx] = cplayer;
    t.nterm[g0 + widx] = cterm;
    t.ndepth[g0 + widx] = t.ndepth[g0 + cur] + 1;
    t.nnodes[b] = new_id + (do_exp ? 1 : 0);
    int slotc = 0;
    bool hop, leaf_now;
    int leaf = w.leaf[b], nxt;
    const int plen = w.plen[b];
    if (naive) {
      slotc = clampi(nch, 0, C - 1);
      t.children[(g0 + wcur) * C + slotc] = new_id;
      t.nchild[g0 + wcur] += 1;
      hop = move_g || move_m || do_exp;
      const bool stop = term || (need_exp && !room);
      leaf_now = !found && (stop || do_exp);
      if (!found) leaf = do_exp ? new_id : (stop ? cur : leaf);
      nxt = move_g ? gchild : (move_m ? mchild : cur);
      if (do_exp) nxt = new_id;
      if (found) nxt = cur;
    } else {
      t.achild[(g0 + wcur) * C + slot] = new_id;
      hop = !found && !term && (child >= 0 || do_exp);
      leaf_now = !found && (term || do_exp || (need_exp && !room));
      if (!found) leaf = do_exp ? new_id : (leaf_now ? cur : leaf);
      nxt = do_exp ? new_id : (child >= 0 ? child : cur);
      if (found || leaf_now) nxt = cur;
    }
    const int pidx = hop ? plen : dm.D + 1;
    w.path[(size_t)b * D2 + pidx] = hop ? cur : -1;
    if (!naive) ((int32_t*)w.edge)[(size_t)b * D2 + pidx] = slot;
    w.plen[b] = plen + (hop ? 1 : 0);
    w.leaf[b] = leaf;
    w.found[b] = found || leaf_now;
    w.cur[b] = nxt;
    w.player[b] = t.nplayer[g0 + nxt];
    // the scratch states: leaf (1: the expanded state, 2: the node's)
    s_leaf_mode = leaf_now ? (do_exp ? 1 : 2) : 0;
    s_cur = cur; s_gslot = gslot; s_widx = widx; s_wcur = wcur;
    s_slotc = slotc; s_pidx = pidx; s_nxt = nxt; s_move_g = move_g;
    copy_scalars(S, g0 + widx, st2, b);
    if (s_leaf_mode == 1) copy_scalars(leaf_st, b, st2, b);
    if (s_leaf_mode == 2) copy_scalars(leaf_st, b, S, g0 + cur);
    if (nxt != cur) copy_scalars(cur_st, b, S, g0 + nxt);
  }
  __syncthreads();

  const int K = dm.C;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    if (naive) {
      const int8_t a8 = (int8_t)sp.arms[(size_t)b * HW + c];
      const int8_t garm = t.carms[((g0 + s_cur) * C + s_gslot) * HW + c];
      ((int8_t*)w.edge)[((size_t)b * D2 + s_pidx) * HW + c] =
          s_move_g ? garm : a8;
      t.carms[((g0 + s_wcur) * C + s_slotc) * HW + c] = a8;
    } else {
      for (int k = 0; k < K; ++k)
        t.acand[((g0 + s_widx) * K + k) * HW + c] =
            (int8_t)sp.cands[((size_t)b * K + k) * HW + c];
    }
    copy_planes(S, g0 + s_widx, st2, b, HW, c);
    if (s_leaf_mode == 1) copy_planes(leaf_st, b, st2, b, HW, c);
    if (s_leaf_mode == 2) copy_planes(leaf_st, b, S, g0 + s_cur, HW, c);
    if (s_nxt != s_cur) copy_planes(cur_st, b, S, g0 + s_nxt, HW, c);
  }
}

__global__ void backprop_kernel(TreeDims dm, int uct, TreeP t, WalkP w,
                                const float* v) {
  const int HW = dm.H * dm.W, N = dm.n1 - 1, D2 = dm.D + 2, A = dm.A;
  const int b = blockIdx.x;
  const size_t g0 = (size_t)b * dm.n1;
  const float vb = v[b];
  const int plen = w.plen[b];
  if (threadIdx.x == 0) {
    const int leaf = w.leaf[b];
    if (!uct) t.nacc[g0 + leaf] += vb;
    t.nvis[g0 + leaf] += 1;
    for (int i = 0; i < D2; ++i) {
      const int idx = i < plen ? w.path[(size_t)b * D2 + i] : N;
      t.nvis[g0 + idx] += 1;
      if (uct) {
        const int s = ((int32_t*)w.edge)[(size_t)b * D2 + i];
        t.avis[(g0 + idx) * dm.C + s] += 1;
        t.aacc[(g0 + idx) * dm.C + s] += vb;
      } else {
        t.nacc[g0 + idx] += vb;
      }
    }
  }
  if (uct) return;
  const int8_t* edge = (const int8_t*)w.edge;
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    for (int i = 0; i < D2; ++i) {
      const int e = edge[((size_t)b * D2 + i) * HW + c];
      if (e < 0) continue;
      const int idx = i < plen ? w.path[(size_t)b * D2 + i] : N;
      const size_t j = ((g0 + idx) * HW + c) * A + e;
      t.tacc[j] += vb;
      t.tvis[j] += 1;
    }
}

// mode D_NAIVE: one NaiveMCTS step (arms, coins); D_UCT_SELECT: UCT's
// choice (slot_out [B] and act [B, H, W, 7] out); D_UCT: one UCT step
// (slot, cands [B, K, H, W]).  cur_st / leaf_st: the per-game scratch
// States the step writes.
extern "C" int mcts_descend_launch(const TreeDims* dm, int mode, int batch,
                                   const TreeP* t, const WalkP* w,
                                   const StateP* S, const StateP* st2,
                                   const StepP* sp, int maxp, float eps0,
                                   float eps_g, float c_uct, int fpu_on,
                                   float fpu, int32_t* slot_out,
                                   int32_t* act, const StateP* cur_st,
                                   const StateP* leaf_st, void* stream) {
  if (dm->C > MAXC || mode < D_NAIVE || mode > D_UCT)
    return (int)cudaErrorInvalidValue;
  const int threads = block_threads(dm->H * dm->W);
  if (mode == D_UCT_SELECT) {
    uct_select_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
        *dm, *t, *w, maxp, c_uct, fpu_on, fpu, slot_out, act);
  } else {
    descend_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
        *dm, mode, *t, *w, *S, *st2, *sp, maxp, eps0, eps_g, *cur_st,
        *leaf_st);
  }
  return (int)cudaGetLastError();
}

extern "C" int mcts_backprop_launch(const TreeDims* dm, int uct, int batch,
                                    const TreeP* t, const WalkP* w,
                                    const float* v, void* stream) {
  backprop_kernel<<<batch, block_threads(dm->H * dm->W), 0,
                    (cudaStream_t)stream>>>(*dm, uct, *t, *w, v);
  return (int)cudaGetLastError();
}
