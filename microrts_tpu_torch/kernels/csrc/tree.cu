// mcts_descend, mcts_backprop and mcts_reroot: the tree-search bots'
// node-array updates (K12c, K12d, K12g).
//
// A walk's optional live flags (a per-game iteration budget) leave the games
// outside them untouched: their blocks return at once.
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
  const uint8_t* live;  // [B] the games this iteration runs, or null: all
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
  if (w.live && !w.live[b]) return;
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
  if (w.live && !w.live[b]) return;
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

// ---------------------------------------------------------------------------
// mcts_reroot (K12g): ContinuingNaiveMCTS's re-root (_reroot,
// microrts_tpu/bots/treesearch.py:507-564, with _node_state_matches :449),
// in place on the tree of every game.
//
// Bound at 64 games, 16x16, N=96, C=16, A=90: a game's tables are ~17.9 MB
// (tacc/tvis 184 KB a row).  The re-root reads the node states' 13 match
// fields, moves the reached rows (read once, written once) and writes the
// fresh rows: about the tree's bytes once each way when most rows are
// fresh, ~0.7 ms for 64 games at 3.35 TB/s.
//
// Design: one block per game.  (1) Every cell compares its 11 match planes
// of every valid row with the real state's (a row's flag is set by any
// cell that differs; thread i compares row i's time and resources); (2)
// thread 0 takes the most-visited match (nvis + 1, first index on ties);
// (3) reachability from it over the children lists as D + 2 synchronous
// steps of a flag set in shared memory (double-buffered, as the JAX
// einsum steps are); (4) thread 0's prefix sum gives the new indices (the
// node -> 0, the other reached rows -> 1.. in index order); (5) the
// reached rows move in increasing index order, one row at a time with the
// block's threads over its elements: a reached row other than the node is
// its descendant, so has a larger index and only moves down onto a row
// already read; (6) the rows past the kept ones become a fresh tree's, row
// N (the scratch, where JAX's scatter lands every unreached row and its own
// row wins as the last index) keeps its data with the depth shifted, no
// children; (7) row 0 takes the real state, the player who can act and the
// game-over flag.  No match: the whole tree becomes a fresh one.

#define MAXN1 1024

struct RerootDims {
  int H, W, A, n1, C, D;
};

__device__ __forceinline__ bool plane_differs(const StateP& s, size_t i,
                                              const StateP& r, size_t j) {
  return s.utype[i] != r.utype[j] || s.owner[i] != r.owner[j]
         || s.hp[i] != r.hp[j] || s.carried[i] != r.carried[j]
         || s.busy[i] != r.busy[j] || s.atype[i] != r.atype[j]
         || s.aparam[i] != r.aparam[j] || s.atx[i] != r.atx[j]
         || s.aty[i] != r.aty[j] || s.aptype[i] != r.aptype[j]
         || s.aticks[i] != r.aticks[j];
}

// Row `row` of the game's tables := a fresh tree's (the node state: the
// real state of game b).
__device__ void fresh_row(const RerootDims& dm, TreeP t, StateP S,
                          StateP real, size_t g0, int row, int b) {
  const int HW = dm.H * dm.W, C = dm.C;
  const size_t r = g0 + row;
  if (threadIdx.x == 0) {
    t.nplayer[r] = 0; t.nterm[r] = 0; t.ndepth[r] = 0; t.nacc[r] = 0.0f;
    t.nvis[r] = 0; t.nchild[r] = 0;
    copy_scalars(S, r, real, b);
  }
  for (int k = threadIdx.x; k < C; k += blockDim.x) t.children[r * C + k] = -1;
  for (int i = threadIdx.x; i < C * HW; i += blockDim.x)
    t.carms[r * C * HW + i] = -1;
  const size_t na = (size_t)HW * dm.A;
  for (size_t i = threadIdx.x; i < na; i += blockDim.x) {
    t.tacc[r * na + i] = 0.0f;
    t.tvis[r * na + i] = 0;
  }
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    copy_planes(S, r, real, b, HW, c);
}

__global__ void reroot_kernel(RerootDims dm, TreeP t, StateP S, StateP real,
                              const int32_t* to_move, const uint8_t* term,
                              const uint8_t* live) {
  const int b = blockIdx.x;
  if (live && !live[b]) return;
  const int HW = dm.H * dm.W, C = dm.C, n1 = dm.n1, N = n1 - 1;
  const size_t g0 = (size_t)b * n1;
  __shared__ int s_mis[MAXN1], s_new[MAXN1];
  __shared__ uint8_t s_reach[MAXN1], s_next[MAXN1];
  __shared__ int s_m, s_found, s_kept, s_base;
  const int nn = t.nnodes[b];

  // (1) the match of every valid row
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    const size_t r = g0 + i;
    s_mis[i] = i >= nn || S.time[r] != real.time[b]
               || S.resources[2 * r] != real.resources[2 * b]
               || S.resources[2 * r + 1] != real.resources[2 * b + 1];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    for (int i = 0; i < nn; ++i)
      if (!s_mis[i] && plane_differs(S, (g0 + i) * HW + c, real,
                                     (size_t)b * HW + c))
        s_mis[i] = 1;
  __syncthreads();

  // (2) the most-visited match (argmax of nvis + 1, first index)
  if (threadIdx.x == 0) {
    int m = 0, best = -1, found = 0;
    for (int i = 0; i < n1; ++i) {
      const int sc = s_mis[i] ? 0 : t.nvis[g0 + i] + 1;
      if (!s_mis[i]) found = 1;
      if (sc > best) { best = sc; m = i; }
    }
    s_m = m; s_found = found;
  }
  __syncthreads();
  const int m = s_m;

  if (!s_found) {
    for (int row = 0; row < n1; ++row) fresh_row(dm, t, S, real, g0, row, b);
    if (threadIdx.x == 0) t.nnodes[b] = 1;
  } else {
    // (3) reachability from m in D + 2 synchronous steps
    for (int i = threadIdx.x; i < n1; i += blockDim.x) s_reach[i] = i == m;
    __syncthreads();
    for (int step = 0; step < dm.D + 2; ++step) {
      for (int i = threadIdx.x; i < n1; i += blockDim.x) s_next[i] = s_reach[i];
      __syncthreads();
      for (int i = threadIdx.x; i < n1; i += blockDim.x) {
        if (!s_reach[i]) continue;
        const int nch = t.nchild[g0 + i];
        for (int k = 0; k < C && k < nch; ++k) {
          const int ch = t.children[(g0 + i) * C + k];
          if (ch >= 0) s_next[clampi(ch, 0, N)] = 1;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n1; i += blockDim.x) s_reach[i] = s_next[i];
      __syncthreads();
    }
    // (4) the new indices
    if (threadIdx.x == 0) {
      int cnt = 0;
      for (int i = 0; i < n1; ++i) {
        s_reach[i] = s_reach[i] && i < nn;
        if (i == m) s_new[i] = 0;
        else if (s_reach[i]) s_new[i] = ++cnt;
        else s_new[i] = N;
      }
      s_kept = cnt + 1;
      s_base = t.ndepth[g0 + m];
    }
    __syncthreads();
    const int base = s_base, kept = s_kept;
    // (5) move the reached rows down, in index order
    const size_t na = (size_t)HW * dm.A;
    for (int i = m; i < nn; ++i) {
      if (!s_reach[i]) continue;
      const size_t src = g0 + i, dst = g0 + s_new[i];
      const int nch = t.nchild[src];
      __syncthreads();  // every thread has read nchild before row 0 moves
      for (int k = threadIdx.x; k < C; k += blockDim.x) {
        const int ch = k < nch ? t.children[src * C + k] : -1;
        const int cc = clampi(ch, 0, N);
        t.children[dst * C + k] = (ch >= 0 && s_reach[cc]) ? s_new[cc] : -1;
      }
      if (dst != src) {
        for (int j = threadIdx.x; j < C * HW; j += blockDim.x)
          t.carms[dst * C * HW + j] = t.carms[src * C * HW + j];
        for (size_t j = threadIdx.x; j < na; j += blockDim.x) {
          t.tacc[dst * na + j] = t.tacc[src * na + j];
          t.tvis[dst * na + j] = t.tvis[src * na + j];
        }
        for (int c = threadIdx.x; c < HW; c += blockDim.x)
          copy_planes(S, dst, S, src, HW, c);
      }
      if (threadIdx.x == 0) {
        t.nplayer[dst] = t.nplayer[src]; t.nterm[dst] = t.nterm[src];
        t.ndepth[dst] = t.ndepth[src] - base; t.nacc[dst] = t.nacc[src];
        t.nvis[dst] = t.nvis[src]; t.nchild[dst] = nch;
        if (dst != src) copy_scalars(S, dst, S, src);
      }
      __syncthreads();
    }
    // (6) fresh rows past the kept ones; row N keeps its data
    for (int row = kept; row < N; ++row) fresh_row(dm, t, S, real, g0, row, b);
    for (int k = threadIdx.x; k < C; k += blockDim.x)
      t.children[(g0 + N) * C + k] = -1;
    if (threadIdx.x == 0) {
      t.ndepth[g0 + N] -= base;
      t.nchild[g0 + N] = 0;
      t.nnodes[b] = kept;
    }
  }
  // (7) the root: the real state, the player who can act, game over
  __syncthreads();
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    copy_planes(S, g0, real, b, HW, c);
  if (threadIdx.x == 0) {
    copy_scalars(S, g0, real, b);
    t.nplayer[g0] = to_move[b];
    t.nterm[g0] = term[b];
  }
}

extern "C" int mcts_reroot_launch(const RerootDims* dm, int batch,
                                  const TreeP* t, const StateP* S,
                                  const StateP* real, const int32_t* to_move,
                                  const uint8_t* term, const uint8_t* live,
                                  void* stream) {
  if (dm->n1 > MAXN1) return (int)cudaErrorInvalidValue;
  reroot_kernel<<<batch, 256, 0, (cudaStream_t)stream>>>(
      *dm, *t, *S, *real, to_move, term, live);
  return (int)cudaGetLastError();
}
