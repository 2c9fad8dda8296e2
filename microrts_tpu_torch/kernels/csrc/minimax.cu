// minimax_step: one trip's stack bookkeeping of the alpha-beta DFS of the
// minimax bots (K12f).
//
// Replaces the state machine of the JAX package's _make_dfs.body
// (microrts_tpu/bots/minimax.py:151-232, shaped for XLA as
// treesearch.descend is): the pop (:159-181) and the push's row writes
// (:194-225), with the child's odometer init (ops/enumerate.py:105-119)
// folded in.  No Pallas kernel stands behind it; it exists because the
// trip's ~40 small tensor operations would each pay a launch's host cost.
//
// Bound: a popping lane reads and writes a handful of scalars and copies
// the state of the node now on top into the lane's scratch state; a
// pushing lane reads the child's state and its mover's mask (the whole
// row only where a cell can act) and writes the state twice (its stack
// row and the scratch), the packed legal arms, the odometer row, the
// in-flight claim flags and the drawn arms; other lanes count the trip.
// chip_smoke.py works the bytes out from the run's data.
//
// Design: one block a lane, one thread a cell; thread 0 runs the scalar
// rules in JAX's order (strict first-best, alpha/beta or row S, the root
// action), the cells copy planes and pack their legal arms (bit a % 32 of
// word a / 32; each mask channel read once, so that an acting cell's
// loads are independent), the in-flight claims are marked in shared
// memory and the mover's in-flight spend is a shared-memory sum.  Every
// write that does not apply goes to row S, as JAX's does, so whole stacks
// compare equal.
#include "common.cuh"

struct MMDims {
  int H, W, T, D;  // board, unit types, attack window diameter
  int M, NW;       // packed mask channels, legal-arm words a cell
  int S;           // the stack's last row (the scratch)
};

struct StackP {
  float* alpha; float* beta; float* best; int32_t* mover; int32_t* nextsim;
  int32_t* down_arms; int32_t* choice; uint8_t* more; int32_t* la;
  uint8_t* claimed0; int32_t* spent0; int32_t* balance;
  int32_t* root_arms; uint8_t* root_set; int32_t* sp; uint8_t* done;
  int32_t* it; int32_t* npush;
};

struct TripP {
  const uint8_t* live; const uint8_t* finish; const uint8_t* push;
  const int32_t* arms; const int32_t* mask2; const int32_t* mover2;
  const int32_t* nextsim2; const uint8_t* leaf2; const float* best2;
};

// The legal arms of a cell whose packed env mask is m, as bits of w (arm
// a is bit a % 32 of w[a / 32]; ops/arms.py arm_masks_packed): each mask
// channel is read once, none where the cell cannot act.
__device__ __forceinline__ void pack_legal(const int32_t* m, int T, int DD,
                                           unsigned* w) {
  if (!m[0]) return;
  w[0] = 1u;  // NONE
  for (int a = 1; a < 13; ++a)  // move, harvest, return: channels 7..18
    if (m[6 + a]) w[a >> 5] |= 1u << (a & 31);
  for (int dir = 0; dir < 4; ++dir) {
    if (!m[19 + dir]) continue;
    for (int ty = 0; ty < T; ++ty) {
      const int a = 13 + dir * T + ty;
      if (m[23 + ty]) w[a >> 5] |= 1u << (a & 31);
    }
  }
  for (int r = 0; r < DD; ++r) {
    const int a = 13 + 4 * T + r;
    if (m[23 + T + r]) w[a >> 5] |= 1u << (a & 31);
  }
}

__global__ void minimax_step_kernel(Cfg cfg, MMDims d, StackP k, TripP t,
                                    StateP states, StateP cur, StateP st2,
                                    int maxp) {
  const int b = blockIdx.x, i = threadIdx.x;
  if (!t.live[b]) return;
  const int W = d.W, HW = d.H * d.W, L = HW + 2 * W, S = d.S;
  const size_t g = (size_t)b * (S + 1);
  const bool in = i < HW;
  extern __shared__ unsigned char smem[];
  __shared__ int s_hit, s_spent;
  const int top = k.sp[b];
  __syncthreads();  // every thread has read sp before thread 0 writes it

  if (t.finish[b]) {
    // pop (minimax.py:159-181)
    const int P = max(top - 1, 0);
    if (i == 0) {
      const float v = k.best[g + top];
      const bool at_root = top == 0;
      const bool is_max = k.mover[g + P] == maxp;
      const float bp = k.best[g + P];
      const bool better = (is_max ? v > bp : v < bp) && !at_root;
      const float an = fmaxf(k.alpha[g + P], v);
      const float bn = fminf(k.beta[g + P], v);
      k.best[g + (better ? P : S)] = v;
      k.alpha[g + ((is_max && !at_root) ? P : S)] = an;
      k.beta[g + ((is_max || at_root) ? S : P)] = bn;
      s_hit = better && P == 0;
      if (s_hit) k.root_set[b] = 1;
      if (at_root) k.done[b] = 1;
      k.sp[b] = P;
      k.it[b] += 1;
      copy_scalars(cur, b, states, g + P);
    }
    __syncthreads();
    if (in) {
      if (s_hit) k.root_arms[(size_t)b * HW + i] = k.down_arms[g * HW + i];
      copy_planes(cur, b, states, g + P, HW, i);
    }
    return;
  }
  if (!t.push[b]) {  // an exhausted draw still costs a trip
    if (i == 0) k.it[b] += 1;
    return;
  }

  // push (minimax.py:194-225): the child enters row C
  const int C = min(top + 1, S);
  const int m2 = t.mover2[b];
  uint8_t* claim = smem;
  if (i == 0) s_spent = 0;
  for (int s = i; s < L; s += blockDim.x) claim[s] = 0;
  __syncthreads();
  if (in) {
    const size_t c = (size_t)b * HW + i;
    copy_planes(states, g + C, st2, b, HW, i);
    copy_planes(cur, b, st2, b, HW, i);
    unsigned w[MAXNW] = {0u, 0u, 0u, 0u};
    pack_legal(t.mask2 + c * d.M, d.T, d.D * d.D, w);
    for (int q = 0; q < d.NW; ++q)
      k.la[((g + C) * HW + i) * d.NW + q] = (int32_t)w[q];
    k.choice[(g + C) * HW + i] = 0;
    k.down_arms[(g + top) * HW + i] = t.arms[c];
    if (top == 0 && !k.root_set[b]) k.root_arms[c] = t.arms[c];
    // in-flight claims of both players, the mover's in-flight spend
    if (st2.busy[c]) {
      const int at = st2.atype[c], dir = st2.aparam[c];
      if ((at == A_MOVE || at == A_PRODUCE) && dir >= 0 && dir < 4)
        claim[claim_slot(W, i, dir)] = 1;
      if (at == A_PRODUCE && st2.owner[c] == m2)
        atomicAdd(&s_spent, cfg.cost[clampi(st2.aptype[c], 0, d.T - 1)]);
    }
  }
  __syncthreads();
  for (int s = i; s < L; s += blockDim.x)
    k.claimed0[(g + C) * L + s] = claim[s];
  if (i == 0) {
    copy_scalars(states, g + C, st2, b);
    copy_scalars(cur, b, st2, b);
    k.more[g + C] = !t.leaf2[b];
    k.spent0[g + C] = s_spent;
    k.balance[g + C] = st2.resources[2 * (size_t)b + (m2 == 1 ? 1 : 0)];
    k.alpha[g + C] = k.alpha[g + top];
    k.beta[g + C] = k.beta[g + top];
    k.best[g + C] = t.best2[b];
    k.mover[g + C] = m2;
    k.nextsim[g + C] = t.nextsim2[b];
    k.sp[b] = C;
    k.npush[b] += 1;
    k.it[b] += 2;  // JAX's push adds 1 to the draw's count
  }
}

// The stack tables of ``batch`` lanes ([B, S+1, ...]; states [B*(S+1)]
// rows b*(S+1)+i), the trip's flags and child (st2 and the child fields
// may be null where no lane pushes), maxp the searching player.
extern "C" int minimax_step_launch(const Cfg* cfg, const MMDims* d, int batch,
                                   const StackP* k, const TripP* t,
                                   const StateP* states, const StateP* cur,
                                   const StateP* st2, int maxp,
                                   void* stream) {
  const int HW = d->H * d->W, L = HW + 2 * d->W;
  if (HW > 1024 || d->S < 1 || d->NW < 1 || d->NW > MAXNW)
    return (int)cudaErrorInvalidValue;
  StateP none{};
  const size_t smem = carve_bytes(L);
  cudaError_t e = allow_smem(minimax_step_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  minimax_step_kernel<<<batch, block_threads(HW), smem,
                        (cudaStream_t)stream>>>(
      *cfg, *d, *k, *t, *states, *cur, st2 ? *st2 : none, maxp);
  return (int)cudaGetLastError();
}
