// decode: PlayerAction.fromVectorAction + fillWithNones for one player.
//
// Replaces the JAX package's GridnetEnv.decode
// (microrts_tpu/env/gridnet.py:139) with _inflight_claims (:321) and
// _inflight_spent (:336): the kernel builds the in-flight claim ledger and
// the player's in-flight produce spend itself, so one launch serves one
// player.
//
// Bound at B=1024, 16x16: it reads the gridnet actions (28 B/cell) and
// utype, owner, busy, atype, aparam, aptype (7 B/cell), and writes six
// int32 candidate planes (24 B/cell): about 59 B/cell, 15.5 MB, 4.6 us at
// 3.35 TB/s.  Bound by bytes.
//
// Design: one block per env.  Claims live in Java's flat position space
// (slot = W + y*W + x + OFF[d], OFF = (-W, 1, W, -1)) in a shared
// [H*W + 2W] ledger, so a LEFT move at x = 0 claims the last cell of the
// row above, as in Java.  Move conflicts resolve with shared atomicMin of
// the row-major rank per slot.  Ranks are row-major, so the first
// max_produce_scan pos-ok produce candidates in rank order are the first
// ones in cell order: warp 0 finds them with ballots, and one lane runs
// the order-sensitive budget recurrence over them (zero-skip, same-slot
// block).  This replaces the packed-key min extraction of the TPU version.
// none_duration >= 0 gives every NONE candidate that duration: the bot
// path's NONE(10) of playout_step (microrts_tpu/ops/playout.py:81-86);
// the RL path passes -1 and keeps decode's own parameters.  Under partial
// observability the in-flight claims come from the player's fog-of-war
// view (`view`, gridnet.py:365-372); legality and the spend stay the
// state's.
#include "common.cuh"

#define MAXKP 64

__global__ void decode_kernel(Cfg cfg, StateP s, int player,
                              const int32_t* players, const int32_t* act,
                              int kp, int none_duration, CandP out,
                              int has_view, StateP view) {
  const int me = players != nullptr ? players[blockIdx.x] : player;
  const int H = cfg.H, W = cfg.W, T = cfg.T, R = cfg.R, D = 2 * cfg.R + 1;
  const int HW = H * W, L = HW + 2 * W;
  const int OFF[4] = {-W, 1, W, -1};
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint8_t* s_claim = carve<uint8_t>(p, L);
  int32_t* s_mrank = carve<int32_t>(p, L);
  int32_t* s_prank = carve<int32_t>(p, L);
  int16_t* s_slot = carve<int16_t>(p, HW);
  uint8_t* s_flag = carve<uint8_t>(p, HW);  // bits below
  __shared__ int s_spent0;
  enum { F_PRESENT = 1, F_OK = 2, F_MOVE = 4, F_PROD = 8, F_POSOK = 16,
         F_KEPT = 32 };

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s_claim[i] = 0;
    s_mrank[i] = INF_I;
    s_prank[i] = INF_I;
  }
  if (threadIdx.x == 0) s_spent0 = 0;
  __syncthreads();

  // in-flight claims (every player; of the view where given) and this
  // player's in-flight spend
  const StateP& cs = has_view ? view : s;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    if (cs.busy[base + c]) {
      const int at = cs.atype[base + c];
      const int d = cs.aparam[base + c];
      if ((at == A_MOVE || at == A_PRODUCE) && d >= 0 && d < 4)
        s_claim[W + c + OFF[d]] = 1;
    }
    if (s.busy[base + c] && s.atype[base + c] == A_PRODUCE
        && s.owner[base + c] == me)
      atomicAdd(&s_spent0, cfg.cost[clampi(s.aptype[base + c], 0, T - 1)]);
  }
  __syncthreads();

  // candidates; move claims take the min rank per slot
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const int32_t* a = act + (base + c) * 7;
    const int at = a[0];
    const bool present = s.utype[base + c] > 0 && s.owner[base + c] == me
                         && !s.busy[base + c];
    const bool ok = present && at >= 0 && at < 6;
    int aparam = (at == A_NONE) ? -1 : 0;
    if (at >= A_MOVE && at <= A_PRODUCE) aparam = a[at];
    const int slot = W + c + OFF[clampi(aparam, 0, 3)];
    bool claim = ok && (at == A_MOVE || at == A_PRODUCE);
    claim = claim && !s_claim[slot];
    const bool is_move = claim && at == A_MOVE;
    const bool is_prod = claim && at == A_PRODUCE;
    s_slot[c] = (int16_t)slot;
    s_flag[c] = (present ? F_PRESENT : 0) | (ok ? F_OK : 0)
                | (is_move ? F_MOVE : 0) | (is_prod ? F_PROD : 0);
    if (is_move) atomicMin(&s_mrank[slot], c);
    // attack target and produce type do not depend on what is kept
    const int rel = a[6];
    const int rq = (rel >= 0 ? rel / D : -((-rel + D - 1) / D));  // floor
    const int rr = rel - rq * D;
    out.atx[base + c] = at == A_ATTACK ? x + rr - R : 0;
    out.aty[base + c] = at == A_ATTACK ? y + rq - R : 0;
    out.aptype[base + c] = clampi(a[5], 0, T - 1);
  }
  __syncthreads();

  // a produce that loses its slot to a lower-rank move is skipped
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    if ((s_flag[c] & F_PROD) && c < s_mrank[s_slot[c]]) s_flag[c] |= F_POSOK;
  __syncthreads();

  // budget recurrence over the first kp pos-ok produces in rank order
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int cells[MAXKP];
    int n = 0;
    for (int c0 = 0; c0 < HW && n < kp; c0 += 32) {
      const int c = c0 + lane;
      const bool f = c < HW && (s_flag[c] & F_POSOK);
      unsigned bits = __ballot_sync(0xffffffffu, f);
      while (bits && n < kp) {
        cells[n++] = c0 + __ffs(bits) - 1;
        bits &= bits - 1;
      }
    }
    if (lane == 0) {
      const int balance = s.resources[2 * b + (me == 1 ? 1 : 0)];
      int spent = s_spent0;
      int kslot[MAXKP];
      int nk = 0;
      for (int i = 0; i < n; ++i) {
        const int c = cells[i];
        const int sl = s_slot[c];
        bool blocked = false;
        for (int j = 0; j < nk; ++j) blocked |= kslot[j] == sl;
        const int cost = cfg.cost[clampi(act[(base + c) * 7 + 5], 0, T - 1)];
        const bool res_ok = (spent == 0) || (spent + cost <= balance);
        if (!blocked && res_ok) {
          spent += cost;
          kslot[nk++] = sl;
          s_flag[c] |= F_KEPT;
        }
      }
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    if (s_flag[c] & F_KEPT) atomicMin(&s_prank[s_slot[c]], c);
  __syncthreads();

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int32_t* a = act + (base + c) * 7;
    const int at = a[0];
    int aparam = (at == A_NONE) ? -1 : 0;
    if (at >= A_MOVE && at <= A_PRODUCE) aparam = a[at];
    const int f = s_flag[c];
    const int sl = s_slot[c];
    const bool move_kept = (f & F_MOVE) && s_mrank[sl] == c && c < s_prank[sl];
    const bool keep = ((f & F_OK) && at != A_MOVE && at != A_PRODUCE)
                      || move_kept || (f & F_KEPT);
    const bool pad = (f & F_PRESENT) && !keep;
    const int atype = keep ? at : (pad ? A_NONE : -1);
    out.atype[base + c] = atype;
    out.aparam[base + c] = (none_duration >= 0 && atype == A_NONE)
                               ? none_duration
                               : (keep ? aparam : (pad ? 1 : 0));
    out.rank[base + c] = keep ? c : (pad ? HW + c : INF_I);
  }
}

// players: int32 [batch] (one player per env), or null for `player`;
// view: the claims' source state, or null for `s`
extern "C" int decode_launch(const Cfg* cfg, const StateP* s, int batch,
                             int player, const int32_t* players,
                             const int32_t* act,
                             int max_produce_scan, int none_duration,
                             const CandP* out, const StateP* view,
                             void* stream) {
  const int HW = cfg->H * cfg->W, L = HW + 2 * cfg->W;
  if (max_produce_scan > MAXKP || L > 32767) return (int)cudaErrorInvalidValue;
  size_t smem = carve_bytes(L) + 2 * carve_bytes(4 * (size_t)L)
                + carve_bytes(2 * (size_t)HW) + carve_bytes(HW) + 16;
  cudaError_t e = allow_smem(decode_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  decode_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, player, players, act, max_produce_scan, none_duration,
      *out, view != nullptr, view ? *view : *s);
  return (int)cudaGetLastError();
}
