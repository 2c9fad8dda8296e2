// issue: issueSafe with the cross-cycle cancels and the same-tick
// move-conflict chains.
//
// Replaces the JAX package's make_engine.issue
// (microrts_tpu/engine/kernel.py:291-454), with sort4 (:125), select_dir
// (:105), stack_b (:112) and sum2 (:119) inside.
//
// Bound at B=1024, 16x16: it reads utype, owner, terrain, carried, busy,
// atype, aparam, aptype, aticks, aorder, atime (19 B/cell), the
// candidates (24 B/cell) and the CANCEL_RANDOM coins where given (4
// B/cell), and writes busy and the eight assignment planes (19 B/cell):
// about 62 B/cell (66 with coins), 16 MB, 4.9 us at 3.35 TB/s.  Bound by
// bytes.
//
// Design: one block per env, phases between block barriers.
// (0) stage utype, owner and free in shared memory; clear the claim slots.
// (1) per source cell: legality and ETA (common.cuh legal_eta; an illegal
//     action becomes NONE(ETA of the attempt)); each MOVE/PRODUCE in
//     flight since an earlier tick marks its target reserved, and each
//     player's largest prior-tick produce cost is a shared atomicMax.
// (2) per source cell: the cross-cycle cancels (a claim of a reserved
//     target, or a produce whose cost plus that largest cost exceeds the
//     stockpile, becomes NONE(-1)); then a claimant (a surviving new
//     claim, or a claim issued earlier this tick that is still in flight)
//     writes its issue-order key and ETA into slot d (its direction) of
//     its target cell: each target has <= 4 claimants, one a neighbour.
// (3) per target cell with two or more claimants: the slots sorted by key
//     with the TPU version's 5-comparator network (a swap on a strict >),
//     and the chain over them with its live claimant (CANCEL_BOTH,
//     CANCEL_RANDOM with the coin of the sorted slot, CANCEL_ALTERNATING
//     with the cancelation counter's parity), each cancelled slot's
//     verdict and min duration stored in place; conflicts summed with a
//     shared atomicAdd for the counter.
// (4) per source cell: a new claim reads its slot's verdict (NONE(min)),
//     a beaten same-tick claim is rewritten in place, and every cell
//     writes its assignment planes.  Thread 0 advances order_ctr by 2*H*W
//     and, under CANCEL_ALTERNATING, cancel_ctr by the conflicts.
#include "common.cuh"

enum { F_PUT = 1, F_CLAIM = 2, F_STX = 4 };

__global__ void issue_kernel(Cfg cfg, StateP s, CandP cand,
                             const uint8_t* coins, StateP o) {
  const int H = cfg.H, W = cfg.W, T = cfg.T, HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  const int policy = cfg.move_conflict_policy;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int8_t* s_utype = carve<int8_t>(p, HW);
  int8_t* s_owner = carve<int8_t>(p, HW);
  uint8_t* s_free = carve<uint8_t>(p, HW);
  uint8_t* s_resv = carve<uint8_t>(p, HW);
  uint8_t* s_flag = carve<uint8_t>(p, HW);
  int8_t* s_at = carve<int8_t>(p, HW);      // a_type after legality
  int32_t* s_ap = carve<int32_t>(p, HW);    // a_param after legality
  int32_t* s_eta = carve<int32_t>(p, HW);   // ETA after legality
  int32_t* s_key = carve<int32_t>(p, 4 * HW);  // claim slots [cell][d]
  int32_t* s_dur = carve<int32_t>(p, 4 * HW);  // their ETA, then duration
  uint8_t* s_cut = carve<uint8_t>(p, 4 * HW);  // slot cancelled
  __shared__ int s_maxif[2];
  __shared__ int s_nconf;

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int8_t ut = s.utype[base + c];
    s_utype[c] = ut;
    s_owner[c] = s.owner[base + c];
    s_free[c] = (s.terrain[base + c] == 0) && (ut == 0);
    s_resv[c] = 0;
    for (int d = 0; d < 4; ++d) {
      s_key[4 * c + d] = INF_I;
      s_dur[4 * c + d] = 0;
      s_cut[4 * c + d] = 0;
    }
  }
  if (threadIdx.x == 0) {
    s_maxif[0] = s_maxif[1] = 0;
    s_nconf = 0;
  }
  __syncthreads();
  const int res0 = s.resources[2 * b], res1 = s.resources[2 * b + 1];
  const int order_ctr = s.order_ctr[b];
  const int now = s.time[b];

  // (1) legality; prior-tick reservations and produce costs
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    const int x = c % W, y = c / W;
    const int ut = s_utype[c];
    const int t = tidx(cfg, ut);
    const int me = s_owner[c];
    const bool busy = s.busy[i];
    const int sat = s.atype[i], sap = s.aparam[i];
    if (busy && s.atime[i] < now) {
      if ((sat == A_MOVE || sat == A_PRODUCE) && sap >= 0 && sap < 4) {
        const int nx = x + dir_dx(sap), ny = y + dir_dy(sap);
        if (nx >= 0 && nx < W && ny >= 0 && ny < H) s_resv[ny * W + nx] = 1;
      }
      if (sat == A_PRODUCE && (me == 0 || me == 1))
        atomicMax(&s_maxif[me], cfg.cost[clampi(s.aptype[i], 0, T - 1)]);
    }
    const int at = cand.atype[i];
    const bool ignore = ut <= 0 || busy || at < 0 || me < 0;
    int eta = 0;
    const bool legal = !ignore && legal_eta(
        cfg, s_utype, s_owner, s_free, x, y, t, me, s.carried[i],
        me == 1 ? res1 : res0, at, cand.aparam[i], cand.aptype[i],
        cand.atx[i], cand.aty[i], &eta);
    s_at[c] = (int8_t)(legal ? at : A_NONE);
    s_ap[c] = legal ? cand.aparam[i] : eta;
    s_eta[c] = eta;
    s_flag[c] = ignore ? 0 : F_PUT;
  }
  __syncthreads();

  // (2) cross-cycle cancels; claimants into their target's slot
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    const int x = c % W, y = c / W;
    const int me = s_owner[c];
    int flag = s_flag[c];
    int d = -1, key = 0, eta = 0;
    if (flag & F_PUT) {
      const int at = s_at[c];
      const int param = cand.aparam[i];
      bool claim = at == A_MOVE || at == A_PRODUCE;
      const int sd = (param >= 1 && param <= 3) ? param : 0;
      const int nx = x + dir_dx(sd), ny = y + dir_dy(sd);
      const bool tgt_resv = nx >= 0 && nx < W && ny >= 0 && ny < H
                            && s_resv[ny * W + nx];
      const int bal = me == 1 ? res1 : res0;
      const int max_if = me == 1 ? s_maxif[1] : s_maxif[0];
      const int cost = cfg.cost[clampi(cand.aptype[i], 0, T - 1)];
      const bool xc = (claim && tgt_resv)
                      || (at == A_PRODUCE && cost + max_if > bal);
      if (xc) {
        s_at[c] = A_NONE;
        s_ap[c] = -1;
        s_eta[c] = -1;
        claim = false;
      }
      if (claim) {
        flag |= F_CLAIM;
        if (param >= 0 && param < 4) {
          d = param;
          key = order_ctr + cand.rank[i];
          eta = s_eta[c];
        }
      }
    } else if (s.busy[i] && s.atime[i] >= now
               && (s.atype[i] == A_MOVE || s.atype[i] == A_PRODUCE)) {
      flag |= F_STX;
      const int sap = s.aparam[i];
      if (sap >= 0 && sap < 4) {
        d = sap;
        key = s.aorder[i];
        eta = s.aticks[i];
      }
    }
    s_flag[c] = (uint8_t)flag;
    if (d >= 0) {
      const int nx = x + dir_dx(d), ny = y + dir_dy(d);
      if (nx >= 0 && nx < W && ny >= 0 && ny < H) {
        const int tgt = ny * W + nx;
        s_key[4 * tgt + d] = key;
        s_dur[4 * tgt + d] = eta;
      }
    }
  }
  __syncthreads();

  // (3) the chain of each target cell
  const int cancel_ctr = s.cancel_ctr[b];
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    int rk[4], et[4], ds[4];
    int n = 0;
    for (int d = 0; d < 4; ++d) {
      rk[d] = s_key[4 * c + d];
      et[d] = s_key[4 * c + d] < INF_I ? s_dur[4 * c + d] : 0;
      ds[d] = d;
      n += rk[d] < INF_I;
    }
    if (n < 2) continue;   // one claimant meets no conflict
    const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
    for (int q = 0; q < 5; ++q) {
      const int a = net[q][0], z = net[q][1];
      if (rk[a] > rk[z]) {
        int u = rk[a]; rk[a] = rk[z]; rk[z] = u;
        u = et[a]; et[a] = et[z]; et[z] = u;
        u = ds[a]; ds[a] = ds[z]; ds[z] = u;
      }
    }
    int live = -1, nconf = 0;
    bool cut[4] = {false, false, false, false};
    int dur4[4] = {0, 0, 0, 0};
    for (int k = 0; k < 4; ++k) {
      const bool valid = rk[k] < INF_I;
      const bool conflict = valid && live >= 0;
      const int dur = min(live >= 0 ? et[live] : 0, et[k]);
      bool c_new = conflict, c_old = conflict;
      if (policy == 2) {
        const bool coin = coins[(base + c) * 4 + k] != 0;
        c_new = conflict && coin;
        c_old = conflict && !coin;
      } else if (policy == 3) {
        const int parity = (((cancel_ctr + nconf) % 2) + 2) % 2;
        c_new = conflict && parity == 0;
        c_old = conflict && parity == 1;
      }
      if (c_old) { cut[live] = true; dur4[live] = dur; }
      if (c_new) { cut[k] = true; dur4[k] = dur; }
      live = (valid && !conflict) ? k
             : (c_old && !c_new) ? k
             : (c_new && !c_old) ? live
             : conflict ? -1 : live;
      nconf += conflict;
    }
    for (int k = 0; k < 4; ++k)
      if (cut[k]) {
        s_cut[4 * c + ds[k]] = 1;
        s_dur[4 * c + ds[k]] = dur4[k];
      }
    if (policy == 3 && nconf) atomicAdd(&s_nconf, nconf);
  }
  __syncthreads();

  // (4) verdicts back to the claimants; the assignment planes
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    const int x = c % W, y = c / W;
    const int flag = s_flag[c];
    // the verdict of this cell's claim in direction `param` (a param
    // outside 1..3 reads direction 0, as select_dir does): {cut, dur}
    auto verdict = [&](int param, int* dur) {
      const int sd = (param >= 1 && param <= 3) ? param : 0;
      const int nx = x + dir_dx(sd), ny = y + dir_dy(sd);
      if (nx < 0 || nx >= W || ny < 0 || ny >= H) return false;
      const int k = 4 * (ny * W + nx) + sd;
      *dur = s_dur[k];
      return s_cut[k] != 0;
    };
    if (flag & F_PUT) {
      int at = s_at[c], ap = s_ap[c], eta = s_eta[c], dur;
      if ((flag & F_CLAIM) && verdict(cand.aparam[i], &dur)) {
        at = A_NONE;
        ap = eta = dur;
      }
      o.busy[i] = 1;
      o.atype[i] = (int8_t)at;
      o.aparam[i] = (int16_t)ap;
      o.atx[i] = (int16_t)cand.atx[i];
      o.aty[i] = (int16_t)cand.aty[i];
      o.aptype[i] = (int8_t)cand.aptype[i];
      o.aticks[i] = (int16_t)eta;
      o.aorder[i] = order_ctr + cand.rank[i];
      o.atime[i] = now;
    } else {
      int dur;
      const bool old = (flag & F_STX) && verdict(s.aparam[i], &dur);
      o.busy[i] = s.busy[i];
      o.atype[i] = old ? (int8_t)A_NONE : s.atype[i];
      o.aparam[i] = old ? (int16_t)dur : s.aparam[i];
      o.atx[i] = s.atx[i];
      o.aty[i] = s.aty[i];
      o.aptype[i] = s.aptype[i];
      o.aticks[i] = old ? (int16_t)dur : s.aticks[i];
      o.aorder[i] = s.aorder[i];
      o.atime[i] = s.atime[i];
    }
  }
  if (threadIdx.x == 0) {
    o.order_ctr[b] = order_ctr + 2 * HW;
    o.cancel_ctr[b] = cancel_ctr + (policy == 3 ? s_nconf : 0);
  }
}

// coins: bool [batch, H, W, 4] (CANCEL_RANDOM), or null for the others
extern "C" int issue_launch(const Cfg* cfg, const StateP* s, int batch,
                            const CandP* cand, const uint8_t* coins,
                            const StateP* out, void* stream) {
  const int HW = cfg->H * cfg->W;
  if (cfg->move_conflict_policy == 2 && coins == nullptr)
    return (int)cudaErrorInvalidValue;
  size_t smem = carve_bytes(HW) * 6 + carve_bytes(4 * (size_t)HW) * 2
                + carve_bytes(16 * (size_t)HW) * 2 + carve_bytes(4 * (size_t)HW)
                + 16;
  cudaError_t e = allow_smem(issue_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  issue_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, *cand, coins, *out);
  return (int)cudaGetLastError();
}
