// cycle: one game tick (GameState.cycle + UnitAction.execute).
//
// Replaces the JAX package's make_engine.cycle
// (microrts_tpu/engine/kernel.py:508) and gameover (:726) on the new
// state, with UTT v3's random damage (:505, :536-545): an attacker of
// type t deals min_damage[t] + (int)(u01 * (max_damage[t] - min_damage[t]
// + 1)) where max > min, u01 its cell's uniform (float32 [B, H, W], null
// under deterministic damage); one round-to-nearest float32 product,
// truncated toward zero, as XLA computes it.
//
// Bound at B=1024, 16x16: it reads the 14 planes other than terrain
// (29 B/cell) and writes them anew (29 B/cell): about 58 B/cell plus the
// per-env scalars, 15.2 MB, 4.5 us at 3.35 TB/s; with u01, 4 B/cell
// more (62 B/cell, 16.3 MB, 4.9 us).  Bound by bytes.
//
// Design: one block per env, every plane it reads at a neighbour staged
// in shared memory, four phases separated by __syncthreads():
//  1. per target cell: the arrival order (at most one MOVE/PRODUCE lands
//     on a cell), the return orders q_d, and the damage it takes, GATHERED
//     from the (2R+1)^2 box (each (target, offset) pair has at most one
//     attacker, so this equals the TPU version's shift-accumulate), with
//     the strict order filters against dep_order, arr_order and q_d; per
//     resource node, which of its <= 4 harvesters take, in issue order;
//     per stockpile, whether it is alive at each returner's order;
//  2. per acting cell: returns and harvests read those bits back, and the
//     per-player deposits and produce payments are summed with shared
//     atomics (int32);
//  3. warp 0 scans the completing produces in row-major order for the
//     newborn IDs;
//  4. per cell: the next board, with mover and newborn arrivals gathered
//     from the 4 neighbours, and the unit counts for gameover.
// With `active` (bool [B], may be null), an env whose flag is off copies
// its input to the output and reads done = false (the playouts' frozen
// lanes, microrts_tpu/ops/playout.py:104 and :172).
#include "common.cuh"

// The damage of an attacker of type index t at cell i (u01 may be null).
__device__ __forceinline__ int damage_of(const Cfg& cfg, int t,
                                         const float* u01, size_t i) {
  const int lo = cfg.min_damage[t], hi = cfg.max_damage[t];
  if (u01 == nullptr || hi <= lo) return lo;
  return lo + (int)__fmul_rn(u01[i], (float)(hi - lo + 1));
}

__global__ void cycle_kernel(Cfg cfg, StateP s, StateP o, uint8_t* done,
                             const uint8_t* active, const float* u01) {
  const int H = cfg.H, W = cfg.W, T = cfg.T, R = cfg.R;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  if (active && !active[b]) {   // uniform over the block: no sync skipped
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const size_t i = base + c;
      o.utype[i] = s.utype[i];
      o.owner[i] = s.owner[i];
      o.hp[i] = s.hp[i];
      o.carried[i] = s.carried[i];
      o.uid[i] = s.uid[i];
      o.busy[i] = s.busy[i];
      o.atype[i] = s.atype[i];
      o.aparam[i] = s.aparam[i];
      o.atx[i] = s.atx[i];
      o.aty[i] = s.aty[i];
      o.aptype[i] = s.aptype[i];
      o.aticks[i] = s.aticks[i];
      o.aorder[i] = s.aorder[i];
      o.atime[i] = s.atime[i];
    }
    if (threadIdx.x == 0) {
      o.time[b] = s.time[b];
      o.resources[2 * b] = s.resources[2 * b];
      o.resources[2 * b + 1] = s.resources[2 * b + 1];
      o.next_id[b] = s.next_id[b];
      done[b] = 0;
    }
    return;
  }
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int32_t* s_aorder = carve<int32_t>(p, HW);
  int32_t* s_uid = carve<int32_t>(p, HW);
  int32_t* s_pre_dep = carve<int32_t>(p, HW);   // damage before departure
  int32_t* s_post_arr = carve<int32_t>(p, HW);  // damage after arrival
  int32_t* s_total = carve<int32_t>(p, HW);     // all damage
  int32_t* s_node_res = carve<int32_t>(p, HW);  // node resources left
  int32_t* s_nb = carve<int32_t>(p, HW);        // newborn rank
  int16_t* s_hp = carve<int16_t>(p, HW);
  int16_t* s_carried = carve<int16_t>(p, HW);
  int16_t* s_aparam = carve<int16_t>(p, HW);
  int16_t* s_atx = carve<int16_t>(p, HW);
  int16_t* s_aty = carve<int16_t>(p, HW);
  int8_t* s_utype = carve<int8_t>(p, HW);
  int8_t* s_owner = carve<int8_t>(p, HW);
  int8_t* s_aptype = carve<int8_t>(p, HW);
  int8_t* s_comp = carve<int8_t>(p, HW);   // completing action type or -1
  uint8_t* s_bits = carve<uint8_t>(p, HW); // take bits 0-3, alive bits 4-7
  uint8_t* s_flag = carve<uint8_t>(p, HW); // below
  enum { F_REMOVED = 1, F_RETVALID = 2, F_GOT = 4 };
  __shared__ int s_dep[2], s_spend[2], s_nborn, s_n[2];

  if (threadIdx.x < 2) {
    s_dep[threadIdx.x] = 0;
    s_spend[threadIdx.x] = 0;
    s_n[threadIdx.x] = 0;
  }
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    s_aorder[c] = s.aorder[i];
    s_uid[c] = s.uid[i];
    s_hp[c] = s.hp[i];
    s_carried[c] = s.carried[i];
    s_aparam[c] = s.aparam[i];
    s_atx[c] = s.atx[i];
    s_aty[c] = s.aty[i];
    s_utype[c] = s.utype[i];
    s_owner[c] = s.owner[i];
    s_aptype[c] = s.aptype[i];
    const bool comp = s.busy[i] && s.aticks[i] - 1 <= 0;
    s_comp[c] = comp ? s.atype[i] : -1;
  }
  __syncthreads();

  // ---- phase 1: per target cell
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const int dep_order = s_comp[c] == A_MOVE ? s_aorder[c] : INF_I;
    int arr_order = INF_I;
    int q[4];
    int hv_ord[4], hv_amt[4];
    for (int d = 0; d < 4; ++d) {
      q[d] = INF_I;
      hv_ord[d] = INF_I;
      hv_amt[d] = 0;
      const int sx = x - dir_dx(d), sy = y - dir_dy(d);
      if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
      const int src = sy * W + sx;
      if (s_aparam[src] != d) continue;
      const int code = s_comp[src];
      if (code == A_MOVE || code == A_PRODUCE)
        arr_order = min(arr_order, s_aorder[src]);
      if (code == A_RETURN) q[d] = s_aorder[src];
      const int st = tidx(cfg, s_utype[src]);
      if (code == A_HARVEST && cfg.can_harvest[st] && s_carried[src] == 0) {
        hv_ord[d] = s_aorder[src];
        hv_amt[d] = cfg.harvest_amount[st];
      }
    }
    int total = 0, pre_dep = 0, post_arr = 0;
    int pre_ret[4] = {0, 0, 0, 0};
    for (int oy = -R; oy <= R; ++oy)
      for (int ox = -R; ox <= R; ++ox) {
        if ((ox == 0 && oy == 0) || ox * ox + oy * oy > R * R) continue;
        const int sx = x - ox, sy = y - oy;
        if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
        const int src = sy * W + sx;
        if (s_comp[src] != A_ATTACK || s_atx[src] != x || s_aty[src] != y)
          continue;
        const int sd = damage_of(cfg, tidx(cfg, s_utype[src]), u01,
                                 base + src);
        const int so = s_aorder[src];
        total += sd;
        if (so < dep_order) pre_dep += sd;
        if (so > arr_order) post_arr += sd;
        for (int d = 0; d < 4; ++d)
          if (so < q[d]) pre_ret[d] += sd;
      }
    s_total[c] = total;
    s_pre_dep[c] = pre_dep;
    s_post_arr[c] = post_arr;

    const int ut = s_utype[c];
    const int t = tidx(cfg, ut);
    const bool is_res = ut > 0 && cfg.is_resource[t];
    const bool is_stock = ut > 0 && cfg.is_stockpile[t];
    const int carried = s_carried[c];
    unsigned bits = 0;
    int taken = 0;
    if (is_res)
      for (int d = 0; d < 4; ++d) {
        if (hv_ord[d] == INF_I) continue;
        int prev = 0;  // amounts of the earlier harvesters of this node
        for (int e = 0; e < 4; ++e)
          if (hv_ord[e] < hv_ord[d]) prev += hv_amt[e];
        if (carried - prev > 0) {
          bits |= 1u << d;
          taken += hv_amt[d];
        }
      }
    for (int d = 0; d < 4; ++d)
      if (is_stock && s_hp[c] > pre_ret[d] && dep_order > q[d])
        bits |= 1u << (4 + d);
    s_bits[c] = (uint8_t)bits;
    s_node_res[c] = carried - taken;
    s_flag[c] = (is_res && taken > 0 && carried - taken <= 0) ? F_REMOVED : 0;
  }
  __syncthreads();

  // ---- phase 2: per acting cell
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int x = c % W, y = c / W;
    const int code = s_comp[c];
    const int d = s_aparam[c];
    const int carried = s_carried[c];
    const int owner = s_owner[c];
    const int t = tidx(cfg, s_utype[c]);
    int n = -1;
    if (d >= 0 && d < 4) {
      const int nx = x + dir_dx(d), ny = y + dir_dy(d);
      if (nx >= 0 && nx < W && ny >= 0 && ny < H) n = ny * W + nx;
    }
    if (code == A_RETURN && carried > 0 && n >= 0
        && ((s_bits[n] >> (4 + d)) & 1)) {
      s_flag[c] |= F_RETVALID;
      if (owner == 0 || owner == 1) atomicAdd(&s_dep[owner], carried);
    }
    if (code == A_HARVEST && cfg.can_harvest[t] && carried == 0 && n >= 0
        && ((s_bits[n] >> d) & 1))
      s_flag[c] |= F_GOT;
    if (code == A_PRODUCE && (owner == 0 || owner == 1))
      atomicAdd(&s_spend[owner], cfg.cost[clampi(s_aptype[c], 0, T - 1)]);
    s_nb[c] = code == A_PRODUCE;
  }
  __syncthreads();

  // ---- phase 3: newborn ranks, an exclusive row-major prefix count
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int c0 = 0; c0 < HW; c0 += 32) {
      const int c = c0 + lane;
      const bool f = c < HW && s_nb[c];
      const unsigned bits = __ballot_sync(0xffffffffu, f);
      if (c < HW) s_nb[c] = carry + __popc(bits & ((1u << lane) - 1u));
      carry += __popc(bits);
    }
    if (lane == 0) s_nborn = carry;
  }
  __syncthreads();

  // ---- phase 4: the next board
  const int next_id = s.next_id[b];
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    const int x = c % W, y = c / W;
    const int ut = s_utype[c];
    const bool exists = ut > 0;
    const int t = tidx(cfg, ut);
    const int owner = s_owner[c];
    const int code = s_comp[c];
    const bool is_res = exists && cfg.is_resource[t];
    const int f = s_flag[c];
    const bool standing = exists && code != A_MOVE;
    const int hp_std = s_hp[c] - s_total[c];
    const bool dead = standing && !is_res && hp_std <= 0;  // owned or neutral
    const bool keep = standing && !dead && !(f & F_REMOVED);

    int utype_n = keep ? ut : 0;
    int owner_n = keep ? owner : -1;
    int hp_n = keep ? hp_std : 0;
    int uid_n = keep ? s_uid[c] : 0;
    int carried_keep = (f & F_GOT) ? cfg.harvest_amount[t]
                       : ((f & F_RETVALID) ? 0 : s_carried[c]);
    if (is_res) carried_keep = s_node_res[c];
    int carried_n = keep ? carried_keep : 0;

    const bool busy = s.busy[i];
    const bool busy_n = busy && code < 0 && keep;
    const int ticks = busy ? s.aticks[i] - 1 : s.aticks[i];
    o.busy[i] = busy_n;
    o.atype[i] = busy_n ? s.atype[i] : 0;
    o.aparam[i] = busy_n ? s_aparam[c] : 0;
    o.atx[i] = busy_n ? s_atx[c] : 0;
    o.aty[i] = busy_n ? s_aty[c] : 0;
    o.aptype[i] = busy_n ? s_aptype[c] : 0;
    o.aticks[i] = (int16_t)(busy_n ? ticks : 0);
    o.aorder[i] = busy_n ? s_aorder[c] : 0;
    o.atime[i] = busy_n ? s.atime[i] : -1;

    // arrivals: movers, then newborns (at most one lands per cell)
    for (int d = 0; d < 4; ++d) {
      const int sx = x - dir_dx(d), sy = y - dir_dy(d);
      if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
      const int src = sy * W + sx;
      if (s_comp[src] != A_MOVE || s_aparam[src] != d) continue;
      const int hp_mid = s_hp[src] - s_pre_dep[src];
      const int hp_arr = hp_mid - s_post_arr[c];
      if (hp_mid > 0 && hp_arr > 0) {
        utype_n = s_utype[src];
        owner_n = s_owner[src];
        hp_n = hp_arr;
        carried_n = s_carried[src];
        uid_n = s_uid[src];
      }
    }
    for (int d = 0; d < 4; ++d) {
      const int sx = x - dir_dx(d), sy = y - dir_dy(d);
      if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
      const int src = sy * W + sx;
      if (s_comp[src] != A_PRODUCE || s_aparam[src] != d) continue;
      const int hp_nb = cfg.hp[clampi(s_aptype[src], 0, T - 1)]
                        - s_post_arr[c];
      if (hp_nb > 0) {
        utype_n = s_aptype[src] + 1;
        owner_n = s_owner[src];
        hp_n = hp_nb;
        carried_n = 0;
        uid_n = next_id + s_nb[src];
      }
    }
    o.utype[i] = (int8_t)utype_n;
    o.owner[i] = (int8_t)owner_n;
    o.hp[i] = (int16_t)hp_n;
    o.carried[i] = (int16_t)carried_n;
    o.uid[i] = uid_n;
    const int8_t un = (int8_t)utype_n, on = (int8_t)owner_n;
    if (un > 0 && (on == 0 || on == 1)) atomicAdd(&s_n[on], 1);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    o.time[b] = s.time[b] + 1;
    o.resources[2 * b] = s.resources[2 * b] + s_dep[0] - s_spend[0];
    o.resources[2 * b + 1] = s.resources[2 * b + 1] + s_dep[1] - s_spend[1];
    o.next_id[b] = next_id + s_nborn;
    const int n0 = s_n[0], n1 = s_n[1];
    done[b] = (n0 + n1 == 0) || ((n0 == 0) != (n1 == 0));
  }
}

extern "C" int cycle_launch(const Cfg* cfg, const StateP* s, int batch,
                            const StateP* out, uint8_t* done,
                            const uint8_t* active, const float* u01,
                            void* stream) {
  const size_t HW = (size_t)cfg->H * cfg->W;
  size_t smem = 7 * carve_bytes(4 * HW) + 5 * carve_bytes(2 * HW)
                + 6 * carve_bytes(HW) + 16;
  cudaError_t e = allow_smem(cycle_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cycle_kernel<<<batch, block_threads((int)HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, *out, done, active, u01);
  return (int)cudaGetLastError();
}
