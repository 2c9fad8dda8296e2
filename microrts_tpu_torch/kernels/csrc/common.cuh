// Shared layout of the port's engine kernels.
//
// Every kernel runs one thread block per env and walks that env's H*W
// cells with a block-stride loop (one cell per thread when H*W <= 1024).
// Planes are row-major [B, H, W] in the storage types of
// microrts_tpu_torch/engine/types.py FIELD_DTYPES; arithmetic is int32 and
// results are stored narrow, as State.canon() stores them.  The host side
// (kernels/__init__.py) mirrors these structs with ctypes.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define MAXT 16
#define INF_I (1 << 30)

enum { A_NONE = 0, A_MOVE = 1, A_HARVEST = 2, A_RETURN = 3, A_PRODUCE = 4,
       A_ATTACK = 5 };

// Direction offsets (UnitAction.java:68-100): up, right, down, left.
__device__ __forceinline__ int dir_dx(int d) { return (d == 1) - (d == 3); }
__device__ __forceinline__ int dir_dy(int d) { return (d == 2) - (d == 0); }

// The unit type table, flattened (EngineConfig); passed by value.
struct Cfg {
  int H, W, T, R;
  int cost[MAXT], hp[MAXT], min_damage[MAXT], attack_range[MAXT];
  int produce_time[MAXT], move_time[MAXT], attack_time[MAXT];
  int harvest_time[MAXT], harvest_amount[MAXT];
  int is_resource[MAXT], is_stockpile[MAXT], can_harvest[MAXT];
  int can_move[MAXT], can_attack[MAXT];
  int produces[MAXT];  // bit j of produces[i]: type i can produce type j
  int sight_radius[MAXT];
  int move_conflict_policy;  // 1 CANCEL_BOTH, 2 RANDOM, 3 ALTERNATING
  int max_damage[MAXT];      // above min_damage only in UTT v3
};

// One batch of states.  Board/assignment planes are [B, H, W];
// resources is [B, 2]; the other scalars are [B].
struct StateP {
  int8_t* terrain; int8_t* utype; int8_t* owner; int16_t* hp;
  int16_t* carried; int32_t* uid; uint8_t* busy; int8_t* atype;
  int16_t* aparam; int16_t* atx; int16_t* aty; int8_t* aptype;
  int16_t* aticks; int32_t* aorder; int32_t* atime;
  int32_t* time; int32_t* resources; int32_t* next_id; int32_t* order_ctr;
  int32_t* cancel_ctr;
};

// Decoded candidates, int32 [B, H, W] planes.
struct CandP {
  int32_t* atype; int32_t* aparam; int32_t* atx; int32_t* aty;
  int32_t* aptype; int32_t* rank;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Type index of a utype value (utype - 1 clipped to [0, T-1]).
__device__ __forceinline__ int tidx(const Cfg& cfg, int utype) {
  return clampi(utype - 1, 0, cfg.T - 1);
}

// Legality (Unit.canExecuteAction; the JAX package's make_engine.validate,
// microrts_tpu/engine/kernel.py:216) and ETA (UnitAction.ETA; eta_of,
// :277) of the candidate of the unit at (x, y) of type index t, owner me,
// carrying `carried`, whose player holds `bal`.  The env's utype, owner
// and free (terrain and no unit) planes are staged in shared memory.  The
// direction neighbour of a param outside 1..3 is direction 0's, as the
// TPU version's unrolled select reads it.
__device__ __forceinline__ bool legal_eta(
    const Cfg& cfg, const int8_t* s_utype, const int8_t* s_owner,
    const uint8_t* s_free, int x, int y, int t, int me, int carried,
    int bal, int at, int param, int ptype, int atx, int aty, int* eta) {
  const int H = cfg.H, W = cfg.W, T = cfg.T, R = cfg.R;
  const int pt = clampi(ptype, 0, T - 1);
  const int sd = (param >= 1 && param <= 3) ? param : 0;
  const int nx = x + dir_dx(sd), ny = y + dir_dy(sd);
  bool free_n = false, res_n = false, stock_n = false;
  if (nx >= 0 && nx < W && ny >= 0 && ny < H) {
    const int n = ny * W + nx;
    const int nut = s_utype[n];
    const int nt = tidx(cfg, nut);
    free_n = s_free[n];
    res_n = nut > 0 && cfg.is_resource[nt];
    stock_n = nut > 0 && cfg.is_stockpile[nt] && s_owner[n] == me;
  }
  bool hit = false;  // an enemy unit at the attack target, in range
  {
    const int dx = atx - x, dy = aty - y;
    const int d2 = dx * dx + dy * dy;
    const int rng = cfg.attack_range[t];
    if (dx >= -R && dx <= R && dy >= -R && dy <= R && d2 > 0
        && d2 <= R * R && d2 <= rng * rng) {
      const int tx = x + dx, ty = y + dy;
      if (tx >= 0 && tx < W && ty >= 0 && ty < H) {
        const int n = ty * W + tx;
        const int no = s_owner[n];
        hit = s_utype[n] > 0 && no >= 0 && no != me;
      }
    }
  }
  bool legal = false;
  int e = 0;
  switch (at) {
    case A_NONE: legal = true; e = param; break;
    case A_MOVE: legal = cfg.can_move[t] && free_n; e = cfg.move_time[t]; break;
    case A_HARVEST:
      legal = cfg.can_harvest[t] && carried == 0 && res_n;
      e = cfg.harvest_time[t]; break;
    case A_RETURN:
      legal = cfg.can_harvest[t] && carried > 0 && stock_n;
      e = cfg.move_time[t]; break;
    case A_PRODUCE:
      legal = ((cfg.produces[t] >> pt) & 1) && cfg.cost[pt] <= bal && free_n;
      e = cfg.produce_time[pt]; break;
    case A_ATTACK:
      legal = cfg.can_attack[t] && hit; e = cfg.attack_time[t]; break;
    default: break;
  }
  *eta = e;
  return legal;
}

// The gridnet action [7] of arm ``arm`` of the search bots' arm catalog
// (ops/arms.py arms_to_action; all zero for -1, a cell that cannot act).
__device__ __forceinline__ void to_action(int arm, int T, int D,
                                          int32_t* o) {
  const int a = arm > 0 ? arm : 0;
  const int ab = 13 + 4 * T;
  const int at = a == 0 ? A_NONE : a < 5 ? A_MOVE : a < 9 ? A_HARVEST
                 : a < 13 ? A_RETURN : a < ab ? A_PRODUCE : A_ATTACK;
  const int pj = clampi(a - 13, 0, 4 * T - 1);
  const int comp[7] = {at, clampi(a - 1, 0, 3), clampi(a - 5, 0, 3),
                       clampi(a - 9, 0, 3), pj / T, pj % T,
                       clampi(a - ab, 0, D * D - 1)};
  for (int i = 0; i < 7; ++i) o[i] = arm > 0 ? comp[i] : 0;
}

// Legal-arm words a cell (arm a is bit a % 32 of word a / 32): the search
// bots' catalog (13 + 4T + D*D arms) at T <= 16 and D <= 5.
#define MAXNW 4

// The claim slot of a move or produce of cell ``cell`` in direction ``dir``
// (up, right, down, left) in the flat space of L = H*W + 2W slots
// (ops/enumerate.py claim_slots); left and right wrap across rows, as in
// Java's PlayerActionGenerator.
__device__ __forceinline__ int claim_slot(int W, int cell, int dir) {
  return W + cell + (dir == 0 ? -W : dir == 1 ? 1 : dir == 2 ? W : -1);
}

// Copy cell c of state row sr of s into row dr of d (the planes), and
// the row's scalars.
__device__ __forceinline__ void copy_planes(const StateP& d, size_t dr,
                                            const StateP& s, size_t sr,
                                            int HW, int c) {
  const size_t i = dr * HW + c, j = sr * HW + c;
  d.terrain[i] = s.terrain[j]; d.utype[i] = s.utype[j];
  d.owner[i] = s.owner[j]; d.hp[i] = s.hp[j]; d.carried[i] = s.carried[j];
  d.uid[i] = s.uid[j]; d.busy[i] = s.busy[j]; d.atype[i] = s.atype[j];
  d.aparam[i] = s.aparam[j]; d.atx[i] = s.atx[j]; d.aty[i] = s.aty[j];
  d.aptype[i] = s.aptype[j]; d.aticks[i] = s.aticks[j];
  d.aorder[i] = s.aorder[j]; d.atime[i] = s.atime[j];
}

__device__ __forceinline__ void copy_scalars(const StateP& d, size_t dr,
                                             const StateP& s, size_t sr) {
  d.time[dr] = s.time[sr];
  d.resources[2 * dr] = s.resources[2 * sr];
  d.resources[2 * dr + 1] = s.resources[2 * sr + 1];
  d.next_id[dr] = s.next_id[sr];
  d.order_ctr[dr] = s.order_ctr[sr];
  d.cancel_ctr[dr] = s.cancel_ctr[sr];
}

// Bump-allocate an aligned slice of dynamic shared memory.
template <typename T>
__device__ __forceinline__ T* carve(unsigned char*& p, int n) {
  uintptr_t a = (reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15);
  T* out = reinterpret_cast<T*>(a);
  p = reinterpret_cast<unsigned char*>(a + sizeof(T) * n);
  return out;
}

inline size_t carve_bytes(size_t bytes) { return (bytes + 15) & ~size_t(15); }

inline int block_threads(int hw) {
  int t = ((hw + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

// Set the dynamic shared memory ceiling of `kernel` when above 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
