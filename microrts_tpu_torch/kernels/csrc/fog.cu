// fog: the fog-of-war view and the partially observable observation.
//
// po_state replaces the JAX package's visibility
// (microrts_tpu/engine/fog.py:27) and po_state (:43); obs_po replaces
// observation_po (:67) and, for its optional one-hot, GridnetEnv's
// observation_onehot of the 8-plane observation
// (microrts_tpu/env/gridnet.py:446).
//
// Bounds at B=1024, 16x16 (UTT v2: max sight 5, 81 disc offsets):
// po_state reads utype and owner (2 B/cell) and the 13 other unit planes
// (28 B/cell) and writes them (30 B/cell) and the visibility (1 B/cell):
// about 61 B/cell, 16 MB, 4.8 us at 3.35 TB/s.  obs_po for both players
// reads utype, owner, hp, carried, busy, atype, terrain (9 B/cell) and
// writes 2 x 8 int32 planes (64 B/cell): about 73 B/cell, 19 MB, 5.7 us.
// Bound by bytes: a cell's <= 81 disc reads hit shared memory.
//
// Design: one block per env, one thread per target cell (block-stride
// loop above 1024 cells).  The squared sight of each observer unit is
// staged in shared memory (-1 where none), and a target cell is seen when
// some offset (ox, oy) of the disc of the UTT's largest sight has
// ox^2 + oy^2 <= the squared sight of the unit at (x - ox, y - oy).
// obs_po stages the view's visible enemy units the same way for the
// eighth plane.  Each launch serves one player per env (an int or one per
// env); obs_po serves two player slots at once.
#include "common.cuh"

__device__ __forceinline__ int max_sight(const Cfg& cfg) {
  int m = 0;
  for (int t = 0; t < cfg.T; ++t) m = max(m, cfg.sight_radius[t]);
  return m;
}

// Is cell (x, y) within the sight of a unit staged in s2 (squared sight,
// or -1 where no unit)?
__device__ __forceinline__ bool seen(const int* s2, int H, int W, int S,
                                     int x, int y) {
  for (int oy = -S; oy <= S; ++oy) {
    const int sy = y - oy;
    if (sy < 0 || sy >= H) continue;
    for (int ox = -S; ox <= S; ++ox) {
      const int d2 = ox * ox + oy * oy;
      const int sx = x - ox;
      if (d2 > S * S || sx < 0 || sx >= W) continue;
      if (d2 <= s2[sy * W + sx]) return true;
    }
  }
  return false;
}

__global__ void po_state_kernel(Cfg cfg, StateP s, int player,
                                const int32_t* players, int write_view,
                                StateP o, uint8_t* vis_out) {
  const int H = cfg.H, W = cfg.W, HW = H * W, S = max_sight(cfg);
  const int b = blockIdx.x;
  const int me = players != nullptr ? players[b] : player;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int* s2 = carve<int>(p, HW);
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int ut = s.utype[base + c];
    const int r = cfg.sight_radius[tidx(cfg, ut)];
    s2[c] = (ut > 0 && s.owner[base + c] == me) ? r * r : -1;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    const bool vis = seen(s2, H, W, S, c % W, c / W);
    vis_out[i] = vis;
    if (!write_view) continue;
    const int ow = s.owner[i];
    const bool keep = !(s.utype[i] > 0 && ow != me && !vis);
    o.utype[i] = keep ? s.utype[i] : (int8_t)0;
    o.owner[i] = keep ? (int8_t)ow : (int8_t)-1;
    o.hp[i] = keep ? s.hp[i] : (int16_t)0;
    o.carried[i] = keep ? s.carried[i] : (int16_t)0;
    o.uid[i] = keep ? s.uid[i] : 0;
    o.busy[i] = keep && s.busy[i];
    o.atype[i] = keep ? s.atype[i] : (int8_t)0;
    o.aparam[i] = keep ? s.aparam[i] : (int16_t)0;
    o.atx[i] = keep ? s.atx[i] : (int16_t)0;
    o.aty[i] = keep ? s.aty[i] : (int16_t)0;
    o.aptype[i] = keep ? s.aptype[i] : (int8_t)0;
    o.aticks[i] = keep ? s.aticks[i] : (int16_t)0;
    o.aorder[i] = keep ? s.aorder[i] : 0;
    o.atime[i] = keep ? s.atime[i] : -1;
  }
}

// One observer slot of obs_po: its player (an int, or one per env) and
// its outputs (int32 [B, 8, H, W] planes and float32 [B, H, W, 20+T]
// one-hot; either may be null).
struct PoSlot {
  int player;
  const int32_t* players;
  int32_t* obs;
  float* onehot;
};

__global__ void obs_po_kernel(Cfg cfg, StateP s, PoSlot s0, PoSlot s1) {
  const int H = cfg.H, W = cfg.W, T = cfg.T, HW = H * W, S = max_sight(cfg);
  const int C = 20 + T;  // 5 + 5 + 3 + (T + 1) + 6
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int* s_own2 = carve<int>(p, HW);   // observer units' squared sight
  int* s_en2 = carve<int>(p, HW);    // visible enemy units' squared sight
  uint8_t* s_cls = carve<uint8_t>(p, 5 * HW);  // one-hot class indices
  for (int slot = 0; slot < 2; ++slot) {
    const PoSlot& ps = slot == 0 ? s0 : s1;
    if (ps.obs == nullptr && ps.onehot == nullptr) continue;
    const int me = ps.players != nullptr ? ps.players[b] : ps.player;
    __syncthreads();   // the previous slot's reads of shared memory
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const int ut = s.utype[base + c];
      const int r = cfg.sight_radius[tidx(cfg, ut)];
      s_own2[c] = (ut > 0 && s.owner[base + c] == me) ? r * r : -1;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const size_t i = base + c;
      const bool vis = seen(s_own2, H, W, S, c % W, c / W);
      const int ut = s.utype[i], ow = s.owner[i];
      const bool ex = ut > 0 && !(ow != me && !vis);  // a unit of the view
      const int own = (ex && ow >= 0) ? (((ow + me) % 2) + 2) % 2 + 1 : 0;
      const int hp = ex ? s.hp[i] : 0, car = ex ? s.carried[i] : 0;
      const int typ = ex ? ut : 0;
      const int act = (ex && s.busy[i]) ? s.atype[i] : 0;
      s_en2[c] = (ex && ow >= 0 && ow != me)
                     ? cfg.sight_radius[tidx(cfg, ut)]
                           * cfg.sight_radius[tidx(cfg, ut)]
                     : -1;
      if (ps.obs != nullptr) {
        int32_t* q = ps.obs + (size_t)b * 8 * HW + c;
        q[0] = hp;
        q[HW] = car;
        q[2 * HW] = own;
        q[3 * HW] = typ;
        q[4 * HW] = act;
        q[5 * HW] = s.terrain[i];
        q[6 * HW] = vis;
      }
      s_cls[c] = (uint8_t)clampi(hp, 0, 4);
      s_cls[HW + c] = (uint8_t)clampi(car, 0, 4);
      s_cls[2 * HW + c] = (uint8_t)own;
      s_cls[3 * HW + c] = (uint8_t)clampi(typ, 0, 255);
      s_cls[4 * HW + c] = (uint8_t)clampi(act, 0, 255);
    }
    __syncthreads();
    if (ps.obs != nullptr)
      for (int c = threadIdx.x; c < HW; c += blockDim.x)
        ps.obs[(size_t)b * 8 * HW + 7 * HW + c] =
            seen(s_en2, H, W, S, c % W, c / W);
    if (ps.onehot != nullptr) {
      float* q = ps.onehot + (size_t)b * HW * C;
      for (int idx = threadIdx.x; idx < HW * C; idx += blockDim.x) {
        const int c = idx / C, ch = idx % C;
        int cls, v;  // channel class (offset into its group) and value
        if (ch < 5) { cls = ch; v = s_cls[c]; }
        else if (ch < 10) { cls = ch - 5; v = s_cls[HW + c]; }
        else if (ch < 13) { cls = ch - 10; v = s_cls[2 * HW + c]; }
        else if (ch < 14 + T) { cls = ch - 13; v = s_cls[3 * HW + c]; }
        else { cls = ch - 14 - T; v = s_cls[4 * HW + c]; }
        q[idx] = cls == v ? 1.0f : 0.0f;
      }
    }
  }
}

// players: int32 [batch] (one player per env), or null for `player`;
// out: the view's unit planes (null: visibility only); vis: bool [batch,
// H, W]
extern "C" int po_state_launch(const Cfg* cfg, const StateP* s, int batch,
                               int player, const int32_t* players,
                               const StateP* out, uint8_t* vis,
                               void* stream) {
  const int HW = cfg->H * cfg->W;
  size_t smem = carve_bytes(4 * (size_t)HW) + 16;
  cudaError_t e = allow_smem(po_state_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  StateP none = {};
  po_state_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, player, players, out != nullptr, out ? *out : none, vis);
  return (int)cudaGetLastError();
}

extern "C" int obs_po_launch(const Cfg* cfg, const StateP* s, int batch,
                             const PoSlot* s0, const PoSlot* s1,
                             void* stream) {
  const int HW = cfg->H * cfg->W;
  size_t smem = carve_bytes(4 * (size_t)HW) * 2 + carve_bytes(5 * (size_t)HW)
                + 16;
  cudaError_t e = allow_smem(obs_po_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  obs_po_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, *s0, *s1);
  return (int)cudaGetLastError();
}
