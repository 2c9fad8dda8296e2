// event_jump: the closed-form jump to the next action completion.
//
// Replaces the JAX package's playout_step(jump_to_event=True)
// (microrts_tpu/ops/playout.py:58) and the event step of fast_forward
// (:109): decision_point (:53), min(busy aticks) - 1 dead ticks clipped to
// [0, max_skip] and to the t_end cap, time += k and aticks -= k on busy
// cells, and whether the one real cycle of the completion tick is taken.
// The cycle itself is the cycle kernel, launched next with this kernel's
// `take` as its `active` lanes.
//
// Bound at B=1024, 16x16: it reads utype, owner, busy (1 B/cell each) and
// aticks (2 B/cell) and writes aticks (2 B/cell): about 7 B/cell, 1.8 MB,
// 0.55 us at 3.35 TB/s.  Bound by bytes; at this size the launch itself
// (a few us) dominates.
//
// Design: one block per env.  Each thread reduces its cells (any idle
// owned unit, the least busy ETA, both players' unit counts) and the
// block combines them with warp reductions and one shared atomic per
// warp; thread 0 takes the per-env decision, and the block writes the
// jumped aticks plane.  The unit counts give gameover of the jumped
// state, which the jump does not change (playout.py:105).
#include "common.cuh"

__global__ void event_jump_kernel(int HW, const int8_t* utype,
                                  const int8_t* owner, const uint8_t* busy,
                                  const int16_t* aticks, const int32_t* time,
                                  const uint8_t* done, const int32_t* t_end,
                                  int max_skip, int gate, int16_t* o_aticks,
                                  int32_t* o_time, uint8_t* take,
                                  uint8_t* over) {
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  __shared__ int s_dp, s_min, s_n0, s_n1, s_k;
  if (threadIdx.x == 0) {
    s_dp = 0;
    s_min = INF_I;
    s_n0 = 0;
    s_n1 = 0;
  }
  __syncthreads();

  int dp = 0, mn = INF_I, n0 = 0, n1 = 0;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int u = utype[base + c], o = owner[base + c];
    const bool bz = busy[base + c];
    if (u > 0 && o >= 0 && !bz) dp = 1;
    if (bz) mn = min(mn, (int)aticks[base + c]);
    if (u > 0 && o == 0) ++n0;
    if (u > 0 && o == 1) ++n1;
  }
  const unsigned full = 0xffffffffu;
  dp = __reduce_or_sync(full, dp);
  mn = __reduce_min_sync(full, mn);
  n0 = __reduce_add_sync(full, n0);
  n1 = __reduce_add_sync(full, n1);
  if ((threadIdx.x & 31) == 0) {
    if (dp) atomicOr(&s_dp, 1);
    atomicMin(&s_min, mn);
    atomicAdd(&s_n0, n0);
    atomicAdd(&s_n1, n1);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int t = time[b];
    int k = clampi(s_min - 1, 0, max_skip);
    bool do_cycle = true;
    if (t_end) {
      const int te = t_end[b];
      k = min(k, max(te - t, 0));
      do_cycle = t + k < te;
    }
    bool live = true;
    if (gate) {
      live = !done[b] && !s_dp && (!t_end || t < t_end[b]);
      if (!live) k = 0;
    }
    take[b] = live && do_cycle;
    o_time[b] = t + k;
    if (over) over[b] = (s_n0 + s_n1 == 0) || ((s_n0 == 0) != (s_n1 == 0));
    s_k = k;
  }
  __syncthreads();

  const int k = s_k;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const int a = aticks[base + c];
    o_aticks[base + c] = (int16_t)(busy[base + c] ? a - k : a);
  }
}

// gate = 0: playout_step's jump (every lane jumps; take = do_cycle).
// gate = 1: fast_forward's event step (lanes that are done, at a decision
// point or at t_end do not move; take = live & do_cycle).  done is read
// only with gate = 1; t_end may be null (no cap); over may be null (not
// written: fast_forward's caller does not read it).
extern "C" int event_jump_launch(int batch, int hw, const int8_t* utype,
                                 const int8_t* owner, const uint8_t* busy,
                                 const int16_t* aticks, const int32_t* time,
                                 const uint8_t* done, const int32_t* t_end,
                                 int max_skip, int gate, int16_t* o_aticks,
                                 int32_t* o_time, uint8_t* take,
                                 uint8_t* over, void* stream) {
  if (gate && !done) return (int)cudaErrorInvalidValue;
  event_jump_kernel<<<batch, block_threads(hw), 0, (cudaStream_t)stream>>>(
      hw, utype, owner, busy, aticks, time, done, t_end, max_skip, gate,
      o_aticks, o_time, take, over);
  return (int)cudaGetLastError();
}
