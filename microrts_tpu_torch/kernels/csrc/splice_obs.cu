// splice_obs: the auto-reset splice and the observations of the step.
//
// Replaces the fresh-reset select of VecGridnetEnv.step
// (microrts_tpu/env/vec.py:92-97, every State field against the batch-1
// initial state, or MapPoolVecEnv.step's bank row of each env's own map,
// microrts_tpu/env/pool.py:101-105), GridnetEnv.observation
// (microrts_tpu/env/gridnet.py:424) and observation_onehot (:446).
//
// Bound at B=1024, 16x16, with the splice, both int32 observations and
// one player's one-hot: it reads the 15 planes (30 B/cell) and writes
// them (30 B/cell), writes 2 x 6 int32 observation planes (48 B/cell) and
// 27 float32 one-hot channels (108 B/cell): about 216 B/cell, 56.6 MB,
// 16.9 us at 3.35 TB/s.  Bound by bytes.
//
// Design: one block per env; the block reads its env's planes from the
// post-step state or, when the env resets, from the initial state, and
// writes the spliced state and the observation planes cell by cell.  The
// five one-hot class indices of each cell (clip(hp,0,4), clip(carried,0,4),
// owner, type, action) are staged in shared memory so that the
// [H, W, C] one-hot rows are written with consecutive threads on
// consecutive floats.  Every output is optional: the same kernel serves
// observation() and observation_onehot() without a splice.
#include "common.cuh"

__global__ void splice_obs_kernel(Cfg cfg, StateP s, const uint8_t* mask,
                                  StateP init, int init_batched,
                                  int write_state, StateP o,
                                  int32_t* obs0, int32_t* obs1, float* oh0,
                                  float* oh1) {
  const int H = cfg.H, W = cfg.W, T = cfg.T;
  const int HW = H * W;
  const int C = 20 + T;  // 5 + 5 + 3 + (T + 1) + 6
  const int b = blockIdx.x;
  const bool rs = mask != nullptr && mask[b];
  const StateP& src = rs ? init : s;
  const size_t k = (rs && !init_batched) ? 0 : b;  // source env
  const size_t sb = k * HW;                          // source cell base
  const size_t ob = (size_t)b * HW;           // output cell base
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint8_t* s_hp = carve<uint8_t>(p, HW);
  uint8_t* s_car = carve<uint8_t>(p, HW);
  int8_t* s_own = carve<int8_t>(p, HW);   // owner if a unit stands, else -1
  uint8_t* s_typ = carve<uint8_t>(p, HW);
  uint8_t* s_act = carve<uint8_t>(p, HW);

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = sb + c, j = ob + c;
    const int8_t ut = src.utype[i], ow = src.owner[i];
    const int16_t hp = src.hp[i], car = src.carried[i];
    const uint8_t busy = src.busy[i];
    const int8_t at = src.atype[i], ter = src.terrain[i];
    if (write_state) {
      o.terrain[j] = ter; o.utype[j] = ut; o.owner[j] = ow; o.hp[j] = hp;
      o.carried[j] = car; o.uid[j] = src.uid[i]; o.busy[j] = busy;
      o.atype[j] = at; o.aparam[j] = src.aparam[i]; o.atx[j] = src.atx[i];
      o.aty[j] = src.aty[i]; o.aptype[j] = src.aptype[i];
      o.aticks[j] = src.aticks[i]; o.aorder[j] = src.aorder[i];
      o.atime[j] = src.atime[i];
    }
    const bool ex = ut > 0;
    const int vhp = ex ? hp : 0, vcar = ex ? car : 0, vtyp = ex ? ut : 0;
    const int vact = (ex && busy) ? at : 0;
    const int own = (ex && ow >= 0) ? ow : -1;
    int32_t* obs[2] = {obs0, obs1};
    for (int pl = 0; pl < 2; ++pl) {
      if (obs[pl] == nullptr) continue;
      int32_t* q = obs[pl] + (size_t)b * 6 * HW + c;
      q[0] = vhp;
      q[HW] = vcar;
      q[2 * HW] = own >= 0 ? (own + pl) % 2 + 1 : 0;
      q[3 * HW] = vtyp;
      q[4 * HW] = vact;
      q[5 * HW] = ter;
    }
    s_hp[c] = (uint8_t)clampi(vhp, 0, 4);
    s_car[c] = (uint8_t)clampi(vcar, 0, 4);
    s_own[c] = (int8_t)own;
    s_typ[c] = (uint8_t)clampi(vtyp, 0, 255);
    s_act[c] = (uint8_t)clampi(vact, 0, 255);
  }
  if (write_state && threadIdx.x == 0) {
    o.time[b] = src.time[k];
    o.resources[2 * b] = src.resources[2 * k];
    o.resources[2 * b + 1] = src.resources[2 * k + 1];
    o.next_id[b] = src.next_id[k];
    o.order_ctr[b] = src.order_ctr[k];
    o.cancel_ctr[b] = src.cancel_ctr[k];
  }
  if (oh0 == nullptr && oh1 == nullptr) return;
  __syncthreads();
  float* oh[2] = {oh0, oh1};
  for (int pl = 0; pl < 2; ++pl) {
    if (oh[pl] == nullptr) continue;
    float* q = oh[pl] + (size_t)b * HW * C;
    for (int idx = threadIdx.x; idx < HW * C; idx += blockDim.x) {
      const int c = idx / C, ch = idx % C;
      int cls, v;  // channel class (offset into its group) and value
      if (ch < 5) { cls = ch; v = s_hp[c]; }
      else if (ch < 10) { cls = ch - 5; v = s_car[c]; }
      else if (ch < 13) {
        cls = ch - 10;
        v = s_own[c] >= 0 ? (s_own[c] + pl) % 2 + 1 : 0;
      }
      else if (ch < 14 + T) { cls = ch - 13; v = s_typ[c]; }
      else { cls = ch - 14 - T; v = s_act[c]; }
      q[idx] = cls == v ? 1.0f : 0.0f;
    }
  }
}

extern "C" int splice_obs_launch(const Cfg* cfg, const StateP* s, int batch,
                                 const uint8_t* mask, const StateP* init,
                                 int init_batched, const StateP* out,
                                 int32_t* obs0,
                                 int32_t* obs1, float* oh0, float* oh1,
                                 void* stream) {
  const int HW = cfg->H * cfg->W;
  size_t smem = carve_bytes(HW) * 5 + 16;
  cudaError_t e = allow_smem(splice_obs_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  StateP none = {};
  splice_obs_kernel<<<batch, block_threads(HW), smem,
                      (cudaStream_t)stream>>>(
      *cfg, *s, mask, init ? *init : none, init_batched, out != nullptr,
      out ? *out : none,
      obs0, obs1, oh0, oh1);
  return (int)cudaGetLastError();
}
