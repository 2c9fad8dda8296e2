// issue_env: issueSafe for decode-vetted candidates.
//
// Replaces the JAX package's make_engine.validate
// (microrts_tpu/engine/kernel.py:216), eta_of (:277) and issue_env (:456).
//
// Bound at B=1024, 16x16: it reads utype, owner, terrain, carried, busy
// (6 B/cell), the candidates (24 B/cell) and the old assignment planes
// where nothing is put (18 B/cell), and writes busy and the eight
// assignment planes (19 B/cell): about 67 B/cell, 17.6 MB, 5.2 us at
// 3.35 TB/s.  (The board planes are shared with the input state, not
// copied.)  Bound by bytes.
//
// Design: one block per env; utype, owner and free are staged in shared
// memory for the neighbour and attack-box reads.  Each thread checks its
// cell's one candidate (common.cuh legal_eta: the direction neighbour and
// the attack target inside the (2R+1)^2 box).  Illegal actions become
// NONE(ETA of the attempt).  Thread 0 advances order_ctr by 2*H*W.
#include "common.cuh"

__global__ void issue_env_kernel(Cfg cfg, StateP s, CandP cand, StateP o) {
  const int H = cfg.H, W = cfg.W;
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int8_t* s_utype = carve<int8_t>(p, HW);
  int8_t* s_owner = carve<int8_t>(p, HW);
  uint8_t* s_free = carve<uint8_t>(p, HW);

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    int8_t ut = s.utype[base + c];
    s_utype[c] = ut;
    s_owner[c] = s.owner[base + c];
    s_free[c] = (s.terrain[base + c] == 0) && (ut == 0);
  }
  __syncthreads();
  const int res0 = s.resources[2 * b], res1 = s.resources[2 * b + 1];
  const int order_ctr = s.order_ctr[b];
  const int now = s.time[b];

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = base + c;
    const int x = c % W, y = c / W;
    const int ut = s_utype[c];
    const bool exists = ut > 0;
    const int t = tidx(cfg, ut);
    const int me = s_owner[c];
    const bool busy = s.busy[i];
    const int at = cand.atype[i], param = cand.aparam[i];
    const int ptype = cand.aptype[i];
    const int atx = cand.atx[i], aty = cand.aty[i];
    const bool ignore = !exists || busy || at < 0 || me < 0;

    if (ignore) {
      o.busy[i] = busy;
      o.atype[i] = s.atype[i];
      o.aparam[i] = s.aparam[i];
      o.atx[i] = s.atx[i];
      o.aty[i] = s.aty[i];
      o.aptype[i] = s.aptype[i];
      o.aticks[i] = s.aticks[i];
      o.aorder[i] = s.aorder[i];
      o.atime[i] = s.atime[i];
      continue;
    }
    const int bal = me == 1 ? res1 : res0;
    int eta;
    const bool legal = legal_eta(cfg, s_utype, s_owner, s_free, x, y, t, me,
                                 s.carried[i], bal, at, param, ptype, atx,
                                 aty, &eta);
    o.busy[i] = 1;
    o.atype[i] = (int8_t)(legal ? at : A_NONE);
    o.aparam[i] = (int16_t)(legal ? param : eta);
    o.atx[i] = (int16_t)atx;
    o.aty[i] = (int16_t)aty;
    o.aptype[i] = (int8_t)ptype;
    o.aticks[i] = (int16_t)eta;
    o.aorder[i] = order_ctr + cand.rank[i];
    o.atime[i] = now;
  }
  if (threadIdx.x == 0) o.order_ctr[b] = order_ctr + 2 * HW;
}

extern "C" int issue_env_launch(const Cfg* cfg, const StateP* s, int batch,
                                const CandP* cand, const StateP* out,
                                void* stream) {
  const int HW = cfg->H * cfg->W;
  size_t smem = carve_bytes(HW) * 3 + 16;
  cudaError_t e = allow_smem(issue_env_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  issue_env_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *s, *cand, *out);
  return (int)cudaGetLastError();
}
