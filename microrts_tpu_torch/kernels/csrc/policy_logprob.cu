// policy_logprob: log-probability and entropy of given gridnet actions
// under the masked factored categorical, and their gradient.
//
// Replaces the JAX package's action_logprob
// (microrts_tpu/models/gridnet_policy.py:116) and the part of jax.grad
// through the PPO loss (microrts_tpu/train/ppo.py:190) that crosses it.
//
// Forward, per cell and per component k of the action space
// [6,4,4,4,4,T,D*D]: lg = logit where (mask | ~any(mask)) else -1e9;
// logp = (lg - max) - log(sum(exp(lg - max))); lp += logp[a_k];
// ent -= sum(where(p > 0, p * logp, 0)), p = exp(logp).  The arithmetic
// is policy_sample.cu's, so the sampler's logprob and this one agree on
// the same logits.
//
// Backward, with upstream g_lp and g_ent per cell (what JAX's autodiff
// gives): per component, g_logp_j = g_lp [j == a] - g_ent [p_j > 0]
// p_j (1 + logp_j); dlg_k = g_logp_k - p_k sum_j g_logp_j (log_softmax's
// VJP, the max taken as a constant); dlogit_k = dlg_k where (mask_k |
// ~any(mask)) else 0 (the where passes nothing to masked entries).  The
// softmax is recomputed from the logits, not saved: at a 32,768-sample
// minibatch a saved p would be another 2.6 GB.
//
// Bound: the forward reads the logits (4 B), the mask (1 B, the
// trajectory's bool layout) per logit and the action (28 B per cell), and
// writes 8 B per cell: 426 B per 16x16 cell with A=78; the backward reads
// the same plus 8 B of upstream gradient and writes 4 B per logit.  About
// 10 flops and 2 transcendentals per logit: both are bound by bytes.
//
// Design: a flat grid over all cells of the batch, 128 cells per block.
// The chunk's logits and mask are staged in shared memory with
// consecutive threads on consecutive words; then each thread walks one
// cell's 7 components from shared memory.  The backward writes the
// cell's gradient over its own logits in shared memory (each entry needs
// only its own logit and the component's max, log-sum-exp and gradient
// sum) and stores the chunk coalesced.  expf/logf (not the fast
// intrinsics) keep exp(-1e9 - max) exactly 0, as the plain version has
// it; __fadd_rn/__fmul_rn keep nvcc from contracting products and sums
// into FMAs.
#include "common.cuh"

#define NCOMP 7
#define CHUNK 128
#define NEG_INF_LOGIT -1e9f

struct Space {
  int sizes[NCOMP];
  int total;
};

// Stage ``n`` cells' logits and mask (from cell ``cell0``) in shared memory.
__device__ __forceinline__ void stage(int A, long long cell0, int n,
                                      const float* logits,
                                      const uint8_t* mask, float* s_lg,
                                      uint8_t* s_mk) {
  const float* lg = logits + cell0 * A;
  const uint8_t* mk = mask + cell0 * A;
  for (int i = threadIdx.x; i < n * A; i += blockDim.x) {
    s_lg[i] = lg[i];
    s_mk[i] = mk[i] != 0;
  }
}

// The component's has-any flag, max and log-sum-exp of the masked logits.
struct Comp {
  bool has;
  float mx, lse;
};

__device__ __forceinline__ Comp comp_stats(const float* x, const uint8_t* m,
                                           int s) {
  Comp c;
  c.has = false;
  for (int j = 0; j < s; ++j) c.has = c.has || m[j];
  c.mx = __int_as_float(0xff800000);  // -inf
  for (int j = 0; j < s; ++j) {
    const float v = (m[j] || !c.has) ? x[j] : NEG_INF_LOGIT;
    c.mx = fmaxf(c.mx, v);
  }
  float sum = 0.0f;
  for (int j = 0; j < s; ++j) {
    const float v = (m[j] || !c.has) ? x[j] : NEG_INF_LOGIT;
    sum = __fadd_rn(sum, expf(__fsub_rn(v, c.mx)));
  }
  c.lse = logf(sum);
  return c;
}

__device__ __forceinline__ float comp_logp(const Comp& c, float x, bool m) {
  const float v = (m || !c.has) ? x : NEG_INF_LOGIT;
  return __fsub_rn(__fsub_rn(v, c.mx), c.lse);
}

__global__ void __launch_bounds__(CHUNK)
logprob_fwd_kernel(Space sp, long long ncells, const float* logits,
                   const uint8_t* mask, const int32_t* action, float* lp,
                   float* ent) {
  const int A = sp.total;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  float* s_lg = carve<float>(p, CHUNK * A);
  uint8_t* s_mk = carve<uint8_t>(p, CHUNK * A);
  const long long cell0 = (long long)blockIdx.x * CHUNK;
  const int n = (int)min((long long)CHUNK, ncells - cell0);
  stage(A, cell0, n, logits, mask, s_lg, s_mk);
  __syncthreads();
  if (threadIdx.x >= n) return;
  const int t = threadIdx.x;
  const float* x = s_lg + t * A;
  const uint8_t* m = s_mk + t * A;
  const long long cell = cell0 + t;
  float lp_sum = 0.0f, ent_sum = 0.0f;
  int off = 0;
  for (int k = 0; k < NCOMP; ++k) {
    const int s = sp.sizes[k];
    const Comp c = comp_stats(x + off, m + off, s);
    const int a = action[cell * NCOMP + k];
    float e = 0.0f, lpa = 0.0f;
    for (int j = 0; j < s; ++j) {
      const float lpj = comp_logp(c, x[off + j], m[off + j]);
      if (j == a) lpa = lpj;
      const float pj = expf(lpj);
      if (pj > 0.0f) e = __fadd_rn(e, __fmul_rn(pj, lpj));
    }
    lp_sum = __fadd_rn(lp_sum, lpa);
    ent_sum = __fsub_rn(ent_sum, e);
    off += s;
  }
  lp[cell] = lp_sum;
  ent[cell] = ent_sum;
}

// d(logp_j) from the upstream gradients of lp and entropy.
__device__ __forceinline__ float g_logp(float lpj, bool taken, float g_lp,
                                        float g_ent) {
  const float pj = expf(lpj);
  float g = taken ? g_lp : 0.0f;
  if (pj > 0.0f)
    g = __fsub_rn(g, __fmul_rn(__fmul_rn(g_ent, pj), __fadd_rn(1.0f, lpj)));
  return g;
}

__global__ void __launch_bounds__(CHUNK)
logprob_bwd_kernel(Space sp, long long ncells, const float* logits,
                   const uint8_t* mask, const int32_t* action,
                   const float* g_lp, const float* g_ent, float* dlogits) {
  const int A = sp.total;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  float* s_lg = carve<float>(p, CHUNK * A);
  uint8_t* s_mk = carve<uint8_t>(p, CHUNK * A);
  const long long cell0 = (long long)blockIdx.x * CHUNK;
  const int n = (int)min((long long)CHUNK, ncells - cell0);
  stage(A, cell0, n, logits, mask, s_lg, s_mk);
  __syncthreads();
  if (threadIdx.x < n) {
    const int t = threadIdx.x;
    float* x = s_lg + t * A;
    const uint8_t* m = s_mk + t * A;
    const long long cell = cell0 + t;
    const float gl = g_lp[cell], ge = g_ent[cell];
    int off = 0;
    for (int k = 0; k < NCOMP; ++k) {
      const int s = sp.sizes[k];
      const Comp c = comp_stats(x + off, m + off, s);
      const int a = action[cell * NCOMP + k];
      float gsum = 0.0f;
      for (int j = 0; j < s; ++j)
        gsum = __fadd_rn(gsum, g_logp(comp_logp(c, x[off + j], m[off + j]),
                                      j == a, gl, ge));
      for (int j = 0; j < s; ++j) {
        const bool keep = m[off + j] || !c.has;
        const float lpj = comp_logp(c, x[off + j], m[off + j]);
        const float d = __fsub_rn(g_logp(lpj, j == a, gl, ge),
                                  __fmul_rn(expf(lpj), gsum));
        x[off + j] = keep ? d : 0.0f;
      }
      off += s;
    }
  }
  __syncthreads();
  float* out = dlogits + cell0 * A;
  for (int i = threadIdx.x; i < n * A; i += blockDim.x) out[i] = s_lg[i];
}

static size_t logprob_smem(int A) {
  return carve_bytes(sizeof(float) * CHUNK * A) + carve_bytes(CHUNK * A) + 16;
}

extern "C" int policy_logprob_fwd_launch(const Space* sp, long long ncells,
                                         const float* logits,
                                         const uint8_t* mask,
                                         const int32_t* action, float* lp,
                                         float* ent, void* stream) {
  const size_t smem = logprob_smem(sp->total);
  cudaError_t e = allow_smem(logprob_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (ncells + CHUNK - 1) / CHUNK;
  if (blocks == 0) return 0;
  logprob_fwd_kernel<<<(unsigned)blocks, CHUNK, smem, (cudaStream_t)stream>>>(
      *sp, ncells, logits, mask, action, lp, ent);
  return (int)cudaGetLastError();
}

extern "C" int policy_logprob_bwd_launch(const Space* sp, long long ncells,
                                         const float* logits,
                                         const uint8_t* mask,
                                         const int32_t* action,
                                         const float* g_lp, const float* g_ent,
                                         float* dlogits, void* stream) {
  const size_t smem = logprob_smem(sp->total);
  cudaError_t e = allow_smem(logprob_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (ncells + CHUNK - 1) / CHUNK;
  if (blocks == 0) return 0;
  logprob_bwd_kernel<<<(unsigned)blocks, CHUNK, smem, (cudaStream_t)stream>>>(
      *sp, ncells, logits, mask, action, g_lp, g_ent, dlogits);
  return (int)cudaGetLastError();
}
