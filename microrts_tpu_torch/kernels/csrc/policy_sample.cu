// policy_sample: masked factored categorical sampling of the gridnet policy.
//
// Replaces the JAX package's sample_action and greedy_action
// (microrts_tpu/models/gridnet_policy.py:79, :103), and the rollout's
// per-env sum of the logprob over the cells that can act
// (microrts_tpu/train/ppo.py:149-150).
//
// Per cell and per component k of the action space [6,4,4,4,4,T,D*D]:
// the masked logit is logit where (mask | ~any(mask)) else -1e9; then
// log-softmax (x - max - log(sum(exp(x - max)))), the action
// argmax(masked + gumbel) (the first maximum; without gumbel the greedy
// argmax), the logprob of the taken action and the entropy
// -sum(where(p > 0, p * logp, 0)), each summed over the 7 components.
// The mask is the env's int32 [.., 1 + A] layout; its channel 0 (can act)
// is skipped, and the 6 type bits after it give can_act for the per-env
// logprob.
//
// Bound at B=1024, 16x16, A=78: it reads the logits (81.8 MB), the mask
// (82.8 MB) and the gumbels (81.8 MB) and writes the actions (7.3 MB),
// logprob and entropy (2.1 MB): about 256 MB, 76 us at 3.35 TB/s.
// About 10 flops and 2 transcendentals per logit: bound by bytes.
//
// Design: one block per env, 128 threads, walking the env's cells in
// chunks of 128: the chunk's logits and gumbels (float32) and mask
// (reduced to one byte per channel) are staged in shared memory with
// consecutive threads on consecutive words, then each thread samples one
// cell from shared memory.  The per-env logprob is each thread's running
// sum, reduced in a fixed order (deterministic).  expf/logf (not the
// fast intrinsics) keep exp(-1e9 - max) exactly 0, as the plain version
// and XLA have it; __fadd_rn/__fmul_rn keep nvcc from contracting the
// entropy's products and sums into FMAs.
#include "common.cuh"

#define NCOMP 7
#define CHUNK 128
#define NEG_INF_LOGIT -1e9f

struct Space {
  int sizes[NCOMP];
  int total;
};

__global__ void __launch_bounds__(CHUNK)
sample_kernel(Space sp, int hw, const float* logits, const int32_t* mask,
              const float* gumbel, int32_t* action, float* logprob,
              float* entropy, float* env_lp) {
  const int A = sp.total;
  const int b = blockIdx.x;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  float* s_lg = carve<float>(p, CHUNK * A);
  float* s_g = carve<float>(p, gumbel ? CHUNK * A : 0);
  uint8_t* s_mk = carve<uint8_t>(p, CHUNK * A);
  __shared__ float s_red[CHUNK];
  float acc = 0.0f;

  for (int c0 = 0; c0 < hw; c0 += CHUNK) {
    const int n = min(CHUNK, hw - c0);
    const size_t cell0 = (size_t)b * hw + c0;
    const float* lg = logits + cell0 * A;
    for (int i = threadIdx.x; i < n * A; i += blockDim.x) s_lg[i] = lg[i];
    if (gumbel) {
      const float* g = gumbel + cell0 * A;
      for (int i = threadIdx.x; i < n * A; i += blockDim.x) s_g[i] = g[i];
    }
    const int32_t* mk = mask + cell0 * (A + 1);
    for (int i = threadIdx.x; i < n * (A + 1); i += blockDim.x) {
      const int cell = i / (A + 1), ch = i % (A + 1);
      if (ch > 0) s_mk[cell * A + ch - 1] = mk[i] != 0;
    }
    __syncthreads();

    if (threadIdx.x < n) {
      const int t = threadIdx.x;
      const float* x = s_lg + t * A;
      const float* g = gumbel ? s_g + t * A : nullptr;
      const uint8_t* m = s_mk + t * A;
      const size_t cell = cell0 + t;
      float lp_sum = 0.0f, ent_sum = 0.0f;
      bool can_act = false;
      for (int j = 0; j < 6; ++j) can_act = can_act || m[j];
      int off = 0;
      for (int k = 0; k < NCOMP; ++k) {
        const int s = sp.sizes[k];
        bool has = false;
        for (int j = 0; j < s; ++j) has = has || m[off + j];
        float mx = __int_as_float(0xff800000);  // -inf
        for (int j = 0; j < s; ++j) {
          const float v = (m[off + j] || !has) ? x[off + j] : NEG_INF_LOGIT;
          mx = fmaxf(mx, v);
        }
        float sum = 0.0f;
        for (int j = 0; j < s; ++j) {
          const float v = (m[off + j] || !has) ? x[off + j] : NEG_INF_LOGIT;
          sum = __fadd_rn(sum, expf(__fsub_rn(v, mx)));
        }
        const float lse = logf(sum);
        int a = 0;
        float best = 0.0f, ent = 0.0f, lpa = 0.0f;
        for (int j = 0; j < s; ++j) {
          const float v = (m[off + j] || !has) ? x[off + j] : NEG_INF_LOGIT;
          const float key = g ? __fadd_rn(v, g[off + j]) : v;
          const float lpj = __fsub_rn(__fsub_rn(v, mx), lse);
          if (j == 0 || key > best) { best = key; a = j; lpa = lpj; }
          const float pj = expf(lpj);
          if (pj > 0.0f) ent = __fadd_rn(ent, __fmul_rn(pj, lpj));
        }
        lp_sum = __fadd_rn(lp_sum, lpa);
        ent_sum = __fsub_rn(ent_sum, ent);
        action[cell * NCOMP + k] = a;
        off += s;
      }
      if (logprob) logprob[cell] = lp_sum;
      if (entropy) entropy[cell] = ent_sum;
      if (can_act) acc = __fadd_rn(acc, lp_sum);
    }
    __syncthreads();
  }
  if (env_lp == nullptr) return;
  s_red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = CHUNK / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      s_red[threadIdx.x] = __fadd_rn(s_red[threadIdx.x],
                                     s_red[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) env_lp[b] = s_red[0];
}

extern "C" int policy_sample_launch(const Space* sp, int batch, int hw,
                                    const float* logits,
                                    const int32_t* mask, const float* gumbel,
                                    int32_t* action, float* logprob,
                                    float* entropy, float* env_lp,
                                    void* stream) {
  const int A = sp->total;
  size_t smem = carve_bytes(sizeof(float) * CHUNK * A)
                * (gumbel ? 2 : 1) + carve_bytes(CHUNK * A) + 16;
  cudaError_t e = allow_smem(sample_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sample_kernel<<<batch, CHUNK, smem, (cudaStream_t)stream>>>(
      *sp, hw, logits, mask, gumbel, action, logprob, entropy, env_lp);
  return (int)cudaGetLastError();
}
