// evaluate: the material evaluation functions (ai/evaluation/*).
//
// Replaces the JAX package's ops/evaluation.py (microrts_tpu/ops/
// evaluation.py:25-167): simple_eval (:46), simple_sqrt_eval (:62),
// simple_sqrt_eval2 (:69), simple_sqrt_eval3 (:77), simple_opt_eval (:93),
// simple_opt_upper_bound (:109) and lanchester_eval (:136), selected by
// `fn`.  Each writes one float32 per env from its `player`'s view.
//
// Bound at B=1024, 16x16: it reads utype and owner (1 B/cell each), hp
// and carried (2 B/cell each) and the resources: about 6 B/cell, 1.6 MB,
// 0.47 us at 3.35 TB/s.  Bound by bytes; at this size the launch itself
// dominates.
//
// Design: one block per env, one thread per cell.  Each thread forms the
// per-cell terms of both players (at most 16 floats), the block sums each
// term with warp shuffles and then over the warps in a fixed order, and
// thread 0 combines the sums as the JAX formulas do, with round-to-nearest
// intrinsics so that no multiply-add is contracted.  The Sqrt family sums
// small integers, so its sums are exact in any order and its results
// equal the plain version's bit for bit; the float terms of Simple, Opt
// and Lanchester are summed in another order than the plain version's.
#include "common.cuh"

#define NTERM 16

enum { F_SIMPLE = 0, F_SQRT = 1, F_SQRT2 = 2, F_SQRT3 = 3, F_OPT = 4,
       F_OPT_UB = 5, F_LANCHESTER = 6 };
// Lanchester type slots of EvalSpec::ids and EvalSpec::w
enum { L_BASE = 0, L_RAX = 1, L_WORKER = 2, L_LIGHT = 3, L_RANGED = 4,
       L_HEAVY = 5, L_CARRIED = 6, L_MINED = 7 };

struct EvalSpec {
  int fn;
  int ids[6];   // type index of Base, Barracks, Worker, Light, Ranged,
                // Heavy (-1: absent)
  float w[8];   // Lanchester weights, in the L_* order
};

#define FADD __fadd_rn
#define FMUL __fmul_rn
#define FDIV __fdiv_rn

// The per-cell terms of player p into v[0..]: see the combination below.
__device__ void cell_terms(const Cfg& cfg, const EvalSpec& sp, int ut,
                           int ow, int hp, int carried, float* v) {
  if (ut <= 0) return;
  const int t = tidx(cfg, ut);
  const float maxhp = (float)max(cfg.hp[t], 1);
  const float cost = (float)cfg.cost[t];
  const float fhp = (float)hp, fc = (float)carried;
  if (sp.fn == F_OPT_UB) {
    if (ow == -1) v[0] = FADD(v[0], fc);
    if (ow == 0 || ow == 1) v[1 + ow] = FADD(v[1 + ow], fc + cost);
    return;
  }
  if (ow != 0 && ow != 1) return;
  switch (sp.fn) {
    case F_SIMPLE:
      v[ow] = FADD(FMUL(fc, 10.0f),
                   FDIV(FMUL(FMUL(40.0f, cost), fhp), maxhp));
      break;
    case F_OPT:
      v[ow] = FADD(FMUL(fc, 0.60513535f),
                   FDIV(FMUL(FMUL(0.30983887f, cost), fhp), maxhp));
      break;
    case F_SQRT:
    case F_SQRT2:
    case F_SQRT3: {
      const int m = max(cfg.hp[t], 1);
      int q = hp / m;   // floor division, as jnp's // on int32
      if ((hp % m != 0) && ((hp < 0) != (m < 0))) --q;
      v[ow] = FADD(FMUL(fc, 10.0f),
                   FMUL(FMUL(40.0f, cost), sqrtf((float)q)));
      v[2 + ow] = 1.0f;
      break;
    }
    case F_LANCHESTER: {
      float* u = v + 8 * ow;
      if (t == sp.ids[L_BASE]) u[0] = FMUL(sp.w[L_BASE], fhp);
      if (t == sp.ids[L_RAX]) u[1] = FMUL(sp.w[L_RAX], fhp);
      if (t == sp.ids[L_WORKER]) u[2] = FMUL(sp.w[L_WORKER], fhp);
      if (t == sp.ids[L_LIGHT]) u[3] = FDIV(FMUL(sp.w[L_LIGHT], fhp), maxhp);
      if (t == sp.ids[L_RANGED]) u[4] = FMUL(sp.w[L_RANGED], fhp);
      if (t == sp.ids[L_HEAVY]) u[5] = FDIV(FMUL(sp.w[L_HEAVY], fhp), maxhp);
      if (t == sp.ids[L_WORKER] || t == sp.ids[L_LIGHT]
          || t == sp.ids[L_RANGED] || t == sp.ids[L_HEAVY])
        u[6] = 1.0f;
      u[7] = fc;
      break;
    }
  }
}

__device__ float lanchester_score(const EvalSpec& sp, const float* u,
                                  int bal) {
  const float s_build = FADD(u[0], u[1]);
  float unit = FADD(FADD(FADD(u[2], u[3]), u[4]), u[5]);
  unit = FMUL(unit, powf(fmaxf(u[6], 1e-9f), 0.7f));
  return FADD(FADD(FADD(unit, s_build), FMUL(u[7], sp.w[L_CARRIED])),
              FMUL((float)bal, sp.w[L_MINED]));
}

__global__ void evaluate_kernel(Cfg cfg, EvalSpec sp, const int8_t* utype,
                                const int8_t* owner, const int16_t* hp,
                                const int16_t* carried,
                                const int32_t* resources,
                                const int32_t* player, float* out) {
  const int HW = cfg.H * cfg.W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  __shared__ float s_part[32][NTERM];
  float v[NTERM];
  for (int i = 0; i < NTERM; ++i) v[i] = 0.0f;
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    float cv[NTERM];
    for (int i = 0; i < NTERM; ++i) cv[i] = 0.0f;
    cell_terms(cfg, sp, utype[base + c], owner[base + c], hp[base + c],
               carried[base + c], cv);
    for (int i = 0; i < NTERM; ++i) v[i] = FADD(v[i], cv[i]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < NTERM; ++i) {
    float x = v[i];
    for (int off = 16; off > 0; off >>= 1)
      x = FADD(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) s_part[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int nw = (blockDim.x + 31) >> 5;
  float s[NTERM];
  for (int i = 0; i < NTERM; ++i) {
    s[i] = 0.0f;
    for (int w = 0; w < nw; ++w) s[i] = FADD(s[i], s_part[w][i]);
  }
  const int me = player[b] == 1 ? 1 : 0;   // the wrapper passes 0 or 1
  const int op = 1 - me;
  const int bal_me = resources[2 * b + me], bal_op = resources[2 * b + op];
  float r = 0.0f;
  switch (sp.fn) {
    case F_SIMPLE:
    case F_OPT: {
      const float k = sp.fn == F_SIMPLE ? 20.0f : 0.19059792f;
      r = FADD(FMUL((float)bal_me, k), s[me])
          - FADD(FMUL((float)bal_op, k), s[op]);
      break;
    }
    case F_SQRT:
    case F_SQRT2:
    case F_SQRT3: {
      float s1 = FADD(FMUL((float)bal_me, 20.0f), s[me]);
      float s2 = FADD(FMUL((float)bal_op, 20.0f), s[op]);
      if (sp.fn == F_SQRT) {
        r = s1 - s2;
      } else if (sp.fn == F_SQRT2) {
        r = (s1 == 0.0f && s2 != 0.0f) ? -10000.0f
            : ((s1 != 0.0f && s2 == 0.0f) ? 10000.0f : s1 - s2);
      } else {
        if (s[2 + me] == 0.0f) s1 = 0.0f;
        if (s[2 + op] == 0.0f) s2 = 0.0f;
        const float tot = FADD(s1, s2);
        r = tot == 0.0f ? 0.5f : FDIV(FMUL(2.0f, s1), tot) - 1.0f;
      }
      break;
    }
    case F_OPT_UB: {
      const float r0 = FADD((float)resources[2 * b], s[1]);
      const float r1 = FADD((float)resources[2 * b + 1], s[2]);
      r = FMUL(FADD(s[0], fmaxf(r0, r1)), 0.30983887f);
      break;
    }
    case F_LANCHESTER: {
      const float d = lanchester_score(sp, s + 8 * me, bal_me)
                      - lanchester_score(sp, s + 8 * op, bal_op);
      r = FMUL(2.0f, FDIV(1.0f, FADD(1.0f, expf(-d)))) - 1.0f;
      break;
    }
  }
  out[b] = r;
}

extern "C" int evaluate_launch(const Cfg* cfg, const EvalSpec* spec,
                               const int8_t* utype, const int8_t* owner,
                               const int16_t* hp, const int16_t* carried,
                               const int32_t* resources,
                               const int32_t* player, int batch, float* out,
                               void* stream) {
  if (spec->fn < F_SIMPLE || spec->fn > F_LANCHESTER)
    return (int)cudaErrorInvalidValue;
  evaluate_kernel<<<batch, block_threads(cfg->H * cfg->W), 0,
                    (cudaStream_t)stream>>>(*cfg, *spec, utype, owner, hp,
                                            carried, resources, player, out);
  return (int)cudaGetLastError();
}
