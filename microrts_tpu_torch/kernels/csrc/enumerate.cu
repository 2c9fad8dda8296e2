// enum_next: one step of the odometer enumerator of joint player actions
// (K12e).
//
// Replaces the JAX package's make_enumerator.next_action
// (microrts_tpu/ops/enumerate.py:180-197) with its _arms_of (:121),
// _consistency (:141) and _increment (:167): the lazy walk of Java's
// PlayerActionGenerator.getNextAction over the product of every acting
// cell's legal arms, to the next joint action whose claims and produce
// costs are consistent, or to exhaustion.
//
// Bound: an active lane needs its odometer row (HW digits in, HW out),
// every cell's first legal-arm word (the NONE bit says whether it acts),
// the other words of the acting cells only, the L in-flight claim flags,
// its spend and balance; every lane writes HW arms and a valid flag.  The
// walk's trip count depends on the data (ops/enumerate.py); each trip is
// ~30 integer operations a cell.  chip_smoke.py works both out from the
// run's inputs.
//
// Design: one block a lane, one thread a cell, next_action's whole while
// loop inside the kernel (no launch a trip).  A thread keeps its cell's
// packed legal arms (NW words) and digit in registers.  Each trip:
//   1. the digit's arm, the k-th set bit counted from arm A-1 down (a
//      popcount walk over the words, then a binary search in the word);
//   2. its claim slot W + cell + OFF[dir] and produce cost; the last
//      claimant of every slot by an atomicMax in shared memory, so a cell
//      fails on a claim that a later cell or an in-flight action holds;
//   3. the suffix sum of the produce costs (warp shuffles, then the
//      later warps' totals), against the balance;
//   4. the largest failing cell (a block max) and the first digit at or
//      above it that is under its radix (a block min), bumped, the digits
//      below zeroed; none left clears the counter and ends the walk.
// The loop's condition is uniform over the block (shared reductions).
#include "common.cuh"

#define FULL_MASK 0xffffffffu

struct EnumDims {
  int H, W;   // board
  int T;      // unit types (produce arms 13 + k*T + t)
  int NW;     // packed legal-arm words a cell
  int R;      // odometer rows a lane
};

// Position of the n-th (0-based) set bit of w counted from bit 0.
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
  int pos = 0;
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned lo = w & ((1u << s) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      w >>= s;
      pos += s;
    } else {
      w = lo;
    }
  }
  return pos;
}

// Block-wide max / min of v (every thread gets it); red holds 32 ints.
__device__ __forceinline__ int block_max(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(FULL_MASK, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = red[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) out = max(out, red[k]);
  __syncthreads();
  return out;
}

__device__ __forceinline__ int block_min(int v, int* red) {
  return -block_max(-v, red);
}

__global__ void enum_next_kernel(Cfg cfg, EnumDims d, int32_t* choice,
                                 uint8_t* more, const int32_t* row,
                                 const uint8_t* active, const int32_t* la,
                                 const uint8_t* claimed0,
                                 const int32_t* spent0,
                                 const int32_t* balance, int32_t* arms_out,
                                 uint8_t* valid_out, int32_t* trips_out) {
  const int b = blockIdx.x, i = threadIdx.x;
  const int W = d.W, HW = d.H * d.W, L = HW + 2 * W, NW = d.NW;
  const int lane = i & 31, wid = i >> 5;
  const bool in = i < HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int* last = carve<int>(p, L);
  uint8_t* base = carve<uint8_t>(p, L);
  __shared__ int red[32];
  __shared__ int wsum[32];

  if (!active[b]) {
    if (in) arms_out[(size_t)b * HW + i] = -1;
    if (i == 0) {
      valid_out[b] = 0;
      trips_out[b] = 0;
    }
    return;
  }
  const size_t rr = (size_t)b * d.R + (row ? row[b] : 0);
  unsigned w[MAXNW];
  int cnt = 0;
  for (int k = 0; k < MAXNW; ++k) {
    w[k] = (in && k < NW) ? (unsigned)la[(rr * HW + i) * NW + k] : 0u;
    cnt += __popc(w[k]);
  }
  const bool acting = w[0] & 1u;  // NONE is legal exactly where it acts
  const int size = max(cnt, 1);
  int c = in ? choice[rr * HW + i] : 0;
  bool mo = more[rr] != 0;
  const int spent = spent0[rr], bal = balance[rr];
  for (int s = i; s < L; s += blockDim.x) base[s] = claimed0[rr * L + s];
  const int ab = 13 + 4 * d.T;

  bool found = false;
  int arm = -1, trips = 0;
  while (mo && !found) {
    // 1. the c-th legal arm counted from the top, NONE last
    arm = -1;
    if (acting) {
      int k = c;
      for (int q = NW - 1; q >= 0; --q) {
        const int n = __popc(w[q]);
        if (k < n) {
          arm = 32 * q + nth_set_bit(w[q], n - 1 - k);
          break;
        }
        k -= n;
      }
    }
    // 2. claim slot and produce cost
    int dir = -1, cost = 0;
    if (arm >= 1 && arm <= 4) {
      dir = arm - 1;
    } else if (arm >= 13 && arm < ab) {
      dir = (arm - 13) / d.T;
      cost = cfg.cost[(arm - 13) % d.T];
    }
    int slot = L;
    if (dir >= 0) {
      slot = claim_slot(W, i, dir);
      if (slot < 0 || slot >= L) slot = L;
    }
    for (int s = i; s < L; s += blockDim.x) last[s] = -1;
    __syncthreads();
    if (slot < L) atomicMax(&last[slot], i);
    // 3. suffix sum of the costs: within the warp, then later warps
    int x = cost;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(FULL_MASK, x, o);
      if (lane + o < 32) x += y;
    }
    if (lane == 0) wsum[wid] = x;
    __syncthreads();
    int acc = x + spent;
    for (int k = wid + 1; k < (int)(blockDim.x >> 5); ++k) acc += wsum[k];
    const bool fail = (slot < L && (last[slot] > i || base[slot]))
                      || (cost > 0 && acc > 0 && acc > bal);
    // 4. the largest failing cell; the digit to bump at or above it
    const int fpos = block_max(fail ? i : -1, red);
    const bool ok = fpos < 0;
    const int pmin = ok ? 0 : fpos;
    const int first = block_min((in && i >= pmin && c < size - 1) ? i : HW,
                                red);
    const bool has = first < HW;
    if (in) c = (i < (has ? first : HW)) ? 0 : (i == first ? c + 1 : c);
    mo = mo && has;
    found = ok;
    ++trips;
  }
  if (in) {
    choice[rr * HW + i] = c;
    arms_out[(size_t)b * HW + i] = found ? arm : -1;
  }
  if (i == 0) {
    more[rr] = mo;
    valid_out[b] = found;
    trips_out[b] = trips;
  }
}

// choice int32 [B, R, HW] and more uint8 [B, R] advanced in place at row
// row[b] (null: 0) of every lane with active[b]; la int32 [B, R, HW, NW],
// claimed0 uint8 [B, R, L], spent0 / balance int32 [B, R]; arms int32
// [B, HW], valid uint8 [B] and trips int32 [B] out.
extern "C" int enum_next_launch(const Cfg* cfg, const EnumDims* d, int batch,
                                int32_t* choice, uint8_t* more,
                                const int32_t* row, const uint8_t* active,
                                const int32_t* la, const uint8_t* claimed0,
                                const int32_t* spent0, const int32_t* balance,
                                int32_t* arms, uint8_t* valid, int32_t* trips,
                                void* stream) {
  const int HW = d->H * d->W, L = HW + 2 * d->W;
  if (HW > 1024 || d->NW < 1 || d->NW > MAXNW || d->T < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = carve_bytes(sizeof(int) * L) + carve_bytes(L) + 16;
  cudaError_t e = allow_smem(enum_next_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  enum_next_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *d, choice, more, row, active, la, claimed0, spent0, balance,
      arms, valid, trips);
  return (int)cudaGetLastError();
}
