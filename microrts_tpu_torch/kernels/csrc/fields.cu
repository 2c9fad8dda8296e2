// fields: the standalone BFS fields of the JAX package's
// microrts_tpu/ops/fields.py (K9 rest).
//
// distance_fields replaces distance_field (:23) for F source planes over
// one passable plane in one launch; descend_direction (:126);
// distance_field2 (:42) keeps per cell the nearest two DISTINCT sources;
// descend_direction_excluding (:104) steps toward the nearest source whose
// id is not the cell's own.
//
// Bound at B=1024, 16x16, three fields of H+W = 32 sweeps: reads ~1 B a
// cell and plane, writes 12 B a cell, ~4 MB, 1.2 us at 3.35 TB/s; the
// sweeps are 3 x 32 x 7 int32 operations a cell (the min of the four
// neighbours, the +1, the min with the cell, the source and walkable
// selects), ~176 M operations, ~10.5 us at the card's 16.7 T int32
// operations/s: bound by operations.  distance_field2's sweeps merge 8
// candidates a cell (~80 operations).
//
// Design: the fields keep one block per env, the planes double-buffered
// int32 in shared memory (fields.cuh, as rush.cu computes them); the
// descents are one thread per cell reading the field from device memory.
#include "fields.cuh"

#define MAXF 8
#define F2_PASS 1u
#define F2_SRC 2u

// sources uint8 [B, F, H, W], passable uint8 [B, H, W] -> int32 [B, F, H, W]
__global__ void distance_fields_kernel(const uint8_t* src, const uint8_t* pas,
                                       int F, int H, int W, int iters,
                                       int32_t* out) {
  const int HW = H * W;
  const int b = blockIdx.x;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint32_t* fl = carve<uint32_t>(p, HW);
  int* cur[MAXF];
  int* nxt[MAXF];
  uint32_t srcf[MAXF];
  for (int f = 0; f < F; ++f) {
    cur[f] = carve<int>(p, HW);
    nxt[f] = carve<int>(p, HW);
    srcf[f] = 1u << f;
  }
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    uint32_t v = pas[(size_t)b * HW + c] ? (1u << 31) : 0u;
    for (int f = 0; f < F; ++f)
      if (src[((size_t)b * F + f) * HW + c]) v |= 1u << f;
    fl[c] = v;
  }
  __syncthreads();
  distance_fields<uint32_t>(F, srcf, cur, nxt, fl, 1u << 31, H, W, iters);
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    for (int f = 0; f < F; ++f) out[((size_t)b * F + f) * HW + c] = cur[f][c];
}

// dist int32 [B, H, W], movable uint8 [B, H, W, 4] -> int32 [B, H, W]
__global__ void descend_kernel(const int32_t* dist, const uint8_t* mov,
                               int B, int H, int W, int32_t* out) {
  const int HW = H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * HW) return;
  const int c = (int)(i % HW);
  const int32_t* d = dist + (i - c);
  unsigned fb = 0;
  for (int k = 0; k < 4; ++k) fb |= (unsigned)(mov[i * 4 + k] != 0) << k;
  out[i] = descend(d, fb, H, W, c % W, c / W);
}

// distance_field2's insert (fields.py:63-79): merge candidate (dc, ic).
__device__ __forceinline__ void insert2(int& d1, int& i1, int& d2, int& i2,
                                        int dc, int ic) {
  const bool valid = ic >= 0;
  const bool same1 = valid && ic == i1;
  const bool beats1 = valid && dc < d1;
  const bool case_b = !same1 && beats1;
  const bool case_c = !same1 && !beats1 && valid;
  const int d2c = min(d2, dc);
  const int i2c = dc < d2 ? ic : i2;
  const int nd1 = same1 ? min(d1, dc) : (case_b ? dc : d1);
  const int ni1 = case_b ? ic : i1;
  const int nd2 = case_b ? d1 : (case_c ? d2c : d2);
  const int ni2 = case_b ? i1 : (case_c ? i2c : i2);
  d1 = nd1; i1 = ni1; d2 = nd2; i2 = ni2;
}

// sources, passable uint8 [B, H, W] -> d1, i1, d2, i2 int32 [B, H, W]
__global__ void distance_field2_kernel(const uint8_t* src, const uint8_t* pas,
                                       int H, int W, int iters, int32_t* o_d1,
                                       int32_t* o_i1, int32_t* o_d2,
                                       int32_t* o_i2) {
  const int HW = H * W;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * HW;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  uint8_t* fl = carve<uint8_t>(p, HW);
  int* cur[4];
  int* nxt[4];
  for (int k = 0; k < 4; ++k) {
    cur[k] = carve<int>(p, HW);
    nxt[k] = carve<int>(p, HW);
  }
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const bool s = src[base + c] != 0;
    fl[c] = (s ? F2_SRC : 0u) | (pas[base + c] ? F2_PASS : 0u);
    cur[0][c] = s ? 0 : INF_I;
    cur[1][c] = s ? c : -1;
    cur[2][c] = INF_I;
    cur[3][c] = -1;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const int x = c % W, y = c / W;
      int d1 = cur[0][c], i1 = cur[1][c], d2 = cur[2][c], i2 = cur[3][c];
      for (int k = 0; k < 4; ++k) {
        const int nx = x + dir_dx(k), ny = y + dir_dy(k);
        const bool on = nx >= 0 && nx < W && ny >= 0 && ny < H;
        const int n = ny * W + nx;
        insert2(d1, i1, d2, i2, (on ? cur[0][n] : INF_I - 1) + 1,
                on ? cur[1][n] : -1);
        insert2(d1, i1, d2, i2, (on ? cur[2][n] : INF_I - 1) + 1,
                on ? cur[3][n] : -1);
      }
      if (!(fl[c] & (F2_SRC | F2_PASS))) {
        d1 = INF_I; i1 = -1; d2 = INF_I; i2 = -1;
      }
      if (fl[c] & F2_SRC) {   // source cells pin their own first entry
        d1 = 0;
        i1 = c;
      }
      nxt[0][c] = d1; nxt[1][c] = i1; nxt[2][c] = d2; nxt[3][c] = i2;
    }
    __syncthreads();
    for (int k = 0; k < 4; ++k) {
      int* t = cur[k];
      cur[k] = nxt[k];
      nxt[k] = t;
    }
  }
  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    o_d1[base + c] = cur[0][c];
    o_i1[base + c] = cur[1][c];
    o_d2[base + c] = cur[2][c];
    o_i2[base + c] = cur[3][c];
  }
}

// the value descend_direction_excluding reads at cell n for id ``self``
__device__ __forceinline__ int excl_val(const int32_t* d1, const int32_t* i1,
                                        const int32_t* d2, int n, int self) {
  return i1[n] != self ? d1[n] : d2[n];
}

// d1, i1, d2 int32 [B, H, W], movable uint8 [B, H, W, 4], self_id int32
// [B, H, W] -> int32 [B, H, W]
__global__ void descend_excluding_kernel(const int32_t* d1, const int32_t* i1,
                                         const int32_t* d2, const uint8_t* mov,
                                         const int32_t* self_id, int B, int H,
                                         int W, int32_t* out) {
  const int HW = H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * HW) return;
  const int c = (int)(i % HW);
  const size_t e = i - c;
  const int x = c % W, y = c / W, self = self_id[i];
  const int order[4] = {2, 3, 0, 1};
  int best_d = -1, best_v = excl_val(d1 + e, i1 + e, d2 + e, c, self);
  for (int j = 0; j < 4; ++j) {
    const int k = order[j];
    const int nx = x + dir_dx(k), ny = y + dir_dy(k);
    // off board, d1 and d2 read INF (and the id -1): either way INF
    const int v = (nx < 0 || nx >= W || ny < 0 || ny >= H)
                      ? INF_I
                      : excl_val(d1 + e, i1 + e, d2 + e, ny * W + nx, self);
    if (mov[i * 4 + k] && v < best_v) {
      best_d = k;
      best_v = v;
    }
  }
  out[i] = best_d;
}

static size_t fields_smem(int HW, int F) {
  return carve_bytes(4 * HW) * (2 * F + 1) + 16;
}

static size_t field2_smem(int HW) {
  return carve_bytes(HW) + carve_bytes(4 * HW) * 8 + 16;
}

extern "C" int distance_fields_launch(const uint8_t* src, const uint8_t* pas,
                                      int B, int F, int H, int W, int iters,
                                      int32_t* out, void* stream) {
  if (F < 1 || F > MAXF) return (int)cudaErrorInvalidValue;
  const size_t smem = fields_smem(H * W, F);
  cudaError_t e = allow_smem(distance_fields_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  distance_fields_kernel<<<B, block_threads(H * W), smem,
                           (cudaStream_t)stream>>>(src, pas, F, H, W, iters,
                                                   out);
  return (int)cudaGetLastError();
}

extern "C" int descend_direction_launch(const int32_t* dist,
                                        const uint8_t* mov, int B, int H,
                                        int W, int32_t* out, void* stream) {
  const size_t n = (size_t)B * H * W;
  if (n == 0) return 0;
  descend_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(dist, mov, B, H, W, out);
  return (int)cudaGetLastError();
}

extern "C" int distance_field2_launch(const uint8_t* src, const uint8_t* pas,
                                      int B, int H, int W, int iters,
                                      int32_t* d1, int32_t* i1, int32_t* d2,
                                      int32_t* i2, void* stream) {
  const size_t smem = field2_smem(H * W);
  cudaError_t e = allow_smem(distance_field2_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  distance_field2_kernel<<<B, block_threads(H * W), smem,
                           (cudaStream_t)stream>>>(src, pas, H, W, iters, d1,
                                                   i1, d2, i2);
  return (int)cudaGetLastError();
}

extern "C" int descend_direction_excluding_launch(
    const int32_t* d1, const int32_t* i1, const int32_t* d2,
    const uint8_t* mov, const int32_t* self_id, int B, int H, int W,
    int32_t* out, void* stream) {
  const size_t n = (size_t)B * H * W;
  if (n == 0) return 0;
  descend_excluding_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(d1, i1, d2, mov, self_id,
                                                     B, H, W, out);
  return (int)cudaGetLastError();
}
