// The device BFS of the JAX package's microrts_tpu/ops/fields.py, shared
// by the kernels that compute distance fields inside one block per env
// (rush.cu, fields.cu, expert.cu).
//
// distance_field (:23) is ``iters`` synchronous 4-neighbour min-plus
// sweeps, not a converged BFS: beyond ``iters`` steps a cell stays INF.
// Each sweep reads the previous sweep's field (double buffers in shared
// memory), off-board neighbours read INF-1, non-source cells that cannot
// be walked are pinned to INF and sources to 0.  descend_direction (:126)
// steps to the strictly smaller neighbour in tie order down, left, up,
// right (AStarPathFinding.java:73-76).
#pragma once
#include "common.cuh"

__device__ __forceinline__ int nb_dist(const int* dist, int H, int W, int x,
                                       int y, int d, int fill) {
  const int nx = x + dir_dx(d), ny = y + dir_dy(d);
  if (nx < 0 || nx >= W || ny < 0 || ny >= H) return fill;
  return dist[ny * W + nx];
}

// Whether the neighbour of cell (x, y) in direction d has any flag of
// ``f`` (off-board: false).
template <typename FL>
__device__ __forceinline__ bool nb_has(const FL* fl, int H, int W, int x,
                                       int y, int d, unsigned f) {
  const int nx = x + dir_dx(d), ny = y + dir_dy(d);
  if (nx < 0 || nx >= W || ny < 0 || ny >= H) return false;
  return (fl[ny * W + nx] & f) != 0;
}

// ``iters`` synchronous sweeps of ``nf`` fields at once: field f's sources
// are the cells with any flag of ``srcf[f]``, the walkable cells those
// with any flag of ``pass``.  The block's threads walk the H*W cells; the
// result is in cur[f] on return (the buffers swap each sweep).
template <typename FL>
__device__ void distance_fields(int nf, const FL* srcf, int** cur, int** nxt,
                                const FL* fl, FL pass, int H, int W,
                                int iters) {
  const int HW = H * W;
  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    for (int f = 0; f < nf; ++f) cur[f][c] = (fl[c] & srcf[f]) ? 0 : INF_I;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int c = threadIdx.x; c < HW; c += blockDim.x) {
      const int x = c % W, y = c / W;
      const bool walk = (fl[c] & pass) != 0;
      for (int f = 0; f < nf; ++f) {
        int v;
        if (fl[c] & srcf[f]) {
          v = 0;
        } else if (!walk) {
          v = INF_I;
        } else {
          v = cur[f][c];
          for (int d = 0; d < 4; ++d)
            v = min(v, nb_dist(cur[f], H, W, x, y, d, INF_I - 1) + 1);
        }
        nxt[f][c] = v;
      }
    }
    __syncthreads();
    for (int f = 0; f < nf; ++f) {
      int* t = cur[f];
      cur[f] = nxt[f];
      nxt[f] = t;
    }
  }
}

// descend_direction: the strictly-smaller neighbour in tie order
// down, left, up, right among the free neighbours (bit d of free_b);
// -1 if none.
__device__ __forceinline__ int descend(const int* dist, unsigned free_b,
                                       int H, int W, int x, int y) {
  const int order[4] = {2, 3, 0, 1};
  int best_d = -1, best_v = dist[y * W + x];
  for (int i = 0; i < 4; ++i) {
    const int k = order[i];
    const int v = nb_dist(dist, H, W, x, y, k, INF_I);
    if (((free_b >> k) & 1) && v < best_v) {
      best_d = k;
      best_v = v;
    }
  }
  return best_d;
}

__device__ __forceinline__ int first_bit(unsigned b) {
  return b ? __ffs(b) - 1 : 0;
}
