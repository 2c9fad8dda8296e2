// synth: the two shift stencils of the DSL interpreter of the JAX
// package's microrts_tpu/synth/dsl.py.
//
// range_cover replaces _range_cover (:319-331): the cells within attack
// range of some unit of a mask (squared-Euclidean ranges, each source
// cell's own range; the box of offsets up to the table's largest range).
// dsl_target replaces nearest_in_range_target (:382-407) under the seven
// target policies (:410-420) as a mode: per cell, the in-range enemy of
// the highest float32 score, scanned closest first (the host's stable
// sort of the dy-major box by d2), the first strictly larger score
// winning from -inf; Random's scores are an input, one uniform plane a
// window offset.
//
// Bound at B=1024, 16x16: range_cover reads the utype plane and the mask
// (2 B a cell) and writes 1 B, 0.8 MB, 0.23 us at 3.35 TB/s; dsl_target
// reads 5 B of state a cell (utype, owner, hp) and writes 5 B, ~2.6 MB,
// 0.8 us (Random also reads its 49 planes of uniforms, 51 MB, 15 us).
// Over 48 offsets a cell, range_cover needs 3 int32 operations an offset
// (the range squared against d2, the AND with the source, the OR into
// the cover), ~38 M operations, 2.3 us at 16.7 T/s; dsl_target (Weakest)
// 6 (d2 against the range squared, the AND with the enemy flag, the
// score against the best, the AND, two selects), ~75 M operations,
// 4.5 us: both are bound by operations, Random by its uniforms' bytes.
//
// Design: one thread per cell, the neighbours read from device memory
// (the planes of an env stay in L1/L2 across its cells).
#include <math.h>

#include "common.cuh"

#define MAXOFF 64

struct TargetSpec {
  int mode;   // 0 Closest, 1 Farthest, 2 Weakest/LessHealthy,
              // 3 MostHealthy, 4 Strongest, 5 Random
  int noff;   // attack scan offsets, closest first
  int off_dx[MAXOFF], off_dy[MAXOFF];
};

// utype int8 [B, H, W], src uint8 [B, H, W] -> uint8 [B, H, W]
__global__ void range_cover_kernel(Cfg cfg, const int8_t* utype,
                                   const uint8_t* src, int B,
                                   uint8_t* out) {
  const int H = cfg.H, W = cfg.W, R = cfg.R, HW = H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * HW) return;
  const int c = (int)(i % HW);
  const size_t e = i - c;
  const int x = c % W, y = c / W;
  bool cover = false;
  for (int dy = -R; dy <= R && !cover; ++dy)
    for (int dx = -R; dx <= R; ++dx) {
      const int d2 = dx * dx + dy * dy;
      if (d2 == 0) continue;
      const int sx = x - dx, sy = y - dy;
      if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
      const int n = sy * W + sx;
      if (!src[e + n]) continue;
      const int rng = cfg.attack_range[tidx(cfg, utype[e + n])];
      if (rng * rng >= d2) {
        cover = true;
        break;
      }
    }
  out[i] = cover;
}

// -> rel int32 [B, H, W] (the window index of the chosen enemy, 0 if
// none), found uint8 [B, H, W]
__global__ void dsl_target_kernel(Cfg cfg, TargetSpec sp, StateP s, int B,
                                  int me0, const int32_t* players,
                                  const float* u, int32_t* rel_out,
                                  uint8_t* found_out) {
  const int H = cfg.H, W = cfg.W, R = cfg.R, D = 2 * cfg.R + 1;
  const int HW = H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * HW) return;
  const int c = (int)(i % HW);
  const size_t e = i - c;
  const int b = (int)(e / HW);
  const int me = players ? players[b] : me0;
  const int x = c % W, y = c / W;
  const int rng = cfg.attack_range[tidx(cfg, s.utype[i])];
  float best_s = -INFINITY;
  int best_rel = 0;
  for (int k = 0; k < sp.noff; ++k) {
    const int dx = sp.off_dx[k], dy = sp.off_dy[k];
    const int d2 = dx * dx + dy * dy;
    if (d2 > rng * rng) continue;
    const int nx = x + dx, ny = y + dy;
    if (nx < 0 || nx >= W || ny < 0 || ny >= H) continue;
    const size_t n = e + ny * W + nx;
    const int ut = s.utype[n], ow = s.owner[n];
    if (!(ut > 0 && ow >= 0 && ow != me)) continue;
    const int rel = (R + dy) * D + (R + dx);
    float sc;
    switch (sp.mode) {
      case 0: sc = 0.0f; break;
      case 1: sc = (float)d2; break;
      case 2: sc = -(float)s.hp[n]; break;
      case 3: sc = (float)s.hp[n]; break;
      case 4: sc = (float)cfg.max_damage[tidx(cfg, ut)]; break;
      default: sc = u[((size_t)b * D * D + rel) * HW + c]; break;
    }
    if (sc > best_s) {
      best_s = sc;
      best_rel = rel;
    }
  }
  rel_out[i] = best_rel;
  found_out[i] = isfinite(best_s);
}

extern "C" int range_cover_launch(const Cfg* cfg, const int8_t* utype,
                                  const uint8_t* src, int B, uint8_t* out,
                                  void* stream) {
  const size_t n = (size_t)B * cfg->H * cfg->W;
  if (n == 0) return 0;
  range_cover_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(*cfg, utype, src, B, out);
  return (int)cudaGetLastError();
}

extern "C" int dsl_target_launch(const Cfg* cfg, const TargetSpec* sp,
                                 const StateP* s, int B, int me,
                                 const int32_t* players, const float* u,
                                 int32_t* rel, uint8_t* found, void* stream) {
  if (sp->noff > MAXOFF || sp->mode < 0 || sp->mode > 5 ||
      (sp->mode == 5 && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * cfg->H * cfg->W;
  if (n == 0) return 0;
  dsl_target_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(*cfg, *sp, *s, B, me, players,
                                              u, rel, found);
  return (int)cudaGetLastError();
}
