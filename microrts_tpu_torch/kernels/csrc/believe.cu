// believe_update (K13): the believe-state bots' memory (BS1/BS2/BS3_NaiveMCTS).
//
// Replaces the believe-state update of the JAX package
// (microrts_tpu/bots/believestate.py:215-323: the vanished enemies with
// _targeted_by_attack :108-127, the forget-by-uid match :250-259, the
// inference loop :262-284, the drop of inferred units :293-299 and the
// spiral relocation _relocate :179-213), its initial memory (init :152) and
// the sampled world's overlay (sample_world :325-338), all of them shift
// stencils and whole-plane selects there.
//
// Bound at B=1024 envs of 16x16: the memory planes (3 x int32) and the
// seen types in and out, the view's unit planes and the previous view's
// (~14 bytes a cell each), the visibility and the world's four overlaid
// planes out: ~60 bytes a cell, ~16 MB, ~5 us at 3.35 TB/s.  The spiral
// (up to 168 offsets, a barrier each) and the all-pairs uid match (H*W
// compares a cell) make it latency-bound instead.
//
// Design: one block per env, one thread per cell (H*W <= 1024), the planes
// staged in shared memory.  JAX's order is kept, since each step reads the
// last one's results: a cell's remember and uid-forget touch only its own
// cell; the inference loop over the types runs on thread 0 in type order
// (seen[t] is updated as it goes and read as seen[pt]) from per-type first
// sightings found with shared atomicMin; each relocation offset is a
// bijection (the unit at c - offset lands on c), so within an offset the
// thread of a target cell is the only one that reads or clears its source,
// and a barrier separates offsets (the walk stops once no unit is left to
// place, which changes nothing after it).  Cells off the board read 0.
#include "common.cuh"

struct BelDims {
  int level;      // 1, 2 or 3
  int me;         // the observer
  int nsp;        // spiral offsets
  int R;          // max(attack_range): the attack box of wasUnderAttack
  int producer[MAXT];  // each type's first producer, -1 for none
};

struct MemP {  // a believe memory: int32 [B, H, W] planes, bool [B, T]
  int32_t* b_utype; int32_t* b_hp; int32_t* b_uid; uint8_t* seen;
};

struct WorldP {  // the sampled world's overlaid planes [B, H, W]
  int8_t* utype; int8_t* owner; int16_t* hp; int32_t* uid;
};

#define NONE_POS 0x7fffffff

__global__ void believe_kernel(Cfg cfg, BelDims dm, int init, StateP st,
                               StateP view, const uint8_t* vis, StateP prev,
                               MemP in, MemP out, WorldP world,
                               const int32_t* spiral) {
  const int H = cfg.H, W = cfg.W, HW = H * W, T = cfg.T;
  const int b = blockIdx.x, c = threadIdx.x;
  const bool cell = c < HW;
  const int x = cell ? c % W : 0, y = cell ? c / W : 0;
  const size_t g = (size_t)b * HW + c;
  const int opp = 1 - dm.me;
  extern __shared__ unsigned char smem[];
  unsigned char* p = smem;
  int32_t* s_bt = carve<int32_t>(p, HW);   // believed types (relocation)
  int32_t* s_ut = carve<int32_t>(p, HW);   // unresolved units (relocation)
  int32_t* s_uh = carve<int32_t>(p, HW);
  int32_t* s_uu = carve<int32_t>(p, HW);
  int32_t* s_vuid = carve<int32_t>(p, HW); // visible enemy uids, else 0
  int32_t* s_patx = carve<int32_t>(p, HW); // previous view's attack targets
  int32_t* s_paty = carve<int32_t>(p, HW);
  int32_t* s_new = carve<int32_t>(p, HW);  // inferred producers (type + 1)
  uint8_t* s_vis = carve<uint8_t>(p, HW);
  uint8_t* s_free = carve<uint8_t>(p, HW);
  uint8_t* s_patk = carve<uint8_t>(p, HW);
  __shared__ int s_first[MAXT];  // first cell (row-major) of a visible type
  __shared__ uint8_t s_seen[MAXT];

  const bool vis_c = cell && vis[g];
  if (c < T) {
    s_first[c] = NONE_POS;
    s_seen[c] = init ? 0 : in.seen[(size_t)b * T + c];
  }
  __syncthreads();

  if (init) {
    // setInitialBelieveState: the opponent's units hidden at the start
    if (cell) {
      const int ut = st.utype[g];
      const bool hidden = ut > 0 && st.owner[g] == opp && !vis_c;
      out.b_utype[g] = hidden ? ut : 0;
      out.b_hp[g] = hidden ? st.hp[g] : 0;
      out.b_uid[g] = hidden ? st.uid[g] : 0;
      if (hidden && ut <= T) s_seen[ut - 1] = 1;
    }
    __syncthreads();
    if (c < T) out.seen[(size_t)b * T + c] = s_seen[c];
    return;
  }

  int bt = 0, bh = 0, bu = 0;
  bool now_enemy = false, now_free = false;
  if (cell) {
    bt = in.b_utype[g]; bh = in.b_hp[g]; bu = in.b_uid[g];
    const int vu = view.utype[g];
    now_enemy = vu > 0 && view.owner[g] == opp;
    now_free = st.terrain[g] == 0 && !(vu > 0);
    s_vis[c] = vis_c;
    s_free[c] = now_free;
    s_vuid[c] = now_enemy ? view.uid[g] : 0;
    s_patk[c] = prev.utype[g] > 0 && prev.busy[g] && prev.atype[g] == A_ATTACK;
    s_patx[c] = prev.atx[g];
    s_paty[c] = prev.aty[g];
    s_new[c] = 0;
    if (now_enemy && vu <= T) atomicMin(&s_first[vu - 1], c);
  }
  __syncthreads();

  if (dm.level >= 2 && cell) {
    // the units that vanished from view (BS3:228-254)
    const bool prev_enemy = prev.utype[g] > 0 && prev.owner[g] == opp;
    const bool gone = prev_enemy && now_free;
    const bool moving = prev.busy[g] && prev.atype[g] == A_MOVE;
    bool tgt_unobs = false;
    const int pa = prev.aparam[g];
    for (int d = 0; d < 4; ++d) {
      const int nx = x + dir_dx(d), ny = y + dir_dy(d);
      const bool unobs = nx >= 0 && nx < W && ny >= 0 && ny < H
                         && !s_vis[ny * W + nx];
      tgt_unobs = tgt_unobs || (pa == d && unobs);
    }
    bool attacked = false;
    for (int oy = -dm.R; oy <= dm.R && !attacked; ++oy)
      for (int ox = -dm.R; ox <= dm.R; ++ox) {
        if (ox == 0 && oy == 0) continue;
        const int sx = x - ox, sy = y - oy;
        if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
        const int s = sy * W + sx;
        if (s_patk[s] && s_patx[s] == x && s_paty[s] == y) {
          attacked = true;
          break;
        }
      }
    const bool moved_to_fog = gone && moving && tgt_unobs;
    const bool static_lost = gone && !moving && !vis_c && !attacked;
    if ((moved_to_fog || static_lost) && bt == 0) {
      bt = prev.utype[g]; bh = prev.hp[g]; bu = prev.uid[g];
    }
    // forget a believed unit whose uid is visible anywhere (BS3:289-306)
    if (bu > 0) {
      bool hit = false;
      for (int j = 0; j < HW && !hit; ++j) hit = s_vuid[j] == bu;
      if (hit) { bt = 0; bh = 0; bu = 0; }
    }
  }

  if (dm.level >= 3) {
    // inference of unseen producers (BS3:256-277), types in order
    if (c == 0) {
      for (int t = 0; t < T; ++t) {
        const int pt = dm.producer[t];
        if (pt < 0) continue;
        const bool any_t = s_first[t] != NONE_POS;
        const bool need = any_t && !s_seen[t] && !s_seen[pt]
                          && s_first[pt] == NONE_POS;
        if (need && s_new[s_first[t]] == 0) s_new[s_first[t]] = pt + 1;
        s_seen[t] = s_seen[t] || any_t;
      }
    }
    __syncthreads();
    // (without a spiral the JAX package places no inferred unit)
    bool need = false;
    if (cell && dm.nsp > 0) {
      const int nw = s_new[c];
      if (nw > 0) { bt = nw; bh = cfg.hp[nw - 1]; bu = 0; }
      need = nw > 0;
    }
    // relocate(need) then, after the drop, relocate(bad): two walks
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && cell) {
        // forget inferred units once their type is seen (BS3:279-287)
        if (bt > 0 && bt <= T && bu == 0 && s_first[bt - 1] != NONE_POS) {
          bt = 0; bh = 0;
        }
        need = bt > 0 && vis_c;  // believed units on observed cells
      }
      if (dm.nsp == 0 && pass == 0) continue;
      if (cell) {
        s_ut[c] = need ? bt : 0; s_uh[c] = need ? bh : 0;
        s_uu[c] = need ? bu : 0;
        if (need) { bt = 0; bh = 0; bu = 0; }
        s_bt[c] = bt;
      }
      for (int k = 0; k < dm.nsp; ++k) {
        // a barrier, and the walk ends once no unit is left to place
        if (!__syncthreads_or(cell && s_ut[c] > 0)) break;
        if (!cell) continue;
        const int sx = x - spiral[2 * k], sy = y - spiral[2 * k + 1];
        if (sx < 0 || sx >= W || sy < 0 || sy >= H) continue;
        const int s = sy * W + sx;
        if (s_ut[s] > 0 && !s_vis[c] && s_free[c] && s_bt[c] == 0) {
          bt = s_ut[s]; bh = s_uh[s]; bu = s_uu[s];
          s_bt[c] = bt;
          s_ut[s] = 0; s_uh[s] = 0; s_uu[s] = 0;
        }
      }
      __syncthreads();
    }
  } else if (cell) {
    // BS2: a believed unit on an observed cell is forgotten; BS1: the
    // initial units, forgotten when their cell is observed free
    const bool bad = bt > 0 && vis_c && (dm.level == 2 || now_free);
    if (bad) { bt = 0; bh = 0; bu = 0; }
  }

  if (cell) {
    out.b_utype[g] = bt; out.b_hp[g] = bh; out.b_uid[g] = bu;
    if (world.utype) {
      // sampleWorld: the believed units where the view's cell is free
      const bool put = now_free && bt > 0;
      world.utype[g] = (int8_t)(put ? bt : view.utype[g]);
      world.owner[g] = (int8_t)(put ? opp : view.owner[g]);
      world.hp[g] = (int16_t)(put ? bh : view.hp[g]);
      world.uid[g] = put ? (bu > 0 ? bu : (1 << 20)) : view.uid[g];
    }
  }
  if (c < T) out.seen[(size_t)b * T + c] = s_seen[c];
}

// init != 0: the initial memory of the full state `st` (prev, in and world
// unused); else the update of `in` by the view, its visibility and the
// previous view, and the world's overlay when world.utype is not null.
// spiral: int32 [nsp, 2] (dx, dy) offsets on the device.
extern "C" int believe_update_launch(const Cfg* cfg, const BelDims* dm,
                                     int init, int batch, const StateP* st,
                                     const StateP* view, const uint8_t* vis,
                                     const StateP* prev, const MemP* in,
                                     const MemP* out, const WorldP* world,
                                     const int32_t* spiral, void* stream) {
  const int HW = cfg->H * cfg->W;
  if (HW > 1024 || cfg->T > MAXT) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  for (int i = 0; i < 8; ++i) smem += carve_bytes(sizeof(int32_t) * HW);
  for (int i = 0; i < 3; ++i) smem += carve_bytes(HW);
  smem += 16;
  cudaError_t e = allow_smem(believe_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  believe_kernel<<<batch, block_threads(HW), smem, (cudaStream_t)stream>>>(
      *cfg, *dm, init, *st, *view, vis, *prev, *in, *out, *world, spiral);
  return (int)cudaGetLastError();
}
