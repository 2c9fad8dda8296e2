// cooperative_act: CooperativeAI's per-unit choices compiled to gridnet
// actions (K14c).
//
// Replaces what the JAX package's cooperative_bot does after the per-type
// networks (microrts_tpu/bots/cooperative.py:100-227): the first maxima of
// the target tile and the unit type of every unit's network output, the
// target tile's resource and enemy flags (JAX: a one-hot [HW, HW] matmul,
// an exact gather), the free-neighbour pulls, the own bases' BFS distance
// field (the fields.cuh device BFS, as expert_macro runs it), the greedy
// step toward the tile in A*'s tie order (down, left, up, right), the
// adjacency direction, the attack range test and window index, the descent
// of the base field, and the _set cascade of the macro rules in JAX's
// order (a later write wins).
//
// Bound (16x16, T = 7): only an idle own unit reads its row of the
// networks' output (HW + T + 1 floats); every cell's state planes are read
// and its action (28 B) written: bytes, from the run's idle units; the
// BFS's H + W sweeps of 7 int32 operations a cell (FIELD_OPS) bound it
// where few units are idle.
//
// Design: one block per env.  A thread a cell stages the class flags
// (passable, own base, resource, enemy) in shared memory; the block runs
// the base field; then a warp per idle own unit takes the first maxima of
// its row (lanes every 32nd tile, a warp reduction; the type among the
// first T + 1 lanes) and lane 0 compiles the action.  Integer arithmetic
// only after the float argmaxes, so the kernel equals the plain PyTorch
// version (bots/cooperative.py) exactly.
#include "arms.cuh"
#include "fields.cuh"

enum : uint8_t { C_PASS = 1, C_BASE = 2, C_RES = 4, C_ENEMY = 8, C_IDLE = 16 };

__device__ __forceinline__ void put_col(int32_t* o, int atype, int col,
                                        int val) {
  o[0] = atype;
  o[col] = val;
}

// Lane 0's compilation of one idle unit's (tile, type) choice at cell c
// into its action row (cooperative.py:127-227).
__device__ void compile_action(const Cfg& cfg, const StateP& s, size_t b,
                               int c, int tile, int typ, int bal,
                               const uint8_t* fl, const int* dist,
                               int32_t* act) {
  const int H = cfg.H, W = cfg.W, HW = H * W, T = cfg.T, R = cfg.R;
  const int D = 2 * R + 1;
  const int TIE[4] = {2, 3, 0, 1};
  const size_t i = b * HW + c;

  int32_t* out = act + i * 7;
  for (int k = 0; k < 7; ++k) out[k] = 0;
  if (typ == T) return;                       // nullop
  const int x = c % W, y = c / W;
  const int t = tidx(cfg, s.utype[i]);
  const int tx = tile % W, ty = tile / W;
  const int dx = tx - x, dy = ty - y;
  const int man = abs(dx) + abs(dy);
  unsigned fb = 0, ab = 0;                    // free, own-base neighbours
  int nb[4];
  int mn = INF_I;
  for (int d = 0; d < 4; ++d) {
    fb |= nb_has(fl, H, W, x, y, d, C_PASS) ? 1u << d : 0u;
    ab |= nb_has(fl, H, W, x, y, d, C_BASE) ? 1u << d : 0u;
    nb[d] = nb_dist(dist, H, W, x, y, d, H + W);
    mn = min(mn, nb[d]);
  }
  int best_dir = -1, best_gain = 0, mdir_b = -1;
  const int lim = min(mn, H + W) + 1;
  for (int k = 0; k < 4; ++k) {
    const int d = TIE[k];
    const int gain = man - (abs(dx - dir_dx(d)) + abs(dy - dir_dy(d)));
    if (((fb >> d) & 1) && gain > best_gain) { best_dir = d; best_gain = gain; }
    if (((fb >> d) & 1) && nb[d] < lim && mdir_b < 0) mdir_b = d;
  }
  const bool can_step = best_dir >= 0;
  const int adj_dir = (dx == 0 && dy == -1) ? 0 : (dx == 1 && dy == 0) ? 1
                      : (dx == 0 && dy == 1) ? 2 : (dx == -1 && dy == 0) ? 3
                      : -1;
  const int rng = cfg.attack_range[t];
  const bool in_rng = dx * dx + dy * dy <= rng * rng && man > 0;
  const int rel = clampi((R + dy) * D + (R + dx), 0, D * D - 1);
  const bool carrying = s.carried[i] > 0;
  const bool immobile = !cfg.can_move[t];
  const bool harvester = cfg.can_harvest[t] != 0;
  const bool attacker = cfg.can_attack[t] != 0;
  const int typc = clampi(typ, 0, T);
  const bool typ_movable = typc < T && cfg.can_move[typc];
  const bool free_any = fb != 0;
  const int tdir = first_bit(fb);
  const int ptype = clampi(typ, 0, T - 1);
  const bool afford = bal >= cfg.cost[ptype];
  const bool tgt_res = (fl[tile] & C_RES) != 0;
  const bool tgt_en = (fl[tile] & C_ENEMY) != 0;

  // 1. buildings train movable types
  if (immobile && typ_movable && free_any && afford) {
    put_col(out, A_PRODUCE, 4, tdir);
    out[5] = ptype;
  }
  // 2. harvesters
  const bool h = harvester && !immobile;
  if (h && tgt_res && !carrying) {
    if (adj_dir >= 0) put_col(out, A_HARVEST, 2, adj_dir);
    else if (can_step) put_col(out, A_MOVE, 1, best_dir);
  }
  if (h && tgt_res && carrying) {
    if (ab != 0) put_col(out, A_RETURN, 3, first_bit(ab));
    else if (mdir_b >= 0) put_col(out, A_MOVE, 1, mdir_b);
  }
  if (h && !tgt_res && tgt_en && attacker) {
    if (in_rng) put_col(out, A_ATTACK, 6, rel);
    else if (can_step) put_col(out, A_MOVE, 1, best_dir);
  }
  if (h && !tgt_res && !tgt_en && !typ_movable && free_any && afford) {
    put_col(out, A_PRODUCE, 4, tdir);
    out[5] = ptype;
  }
  if (h && !tgt_res && !tgt_en && typ_movable && can_step)
    put_col(out, A_MOVE, 1, best_dir);
  // 3. movers
  const bool m = !harvester && !immobile;
  if (m && tgt_en && attacker) {
    if (in_rng) put_col(out, A_ATTACK, 6, rel);
    else if (can_step) put_col(out, A_MOVE, 1, best_dir);
  }
  if (m && !tgt_en && can_step) put_col(out, A_MOVE, 1, best_dir);
}

__global__ void cooperative_kernel(Cfg cfg, StateP s, int me0,
                                   const int32_t* players, const float* nets,
                                   int32_t* act) {
  extern __shared__ unsigned char smem[];
  const int H = cfg.H, W = cfg.W, HW = H * W, T = cfg.T;
  const int NO = HW + T + 1;
  const size_t b = blockIdx.x;
  const int me = players != nullptr ? players[b] : me0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned char* p = smem;
  uint8_t* fl = carve<uint8_t>(p, HW);
  int* bufa = carve<int>(p, HW);
  int* bufb = carve<int>(p, HW);
  const int bal = s.resources[2 * b + (me == 1 ? 1 : 0)];

  for (int c = threadIdx.x; c < HW; c += blockDim.x) {
    const size_t i = b * HW + c;
    const int ut = s.utype[i], ow = s.owner[i];
    const int t = tidx(cfg, ut);
    const bool ex = ut > 0;
    const bool mine = ex && ow == me;
    uint8_t f = 0;
    if (s.terrain[i] == 0 && !ex) f |= C_PASS;
    if (mine && cfg.is_stockpile[t]) f |= C_BASE;
    if (ex && cfg.is_resource[t]) f |= C_RES;
    if (ex && ow >= 0 && ow != me) f |= C_ENEMY;
    if (mine && !s.busy[i]) f |= C_IDLE;
    fl[c] = f;
  }
  __syncthreads();
  const uint8_t src = C_BASE;
  int* cur[1] = {bufa};
  int* nxt[1] = {bufb};
  distance_fields<uint8_t>(1, &src, cur, nxt, fl, (uint8_t)C_PASS, H, W,
                           H + W);
  const int* dist = cur[0];

  for (int c = threadIdx.x; c < HW; c += blockDim.x)
    if (!(fl[c] & C_IDLE))
      for (int k = 0; k < 7; ++k) act[(b * HW + c) * 7 + k] = 0;

  const float NEG_INF = __int_as_float(0xff800000);
  for (int c = warp; c < HW; c += nwarps) {
    if (!(fl[c] & C_IDLE)) continue;
    const size_t i = b * HW + c;
    const float* o = nets + i * NO;
    float bv = NEG_INF;
    int bi = INF_I;
    for (int k = lane; k < HW; k += 32)
      if (o[k] > bv) { bv = o[k]; bi = k; }
    const int tile = warp_first_max(bv, bi);
    bv = NEG_INF;
    bi = INF_I;
    if (lane <= T) { bv = o[HW + lane]; bi = lane; }
    const int typ = warp_first_max(bv, bi);
    if (lane == 0)
      compile_action(cfg, s, b, c, tile, typ, bal, fl, dist, act);
    __syncwarp();
  }
}

// players int32 [B] or null (me0 for every env); nets float32 [B, H*W,
// H*W + T + 1] (the per-type networks' output, selected by cell type);
// act int32 [B, H, W, 7] out.
extern "C" int cooperative_act_launch(const Cfg* cfg, const StateP* s,
                                      int batch, int me0,
                                      const int32_t* players,
                                      const float* nets, int32_t* act,
                                      void* stream) {
  const int HW = cfg->H * cfg->W;
  const size_t smem = carve_bytes(HW) + carve_bytes(4 * HW) * 2 + 16;
  cudaError_t e = allow_smem(cooperative_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  if (batch == 0) return 0;
  cooperative_kernel<<<batch, block_threads(HW), smem,
                       (cudaStream_t)stream>>>(*cfg, *s, me0, players, nets,
                                               act);
  return (int)cudaGetLastError();
}
