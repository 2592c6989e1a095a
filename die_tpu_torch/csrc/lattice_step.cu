// lattice_step: one full step of the field-centric lattice engine for a
// lockstep batch of envs, f32 [B, W, H] per state field (W, H powers of 2).
//
// Replaces die_tpu/fast/pallas_step.py::_multi_step_kernel (body
// _multi_step_kernel_body, launched by make_pallas_multi_step through
// pl.pallas_call), one step per launch (K = 1).  Its plain twin is
// die_tpu_torch/fast/env.py::fast_step_full; the two agree bit for bit.
//
// Bound on an H100: bytes.  A step reads 5 fields and writes 5 fields plus
// the gain field, 44 bytes a cell, against a few hundred fp32/int
// operations a cell (below the card's 67 TFLOP/s fp32 rate over 3.35 TB/s).
//
// Design: one block per (2-D tile, env).  The block loads its tile plus a
// torus halo of halo_radius(dyn) cells on every side into shared memory
// (global indices wrap mod W and mod H), then runs the phases of the step
// over regions that shrink by each phase's reach:
//   sense+turn (hop*sense_dist) -> move winner (hop) -> update (hop)
//   [-> birth winner (hop) -> birth update] -> feed/lifecycle/flow
//   -> diffuse axis 0 -> diffuse axis 1 (x chem decay) on the tile,
// so device memory sees each input read once (plus the halo, mostly from
// L2) and each output written once.  Intermediates live in shared memory;
// the price is the halo's recomputation (a 32x32 tile at radius 7 works
// on 46x46 cells).  The per-cell u32 bits are generated in-kernel from the
// cell's global flat index row*H + col (murmur or threefry), halo cells
// included, so no bit field touches memory.  The agent count is an exact
// integer sum (one atomic per block); the reward fold is the separate
// tree_sum_2d kernel, which keeps the reference's pairing order across the
// whole field.
#include <cuda_runtime.h>

#include <cstdint>

#include "contract.cuh"

namespace {

// Block shape: threads and the largest tile; -D overrides exist for
// measuring other shapes without editing the source.
#ifndef DIE_THREADS
#define DIE_THREADS 512
#endif
#ifndef DIE_TILE_ROWS
#define DIE_TILE_ROWS 32
#endif
#ifndef DIE_TILE_COLS
#define DIE_TILE_COLS 32
#endif

constexpr int kMaxTaps = 33;
constexpr int kThreads = DIE_THREADS;
constexpr int kFields = 10;            // shared-memory fields of the region
constexpr int kMaxSmem = 232448 - 1024;  // opt-in limit less static smem

struct Params {
  int B, W, H, lw, lh;
  int tr, tc, halo;  // tile rows/cols, halo radius
  int threefry, per_cell_priority, randomize_on_block, agents_born,
      agents_die, food_infinite, flow_wave, sense_dist, ntaps;
  float idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
      death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
      inv_wm1, inv_hm1;
  float taps[kMaxTaps];
};

struct Buffers {
  const float *occ, *dir, *afood, *efood, *chem;
  const long long* keys;  // [B, 2] u32 words
  const float* flow_t;    // [B] flow time (wave flow only)
  float *occ_o, *dir_o, *afood_o, *efood_o, *chem_o, *gained_o;
  int* num_o;             // [B], zeroed by the caller
};

// Direction tables: (row, col) offsets, counter-clockwise from East.
__constant__ int kOff4[4][2] = {{0, 1}, {-1, 0}, {0, -1}, {1, 0}};
__constant__ int kOff8[8][2] = {{0, 1},  {-1, 1}, {-1, 0}, {-1, -1},
                                {0, -1}, {1, -1}, {1, 0},  {1, 1}};
__constant__ int kOff16[16][2] = {
    {0, 1},  {-1, 2}, {-1, 1}, {-2, 1}, {-1, 0}, {-2, -1}, {-1, -1}, {-1, -2},
    {0, -1}, {1, -2}, {1, -1}, {2, -1}, {1, 0},  {2, 1},   {1, 1},   {1, 2}};

template <int N>
__device__ __forceinline__ int off_row(int d) {
  return N == 4 ? kOff4[d][0] : (N == 8 ? kOff8[d][0] : kOff16[d][0]);
}
template <int N>
__device__ __forceinline__ int off_col(int d) {
  return N == 4 ? kOff4[d][1] : (N == 8 ? kOff8[d][1] : kOff16[d][1]);
}

template <int N>
__device__ __forceinline__ float mod_dirs(float a) {
  return a - (float)N * floorf(a * (1.0f / (float)N));
}

// bit fields of one draw: (prio, block, birth)
template <int N>
__device__ __forceinline__ void carve(uint32_t rand, uint32_t* prio,
                                      uint32_t* block, uint32_t* birth) {
  if (N == 16) {
    *prio = (rand >> 1) & 15u;
    *block = (rand >> 5) & 15u;
    *birth = (rand >> 9) & 15u;
  } else {
    *prio = (rand >> 1) & 7u;
    *block = ((rand >> 4) & 7u) & (uint32_t)(N - 1);
    *birth = (rand >> 7) & (uint32_t)(N - 1);
  }
}

// The block's view: region cell (u, v) is global cell (grow, gcol) of env b.
struct Tile {
  int b, i0, j0;  // env and the tile's first global row/col
  int RW, RH;     // region rows/cols (tile + 2 * halo)
  uint32_t k0, k1;
  float rot;      // per-step scalar rotation (per-cell priority off)
};

__device__ __forceinline__ int grow(const Params& p, const Tile& t, int u) {
  return (t.i0 - p.halo + u) & (p.W - 1);
}
__device__ __forceinline__ int gcol(const Params& p, const Tile& t, int v) {
  return (t.j0 - p.halo + v) & (p.H - 1);
}

__device__ __forceinline__ uint32_t cell_bits(const Params& p, const Tile& t,
                                              int u, int v) {
  const uint32_t count =
      ((uint32_t)grow(p, t, u) << p.lh) | (uint32_t)gcol(p, t, v);
  return p.threefry ? die::threefry_bits(t.k0, t.k1, count)
                    : die::murmur_bits(t.k0, t.k1, count);
}

template <int N>
__device__ __forceinline__ float prio_r(const Params& p, const Tile& t,
                                        uint32_t rand) {
  if (!p.per_cell_priority) return t.rot;
  uint32_t prio, block, birth;
  carve<N>(rand, &prio, &block, &birth);
  float r = (float)prio;
  if (N < 8) r = mod_dirs<N>(r);
  return r;
}

__device__ float wave_field(const Params& p, int gi, int gj, float t) {
  const float pi = die::f32_bits(0x40490fdbu);
  const float c04pi = die::f32_bits(0x3fa0d97cu);
  const float x = ((float)gj * p.inv_hm1) * 2.0f - 1.0f;
  const float y = ((float)gi * p.inv_wm1) * 2.0f - 1.0f;
  const float r = die::c_sqrt(x * x + y * y);
  const float px = pi * x;
  const float py = pi * y;
  float sv, cv;
  die::c_sincos(px, &sv, &cv);
  const float cos_x = cv;
  die::c_sincos(c04pi * y, &sv, &cv);
  const float sin_04y = sv;
  const float rwave = r + cos_x + sin_04y;
  die::c_sincos(pi * (rwave + t), &sv, &cv);
  const float z_waves = cv;
  die::c_sincos(px * 3.0f + t, &sv, &cv);
  const float sin_ix = sv;
  die::c_sincos(py * 3.0f + t, &sv, &cv);
  const float cos_iy = cv;
  const float z_islands = sin_ix + cos_iy;
  return 0.75f * z_waves + 0.25f * z_islands;
}

// Calls f(u, v) for every region cell at least m cells inside the region.
template <typename F>
__device__ __forceinline__ void for_region(const Tile& t, int m, F f) {
  const int h = t.RH - 2 * m;
  const int n = (t.RW - 2 * m) * h;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int du = e / h;
    f(m + du, m + e - du * h);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    k_lattice_step(Params p, Buffers q) {
  extern __shared__ float sm[];
  Tile t;
  t.b = blockIdx.y;
  const int tiles_c = p.H / p.tc;
  t.i0 = (blockIdx.x / tiles_c) * p.tr;
  t.j0 = (blockIdx.x % tiles_c) * p.tc;
  t.RW = p.tr + 2 * p.halo;
  t.RH = p.tc + 2 * p.halo;
  t.k0 = (uint32_t)q.keys[2 * t.b];
  t.k1 = (uint32_t)q.keys[2 * t.b + 1];
  t.rot = (float)(die::murmur_finalize(t.k0 ^ t.k1 ^ 0x9E3779B9u) &
                  (uint32_t)(N - 1));
  const int RC = t.RW * t.RH;
  const int RH = t.RH;
  // region fields; later phases reuse earlier ones in place (noted below)
  float* s_chem = sm;           // chem, then chem + deposit
  float* s_occ = sm + RC;       // occ, then post-move, then final occ
  float* s_dir = sm + 2 * RC;   // dir, then post-move, then final dir
  float* s_af = sm + 3 * RC;    // agent_food, likewise
  float* s_ef = sm + 4 * RC;    // env_food (read only)
  float* s_dirt = sm + 5 * RC;  // turned heading, then birth code
  float* s_code = sm + 6 * RC;  // neighbour code, then deposit mask
  float* s_acc = sm + 7 * RC;   // accepted code, then birth acceptance
  float* s_inf = sm + 8 * RC;   // incoming food, then received flag
  float* s_tmp = sm + 9 * RC;   // parent food (birth), then diffusion
  const long long base = (long long)t.b << (p.lw + p.lh);
  const int hop = N == 16 ? 2 : 1;
  const int S = p.sense_dist;
  const float nf = (float)N;

  for_region(t, 0, [&](int u, int v) {
    const long long g =
        base + ((long long)grow(p, t, u) << p.lh) + gcol(p, t, v);
    const int e = u * RH + v;
    s_chem[e] = q.chem[g];
    s_occ[e] = q.occ[g];
    s_dir[e] = q.dir[g];
    s_af[e] = q.afood[g];
    s_ef[e] = q.efood[g];
  });
  __syncthreads();

  // ---- 1. sense + turn ------------------------------------------------------
  const int m1 = hop * S;
  for_region(t, m1, [&](int u, int v) {
    const int e = u * RH + v;
    const float occ = s_occ[e];
    const float dirf = s_dir[e];
    float fwd = 0.0f, left = 0.0f, right = 0.0f;
#pragma unroll
    for (int d = 0; d < N; ++d) {
      const bool is_f = dirf == (float)d;
      const bool is_l = dirf == (float)((d + N - 1) % N);
      const bool is_r = dirf == (float)((d + 1) % N);
      if (is_f || is_l || is_r) {
        const float pv =
            s_chem[e + off_row<N>(d) * S * RH + off_col<N>(d) * S];
        if (is_f) fwd = pv;
        if (is_l) left = pv;
        if (is_r) right = pv;
      }
    }
    const uint32_t rand = cell_bits(p, t, u, v);
    const bool keep = (fwd >= left) && (fwd >= right);
    const float rand_sign = (float)(rand & 1u) * 2.0f - 1.0f;
    const float turn =
        keep ? 0.0f
             : (left > right ? 1.0f : (right > left ? -1.0f : rand_sign));
    const float dirt = mod_dirs<N>(dirf + turn);
    s_dirt[e] = dirt;
    s_code[e] = dirt * occ - (1.0f - occ);
  });
  __syncthreads();

  // ---- 2. move: winner among incoming candidates ----------------------------
  const int m2 = m1 + hop;
  for_region(t, m2, [&](int u, int v) {
    const int e = u * RH + v;
    const bool empty = s_occ[e] <= 0.0f;
    const float r = prio_r<N>(p, t, cell_bits(p, t, u, v));
    float best = 0.0f + nf, winner = 0.0f, in_food = 0.0f;
    float s = mod_dirs<N>(-r);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      const int opp = (d + N / 2) % N;
      const int o = off_row<N>(opp) * RH + off_col<N>(opp);
      if (s_code[e + o] == (float)d && s < best) {
        winner = (float)d;
        in_food = s_af[e + o];
        best = s;
      }
      if (d + 1 < N) {
        const float s1 = s + 1.0f;
        s = (s1 == nf) ? 0.0f : s1;
      }
    }
    const bool received = (best < nf) && empty;
    s_acc[e] = received ? winner : -1.0f;
    s_inf[e] = in_food;
  });
  __syncthreads();

  // ---- 3. update: moves resolved, deposit; birth proposal --------------------
  // (reads its own cell of every field it overwrites; neighbours of s_acc)
  const int m3 = m2 + hop;
  for_region(t, m3, [&](int u, int v) {
    const int e = u * RH + v;
    const float occ = s_occ[e];
    const float dirt = s_dirt[e];
    const float acc = s_acc[e];
    const bool empty = occ <= 0.0f;
    const bool received = acc >= 0.0f;
    float acc_sel = s_acc[e + off_row<N>(0) * RH + off_col<N>(0)];
#pragma unroll
    for (int d = 1; d < N; ++d)
      if (dirt == (float)d)
        acc_sel = s_acc[e + off_row<N>(d) * RH + off_col<N>(d)];
    const bool moved = !empty && (acc_sel == dirt);
    const bool blocked = !empty && !moved;
    uint32_t prio, block, birth;
    carve<N>(cell_bits(p, t, u, v), &prio, &block, &birth);
    const float stay =
        (p.randomize_on_block && blocked) ? (float)block : dirt;
    const float new_occ = received ? 1.0f : (moved ? 0.0f : occ);
    const float new_dir = received ? acc : (moved ? 0.0f : stay);
    const float new_af = received ? s_inf[e] : (moved ? 0.0f : s_af[e]);
    const float dep_mask =
        received ? 1.0f : (moved ? 0.0f : occ * p.idle_deposit);
    s_occ[e] = new_occ;
    s_dir[e] = new_dir;
    s_af[e] = new_af;
    s_code[e] = dep_mask;
    s_inf[e] = received ? 1.0f : 0.0f;
    s_chem[e] = s_chem[e] + p.deposit_coef * s_ef[e] * dep_mask;
    if (p.agents_born) {
      const float fert =
          (new_occ > 0.0f && new_af > p.birth_threshold) ? 1.0f : 0.0f;
      s_dirt[e] = (float)birth * fert - (1.0f - fert);
    }
  });
  __syncthreads();

  const int R = p.halo;
  if (p.agents_born) {
    // ---- 2b. reproduction: winner among proposed children -------------------
    for_region(t, m3 + hop, [&](int u, int v) {
      const int e = u * RH + v;
      const bool post_empty = s_occ[e] <= 0.0f;
      const float r = prio_r<N>(p, t, cell_bits(p, t, u, v));
      float b_best = 0.0f + nf, b_win = 0.0f, b_pfood = 0.0f;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        const int opp = (d + N / 2) % N;
        const int o = off_row<N>(opp) * RH + off_col<N>(opp);
        const bool cand = (s_dirt[e + o] == (float)d) && post_empty;
        const float score = cand ? mod_dirs<N>((float)d - r) : nf;
        if (score < b_best) {
          b_win = (float)d;
          b_pfood = s_af[e + o];
          b_best = score;
        }
      }
      s_acc[e] = (b_best < nf) ? b_win : -1.0f;
      s_tmp[e] = b_pfood;
    });
    __syncthreads();
    // parents split their food, children arrive (tile cells; reads
    // neighbours of s_acc only)
    for_region(t, R, [&](int u, int v) {
      const int e = u * RH + v;
      const float pm_occ = s_occ[e];
      const float pm_af = s_af[e];
      uint32_t prio, block, birth;
      carve<N>(cell_bits(p, t, u, v), &prio, &block, &birth);
      const float birth_dir = (float)birth;
      const bool fertile = pm_occ > 0.0f && pm_af > p.birth_threshold;
      float spawned_f = 0.0f;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        const float b_acc_o = s_acc[e + off_row<N>(d) * RH + off_col<N>(d)];
        const float t2 = (birth_dir == (float)d ? 1.0f : 0.0f) *
                         (b_acc_o == (float)d ? 1.0f : 0.0f);
        spawned_f = d == 0 ? t2 : spawned_f + t2;
      }
      const bool spawned = fertile && spawned_f > 0.0f;
      const float bacc = s_acc[e];
      const bool born = bacc >= 0.0f;
      const float bornf = born ? 1.0f : 0.0f;
      const float b_windir = born ? bacc : 0.0f;
      float new_af = spawned ? pm_af * 0.5f : pm_af;
      new_af = new_af + bornf * s_tmp[e] * 0.5f;
      s_af[e] = new_af;
      s_dir[e] = s_dir[e] * (1.0f - bornf) + b_windir * bornf;
      s_occ[e] = pm_occ + bornf;
    });
    __syncthreads();
  }

  // ---- 4-6. feed, lifecycle, food flow (tile cells) --------------------------
  int alive_count = 0;
  const float flow_t = p.flow_wave ? q.flow_t[t.b] : 0.0f;
  for_region(t, R, [&](int u, int v) {
    const int e = u * RH + v;
    float new_occ = s_occ[e];
    float new_dir = s_dir[e];
    float new_af = s_af[e];
    const float efood = s_ef[e];
    const float deposit = p.deposit_coef * efood * s_code[e];
    const float consumed = p.rate_feed * efood * new_occ;
    float env = efood;
    if (!p.food_infinite) env = env - consumed;
    const float cost = p.cost_deposit * deposit + p.cost_move * s_inf[e];
    const float gained = consumed - cost * new_occ;
    new_af = new_af + gained;
    if (p.agents_die) {
      const float dead =
          new_occ * (new_af <= p.death_threshold ? 1.0f : 0.0f);
      const float alive = 1.0f - dead;
      new_occ = new_occ * alive;
      new_dir = new_dir * alive;
      new_af = new_af * alive;
    }
    const int gi = grow(p, t, u), gj = gcol(p, t, v);
    if (p.flow_wave) {
      const float f = wave_field(p, gi, gj, flow_t);
      env = p.flow_scale * f + p.flow_keep * env;
    }
    const long long g = base + ((long long)gi << p.lh) + gj;
    q.occ_o[g] = new_occ;
    q.dir_o[g] = new_dir;
    q.afood_o[g] = new_af;
    q.efood_o[g] = env;
    q.gained_o[g] = gained * new_occ;
    alive_count += new_occ > 0.0f ? 1 : 0;
  });

  // ---- 7. diffuse (taps folded from -r to +r, axis 0 then axis 1) ----------
  // s_tmp takes the axis-0 pass on the tile's rows, widened by r columns
  const int dr = (p.ntaps - 1) / 2;
  {
    const int h = p.tc + 2 * dr;
    const int n = p.tr * h;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int du = e / h;
      const int u = R + du, v = R - dr + (e - du * h);
      float acc = p.taps[0] * s_chem[(u - dr) * RH + v];
      for (int k = 1; k < p.ntaps; ++k)
        acc = acc + p.taps[k] * s_chem[(u + k - dr) * RH + v];
      s_tmp[u * RH + v] = acc;
    }
  }
  __syncthreads();
  for_region(t, R, [&](int u, int v) {
    const int e = u * RH + v;
    float acc = p.taps[0] * s_tmp[e - dr];
    for (int k = 1; k < p.ntaps; ++k)
      acc = acc + p.taps[k] * s_tmp[e + k - dr];
    const long long g =
        base + ((long long)grow(p, t, u) << p.lh) + gcol(p, t, v);
    q.chem_o[g] = acc * p.chem_keep;
  });

  // exact agent count: warp sums, then one atomic per block
  for (int off = 16; off > 0; off >>= 1)
    alive_count += __shfl_down_sync(0xffffffffu, alive_count, off);
  __shared__ int warp_counts[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = alive_count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    if (total) atomicAdd(q.num_o + t.b, total);
  }
}

template <int N>
cudaError_t launch(Params p, const Buffers& q, cudaStream_t st) {
  // the largest tile (at most DIE_TILE_ROWS x DIE_TILE_COLS, halved until
  // its region fits in shared memory)
  for (int k = 1; k <= 8; k *= 2) {
    p.tr = DIE_TILE_ROWS / k < p.W ? DIE_TILE_ROWS / k : p.W;
    p.tc = DIE_TILE_COLS / k < p.H ? DIE_TILE_COLS / k : p.H;
    if (p.tr < 1 || p.tc < 1) break;
    const size_t smem = (size_t)kFields * (p.tr + 2 * p.halo) *
                        (p.tc + 2 * p.halo) * sizeof(float);
    if (smem > (size_t)kMaxSmem) continue;
    const cudaError_t e = cudaFuncSetAttribute(
        k_lattice_step<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((p.W / p.tr) * (p.H / p.tc)), (unsigned)p.B);
    k_lattice_step<N><<<grid, kThreads, smem, st>>>(p, q);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// ptrs: occ, dir, agent_food, env_food, chem, keys, flow_t, occ_o, dir_o,
//   agent_food_o, env_food_o, chem_o, gained_o, num_o.
// ip: B, W, H, num_dirs, threefry, per_cell_priority, randomize_on_block,
//   agents_born, agents_die, food_infinite, flow_wave, sense_dist, ntaps,
//   halo.
// fp: idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
//   death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
//   inv_wm1, inv_hm1, taps[ntaps].
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step(const long long* ptrs, const int* ip,
                                const float* fp, void* stream) {
  Params p;
  p.B = ip[0];
  p.W = ip[1];
  p.H = ip[2];
  if (p.B < 1 || p.W < 2 || p.H < 2 || (p.W & (p.W - 1)) ||
      (p.H & (p.H - 1)))
    return (int)cudaErrorInvalidValue;
  p.lw = __builtin_ctz((unsigned)p.W);
  p.lh = __builtin_ctz((unsigned)p.H);
  const int n_dirs = ip[3];
  p.threefry = ip[4];
  p.per_cell_priority = ip[5];
  p.randomize_on_block = ip[6];
  p.agents_born = ip[7];
  p.agents_die = ip[8];
  p.food_infinite = ip[9];
  p.flow_wave = ip[10];
  p.sense_dist = ip[11];
  p.ntaps = ip[12];
  p.halo = ip[13];
  if (p.ntaps < 1 || p.ntaps > kMaxTaps || p.halo < 0)
    return (int)cudaErrorInvalidValue;
  p.idle_deposit = fp[0];
  p.deposit_coef = fp[1];
  p.rate_feed = fp[2];
  p.cost_move = fp[3];
  p.cost_deposit = fp[4];
  p.death_threshold = fp[5];
  p.birth_threshold = fp[6];
  p.flow_scale = fp[7];
  p.flow_keep = fp[8];
  p.chem_keep = fp[9];
  p.inv_wm1 = fp[10];
  p.inv_hm1 = fp[11];
  for (int k = 0; k < p.ntaps; ++k) p.taps[k] = fp[12 + k];

  Buffers q;
  q.occ = (const float*)ptrs[0];
  q.dir = (const float*)ptrs[1];
  q.afood = (const float*)ptrs[2];
  q.efood = (const float*)ptrs[3];
  q.chem = (const float*)ptrs[4];
  q.keys = (const long long*)ptrs[5];
  q.flow_t = (const float*)ptrs[6];
  q.occ_o = (float*)ptrs[7];
  q.dir_o = (float*)ptrs[8];
  q.afood_o = (float*)ptrs[9];
  q.efood_o = (float*)ptrs[10];
  q.chem_o = (float*)ptrs[11];
  q.gained_o = (float*)ptrs[12];
  q.num_o = (int*)ptrs[13];

  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_dirs) {
    case 4: return (int)launch<4>(p, q, st);
    case 8: return (int)launch<8>(p, q, st);
    case 16: return (int)launch<16>(p, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* die_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
