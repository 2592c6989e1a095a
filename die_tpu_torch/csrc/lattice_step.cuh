// lattice_step.cuh: the tiled step kernel of the field-centric lattice
// engine for a lockstep batch of envs, f32 [B, W, H] per state field (W, H
// powers of 2), templated on the lattice (N directions) and on the turn
// rule (FAM), and the per-cell bodies of a step's phases, which the
// template and the Jones step kernel K1 (lattice_step.cu, a persistent
// double-buffered kernel of its own) both run.  One translation unit
// instantiates the template's one-step form:
//   lattice_step_learned.cu  FAM = kLinear, kMlp, kWide, kCtx: the learned
//                            rule of fast/learned.py::make_turn_rule (K3),
//                            replacing _multi_step_kernel_learned
// It takes an optional precomputed flow field (f32 [W, H] shared by the
// batch, or [B, W, H] per env), replacing _multi_step_kernel_perlin_learned
// (B3).  One step per launch (K = 1).  The plain twin is
// die_tpu_torch/fast/env.py::fast_step_full with the rule of
// die_tpu_torch/fast/learned.py; the two agree bit for bit.
//
// The same template with FUSED = true is the large-field kernel (K4),
// instantiated by lattice_step_fused.cu (Jones) and
// lattice_step_fused_learned.cu (learned): K steps per launch, replacing
// the banded kernel of make_pallas_banded_step.  Its notes follow the
// design below.
//
// Bound on an H100: bytes for the Jones rule and the small learned rules.
// A step reads 5 fields and writes 5 fields plus the gain field, 44 bytes a
// cell (plus the flow field, 4 more, when it is given), against a few
// hundred fp32/int operations a cell; the wide and ctx rules add two or
// three probe trios, h*(14..21) multiply-adds and, for ctx, 63 tap
// multiply-adds a cell, which brings them toward the fp32 operation bound.
//
// Design: one block per (2-D tile, env).  The block loads its tile plus a
// torus halo into shared memory (global indices wrap mod W and mod H), then
// runs the phases of the step over regions that shrink by each phase's
// reach:
//   sense+turn (reach) -> move winner (hop) -> update (hop)
//   [-> birth winner (hop) -> birth update] -> feed/lifecycle/flow
//   -> diffuse axis 0 -> diffuse axis 1 (x chem decay) on the tile,
// so device memory sees each input read once (plus the halo, mostly from
// L2) and each output written once.  The turn phase's reach is the rule's
// (turn_reach in fast/cuda_step.py): hop*sense_dist for Jones, linear and
// MLP; 2*hop*sense_dist for the wide rule's chem probes at 2*sense_dist;
// max(2*hop*S, hop*S + 1) for ctx, whose depthwise 3x3 taps read the probe
// fields of the neighbours.  The halo is that reach plus the later phases'
// (learned_halo_radius), so no tile edge sees a value it did not compute.
// The ctx rule runs its turn phase in two passes: the (left, fwd, right)
// probes over margin hop*S into three shared fields that are free during
// the turn phase, then the rule over margin reach; the block keeps ten
// shared fields (174 KB at halo 17 with 32x32 tiles).  The rule's params
// (at most kMaxParams floats) are copied once per block into shared memory
// and read by every thread as broadcasts.  The per-cell u32 bits are
// generated in-kernel from the cell's global flat index row*H + col
// (murmur or threefry), halo cells included, so no bit field touches
// memory.  The agent count is an exact integer sum (one atomic per block);
// the reward fold is the separate tree_sum_2d kernel, which keeps the
// reference's pairing order across the whole field.
//
// FUSED (K4): the block loads its tile plus a margin of K * r cells (r the
// one-step halo above) and loops over K steps with the state kept in shared
// memory.  Step k reads a region that is valid from margin k * r inwards and
// leaves one valid from margin (k + 1) * r, so every phase of step k, feed,
// lifecycle, flow and diffusion included, runs over tile + remaining margin
// and writes back to shared memory; the last step's region is the tile and
// goes to device memory.  Device memory sees each field read once and
// written once per launch, plus one gain field per inner step (folded by
// tree_sum_2d in the whole-field order, where the TPU kernel folds by band).
// Each inner step has its own key (bits and rotation of every region cell
// from its global index), its own flow time or flow field, and its own
// exact count over tile cells.  In place of the TPU kernel's row bands,
// double-buffered DMA and 8-row rounding stand 2-D tiles, an exact margin
// and the host's shared-memory fit check (fast/cuda_step.py), which refuses
// a (config, K, tile) that does not fit.  Bound: bytes, 4 * (10 + K) a cell;
// the margin's redundant work, ((tile + 2 K r) / tile)^2 of the tile's, is
// what the fusion pays for the bytes it saves.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "contract.cuh"

namespace {

constexpr int kMaxTaps = 33;
constexpr int kThreads = 512;          // the template's block
constexpr int kTile = 32;              // its largest tile side (one step)
constexpr int kFields = 10;            // shared-memory fields of the region
constexpr int kMaxSmem = 232448 - 1024;  // opt-in limit less static smem
constexpr int kMaxParams = 1024;       // floats of one env's rule params

// turn rules (make_turn_rule's families)
constexpr int kJones = 0, kLinear = 1, kMlp = 2, kWide = 3, kCtx = 4;
// flow kinds the kernel applies
constexpr int kFlowNone = 0, kFlowWave = 1, kFlowField = 2;

struct Params {
  int B, W, H, lw, lh;
  int tr, tc, halo, reach;  // tile rows/cols, halo radius, turn reach
  int threefry, per_cell_priority, randomize_on_block, agents_born,
      agents_die, food_infinite, flow_kind, sense_dist, ntaps;
  int flow_env_stride;      // 0: one flow field for the batch; 1: per env
  int rows, cols, hidden;   // rule params [rows, cols], hidden units
  float idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
      death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
      inv_wm1, inv_hm1;
  float taps[kMaxTaps];
  // fused form: inner steps a launch and one step's halo (halo = K * r)
  int K, step_halo;
};

struct Buffers {
  const float *occ, *dir, *afood, *efood, *chem;
  const long long* keys;  // [B, 2] u32 words; fused [B, K, 2]
  const float* flow_t;    // [B] flow time (wave flow only); fused [B, K]
  const float* flow_f;    // [W, H] or [B, W, H] flow field (field flow);
                          // fused [K, W, H] or [B, K, W, H]
  const float* tparams;   // [P, rows, cols] rule params (learned rules)
  const int* member;      // [B] row of tparams for each env
  float *occ_o, *dir_o, *afood_o, *efood_o, *chem_o;
  float* gained_o;        // [B, W, H]; fused [K, B, W, H]
  int* num_o;             // [B], zeroed by the caller; fused [B, K]
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

// The u32 bits of global cell (gi, gj) under the step key (k0, k1), from
// its flat index gi * H + gj.
__device__ __forceinline__ uint32_t bits_at(const Params& p, uint32_t k0,
                                            uint32_t k1, int gi, int gj) {
  const uint32_t count = ((uint32_t)gi << p.lh) | (uint32_t)gj;
  return p.threefry ? die::threefry_bits(k0, k1, count)
                    : die::murmur_bits(k0, k1, count);
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
  return bits_at(p, t.k0, t.k1, grow(p, t, u), gcol(p, t, v));
}

// The winner priority of a cell: its own bits' or the step's rotation.
template <int N>
__device__ __forceinline__ float prio_r(const Params& p, float rot,
                                        uint32_t rand) {
  if (!p.per_cell_priority) return rot;
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

// Calls f(u, v) for u in [u0, u1), v in [v0, v1), the block's threads in
// row-major order, each stepping its (u, v) by the block size (one divide,
// none an element).
template <typename F>
__device__ __forceinline__ void for_rect(int u0, int u1, int v0, int v1,
                                         F f) {
  const int w = v1 - v0;
  const int n = (u1 - u0) * w;
  const int T = blockDim.x;
  const int su = T / w, sv = T - su * w;
  int du = threadIdx.x / w;
  int dv = threadIdx.x - du * w;
  for (int e = threadIdx.x; e < n; e += T) {
    f(u0 + du, v0 + dv);
    du += su;
    dv += sv;
    if (dv >= w) {
      dv -= w;
      ++du;
    }
  }
}

// The direction a heading selects: d for a heading equal to d in
// {0..N-1}, else -1 (NaN, out of range, not an integer).
template <int N>
__device__ __forceinline__ int heading(float dirf) {
  const int d = (int)dirf;
  return (dirf == (float)d && d >= 0 && d < N) ? d : -1;
}

// Fills off[d] (shared, N entries) with the region offset of the neighbour
// in direction d, for a region of row stride rs; a barrier must follow.
template <int N>
__device__ __forceinline__ void fill_offsets(int* off, int rs) {
  if (threadIdx.x < N)
    off[threadIdx.x] = off_row<N>(threadIdx.x) * rs + off_col<N>(threadIdx.x);
}

// (left, fwd, right) probes of a shared field at dist cells along the
// heading dirf (probe_trio): fwd reads direction dirf, left dirf + 1, right
// dirf - 1, one shared load each through the offsets off; a heading
// outside {0..N-1} reads nothing and leaves 0.
template <int N>
__device__ __forceinline__ void probe(const float* s, int e, const int* off,
                                      int dist, float dirf, float* left,
                                      float* fwd, float* right) {
  const int d = heading<N>(dirf);
  float l = 0.0f, f = 0.0f, r = 0.0f;
  if (d >= 0) {
    f = s[e + dist * off[d]];
    l = s[e + dist * off[(d + 1) % N]];
    r = s[e + dist * off[(d + N - 1) % N]];
  }
  *left = l;
  *fwd = f;
  *right = r;
}

// hardtanh as min(max(x, -1), 1) with NaN kept (np.maximum/np.minimum
// propagate NaN; fmaxf/fminf would drop it); -0.0 stays -0.0.
__device__ __forceinline__ float hardtanh(float x) {
  const float y = x < -1.0f ? -1.0f : x;
  return y > 1.0f ? 1.0f : y;
}

// The pinned tie chain keep >= left >= right: turn right (-1) iff
// l_right > max(l_keep, l_left) (false when either is NaN, as a NaN max
// compares false), else left (+1) iff l_left > l_keep, else keep (0).
__device__ __forceinline__ float decide(float l_left, float l_keep,
                                        float l_right) {
  const bool right_wins = (l_right > l_keep) && (l_right > l_left);
  return right_wins ? -1.0f : (l_left > l_keep ? 1.0f : 0.0f);
}

// The per-cell MLP: hidden hardtanh units over NF features, then three
// logits.  Each unit's sum starts from its bias times 1 and adds w*f in
// feature order; each logit adds its weight times unit h in unit order,
// which is the reference's order one unit at a time.
template <int NF>
__device__ __forceinline__ float mlp_turn(const float* P, int cols,
                                          int dw_rows, int hidden,
                                          const float (&feat)[NF]) {
  const float* head = P + (dw_rows + hidden) * cols;
  float l0 = head[hidden] * 1.0f;
  float l1 = head[cols + hidden] * 1.0f;
  float l2 = head[2 * cols + hidden] * 1.0f;
  for (int h = 0; h < hidden; ++h) {
    const float* row = P + (dw_rows + h) * cols;
    float acc = row[NF] * 1.0f;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc = acc + row[f] * feat[f];
    const float a = hardtanh(acc);
    l0 = l0 + head[h] * a;
    l1 = l1 + head[cols + h] * a;
    l2 = l2 + head[2 * cols + h] * a;
  }
  return decide(l0, l1, l2);
}

// Depthwise 3x3 torus tap sum of one shared field at e with the taps of
// params row c (du-major from (-1, -1)); the first term is the accumulator.
__device__ __forceinline__ float depthwise3x3(const float* s, int e, int RH,
                                              const float* taps) {
  float acc = taps[0] * s[e - RH - 1];
  int k = 1;
#pragma unroll
  for (int du = -1; du <= 1; ++du)
#pragma unroll
    for (int dv = -1; dv <= 1; ++dv) {
      if (du == -1 && dv == -1) continue;
      acc = acc + taps[k] * s[e + du * RH + dv];
      ++k;
    }
  return acc;
}

// Adds the block's exact count of live cells to *dst: warp sums into
// slots (shared, a warp each), one atomic.  Its barrier also closes the
// pass: every thread has done its reads of the step's shared fields.
__device__ __forceinline__ void count_add(int c, int* dst, int* slots) {
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += slots[w];
    if (total) atomicAdd(dst, total);
  }
}

// ---- The phases of a step, one cell each --------------------------------
// Both step kernels (the template below and K1 in lattice_step.cu) run
// these bodies over their regions; the kernels differ in what surrounds
// them (loads, margins, where the bits come from, stores).

// The shared fields of a region, row stride rs.  Later phases reuse earlier
// fields in place, as noted.
struct Region {
  float* chem;   // chem, then chem + deposit
  float* occ;    // occ, then post-move, then final occ
  float* dir;    // dir, then post-move, then final dir
  float* af;     // agent_food, likewise
  float* ef;     // env_food
  float* dirt;   // the turned heading (may be dir itself: a cell reads only
                 // its own)
  float* code;   // neighbour code, then deposit mask
  float* acc;    // accepted code, then birth acceptance
  float* inf;    // incoming food, then received flag
  float* tmp;    // parent food (birth), then the diffusion's axis-0 pass
  float* bcode;  // birth code (may be dirt: read after the update only)
  int rs;
};

// The Jones rule: keep the heading if fwd is no less than either side,
// else turn toward the larger side, a tie broken by the cell's bit 0.
__device__ __forceinline__ float jones_turn(float left, float fwd,
                                            float right, uint32_t rand) {
  const bool keep = (fwd >= left) && (fwd >= right);
  const float rand_sign = (float)(rand & 1u) * 2.0f - 1.0f;
  return keep ? 0.0f
              : (left > right ? 1.0f : (right > left ? -1.0f : rand_sign));
}

// 1. The turned heading of cell e and its neighbour code (the heading
// where an agent is, -1 where none).
template <int N>
__device__ __forceinline__ void set_heading(const Region& R, int e,
                                            float dirf, float occ,
                                            float turn) {
  const float dirt = mod_dirs<N>(dirf + turn);
  R.dirt[e] = dirt;
  R.code[e] = dirt * occ - (1.0f - occ);
}

// 2. The move winner of cell e among the agents that point at it (code d
// from the neighbour opposite d; scores from -r up, wrapped at N, the lowest
// wins, d in order), accepted where e is empty: its heading (acc, -1 where
// none) and its food (inf).
template <int N>
__device__ __forceinline__ void move_cell(const Region& R, int e, float r) {
  const float nf = (float)N;
  const bool empty = R.occ[e] <= 0.0f;
  float best = 0.0f + nf, winner = 0.0f;
  int wo = 0;  // the winner's offset
  float s = mod_dirs<N>(-r);
#pragma unroll
  for (int d = 0; d < N; ++d) {
    const int opp = (d + N / 2) % N;
    const int o = off_row<N>(opp) * R.rs + off_col<N>(opp);
    if (R.code[e + o] == (float)d && s < best) {
      winner = (float)d;
      wo = o;
      best = s;
    }
    if (d + 1 < N) {
      const float s1 = s + 1.0f;
      s = (s1 == nf) ? 0.0f : s1;
    }
  }
  const bool received = (best < nf) && empty;
  R.acc[e] = received ? winner : -1.0f;
  // the incoming food, read by the update of a cell that received only
  R.inf[e] = received ? R.af[e + wo] : 0.0f;
}

// 3. The update of cell e: moves resolved (an agent moved if the cell its
// heading points at accepted that heading; direction 0 for a heading
// outside {1..N-1}), the deposit, and the birth proposal.
template <int N>
__device__ __forceinline__ void update_cell(const Params& p, const Region& R,
                                            int e, const int* off,
                                            uint32_t bits) {
  const float occ = R.occ[e];
  const float dirt = R.dirt[e];
  const float acc = R.acc[e];
  const bool empty = occ <= 0.0f;
  const bool received = acc >= 0.0f;
  const int hd = heading<N>(dirt);
  const float acc_sel = R.acc[e + off[hd > 0 ? hd : 0]];
  const bool moved = !empty && (acc_sel == dirt);
  const bool blocked = !empty && !moved;
  uint32_t pr, block, birth;
  carve<N>(bits, &pr, &block, &birth);
  const float stay = (p.randomize_on_block && blocked) ? (float)block : dirt;
  const float new_occ = received ? 1.0f : (moved ? 0.0f : occ);
  const float new_dir = received ? acc : (moved ? 0.0f : stay);
  const float new_af = received ? R.inf[e] : (moved ? 0.0f : R.af[e]);
  const float dep_mask =
      received ? 1.0f : (moved ? 0.0f : occ * p.idle_deposit);
  R.occ[e] = new_occ;
  R.dir[e] = new_dir;
  R.af[e] = new_af;
  R.code[e] = dep_mask;
  R.inf[e] = received ? 1.0f : 0.0f;
  R.chem[e] = R.chem[e] + p.deposit_coef * R.ef[e] * dep_mask;
  if (p.agents_born) {
    const float fert =
        (new_occ > 0.0f && new_af > p.birth_threshold) ? 1.0f : 0.0f;
    R.bcode[e] = (float)birth * fert - (1.0f - fert);
  }
}

// 2b. The birth winner of cell e among the children proposed to it, as the
// move winner: its direction (acc, -1 where none) and its parent's food
// (tmp).
template <int N>
__device__ __forceinline__ void birth_winner_cell(const Region& R, int e,
                                                  float r) {
  const float nf = (float)N;
  const bool post_empty = R.occ[e] <= 0.0f;
  float b_best = 0.0f + nf, b_win = 0.0f;
  int wo = 0;  // the winning parent's offset
#pragma unroll
  for (int d = 0; d < N; ++d) {
    const int opp = (d + N / 2) % N;
    const int o = off_row<N>(opp) * R.rs + off_col<N>(opp);
    const bool cand = (R.bcode[e + o] == (float)d) && post_empty;
    const float score = cand ? mod_dirs<N>((float)d - r) : nf;
    if (score < b_best) {
      b_win = (float)d;
      wo = o;
      b_best = score;
    }
  }
  const bool born = b_best < nf;
  R.acc[e] = born ? b_win : -1.0f;
  R.tmp[e] = born ? R.af[e + wo] : 0.0f;
}

// 2b. Parents split their food, children arrive (reads the neighbours of
// acc only).  The reference sums, over d, [birth_dir == d] * [acceptance
// of the neighbour at d == d]: one term can be 1, the rest are 0.
template <int N>
__device__ __forceinline__ void birth_update_cell(const Params& p,
                                                  const Region& R, int e,
                                                  const int* off,
                                                  uint32_t bits) {
  const float pm_occ = R.occ[e];
  const float pm_af = R.af[e];
  uint32_t pr, block, birth;
  carve<N>(bits, &pr, &block, &birth);
  const float birth_dir = (float)birth;
  const bool fertile = pm_occ > 0.0f && pm_af > p.birth_threshold;
  const bool spawned = fertile && R.acc[e + off[birth]] == birth_dir;
  const float bacc = R.acc[e];
  const bool born = bacc >= 0.0f;
  const float bornf = born ? 1.0f : 0.0f;
  const float b_windir = born ? bacc : 0.0f;
  float new_af = spawned ? pm_af * 0.5f : pm_af;
  new_af = new_af + bornf * R.tmp[e] * 0.5f;
  R.af[e] = new_af;
  R.dir[e] = R.dir[e] * (1.0f - bornf) + b_windir * bornf;
  R.occ[e] = pm_occ + bornf;
}

// 4-5. Feed and lifecycle of cell e: the agent's new state, the env food
// before the flow, the agent's gain.
struct Fed {
  float occ, dir, af, env, gained;
};
__device__ __forceinline__ Fed feed_cell(const Params& p, const Region& R,
                                         int e) {
  Fed o;
  o.occ = R.occ[e];
  o.dir = R.dir[e];
  o.af = R.af[e];
  const float efood = R.ef[e];
  const float deposit = p.deposit_coef * efood * R.code[e];
  const float consumed = p.rate_feed * efood * o.occ;
  o.env = efood;
  if (!p.food_infinite) o.env = o.env - consumed;
  const float cost = p.cost_deposit * deposit + p.cost_move * R.inf[e];
  o.gained = consumed - cost * o.occ;
  o.af = o.af + o.gained;
  if (p.agents_die) {
    const float dead = o.occ * (o.af <= p.death_threshold ? 1.0f : 0.0f);
    const float alive = 1.0f - dead;
    o.occ = o.occ * alive;
    o.dir = o.dir * alive;
    o.af = o.af * alive;
  }
  return o;
}

// 6. The food flow at global cell (gi, gj): the wave at time t, or the
// flow field's value at index fi.
__device__ __forceinline__ float flow_food(const Params& p, const Buffers& q,
                                           float env, int gi, int gj,
                                           float t, long long fi) {
  if (p.flow_kind == kFlowWave)
    return p.flow_scale * wave_field(p, gi, gj, t) + p.flow_keep * env;
  if (p.flow_kind == kFlowField)
    return p.flow_scale * q.flow_f[fi] + p.flow_keep * env;
  return env;
}

// 7. One axis of the diffusion at e (stride: the row stride for axis 0, 1
// for axis 1), its taps folded from -r to +r.
__device__ __forceinline__ float taps_at(const Params& p, const float* s,
                                         int e, int stride) {
  const int dr = (p.ntaps - 1) / 2;
  float acc = p.taps[0] * s[e - dr * stride];
  for (int k = 1; k < p.ntaps; ++k)
    acc = acc + p.taps[k] * s[e + (k - dr) * stride];
  return acc;
}

// Two blocks an SM for the fused Jones form (K4: at the default config's
// halo 7 its 46x46 one-step region fits twice in shared memory), which caps
// it at 64 registers a thread; one for the learned rules, whose larger
// halos leave room for one block only.
template <int N, int FAM, bool FUSED>
__global__ void __launch_bounds__(kThreads, FAM != kJones ? 1 : 2)
    k_lattice_step(Params p, Buffers q) {
  extern __shared__ float sm[];
  __shared__ int slots[kThreads / 32];
  __shared__ int s_off[N];  // region offset of the neighbour in direction d
  Tile t;
  t.b = blockIdx.y;
  const int tiles_c = p.H / p.tc;
  t.i0 = (blockIdx.x / tiles_c) * p.tr;
  t.j0 = (blockIdx.x % tiles_c) * p.tc;
  t.RW = p.tr + 2 * p.halo;
  t.RH = p.tc + 2 * p.halo;
  if (!FUSED) {
    t.k0 = (uint32_t)q.keys[2 * t.b];
    t.k1 = (uint32_t)q.keys[2 * t.b + 1];
    t.rot = (float)(die::murmur_finalize(t.k0 ^ t.k1 ^ 0x9E3779B9u) &
                    (uint32_t)(N - 1));
  }
  const int RC = t.RW * t.RH;
  const int RW = t.RW, RH = t.RH;
  fill_offsets<N>(s_off, RH);
  // region fields (Region notes their reuse); the ctx rule keeps its
  // (left, fwd, right) probes in acc, inf and tmp during the turn phase
  Region R;
  R.chem = sm;
  R.occ = sm + RC;
  R.dir = sm + 2 * RC;
  R.af = sm + 3 * RC;
  R.ef = sm + 4 * RC;  // fused: then after the flow
  R.dirt = sm + 5 * RC;
  R.bcode = R.dirt;
  R.code = sm + 6 * RC;
  R.acc = sm + 7 * RC;
  R.inf = sm + 8 * RC;
  R.tmp = sm + 9 * RC;
  R.rs = RH;
  float* s_par = sm + kFields * RC;  // rule params [rows, cols]
  const long long base = (long long)t.b << (p.lw + p.lh);
  const int hop = N == 16 ? 2 : 1;
  const int S = p.sense_dist;

  for_rect(0, RW, 0, RH, [&](int u, int v) {
    const long long g =
        base + ((long long)grow(p, t, u) << p.lh) + gcol(p, t, v);
    const int e = u * RH + v;
    R.chem[e] = q.chem[g];
    R.occ[e] = q.occ[g];
    R.dir[e] = q.dir[g];
    R.af[e] = q.afood[g];
    R.ef[e] = q.efood[g];
  });
  if (FAM != kJones) {
    const int np = p.rows * p.cols;
    const float* src = q.tparams + (long long)q.member[t.b] * np;
    for (int i = threadIdx.x; i < np; i += blockDim.x) s_par[i] = src[i];
  }
  __syncthreads();

  // One pass of the loop is one step.  The one-step form runs it once with
  // mb = 0 and writes device memory; the fused form runs it K times, step k
  // over the region still valid (from margin mb = k * r inwards), and writes
  // device memory in the last pass only.
  const int steps = FUSED ? p.K : 1;
  for (int k = 0; k < steps; ++k) {
    const int mb = FUSED ? k * p.step_halo : 0;
    const bool last = !FUSED || k + 1 == steps;
    if (FUSED) {
      const long long* key = q.keys + 2 * ((long long)t.b * p.K + k);
      t.k0 = (uint32_t)key[0];
      t.k1 = (uint32_t)key[1];
      t.rot = (float)(die::murmur_finalize(t.k0 ^ t.k1 ^ 0x9E3779B9u) &
                      (uint32_t)(N - 1));
    }
    // region cells from margin m inwards
    auto inner = [&](int m, auto f) { for_rect(m, RW - m, m, RH - m, f); };

    // ---- 1. sense + turn --------------------------------------------------
    // the reach is hop * S but for the wide and ctx rules; written so, the
    // compiler sees it as such (the margins follow from it)
    const int m1 = mb + (FAM == kWide || FAM == kCtx ? p.reach : hop * S);
    if (FAM == kCtx) {
      // pass A: the chem probes at sense_dist, kept for the neighbours' taps
      inner(mb + hop * S, [&](int u, int v) {
        const int e = u * RH + v;
        probe<N>(R.chem, e, s_off, S, R.dir[e], &R.acc[e], &R.inf[e],
                 &R.tmp[e]);
      });
      __syncthreads();
    }
    inner(m1, [&](int u, int v) {
      const int e = u * RH + v;
      const float occ = R.occ[e];
      const float dirf = R.dir[e];
      float left, fwd, right;
      if (FAM == kCtx) {
        left = R.acc[e];
        fwd = R.inf[e];
        right = R.tmp[e];
      } else {
        probe<N>(R.chem, e, s_off, S, dirf, &left, &fwd, &right);
      }
      float turn;
      if (FAM == kJones) {
        turn = jones_turn(left, fwd, right, cell_bits(p, t, u, v));
      } else if (FAM == kLinear) {
        const float feat[6] = {left, fwd, right, R.ef[e], R.af[e], R.chem[e]};
        float lg[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* row = s_par + a * p.cols;
          float acc = row[6] * 1.0f;
#pragma unroll
          for (int f = 0; f < 6; ++f) acc = acc + row[f] * feat[f];
          lg[a] = acc;
        }
        turn = decide(lg[0], lg[1], lg[2]);
      } else if (FAM == kMlp) {
        const float feat[7] = {left, fwd, right, occ, R.af[e], R.ef[e],
                               R.chem[e]};
        turn = mlp_turn<7>(s_par, p.cols, 0, p.hidden, feat);
      } else {
        float fl, ff, fr, el, ef, er;
        probe<N>(R.chem, e, s_off, 2 * S, dirf, &fl, &ff, &fr);
        probe<N>(R.ef, e, s_off, S, dirf, &el, &ef, &er);
        if (FAM == kWide) {
          const float feat[13] = {left, fwd, right, fl, ff, fr, el, ef, er,
                                  occ, R.af[e], R.ef[e], R.chem[e]};
          turn = mlp_turn<13>(s_par, p.cols, 0, p.hidden, feat);
        } else {
          const float* c = s_par;
          const int C = p.cols;
          const float feat[20] = {
              left, fwd, right, fl, ff, fr, el, ef, er, occ, R.af[e],
              R.ef[e], R.chem[e],
              depthwise3x3(R.acc, e, RH, c),
              depthwise3x3(R.inf, e, RH, c + C),
              depthwise3x3(R.tmp, e, RH, c + 2 * C),
              depthwise3x3(R.occ, e, RH, c + 3 * C),
              depthwise3x3(R.af, e, RH, c + 4 * C),
              depthwise3x3(R.ef, e, RH, c + 5 * C),
              depthwise3x3(R.chem, e, RH, c + 6 * C)};
          turn = mlp_turn<20>(s_par, C, 7, p.hidden, feat);
        }
      }
      set_heading<N>(R, e, dirf, occ, turn);
    });
    __syncthreads();

    // ---- 2. move: winner among incoming candidates ------------------------
    const int m2 = m1 + hop;
    inner(m2, [&](int u, int v) {
      move_cell<N>(R, u * RH + v, prio_r<N>(p, t.rot, cell_bits(p, t, u, v)));
    });
    __syncthreads();

    // ---- 3. update: moves resolved, deposit; birth proposal ---------------
    const int m3 = m2 + hop;
    inner(m3, [&](int u, int v) {
      update_cell<N>(p, R, u * RH + v, s_off, cell_bits(p, t, u, v));
    });
    __syncthreads();

    // the margin this step's results are valid from: the tile in the one-step
    // form and in the fused form's last pass
    const int M = FUSED ? mb + p.step_halo : p.halo;
    if (p.agents_born) {
      // ---- 2b. reproduction: winner among proposed children ---------------
      inner(m3 + hop, [&](int u, int v) {
        birth_winner_cell<N>(R, u * RH + v,
                             prio_r<N>(p, t.rot, cell_bits(p, t, u, v)));
      });
      __syncthreads();
      inner(M, [&](int u, int v) {
        birth_update_cell<N>(p, R, u * RH + v, s_off, cell_bits(p, t, u, v));
      });
      __syncthreads();
    }

    // ---- 4-6. feed, lifecycle, food flow (cells from margin M) ------------
    int alive_count = 0;
    const float flow_t = p.flow_kind == kFlowWave
                             ? q.flow_t[FUSED ? t.b * p.K + k : t.b]
                             : 0.0f;
    const long long flow_base =
        FUSED ? ((p.flow_env_stride ? (long long)t.b * p.K : 0) + k)
                    << (p.lw + p.lh)
              : (p.flow_env_stride ? (long long)t.b << (p.lw + p.lh) : 0);
    const long long gained_base =
        FUSED ? ((long long)k * p.B + t.b) << (p.lw + p.lh) : base;
    inner(M, [&](int u, int v) {
      const int e = u * RH + v;
      const Fed o = feed_cell(p, R, e);
      const int gi = grow(p, t, u), gj = gcol(p, t, v);
      const long long cell = ((long long)gi << p.lh) + gj;
      const float env = flow_food(p, q, o.env, gi, gj, flow_t,
                                  flow_base + cell);
      if (last) {
        const long long g = base + cell;
        q.occ_o[g] = o.occ;
        q.dir_o[g] = o.dir;
        q.afood_o[g] = o.af;
        q.efood_o[g] = env;
        q.gained_o[gained_base + cell] = o.gained * o.occ;
        alive_count += o.occ > 0.0f ? 1 : 0;
      } else {
        R.occ[e] = o.occ;
        R.dir[e] = o.dir;
        R.af[e] = o.af;
        R.ef[e] = env;
        // the step's gain and count are the tile's cells only
        if (u >= p.halo && u < p.halo + p.tr && v >= p.halo &&
            v < p.halo + p.tc) {
          q.gained_o[gained_base + cell] = o.gained * o.occ;
          alive_count += o.occ > 0.0f ? 1 : 0;
        }
      }
    });

    // ---- 7. diffuse (taps folded from -r to +r, axis 0 then axis 1) -------
    // tmp takes the axis-0 pass on the rows from margin M, widened by r
    // columns
    const int dr = (p.ntaps - 1) / 2;
    for_rect(M, RW - M, M - dr, RH - M + dr, [&](int u, int v) {
      const int e = u * RH + v;
      R.tmp[e] = taps_at(p, R.chem, e, RH);
    });
    __syncthreads();
    inner(M, [&](int u, int v) {
      const int e = u * RH + v;
      const float c = taps_at(p, R.tmp, e, 1) * p.chem_keep;
      if (last)
        q.chem_o[base + ((long long)grow(p, t, u) << p.lh) + gcol(p, t, v)] =
            c;
      else
        R.chem[e] = c;
    });

    // exact agent count of this step (its barrier also closes the pass: the
    // next one reads what this one wrote to shared memory)
    count_add(alive_count, q.num_o + (FUSED ? t.b * p.K + k : t.b), slots);
  }
}

// The one-step launch of the learned rules (K3; the Jones step is K1,
// lattice_step.cu).
template <int N, int FAM>
cudaError_t launch(Params p, const Buffers& q, cudaStream_t st) {
  static_assert(FAM != kJones, "the one-step Jones kernel is K1");
  // the largest tile (at most kTile x kTile, halved until its region and
  // the rule params fit in shared memory)
  const size_t par = (size_t)p.rows * p.cols;
  for (int k = 1; k <= 8; k *= 2) {
    p.tr = kTile / k < p.W ? kTile / k : p.W;
    p.tc = kTile / k < p.H ? kTile / k : p.H;
    if (p.tr < 1 || p.tc < 1) break;
    const size_t smem = ((size_t)kFields * (p.tr + 2 * p.halo) *
                             (p.tc + 2 * p.halo) +
                         par) *
                        sizeof(float);
    if (smem > (size_t)kMaxSmem) continue;
    const cudaError_t e = cudaFuncSetAttribute(
        k_lattice_step<N, FAM, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((p.W / p.tr) * (p.H / p.tc)), (unsigned)p.B);
    k_lattice_step<N, FAM, false><<<grid, kThreads, smem, st>>>(p, q);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// The fused launch (K4): K steps, the tile the host chose (fast/cuda_step.py
// ::choose_tile); a region that does not fit is refused, never shrunk here.
template <int N, int FAM>
cudaError_t launch_fused(const Params& p, const Buffers& q, cudaStream_t st) {
  const size_t par = FAM == kJones ? 0 : (size_t)p.rows * p.cols;
  if (p.K < 1 || p.tr < 1 || p.tc < 1 || p.W % p.tr || p.H % p.tc ||
      p.halo != p.K * p.step_halo)
    return cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kFields * (p.tr + 2 * p.halo) * (p.tc + 2 * p.halo) + par) *
      sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      k_lattice_step<N, FAM, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((p.W / p.tr) * (p.H / p.tc)), (unsigned)p.B);
  k_lattice_step<N, FAM, true><<<grid, kThreads, smem, st>>>(p, q);
  return cudaGetLastError();
}

// Unpacks the host's arrays (see die_lattice_step in lattice_step.cu for
// their layout; the fused form's ip has three more entries, see
// lattice_step_fused.cu); returns false on a shape the kernel does not take.
inline bool unpack(const long long* ptrs, const int* ip, const float* fp,
                   Params* pp, Buffers* qq, int* n_dirs, int* family,
                   bool fused = false) {
  Params& p = *pp;
  p.B = ip[0];
  p.W = ip[1];
  p.H = ip[2];
  if (p.B < 1 || p.W < 2 || p.H < 2 || (p.W & (p.W - 1)) ||
      (p.H & (p.H - 1)))
    return false;
  p.lw = __builtin_ctz((unsigned)p.W);
  p.lh = __builtin_ctz((unsigned)p.H);
  *n_dirs = ip[3];
  p.threefry = ip[4];
  p.per_cell_priority = ip[5];
  p.randomize_on_block = ip[6];
  p.agents_born = ip[7];
  p.agents_die = ip[8];
  p.food_infinite = ip[9];
  p.flow_kind = ip[10];
  p.sense_dist = ip[11];
  p.ntaps = ip[12];
  p.halo = ip[13];
  p.reach = ip[14];
  p.flow_env_stride = ip[15];
  *family = ip[16];
  p.rows = ip[17];
  p.cols = ip[18];
  p.hidden = ip[19];
  p.K = 1;
  p.step_halo = p.halo;
  if (fused) {
    p.K = ip[20];
    p.tr = ip[21];
    p.tc = ip[22];
    if (p.K < 1) return false;
    p.halo = p.K * p.step_halo;
  }
  if (p.ntaps < 1 || p.ntaps > kMaxTaps || p.halo < 0 || p.reach < 0 ||
      p.reach > p.step_halo || p.flow_kind < kFlowNone ||
      p.flow_kind > kFlowField)
    return false;
  if (*family != kJones &&
      (p.rows < 1 || p.cols < 1 || p.rows * p.cols > kMaxParams ||
       p.hidden < 0))
    return false;
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

  Buffers& q = *qq;
  q.occ = (const float*)ptrs[0];
  q.dir = (const float*)ptrs[1];
  q.afood = (const float*)ptrs[2];
  q.efood = (const float*)ptrs[3];
  q.chem = (const float*)ptrs[4];
  q.keys = (const long long*)ptrs[5];
  q.flow_t = (const float*)ptrs[6];
  q.flow_f = (const float*)ptrs[7];
  q.tparams = (const float*)ptrs[8];
  q.member = (const int*)ptrs[9];
  q.occ_o = (float*)ptrs[10];
  q.dir_o = (float*)ptrs[11];
  q.afood_o = (float*)ptrs[12];
  q.efood_o = (float*)ptrs[13];
  q.chem_o = (float*)ptrs[14];
  q.gained_o = (float*)ptrs[15];
  q.num_o = (int*)ptrs[16];
  return true;
}

}  // namespace
