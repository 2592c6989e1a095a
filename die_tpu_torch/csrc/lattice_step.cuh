// lattice_step.cuh: what the step kernels of the field-centric lattice
// engine share: the parameters and buffers of a launch, the direction
// tables, the cell bits, and the per-cell bodies of a step's phases (the
// turn rules, move, update, birth, feed, flow, diffusion taps, the exact
// count).  The one kernel that runs them, for every step form (K1, K3, K4),
// is lattice_persistent.cuh's; its four entry files instantiate it.
//
// The turn phase's reach is the rule's (turn_reach in fast/cuda_step.py):
// hop*sense_dist for Jones, linear and MLP; 2*hop*sense_dist for the wide
// rule's chem probes at 2*sense_dist; max(2*hop*S, hop*S + 1) for ctx,
// whose depthwise 3x3 taps read the probe fields of the neighbours.  The
// one-step halo is that reach plus the later phases' (learned_halo_radius),
// so no tile edge sees a value it did not compute.  The per-cell u32 bits
// are generated from the cell's global flat index row*H + col (murmur or
// threefry), halo cells included, so no bit field touches memory.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "contract.cuh"

namespace {

constexpr int kMaxTaps = 33;
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
  // inner steps an item, one step's halo r (halo = K * r, the margin)
  int K, step_halo;
};

struct Buffers {
  const float *occ, *dir, *afood, *efood, *chem;
  const long long* keys;  // [B, K, 2] u32 words
  const float* flow_t;    // [B, K] flow time (wave flow only)
  const float* flow_f;    // [K, W, H] or [B, K, W, H] flow field (field flow)
  const float* tparams;   // [P, rows, cols] rule params (learned rules)
  const int* member;      // [B] row of tparams for each env
  float *occ_o, *dir_o, *afood_o, *efood_o, *chem_o;
  float* gained_o;        // [K, B, W, H]
  int* num_o;             // [B, K], zeroed by the caller
  float* dirt_o;          // [B, W, H] the turned heading (a turn pass's)
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
// which is the reference's order one unit at a time.  P's rows are cs
// floats apart (cs a multiple of 4, at least NF + 1) and 16-byte aligned,
// so a unit's weights and bias are ceil((NF + 1) / 4) 16-byte loads.
template <int NF>
__device__ __forceinline__ float mlp_turn(const float* P, int cs,
                                          int dw_rows, int hidden,
                                          const float (&feat)[NF]) {
  constexpr int kQuads = (NF + 4) / 4;
  const float* head = P + (dw_rows + hidden) * cs;
  float l0 = head[hidden] * 1.0f;
  float l1 = head[cs + hidden] * 1.0f;
  float l2 = head[2 * cs + hidden] * 1.0f;
  for (int h = 0; h < hidden; ++h) {
    const float4* row = reinterpret_cast<const float4*>(P + (dw_rows + h) * cs);
    float w[4 * kQuads];
#pragma unroll
    for (int c = 0; c < kQuads; ++c) {
      const float4 v = row[c];
      w[4 * c] = v.x;
      w[4 * c + 1] = v.y;
      w[4 * c + 2] = v.z;
      w[4 * c + 3] = v.w;
    }
    float acc = w[NF] * 1.0f;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc = acc + w[f] * feat[f];
    const float a = hardtanh(acc);
    l0 = l0 + head[h] * a;
    l1 = l1 + head[cs + h] * a;
    l2 = l2 + head[2 * cs + h] * a;
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
// The step kernel (lattice_persistent.cuh) runs these bodies over its
// regions.

// The shared fields of a region, row stride rs.  Later phases reuse earlier
// fields in place, as noted.
struct Region {
  float* chem;   // chem, then chem + deposit
  float* occ;    // occ, then post-move, then final occ
  float* dir;    // dir, then the turned heading (a cell reads only its
                 // own), then post-move, then final dir
  float* af;     // agent_food, likewise
  float* ef;     // env_food
  float* code;   // neighbour code, then deposit mask
  float* acc;    // accepted code, then birth acceptance
  float* inf;    // incoming food, then received flag
  float* tmp;    // the diffusion's axis-0 pass
  float* bcode;  // birth code: tmp, written by the update, read by the
                 // birth winner and the birth update
  float* pfood;  // a child's parent food: the bits' field, written by the
                 // birth winner after it read the cell's own bits
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

// 1. A learned rule's turn of cell e (left, fwd, right: the chem probes
// at sense_dist, which the ctx rule keeps in acc, inf and tmp for its
// neighbours' taps); P the env's params [rows, cols] in shared memory,
// rows cs floats apart and 16-byte aligned (mlp_turn).
template <int N, int FAM>
__device__ __forceinline__ float learned_turn(const Params& p,
                                              const Region& R, int e,
                                              const int* off, const float* P,
                                              int cs, float dirf) {
  const int S = p.sense_dist;
  const float occ = R.occ[e];
  float left, fwd, right;
  if (FAM == kCtx) {
    left = R.acc[e];
    fwd = R.inf[e];
    right = R.tmp[e];
  } else {
    probe<N>(R.chem, e, off, S, dirf, &left, &fwd, &right);
  }
  if (FAM == kLinear) {
    const float feat[6] = {left, fwd, right, R.ef[e], R.af[e], R.chem[e]};
    float lg[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* row = P + a * cs;
      float acc = row[6] * 1.0f;
#pragma unroll
      for (int f = 0; f < 6; ++f) acc = acc + row[f] * feat[f];
      lg[a] = acc;
    }
    return decide(lg[0], lg[1], lg[2]);
  }
  if (FAM == kMlp) {
    const float feat[7] = {left, fwd, right, occ, R.af[e], R.ef[e],
                           R.chem[e]};
    return mlp_turn<7>(P, cs, 0, p.hidden, feat);
  }
  float fl, ff, fr, el, ef, er;
  probe<N>(R.chem, e, off, 2 * S, dirf, &fl, &ff, &fr);
  probe<N>(R.ef, e, off, S, dirf, &el, &ef, &er);
  if (FAM == kWide) {
    const float feat[13] = {left, fwd, right, fl,       ff,      fr,      el,
                            ef,   er,  occ,   R.af[e], R.ef[e], R.chem[e]};
    return mlp_turn<13>(P, cs, 0, p.hidden, feat);
  }
  const int C = cs;
  const int RS = R.rs;
  const float feat[20] = {left,
                          fwd,
                          right,
                          fl,
                          ff,
                          fr,
                          el,
                          ef,
                          er,
                          occ,
                          R.af[e],
                          R.ef[e],
                          R.chem[e],
                          depthwise3x3(R.acc, e, RS, P),
                          depthwise3x3(R.inf, e, RS, P + C),
                          depthwise3x3(R.tmp, e, RS, P + 2 * C),
                          depthwise3x3(R.occ, e, RS, P + 3 * C),
                          depthwise3x3(R.af, e, RS, P + 4 * C),
                          depthwise3x3(R.ef, e, RS, P + 5 * C),
                          depthwise3x3(R.chem, e, RS, P + 6 * C)};
  return mlp_turn<20>(P, C, 7, p.hidden, feat);
}

// 1. The neighbour code of a cell whose turned heading is dirt: the heading
// where an agent is (occ 1), -1 where none (occ 0).
__device__ __forceinline__ float neighbour_code(float dirt, float occ) {
  return dirt * occ - (1.0f - occ);
}

// 1. The turned heading of cell e and its neighbour code (the heading
// where an agent is, -1 where none).
template <int N>
__device__ __forceinline__ void set_heading(const Region& R, int e,
                                            float dirf, float occ,
                                            float turn) {
  const float dirt = mod_dirs<N>(dirf + turn);
  R.dir[e] = dirt;
  R.code[e] = neighbour_code(dirt, occ);
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
  const float dirt = R.dir[e];  // the turned heading
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
// (pfood).
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
  R.pfood[e] = born ? R.af[e + wo] : 0.0f;
}

// 2b. Parents split their food, children arrive (reads the neighbours of
// acc only).  The reference sums, over d, [birth_dir == d] * [acceptance
// of the neighbour at d == d]: one term can be 1, the rest are 0.  The
// cell's birth code is its birth direction where it is fertile (an agent
// whose food passed the threshold: the update's test on the same values),
// else -1.
template <int N>
__device__ __forceinline__ void birth_update_cell(const Params& p,
                                                  const Region& R, int e,
                                                  const int* off) {
  const float pm_occ = R.occ[e];
  const float pm_af = R.af[e];
  const float birth_dir = R.bcode[e];
  const bool fertile = birth_dir >= 0.0f;
  const bool spawned =
      fertile && R.acc[e + off[fertile ? (int)birth_dir : 0]] == birth_dir;
  const float bacc = R.acc[e];
  const bool born = bacc >= 0.0f;
  const float bornf = born ? 1.0f : 0.0f;
  const float b_windir = born ? bacc : 0.0f;
  float new_af = spawned ? pm_af * 0.5f : pm_af;
  new_af = new_af + bornf * R.pfood[e] * 0.5f;
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

// Unpacks the host's arrays (see die_lattice_step in lattice_step.cu for
// their layout) but the plan (ip[20..27], lattice_persistent.cuh's
// plan_from); returns false on a shape the kernel does not take.
inline bool unpack(const long long* ptrs, const int* ip, const float* fp,
                   Params* pp, Buffers* qq, int* n_dirs, int* family) {
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
  q.dirt_o = (float*)ptrs[17];
  return true;
}

}  // namespace
