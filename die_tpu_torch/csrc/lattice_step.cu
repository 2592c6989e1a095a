// lattice_step (K1): one full step of the field-centric lattice engine with
// the Jones turn rule, for a lockstep batch of envs, f32 [B, W, H] per state
// field (W, H powers of 2), with flow none, wave (evaluated in-kernel) or a
// precomputed field (perlin).
//
// Replaces die_tpu/fast/pallas_step.py::_multi_step_kernel (body
// _multi_step_kernel_body, launched by make_pallas_multi_step through
// pl.pallas_call) and, with the flow field, _multi_step_kernel_perlin, one
// step per launch (K = 1).  Its plain twin is
// die_tpu_torch/fast/env.py::fast_step_full; the two agree bit for bit.
//
// Bound on an H100: bytes.  A step reads 5 fields and writes 5 fields plus
// the gain field, 44 bytes a cell (48 with a flow field), against a few
// hundred fp32/int operations a cell.
//
// Design, for this card.  A tile's step needs its tile plus a torus halo of
// h = halo_radius cells (sense reach + 2 hops + diffusion radius), so a
// block loads about twice the tile and runs the phases over regions that
// shrink by each phase's reach, a barrier between phases.  Taken apart on
// the card (tools/step_split.py, PERF.md), one block per (tile, env) spent
// 43% of its step on the loads and stores alone and 39% on phases 1-3, and
// the parts added up: nothing overlapped the loads.  Here:
// - A persistent grid: one block an SM walks the (tile, env) items with a
//   static stride, env-major, so neighbouring blocks share halo rows in L2.
//   512 threads a block: fewer threads with more registers each ran faster
//   than 1024 capped at 64 registers.
// - The five input fields of the next item land by cp.async in a second
//   buffer while the block computes the current one; a wait_group and a
//   barrier stand before use.  Where two buffers do not fit beside the
//   largest tile (32x64), one does: a larger tile, less halo work a cell,
//   ran faster than a second buffer.  The region's column start and width
//   are rounded out to 4 floats (hc = h rounded up), so every 16-byte copy
//   is one aligned quad inside one torus row (H is a power of two >= 4; a
//   field with H < 4, or a state not 16-byte aligned, copies 4 bytes).
//   The phases compute on the true region only.
// - Each phase walks its rectangle with coordinates stepped by the block
//   size (one divide a phase, none an element).
// - A cell's murmur or threefry bits are hashed once, in the sense phase,
//   and kept in a shared field for the move, update and birth phases.
// - A probe, the cell a heading points at and a winner's food are one
//   shared load each, through a table of neighbour offsets, not a select
//   over every direction.
// - The turned heading overwrites the heading in place (a cell reads only
//   its own), which frees a field: five work fields (six with
//   reproduction) beside one or two buffers of the five inputs.
// The per-cell bodies of the phases are lattice_step.cuh's, which the
// step template (K3, K4) runs as well.
// The host chooses the tile, buffers and grid (fast/cuda_step.py::
// step_plan); the entry refuses a plan that does not fit.  Arithmetic is
// the plain twin's, term for term: no FMA contraction (--fmad=false),
// diffusion taps folded from -r to +r, axis 0 then axis 1, winner loops
// over d in order, bits from the cell's global flat index, an exact integer
// agent count (one atomic an item).  The reward fold is tree_sum_2d.cu.
#include "lattice_step.cuh"

namespace {

constexpr int kStepThreads = 512;
constexpr int kInputs = 5;  // chem, occ, dir, agent_food, env_food

struct Plan {
  int RW, RS;      // region rows; row stride (tile cols + 2 hc)
  int hc, dv;      // column margin (h rounded up to cw); dv = hc - h
  int cw;          // floats a copy (4, or 1 where H < 4)
  int fs;          // floats a field (RW * RS)
  int tiles_c, tiles, items;
  int stages;      // input buffers: 2, the next item loads during this one
};

__device__ __forceinline__ void cp_async(float* s, const float* g, int cw) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  if (cw == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(g)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                 "l"(g)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The rounded region of item it into buffer d: kInputs fields, one copy of
// cw floats a (row, column group).
__device__ __forceinline__ void load_region(const Params& p, const Buffers& q,
                                            const Plan& g, int it, float* d) {
  const int b = it / g.tiles;
  const int tile = it - b * g.tiles;
  const int i0 = (tile / g.tiles_c) * p.tr;
  const int j0 = (tile % g.tiles_c) * p.tc;
  const long long base = (long long)b << (p.lw + p.lh);
  const float* src[kInputs] = {q.chem, q.occ, q.dir, q.afood, q.efood};
  for_rect(0, g.RW, 0, g.RS / g.cw, [&](int u, int jq) {
    const int gi = (i0 - p.halo + u) & (p.W - 1);
    const int gj = (j0 - g.hc + jq * g.cw) & (p.H - 1);
    const long long off = base + ((long long)gi << p.lh) + gj;
    const int e = u * g.RS + jq * g.cw;
#pragma unroll
    for (int f = 0; f < kInputs; ++f)
      cp_async(d + f * g.fs + e, src[f] + off, g.cw);
  });
  cp_commit();
}

template <int N>
__device__ __forceinline__ void step_item(const Params& p, const Buffers& q,
                                          const Plan& g, int it, float* in,
                                          float* work, const int* s_off,
                                          int* slots) {
  const int FS = g.fs;
  const int RS = g.RS;
  const int b = it / g.tiles;
  const int tile = it - b * g.tiles;
  const int i0 = (tile / g.tiles_c) * p.tr;
  const int j0 = (tile % g.tiles_c) * p.tc;
  const long long base = (long long)b << (p.lw + p.lh);
  const uint32_t k0 = (uint32_t)q.keys[2 * b];
  const uint32_t k1 = (uint32_t)q.keys[2 * b + 1];
  const float rot = (float)(die::murmur_finalize(k0 ^ k1 ^ 0x9E3779B9u) &
                            (uint32_t)(N - 1));
  // the five inputs in their buffer, five work fields (six with
  // reproduction); the turned heading overwrites the heading in place
  Region R;
  R.chem = in;
  R.occ = in + FS;
  R.dir = in + 2 * FS;
  R.af = in + 3 * FS;
  R.ef = in + 4 * FS;
  R.dirt = R.dir;
  R.code = work;
  R.acc = work + FS;
  R.inf = work + 2 * FS;
  R.tmp = work + 3 * FS;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(work + 4 * FS);
  R.bcode = work + 5 * FS;
  R.rs = RS;
  const int h = p.halo;
  const int RWt = p.tr + 2 * h, RHt = p.tc + 2 * h;  // the true region
  const int hop = N == 16 ? 2 : 1;
  const int S = p.sense_dist;
  // region cell (u, v) of the true region: shared index and global cell
  auto E = [&](int u, int v) { return u * RS + v + g.dv; };
  auto grow = [&](int u) { return (i0 - h + u) & (p.W - 1); };
  auto gcol = [&](int v) { return (j0 - h + v) & (p.H - 1); };
  // true-region cells from margin m inwards
  auto inner = [&](int m, auto f) { for_rect(m, RWt - m, m, RHt - m, f); };

  // ---- 1. sense + turn; the cell's bits, hashed once ----------------------
  const int m1 = hop * S;
  inner(m1, [&](int u, int v) {
    const int e = E(u, v);
    const float dirf = R.dir[e];
    float left, fwd, right;
    probe<N>(R.chem, e, s_off, S, dirf, &left, &fwd, &right);
    const uint32_t rand = bits_at(p, k0, k1, grow(u), gcol(v));
    s_bits[e] = rand;
    set_heading<N>(R, e, dirf, R.occ[e], jones_turn(left, fwd, right, rand));
  });
  __syncthreads();

  // ---- 2. move: winner among incoming candidates --------------------------
  const int m2 = m1 + hop;
  inner(m2, [&](int u, int v) {
    const int e = E(u, v);
    move_cell<N>(R, e, prio_r<N>(p, rot, s_bits[e]));
  });
  __syncthreads();

  // ---- 3. update: moves resolved, deposit; birth proposal -----------------
  const int m3 = m2 + hop;
  inner(m3, [&](int u, int v) {
    const int e = E(u, v);
    update_cell<N>(p, R, e, s_off, s_bits[e]);
  });
  __syncthreads();

  // ---- 2b. reproduction: winner among proposed children -------------------
  if (p.agents_born) {
    inner(m3 + hop, [&](int u, int v) {
      const int e = E(u, v);
      birth_winner_cell<N>(R, e, prio_r<N>(p, rot, s_bits[e]));
    });
    __syncthreads();
    inner(h, [&](int u, int v) {
      const int e = E(u, v);
      birth_update_cell<N>(p, R, e, s_off, s_bits[e]);
    });
    __syncthreads();
  }

  // ---- 4-6. feed, lifecycle, food flow (the tile) -------------------------
  int alive_count = 0;
  const float flow_t = p.flow_kind == kFlowWave ? q.flow_t[b] : 0.0f;
  const long long flow_base =
      p.flow_env_stride ? (long long)b << (p.lw + p.lh) : 0;
  inner(h, [&](int u, int v) {
    const Fed o = feed_cell(p, R, E(u, v));
    const int gi = grow(u), gj = gcol(v);
    const long long cell = ((long long)gi << p.lh) + gj;
    const long long gl = base + cell;
    q.occ_o[gl] = o.occ;
    q.dir_o[gl] = o.dir;
    q.afood_o[gl] = o.af;
    q.efood_o[gl] = flow_food(p, q, o.env, gi, gj, flow_t, flow_base + cell);
    q.gained_o[gl] = o.gained * o.occ;
    alive_count += o.occ > 0.0f ? 1 : 0;
  });

  // ---- 7. diffuse (taps folded from -r to +r, axis 0 then axis 1) ---------
  const int dr = (p.ntaps - 1) / 2;
  for_rect(h, h + p.tr, h - dr, h + p.tc + dr, [&](int u, int v) {
    const int e = E(u, v);
    R.tmp[e] = taps_at(p, R.chem, e, RS);
  });
  __syncthreads();
  inner(h, [&](int u, int v) {
    q.chem_o[base + ((long long)grow(u) << p.lh) + gcol(v)] =
        taps_at(p, R.tmp, E(u, v), 1) * p.chem_keep;
  });

  // ---- count: the exact agent count of the item ---------------------------
  count_add(alive_count, q.num_o + b, slots);
}

template <int N>
__global__ void __launch_bounds__(kStepThreads, 1)
    k_jones_step(Params p, Buffers q, Plan g) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int slots[kStepThreads / 32];
  __shared__ int s_off[N];  // region offset of the neighbour in direction d
  fill_offsets<N>(s_off, g.RS);
  float* work = sm + g.stages * kInputs * g.fs;
  int it = blockIdx.x;
  if (g.stages == 2 && it < g.items) load_region(p, q, g, it, sm);
  for (int n = 0; it < g.items; ++n, it += gridDim.x) {
    const int next = it + gridDim.x;
    if (g.stages == 1) {
      load_region(p, q, g, it, sm);
      cp_wait<0>();
    } else if (next < g.items) {
      load_region(p, q, g, next, sm + ((n + 1) & 1) * kInputs * g.fs);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    step_item<N>(p, q, g, it,
                 sm + (g.stages == 2 ? (n & 1) * kInputs * g.fs : 0), work,
                 s_off, slots);
  }
}

template <int N>
cudaError_t launch_jones(const Params& p, const Buffers& q, const Plan& g,
                         int threads, int blocks, size_t smem,
                         cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      k_jones_step<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  k_jones_step<N><<<blocks, threads, smem, st>>>(p, q, g);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// ptrs: occ, dir, agent_food, env_food, chem, keys, flow_t, flow_f,
//   tparams, member, occ_o, dir_o, agent_food_o, env_food_o, chem_o,
//   gained_o, num_o.
// ip: B, W, H, num_dirs, threefry, per_cell_priority, randomize_on_block,
//   agents_born, agents_die, food_infinite, flow_kind (0 none, 1 wave,
//   2 field), sense_dist, ntaps, halo, reach, flow_env_stride, family,
//   rows, cols, hidden, then the plan (fast/cuda_step.py::step_plan): tile
//   rows, tile cols, column margin, floats a copy, threads, blocks, input
//   buffers (2: the next item loads during this one; 1: each item loads
//   before its phases, other resident blocks covering the wait).
// fp: idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
//   death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
//   inv_wm1, inv_hm1, taps[ntaps].
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step(const long long* ptrs, const int* ip,
                                const float* fp, void* stream) {
  Params p;
  Buffers q;
  int n_dirs, family;
  if (!unpack(ptrs, ip, fp, &p, &q, &n_dirs, &family) || family != kJones)
    return (int)cudaErrorInvalidValue;
  p.tr = ip[20];
  p.tc = ip[21];
  Plan g;
  g.hc = ip[22];
  g.cw = ip[23];
  const int threads = ip[24], blocks = ip[25];
  g.stages = ip[26];
  const int dr = (p.ntaps - 1) / 2;
  const int hop = n_dirs == 16 ? 2 : 1;
  if (!pow2(p.tr) || !pow2(p.tc) || p.W % p.tr || p.H % p.tc ||
      (g.cw != 4 && g.cw != 1) || (g.cw == 4 && p.H < 4) || g.hc < p.halo ||
      g.hc % g.cw || p.tc % g.cw || threads < 32 || threads % 32 ||
      threads > kStepThreads || blocks < 1 ||
      (g.stages != 1 && g.stages != 2) || p.reach != p.sense_dist * hop ||
      p.halo < p.reach + 2 * hop + dr)
    return (int)cudaErrorInvalidValue;
  g.dv = g.hc - p.halo;
  g.RW = p.tr + 2 * p.halo;
  g.RS = p.tc + 2 * g.hc;
  g.fs = g.RW * g.RS;
  g.tiles_c = p.H / p.tc;
  g.tiles = (p.W / p.tr) * g.tiles_c;
  if ((long long)g.tiles * p.B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  g.items = g.tiles * p.B;
  const int fields = g.stages * kInputs + 5 + (p.agents_born ? 1 : 0);
  const size_t smem = (size_t)fields * g.fs * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_dirs) {
    case 4: return (int)launch_jones<4>(p, q, g, threads, blocks, smem, st);
    case 8: return (int)launch_jones<8>(p, q, g, threads, blocks, smem, st);
    case 16: return (int)launch_jones<16>(p, q, g, threads, blocks, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* die_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
