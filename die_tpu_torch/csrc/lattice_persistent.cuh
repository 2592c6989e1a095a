// lattice_persistent.cuh: the one step kernel of every step form, for a
// lockstep batch of envs, f32 [B, W, H] per state field (W, H powers of 2),
// templated on the lattice (N directions) and the turn rule (FAM), with
// p.K inner steps an item.  Its one entry point (lattice_step.cu) takes
// the rule from the launch's family word and launches every form:
//   K1: the Jones step, K = 1
//   K3: a learned rule, K = 1 (wide and ctx: a turn pass, then the step)
//   K4: the Jones step or a learned rule, K >= 1
// At K = 1 the fused form runs K1's schedule exactly; the one-step forms
// are the fused form's layout at K = 1 (keys [B, 1, 2], flow_t [B, 1], the
// gain [1, B, W, H], the count [B, 1]).
//
// Bound on an H100: bytes for the Jones rule and the small learned rules.
// A step reads 5 fields and writes 5 fields plus the gain field, 44 bytes a
// cell (plus the flow field, 4 more, when it is given), against a few
// hundred fp32/int operations a cell; the wide and ctx rules add two or
// three probe trios, h*(14..21) multiply-adds and, for ctx, 63 tap
// multiply-adds a cell, which brings them toward the fp32 operation bound.
// The fused form (K steps a launch) moves 4 * (10 + K) bytes a cell; the
// margin's redundant work, ((tile + 2 K r) / tile)^2 of the tile's, is what
// it pays for the bytes it saves.
//
// Design, for this card.  An item is a (tile, env): its tile plus a torus
// halo of h = K * r cells (r the one-step influence radius: the rule's
// turn reach, 2 hops, the diffusion radius; learned_halo_radius in
// fast/cuda_step.py).  Taken apart on the card (tools/step_split.py,
// PERF.md), one block per item spent most of its time on loads that
// nothing overlapped, on a region 2-4 times its tile.  Here:
// - A persistent grid: one 512-thread block an SM walks the items with a
//   static stride, env-major, so neighbouring blocks share halo rows in L2.
// - The five input fields of the next item, and env b's rule params (at
//   most kMaxParams floats; consecutive items of a block are other envs),
//   land by cp.async in a second buffer while the block computes the
//   current item; a wait_group and a barrier stand before use.  Where two
//   buffers do not fit beside the tile, one does (a larger tile, less halo
//   work a cell, ran faster than a second buffer), and the next item lands
//   in it from the moment the last pass has read its inputs (the second
//   diffusion axis, or the end of a turn pass).  The region's column
//   start and width are rounded out to 4 floats (hc = h rounded up), so
//   every 16-byte copy is one aligned quad inside one torus row; where that
//   does not fit, or H < 4, or a state is not 16-byte aligned, the host
//   plans 4-byte copies (cw = 1) at the exact margin.  The phases compute
//   on the true region only.
// - Pass k of an item's K steps runs over the region still valid (from
//   margin k * r inwards) and writes the state back in place in the item's
//   input buffer, which the next item's prefetch never touches; pass k
//   writes its gain field and its exact count over the tile; the last pass
//   stores the tile.
// - Each pass hashes every cell's murmur or threefry bits once, under its
//   own key, and keeps them in a shared field for the move, update and
//   birth phases; its flow time or flow field is its own.
// - The turned heading overwrites the heading in place (a cell reads only
//   its own), so five work fields (code, acc, inf, tmp, bits) stand beside
//   one or two buffers of the inputs, reproduction included: its birth
//   code lives in tmp, its parent food over the bits the winner has read.
//   The ctx rule keeps its (left, fwd, right) probes in acc, inf and tmp
//   during the turn phase, where they are free.
// - Each phase walks its rectangle with coordinates stepped by the block
//   size; a probe, the cell a heading points at and a winner's food are one
//   shared load each through a table of neighbour offsets.  The params'
//   rows are padded to 4 floats, so an MLP unit's weights are 16-byte loads.
// - The wide and ctx rules reach twice as far as the others, so at halo 17
//   (16 directions) only a 32x32 tile fits and the turn phase runs their
//   MLP on 2.4 times the tile's cells.  Their one step (K3) launches
//   a turn pass (MODE kTurnPass: the tile's turned headings to a scratch
//   field, the halo the rule's reach) and then the step (kTurned) reading
//   the turned heading in place of the heading, at the later phases' halo
//   (9) on a 32x64 tile: on the card 1.53 (wide) and 1.70 (ctx) times
//   faster than the one kernel, for 24 more bytes a cell (the pass reads
//   the five inputs and writes the heading).
// The host chooses the tile, copy width, buffers and grid (fast/
// cuda_step.py::step_plan); the entry refuses a plan that does not fit.
// Arithmetic is the plain twin's, term for term: no FMA contraction
// (--fmad=false), diffusion taps folded from -r to +r, axis 0 then axis 1,
// winner loops over d in order, bits from the cell's global flat index, an
// exact integer agent count (one atomic an item and pass).  The reward fold
// is tree_sum_2d.cu.
#pragma once
#include "lattice_step.cuh"

namespace {

constexpr int kStepThreads = 512;
constexpr int kInputs = 5;  // chem, occ, dir, agent_food, env_food
constexpr int kWork = 5;    // code, acc, inf, tmp, bits
// What a launch computes: the whole step; a turn pass (the learned rule's
// turned heading of every tile cell, to dirt_o; the halo is the rule's
// reach); or the step after a turn pass (the heading read is turned
// already: no turn phase, the halo of the later phases alone).
constexpr int kWhole = 0, kTurnPass = 1, kTurned = 2;

struct Plan {
  int RW, RS;      // region rows; row stride (tile cols + 2 hc)
  int hc, dv;      // column margin (h rounded up to cw); dv = hc - h
  int cw;          // floats a copy (4, or 1)
  int fs;          // floats a field (RW * RS)
  int np, cs, po;  // rule params: floats, row stride in shared memory
                   // (cols rounded up to 4), offset in a stage (16-byte
                   // aligned, after the inputs)
  int ss;          // floats a stage (inputs, params)
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

// The item's env, tile origin and field offset.
struct Item {
  int b, i0, j0;
  long long base;
};
__device__ __forceinline__ Item item_at(const Params& p, const Plan& g,
                                        int it) {
  Item t;
  t.b = it / g.tiles;
  const int tile = it - t.b * g.tiles;
  t.i0 = (tile / g.tiles_c) * p.tr;
  t.j0 = (tile % g.tiles_c) * p.tc;
  t.base = (long long)t.b << (p.lw + p.lh);
  return t;
}

// The rounded region of item it into stage d: kInputs fields, one copy of
// cw floats a (row, column group), then env b's rule params [rows, cols],
// 4 bytes a copy, into rows g.cs floats apart.
__device__ __forceinline__ void load_region(const Params& p, const Buffers& q,
                                            const Plan& g, int it, float* d) {
  const Item t = item_at(p, g, it);
  const float* src[kInputs] = {q.chem, q.occ, q.dir, q.afood, q.efood};
  for_rect(0, g.RW, 0, g.RS / g.cw, [&](int u, int jq) {
    const int gi = (t.i0 - p.halo + u) & (p.W - 1);
    const int gj = (t.j0 - g.hc + jq * g.cw) & (p.H - 1);
    const long long off = t.base + ((long long)gi << p.lh) + gj;
    const int e = u * g.RS + jq * g.cw;
#pragma unroll
    for (int f = 0; f < kInputs; ++f)
      cp_async(d + f * g.fs + e, src[f] + off, g.cw);
  });
  if (g.np) {
    const float* par = q.tparams + (long long)q.member[t.b] * g.np;
    for (int i = threadIdx.x; i < g.np; i += blockDim.x) {
      const int r = i / p.cols;
      cp_async(d + g.po + r * g.cs + (i - r * p.cols), par + i, 1);
    }
  }
  cp_commit();
}

// Pass k of item t: one step over the region valid from margin k * r (MODE:
// the whole step, its turn pass or the rest after it).  prefetch >= 0 (the
// last pass of a one-buffer plan): the item whose region this pass loads
// into its own buffer once it has read its inputs for the last time.
template <int N, int FAM, int MODE>
__device__ __forceinline__ void step_pass(const Params& p, const Buffers& q,
                                          const Plan& g, const Item& t, int k,
                                          float* in, float* work,
                                          const int* s_off, int* slots,
                                          int prefetch) {
  const int FS = g.fs;
  const int RS = g.RS;
  const long long base = t.base;
  const long long* key = q.keys + 2 * ((long long)t.b * p.K + k);
  const uint32_t k0 = (uint32_t)key[0];
  const uint32_t k1 = (uint32_t)key[1];
  const float rot = (float)(die::murmur_finalize(k0 ^ k1 ^ 0x9E3779B9u) &
                            (uint32_t)(N - 1));
  // the five inputs in their buffer (the state, written back in place by
  // every pass but the last), five work fields
  Region R;
  R.chem = in;
  R.occ = in + FS;
  R.dir = in + 2 * FS;
  R.af = in + 3 * FS;
  R.ef = in + 4 * FS;
  R.code = work;
  R.acc = work + FS;
  R.inf = work + 2 * FS;
  R.tmp = work + 3 * FS;
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(work + 4 * FS);
  R.bcode = R.tmp;
  R.pfood = work + 4 * FS;
  R.rs = RS;
  const float* s_par = in + g.po;  // the rule's params, rows g.cs apart
  const int h = p.halo;
  const int RWt = p.tr + 2 * h, RHt = p.tc + 2 * h;  // the true region
  const int hop = N == 16 ? 2 : 1;
  const int S = p.sense_dist;
  const int mb = k * p.step_halo;  // the margin this pass's inputs hold from
  const bool last = k + 1 == p.K;
  const long long gained_base = ((long long)k * p.B + t.b) << (p.lw + p.lh);
  // region cell (u, v) of the true region: shared index and global cell
  auto E = [&](int u, int v) { return u * RS + v + g.dv; };
  auto grow = [&](int u) { return (t.i0 - h + u) & (p.W - 1); };
  auto gcol = [&](int v) { return (t.j0 - h + v) & (p.H - 1); };
  // true-region cells from margin m inwards
  auto inner = [&](int m, auto f) { for_rect(m, RWt - m, m, RHt - m, f); };

  // ---- 1. sense + turn; the cell's bits, hashed once ----------------------
  // the reach is hop * S but for the wide and ctx rules, and 0 after a turn
  // pass (the heading read is turned already)
  const int m1 = mb + (MODE == kTurned ? 0
                       : FAM == kWide || FAM == kCtx ? p.reach
                                                     : hop * S);
  if (FAM == kCtx) {
    // pass A: the chem probes at sense_dist, kept for the neighbours' taps
    inner(mb + hop * S, [&](int u, int v) {
      const int e = E(u, v);
      probe<N>(R.chem, e, s_off, S, R.dir[e], &R.acc[e], &R.inf[e],
               &R.tmp[e]);
    });
    __syncthreads();
  }
  inner(m1, [&](int u, int v) {
    const int e = E(u, v);
    const float dirf = R.dir[e];
    if constexpr (MODE == kTurnPass) {
      // the tile's cells (the halo is the rule's reach): the turned heading
      const float turn =
          learned_turn<N, FAM>(p, R, e, s_off, s_par, g.cs, dirf);
      q.dirt_o[base + ((long long)grow(u) << p.lh) + gcol(v)] =
          mod_dirs<N>(dirf + turn);
    } else {
      const uint32_t rand = bits_at(p, k0, k1, grow(u), gcol(v));
      s_bits[e] = rand;
      if constexpr (MODE == kTurned) {
        R.code[e] = neighbour_code(dirf, R.occ[e]);
      } else {
        float turn;
        if constexpr (FAM == kJones) {
          float left, fwd, right;
          probe<N>(R.chem, e, s_off, S, dirf, &left, &fwd, &right);
          turn = jones_turn(left, fwd, right, rand);
        } else {
          turn = learned_turn<N, FAM>(p, R, e, s_off, s_par, g.cs, dirf);
        }
        set_heading<N>(R, e, dirf, R.occ[e], turn);
      }
    }
  });
  __syncthreads();
  // a turn pass ends here (the barrier closed it)
  if constexpr (MODE == kTurnPass) {
    if (prefetch >= 0) load_region(p, q, g, prefetch, in);
    return;
  }

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
  // M: the margin this pass's results are valid from (the tile in the last)
  const int M = mb + p.step_halo;
  if (p.agents_born) {
    inner(m3 + hop, [&](int u, int v) {
      const int e = E(u, v);
      birth_winner_cell<N>(R, e, prio_r<N>(p, rot, s_bits[e]));
    });
    __syncthreads();
    inner(M, [&](int u, int v) { birth_update_cell<N>(p, R, E(u, v), s_off); });
    __syncthreads();
  }

  // ---- 4-6. feed, lifecycle, food flow (cells from margin M) --------------
  int alive_count = 0;
  const float flow_t =
      p.flow_kind == kFlowWave ? q.flow_t[(long long)t.b * p.K + k] : 0.0f;
  const long long flow_base =
      ((p.flow_env_stride ? (long long)t.b * p.K : 0) + k) << (p.lw + p.lh);
  inner(M, [&](int u, int v) {
    const int e = E(u, v);
    const Fed o = feed_cell(p, R, e);
    const int gi = grow(u), gj = gcol(v);
    const long long cell = ((long long)gi << p.lh) + gj;
    const float env =
        flow_food(p, q, o.env, gi, gj, flow_t, flow_base + cell);
    if (last) {
      const long long gl = base + cell;
      q.occ_o[gl] = o.occ;
      q.dir_o[gl] = o.dir;
      q.afood_o[gl] = o.af;
      q.efood_o[gl] = env;
      q.gained_o[gained_base + cell] = o.gained * o.occ;
      alive_count += o.occ > 0.0f ? 1 : 0;
    } else {
      R.occ[e] = o.occ;
      R.dir[e] = o.dir;
      R.af[e] = o.af;
      R.ef[e] = env;
      // the pass's gain and count are the tile's cells only
      if (u >= h && u < h + p.tr && v >= h && v < h + p.tc) {
        q.gained_o[gained_base + cell] = o.gained * o.occ;
        alive_count += o.occ > 0.0f ? 1 : 0;
      }
    }
  });

  // ---- 7. diffuse (taps folded from -r to +r, axis 0 then axis 1) ---------
  // tmp takes the axis-0 pass on the rows from margin M, widened by r columns
  const int dr = (p.ntaps - 1) / 2;
  for_rect(M, RWt - M, M - dr, RHt - M + dr, [&](int u, int v) {
    const int e = E(u, v);
    R.tmp[e] = taps_at(p, R.chem, e, RS);
  });
  __syncthreads();
  // the inputs are read: the next item's region may land (axis 1 reads tmp)
  if (prefetch >= 0) load_region(p, q, g, prefetch, in);
  inner(M, [&](int u, int v) {
    const int e = E(u, v);
    const float c = taps_at(p, R.tmp, e, 1) * p.chem_keep;
    if (last)
      q.chem_o[base + ((long long)grow(u) << p.lh) + gcol(v)] = c;
    else
      R.chem[e] = c;
  });

  // ---- count: the exact agent count of the pass over the tile -------------
  // (its barrier also closes the pass: the next one reads what this one
  // wrote to shared memory, and the next item's prefetch lands in buffers
  // this one has done reading)
  count_add(alive_count, q.num_o + (long long)t.b * p.K + k, slots);
}

template <int N, int FAM, int MODE>
__global__ void __launch_bounds__(kStepThreads, 1)
    k_step(Params p, Buffers q, Plan g) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int slots[kStepThreads / 32];
  __shared__ int s_off[N];  // region offset of the neighbour in direction d
  fill_offsets<N>(s_off, g.RS);
  float* work = sm + g.stages * g.ss;
  int it = blockIdx.x;
  if (it < g.items) load_region(p, q, g, it, sm);
  for (int n = 0; it < g.items; ++n, it += gridDim.x) {
    const int next = it + gridDim.x;
    // two buffers: the next item loads into the other one now; one buffer:
    // the last pass loads it once it has read its inputs
    int prefetch = -1;
    if (g.stages == 2 && next < g.items) {
      load_region(p, q, g, next, sm + ((n + 1) & 1) * g.ss);
      cp_wait<1>();
    } else {
      cp_wait<0>();
      if (next < g.items) prefetch = next;
    }
    __syncthreads();
    const Item t = item_at(p, g, it);
    float* in = sm + (g.stages == 2 ? (n & 1) * g.ss : 0);
    for (int k = 0; k < p.K; ++k)
      step_pass<N, FAM, MODE>(p, q, g, t, k, in, work, s_off, slots,
                              g.stages == 1 && k + 1 == p.K ? prefetch : -1);
  }
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// A plan of the host (8 words w, fast/cuda_step.py::StepPlan.words): tile
// rows, tile cols, column margin, floats a copy, threads, blocks, input
// buffers, inner steps.  Sets p.tr, p.tc, p.K and the margin p.halo = K *
// p.step_halo; fills g; false where the plan does not fit the config, the
// mode (MODE of k_step), the field or shared memory.
inline bool plan_from(const int* w, int family, int n_dirs, int mode,
                      Params* pp, Plan* gg, int* threads, int* blocks,
                      size_t* smem) {
  Params& p = *pp;
  Plan& g = *gg;
  p.tr = w[0];
  p.tc = w[1];
  g.hc = w[2];
  g.cw = w[3];
  *threads = w[4];
  *blocks = w[5];
  g.stages = w[6];
  p.K = w[7];
  if (p.K < 1 || p.K > 64 || (mode != kWhole && p.K != 1)) return false;
  p.halo = p.K * p.step_halo;
  const int dr = (p.ntaps - 1) / 2;
  const int hop = n_dirs == 16 ? 2 : 1;
  const int hs = p.sense_dist * hop;
  const int reach = mode == kTurned        ? 0
                    : family == kWide      ? 2 * hs
                    : family == kCtx       ? (2 * hs > hs + 1 ? 2 * hs
                                                              : hs + 1)
                                           : hs;
  const int need = mode == kTurnPass ? reach
                   : p.agents_born && 4 * hop > 2 * hop + dr
                       ? reach + 4 * hop
                       : reach + 2 * hop + dr;
  if (!pow2(p.tr) || !pow2(p.tc) || p.W % p.tr || p.H % p.tc ||
      (g.cw != 4 && g.cw != 1) || (g.cw == 4 && p.H < 4) || g.hc < p.halo ||
      g.hc % g.cw || p.tc % g.cw || *threads < 32 || *threads % 32 ||
      *threads > kStepThreads || *blocks < 1 ||
      (g.stages != 1 && g.stages != 2) || p.reach != reach ||
      p.step_halo < need)
    return false;
  g.dv = g.hc - p.halo;
  g.RW = p.tr + 2 * p.halo;
  g.RS = p.tc + 2 * g.hc;
  g.fs = g.RW * g.RS;
  g.np = family == kJones || mode == kTurned ? 0 : p.rows * p.cols;
  g.cs = (p.cols + 3) / 4 * 4;
  g.po = (kInputs * g.fs + 3) / 4 * 4;
  g.ss = g.np ? g.po + p.rows * g.cs : kInputs * g.fs;
  g.tiles_c = p.H / p.tc;
  g.tiles = (p.W / p.tr) * g.tiles_c;
  if ((long long)g.tiles * p.B > 0x7fffffffLL) return false;
  g.items = g.tiles * p.B;
  *smem = ((size_t)g.stages * g.ss + (size_t)kWork * g.fs) * sizeof(float);
  return *smem <= (size_t)kMaxSmem;
}

// A launch's plan, checked, and its shape.
struct Launch {
  Params p;
  Plan g;
  int threads, blocks;
  size_t smem;
};

template <int N, int FAM, int MODE>
cudaError_t launch_step(const Launch& l, const Buffers& q, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      k_step<N, FAM, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (e != cudaSuccess) return e;
  k_step<N, FAM, MODE><<<l.blocks, l.threads, l.smem, st>>>(l.p, q, l.g);
  return cudaGetLastError();
}

// The rule's whole step for the lattice: kJones, or the learned family;
// with a turn pass (a learned rule's one step; wide and ctx), that pass,
// then the step after it, which reads the turned heading in place of the
// heading.
template <int N>
cudaError_t launch_rule(int family, const Launch& l, const Launch* turn,
                        const Buffers& q, cudaStream_t st) {
  if (turn) {
    const cudaError_t e =
        family == kWide ? launch_step<N, kWide, kTurnPass>(*turn, q, st)
                        : launch_step<N, kCtx, kTurnPass>(*turn, q, st);
    if (e != cudaSuccess) return e;
    Buffers after = q;
    after.dir = q.dirt_o;
    return launch_step<N, kJones, kTurned>(l, after, st);
  }
  switch (family) {
    case kJones: return launch_step<N, kJones, kWhole>(l, q, st);
    case kLinear: return launch_step<N, kLinear, kWhole>(l, q, st);
    case kMlp: return launch_step<N, kMlp, kWhole>(l, q, st);
    case kWide: return launch_step<N, kWide, kWhole>(l, q, st);
    default: return launch_step<N, kCtx, kWhole>(l, q, st);
  }
}

// The entry point's body: unpack, check the plans, launch the family's
// kernel.  ip[28] > 0 (a learned rule's one step; wide and ctx) says the
// plan ip[20..27] is the step after a turn pass whose plan is ip[28..35],
// and ptrs[17] is the turned heading's buffer [B, W, H]; plan_from refuses
// either plan at K != 1.
inline int run_entry(const long long* ptrs, const int* ip, const float* fp,
                     void* stream) {
  Launch l, t;
  Buffers q;
  int n_dirs, family;
  if (!unpack(ptrs, ip, fp, &l.p, &q, &n_dirs, &family) || family < kJones ||
      family > kCtx)
    return (int)cudaErrorInvalidValue;
  const bool split = ip[28] > 0;
  if (split) {
    if ((family != kWide && family != kCtx) || !q.dirt_o)
      return (int)cudaErrorInvalidValue;
    t.p = l.p;
    t.p.step_halo = l.p.reach;
    l.p.step_halo = l.p.halo - l.p.reach;
    l.p.reach = 0;
    if (!plan_from(ip + 28, family, n_dirs, kTurnPass, &t.p, &t.g,
                   &t.threads, &t.blocks, &t.smem))
      return (int)cudaErrorInvalidValue;
  }
  if (!plan_from(ip + 20, family, n_dirs, split ? kTurned : kWhole, &l.p,
                 &l.g, &l.threads, &l.blocks, &l.smem))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Launch* turn = split ? &t : nullptr;
  switch (n_dirs) {
    case 4: return (int)launch_rule<4>(family, l, turn, q, st);
    case 8: return (int)launch_rule<8>(family, l, turn, q, st);
    case 16: return (int)launch_rule<16>(family, l, turn, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
