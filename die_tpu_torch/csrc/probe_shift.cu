// Torus shifts of whole 256x256 f32 fields, chained over rounds.
//
// die_probe_roll (P2, and P5's shift leg): `chains` chains per field (4: x +
//   i, P2; 1: x itself, P5's shift), each `rounds` times roll(c, shift,
//   axis) + 1, then their maximum (of one chain: the chain).  Replaces the
//   TPU probe `make_roll` of tools/tpu_measure.py (the pallas_call at :157)
//   and the `vpu` leg of `make_roll_kernel` of tools/tpu_mxu_offload.py
//   (:180), which is roll(x, 1, 0) + 1 on one chain.
// die_probe_neighbour (P3): `rounds` rounds of one field, each x * 0.5 +
//   acc * 0.0625 with acc the sum of the 8 neighbours in DIR_OFFSETS order,
//   or of 8 products x * c_i (the ALU stand-in).  Replaces `make_rollk` of
//   tools/tpu_measure.py (:283).
//
// P2: a line in registers.  roll(c, s, axis) moves values only along
// `axis`, so each line of it (a row for axis 1, a column for axis 0) of
// each chain is an independent 256-vector for all rounds, and the chains
// meet only in the final max.  A lane holds kSeg = 16 contiguous cells of a
// line of every chain (16 registers a chain), and the 16 lanes of a
// half-warp hold the line.  A round shuffles the last s cells of each
// segment to the next lane (__shfl_sync of width 16: the line's last lane
// wraps to its first), renames the segment's registers by s (a compile-time
// base: the round loop is unrolled by kSeg / gcd(kSeg, s) = 16 rounds, after
// which the base is back at 0; the tail's rounds move the registers
// instead), and adds 1 to every cell.  No cluster and no barrier inside the
// round loop.  A block of 128 threads holds kRollLines = 8 lines, staged
// once through shared memory at the start and once at the end (axis 0: the
// float4s of 8 columns of every row, each spread over 4 lines of the panel;
// a line's pitch of 260 floats keeps those stores off each other's banks).
// kSeg is probes.ROLL_SEG (tests/test_torch_probes3.py holds them equal, and
// models the layout in numpy; tests/test_torch_probes5.py models P5's one
// chain).  P5's shift is the instance of one chain at axis 0, shift 1.
//
// Bound: one add a cell a round and chain, over the fp32 lane rate (128 a
// clock an SM); the field read and written once.  What bounds the design:
// the issue slots, kSeg adds and s shuffles for kSeg cells a round (the
// shuffles alone, s of every kSeg cells at 32 lane-results a clock an SM,
// are its phase bound).
//
// P3, kinds smem and shfl: a field on a cluster of 2 blocks of 128 rows, one
// block an SM, so 64 fields run at once on 128 SMs (the skeleton of
// probe_diffuse.cu's stencil; tools/probes.py neighbour_plan).  Warp w owns
// the strip of 8 rows 8 w .., lane l the 8 contiguous columns 8 l .., read
// as two 16-byte loads a row.  A round walks the strip's rows down with the
// rows above, at and below the output row in registers, so each row (and
// the row above and below the strip) is read once; only the segment's two
// end cells need the columns beside it, and the kinds are the card's two
// ways to reach them, the counterparts of the TPU probe's two lowerings:
// `smem` (twin of jnp.roll: neighbour x[i+o0, j+o1]) reads them at their
// offsets in shared memory, `shfl` (twin of pltpu.roll, which rolls by +o1
// and so reads x[i+o0, j-o1]) takes them from lanes l - 1 and l + 1 by
// __shfl_sync, the row's wrap from lane 31 or 0.  The strip's outputs stay in
// registers until the warp has read its rows and are written back in place;
// its first and last rows also go to the warp's edge rows of the next
// round's parity, which are all the warps above and below it read (each
// waits on the mbarriers of the warps beside it: no block barrier a round).
// The block's row above and row below are its peer's last and first rows:
// the peer's last warp and warp 0 push them by st.async into this block's
// halo row of the next round's parity, completing on its mbarrier (no
// cluster barrier and no fence a round; the protocol of the stencil's
// halo).  A row's 16-byte chunks q are stored at q ^ ((q >> 3) & 1), so that
// each quarter-warp's 16-byte accesses meet every bank once; the smem kind's
// two 4-byte edge reads take the columns in opposite orders in the two
// half-warps, so that each meets 16 banks twice.
// P3, kind alu: the stand-in reads no neighbour, so a thread holds 8 cells
// in registers for all rounds: no shared memory, no cluster, no barrier, the
// field read and written once.
// Bounds: 7 adds and 3 for the update a cell a round (smem, shfl), 8 muls,
// 7 adds and 3 (alu), over the fp32 lane rate; the field in and out once.
// The design's phase bound (smem, shfl) is its shared-memory wavefronts
// (tools/probes.py neighbour_plan) at one a clock an SM.
//
// The arithmetic is f32 with explicit roundings (--fmad=false besides), in
// the plain version's order, so results are bitwise equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_push.cuh"

namespace {

constexpr int kN = 256;
constexpr long long kField = (long long)kN * kN;

// ---- P2, P5's shift: a line of each chain in the registers of 16 lanes -----
constexpr int kSeg = 16;                          // cells of a line a lane holds
constexpr int kLanes = kN / kSeg;                 // 16 lanes a line
constexpr int kRollLines = 8;                     // lines a block
constexpr int kRollThreads = kRollLines * kLanes;
constexpr int kPanels = kN / kRollLines;          // blocks a field
constexpr int kPitch = kN + 4;  // floats a line in shared memory
constexpr int kQuads = kRollLines * kN / 4 / kRollThreads;  // float4 a thread

constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }
// rounds after which the register base is back at 0
template <int S>
constexpr int kUnroll = kSeg / gcd(kSeg, S);

// One round with the segment's logical cell k in register (k + B) % kSeg:
// the last S cells go to the next lane (the registers they leave take the
// previous lane's), then every cell adds 1.  Afterwards logical k is in
// register (k + B - S) % kSeg.
template <int S, int B, int CH>
__device__ __forceinline__ void roll_round(float (&v)[CH][kSeg], int from) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float& r = v[c][(kSeg - S + j + B) % kSeg];
      r = __shfl_sync(0xffffffffu, r, from, kLanes);
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) v[c][k] = __fadd_rn(v[c][k], 1.0f);
  }
}

// rounds U .. kUnroll - 1 of an unrolled group, base (-S * U) % kSeg
template <int S, int U, int CH>
__device__ __forceinline__ void roll_group(float (&v)[CH][kSeg], int from) {
  if constexpr (U < kUnroll<S>) {
    roll_round<S, (kSeg - (S * U) % kSeg) % kSeg, CH>(v, from);
    roll_group<S, U + 1, CH>(v, from);
  }
}

// Where float4 number i of the block's lines sits in global memory (relative
// to the field) and in the panel: axis 1 reads its rows p0 .. in one run;
// axis 0 reads kRollLines columns of every row, and a float4 of a row holds
// 4 lines' cells, placed in 4 lines of the panel.
template <int AXIS>
__device__ __forceinline__ int global_quad(int i, int p0) {
  constexpr int per_row = kRollLines / 4;
  return AXIS == 1 ? p0 * kN + 4 * i
                   : (i / per_row) * kN + p0 + 4 * (i % per_row);
}

// ptxas holds roll_kernel<1, 1, 4> to 128 registers (4 blocks an SM) by
// spilling 16 bytes; asked for 3 blocks an SM it spills nothing (and runs 3%
// slower, where the others would lose up to 8%)
template <int AXIS, int S, int CH>
constexpr int kRollMinBlocks = CH == 4 && AXIS == 1 && S == 1 ? 3 : 1;

template <int AXIS, int S, int CH>
__global__ void __launch_bounds__(kRollThreads, (kRollMinBlocks<AXIS, S, CH>))
roll_kernel(const float* __restrict__ x, float* __restrict__ out,
            int rounds) {
  __shared__ __align__(16) float panel[kRollLines * kPitch];  // [line][cell]
  const long long env = blockIdx.x / kPanels;
  const int p0 = (blockIdx.x % kPanels) * kRollLines;  // first line
  const float* xe = x + env * kField;
  float* oe = out + env * kField;
  constexpr int per_row = kRollLines / 4;
  float4 q[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j)  // all loads in flight, then the stores
    q[j] = *reinterpret_cast<const float4*>(
        xe + global_quad<AXIS>(threadIdx.x + j * kRollThreads, p0));
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int i = threadIdx.x + j * kRollThreads;
    if constexpr (AXIS == 1) {
      const int line = i / (kN / 4), c = 4 * (i % (kN / 4));
      *reinterpret_cast<float4*>(panel + line * kPitch + c) = q[j];
    } else {
      const int row = i / per_row, h = 4 * (i % per_row);
      panel[(h + 0) * kPitch + row] = q[j].x;
      panel[(h + 1) * kPitch + row] = q[j].y;
      panel[(h + 2) * kPitch + row] = q[j].z;
      panel[(h + 3) * kPitch + row] = q[j].w;
    }
  }
  __syncthreads();

  const int line = threadIdx.x / kLanes, seg = threadIdx.x % kLanes;
  const int from = (seg + kLanes - 1) % kLanes;  // the previous lane of the line
  float* mine = panel + line * kPitch + seg * kSeg;
  float v[CH][kSeg];
#pragma unroll
  for (int j = 0; j < kSeg / 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(mine)[j];
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k)  // one chain is x itself: no x + 0
        v[c][4 * j + k] = CH == 1 ? e[k] : __fadd_rn(e[k], (float)c);
  }

  int r = 0;
#pragma unroll 1
  for (; r + kUnroll<S> <= rounds; r += kUnroll<S>)
    roll_group<S, 0, CH>(v, from);
#pragma unroll 1
  for (; r < rounds; ++r) {  // the tail: base 0, then the registers move back
    roll_round<S, 0, CH>(v, from);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float t[kSeg];
#pragma unroll
      for (int k = 0; k < kSeg; ++k) t[k] = v[c][(k + kSeg - S) % kSeg];
#pragma unroll
      for (int k = 0; k < kSeg; ++k) v[c][k] = t[k];
    }
  }

  // the chains' max into this lane's own cells of the panel (no lane reads
  // another's), then out through the panel
#pragma unroll
  for (int j = 0; j < kSeg / 4; ++j) {
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m[k] = v[0][4 * j + k];
#pragma unroll
      for (int c = 1; c < CH; ++c) m[k] = fmaxf(m[k], v[c][4 * j + k]);
    }
    reinterpret_cast<float4*>(mine)[j] = make_float4(m[0], m[1], m[2], m[3]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int i = threadIdx.x + j * kRollThreads;
    float4 o;
    if constexpr (AXIS == 1) {
      o = *reinterpret_cast<const float4*>(panel + (i / (kN / 4)) * kPitch +
                                           4 * (i % (kN / 4)));
    } else {
      const int row = i / per_row, h = 4 * (i % per_row);
      o = make_float4(panel[(h + 0) * kPitch + row],
                      panel[(h + 1) * kPitch + row],
                      panel[(h + 2) * kPitch + row],
                      panel[(h + 3) * kPitch + row]);
    }
    *reinterpret_cast<float4*>(oe + global_quad<AXIS>(i, p0)) = o;
  }
}

// ---- P3: the update and the alu stand-in -------------------------------------
enum NbKind { kAlu = 0, kSmem = 1, kShfl = 2 };

struct NbConsts {
  float w[8];  // the ALU stand-in's factors float32(0.1 + 0.01 i)
};

__device__ __forceinline__ float blend(float x, float acc) {
  return __fadd_rn(__fmul_rn(x, 0.5f), __fmul_rn(acc, 0.0625f));
}

constexpr int kAluThreads = 256;
constexpr int kAluCells = 8;  // contiguous cells a thread
constexpr int kAluBlocks = (int)(kField / (kAluThreads * kAluCells));  // a field

// thread: 8 contiguous cells of the fields, in registers for all rounds
__global__ void __launch_bounds__(kAluThreads)
neighbour_alu_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int rounds, const NbConsts k) {
  const long long i =
      ((long long)blockIdx.x * kAluThreads + threadIdx.x) * kAluCells;
  const float4 a = __ldg(reinterpret_cast<const float4*>(x + i));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x + i) + 1);
  float v[kAluCells] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll 2
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int q = 0; q < kAluCells; ++q) {
      float acc = __fmul_rn(v[q], k.w[0]);
#pragma unroll
      for (int j = 1; j < 8; ++j) acc = __fadd_rn(acc, __fmul_rn(v[q], k.w[j]));
      v[q] = blend(v[q], acc);
    }
  }
  reinterpret_cast<float4*>(out + i)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out + i)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// ---- P3 smem, shfl: a field on a cluster of 2 blocks, 128 rows each ----------
// tools/probes.py neighbour_plan states this geometry (its CPU test walks it).
// Shared memory: the block's rows (in place), its halo rows [parity][above,
// below] (the peer's pushes), and each warp's edge rows [warp][parity][first,
// last]: a copy of its strip's first and last rows, which are all the warps
// above and below it read of the strip.  So no warp reads another's rows in
// place, and a round needs no block barrier: warp w waits on the mbarriers
// of warps w - 1 and w + 1 (32 arrivals a round each, after their edge rows
// of the round are written), which also says they have read its edge rows
// of the parity it writes next.  Warps beside each other run at most a
// round apart, so a warp can be two rounds ahead of one two warps away, and
// one mbarrier a warp would be two phases ahead of the one its neighbour
// waits for: a warp has one mbarrier a parity of rounds.
constexpr int kNbCl = 2;                       // blocks a field (a cluster)
constexpr int kNbRows = kN / kNbCl;            // 128 rows a block
constexpr int kNbStrip = 8;                    // rows a warp
constexpr int kNbCols = 8;                     // columns a lane
constexpr int kNbWarps = kNbRows / kNbStrip;   // 16
constexpr int kNbThreads = 32 * kNbWarps;      // 512
constexpr int kNbHaloAt = kNbRows * kN;        // floats before the halo rows
constexpr int kNbEdgeAt = kNbHaloAt + 4 * kN;  // and before the edge rows
constexpr int kNbBars = (kNbEdgeAt + 4 * kNbWarps * kN) * 4;  // bytes
constexpr int kNbSmem = kNbBars + (4 + 2 * kNbWarps) * 8;  // halo, warps

__device__ __forceinline__ int nb_chunk(int q) { return q ^ ((q >> 3) & 1); }

// where column c of a row sits in shared memory
__device__ __forceinline__ int nb_col(int c) {
  return 4 * nb_chunk(c >> 2) + (c & 3);
}

// edge row `side` (0 first, 1 last) of `parity` of warp w
__device__ __forceinline__ int nb_edge(int w, int parity, int side) {
  return kNbEdgeAt + ((w * 2 + parity) * 2 + side) * kN;
}

// a row as a lane holds it: its 8 columns, and the columns left and right of
// them (l: 8 lane - 1, r: 8 lane + 8, on the torus)
struct NbRow {
  float v[kNbCols];
  float l, r;
};

// smem: ea and eb are the lane's two edge columns in shared memory, left
// then right for lanes 0-15 and right then left for lanes 16-31, so that each
// of the two 4-byte loads meets 16 banks twice (2 wavefronts; in one order
// for all lanes 8 banks 4 times)
template <int KIND>
__device__ __forceinline__ void nb_load(NbRow& o, const float* row, int c0,
                                        int c1, int ea, int eb, int lane) {
  const float4 a = *reinterpret_cast<const float4*>(row + c0);
  const float4 b = *reinterpret_cast<const float4*>(row + c1);
  o.v[0] = a.x, o.v[1] = a.y, o.v[2] = a.z, o.v[3] = a.w;
  o.v[4] = b.x, o.v[5] = b.y, o.v[6] = b.z, o.v[7] = b.w;
  if constexpr (KIND == kSmem) {
    const float p = row[ea], q = row[eb];
    o.l = lane < 16 ? p : q;
    o.r = lane < 16 ? q : p;
  } else {
    o.l = __shfl_sync(0xffffffffu, o.v[kNbCols - 1], (lane + 31) & 31);
    o.r = __shfl_sync(0xffffffffu, o.v[0], (lane + 1) & 31);
  }
}

// the cells right and left of the lane's column k
__device__ __forceinline__ float nb_right(const NbRow& x, int k) {
  return k + 1 < kNbCols ? x.v[k + 1] : x.r;
}

__device__ __forceinline__ float nb_left(const NbRow& x, int k) {
  return k > 0 ? x.v[k - 1] : x.l;
}

// the output at the lane's column k of row m, u the row above, d below
template <int KIND>
__device__ __forceinline__ float nb_cell(const NbRow& u, const NbRow& m,
                                         const NbRow& d, int k) {
  float acc;
  if constexpr (KIND == kSmem) {  // E, NE, N, NW, W, SW, S, SE at x[i+o0, j+o1]
    acc = nb_right(m, k);
    acc = __fadd_rn(acc, nb_right(u, k));
    acc = __fadd_rn(acc, u.v[k]);
    acc = __fadd_rn(acc, nb_left(u, k));
    acc = __fadd_rn(acc, nb_left(m, k));
    acc = __fadd_rn(acc, nb_left(d, k));
    acc = __fadd_rn(acc, d.v[k]);
    acc = __fadd_rn(acc, nb_right(d, k));
  } else {  // the same offsets read as pltpu.roll reads them: x[i+o0, j-o1]
    acc = nb_left(m, k);
    acc = __fadd_rn(acc, nb_left(u, k));
    acc = __fadd_rn(acc, u.v[k]);
    acc = __fadd_rn(acc, nb_right(u, k));
    acc = __fadd_rn(acc, nb_right(m, k));
    acc = __fadd_rn(acc, nb_right(d, k));
    acc = __fadd_rn(acc, d.v[k]);
    acc = __fadd_rn(acc, nb_left(d, k));
  }
  return blend(m.v[k], acc);
}

// the lane's two chunks of output row I of the strip into the row at `dst`
template <int I>
__device__ __forceinline__ void nb_store(const float (&z)[kNbStrip][kNbCols],
                                         float* dst, int c0, int c1) {
  *reinterpret_cast<float4*>(dst + c0) =
      make_float4(z[I][0], z[I][1], z[I][2], z[I][3]);
  *reinterpret_cast<float4*>(dst + c1) =
      make_float4(z[I][4], z[I][5], z[I][6], z[I][7]);
}

// output row I of the strip into the peer's halo row at `dst`, counted on the
// peer's mbarrier `bar` (shared::cluster addresses), the lane's two chunks
template <int I>
__device__ __forceinline__ void nb_push(const float (&z)[kNbStrip][kNbCols],
                                        uint32_t dst, uint32_t bar, int c0,
                                        int c1) {
  st_async4(dst + c0 * 4, bar, z[I][0], z[I][1], z[I][2], z[I][3]);
  st_async4(dst + c1 * 4, bar, z[I][4], z[I][5], z[I][6], z[I][7]);
}

template <int KIND>
__global__ void __launch_bounds__(kNbThreads, 1)
neighbour_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int rounds) {
  extern __shared__ __align__(16) float sm[];
  const uint32_t bars = smem_addr(sm) + kNbBars;  // halo [parity][above, below]
  const uint32_t wbars = bars + 4 * 8;  // a warp's, [warp][parity]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int peer = (int)rank ^ 1, g0 = (int)rank * kNbRows;
  const long long env = blockIdx.x / kNbCl;
  const float* xe = x + env * kField;
  if (rounds == 0) {  // y = x
    for (int e = tid; e < kNbRows * kN / 4; e += kNbThreads)
      reinterpret_cast<float4*>(out + env * kField + (long long)g0 * kN)[e] =
          __ldg(reinterpret_cast<const float4*>(xe + (long long)g0 * kN) + e);
    return;
  }
  // the block's rows, the first round's halo rows (global rows g0 - 1 and
  // g0 + 128 on the torus) and edge rows, from x
  for (int e = tid; e < (kNbRows + 2) * (kN / 4); e += kNbThreads) {
    const int r = e / (kN / 4), q = e % (kN / 4);
    const int g = r < kNbRows ? g0 + r : r == kNbRows ? g0 - 1 : g0 + kNbRows;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
                               xe + (long long)(g & (kN - 1)) * kN) + q);
    const int at = 4 * nb_chunk(q);
    *reinterpret_cast<float4*>(sm + r * kN + at) = v;
    const int w = r / kNbStrip, i = r % kNbStrip;
    if (r < kNbRows && (i == 0 || i == kNbStrip - 1))
      *reinterpret_cast<float4*>(sm + nb_edge(w, 0, i ? 1 : 0) + at) = v;
  }
  if (tid < 4) {  // a halo slot's phase: one local arrival and its bytes
    bar_init(bars + 8 * tid);
    bar_expect(bars + 8 * tid, kN * 4);  // the slot's first use
  } else if (tid < 4 + 2 * kNbWarps) {  // a warp's phase: its lanes a round
    bar_init_count(wbars + 8 * (tid - 4), 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  cluster_sync();  // both blocks' mbarriers exist before the first push

  const int v0 = warp * kNbStrip;
  const int c0 = 4 * nb_chunk(2 * lane), c1 = 4 * nb_chunk(2 * lane + 1);
  const int el = nb_col((kNbCols * lane + kN - 1) & (kN - 1));
  const int er = nb_col((kNbCols * lane + kNbCols) & (kN - 1));
  const int ea = lane < 16 ? el : er, eb = lane < 16 ? er : el;
  const bool top = warp == 0, bottom = warp == kNbWarps - 1;
  float* own = sm + v0 * kN;
  float z[kNbStrip][kNbCols];
#pragma unroll 1
  for (int a = 0; a < rounds; ++a) {
    const int par = a & 1;
    const float* above = sm + (top ? kNbHaloAt + 2 * par * kN
                                   : nb_edge(warp - 1, par, 1));
    const float* below = sm + (bottom ? kNbHaloAt + (2 * par + 1) * kN
                                      : nb_edge(warp + 1, par, 0));
    if (a > 0) {
      // round a - 1 completed phase (a - 1) >> 1 of the mbarriers of its
      // parity, which is this round's other parity
      const uint32_t phase = ((a - 1) >> 1) & 1;
      if (top || bottom) {  // the peer's push for this round
        const uint32_t bar = bars + 8 * (2 * par + (top ? 0 : 1));
        bar_wait_cluster(bar, phase);
        __syncwarp();
        if (lane == 0) bar_expect(bar, kN * 4);  // its next use, a + 2
      }
      if (!top) bar_wait(wbars + 8 * (2 * (warp - 1) + (par ^ 1)), phase);
      if (!bottom) bar_wait(wbars + 8 * (2 * (warp + 1) + (par ^ 1)), phase);
    }
    NbRow u, m, d;
    nb_load<KIND>(u, above, c0, c1, ea, eb, lane);
    nb_load<KIND>(m, own, c0, c1, ea, eb, lane);
#pragma unroll
    for (int i = 0; i < kNbStrip; ++i) {
      nb_load<KIND>(d, i + 1 < kNbStrip ? own + (i + 1) * kN : below, c0, c1,
                    ea, eb, lane);
#pragma unroll
      for (int k = 0; k < kNbCols; ++k) z[i][k] = nb_cell<KIND>(u, m, d, k);
      u = m;
      m = d;
    }
    if (a + 1 == rounds) {
      float* oe = out + env * kField + (long long)(g0 + v0) * kN;
#pragma unroll
      for (int i = 0; i < kNbStrip; ++i) {
        float* o = oe + i * kN + kNbCols * lane;
        *reinterpret_cast<float4*>(o) =
            make_float4(z[i][0], z[i][1], z[i][2], z[i][3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(z[i][4], z[i][5], z[i][6], z[i][7]);
      }
      break;
    }
    // the next round's halo rows to the peer: warp 0 its first row (the
    // peer's row below), the last warp its last (the peer's row above)
    if (top || bottom) {
      const int slot = 2 * (par ^ 1) + (top ? 1 : 0);
      const uint32_t dst =
          map_rank(smem_addr(sm + kNbHaloAt + slot * kN), peer);
      const uint32_t bar = map_rank(bars + 8 * slot, peer);
      if (top)
        nb_push<0>(z, dst, bar, c0, c1);
      else
        nb_push<kNbStrip - 1>(z, dst, bar, c0, c1);
    }
    __syncwarp();  // the lanes have read the strip (smem reads across lanes)
#pragma unroll
    for (int i = 0; i < kNbStrip; ++i) {
      *reinterpret_cast<float4*>(own + i * kN + c0) =
          make_float4(z[i][0], z[i][1], z[i][2], z[i][3]);
      *reinterpret_cast<float4*>(own + i * kN + c1) =
          make_float4(z[i][4], z[i][5], z[i][6], z[i][7]);
    }
    nb_store<0>(z, sm + nb_edge(warp, par ^ 1, 0), c0, c1);
    nb_store<kNbStrip - 1>(z, sm + nb_edge(warp, par ^ 1, 1), c0, c1);
    __syncwarp();  // the strip is written before its lanes read it again
    bar_arrive(wbars + 8 * (2 * warp + par));  // round a's edge rows written
  }
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

cudaLaunchConfig_t neighbour_config(int B, cudaLaunchAttribute* attr,
                                    cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kNbCl);
  cfg.blockDim = dim3(kNbThreads);
  cfg.dynamicSmemBytes = kNbSmem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kNbCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KIND>
int launch_neighbour(const float* x, float* o, int B, int rounds,
                     cudaStream_t s) {
  const int rc = prepare(neighbour_kernel<KIND>, kNbSmem);
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = neighbour_config(B, attr, s);
  const int lrc =
      (int)cudaLaunchKernelEx(&cfg, neighbour_kernel<KIND>, x, o, rounds);
  if (lrc) return lrc;
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int neighbour_clusters() {
  int n = 0, rc = prepare(neighbour_kernel<KIND>, kNbSmem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = neighbour_config(64, attr, nullptr);
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveClusters(&n, neighbour_kernel<KIND>, &cfg);
  return rc ? -rc : n;
}

template <int AXIS, int S, int CH>
void launch_roll(const float* x, float* o, int B, int rounds, cudaStream_t s) {
  roll_kernel<AXIS, S, CH><<<B * kPanels, kRollThreads, 0, s>>>(x, o, rounds);
}

}  // namespace

// x, out: [B, 256, 256] f32 on the device; shift 1 or 3; chains 4 (P2) or 1
// (P5's shift: axis 0, shift 1 only).  Returns the CUDA error of the launch
// (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_roll(const void* x, void* out, int B, int axis,
                              int shift, int rounds, int chains,
                              void* stream) {
  if (B < 1 || B > 65535 || rounds < 0 || (axis != 0 && axis != 1) ||
      (shift != 1 && shift != 3) || (chains != 1 && chains != 4) ||
      (chains == 1 && (axis != 0 || shift != 1)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (chains == 1)
    launch_roll<0, 1, 1>(xi, o, B, rounds, s);
  else if (axis == 0 && shift == 1)
    launch_roll<0, 1, 4>(xi, o, B, rounds, s);
  else if (axis == 0)
    launch_roll<0, 3, 4>(xi, o, B, rounds, s);
  else if (shift == 1)
    launch_roll<1, 1, 4>(xi, o, B, rounds, s);
  else
    launch_roll<1, 3, 4>(xi, o, B, rounds, s);
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 alu, 1 smem, 2 shfl (any other is refused; P5's shift runs in
// die_probe_roll); consts: host array of the 8 ALU factors.
extern "C" int die_probe_neighbour(const void* x, void* out, int B, int kind,
                                   int rounds, const float* consts,
                                   void* stream) {
  if (B < 1 || B > 65535 || rounds < 0 || kind < 0 || kind > 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (kind == kAlu) {
    NbConsts k;
    for (int i = 0; i < 8; ++i) k.w[i] = consts[i];
    neighbour_alu_kernel<<<B * kAluBlocks, kAluThreads, 0, s>>>(xi, o, rounds,
                                                                k);
    return static_cast<int>(cudaGetLastError());
  }
  return kind == kSmem ? launch_neighbour<kSmem>(xi, o, B, rounds, s)
                       : launch_neighbour<kShfl>(xi, o, B, rounds, s);
}

// How many clusters of die_probe_neighbour's launch for kind 1 or 2 fit the
// card at once (cudaOccupancyMaxActiveClusters), which sets the waves of B
// fields; -(CUDA error) on a failure, -1 for a kind without a cluster.
extern "C" int die_probe_neighbour_clusters(int kind) {
  if (kind != kSmem && kind != kShfl) return -1;
  return kind == kSmem ? neighbour_clusters<kSmem>()
                       : neighbour_clusters<kShfl>();
}
