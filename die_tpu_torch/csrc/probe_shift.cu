// Torus shifts of whole 256x256 f32 fields, chained over rounds.
//
// die_probe_roll (P2): four chains x + i per field, each `rounds` times
//   roll(c, shift, axis) + 1, then their maximum.  Replaces the TPU probe
//   `make_roll` of tools/tpu_measure.py (the pallas_call at :157).
// die_probe_neighbour (P3, and P5's shift leg): `rounds` rounds of one
//   field, each x * 0.5 + acc * 0.0625 with acc the sum of the 8 neighbours
//   in DIR_OFFSETS order, or of 8 products x * c_i (the ALU stand-in); or
//   roll(x, 1, 0) + 1 (kind 3).  Replaces `make_rollk` of
//   tools/tpu_measure.py (:283) and the `vpu` leg of `make_roll_kernel` of
//   tools/tpu_mxu_offload.py (:180).
//
// P2: a line in registers.  roll(c, s, axis) moves values only along
// `axis`, so each line of it (a row for axis 1, a column for axis 0) of
// each chain is an independent 256-vector for all rounds, and the chains
// meet only in the final max.  A lane holds kSeg = 16 contiguous cells of a
// line of all four chains (64 registers), and the 16 lanes of a half-warp
// hold the line.  A round shuffles the last s cells of each segment to the
// next lane (__shfl_sync of width 16: the line's last lane wraps to its
// first), renames the segment's registers by s (a compile-time base: the
// round loop is unrolled by kSeg / gcd(kSeg, s) = 16 rounds, after which the
// base is back at 0; the tail's rounds move the registers instead), and
// adds 1 to every cell.  No cluster and no barrier inside the round loop.
// A block of 128 threads holds kRollLines = 8 lines, staged once through
// shared memory at the start and once at the end (axis 0: the float4s of
// 8 columns of every row, each spread over 4 lines of the panel; a line's
// pitch of 260 floats keeps those stores off each other's banks).  kSeg
// is probes.ROLL_SEG (tests/test_torch_probes3.py holds them equal, and
// models the layout in numpy).
//
// Bound: one add a cell a round, 4 chains, over the fp32 lane rate (128 a
// clock an SM); the field read and written once.  What bounds the design:
// the issue slots, kSeg adds and s shuffles for kSeg cells a round (the
// shuffles alone, s of every kSeg cells at 32 lane-results a clock an SM,
// are its phase bound).

// P3 and P5: a cluster of 4 blocks holds one field, 64 rows each, double
// buffered (128 KB a block): one cluster barrier a round.  Each warp owns
// whole rows; a lane holds columns lane + 32k (k < 8).  The neighbours are
// reached in one of the card's two ways, the counterparts of the TPU probe's
// two lowerings: kind 1 (`smem`, twin of jnp.roll) reads x[i+o0, j+o1] at
// its offset in shared memory; kind 2 (`shfl`, twin of pltpu.roll, which
// rolls by +o1 and so reads x[i+o0, j-o1]) loads the three rows once and
// takes the axis-1 neighbours from the next lane by __shfl_sync, the row's
// wrap from the next register.  Bound: each round reads and writes the
// field once; the least time is that traffic over the shared-memory
// bandwidth (128 bytes a cycle per SM).
//
// The arithmetic is f32 with explicit roundings (--fmad=false besides), in
// the plain version's order, so results are bitwise equal to it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 256;
constexpr int kChains = 4;
constexpr long long kField = (long long)kN * kN;

// ---- P2: a line of four chains in the registers of 16 lanes -----------------
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
template <int S, int B>
__device__ __forceinline__ void roll_round(float (&v)[kChains][kSeg],
                                           int from) {
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
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
template <int S, int U>
__device__ __forceinline__ void roll_group(float (&v)[kChains][kSeg],
                                           int from) {
  if constexpr (U < kUnroll<S>) {
    roll_round<S, (kSeg - (S * U) % kSeg) % kSeg>(v, from);
    roll_group<S, U + 1>(v, from);
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

// ptxas holds roll_kernel<1, 1> to 128 registers (4 blocks an SM) by
// spilling 16 bytes; asked for 3 blocks an SM it spills nothing (and runs 3%
// slower, where the others would lose up to 8%)
template <int AXIS, int S>
constexpr int kRollMinBlocks = AXIS == 1 && S == 1 ? 3 : 1;

template <int AXIS, int S>
__global__ void __launch_bounds__(kRollThreads, (kRollMinBlocks<AXIS, S>))
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
  float v[kChains][kSeg];
#pragma unroll
  for (int j = 0; j < kSeg / 4; ++j) {
    const float4 a = reinterpret_cast<const float4*>(mine)[j];
    const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int c = 0; c < kChains; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[c][4 * j + k] = __fadd_rn(e[k], (float)c);
  }

  int r = 0;
#pragma unroll 1
  for (; r + kUnroll<S> <= rounds; r += kUnroll<S>) roll_group<S, 0>(v, from);
#pragma unroll 1
  for (; r < rounds; ++r) {  // the tail: base 0, then the registers move back
    roll_round<S, 0>(v, from);
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
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
      for (int c = 1; c < kChains; ++c) m[k] = fmaxf(m[k], v[c][4 * j + k]);
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

// ---- P3 / P5: one field on a cluster of 4, double buffered -------------------
constexpr int kNbCta = 4;
constexpr int kNbRows = kN / kNbCta;   // 64
constexpr int kNbThreads = 512;
constexpr int kNbWarps = kNbThreads / 32;
constexpr int kNbRowsPerWarp = kNbRows / kNbWarps;  // 4
constexpr int kNbCols = kN / 32;       // 8 columns a lane
constexpr int kNbBuf = kNbRows * kN;   // floats of one buffer
constexpr int kNbSmem = 2 * kNbBuf * 4 + 2 * kN * (int)sizeof(float*);

enum NbKind { kAlu = 0, kSmem = 1, kShfl = 2, kShift = 3 };

struct NbConsts {
  float w[8];  // the ALU stand-in's factors float32(0.1 + 0.01 i)
};

__device__ __forceinline__ float blend(float x, float acc) {
  return __fadd_rn(__fmul_rn(x, 0.5f), __fmul_rn(acc, 0.0625f));
}

// the value at column c - 1 (left) or c + 1 (right) of a row held as
// v[k] = row[lane + 32 k]
__device__ __forceinline__ float from_left(const float (&v)[kNbCols], int k,
                                           int lane) {
  const float send = lane == 31 ? v[(k + kNbCols - 1) % kNbCols] : v[k];
  return __shfl_sync(0xffffffffu, send, (lane + 31) & 31);
}

__device__ __forceinline__ float from_right(const float (&v)[kNbCols], int k,
                                            int lane) {
  const float send = lane == 0 ? v[(k + 1) % kNbCols] : v[k];
  return __shfl_sync(0xffffffffu, send, (lane + 1) & 31);
}

template <int KIND>
__global__ void __cluster_dims__(kNbCta, 1, 1)
__launch_bounds__(kNbThreads, 1)
neighbour_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int rounds, const NbConsts k) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* buf = reinterpret_cast<float*>(raw);  // [2][kNbRows][kN]
  // tab[b][g]: row g of buffer b, on whichever block of the cluster holds it
  const float** tab = reinterpret_cast<const float**>(raw + 2 * kNbBuf * 4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long env = blockIdx.x / kNbCta;
  for (int i = threadIdx.x; i < 2 * kN; i += kNbThreads) {
    const int b = i / kN, g = i % kN;
    tab[i] = cl.map_shared_rank(buf + b * kNbBuf, g / kNbRows) +
             (g % kNbRows) * kN;
  }
  const float* xe = x + env * kField + (long long)rank * kNbBuf;
  for (int e = threadIdx.x; e < kNbBuf; e += kNbThreads) buf[e] = xe[e];
  cl.sync();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  int cur = 0;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const float* const* rows = tab + cur * kN;
    float* dst = buf + (cur ^ 1) * kNbBuf;
#pragma unroll 1
    for (int jr = 0; jr < kNbRowsPerWarp; ++jr) {
      const int lr = warp + kNbWarps * jr, g = rank * kNbRows + lr;
      const float* mid = buf + cur * kNbBuf + lr * kN;
      const float* up = rows[(g - 1) & (kN - 1)];
      const float* dn = rows[(g + 1) & (kN - 1)];
      float res[kNbCols];
      if constexpr (KIND == kShift) {
#pragma unroll
        for (int q = 0; q < kNbCols; ++q)
          res[q] = __fadd_rn(up[lane + 32 * q], 1.0f);
      } else if constexpr (KIND == kAlu) {
#pragma unroll
        for (int q = 0; q < kNbCols; ++q) {
          const float v = mid[lane + 32 * q];
          float acc = __fmul_rn(v, k.w[0]);
#pragma unroll
          for (int i = 1; i < 8; ++i) acc = __fadd_rn(acc, __fmul_rn(v, k.w[i]));
          res[q] = blend(v, acc);
        }
      } else if constexpr (KIND == kSmem) {
        // DIR_OFFSETS: E, NE, N, NW, W, SW, S, SE at x[i+o0, j+o1]
#pragma unroll
        for (int q = 0; q < kNbCols; ++q) {
          const int c = lane + 32 * q;
          const int cr = (c + 1) & (kN - 1), cl_ = (c - 1) & (kN - 1);
          float acc = mid[cr];
          acc = __fadd_rn(acc, up[cr]);
          acc = __fadd_rn(acc, up[c]);
          acc = __fadd_rn(acc, up[cl_]);
          acc = __fadd_rn(acc, mid[cl_]);
          acc = __fadd_rn(acc, dn[cl_]);
          acc = __fadd_rn(acc, dn[c]);
          acc = __fadd_rn(acc, dn[cr]);
          res[q] = blend(mid[c], acc);
        }
      } else {
        // the same offsets read as pltpu.roll reads them: x[i+o0, j-o1]
        float m[kNbCols], u[kNbCols], d[kNbCols];
#pragma unroll
        for (int q = 0; q < kNbCols; ++q) {
          m[q] = mid[lane + 32 * q];
          u[q] = up[lane + 32 * q];
          d[q] = dn[lane + 32 * q];
        }
#pragma unroll
        for (int q = 0; q < kNbCols; ++q) {
          float acc = from_left(m, q, lane);
          acc = __fadd_rn(acc, from_left(u, q, lane));
          acc = __fadd_rn(acc, u[q]);
          acc = __fadd_rn(acc, from_right(u, q, lane));
          acc = __fadd_rn(acc, from_right(m, q, lane));
          acc = __fadd_rn(acc, from_right(d, q, lane));
          acc = __fadd_rn(acc, d[q]);
          acc = __fadd_rn(acc, from_left(d, q, lane));
          res[q] = blend(m[q], acc);
        }
      }
#pragma unroll
      for (int q = 0; q < kNbCols; ++q) dst[lr * kN + lane + 32 * q] = res[q];
    }
    cl.sync();
    cur ^= 1;
  }
  float* oe = out + env * kField + (long long)rank * kNbBuf;
  for (int e = threadIdx.x; e < kNbBuf; e += kNbThreads)
    oe[e] = buf[cur * kNbBuf + e];
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// x, out: [B, 256, 256] f32 on the device; shift 1 or 3.  Returns the CUDA
// error of the launch (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_roll(const void* x, void* out, int B, int axis,
                              int shift, int rounds, void* stream) {
  if (B < 1 || B > 65535 || rounds < 0 || (axis != 0 && axis != 1) ||
      (shift != 1 && shift != 3))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const dim3 grid(B * kPanels), block(kRollThreads);
  if (axis == 0 && shift == 1) {
    roll_kernel<0, 1><<<grid, block, 0, s>>>(xi, o, rounds);
  } else if (axis == 0) {
    roll_kernel<0, 3><<<grid, block, 0, s>>>(xi, o, rounds);
  } else if (shift == 1) {
    roll_kernel<1, 1><<<grid, block, 0, s>>>(xi, o, rounds);
  } else {
    roll_kernel<1, 3><<<grid, block, 0, s>>>(xi, o, rounds);
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 alu, 1 smem, 2 shfl, 3 shift (roll(x, 1, 0) + 1); consts: host
// array of the 8 ALU factors.
extern "C" int die_probe_neighbour(const void* x, void* out, int B, int kind,
                                   int rounds, const float* consts,
                                   void* stream) {
  if (B < 1 || B > 65535 || rounds < 0 || kind < 0 || kind > 3) return -1;
  NbConsts k;
  for (int i = 0; i < 8; ++i) k.w[i] = consts[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const dim3 grid(B * kNbCta), block(kNbThreads);
  int rc = 0;
  switch (kind) {
    case kAlu:
      rc = prepare(neighbour_kernel<kAlu>, kNbSmem);
      if (!rc) neighbour_kernel<kAlu><<<grid, block, kNbSmem, s>>>(xi, o, rounds, k);
      break;
    case kSmem:
      rc = prepare(neighbour_kernel<kSmem>, kNbSmem);
      if (!rc) neighbour_kernel<kSmem><<<grid, block, kNbSmem, s>>>(xi, o, rounds, k);
      break;
    case kShfl:
      rc = prepare(neighbour_kernel<kShfl>, kNbSmem);
      if (!rc) neighbour_kernel<kShfl><<<grid, block, kNbSmem, s>>>(xi, o, rounds, k);
      break;
    default:
      rc = prepare(neighbour_kernel<kShift>, kNbSmem);
      if (!rc) neighbour_kernel<kShift><<<grid, block, kNbSmem, s>>>(xi, o, rounds, k);
      break;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
