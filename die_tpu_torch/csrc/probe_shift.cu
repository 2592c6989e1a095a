// Torus shifts of whole 256x256 f32 fields, chained over rounds, with the
// fields kept on chip in a thread-block cluster's distributed shared memory.
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
// Where the field lives is the design.  On the TPU the field sits in VMEM
// for all rounds.  A 256x256 f32 field is 256 KB and a block has 227 KB, so
// here a cluster of blocks holds it in their shared memory and reads across
// block edges through distributed shared memory (cluster.map_shared_rank):
//   - P2: a cluster of 8 blocks holds the env's four chains (1 MB), 32 rows
//     of each on every block (128 KB).  Double-buffering 1 MB does not fit 8
//     blocks, so a round reads every new value into registers, waits at a
//     barrier, writes, and waits again: two barriers a round, cluster-wide
//     for axis 0 (rows cross block edges) and block-wide for axis 1 (a row
//     stays on its block).  With a scratch pointer the same kernel keeps the
//     chains in device memory instead, ping-ponged through L2 (ld.global.cg,
//     one barrier a round): the "l2" placement.
//   - P3 and P5: a cluster of 4 blocks holds one field, 64 rows each, double
//     buffered (128 KB a block): one cluster barrier a round.  Each warp owns
//     whole rows; a lane holds columns lane + 32k (k < 8).  The neighbours
//     are reached in one of the card's two ways, the counterparts of the TPU
//     probe's two lowerings: kind 1 (`smem`, twin of jnp.roll) reads
//     x[i+o0, j+o1] at its offset in shared memory; kind 2 (`shfl`, twin of
//     pltpu.roll, which rolls by +o1 and so reads x[i+o0, j-o1]) loads the
//     three rows once and takes the axis-1 neighbours from the next lane by
//     __shfl_sync, the row's wrap from the next register.
//
// Bound: each round reads and writes the field once; the least time is
// that traffic over the shared-memory bandwidth (128 bytes a cycle per SM).
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

// ---- P2: four chains of a field on a cluster of 8 -----------------------------
constexpr int kRollCta = 8;
constexpr int kRollRows = kN / kRollCta;              // 32
constexpr int kRollThreads = 1024;
constexpr int kRollRowStep = kRollThreads / kN;       // 4
constexpr int kRollPer = kRollRows / kRollRowStep;    // 8 rows a thread
constexpr int kRollSmem = kChains * kRollRows * kN * 4;  // 131072 bytes

template <int AXIS>
__device__ __forceinline__ void roll_sync(cg::cluster_group& cl) {
  if constexpr (AXIS == 0) {
    cl.sync();
  } else {
    __syncthreads();
  }
}

template <int AXIS, bool L2>
__global__ void __cluster_dims__(kRollCta, 1, 1)
__launch_bounds__(kRollThreads, 1)
roll_kernel(const float* __restrict__ x, float* __restrict__ out,
            float* __restrict__ scratch, int shift, int rounds) {
  extern __shared__ float s_chain[];  // [kChains][kRollRows][kN]
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long env = blockIdx.x / kRollCta;
  const int col = threadIdx.x & (kN - 1);
  const int r0 = threadIdx.x / kN;
  const float* xe = x + env * kField;
  // L2: [2][kChains][kN][kN] of this env
  float* se = L2 ? scratch + env * 2 * kChains * kField : nullptr;
  int cur = 0;

#pragma unroll
  for (int j = 0; j < kRollPer; ++j) {
    const int lr = r0 + kRollRowStep * j, g = rank * kRollRows + lr;
    const float v = xe[g * kN + col];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float w = __fadd_rn(v, (float)c);
      if (L2) {
        __stcg(se + (c * kN + g) * kN + col, w);
      } else {
        s_chain[(c * kRollRows + lr) * kN + col] = w;
      }
    }
  }
  roll_sync<AXIS>(cl);

#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float v[kChains][kRollPer];
    const float* src = L2 ? se + cur * kChains * kField : nullptr;
#pragma unroll
    for (int j = 0; j < kRollPer; ++j) {
      const int lr = r0 + kRollRowStep * j, g = rank * kRollRows + lr;
      const int sg = AXIS == 0 ? ((g - shift) & (kN - 1)) : g;
      const int sc = AXIS == 0 ? col : ((col - shift) & (kN - 1));
      if (L2) {
#pragma unroll
        for (int c = 0; c < kChains; ++c)
          v[c][j] = __ldcg(src + (c * kN + sg) * kN + sc);
      } else if (AXIS == 0) {
        const float* base = cl.map_shared_rank(s_chain, sg / kRollRows);
        const int sl = sg % kRollRows;
#pragma unroll
        for (int c = 0; c < kChains; ++c)
          v[c][j] = base[(c * kRollRows + sl) * kN + sc];
      } else {
#pragma unroll
        for (int c = 0; c < kChains; ++c)
          v[c][j] = s_chain[(c * kRollRows + lr) * kN + sc];
      }
    }
    if (!L2) roll_sync<AXIS>(cl);  // every old value read before any write
    float* dst = L2 ? se + (cur ^ 1) * kChains * kField : nullptr;
#pragma unroll
    for (int j = 0; j < kRollPer; ++j) {
      const int lr = r0 + kRollRowStep * j, g = rank * kRollRows + lr;
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const float w = __fadd_rn(v[c][j], 1.0f);
        if (L2) {
          __stcg(dst + (c * kN + g) * kN + col, w);
        } else {
          s_chain[(c * kRollRows + lr) * kN + col] = w;
        }
      }
    }
    roll_sync<AXIS>(cl);
    if (L2) cur ^= 1;
  }

  const float* fin = L2 ? se + cur * kChains * kField : nullptr;
#pragma unroll
  for (int j = 0; j < kRollPer; ++j) {
    const int lr = r0 + kRollRowStep * j, g = rank * kRollRows + lr;
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float w = L2 ? __ldcg(fin + (c * kN + g) * kN + col)
                         : s_chain[(c * kRollRows + lr) * kN + col];
      m = c == 0 ? w : fmaxf(m, w);
    }
    out[env * kField + g * kN + col] = m;
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

// x, out: [B, 256, 256] f32 on the device; scratch: null (the chains in a
// cluster's shared memory) or [B, 2, 4, 256, 256] f32 (through L2).
// Returns the CUDA error of the launch (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_roll(const void* x, void* out, void* scratch, int B,
                              int axis, int shift, int rounds, void* stream) {
  if (B < 1 || B > 65535 || rounds < 0 || (axis != 0 && axis != 1) ||
      shift < 0 || shift >= kN)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const dim3 grid(B * kRollCta), block(kRollThreads);
  const bool l2 = scratch != nullptr;
  const int smem = l2 ? 0 : kRollSmem;
  int rc = 0;
  if (axis == 0 && !l2) {
    rc = prepare(roll_kernel<0, false>, smem);
    if (!rc) roll_kernel<0, false><<<grid, block, smem, s>>>(xi, o, sc, shift, rounds);
  } else if (axis == 0) {
    roll_kernel<0, true><<<grid, block, 0, s>>>(xi, o, sc, shift, rounds);
  } else if (!l2) {
    rc = prepare(roll_kernel<1, false>, smem);
    if (!rc) roll_kernel<1, false><<<grid, block, smem, s>>>(xi, o, sc, shift, rounds);
  } else {
    roll_kernel<1, true><<<grid, block, 0, s>>>(xi, o, sc, shift, rounds);
  }
  if (rc) return rc;
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
