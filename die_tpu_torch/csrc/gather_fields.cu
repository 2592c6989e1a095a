// gather_fields (K5): out[b, f, i] = fields[f][b, idx[b, i]], moved as 32-bit
// words, for a lockstep batch of envs and up to kMaxFields fields that share
// one index array.
//
// Replaces the TPU kernel `_gather_kernel` of die_tpu/ops/pallas_gather.py
// (`pallas_onehot_gather`).  That kernel splits every f32 into four byte
// planes and moves them through one-hot bf16 matrix products, because the TPU
// has no fast indexed load.  What it computes is an indexed load that keeps
// every bit (-0.0, subnormals, NaN payloads, infinities); on Hopper that is a
// load through a 32-bit integer type, and nothing of the one-hot formulation
// is carried over.
//
// Bound: bytes.  Per index the kernel must read 4 bytes of index and write 4
// bytes a field, and read each env's fields once: B * N * (4 + 4 F) + B * F *
// M * 4 bytes (the bound the callers state, B * N * (4 + 8 F), counts a field
// read an index, the same where N = M).  No arithmetic to speak of.
//
// Two routes, chosen from the shape before the launch by
// ops/gather.py::gather_plan (or named by a caller that knows its indices):
//
// - l2 (gather_l2_kernel<F>, the first port's kernel): each thread owns
//   kPerThread consecutive indices of one env, reads them with one 16-byte
//   load where the row is aligned, issues all its field loads before the
//   first store, and writes 16 bytes per field.  Every index is a 4-byte
//   load of a field that stays in L2 while its env's blocks run (blocks are
//   numbered env-major) and moves a 32-byte sector, so its time follows the
//   order of the indices: near the byte bound where they are nearly sorted
//   or mostly one cell (an exact rollout's first steps; the deposit's row),
//   1.6x (F = 1) to 1.8x (F = 2) the bound once the agents have scattered
//   (PERF.md).
// - staged (staged_kernel<F, C>): C blocks (1, 2, 4 or 8), one block an SM,
//   launched as a cluster so that they run together, hold one env's fields
//   in shared memory, block r cells [r cells, (r + 1) cells) of every
//   field, each brought in by one cp.async.bulk a field on an mbarrier (the
//   fields are views with batch strides: per-field pointers and strides).
//   Every block reads the env's index row (or its cluster's share of it)
//   from device memory, kLoads positions a lane in flight, keeps the
//   indices in its own slice and stores their words: no read crosses to a
//   peer's shared memory (P6 measured distributed reads 6x to 13x slower
//   than routed ones, probe_gather.cu), and no block waits on another.  Its
//   time does not depend on the order of the indices: the index bytes leave
//   L2 C times and each output sector is written by up to C blocks, but the
//   fields are read once.  An env's indices are split over `per_env`
//   clusters, each with its own copy of the fields, where the batch leaves
//   SMs idle.  Two richer forms lost to this one on the H100 (PERF.md):
//   the index row multicast by cp.async.bulk into a ring of chunks in
//   every block of the cluster, refilled when every block had released a
//   slot, is held by that round trip a chunk; and routing each word by
//   st.async to the block that stores its part of the chunk, for whole
//   sectors, costs a 4-byte message a word.

// An index outside [0, M) gives an unspecified word and never a fault or a
// hang: on the staged route block C - 1 takes every index at or above its
// first cell (a negative one too) and clamps it into its slice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_push.cuh"

namespace {

constexpr int kMaxFields = 4;

struct GatherArgs {
  const uint32_t* field[kMaxFields];  // field f of env 0
  long long stride[kMaxFields];       // words between consecutive envs
  const int32_t* idx;                 // [B, N]
  uint32_t* out;                      // [B, F, N]
  int N;
  int M;
  int chunks;   // l2: blocks per env
  int vec;      // l2: 1 where rows of idx and out are 16-byte aligned
  int cells;    // staged: cells of each field a block holds
  int per_env;  // staged: clusters an env
  int share;    // staged: indices a cluster (a multiple of 4)
};

// ---- the staged route ---------------------------------------------------------
constexpr int kSThreads = 1024;  // one block an SM (ops/gather.py STAGED_THREADS)
constexpr int kLoads = 16;       // index loads a lane keeps in flight (LOADS)
constexpr int kMaxSmem = 232448; // a block's dynamic shared memory (BLOCK_SMEM)

constexpr int staged_smem(int F, int cells) {
  return F * cells * 4 + 16;  // the slices and the field barrier
}

// `bytes` (a multiple of 16) from device memory into this block's shared
// memory, counted on its mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int F, int C>
__global__ void __launch_bounds__(kSThreads, 1)
staged_kernel(const GatherArgs a) {
  extern __shared__ __align__(16) unsigned char raw[];
  const uint32_t* slice = reinterpret_cast<const uint32_t*>(raw);  // [F][cells]
  const uint32_t bar = smem_addr(raw + F * a.cells * 4);
  const int rank = (int)(blockIdx.x % C);  // the block's rank in its cluster
  const long long cl = blockIdx.x / C;
  const long long env = cl / a.per_env;
  const int start = (int)(cl % a.per_env) * a.share;
  const int n = min(a.N, start + a.share) - start;
  const int lo = rank * a.cells;
  const int len = max(0, min(a.cells, a.M - lo));
  if (threadIdx.x == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_expect(bar, (uint32_t)(F * len) * 4u);
    if (len > 0) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        bulk_load(smem_addr(slice + f * a.cells),
                  a.field[f] + env * a.stride[f] + lo, (uint32_t)len * 4u,
                  bar);
    }
  }
  __syncthreads();  // the barrier initialised before anyone waits on it

  // warp w takes positions w 32 kLoads + q 32 + lane of each step of
  // kSThreads kLoads positions, and keeps the indices of its block's slice
  // (block C - 1: every index at or above its first cell, clamped into the
  // slice, so that one outside [0, M) reads a word of it)
  const int32_t* row = a.idx + env * a.N + start;
  uint32_t* o = a.out + env * F * a.N + start;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t ulen = (uint32_t)len;
  bool landed = false;
  for (int base = warp * 32 * kLoads; base < n; base += kSThreads * kLoads) {
    uint32_t id[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = base + q * 32 + lane;
      id[q] = i < n ? (uint32_t)__ldg(row + i) : 0u;
    }
    if (!landed) {  // the slices, once, after the first loads are issued
      bar_wait(bar, 0);
      landed = true;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = base + q * 32 + lane;
      const uint32_t u = id[q] - (uint32_t)lo;  // wraps below lo
      const bool mine =
          C == 1 || (rank == C - 1 ? id[q] >= (uint32_t)lo : u < ulen);
      if (i < n && mine) {
        const uint32_t off = min(u, ulen - 1u);
#pragma unroll
        for (int f = 0; f < F; ++f)
          o[(long long)f * a.N + i] = slice[f * a.cells + off];
      }
    }
  }
  if (!landed) bar_wait(bar, 0);  // no block leaves with its copy in flight
}

// ---- the l2 route -------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kPerThread = 4;

template <int F>
__device__ __forceinline__ void gather_items(const GatherArgs& a, int b,
                                             int i0) {
  const int32_t* idx = a.idx + (long long)b * a.N;
  uint32_t* out = a.out + (long long)b * F * a.N;
  int id[kPerThread];
  uint32_t v[F][kPerThread];
  if (a.vec && i0 + kPerThread <= a.N) {
    const int4 q = *reinterpret_cast<const int4*>(idx + i0);
    id[0] = q.x; id[1] = q.y; id[2] = q.z; id[3] = q.w;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const uint32_t* src = a.field[f] + (long long)b * a.stride[f];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) v[f][k] = __ldg(src + id[k]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      uint4 w;
      w.x = v[f][0]; w.y = v[f][1]; w.z = v[f][2]; w.w = v[f][3];
      *reinterpret_cast<uint4*>(out + (long long)f * a.N + i0) = w;
    }
    return;
  }
  for (int k = 0; k < kPerThread; ++k) {
    const int i = i0 + k;
    if (i >= a.N) return;
    const int j = idx[i];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      out[(long long)f * a.N + i] =
          __ldg(a.field[f] + (long long)b * a.stride[f] + j);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gather_l2_kernel(const GatherArgs a) {
  const long long blk = blockIdx.x;
  const int b = (int)(blk / a.chunks);
  const int c = (int)(blk - (long long)b * a.chunks);
  const int i0 = (c * kThreads + (int)threadIdx.x) * kPerThread;
  if (i0 < a.N) gather_items<F>(a, b, i0);
}

template <int F, int C>
int launch_staged(const GatherArgs& a, int B, cudaStream_t s) {
  static bool prepared = false;  // the attribute, once a process
  if (!prepared) {
    const int rc = (int)cudaFuncSetAttribute(
        staged_kernel<F, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (rc) return rc;
    prepared = true;
  }
  const long long blocks = (long long)B * a.per_env * C;
  if (blocks > 2147483647LL) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = staged_smem(F, a.cells);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const int rc = (int)cudaLaunchKernelEx(&cfg, staged_kernel<F, C>, a);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_staged_f(const GatherArgs& a, int B, int C, cudaStream_t s) {
  switch (C) {
    case 1: return launch_staged<F, 1>(a, B, s);
    case 2: return launch_staged<F, 2>(a, B, s);
    case 4: return launch_staged<F, 4>(a, B, s);
    default: return launch_staged<F, 8>(a, B, s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// f0..f3: field f of env 0 (F used, the rest ignored); s0..s3: their word
// strides between envs; idx [B, N] int32; out [B, F, N]; plan: the int32
// words of ops/gather.py::GatherPlan (route 0 l2 / 1 staged, B, F, M, N,
// cluster, cells, per_env, share, smem).  Returns the CUDA error of the
// launch (0 = ok, -1 = a plan or arguments the kernel does not take).
extern "C" int die_gather_fields(const void* f0, const void* f1,
                                 const void* f2, const void* f3, long long s0,
                                 long long s1, long long s2, long long s3,
                                 const void* idx, void* out, const int* plan,
                                 void* stream) {
  const int route = plan[0], B = plan[1], F = plan[2], M = plan[3],
            N = plan[4];
  if (B < 1 || N < 1 || M < 1 || F < 1 || F > kMaxFields) return -1;
  GatherArgs a = {};
  const void* fp[kMaxFields] = {f0, f1, f2, f3};
  const long long sp[kMaxFields] = {s0, s1, s2, s3};
  for (int f = 0; f < kMaxFields; ++f) {
    a.field[f] = static_cast<const uint32_t*>(fp[f]);
    a.stride[f] = sp[f];
  }
  a.idx = static_cast<const int32_t*>(idx);
  a.out = static_cast<uint32_t*>(out);
  a.N = N;
  a.M = M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const int C = plan[5];
    a.cells = plan[6];
    a.per_env = plan[7];
    a.share = plan[8];
    if ((C != 1 && C != 2 && C != 4 && C != 8) || a.cells < 4 ||
        a.cells % 4 || (long long)(C - 1) * a.cells >= M ||
        (long long)C * a.cells < M || a.per_env < 1 || a.share < 1 ||
        (long long)a.per_env * a.share < N ||
        plan[9] != staged_smem(F, a.cells) || plan[9] > kMaxSmem || M % 4)
      return -1;
    for (int f = 0; f < F; ++f)
      if (!aligned16(fp[f]) || (B > 1 && sp[f] % 4)) return -1;
    switch (F) {
      case 1: return launch_staged_f<1>(a, B, C, s);
      case 2: return launch_staged_f<2>(a, B, C, s);
      case 3: return launch_staged_f<3>(a, B, C, s);
      default: return launch_staged_f<4>(a, B, C, s);
    }
  }
  if (route != 0) return -1;
  a.chunks = (N + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  a.vec = (N % kPerThread == 0) && aligned16(idx) && aligned16(out);
  const long long blocks = (long long)B * a.chunks;
  if (blocks > 2147483647LL) return -1;
  const dim3 grid((unsigned)blocks), block(kThreads);
  switch (F) {
    case 1: gather_l2_kernel<1><<<grid, block, 0, s>>>(a); break;
    case 2: gather_l2_kernel<2><<<grid, block, 0, s>>>(a); break;
    case 3: gather_l2_kernel<3><<<grid, block, 0, s>>>(a); break;
    default: gather_l2_kernel<4><<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
