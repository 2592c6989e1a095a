// gather_fields (K5): out[b, f, i] = fields[f][b, idx[b, i]], moved as 32-bit
// words, for a lockstep batch of envs and up to kMaxFields fields that share
// one index array.
//
// Replaces the TPU kernel `_gather_kernel` of die_tpu/ops/pallas_gather.py
// (`pallas_onehot_gather`).  That kernel splits every f32 into four byte
// planes and moves them through one-hot bf16 matrix products, because the TPU
// has no fast indexed load.  What it computes is an indexed load that keeps
// every bit (-0.0, subnormals, NaN payloads, infinities); on Hopper that is a
// plain load through a 32-bit integer type, and nothing of the one-hot
// formulation is carried over.
//
// Bound: bytes.  Per index the kernel reads 4 bytes of index and 4 bytes of
// each field, and writes 4 bytes per field: B * N * (4 + 8 * F) bytes, no
// arithmetic to speak of.  The design follows from that: each thread owns
// kPerThread consecutive indices of one env, reads them with one 16-byte load
// where the row is aligned, issues all its field loads before the first
// store (so the random reads overlap), and writes 16 bytes per field.  The
// index array and the output are streamed once, coalesced; the random reads
// land in one env's field (256 KB at 256x256), which stays in L2 while the
// blocks of that env run, because blocks are numbered env-major.
//
// Precondition (not checked on the device): 0 <= idx < M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 4;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;

struct GatherArgs {
  const uint32_t* field[kMaxFields];  // field f of env 0
  long long stride[kMaxFields];       // words between consecutive envs
  const int32_t* idx;                 // [B, N]
  uint32_t* out;                      // [B, F, N]
  int N;
  int chunks;                         // blocks per env
  int vec;                            // 1: rows of idx and out are 16-byte aligned
};

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
gather_fields_kernel(const GatherArgs a) {
  const long long blk = blockIdx.x;
  const int b = (int)(blk / a.chunks);
  const int c = (int)(blk - (long long)b * a.chunks);
  const int i0 = (c * kThreads + (int)threadIdx.x) * kPerThread;
  if (i0 < a.N) gather_items<F>(a, b, i0);
}

}  // namespace

// fields: host array of F device pointers; strides: host array of F word
// strides between envs.  Returns the CUDA error of the launch (0 = ok, -1 =
// arguments out of range).
extern "C" int die_gather_fields(const void* const* fields,
                                 const long long* strides, const void* idx,
                                 void* out, int B, int F, int N,
                                 void* stream) {
  if (B < 1 || N < 1 || F < 1 || F > kMaxFields) return -1;
  GatherArgs a;
  for (int f = 0; f < kMaxFields; ++f) {
    a.field[f] = static_cast<const uint32_t*>(fields[f < F ? f : 0]);
    a.stride[f] = strides[f < F ? f : 0];
  }
  a.idx = static_cast<const int32_t*>(idx);
  a.out = static_cast<uint32_t*>(out);
  a.N = N;
  a.chunks = (N + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  a.vec = (N % kPerThread == 0) &&
          (reinterpret_cast<uintptr_t>(idx) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long blocks = (long long)B * a.chunks;
  if (blocks > 2147483647LL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kThreads);
  switch (F) {
    case 1: gather_fields_kernel<1><<<grid, block, 0, s>>>(a); break;
    case 2: gather_fields_kernel<2><<<grid, block, 0, s>>>(a); break;
    case 3: gather_fields_kernel<3><<<grid, block, 0, s>>>(a); break;
    default: gather_fields_kernel<4><<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
