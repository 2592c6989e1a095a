// tree_sum_2d: the order-pinned fp32 reward fold, one sum per env of an
// f32 [B, W, H] field (W and H powers of two).
//
// Replaces the reward reduction inside die_tpu/fast/pallas_step.py::
// _multi_step_kernel (fast/env.py::tree_sum_2d on the kernel's gain field).
// Plain twin: die_tpu_torch/fast/env.py::tree_sum_2d; the two agree bit for
// bit.  The pairing is the reference's: fold rows first (at each level row
// i pairs with row i + n/2, for every column), then fold the columns the
// same way.  A band-, tile- or warp-order sum would round differently.
//
// Bound on an H100: bytes.  The kernel reads the field once (4 bytes a
// cell) and does one add a cell.
//
// Design: a streaming fold, one launch.  Block (env b, column split s) runs
// T = G * QT threads; thread (w, q) owns column vector q (V = 4 columns, one
// 16-byte load) of the block's QT vectors and the rows w + k G, k < m = W/G.
// Every row level with n >= G pairs two rows of the same thread, so the
// thread folds those levels in registers: it streams its rows in chunks of
// CH rows (all CH loads in flight), chunk c holding rows k = c + r (m/CH),
// folds each chunk over r, and takes the chunks in bit-reversed order of c
// through a stack of log2(m/CH) partials.  That order makes the stack's
// left-to-right pairs exactly the reference's stride-halving pairs.  The
// last log2 G row levels and the column levels are one stride-halving fold
// of the block's T partials (flat index w * QT + q: strides >= QT are row
// levels, the rest column levels) in shared memory down to 32 entries, then
// warp shuffles; the last log2 V column levels are inside the vector.
// A block never waits on another.
//
// Where B alone gives too few blocks to fill the card (8 x 1024^2, 64 x
// 2048^2, 32 x 512^2), the columns split over S blocks an env; each block
// stops at its QT column vectors and writes them to a [B, H] scratch row,
// and a second, short launch of this same kernel (in the same call) folds
// that row as a [B, H/V, V] field.  A cluster whose leader folds the
// partials was not taken: the second pass reads B*H floats, under 1% of the
// first.  The block shape, V and S come from the host (fast/cuda_step.py::
// fold_plans), whose schedule the CPU tests run in numpy against the
// reference.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxStack = 3;  // m / CH <= 8 chunks a thread (m <= 64)

template <int V> struct VecT;
template <> struct VecT<4> { using T = float4; };
template <> struct VecT<2> { using T = float2; };
template <> struct VecT<1> { using T = float; };

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }

__device__ __forceinline__ float4 shfl_down(float4 v, int n, unsigned mask) {
  return make_float4(__shfl_down_sync(mask, v.x, n),
                     __shfl_down_sync(mask, v.y, n),
                     __shfl_down_sync(mask, v.z, n),
                     __shfl_down_sync(mask, v.w, n));
}
__device__ __forceinline__ float2 shfl_down(float2 v, int n, unsigned mask) {
  return make_float2(__shfl_down_sync(mask, v.x, n),
                     __shfl_down_sync(mask, v.y, n));
}
__device__ __forceinline__ float shfl_down(float v, int n, unsigned mask) {
  return __shfl_down_sync(mask, v, n);
}

// the last column levels, inside one vector: (c0 + c2) + (c1 + c3)
__device__ __forceinline__ float lanes_sum(float4 v) {
  return (v.x + v.z) + (v.y + v.w);
}
__device__ __forceinline__ float lanes_sum(float2 v) { return v.x + v.y; }
__device__ __forceinline__ float lanes_sum(float v) { return v; }

// x: [B, W, H] as [B, W, Q] vectors (Q = H / V).  S == 1: out[b] is the
// env's sum.  S > 1: dst[b, s * QT + q] (vectors) are the block's column
// sums after every row level.
template <int V, int CH>
__global__ void __launch_bounds__(kMaxThreads)
    k_fold(const float* __restrict__ x, float* __restrict__ dst, int W, int H,
           int G, int QT, int S) {
  using vec = typename VecT<V>::T;
  extern __shared__ unsigned char smem_raw[];
  vec* part = reinterpret_cast<vec*>(smem_raw);  // [T]
  const int T = G * QT;
  const int Q = H / V;
  const int b = blockIdx.x / S;
  const int s = blockIdx.x - b * S;
  const int t = threadIdx.x;
  const int w = t / QT;
  const int qv = t - w * QT;
  const vec* f = reinterpret_cast<const vec*>(x) + (long long)b * W * Q +
                 (long long)s * QT + qv;
  const long long row_step = (long long)G * Q;  // rows k and k + 1
  const int m = W / G;
  const int nc = m / CH;
  const int levels = __ffs(nc) - 1;  // log2(nc)

  vec stack[kMaxStack];
  vec carry;
  for (int i = 0; i < nc; ++i) {
    const int c = levels ? (int)(__brev((unsigned)i) >> (32 - levels)) : 0;
    vec v[CH];
#pragma unroll
    for (int r = 0; r < CH; ++r)
      v[r] = __ldg(f + (long long)w * Q + (long long)(c + r * nc) * row_step);
#pragma unroll
    for (int n = CH / 2; n >= 1; n /= 2)
#pragma unroll
      for (int r = 0; r < n; ++r) v[r] = vadd(v[r], v[r + n]);
    carry = v[0];
    bool open = true;
#pragma unroll
    for (int l = 0; l < kMaxStack; ++l) {
      if (open && l < levels) {
        if ((i >> l) & 1) {
          carry = vadd(stack[l], carry);
        } else {
          stack[l] = carry;
          open = false;
        }
      }
    }
  }

  part[t] = carry;
  __syncthreads();
  const int stop = S > 1 ? QT : 1;
  for (int n = T / 2; n >= stop && n >= 32; n >>= 1) {
    if (t < n) part[t] = vadd(part[t], part[t + n]);
    __syncthreads();
  }
  vec* cols = reinterpret_cast<vec*>(dst) + (long long)b * Q +
              (long long)s * QT;
  if (stop >= 32) {
    if (t < stop) cols[t] = part[t];
    return;
  }
  const int live = T < 32 ? T : 32;
  if (t < live) {
    const unsigned mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
    vec v = part[t];
    for (int n = live / 2; n >= stop; n >>= 1)
      v = vadd(v, shfl_down(v, n, mask));
    if (S > 1) {
      if (t < stop) cols[t] = v;
    } else if (t == 0) {
      dst[b] = lanes_sum(v);
    }
  }
}

template <int V>
cudaError_t launch_v(const float* x, float* dst, int B, int W, int H, int G,
                     int QT, int S, int CH, cudaStream_t st) {
  const int T = G * QT;
  const size_t smem = (size_t)T * V * sizeof(float);
  const dim3 grid((unsigned)(B * S));
  switch (CH) {
    case 1: k_fold<V, 1><<<grid, T, smem, st>>>(x, dst, W, H, G, QT, S); break;
    case 2: k_fold<V, 2><<<grid, T, smem, st>>>(x, dst, W, H, G, QT, S); break;
    case 4: k_fold<V, 4><<<grid, T, smem, st>>>(x, dst, W, H, G, QT, S); break;
    case 8: k_fold<V, 8><<<grid, T, smem, st>>>(x, dst, W, H, G, QT, S); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// One launch's plan (V, G, QT, S, CH) fits the kernel for a [B, W, H] field.
bool fits(const int* pl, int W, int H) {
  const int V = pl[0], G = pl[1], QT = pl[2], S = pl[3], CH = pl[4];
  return pow2(W) && pow2(H) && pow2(V) && V <= 4 && H % V == 0 && pow2(G) &&
         pow2(QT) && pow2(S) && pow2(CH) && CH <= 8 &&
         G * QT <= kMaxThreads && W % G == 0 && QT * S * V == H &&
         (W / G) % CH == 0 && (W / G) / CH <= (1 << kMaxStack);
}

cudaError_t launch(const float* x, float* dst, int B, int W, int H,
                   const int* pl, cudaStream_t st) {
  const int G = pl[1], QT = pl[2], S = pl[3], CH = pl[4];
  switch (pl[0]) {
    case 4: return launch_v<4>(x, dst, B, W, H, G, QT, S, CH, st);
    case 2: return launch_v<2>(x, dst, B, W, H, G, QT, S, CH, st);
    default: return launch_v<1>(x, dst, B, W, H, G, QT, S, CH, st);
  }
}

}  // namespace

// The fold with the host's plans (fast/cuda_step.py::fold_plans): x f32
// [B, W, H] contiguous and aligned to 4 * V bytes; plans[0..4] the field's
// launch (V columns a vector, G row groups, QT vectors a block, S blocks an
// env, CH rows a chunk).  S == 1: out f32 [B] takes the sums.  S > 1:
// colsum f32 [B, H] takes each block's column sums and plans[5..9] fold
// them, as a [B, H/V, V] field, into out.  Returns a cudaError_t.
extern "C" int die_tree_sum_2d(const float* x, float* colsum, float* out,
                               int B, int W, int H, const int* plans,
                               void* stream) {
  const int V = plans[0], S = plans[3];
  if (B < 1 || !fits(plans, W, H) || ((size_t)x & (sizeof(float) * V - 1)) ||
      (S > 1 && (!fits(plans + 5, H / V, V) || plans[5] != V ||
                 plans[8] != 1 || ((size_t)colsum & (sizeof(float) * V - 1)))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S == 1) return (int)launch(x, out, B, W, H, plans, st);
  const cudaError_t e = launch(x, colsum, B, W, H, plans, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(colsum, out, B, H / V, V, plans + 5, st);
}
