// The chem diffusion of one 256x256 f32 field, applied `apps` times, on the
// CUDA cores and on the tensor cores.
//
// die_probe_stencil (P4, stencil leg): y = G(x) * decay with G the separable
//   wrap Gaussian, taps folded from -r to +r, axis 0 and then axis 1: the
//   order of ops/gaussian.py and of K1's phase 7 (lattice_step.cuh).
// die_probe_tc (P4's product legs, P5's product leg): y = (A x A^T) * decay
//   (two-sided) or y = A x + add (one-sided; A the permutation P gives
//   roll(x, 1, 0) + 1), with mma.sync on the tensor cores: TF32 inputs
//   (cvt.rna.tf32.f32, the counterpart of the TPU's f32 dot) or bf16 inputs
//   (the counterpart of its bf16 dot, the product between the two sides
//   rounded to bf16 too), f32 accumulation.
// Both replace `make_diffuse_kernel` of tools/tpu_mxu_offload.py (the
// pallas_call at :127); the one-sided product replaces the `mxu` leg of
// `make_roll_kernel` (:180).
//
// The field stays on chip for all applications, as it stays in VMEM on the
// TPU: a cluster of 4 blocks holds it, 64 rows on each, and the half of the
// work that mixes rows (the axis-0 pass; A x) reads the other blocks' rows
// through distributed shared memory, while the half that mixes columns (the
// axis-1 pass; (A x) A^T) reads only the block's own rows.  Two field
// buffers ping-pong, so one cluster barrier closes an application.  The
// dense 256x256 A (256 KB in f32, 128 KB in bf16) does not fit beside the
// field's share: it is streamed from L2 with __ldg at every use.
//
// Bounds: the stencil is 2 (2 ntaps - 1) + 1 fp32 operations a cell an
// application over the CUDA cores' rate; a two-sided product is 4 * 256^3
// FLOP an application over the tensor cores' rate (495 TFLOP/s TF32, 989
// bf16), about 50 times the stencil's arithmetic at ntaps = 5.  The stencil
// is bitwise equal to its plain version; the tensor cores' sums follow their
// own order, so the product legs agree with theirs to a tolerance.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 256;
constexpr long long kField = (long long)kN * kN;
constexpr int kCta = 4;
constexpr int kRows = kN / kCta;  // 64 rows a block
constexpr int kMaxTaps = 16;

// ---- stencil ------------------------------------------------------------------
constexpr int kStThreads = 512;
constexpr int kStBuf = kRows * kN;
constexpr int kStSmem = 3 * kStBuf * 4 + 2 * kN * (int)sizeof(float*);

struct StencilParams {
  float taps[kMaxTaps];
  int ntaps;
  int apps;
  float decay;
};

__global__ void __cluster_dims__(kCta, 1, 1) __launch_bounds__(kStThreads, 1)
stencil_kernel(const float* __restrict__ x, float* __restrict__ out,
               const StencilParams p) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* buf = reinterpret_cast<float*>(raw);  // [2][kRows][kN]
  float* tmp = buf + 2 * kStBuf;               // [kRows][kN]
  const float** tab = reinterpret_cast<const float**>(tmp + kStBuf);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long env = blockIdx.x / kCta;
  for (int i = threadIdx.x; i < 2 * kN; i += kStThreads) {
    const int b = i / kN, g = i % kN;
    tab[i] = cl.map_shared_rank(buf + b * kStBuf, g / kRows) +
             (g % kRows) * kN;
  }
  const float* xe = x + env * kField + (long long)rank * kStBuf;
  for (int e = threadIdx.x; e < kStBuf; e += kStThreads) buf[e] = xe[e];
  cl.sync();

  const int r = (p.ntaps - 1) / 2;
  int cur = 0;
#pragma unroll 1
  for (int a = 0; a < p.apps; ++a) {
    const float* const* rows = tab + cur * kN;
    // axis 0: rows g - r .. g + r, from whichever block holds them
    for (int e = threadIdx.x; e < kStBuf; e += kStThreads) {
      const int lr = e / kN, c = e % kN, g = rank * kRows + lr;
      float acc = p.taps[0] * rows[(g - r) & (kN - 1)][c];
      for (int k = 1; k < p.ntaps; ++k)
        acc = acc + p.taps[k] * rows[(g + k - r) & (kN - 1)][c];
      tmp[e] = acc;
    }
    __syncthreads();
    // axis 1: the block's own rows
    float* dst = buf + (cur ^ 1) * kStBuf;
    for (int e = threadIdx.x; e < kStBuf; e += kStThreads) {
      const int lr = e / kN, c = e % kN;
      const float* t = tmp + lr * kN;
      float acc = p.taps[0] * t[(c - r) & (kN - 1)];
      for (int k = 1; k < p.ntaps; ++k)
        acc = acc + p.taps[k] * t[(c + k - r) & (kN - 1)];
      dst[e] = acc * p.decay;
    }
    cl.sync();
    cur ^= 1;
  }
  float* oe = out + env * kField + (long long)rank * kStBuf;
  for (int e = threadIdx.x; e < kStBuf; e += kStThreads)
    oe[e] = buf[cur * kStBuf + e];
}

// ---- tensor cores ---------------------------------------------------------------
// 8 warps; warp w computes rows 16 (w % 4) .. +16 and columns 128 (w / 4) ..
// +128 of the block's 64 x 256 share: 16 tiles of m16n8 in registers.
constexpr int kTcThreads = 256;
constexpr int kXs = kN + 8;  // row stride of the field buffers (B operand
                             // reads of 4 rows x 8 columns hit 32 banks)
constexpr int kYs = kN + 4;  // row stride of A x (A operand reads of 8 rows
                             // x 4 columns hit 32 banks)
constexpr int kTcSmem = (2 * kRows * kXs + kRows * kYs) * 4 +
                        2 * kN * (int)sizeof(float*);
constexpr int kTiles = 16;

struct TcParams {
  int apps;
  int two_sided;
  float decay;  // two-sided: y = acc * decay
  float add;    // one-sided: y = acc + add
};

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc = A[rows m .. m + 16, :] . X with the B operand X[k][n] = xrow(k)[n] (f32 in
// shared memory, here or on another block); A from device memory
template <bool BF16>
__device__ __forceinline__ void product_left(float (&acc)[kTiles][4],
                                             const void* A, int m,
                                             const float* const* xrows,
                                             int n0, int g, int t) {
  if constexpr (!BF16) {
    const float* r0 = static_cast<const float*>(A) + (m + g) * kN + t;
    const float* r1 = r0 + 8 * kN;
#pragma unroll 1
    for (int k0 = 0; k0 < kN; k0 += 8) {
      const uint32_t a0 = tf32(__ldg(r0 + k0)), a1 = tf32(__ldg(r1 + k0));
      const uint32_t a2 = tf32(__ldg(r0 + k0 + 4));
      const uint32_t a3 = tf32(__ldg(r1 + k0 + 4));
      const float* x0 = xrows[k0 + t];
      const float* x1 = xrows[k0 + t + 4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int n = n0 + 8 * j + g;
        mma_tf32(acc[j], a0, a1, a2, a3, tf32(x0[n]), tf32(x1[n]));
      }
    }
  } else {
    constexpr int kW = kN / 2;  // words (bf16 pairs) of a row
    const uint32_t* r0 = static_cast<const uint32_t*>(A) + (m + g) * kW + t;
    const uint32_t* r1 = r0 + 8 * kW;
#pragma unroll 1
    for (int k0 = 0; k0 < kN; k0 += 16) {
      const int kw = k0 / 2;
      const uint32_t a0 = __ldg(r0 + kw), a1 = __ldg(r1 + kw);
      const uint32_t a2 = __ldg(r0 + kw + 4), a3 = __ldg(r1 + kw + 4);
      const float* x0 = xrows[k0 + 2 * t];
      const float* x1 = xrows[k0 + 2 * t + 1];
      const float* x2 = xrows[k0 + 2 * t + 8];
      const float* x3 = xrows[k0 + 2 * t + 9];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int n = n0 + 8 * j + g;
        mma_bf16(acc[j], a0, a1, a2, a3, bf2(x0[n], x1[n]), bf2(x2[n], x3[n]));
      }
    }
  }
}

// acc = Y[rows m .. m + 16, :] . A^T with Y the block's own rows (stride kYs) and the
// B operand A^T[k][n] = A[n][k] from device memory
template <bool BF16>
__device__ __forceinline__ void product_right(float (&acc)[kTiles][4],
                                              const void* A, const float* y,
                                              int m, int n0, int g, int t) {
  const float* y0 = y + (m + g) * kYs;
  const float* y1 = y0 + 8 * kYs;
  if constexpr (!BF16) {
    const float* Af = static_cast<const float*>(A);
#pragma unroll 1
    for (int k0 = 0; k0 < kN; k0 += 8) {
      const uint32_t a0 = tf32(y0[k0 + t]), a1 = tf32(y1[k0 + t]);
      const uint32_t a2 = tf32(y0[k0 + t + 4]), a3 = tf32(y1[k0 + t + 4]);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const float* an = Af + (n0 + 8 * j + g) * kN + k0 + t;
        mma_tf32(acc[j], a0, a1, a2, a3, tf32(__ldg(an)), tf32(__ldg(an + 4)));
      }
    }
  } else {
    const uint32_t* Ab = static_cast<const uint32_t*>(A);
    constexpr int kW = kN / 2;
#pragma unroll 1
    for (int k0 = 0; k0 < kN; k0 += 16) {
      const int k = k0 + 2 * t;
      const uint32_t a0 = bf2(y0[k], y0[k + 1]), a1 = bf2(y1[k], y1[k + 1]);
      const uint32_t a2 = bf2(y0[k + 8], y0[k + 9]);
      const uint32_t a3 = bf2(y1[k + 8], y1[k + 9]);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const uint32_t* an = Ab + (n0 + 8 * j + g) * kW + k0 / 2 + t;
        mma_bf16(acc[j], a0, a1, a2, a3, __ldg(an), __ldg(an + 4));
      }
    }
  }
}

// the C fragment of tile j: (m + g, n), (m + g, n + 1), (m + g + 8, n),
// (m + g + 8, n + 1) with n = n0 + 8 j + 2 t
template <typename F>
__device__ __forceinline__ void store_tiles(const float (&acc)[kTiles][4],
                                            int m, int n0, int g, int t,
                                            F&& put) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    put(m + g, n, acc[j][0]);
    put(m + g, n + 1, acc[j][1]);
    put(m + g + 8, n, acc[j][2]);
    put(m + g + 8, n + 1, acc[j][3]);
  }
}

template <bool BF16>
__global__ void __cluster_dims__(kCta, 1, 1) __launch_bounds__(kTcThreads, 1)
tc_kernel(const float* __restrict__ x, float* __restrict__ out,
          const void* __restrict__ A, const TcParams p) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* xs = reinterpret_cast<float*>(raw);  // [2][kRows][kXs]
  float* ys = xs + 2 * kRows * kXs;           // [kRows][kYs]
  const float** tab = reinterpret_cast<const float**>(ys + kRows * kYs);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long env = blockIdx.x / kCta;
  for (int i = threadIdx.x; i < 2 * kN; i += kTcThreads) {
    const int b = i / kN, g = i % kN;
    tab[i] = cl.map_shared_rank(xs + b * kRows * kXs, g / kRows) +
             (g % kRows) * kXs;
  }
  const float* xe = x + env * kField + (long long)rank * kRows * kN;
  for (int e = threadIdx.x; e < kRows * kN; e += kTcThreads)
    xs[(e / kN) * kXs + e % kN] = xe[e];
  cl.sync();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = (warp & 3) * 16;   // row of the block's share
  const int n0 = (warp >> 2) * 128;
  const int mg = rank * kRows + m;  // row of A
  int cur = 0;
#pragma unroll 1
  for (int a = 0; a < p.apps; ++a) {
    float acc[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    product_left<BF16>(acc, A, mg, tab + cur * kN, n0, g, t);
    float* dst = xs + (cur ^ 1) * kRows * kXs;
    if (p.two_sided) {
      store_tiles(acc, m, n0, g, t,
                  [&](int r, int c, float v) { ys[r * kYs + c] = v; });
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      product_right<BF16>(acc, A, ys, m, n0, g, t);
      const float decay = p.decay;
      store_tiles(acc, m, n0, g, t, [&](int r, int c, float v) {
        dst[r * kXs + c] = __fmul_rn(v, decay);
      });
    } else {
      const float add = p.add;
      store_tiles(acc, m, n0, g, t, [&](int r, int c, float v) {
        dst[r * kXs + c] = __fadd_rn(v, add);
      });
    }
    cl.sync();
    cur ^= 1;
  }
  float* oe = out + env * kField + (long long)rank * kRows * kN;
  for (int e = threadIdx.x; e < kRows * kN; e += kTcThreads)
    oe[e] = xs[cur * kRows * kXs + (e / kN) * kXs + e % kN];
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// x, out: [B, 256, 256] f32 on the device; taps: host array of ntaps f32.
// Returns the CUDA error of the launch (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_stencil(const void* x, void* out, int B, int apps,
                                 const float* taps, int ntaps, float decay,
                                 void* stream) {
  if (B < 1 || B > 65535 || apps < 0 || ntaps < 1 || ntaps > kMaxTaps ||
      ntaps % 2 == 0)
    return -1;
  StencilParams p;
  for (int k = 0; k < kMaxTaps; ++k) p.taps[k] = k < ntaps ? taps[k] : 0.0f;
  p.ntaps = ntaps;
  p.apps = apps;
  p.decay = decay;
  const int rc = prepare(stencil_kernel, kStSmem);
  if (rc) return rc;
  stencil_kernel<<<B * kCta, kStThreads, kStSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// A: [256, 256] on the device, f32 (tf32 leg) or bf16 (bf16 != 0).
extern "C" int die_probe_tc(const void* x, void* out, const void* A, int B,
                            int apps, int bf16, int two_sided, float decay,
                            float add, void* stream) {
  if (B < 1 || B > 65535 || apps < 0) return -1;
  const TcParams p{apps, two_sided, decay, add};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  int rc;
  if (bf16) {
    rc = prepare(tc_kernel<true>, kTcSmem);
    if (!rc) tc_kernel<true><<<B * kCta, kTcThreads, kTcSmem, s>>>(xi, o, A, p);
  } else {
    rc = prepare(tc_kernel<false>, kTcSmem);
    if (!rc) tc_kernel<false><<<B * kCta, kTcThreads, kTcSmem, s>>>(xi, o, A, p);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
