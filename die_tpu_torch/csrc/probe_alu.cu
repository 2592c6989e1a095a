// probe_alu (P1): ALU throughput by kind and dtype.  Each element of a
// [B, 256, 256] field starts four independent chains x + i (i < 4); each
// chain runs `rounds` rounds of 8 operation pairs, and the element's result
// is the maximum of its chains:
//   fma     x = x * 0.999 + 1e-3          (f32, bf16)
//   cmpsel  x = x > 0.5 ? x * 0.25 : x + 0.5  (f32, bf16)
//   intops  x = x > 3 ? x - 7 : x + 5     (int32, int16, int8; wrapping)
//
// Replaces the TPU probe `make_micro` of tools/tpu_measure.py (the
// pallas_call at :107), which measures the TPU's packed VPU throughput per
// dtype on a VMEM-resident 256x256 block.  What it computes is elementwise,
// so there is nothing to keep on chip but registers: each thread holds one
// 32-bit word of the field (one f32 or int32, a bf16 or int16 pair, four
// int8) and its four chains in registers, and the arithmetic is packed the
// way the TPU's is: bf16 as __nv_bfloat162 pairs (mul.rn.bf16x2,
// add.rn.bf16x2: one rounding each, no contraction), int16 and int8 as the
// SIMD intrinsics (__vadd2 / __vadd4 and their compare, subtract and max).
// Every select computes both sides and picks by a mask, so no lane of a warp
// branches away from the others.  Under --fmad=false the f32 fma is a
// multiply and then an add, two roundings, as the lattice step's contract
// pays them.
//
// Bound: operations.  B * 4 * 16 * rounds * 256^2 operations (the TPU
// tool's count: a pair is two) over the lane rate of the dtype; the field is
// read and written once.  The constants (chain offsets, and the kind's three
// constants) come from the wrapper as 32-bit words in the dtype, repeated
// across the word's lanes, so the kernel uses the plain version's values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 8;  // operation pairs per chain per round

enum Kind { kFma = 0, kCmpSel = 1, kIntOps = 2 };
enum Dtype { kF32 = 0, kBF16 = 1, kI32 = 2, kI16 = 3, kI8 = 4 };

struct Consts {
  uint32_t ofs[4];  // chain offsets 0, 1, 2, 3 in the dtype
  uint32_t k[3];    // fma: mul, add; cmpsel: threshold, mul, add;
                    // intops: threshold, sub, add
};

__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_gt_mask(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  return __hgt2_mask(x, y);
}

__device__ __forceinline__ uint32_t bf2_max(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 m = __hmax2(x, y);
  return *reinterpret_cast<uint32_t*>(&m);
}

__device__ __forceinline__ uint32_t select(uint32_t m, uint32_t a,
                                           uint32_t b) {
  return (m & a) | (~m & b);
}

template <int DT>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if constexpr (DT == kF32) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  } else if constexpr (DT == kBF16) {
    return bf2_add(a, b);
  } else if constexpr (DT == kI32) {
    return a + b;
  } else if constexpr (DT == kI16) {
    return __vadd2(a, b);
  } else {
    return __vadd4(a, b);
  }
}

template <int DT>
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
  if constexpr (DT == kF32) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  } else if constexpr (DT == kBF16) {
    return bf2_max(a, b);
  } else if constexpr (DT == kI32) {
    return (uint32_t)max((int)a, (int)b);
  } else if constexpr (DT == kI16) {
    return __vmaxs2(a, b);
  } else {
    return __vmaxs4(a, b);
  }
}

template <int KIND, int DT>
__device__ __forceinline__ uint32_t op_pair(uint32_t x, const Consts& c) {
  if constexpr (KIND == kFma) {
    if constexpr (DT == kF32) {
      const float v = __uint_as_float(x);
      return __float_as_uint(__fadd_rn(__fmul_rn(v, __uint_as_float(c.k[0])),
                                       __uint_as_float(c.k[1])));
    } else {
      return bf2_add(bf2_mul(x, c.k[0]), c.k[1]);
    }
  } else if constexpr (KIND == kCmpSel) {
    if constexpr (DT == kF32) {
      // both sides, then a select: no branch for the lanes to diverge on
      const float v = __uint_as_float(x);
      const uint32_t m = v > __uint_as_float(c.k[0]) ? 0xffffffffu : 0u;
      return select(m, __float_as_uint(__fmul_rn(v, __uint_as_float(c.k[1]))),
                    __float_as_uint(__fadd_rn(v, __uint_as_float(c.k[2]))));
    } else {
      return select(bf2_gt_mask(x, c.k[0]), bf2_mul(x, c.k[1]),
                    bf2_add(x, c.k[2]));
    }
  } else {
    if constexpr (DT == kI32) {
      const uint32_t m = (int)x > (int)c.k[0] ? 0xffffffffu : 0u;
      return select(m, x - c.k[1], x + c.k[2]);
    } else if constexpr (DT == kI16) {
      return select(__vcmpgts2(x, c.k[0]), __vsub2(x, c.k[1]),
                    __vadd2(x, c.k[2]));
    } else {
      return select(__vcmpgts4(x, c.k[0]), __vsub4(x, c.k[1]),
                    __vadd4(x, c.k[2]));
    }
  }
}

template <int KIND, int DT>
__global__ void __launch_bounds__(kThreads)
alu_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           long long words, int rounds, const Consts c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= words) return;
  const uint32_t w = x[i];
  uint32_t c0 = add<DT>(w, c.ofs[0]), c1 = add<DT>(w, c.ofs[1]);
  uint32_t c2 = add<DT>(w, c.ofs[2]), c3 = add<DT>(w, c.ofs[3]);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      c0 = op_pair<KIND, DT>(c0, c);
      c1 = op_pair<KIND, DT>(c1, c);
      c2 = op_pair<KIND, DT>(c2, c);
      c3 = op_pair<KIND, DT>(c3, c);
    }
  }
  out[i] = vmax<DT>(vmax<DT>(vmax<DT>(c0, c1), c2), c3);
}

template <int KIND, int DT>
void launch(const void* x, void* out, long long words, int rounds,
            const Consts& c, cudaStream_t s) {
  const long long blocks = (words + kThreads - 1) / kThreads;
  alu_kernel<KIND, DT><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), words,
      rounds, c);
}

}  // namespace

// x, out: device arrays of `words` 32-bit words; consts: host array of 7
// words (4 chain offsets, 3 constants).  Returns the CUDA error of the
// launch (0 = ok, -1 = arguments out of range or no such case).
extern "C" int die_probe_alu(const void* x, void* out, long long words,
                             int kind, int dtype, int rounds,
                             const uint32_t* consts, void* stream) {
  if (words < 1 || rounds < 0 || (words + kThreads - 1) / kThreads >
                                     2147483647LL)
    return -1;
  Consts c;
  for (int i = 0; i < 4; ++i) c.ofs[i] = consts[i];
  for (int i = 0; i < 3; ++i) c.k[i] = consts[4 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = kind * 8 + dtype;
  switch (code) {
    case kFma * 8 + kF32: launch<kFma, kF32>(x, out, words, rounds, c, s); break;
    case kFma * 8 + kBF16: launch<kFma, kBF16>(x, out, words, rounds, c, s); break;
    case kCmpSel * 8 + kF32: launch<kCmpSel, kF32>(x, out, words, rounds, c, s); break;
    case kCmpSel * 8 + kBF16: launch<kCmpSel, kBF16>(x, out, words, rounds, c, s); break;
    case kIntOps * 8 + kI32: launch<kIntOps, kI32>(x, out, words, rounds, c, s); break;
    case kIntOps * 8 + kI16: launch<kIntOps, kI16>(x, out, words, rounds, c, s); break;
    case kIntOps * 8 + kI8: launch<kIntOps, kI8>(x, out, words, rounds, c, s); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
