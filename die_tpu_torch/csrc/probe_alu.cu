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
// int8) and its four chains in registers.  Every select picks by a mask, so
// no lane of a warp branches away from the others.  Under --fmad=false the
// f32 fma is a multiply and then an add, two roundings, as the lattice
// step's contract pays them.
//
// What bounds each leg is the issue slot (one warp instruction a clock a
// scheduler) or, where its instructions crowd one pipe, that pipe: the ALU
// pipe (compares, selects, LOP3, PRMT, packed min/max) and the half-
// precision FMA pipe take a warp instruction every 2 clocks (read from the
// timings of candidate sequences: no profiler counts pipes here).  The SASS
// a pair and a word (cuobjdump, sm_90a), and how each sequence keeps off a
// crowded pipe:
//   - f32 fma: FMUL, FADD (2, issue).  bf16 fma: 2 (HMUL2 or HADD2 on the
//     FMA pipe, HFMA2.MMA on the MMA pipe, as ptxas splits them).
//   - f32 cmpsel: FSETP and a predicated FMUL, FADD (3, issue).
//   - bf16 cmpsel: HSET2 (a mask), the product, the sum and a LOP3 select
//     (4).  The compare can only go to the FMA pipe, so the sum is written
//     as fma.rn(x, 1, k2) with the 1 from the wrapper and the product as
//     fma.rn(x, k1, -0) (each one rounding of an exact product or sum: the
//     add.rn and mul.rn results), which ptxas may put on the MMA pipe: about
//     half of them go there, where add.rn and mul.rn kept two thirds on the
//     FMA pipe.
//   - int32 intops: ISETP, SEL, and an IMAD.IADD (3; the ALU pipe's 2).
//   - int16 intops, on the packed halves with sm_90's 16x2 instructions
//     (5: 2 VIADD.16x2, VIMNMX.S16x2, PRMT, LOP3; 3 on the ALU pipe): the
//     compare is the sign of max(x, low) - (k0 + 1), where the clamp `low`
//     = k0 + 1 - 32768 keeps the difference from wrapping (so 0 <= k0 + 1 <=
//     32767), its sign bit spread over the half by PRMT (0xBB99); the add is
//     one VIADD.16x2 of the half's own constant, m ? k2 : -k1, picked by one
//     LOP3.
//   - int8 intops: the same sequence on two registers a word, lanes 0, 2
//     and 1, 3 at the top byte of each 16-bit half (low bytes 0, the
//     constants scaled by 256), where a 16-bit add wraps the lane as an
//     8-bit one does (10; 6 on the ALU pipe).
//   The __vcmpgts2 / __vsub2 / __vadd2 and __vcmpgts4 / __vsub4 / __vadd4
//   intrinsics took 7 and 12 instructions, 4 and 9 on the ALU pipe; a SWAR
//   form with the carries held off the lane boundaries (LOP3, IADD, PRMT)
//   took 10, 8 on the ALU pipe, for either; each lane in an int32 of its own
//   took 3 a lane.
//
// Bound: operations.  B * 4 * 16 * rounds * 256^2 operations (the TPU
// tool's count: a pair is two) over the lane rate of the dtype; the field is
// read and written once.  The constants (chain offsets, the kind's three
// constants and the sequences' derived words) come from the wrapper as
// 32-bit words, repeated across the word's lanes (probes.alu_consts), so the
// kernel uses the plain version's values.

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
  uint32_t d[4];    // bf16 cmpsel: 1; int16 / int8 intops: low,
                    // -(k0 + 1), -k1, -k1 ^ k2 (each 16-bit half)
};

constexpr uint32_t kNegZero2 = 0x80008000u;  // bf16x2 -0, -0

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

__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
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

__device__ __forceinline__ uint32_t add_16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// each byte of the result is the sign of byte 1 (low half) or byte 3
__device__ __forceinline__ uint32_t half_signs(uint32_t a) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0u), "r"(0xBB99u));
  return d;
}

__device__ __forceinline__ uint32_t select(uint32_t m, uint32_t a,
                                           uint32_t b) {
  return (m & a) | (~m & b);
}

// a word of the dtype as the registers a chain keeps: int8 as two, its
// lanes 0, 2 and 1, 3 at the top of 16-bit halves
template <int DT>
constexpr int kRegs = DT == kI8 ? 2 : 1;

template <int DT>
__device__ __forceinline__ void unpack(uint32_t w, uint32_t (&u)[kRegs<DT>]) {
  if constexpr (DT == kI8) {
    u[0] = (w << 8) & 0xFF00FF00u;
    u[1] = w & 0xFF00FF00u;
  } else {
    u[0] = w;
  }
}

template <int DT>
__device__ __forceinline__ uint32_t pack(const uint32_t (&u)[kRegs<DT>]) {
  if constexpr (DT == kI8) {
    return ((u[0] >> 8) & 0x00FF00FFu) | (u[1] & 0xFF00FF00u);
  } else {
    return u[0];
  }
}

template <int DT>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if constexpr (DT == kF32) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  } else if constexpr (DT == kBF16) {
    return bf2_add(a, b);
  } else if constexpr (DT == kI32) {
    return a + b;
  } else {
    return add_16x2(a, b);
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
  } else {
    return max_s16x2(a, b);
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
      return select(bf2_gt_mask(x, c.k[0]), bf2_fma(x, c.k[1], kNegZero2),
                    bf2_fma(x, c.d[0], c.k[2]));
    }
  } else if constexpr (DT == kI32) {
    const uint32_t m = (int)x > (int)c.k[0] ? 0xffffffffu : 0u;
    return select(m, x - c.k[1], x + c.k[2]);
  } else {  // int16 halves, or int8 lanes at the top of them
    const uint32_t le = half_signs(add_16x2(max_s16x2(x, c.d[0]), c.d[1]));
    return add_16x2(x, c.d[2] ^ (le & c.d[3]));  // le ? k2 : -k1
  }
}

template <int KIND, int DT>
__global__ void __launch_bounds__(kThreads)
alu_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           long long words, int rounds, const Consts c) {
  constexpr int R = kRegs<DT>;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= words) return;
  uint32_t u[R], v[4][R];
  unpack<DT>(x[i], u);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
#pragma unroll
    for (int l = 0; l < R; ++l) v[ch][l] = add<DT>(u[l], c.ofs[ch]);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int l = 0; l < R; ++l) v[ch][l] = op_pair<KIND, DT>(v[ch][l], c);
  }
#pragma unroll
  for (int l = 0; l < R; ++l)
    u[l] = vmax<DT>(vmax<DT>(vmax<DT>(v[0][l], v[1][l]), v[2][l]), v[3][l]);
  out[i] = pack<DT>(u);
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

// x, out: device arrays of `words` 32-bit words; consts: host array of 11
// words (4 chain offsets, 3 constants, 4 derived: probes.alu_consts).
// Returns the CUDA error of the launch (0 = ok, -1 = arguments out of range
// or no such case).
extern "C" int die_probe_alu(const void* x, void* out, long long words,
                             int kind, int dtype, int rounds,
                             const uint32_t* consts, void* stream) {
  if (words < 1 || rounds < 0 || (words + kThreads - 1) / kThreads >
                                     2147483647LL)
    return -1;
  Consts c;
  for (int i = 0; i < 4; ++i) c.ofs[i] = consts[i];
  for (int i = 0; i < 3; ++i) c.k[i] = consts[4 + i];
  for (int i = 0; i < 4; ++i) c.d[i] = consts[7 + i];
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
