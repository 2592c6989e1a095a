// Bit-plane building blocks on u32 words: the costs a 0/1 occupancy field
// carried as a bitboard (a 256x256 field in [8, 256] words) would pay.
//
// die_probe_chain (P8): `rounds` times x ^= x << 1; x |= x >> 3;
//   x += 0x9E3779B9; x &= x ^ 0x85EBCA6B on every word.  Replaces
//   `chain_kernel` of tools/tpu_measure2.py (the pallas_call at :216).  Each
//   word's rounds are one loop-carried chain in a register, 6 dependent
//   operations a round (x & (x ^ c) is x & ~c).  Three forms, the plan's
//   choice by how many warps a scheduler the words give
//   (tools/probes2.py chain_plan):
//   - kChainFp64, many warps (the issue rate sets the pace): the xor, the or
//     and the and as LOP3 on the ALU pipe, << 1 and the add as IMAD on the
//     FMA pipe and >> 3 as one DADD.RZ on the FP64 pipe (shr_fp64), each
//     pipe 16 lanes a clock a scheduler: 6 clocks a warp-round on the ALU
//     pipe and 6 issue slots, the 128-lane bound.  2 words a thread.  (The
//     FMA pipe's IMAD.HI by 2^29 would be the other way off the ALU pipe;
//     on the H100 it issues at half rate with a latency of 9.9 clocks, and
//     every P8 leg ran slower with it.)
//   - kChainDepth5, one warp a scheduler or fewer (the chain's latency sets
//     the pace): 5 dependent operations a round, 7 instructions: a = x << 1,
//     b = x >> 3 and c = x >> 2 side by side, m = b ^ (c & 0x1FFFFFFF) (as
//     (x << 1) >> 3 drops bit 29), u = (x ^ a) | m = (x ^ (x << 1)) |
//     ((x ^ (x << 1)) >> 3), then the add and the and.  A word a thread.
//   - kChainShf, up to 4 warps a scheduler: the round of kChainFp64 with
//     >> 3 on SHF (latency 4.5 clocks against DADD's 13.1), 4 words a thread
//     in blocks of 128, one warp a scheduler interleaving 4 chains.
// die_probe_pack (P9): [B, 256, 256] words -> [B, 8, 256], word[j, c] =
//   OR_i x[32 j + i, c] << i, `reps` times xor-accumulated.  Replaces
//   `pack_kernel` (:253), which shifts each row, ORs it with its rolls by 1,
//   2, 4, 8 and 16 rows and takes every 32nd row.  Here a thread owns one
//   word (or R = 32 / P of its rows, P threads a word where few fields leave
//   the card idle: tools/probes2.py pack_plan): it loads its rows once (a
//   warp reads neighbouring columns of a row, coalesced) into registers and
//   keeps them for all reps.  A rep shifts every row anew and ORs them with
//   16 three-input LOP3 (R / 2 for R rows), the last one xoring the word
//   into the sum.  The shifts are split over the two integer pipes, each 64
//   lanes a clock an SM: SHF and LOP3 run on the ALU pipe, a multiply on the
//   FMA pipe, so 7 rows (k = 4 m + 1) are funnel shifts SHF.L.W(zr, v, k)
//   and the others IMAD v * 2^k + zr (2^k a kernel parameter, so ptxas sees
//   no power of two to turn into a shift): 7 SHF + 16 LOP3 beside 24 IMAD
//   a word a rep.  zr is the runtime `zero` times the rep (and the thread),
//   so ptxas can hoist neither a row's shift nor the pack; with zr = 0 each
//   equals v << k
//   on any word.  With P threads a word, each ORs its rows, shifts the
//   partial word by R part and the P partial words are ORed by warp
//   shuffles before the xor (an OR of xors is not the xor of ORs).  This
//   equals the plain version on any word; __ballot_sync would build the word
//   from one bit a row and equal it only on 0/1 cells.
// die_probe_unpack (P10): [B, 8, 256] -> [B, 256, 256], out[r, c] =
//   (w[r % 8, c] >> (r & 31)) & 1, `reps` times xor-accumulated.  Replaces
//   `unpack_kernel` (:289).  pltpu.repeat tiles the 8 word rows (row r reads
//   word row r % 8, not r // 32), so this is what the TPU kernel computes,
//   not the inverse of the pack.  A thread a word, as the TPU kernel reads a
//   word once a rep: word (q, c) feeds the 32 cells r = q + 8 i of column c,
//   which the thread holds in registers (or 16, 8 or 4 of them, the word's
//   cells split over 2, 4 or 8 threads where few fields leave the card
//   idle: tools/probes2.py unpack_plan), so a load serves 32 cell-reps (or
//   16, 8, 4) and the shifts and LOP3s set the pace: each cell's shift a
//   multiply on the FMA pipe beside its LOP3 on the ALU pipe.  The stores go
//   once at the end, a warp's lanes on neighbouring columns.
// die_probe_funnel (P11): `steps` times x = (x << 1) | (roll(x, 1, 0) >> 31)
//   on [B, 8, 256], the roll along the 8 word rows of a column.  Replaces
//   `funnel_kernel` (:317).  A step is 8 one-bit funnel shifts of a column,
//   every one done as an SHF (512 steps rotate a 256-bit column back to
//   itself, and two steps would compose into one shift by 2), the words in
//   registers for all steps, in blocks of 128 threads, so that no scheduler
//   holds more than one warp (tools/probes2.py funnel_plan): B = 64 is 512
//   warps, one a scheduler on 128 SMs.  Where that leaves schedulers idle
//   (B <= 33), a column's words go to 2 lanes, 4 each, the two exchanging
//   their last words by one shuffle a step: a path through the steps crosses
//   a lane once in 4 steps.  The ALU pipe takes an SHF every 2 clocks, so a
//   warp's step is 16 clocks (8 at 2 lanes).  The other pipes' one-bit
//   shifts lose here: IMAD.HI (FMA pipe) issues at half rate with a latency
//   of 9.9 clocks and DADD.RZ (FP64 pipe) has one of 13.1, which one warp a
//   scheduler cannot hide (measured: every split slower than SHF alone).
// die_probe_int_latency: a clock64() loop of one instruction (LOP3, SHF,
//   IMAD, IMAD.HI, an add, DADD.RZ), in 1 dependent chain a thread (its
//   latency) or 8 (its issue rate), for the chain's floor and the choice of
//   the forms above (tools/probes2.py int_latencies).  No TPU kernel.
//
// The reps of the pack and the unpack recompute a loop-invariant word; the
// TPU code keeps them with `x_ref[:] + k - k` (tpu_measure2.py:243, :283),
// which nvcc folds away.  An empty asm volatile on the loaded words does not
// keep them either (it leaves no PTX instruction; ptxas hoisted the pack out
// of the rep loop, seen in the SASS).  So a runtime `zero`, a kernel argument
// the entry point sets to 0, enters each rep's work: the unpack reads its
// word anew at `ptr + rep * zero` (an L1 hit after the first rep), the pack
// adds `zero * rep` into every row's shift.  The chain and the funnel carry
// their value from step to step.
//
// Bound: the fewest integer instructions the work needs, at the dispatch
// limit (128 lanes a cycle an SM: the compiler spreads them over the INT32
// pipe and IMAD on the FMA pipe): 6 a word a round (P8: two shifts, an xor,
// an or, an add and one LOP3 for x & (x ^ c)), 47 a word a rep (P9: 31
// shifts and 16 three-input LOP3), 2 a cell a rep (P10: a shift, here an
// IMAD, and one LOP3, each cell its own), 1 a word a step (P11: one SHF),
// against the words in and out once over the memory rate.  chip_smoke.py
// counts P8's, P9's, P10's and P11's in the SASS.
// Outputs are bitwise equal to the plain versions (tools/probes2.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;
constexpr int kWordRows = kN / 32;  // 8
constexpr int kBoard = kWordRows * kN;  // words of one bitboard
constexpr int kCells = kN * kN;
constexpr int kThreads = 256;

// forms (probes2.CHAIN_FORMS); die_probe_chain gives each its words a thread
constexpr int kChainFp64 = 0, kChainDepth5 = 1, kChainShf = 2;
constexpr int kChainUnroll = 12;  // rounds a turn of the round loop
constexpr uint32_t kChainAdd = 0x9E3779B9u, kChainMask = 0x85EBCA6Bu;

struct ChainMul {
  uint32_t two, one;  // 2 and 1, set by the entry point
};

// x >> K on the FP64 pipe, exact for every u32 x: the double with high word
// 0x43300000 and low word x is 2^52 + x; adding 2^(52 + K) - 2^52 gives
// 2^(52 + K) + x, which rounded toward zero keeps floor(x / 2^K) as the low
// word of its mantissa (DADD.RZ)
template <int K>
__device__ __forceinline__ uint32_t shr_fp64(uint32_t x) {
  constexpr double kBias = 0x1p52 * ((1ull << K) - 1);  // 2^(52+K) - 2^52
  return (uint32_t)__double2loint(
      __dadd_rz(__hiloint2double(0x43300000, (int)x), kBias));
}

// (a ^ b) | c, and a ^ (b & c)
__device__ __forceinline__ uint32_t xor_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xBE;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t xor_and(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x78;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// one round: << 1 and the add as IMAD (FMA pipe; the multipliers kernel
// parameters, so ptxas sees no power of two or 1 to turn back into a shift
// or an add), >> 3 as DADD.RZ (FP64 pipe, kChainFp64) or SHF (ALU pipe,
// kChainShf), the xor, the or and the and as LOP3 (ALU pipe); one round 5
// dependent operations deep (kChainDepth5): x << 1 (IMAD), x >> 3 and
// x >> 2 (SHF) side by side, then two LOP3, the add and the and
template <int FORM>
__device__ __forceinline__ uint32_t chain_round(uint32_t v,
                                                const ChainMul& cm) {
  uint32_t a;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(a) : "r"(v), "r"(cm.two));
  if constexpr (FORM == kChainDepth5) {
    const uint32_t m = xor_and(v >> 3, v >> 2, 0x1FFFFFFFu);
    return (xor_or(v, a, m) + kChainAdd) & ~kChainMask;
  } else {
    v ^= a;
    v |= FORM == kChainShf ? v >> 3 : shr_fp64<3>(v);
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(v) : "r"(v), "r"(cm.one),
        "r"(kChainAdd));
    return v & ~kChainMask;
  }
}

// block: W blockDim.x (128 or 256) words; thread: W words blockDim.x apart,
// each its own chain for the warp to interleave
template <int FORM, int W>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             long long n, int rounds, const ChainMul cm) {
  const long long i0 = (long long)blockIdx.x * blockDim.x * W + threadIdx.x;
  uint32_t v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const long long i = i0 + (long long)w * blockDim.x;
    v[w] = i < n ? x[i] : 0u;
  }
  int r = 0;
#pragma unroll 1
  for (; r + kChainUnroll <= rounds; r += kChainUnroll) {
#pragma unroll
    for (int k = 0; k < kChainUnroll; ++k)
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = chain_round<FORM>(v[w], cm);
  }
#pragma unroll 1
  for (; r < rounds; ++r)
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = chain_round<FORM>(v[w], cm);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const long long i = i0 + (long long)w * blockDim.x;
    if (i < n) out[i] = v[w];
  }
}

// rows k = 4 m + 1, m < 7, of a thread's R are shifted by SHF, the others by
// IMAD (tools/probes2.py PACK_SHF_EVERY, PACK_SHF_ROWS): with the rep's zr
// add and 16 LOP3, 24 instructions on each pipe a word a rep
constexpr int kPackShfEvery = 4;
constexpr int kPackShfRows = 7;
constexpr int kPackUnroll = 5;  // reps a turn of the rep loop (probes2.PACK_UNROLL)

struct PackMul {
  uint32_t m[32];  // m[k] = 2^k, set by the entry point
};

__device__ __forceinline__ uint32_t or3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xFE;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (a | b) ^ c
__device__ __forceinline__ uint32_t or_xor(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x56;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// block: 256 / P columns of word row j of one env; thread: column c, part
// `part` of its word, the rows 32 j + R part .. + R - 1 (tools/probes2.py
// pack_plan); the P threads of a word are neighbouring lanes.  At one
// thread a word, 4 blocks an SM (64 registers) hold B = 64 in one wave.
template <int P>
__global__ void __launch_bounds__(kThreads, P == 1 ? 4 : 1)
pack_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            int reps, int zero, const PackMul pm) {
  constexpr int R = 32 / P;            // rows a thread
  constexpr int kCols = kThreads / P;  // columns a block
  constexpr int kOr3 = (R - 2) / 2;    // three-input ORs that leave two terms
  const long long env = blockIdx.x / (kWordRows * P);
  const int j = blockIdx.x / P % kWordRows, part = threadIdx.x % P;
  const int c = blockIdx.x % P * kCols + threadIdx.x / P;
  const uint32_t* src = x + env * kCells + (32 * j + R * part) * kN + c;
  uint32_t v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = __ldg(src + k * kN);
  // zr: zero times the rep, started per thread so that it lives in a vector
  // register (a uniform one would cost a move to each SHF and keep the
  // multipliers out of the IMADs' constant operand)
  uint32_t acc = 0, zr = zero * threadIdx.x;
#pragma unroll kPackUnroll
  for (int r = 0; r < reps; ++r) {
    // q[0 .. R - 1] the shifted rows; q[R + n] the n-th OR of three, taking
    // q[3 n .. 3 n + 2] (a tree of depth log3 R)
    uint32_t q[R + kOr3];
    q[0] = v[0];
#pragma unroll
    for (int k = 1; k < R; ++k) {
      if (k % kPackShfEvery == 1 && k / kPackShfEvery < kPackShfRows)
        q[k] = __funnelshift_l(zr, v[k], k);
      else
        asm("mad.lo.u32 %0, %1, %2, %3;"
            : "=r"(q[k])
            : "r"(v[k]), "r"(pm.m[k]), "r"(zr));
    }
#pragma unroll
    for (int n = 0; n < kOr3; ++n)
      q[R + n] = or3(q[3 * n], q[3 * n + 1], q[3 * n + 2]);
    const uint32_t a = q[3 * kOr3], b = q[3 * kOr3 + 1];
    if constexpr (P == 1) {
      acc = or_xor(a, b, acc);
    } else {
      uint32_t w = (a | b) << (R * part);
#pragma unroll
      for (int d = 1; d < P; d <<= 1) {
        const uint32_t s = __shfl_xor_sync(0xffffffffu, w, d);
        if (2 * d < P)
          w |= s;
        else
          acc = or_xor(w, s, acc);
      }
    }
    zr += zero;
  }
  if (part == 0) out[env * kBoard + j * kN + c] = acc;
}

// block: 256 columns of word row q of one env, part `part` of its cells;
// thread: column c, the word (q, c) and its T cells r = q + 8 i, i = T part ..
// T part + T - 1 (tools/probes2.py unpack_plan).  Each rep reads the word
// once (the next rep's word loads during this one) and gives each cell its
// own shift and LOP3.  The shift moves the cell's bit (q + 8 i) & 31 to bit
// 31 as a multiply by 2^(31 - (q + 8 i) & 31) (IMAD, on the FMA pipe; SHF and
// LOP3 share the ALU pipe, 64 lanes a clock an SM, half the issue rate), and
// the cell's xor is kept at bit 31 of its accumulator:
// - the thread's first 4 cells (4 different shifts, as T part % 4 = 0):
//   t = w * m, acc ^= t & 2^31 (one LOP3);
// - its later cells, whose shifts repeat every 4: t = w * m + acc (the add
//   at bit 31 is the xor), acc = t & 2^31.  The cell's accumulator is an
//   operand of its multiply, so the compiler cannot fold one cell's work
//   into another's; the accumulators start from the runtime `zero` times
//   the cell for the same reason.
// The output is bit 31 of each accumulator.
template <int T>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ w, uint32_t* __restrict__ out,
              int reps, int zero) {
  constexpr int kParts = 32 / T;
  const long long env = blockIdx.x / (kWordRows * kParts);
  const int q = blockIdx.x / kParts % kWordRows, part = blockIdx.x % kParts;
  const int c = threadIdx.x;
  const uint32_t* word = w + env * kBoard + q * kN + c;
  uint32_t m[4];  // cells i with i % 4 = j: bit q + 8 j to bit 31
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = 1u << (31 - q - 8 * j);
  uint32_t acc[T];
#pragma unroll
  for (int i = 0; i < T; ++i) acc[i] = (uint32_t)(zero * i);
  uint32_t v = word[0];
#pragma unroll 4
  for (int k = 0; k < reps; ++k) {
    const uint32_t next = word[(k + 1) * zero];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint32_t t;
      if (i < 4) {
        asm("mul.lo.u32 %0, %1, %2;" : "=r"(t) : "r"(v), "r"(m[i]));
        acc[i] ^= t & 0x80000000u;
      } else {
        asm("mad.lo.u32 %0, %1, %2, %3;"
            : "=r"(t)
            : "r"(v), "r"(m[i & 3]), "r"(acc[i]));
        acc[i] = t & 0x80000000u;
      }
    }
    v = next;
  }
  uint32_t* o = out + env * kCells + (long long)(q + 8 * T * part) * kN + c;
#pragma unroll
  for (int i = 0; i < T; ++i) o[8 * i * kN] = acc[i] >> 31;
}

constexpr int kFunnelThreads = 128;  // threads a block (probes2.FUNNEL_THREADS)
constexpr int kFunnelUnroll = 8;  // steps a turn of the step loop

// one step on a thread's R = 8 / L words of a column: word j takes j - 1's
// top bit, word 0 the top bit of `up0` (the column's word before the
// thread's first), each by one SHF
template <int R>
__device__ __forceinline__ void funnel_step(uint32_t (&v)[R], uint32_t up0) {
  uint32_t nv[R];
#pragma unroll
  for (int q = 0; q < R; ++q)
    nv[q] = __funnelshift_l(q ? v[q - 1] : up0, v[q], 1);
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = nv[q];
}

// block: 128 / L columns of one env; thread: column c with its 8 words
// (L = 1), or lanes 2 i and 2 i + 1 with words 0-3 and 4-7 of column c,
// each taking the other's last word by one shuffle a step (L = 2)
template <int L>
__global__ void __launch_bounds__(kFunnelThreads)
funnel_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              int steps) {
  constexpr int R = kWordRows / L;
  const long long t = (long long)blockIdx.x * kFunnelThreads + threadIdx.x;
  const long long col = t / L;
  const long long base = col / kN * kBoard + col % kN + t % L * R * kN;
  uint32_t v[R];
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = x[base + q * kN];
  int s = 0;
#pragma unroll 1
  for (; s + kFunnelUnroll <= steps; s += kFunnelUnroll) {
#pragma unroll
    for (int k = 0; k < kFunnelUnroll; ++k)
      funnel_step<R>(v, L == 1 ? v[R - 1]
                               : __shfl_xor_sync(0xffffffffu, v[R - 1], 1));
  }
#pragma unroll 1
  for (; s < steps; ++s)
    funnel_step<R>(v, L == 1 ? v[R - 1]
                             : __shfl_xor_sync(0xffffffffu, v[R - 1], 1));
#pragma unroll
  for (int q = 0; q < R; ++q) out[base + q * kN] = v[q];
}

// ---- the integer instructions' latency and issue rate ---------------------

constexpr int kLatOps = 8;  // probes2.INT_LATENCY_OPS
constexpr int kLatUnroll = 16;  // instructions a chain a turn of the loop

struct LatArgs {
  uint32_t k1, k2, m, seed;
};

// op 0 LOP3, 1 SHF, 2 IMAD, 3 IMAD.HI, 4 an add of an immediate followed by
// a LOP3 xor (a chain of adds alone folds into one), 5 SHF and IMAD in turn
// (k, the place in the unrolled turn), 6 the DADD.RZ of shr_fp64, 7 SHF,
// IMAD and that DADD in turn
template <int OP>
__device__ __forceinline__ uint32_t lat_op(uint32_t x, const LatArgs& a,
                                           int k) {
  uint32_t d;
  if constexpr (OP == 0)
    asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;"
                 : "=r"(d) : "r"(x), "r"(a.k1), "r"(a.k2));
  else if constexpr (OP == 2)
    asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                 : "=r"(d) : "r"(x), "r"(a.m), "r"(a.k1));
  else if constexpr (OP == 3)
    asm volatile("mad.hi.u32 %0, %1, %2, %3;"
                 : "=r"(d) : "r"(x), "r"(a.m), "r"(a.k1));
  else if constexpr (OP == 4)
    d = (x + 0x9E3779B9u) ^ a.k2;
  else if constexpr (OP == 6)
    d = shr_fp64<3>(x);
  else if (OP == 1 || k % (OP == 5 ? 2 : 3) == 0)
    asm volatile("shf.l.wrap.b32 %0, %1, %1, 1;" : "=r"(d) : "r"(x));
  else if (k % (OP == 5 ? 2 : 3) == 1)
    asm volatile("mad.lo.u32 %0, %1, %2, %3;"
                 : "=r"(d) : "r"(x), "r"(a.m), "r"(a.k1));
  else
    d = shr_fp64<3>(x);
  return d;
}

// one block; each warp's lane 0 writes the clocks of its loop
template <int OP, int CHAINS>
__global__ void __launch_bounds__(512)
latency_kernel(uint32_t* __restrict__ out, long long* __restrict__ clk,
               int iters, const LatArgs a) {
  uint32_t v[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    v[c] = a.seed + threadIdx.x * 0x9E3779B9u + c * 0x7F4A7C15u;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kLatUnroll; ++k)
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) v[c] = lat_op<OP>(v[c], a, k);
  }
  const long long t1 = clock64();
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) r ^= v[c];
  out[threadIdx.x] = r;
  if (threadIdx.x % 32 == 0) clk[threadIdx.x / 32] = t1 - t0;
}

template <int OP>
int launch_latency(uint32_t* out, long long* clk, int chains, int iters,
                   int threads, const LatArgs& a, cudaStream_t s) {
  if (chains == 1)
    latency_kernel<OP, 1><<<1, threads, 0, s>>>(out, clk, iters, a);
  else
    latency_kernel<OP, 8><<<1, threads, 0, s>>>(out, clk, iters, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: n u32 words on the device; threads: a block's, 128 or 256;
// form: kChainFp64 (2 words a thread), kChainDepth5 (1) or kChainShf (4)
// (tools/probes2.py chain_plan; any other value is refused).  Returns the
// CUDA error of the launch (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_chain(const void* x, void* out, long long n,
                               int rounds, int threads, int form,
                               void* stream) {
  if (n < 1 || rounds < 0 ||
      (threads != 128 && threads != 256) || form < kChainFp64 ||
      form > kChainShf)
    return -1;
  const int words = form == kChainFp64 ? 2 : form == kChainDepth5 ? 1 : 4;
  const long long per = (long long)threads * words;
  if ((n + per - 1) / per > 0x7FFFFFFFLL) return -1;
  const ChainMul cm{2u, 1u};
  const unsigned grid = (unsigned)((n + per - 1) / per);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (form == kChainFp64)
    chain_kernel<kChainFp64, 2><<<grid, threads, 0, s>>>(xi, o, n, rounds,
                                                         cm);
  else if (form == kChainDepth5)
    chain_kernel<kChainDepth5, 1><<<grid, threads, 0, s>>>(xi, o, n, rounds,
                                                           cm);
  else
    chain_kernel<kChainShf, 4><<<grid, threads, 0, s>>>(xi, o, n, rounds,
                                                        cm);
  return static_cast<int>(cudaGetLastError());
}

// x: [B, 256, 256] u32; out: [B, 8, 256]; parts: threads a word, 1, 2, 4 or
// 8 (tools/probes2.py pack_plan; any other count is refused).
extern "C" int die_probe_pack(const void* x, void* out, int B, int reps,
                              int parts, void* stream) {
  if (B < 1 || B > 65535 || reps < 0 ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8))
    return -1;
  PackMul pm;
  for (int k = 0; k < 32; ++k) pm.m[k] = 1u << k;
  const dim3 grid(B * kWordRows * parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (parts == 1)
    pack_kernel<1><<<grid, kThreads, 0, s>>>(xi, o, reps, 0, pm);
  else if (parts == 2)
    pack_kernel<2><<<grid, kThreads, 0, s>>>(xi, o, reps, 0, pm);
  else if (parts == 4)
    pack_kernel<4><<<grid, kThreads, 0, s>>>(xi, o, reps, 0, pm);
  else
    pack_kernel<8><<<grid, kThreads, 0, s>>>(xi, o, reps, 0, pm);
  return static_cast<int>(cudaGetLastError());
}

// w: [B, 8, 256] u32; out: [B, 256, 256]; parts: threads a word, 1, 2, 4 or
// 8 (tools/probes2.py unpack_plan; any other count is refused).
extern "C" int die_probe_unpack(const void* w, void* out, int B, int reps,
                                int parts, void* stream) {
  if (B < 1 || B > 65535 || reps < 0 ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8))
    return -1;
  const dim3 grid(B * kWordRows * parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* wi = static_cast<const uint32_t*>(w);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (parts == 1)
    unpack_kernel<32><<<grid, kThreads, 0, s>>>(wi, o, reps, 0);
  else if (parts == 2)
    unpack_kernel<16><<<grid, kThreads, 0, s>>>(wi, o, reps, 0);
  else if (parts == 4)
    unpack_kernel<8><<<grid, kThreads, 0, s>>>(wi, o, reps, 0);
  else
    unpack_kernel<4><<<grid, kThreads, 0, s>>>(wi, o, reps, 0);
  return static_cast<int>(cudaGetLastError());
}

// x, out: [B, 8, 256] u32; lanes: a column's, 1 or 2 (tools/probes2.py
// funnel_plan; any other count is refused).
extern "C" int die_probe_funnel(const void* x, void* out, int B, int steps,
                                int lanes, void* stream) {
  if (B < 1 || B > 65535 || steps < 0 || (lanes != 1 && lanes != 2))
    return -1;
  const dim3 grid(B * lanes * (kN / kFunnelThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (lanes == 1)
    funnel_kernel<1><<<grid, kFunnelThreads, 0, s>>>(xi, o, steps);
  else
    funnel_kernel<2><<<grid, kFunnelThreads, 0, s>>>(xi, o, steps);
  return static_cast<int>(cudaGetLastError());
}

// out: threads u32; clk: threads / 32 int64, each warp's clocks over
// iters x 16 instructions a chain; op 0 to 7, chains 1 or 8, threads 128 (a
// warp a scheduler) or 512 (4).
extern "C" int die_probe_int_latency(void* out, void* clk, int op, int chains,
                                     int iters, int threads, void* stream) {
  if (op < 0 || op >= kLatOps || (chains != 1 && chains != 8) || iters < 1 ||
      (threads != 128 && threads != 512))
    return -1;
  const LatArgs a{0x5BD1E995u, 0x27D4EB2Fu, 0x9E3779B1u, 0x165667B1u};
  uint32_t* o = static_cast<uint32_t*>(out);
  long long* c = static_cast<long long*>(clk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return launch_latency<0>(o, c, chains, iters, threads, a, s);
    case 1: return launch_latency<1>(o, c, chains, iters, threads, a, s);
    case 2: return launch_latency<2>(o, c, chains, iters, threads, a, s);
    case 3: return launch_latency<3>(o, c, chains, iters, threads, a, s);
    case 4: return launch_latency<4>(o, c, chains, iters, threads, a, s);
    case 5: return launch_latency<5>(o, c, chains, iters, threads, a, s);
    case 6: return launch_latency<6>(o, c, chains, iters, threads, a, s);
    default: return launch_latency<7>(o, c, chains, iters, threads, a, s);
  }
}
