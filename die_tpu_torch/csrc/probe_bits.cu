// Bit-plane building blocks on u32 words: the costs a 0/1 occupancy field
// carried as a bitboard (a 256x256 field in [8, 256] words) would pay.
//
// die_probe_chain (P8): `rounds` times x ^= x << 1; x |= x >> 3;
//   x += 0x9E3779B9; x &= x ^ 0x85EBCA6B on every word.  Replaces
//   `chain_kernel` of tools/tpu_measure2.py (the pallas_call at :216).  A
//   thread a word, the rounds in a register (a loop-carried chain).
// die_probe_pack (P9): [B, 256, 256] words -> [B, 8, 256], word[j, c] =
//   OR_i x[32 j + i, c] << i, `reps` times xor-accumulated.  Replaces
//   `pack_kernel` (:253), which shifts each row, ORs it with its rolls by 1,
//   2, 4, 8 and 16 rows and takes every 32nd row.  Here a thread owns one
//   word: it loads its 32 rows once (a warp reads 32 neighbouring columns of
//   a row, coalesced) and ORs them in registers, with no warp primitive.
//   This equals the plain version on any word; __ballot_sync would build
//   the word from one bit a row and equal it only on 0/1 cells.
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
//   `funnel_kernel` (:317).  A thread holds a column's 8 words; a step is 8
//   __funnelshift_l(x[w - 1], x[w], 1) with no communication.
//
// The reps of the pack and the unpack recompute a loop-invariant word; the
// TPU code keeps them with `x_ref[:] + k - k` (tpu_measure2.py:243, :283),
// which nvcc folds away.  An empty asm volatile on the loaded words does not
// keep them either (it leaves no PTX instruction; ptxas hoisted the pack out
// of the rep loop, seen in the SASS).  So each rep reads its words anew, as
// the TPU kernel reads x_ref each rep, at `ptr + rep * zero`, with `zero` a
// kernel argument the entry point sets to 0 (L1 hits after the first rep).
// The chain and the funnel carry their value from step to step.
//
// Bound: the fewest integer instructions the work needs, at the dispatch
// limit (128 lanes a cycle an SM: the compiler spreads them over the INT32
// pipe and IMAD on the FMA pipe): 6 a word a round (P8: two shifts, an xor,
// an or, an add and one LOP3 for x & (x ^ c)), 47 a word a rep (P9: 31
// shifts and 16 three-input LOP3), 2 a cell a rep (P10: a shift, here an
// IMAD, and one LOP3, each cell its own; chip_smoke.py counts them in the
// SASS), 1 a word
// a step (P11: one SHF), against the words in and out once over the memory
// rate.
// Outputs are bitwise equal to the plain versions (tools/probes2.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 256;
constexpr int kWordRows = kN / 32;  // 8
constexpr int kBoard = kWordRows * kN;  // words of one bitboard
constexpr int kCells = kN * kN;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             long long n, int rounds) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t v = x[i];
#pragma unroll 4
  for (int r = 0; r < rounds; ++r) {
    v ^= v << 1;
    v |= v >> 3;
    v += 0x9E3779B9u;
    v &= v ^ 0x85EBCA6Bu;
  }
  out[i] = v;
}

// block: one word row j of one env; thread: column c
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            int reps, int zero) {
  const long long env = blockIdx.x / kWordRows;
  const int j = blockIdx.x % kWordRows, c = threadIdx.x;
  const uint32_t* src = x + env * kCells + (32 * j) * kN + c;
  uint32_t acc = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const uint32_t* p = src + r * zero;
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) w |= p[i * kN] << i;
    acc ^= w;
  }
  out[env * kBoard + j * kN + c] = acc;
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

// block: one env; thread: column c with its 8 words
__global__ void __launch_bounds__(kThreads)
funnel_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              int steps) {
  const long long base = (long long)blockIdx.x * kBoard + threadIdx.x;
  uint32_t v[kWordRows];
#pragma unroll
  for (int q = 0; q < kWordRows; ++q) v[q] = x[base + q * kN];
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    uint32_t nv[kWordRows];
#pragma unroll
    for (int q = 0; q < kWordRows; ++q)
      nv[q] = __funnelshift_l(v[(q + kWordRows - 1) % kWordRows], v[q], 1);
#pragma unroll
    for (int q = 0; q < kWordRows; ++q) v[q] = nv[q];
  }
#pragma unroll
  for (int q = 0; q < kWordRows; ++q) out[base + q * kN] = v[q];
}

}  // namespace

// x, out: n u32 words on the device.  Returns the CUDA error of the launch
// (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_chain(const void* x, void* out, long long n,
                               int rounds, void* stream) {
  if (n < 1 || rounds < 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
    return -1;
  chain_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, rounds);
  return static_cast<int>(cudaGetLastError());
}

// x: [B, 256, 256] u32; out: [B, 8, 256].
extern "C" int die_probe_pack(const void* x, void* out, int B, int reps,
                              void* stream) {
  if (B < 1 || B > 65535 || reps < 0) return -1;
  pack_kernel<<<B * kWordRows, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), reps, 0);
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

// x, out: [B, 8, 256] u32.
extern "C" int die_probe_funnel(const void* x, void* out, int B, int steps,
                                void* stream) {
  if (B < 1 || B > 65535 || steps < 0) return -1;
  funnel_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
