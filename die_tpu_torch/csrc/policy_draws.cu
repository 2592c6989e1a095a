// policy_draws: the gradient policies' random draws, one launch a draw site,
// from the unfolded policy keys: Physarum's random turn signs and the
// momentum noise, as float32.
//
// Replaces no TPU kernel: the JAX package draws in plain jnp
// (die_tpu/models/gradient.py: jax.random bits of fold_in(key, tag), then
// the contract's sign or normal transform), which XLA fuses into its step.
// It was added because the port's eager version of the same arithmetic
// runs about 180 int64 elementwise launches over every u32 word of a draw
// (each word an int64, 1.07 GB a temporary at 1024 x 2 x 65,536 words)
// and about 110 float32 ones for the normals, and a host sync for the
// tag's fold_in.  Plain twins: die_tpu_torch/ops/draws.py::
// draw_signs_plain, draw_normals_plain; the two agree bit for bit.
//
// Per key (k0, k1) and tag, in the plain twins' order:
// - the key folded once: fold_in(key, tag) = threefry2x32(key, (0, tag)),
//   both output words kept;
// - for each slot j < n, the counter-mode bits of the folded key at j (the
//   signs) or at j and n + j (the normals' two rows, random_bits of shape
//   (2, n)), each a threefry2x32 block with the halves xor'd;
// - signs: (b & 1) * 2 - 1; normals: scale * (sqrt2 * erfinv(2u - 1)) of
//   u = uniform01(b), with erfinv, log(1 - x x) and sqrt in
//   core/mathx.py's operation order, every constant by its fp32 bit
//   pattern (build with --fmad=false: a contracted a*b+c rounds once).
//
// Bound on an H100: the integer pipe.  Each word is one threefry2x32
// block: 20 rotates (funnel shifts) and 21 xors that only the ALU pipe
// executes (64 lanes an SM, 16.7 T op/s), and 26 adds that it shares with the
// FMA pipe (IMAD); a normal adds about 76 fp32 operations on the FMA pipe.
// At 1024 x 65,536 slots the signs' 67.1 M words need 0.165 ms of the ALU
// pipe, the normals' 134.2 M words 0.38 ms of both pipes together, against
// 0.08 and 0.16 ms for the float32 written at 3.35 TB/s.  The kernel takes
// 0.23 and 0.79 ms (an H100 80GB HBM3 at 700 W).
//
// Design: nothing but the output touches memory.  A block of 256 threads
// takes a run of 1024 slots of one key, each thread four adjacent slots
// (and both rows of them for the normals): four or eight independent
// threefry chains a thread, unrolled, that the scheduler interleaves, and
// one 16-byte store a row where n is a multiple of 4 (4-byte stores with
// the ragged edge masked otherwise).  The key is folded once a block, by
// one thread into shared memory, not once a slot (which would add a
// threefry block a slot, a third more integer work for the normals).  The
// normals' second Giles polynomial (|2u - 1| near 1, w >= 5) is computed
// only where a lane takes it: the select reads one of the two, so its
// value is the same.  The grid is B * ceil(n / 1024) blocks, from the shape
// alone: 65,536 at 1024 x 65,536.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "contract.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                  // adjacent slots a thread
constexpr int kRun = kThreads * kVec;    // slots a block

// p = p x + c for each fp32 constant c, given by its bit pattern, in
// order: a polynomial by Horner's rule, a multiply and an add a term.
__device__ __forceinline__ float horner(float, float p) { return p; }

template <typename... Rest>
__device__ __forceinline__ float horner(float x, float p, uint32_t c,
                                        Rest... rest) {
  return horner(x, p * x + die::f32_bits(c), rest...);
}

// Natural log of a finite normal fp32 x > 0 from its exponent and mantissa
// bits (cephes logf; mathx._log_f32).
__device__ __forceinline__ float log_f32(float x) {
  const int bits = __float_as_int(x);
  float ef = (float)((bits >> 23) - 127);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F800000);  // [1, 2)
  const bool small = m < die::f32_bits(0x3fb504f3u);  // fp32(sqrt(0.5)) * 2
  const float f = small ? m - 1.0f : 0.5f * m - 1.0f;
  ef = small ? ef : ef + 1.0f;
  const float z = f * f;
  float y = horner(f, die::f32_bits(0x3d9021bbu), 0xbdebd1b8u, 0x3def251au,
                   0xbdfe5d4fu, 0x3e11e9bfu, 0xbe2aae50u, 0x3e4cceacu,
                   0xbe7ffffcu, 0x3eaaaaaau);
  y = y * f * z;
  y = y + ef * die::f32_bits(0xb95e8083u);  // ln 2, low part
  y = y - 0.5f * z;
  return f + y + ef * die::f32_bits(0x3f318000u);  // ln 2, high part
}

// Inverse error function for |x| < 1 (Giles 2010; mathx.erfinv), with
// log(1 - x x) as log((1 - x)(1 + x)).
__device__ __forceinline__ float erfinv_f32(float x) {
  const float w = -log_f32((1.0f - x) * (1.0f + x));
  if (w < 5.0f)
    return horner(w - 2.5f, die::f32_bits(0x32f16588u), 0x34b84b36u,
                  0xb66c7357u, 0xb6935ac1u, 0x396532dbu, 0xbaa45408u,
                  0xbb88e4efu, 0x3e7c8f63u, 0x3fc02e2fu) * x;
  return horner(die::c_sqrt(w) - 3.0f, die::f32_bits(0xb951f09bu),
                0x38d3b56bu, 0x3ab0dc72u, 0xbb70bde7u, 0x3bbc127bu,
                0xbbf9c5d7u, 0x3c1aa57eu, 0x3f8036dbu, 0x40354f7eu) * x;
}

template <bool kNormals>
__device__ __forceinline__ float draw(uint32_t bits, float scale) {
  if (kNormals) {
    const float u = die::uniform01(bits);
    return scale * (die::f32_bits(0x3fb504f3u) *  // fp32(sqrt(2))
                     erfinv_f32(2.0f * u - 1.0f));
  }
  return (float)(bits & 1u) * 2.0f - 1.0f;
}

// Rows of one key: 2 (the normals' [2, n]) or 1 (the signs' [n]); row r of
// key b at out + (b rows + r) n, its slot j drawn at counter r n + j.
template <bool kNormals, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    k_policy_draws(const long long* __restrict__ keys,
                   float* __restrict__ out, int n, int runs, uint32_t tag,
                   float scale) {
  constexpr int kRows = kNormals ? 2 : 1;
  __shared__ uint32_t key[2];
  const int b = blockIdx.x / runs;
  const int run = blockIdx.x - b * runs;
  if (threadIdx.x == 0)
    die::threefry_fold_in((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1],
                          tag, &key[0], &key[1]);
  __syncthreads();
  const int j0 = run * kRun + (int)threadIdx.x * kVec;
  if (j0 >= n) return;
  const uint32_t k0 = key[0], k1 = key[1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint32_t first = (uint32_t)r * (uint32_t)n + (uint32_t)j0;
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      v[i] = draw<kNormals>(die::threefry_bits(k0, k1, first + i), scale);
    float* row = out + ((size_t)b * kRows + r) * (size_t)n;
    if (kVec4) {
      *reinterpret_cast<float4*>(row + j0) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (j0 + i < n) row[j0 + i] = v[i];
    }
  }
}

template <bool kNormals>
void launch(const long long* keys, float* out, int B, int n, int runs,
            bool vec4, unsigned tag, float scale, cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)B * runs);
  if (vec4)
    k_policy_draws<kNormals, true>
        <<<grid, kThreads, 0, stream>>>(keys, out, n, runs, tag, scale);
  else
    k_policy_draws<kNormals, false>
        <<<grid, kThreads, 0, stream>>>(keys, out, n, runs, tag, scale);
}

}  // namespace

// The draws of B keys: keys int64 [B, 2] (their low 32 bits the key
// words), out f32 [B, n] (signs, normals 0) or [B, 2, n] (normals 1,
// each scaled by scale), contiguous; tag the draw's fold_in data.  Returns
// a cudaError_t: invalid value, before any launch, for a shape the kernel
// does not take (B or n below 1, more than 2**31 - 1 words a key, a grid
// above 2**31 - 1 blocks).
extern "C" int die_policy_draws(const long long* keys, float* out, int B,
                                int n, unsigned tag, int normals, float scale,
                                void* stream) {
  const long long rows = normals ? 2 : 1;
  const long long runs = ((long long)n + kRun - 1) / kRun;
  if (B < 1 || n < 1 || rows * n > INT_MAX || (long long)B * runs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = n % kVec == 0 && ((size_t)out & 15) == 0;
  if (normals)
    launch<true>(keys, out, B, n, (int)runs, vec4, tag, scale,
                 (cudaStream_t)stream);
  else
    launch<false>(keys, out, B, n, (int)runs, vec4, tag, scale,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
