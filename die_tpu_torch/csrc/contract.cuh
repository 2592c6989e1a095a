// The bit contract on the device: counter-based RNG (threefry2x32, murmur3
// fmix32, uniforms from bits) and the fp32 math kernels (Newton rsqrt/sqrt,
// Cody-Waite sincos, round3), in the operation order of the NumPy oracle
// (die_tpu_torch/core/rng.py and core/mathx.py are the host twins).  Every
// constant is given by its fp32 bit pattern, so no decimal literal is
// rounded differently from numpy.
// Build with --fmad=false: a contracted a*b+c rounds once, not twice, and
// would leave the contract.
#pragma once
#include <cstdint>

namespace die {

__device__ __forceinline__ float f32_bits(uint32_t u) {
  return __uint_as_float(u);
}

// ---- RNG -----------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counter pair (0, lo) under key (k0, k1), halves
// xor'd: jax.random.bits for a flat index below 2**32.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t lo) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = 0u + ks[0];
  uint32_t x1 = lo + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

// The same block of the counter pair (0, data) with both output words kept:
// jax.random.fold_in(key, data) = (y0, y1).  threefry_bits keeps its own
// body: written through this one, the step kernels compile to other SASS
// and run 3-4% slower (K3 wide, K1 at 16 directions; H100).
__device__ __forceinline__ void threefry_fold_in(uint32_t k0, uint32_t k1,
                                                 uint32_t data, uint32_t* y0,
                                                 uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = 0u + ks[0];
  uint32_t x1 = data + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// u32 bits -> fp32 uniform in (0, 1): the top 23 bits times 2**-23, plus
// 2**-24.
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return (float)(bits >> 9) * f32_bits(0x34000000u) + f32_bits(0x33800000u);
}

__device__ __forceinline__ uint32_t murmur_finalize(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t murmur_bits(uint32_t k0, uint32_t k1,
                                                uint32_t count) {
  return murmur_finalize(murmur_finalize(count ^ k0) ^ k1);
}

// ---- fp32 math -----------------------------------------------------------

__device__ __forceinline__ float c_rsqrt(float x) {
  const int i = __float_as_int(x);
  float r = __int_as_float(0x5F3759DF - (i >> 1));
#pragma unroll
  for (int k = 0; k < 3; ++k) r = r * (1.5f - 0.5f * x * r * r);
  return r;
}

__device__ __forceinline__ float c_sqrt(float x) {
  const bool pos = x > 0.0f;
  const float safe = pos ? x : 1.0f;
  return pos ? safe * c_rsqrt(safe) : 0.0f;
}

__device__ __forceinline__ void c_sincos(float theta, float* sin_v,
                                         float* cos_v) {
  const float inv_pio2 = f32_bits(0x3f22f983u);
  const float pio2_hi = f32_bits(0x3fc90f80u);
  const float pio2_lo = f32_bits(0x37354443u);
  const float s1 = f32_bits(0xbe2aaaa3u), s2 = f32_bits(0x3c08839eu),
              s3 = f32_bits(0xb94ca1f9u);
  const float c1 = f32_bits(0x3d2aaaa5u), c2 = f32_bits(0xbab6061au),
              c3 = f32_bits(0x37ccf5ceu);
  const float k = floorf(theta * inv_pio2 + 0.5f);
  float r = theta - k * pio2_hi;
  r = r - k * pio2_lo;
  const float q = k - 4.0f * floorf(k * 0.25f);
  const float r2 = r * r;
  const float s = r + r * r2 * (s1 + r2 * (s2 + r2 * s3));
  const float c = 1.0f - 0.5f * r2 + r2 * r2 * (c1 + r2 * (c2 + r2 * c3));
  const bool q0 = q == 0.0f, q1 = q == 1.0f, q2 = q == 2.0f;
  *sin_v = q0 ? s : (q1 ? c : (q2 ? -s : -c));
  *cos_v = q0 ? c : (q1 ? -s : (q2 ? -c : s));
}

// Round to 3 decimals, half-up: floor(u * 1000 + 0.5) * fp32(0.001).
__device__ __forceinline__ float round3(float u) {
  return floorf(u * 1000.0f + 0.5f) * f32_bits(0x3a83126fu);
}

}  // namespace die
