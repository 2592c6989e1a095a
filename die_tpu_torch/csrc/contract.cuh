// The bit contract on the device: counter-based RNG (threefry2x32, murmur3
// fmix32) and the fp32 math kernels (Newton rsqrt/sqrt, Cody-Waite sincos),
// in the operation order of the NumPy oracle (die_tpu_torch/core/rng.py and
// core/mathx.py are the host twins).  Every constant is given by its fp32
// bit pattern, so no decimal literal is rounded differently from numpy.
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

}  // namespace die
