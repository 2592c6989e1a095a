// lattice_init: the lattice engine's initial state, one env per key pair,
// in one launch: masked Perlin food, thresholded-uniform occupancy, random
// lattice headings, on-grid agent food and an empty chem field.
//
// Replaces no TPU kernel: the JAX package builds its initial state in plain
// jnp (die_tpu/fast/init.py::fast_init_jax), which XLA fuses.  It was added
// because the port's eager version of the same arithmetic runs about 600
// int64 elementwise launches and a host sync for each of its host-to-device
// copies a call.  Plain twin: die_tpu_torch/fast/init.py::fast_init_plain;
// the two agree bit for bit.
//
// Per env key (k0, k1), in fast_init_plain's order:
// - the four init keys fold_in(key, tag) = threefry2x32(key, (0, tag)),
//   both output words kept;
// - the (o+1)^2 lattice gradients, o = init_food_octaves: threefry_bits of
//   the Perlin key at flat index i, uniform01, (2u - 1) pi, c_sincos,
//   stored as (cos, sin);
// - for each cell (x, y), at flat index c = x H + y: the occupancy and
//   food-grid uniforms (uniform01 of the counter-mode bits at c, round3)
//   and the heading bits at c; the Perlin value from the axis coordinates
//   p = i * step (step = fp32(o / (n - 1)) of the axis' n cells, from the
//   host), i0 = min(floor(p), o - 1), t = p - i0, the four corner dots
//   (00, 10, 01, 11), the quintic fade, the bilinear blend and round3; then
//   the masks and the five fields.
//
// Bound on an H100: bytes.  The kernel reads 16 bytes an env and writes 5
// f32 fields, 20 bytes a cell: 0.05 ms at 1024 x 64x128 and 0.40 ms at
// 1024 x 256x256 at 3.35 TB/s.  Its arithmetic keeps it above that bound:
// each cell costs three threefry2x32 blocks (about 73 integer operations
// each) and about 50 fp32 operations, and the kernel takes about twice the
// byte bound (0.10 and 0.76 ms on an H100 80GB HBM3 at 700 W).
//
// Design: a block of 256 threads takes a run of up to 2048 cells of one
// env, and each thread four adjacent cells of a row at a time (H % 4 == 0),
// so every field is written with one 16-byte store a thread and a warp's
// stores are 512 contiguous bytes.  Before its cells, a block folds its
// env's four keys (four threads) and draws the env's gradients (one a
// thread) into shared memory: every block of an env repeats that work, 85
// threefry blocks against the run's 6,144 at o = 8, so that no block waits
// on another.  The grid is B * ceil(W H / 2048) blocks, derived from the
// shape alone: 4,096 at 1024 x 64x128, 32,768 at 1024 x 256x256.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "contract.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // adjacent cells a thread writes at once
constexpr int kRunCells = 2048;  // cells a block
constexpr int kMaxOctaves = 15;  // (o + 1)^2 <= kThreads gradients
constexpr int kTags = 4;         // perlin, occupancy, food grid, heading

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (10.0f + t * (-15.0f + t * 6.0f));
}

// Axis coordinate of cell i: (lattice index i0, offset t).
__device__ __forceinline__ void axis(int i, float step, float top, int* i0,
                                     float* t) {
  const float p = (float)i * step;
  const float f = fminf(floorf(p), top);
  *i0 = (int)f;
  *t = p - f;
}

__device__ __forceinline__ float corner(float2 g, float rx, float ry) {
  return g.x * rx + g.y * ry;
}

__global__ void __launch_bounds__(kThreads)
    k_init(const long long* __restrict__ keys, float* __restrict__ occ,
           float* __restrict__ dirf, float* __restrict__ afood,
           float* __restrict__ efood, float* __restrict__ chem, int cells,
           int H, int runs, int octaves, float step_x, float step_y,
           float thr, float ratio, uint32_t dir_mask, uint4 tags) {
  __shared__ uint32_t key[kTags][2];
  __shared__ float2 grad[kThreads];
  const int b = blockIdx.x / runs;
  const int run = blockIdx.x - b * runs;
  const int t = threadIdx.x;
  if (t < kTags) {
    const uint32_t tag =
        t == 0 ? tags.x : (t == 1 ? tags.y : (t == 2 ? tags.z : tags.w));
    die::threefry_fold_in((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1],
                          tag, &key[t][0], &key[t][1]);
  }
  __syncthreads();
  const int n = octaves + 1;
  if (t < n * n) {
    const float u = die::uniform01(
        die::threefry_bits(key[0][0], key[0][1], (uint32_t)t));
    float s, c;
    die::c_sincos((2.0f * u - 1.0f) * die::f32_bits(0x40490fdbu), &s, &c);
    grad[t] = make_float2(c, s);
  }
  __syncthreads();
  const uint32_t ko0 = key[1][0], ko1 = key[1][1];
  const uint32_t kf0 = key[2][0], kf1 = key[2][1];
  const uint32_t kd0 = key[3][0], kd1 = key[3][1];
  const float top = (float)(octaves - 1);
  const float c09 = die::f32_bits(0x3f666666u);  // fp32(0.9)
  const float c01 = die::f32_bits(0x3dcccccdu);  // fp32(0.1)
  const size_t base = (size_t)b * cells;
  const int end = min(cells, (run + 1) * kRunCells);
  for (int i = run * kRunCells + t * kVec; i < end; i += kThreads * kVec) {
    const int x = i / H;
    const int y0 = i - x * H;
    int ix;
    float tx;
    axis(x, step_x, top, &ix, &tx);
    const float ux = fade(tx);
    float o[kVec], d[kVec], a[kVec], e[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t c = (uint32_t)(i + j);
      const float u_occ = die::round3(die::uniform01(
          die::threefry_bits(ko0, ko1, c)));
      const float u_food = die::round3(die::uniform01(
          die::threefry_bits(kf0, kf1, c)));
      const uint32_t bits = die::threefry_bits(kd0, kd1, c);
      int iy;
      float ty;
      axis(y0 + j, step_y, top, &iy, &ty);
      const float n00 = corner(grad[ix * n + iy], tx - 0.0f, ty - 0.0f);
      const float n10 = corner(grad[(ix + 1) * n + iy], tx - 1.0f, ty - 0.0f);
      const float n01 = corner(grad[ix * n + iy + 1], tx - 0.0f, ty - 1.0f);
      const float n11 =
          corner(grad[(ix + 1) * n + iy + 1], tx - 1.0f, ty - 1.0f);
      const float uy = fade(ty);
      const float nx0 = n00 + ux * (n10 - n00);
      const float nx1 = n01 + ux * (n11 - n01);
      const float perlin = die::round3(nx0 + uy * (nx1 - nx0));
      o[j] = (u_occ > 0.0f && u_occ <= ratio) ? 1.0f : 0.0f;
      d[j] = (float)(bits & dir_mask) * o[j];
      a[j] = (c09 * u_food + c01) * o[j];
      e[j] = perlin * ((perlin >= 0.0f && perlin <= thr) ? 1.0f : 0.0f);
    }
    const size_t at = base + i;
    *reinterpret_cast<float4*>(occ + at) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dirf + at) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(afood + at) =
        make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(efood + at) =
        make_float4(e[0], e[1], e[2], e[3]);
    *reinterpret_cast<float4*>(chem + at) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

// The initial state of B envs of W x H cells: keys int64 [B, 2] (their low
// 32 bits the key words), occ, dir, agent_food, env_food and chem f32
// [B, W, H], contiguous and 16-byte aligned; step_x, step_y the axes' fp32
// o / (n - 1); thr, ratio the fp32 init_food_threshold and
// init_agent_ratio; dir_mask num_dirs - 1; the four init tags (perlin,
// occupancy, food grid, heading).  Returns a cudaError_t: invalid value,
// before any launch, for a shape the kernel does not take (W or H below 2,
// H not a multiple of 4, W H or the grid above 2**31 - 1, octaves outside
// 1..15, an output not 16-byte aligned).
extern "C" int die_lattice_init(const long long* keys, float* occ, float* dir,
                                float* afood, float* efood, float* chem,
                                int B, int W, int H, int octaves, float step_x,
                                float step_y, float thr, float ratio,
                                unsigned dir_mask, unsigned tag_perlin,
                                unsigned tag_occ, unsigned tag_food,
                                unsigned tag_dir, void* stream) {
  const long long cells = (long long)W * H;
  const long long runs = (cells + kRunCells - 1) / kRunCells;
  if (B < 1 || W < 2 || H < 2 || H % kVec != 0 || cells > INT_MAX ||
      (long long)B * runs > INT_MAX || octaves < 1 ||
      octaves > kMaxOctaves || !aligned16(occ) || !aligned16(dir) ||
      !aligned16(afood) || !aligned16(efood) || !aligned16(chem))
    return (int)cudaErrorInvalidValue;
  k_init<<<(unsigned)(B * runs), kThreads, 0, (cudaStream_t)stream>>>(
      keys, occ, dir, afood, efood, chem, (int)cells, H, (int)runs, octaves,
      step_x, step_y, thr, ratio, dir_mask,
      make_uint4(tag_perlin, tag_occ, tag_food, tag_dir));
  return (int)cudaGetLastError();
}
