// physarum_policy: the float32 math of the exact engine's Physarum policy
// (PhysarumPolicy.forward with normalized gradients), in three kernels.
//
// Replaces no TPU kernel: the JAX package computes the policy in plain jnp
// (die_tpu/models/gradient.py), which XLA fuses into its step.  It was
// added because the port's eager version of the same arithmetic runs well
// over a hundred float32 elementwise launches a step, each reading and
// writing a [1024, 65,536] tensor.  Plain twins: the eager route of
// die_tpu_torch/models/gradient.py (GradientPolicy._angle_field_plain,
// _sense_cells, _act_from_rads); the kernels agree with it bit for bit.
//
// A step of the route:
// - k_physarum_field, once over the chem field [B, W, H]: per cell the
//   central gradient (np.gradient: central inside, one-sided at the edges,
//   not wrapped), its norm through the contract's sqrt, the normalized
//   gradient through the contract's recip (0/0 -> 0), the grad_clip mask,
//   then atan2(gy, gx); the angle field [B, W*H] is all it writes;
// - k_physarum_cells, once over the slots: the sense offset along the
//   heading (polar2xy through sincos) and the flat cell cx * H + cy of
//   the offset coordinates, coords_to_cells with its NaN / int32 guard;
// - (the gather K5 reads the angle field at those cells; the draws kernel
//   draws the turn signs and the noise; neither is here)
// - k_physarum_turn, once over the slots: the turn (renormalize_radians,
//   the isclose tolerances, the unseen test, the selects), the unit vector
//   of the new direction, momentum, noise, the new heading atan2(gpy, gpx)
//   and the deposit, written as action [B, 3, N], prev_grad [B, 2, N] and
//   heading [B, N].
// Every operation is core/mathx.py's, in its order, each constant by its
// fp32 bit pattern; the policy's own constants arrive as float arguments,
// computed on the host as the eager route computes them.  Build with
// --fmad=false: a contracted a*b+c rounds once.  The math below lives in
// this file alone: contract.cuh's functions are used, not changed.
//
// Design (an H100): the field kernel stages a tile of 32 rows x 128
// columns of one env with its +-1 row and column halo in shared memory
// (each chem word read from device memory once, the halo from L2), then
// each thread takes four adjacent columns of four rows, its stencil read
// from shared memory 16 bytes at a time, the result stored 16 bytes at a
// time where H is a multiple of 4 (4-byte stores with the ragged edge
// masked otherwise).
// About 107 fp32 operations a cell bound it before its 8 bytes a cell.
// The slot kernels take a run of 1024 slots of one env a block, four
// adjacent slots a thread, 16-byte loads and stores where N is a multiple
// of 4; they are bound by their bytes (16 and 56 a slot).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "contract.cuh"

namespace {

using die::f32_bits;

// core/mathx.py's constants, by bit pattern
#define PI_F f32_bits(0x40490fdbu)              // PI
#define PIO2_F f32_bits(0x3fc90fdbu)            // _PIO2
#define PIO4_F f32_bits(0x3f490fdbu)            // _PIO4
#define TAN_PIO8_F f32_bits(0x3ed413cdu)        // _TAN_PIO8
#define NEG_TWO_PI_F f32_bits(0xc0c90fdbu)      // _NEG_TWO_PI
#define INV_NEG_TWO_PI_F f32_bits(0xbe22f983u)  // _INV_NEG_TWO_PI
#define INT32_LIMIT_F f32_bits(0x4f000000u)     // core/env.py _INT32_LIMIT

constexpr int kRecipMagic = 0x7EF311C3;  // mathx._RECIP_MAGIC

// 1/y for finite nonzero y (mathx.recip): the bit-hack seed and three
// Newton steps on |y|, the sign put back.
__device__ __forceinline__ float c_recip(float y) {
  const float ay = fabsf(y);
  float r = __int_as_float(kRecipMagic - __float_as_int(ay));
#pragma unroll
  for (int k = 0; k < 3; ++k) r = r * (2.0f - ay * r);
  return y < 0.0f ? -r : r;
}

// atan(t) for t in [0, 1] (mathx._atan_unit, cephes atanf).
__device__ __forceinline__ float atan_unit(float t) {
  const bool big = t > TAN_PIO8_F;
  const float u = big ? (t - 1.0f) * c_recip(t + 1.0f) : t;
  const float u2 = u * u;
  const float p =
      u + u * u2 *
              (f32_bits(0xbeaaaa2au) +
               u2 * (f32_bits(0x3e4c925fu) +
                     u2 * (f32_bits(0xbe0e1b85u) + u2 * f32_bits(0x3da4f0d1u))));
  return big ? PIO4_F + p : p;
}

// mathx.atan2: octant-folded; torch.maximum / minimum propagate a NaN,
// and so do these.
__device__ __forceinline__ float c_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = (ax > ay || ax != ax) ? ax : ay;
  const float mn = (ax < ay || ax != ax) ? ax : ay;
  const bool pos = mx > 0.0f;
  const float t = pos ? mn * c_recip(pos ? mx : 1.0f) : 0.0f;
  float a = atan_unit(t);
  a = ay > ax ? PIO2_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

// mathx.renormalize_radians: (rads - pi) % (-2 pi) + pi.
__device__ __forceinline__ float renormalize(float rads) {
  const float a = rads - PI_F;
  return (a - floorf(a * INV_NEG_TWO_PI_F) * NEG_TWO_PI_F) + PI_F;
}

// core/env.py coords_to_cells: round half up of c (size - 1), clipped; a
// scaled value that is NaN or outside int32 lands in cell 0.
__device__ __forceinline__ int coords_to_cell(float coord, int size) {
  const float scaled = coord * (float)(size - 1) + 0.5f;
  const bool ok = scaled >= -INT32_LIMIT_F && scaled < INT32_LIMIT_F;
  const int c = (int)(ok ? floorf(scaled) : 0.0f);
  return min(max(c, 0), size - 1);
}

// ---- the angle field --------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kVec = 4;                   // adjacent cells or slots a thread
constexpr int kRun = kThreads * kVec;     // slots a block
constexpr int kTileCols = 32 * kVec;      // a warp's row
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = (kThreads / 32) * kRowsPerWarp;
constexpr int kPitch = kTileCols + 8;     // halo at 3 and kTileCols + 4
constexpr int kCol0 = 4;                  // column 0 of the tile

// The sensed angle of one cell from its normalized, clipped gradient
// (GradientPolicy._gradient_field, then atan2(gy, gx)).
template <bool kClip>
__device__ __forceinline__ float cell_angle(float gx, float gy, float clip) {
  const float norm = die::c_sqrt(gx * gx + gy * gy);
  const bool pos = norm > 0.0f;
  const float invn = c_recip(pos ? norm : 1.0f);
  float nx = pos ? gx * invn : 0.0f;
  float ny = pos ? gy * invn : 0.0f;
  if (kClip) {
    const float keep = norm >= clip ? 1.0f : 0.0f;
    nx = nx * keep;
    ny = ny * keep;
  }
  return c_atan2(ny, nx);
}

// One block a tile of kTileRows x kTileCols cells of one env.
template <bool kClip, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    k_physarum_field(const float* __restrict__ chem, long long env_stride,
                     float* __restrict__ out, int W, int H, int row_tiles,
                     int col_tiles, float clip) {
  __shared__ __align__(16) float s[kTileRows + 2][kPitch];
  const int per_env = row_tiles * col_tiles;
  const int b = blockIdx.x / per_env;
  const int t = blockIdx.x - b * per_env;
  const int i0 = (t / col_tiles) * kTileRows;
  const int j0 = (t - (t / col_tiles) * col_tiles) * kTileCols;
  const float* f = chem + (size_t)b * (size_t)env_stride;

  // stage rows i0 - 1 .. i0 + kTileRows and columns j0 - 1 .. j0 +
  // kTileCols; a word outside the field is 0 and never read
  constexpr int kQuads = kTileCols / kVec;
  for (int k = threadIdx.x; k < (kTileRows + 2) * kQuads; k += kThreads) {
    const int r = k / kQuads, q = k - r * kQuads;
    const int i = i0 - 1 + r, j = j0 + q * kVec;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i >= 0 && i < W && j < H) {
      const float* row = f + (size_t)i * H + j;
      if (kVec4) {
        v = __ldg(reinterpret_cast<const float4*>(row));
      } else {
        v.x = __ldg(row);
        if (j + 1 < H) v.y = __ldg(row + 1);
        if (j + 2 < H) v.z = __ldg(row + 2);
        if (j + 3 < H) v.w = __ldg(row + 3);
      }
    }
    *reinterpret_cast<float4*>(&s[r][kCol0 + q * kVec]) = v;
  }
  for (int k = threadIdx.x; k < 2 * (kTileRows + 2); k += kThreads) {
    const int r = k >> 1, right = k & 1;
    const int i = i0 - 1 + r, j = right ? j0 + kTileCols : j0 - 1;
    s[r][right ? kCol0 + kTileCols : kCol0 - 1] =
        (i >= 0 && i < W && j >= 0 && j < H) ? __ldg(f + (size_t)i * H + j)
                                             : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = j0 + lane * kVec;
  if (j >= H) return;
  const int c = kCol0 + lane * kVec;
  float* out_env = out + (size_t)b * (size_t)W * (size_t)H;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int i = i0 + r;
    if (i >= W) break;
    // the thread's four columns of rows i - 1, i, i + 1 as 16-byte shared
    // loads (4 wavefronts a warp), and the columns beside them in row i
    const float4 u4 = *reinterpret_cast<const float4*>(&s[r][c]);
    const float4 m4 = *reinterpret_cast<const float4*>(&s[r + 1][c]);
    const float4 d4 = *reinterpret_cast<const float4*>(&s[r + 2][c]);
    const float up[kVec] = {u4.x, u4.y, u4.z, u4.w};
    const float down[kVec] = {d4.x, d4.y, d4.z, d4.w};
    const float mid[kVec + 2] = {s[r + 1][c - 1], m4.x, m4.y, m4.z, m4.w,
                                 s[r + 1][c + kVec]};
    float a[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int jj = j + e;
      const float m = mid[e + 1];
      // np.gradient along W (axis -2), then along H (axis -1)
      const float gx = i == 0       ? down[e] - m
                       : i == W - 1 ? m - up[e]
                                    : (down[e] - up[e]) * 0.5f;
      const float gy = jj == 0       ? mid[e + 2] - m
                       : jj == H - 1 ? m - mid[e]
                                     : (mid[e + 2] - mid[e]) * 0.5f;
      a[e] = cell_angle<kClip>(gx, gy, clip);
    }
    float* row = out_env + (size_t)i * H + j;
    if (kVec4) {
      *reinterpret_cast<float4*>(row) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (j + e < H) row[e] = a[e];
    }
  }
}

// ---- the slots ----------------------------------------------------------------

// kVec adjacent words of a row from p + j (16-byte load where kVec4),
// the words past n left 0.
template <bool kVec4>
__device__ __forceinline__ void load4(const float* __restrict__ p, int j,
                                      int n, float v[kVec]) {
  if (kVec4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p + j));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = j + e < n ? __ldg(p + j + e) : 0.0f;
  }
}

// kVec adjacent words to p + j (a 16-byte store where kVec4), the words
// past n left out.
template <bool kVec4>
__device__ __forceinline__ void store4(float* __restrict__ p, int j, int n,
                                       const float v[kVec]) {
  if (kVec4) {
    *reinterpret_cast<float4*>(p + j) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (j + e < n) p[j + e] = v[e];
  }
}

template <bool kVec4>
__device__ __forceinline__ void store4(int* __restrict__ p, int j, int n,
                                       const int v[kVec]) {
  if (kVec4) {
    *reinterpret_cast<int4*>(p + j) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (j + e < n) p[j + e] = v[e];
  }
}

// Each slot's flat sense cell: the agent's coordinates plus the polar sense
// offset along its heading, to cells (GradientPolicy._sense_cells).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    k_physarum_cells(const float* __restrict__ xs,
                     const float* __restrict__ ys, long long agent_stride,
                     const float* __restrict__ heading,
                     int* __restrict__ cells, int n, int runs, int W, int H,
                     float sense_offset) {
  const int b = blockIdx.x / runs;
  const int j = (blockIdx.x - b * runs) * kRun + (int)threadIdx.x * kVec;
  if (j >= n) return;
  const size_t row = (size_t)b * (size_t)n;
  const size_t arow = (size_t)b * (size_t)agent_stride;
  float x[kVec], y[kVec], d[kVec];
  load4<kVec4>(xs + arow, j, n, x);
  load4<kVec4>(ys + arow, j, n, y);
  load4<kVec4>(heading + row, j, n, d);
  int cell[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    float s, c;
    die::c_sincos(d[e], &s, &c);
    const int cx = coords_to_cell(x[e] + sense_offset * c, W);
    const int cy = coords_to_cell(y[e] + sense_offset * s, H);
    cell[e] = cx * H + cy;
  }
  store4<kVec4>(cells + row, j, n, cell);
}

// The policy's constants, computed on the host as the eager route does.
struct TurnConsts {
  float atol, sense_radians, turn_radians, lead, inertia, noise_scale,
      scale, deposit;
};

// Each slot's turn, momentum, noise, heading and deposit
// (PhysarumPolicy._turn_from_rads with r = 1, then GradientPolicy's
// momentum and action, PhysarumPolicy._process_deposit).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    k_physarum_turn(const float* __restrict__ drads,
                    const float* __restrict__ heading,
                    const float* __restrict__ signs,
                    const float* __restrict__ prev,
                    const float* __restrict__ noise,
                    const float* __restrict__ food,
                    float* __restrict__ action,
                    float* __restrict__ prev_out,
                    float* __restrict__ heading_out, int n, int runs,
                    TurnConsts k) {
  const int b = blockIdx.x / runs;
  const int j = (blockIdx.x - b * runs) * kRun + (int)threadIdx.x * kVec;
  if (j >= n) return;
  const size_t row = (size_t)b * (size_t)n;
  float dr[kVec], hd[kVec], sg[kVec], p0[kVec], p1[kVec], n0[kVec],
      n1[kVec], fd[kVec];
  load4<kVec4>(drads + row, j, n, dr);
  load4<kVec4>(heading + row, j, n, hd);
  load4<kVec4>(signs + row, j, n, sg);
  load4<kVec4>(prev + 2 * row, j, n, p0);
  load4<kVec4>(prev + 2 * row + n, j, n, p1);
  load4<kVec4>(noise + 2 * row, j, n, n0);
  load4<kVec4>(noise + 2 * row + n, j, n, n1);
  load4<kVec4>(food + row, j, n, fd);
  float ax[kVec], ay[kVec], dep[kVec], gx[kVec], gy[kVec], hn[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float dir_delta = renormalize(hd[e] - dr[e]);
    const float abs_drads = fabsf(dr[e]);
    const float abs_delta = fabsf(dir_delta);
    // np.isclose(0, v, rtol, atol): |v| <= atol + rtol |v|
    const bool und_grad =
        abs_drads <= (f32_bits(0x322bcc77u) + f32_bits(0x3727c5acu) * abs_drads);
    const bool und_turn =
        abs_delta <= (k.atol + f32_bits(0x3c23d70au) * abs_delta);
    const bool unseen = abs_delta > k.sense_radians;
    const bool und = und_grad || und_turn || unseen;
    const float dd = dir_delta * (und ? 0.0f : 1.0f);
    float turn = dd > k.atol ? -1.0f : sg[e];
    turn = dd < -k.atol ? 1.0f : turn;
    turn = turn * k.turn_radians;
    // clip(deposit_mask, 0.1, 1) of the mask in {0, 1}
    const float mask = (und_grad || und_turn) ? f32_bits(0x3dcccccdu) : 1.0f;
    float s, c;
    die::c_sincos(renormalize(hd[e] + turn), &s, &c);
    float px = k.lead * (1.0f * c) + k.inertia * p0[e];
    float py = k.lead * (1.0f * s) + k.inertia * p1[e];
    px = px + k.noise_scale * n0[e];
    py = py + k.noise_scale * n1[e];
    gx[e] = px;
    gy[e] = py;
    hn[e] = c_atan2(py, px);
    ax[e] = px * k.scale;
    ay[e] = py * k.scale;
    dep[e] = k.deposit * fd[e] * mask;
  }
  float* act = action + 3 * row;
  store4<kVec4>(act, j, n, ax);
  store4<kVec4>(act + n, j, n, ay);
  store4<kVec4>(act + 2 * (size_t)n, j, n, dep);
  store4<kVec4>(prev_out + 2 * row, j, n, gx);
  store4<kVec4>(prev_out + 2 * row + n, j, n, gy);
  store4<kVec4>(heading_out + row, j, n, hn);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

// The angle field of B envs: chem f32 with env b's [W, H] plane dense at
// chem + b env_stride, out f32 [B, W H] contiguous; clip below 0 for no
// grad_clip.  Returns a cudaError_t: invalid value, before any launch, for
// a shape the kernel does not take (B below 1, W or H below 2, more than
// 2**31 - 1 cells an env or blocks).
extern "C" int die_physarum_field(const float* chem, long long env_stride,
                                  float* out, int B, int W, int H,
                                  int has_clip, float clip, void* stream) {
  if (B < 1 || W < 2 || H < 2 || (long long)W * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int row_tiles = (W + kTileRows - 1) / kTileRows;
  const int col_tiles = (H + kTileCols - 1) / kTileCols;
  const long long grid = (long long)B * row_tiles * col_tiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec4 = H % kVec == 0 && env_stride % kVec == 0 &&
                    aligned16(chem) && aligned16(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)grid;
#define DIE_FIELD(CLIP, VEC)                                                 \
  k_physarum_field<CLIP, VEC><<<g, kThreads, 0, s>>>(                        \
      chem, env_stride, out, W, H, row_tiles, col_tiles, clip)
  if (has_clip) {
    if (vec4) DIE_FIELD(true, true); else DIE_FIELD(true, false);
  } else {
    if (vec4) DIE_FIELD(false, true); else DIE_FIELD(false, false);
  }
#undef DIE_FIELD
  return (int)cudaGetLastError();
}

// The sense cells of B x n slots: x and y f32 rows of n at xs + b
// agent_stride and ys + b agent_stride, heading f32 [B, n] and cells int32
// [B, n] contiguous.  Invalid value, before any launch, for B or n below
// 1, W or H below 2, more than 2**31 - 1 cells or blocks.
extern "C" int die_physarum_cells(const float* xs, const float* ys,
                                  long long agent_stride,
                                  const float* heading, int* cells, int B,
                                  int n, int W, int H, float sense_offset,
                                  void* stream) {
  const long long runs = ((long long)n + kRun - 1) / kRun;
  if (B < 1 || n < 1 || W < 2 || H < 2 || (long long)W * H > INT_MAX ||
      (long long)B * runs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = n % kVec == 0 && agent_stride % kVec == 0 &&
                    aligned16(xs) && aligned16(ys) && aligned16(heading) &&
                    aligned16(cells);
  const unsigned g = (unsigned)(B * runs);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    k_physarum_cells<true><<<g, kThreads, 0, s>>>(
        xs, ys, agent_stride, heading, cells, n, (int)runs, W, H,
        sense_offset);
  else
    k_physarum_cells<false><<<g, kThreads, 0, s>>>(
        xs, ys, agent_stride, heading, cells, n, (int)runs, W, H,
        sense_offset);
  return (int)cudaGetLastError();
}

// The turn of B x n slots, every array contiguous: drads, heading, signs,
// food [B, n]; prev, noise [B, 2, n]; out action [B, 3, n], prev_out
// [B, 2, n], heading_out [B, n].  Invalid value, before any launch, for B
// or n below 1, more than 2**31 - 1 words a row of outputs or blocks.
extern "C" int die_physarum_turn(const float* drads, const float* heading,
                                 const float* signs, const float* prev,
                                 const float* noise, const float* food,
                                 float* action, float* prev_out,
                                 float* heading_out, int B, int n, float atol,
                                 float sense_radians, float turn_radians,
                                 float lead, float inertia, float noise_scale,
                                 float scale, float deposit, void* stream) {
  const long long runs = ((long long)n + kRun - 1) / kRun;
  if (B < 1 || n < 1 || 3LL * n > INT_MAX || (long long)B * runs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = n % kVec == 0 && aligned16(drads) &&
                    aligned16(heading) && aligned16(signs) &&
                    aligned16(prev) && aligned16(noise) && aligned16(food) &&
                    aligned16(action) && aligned16(prev_out) &&
                    aligned16(heading_out);
  const TurnConsts k{atol,    sense_radians, turn_radians, lead,
                     inertia, noise_scale,   scale,        deposit};
  const unsigned g = (unsigned)(B * runs);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    k_physarum_turn<true><<<g, kThreads, 0, s>>>(
        drads, heading, signs, prev, noise, food, action, prev_out,
        heading_out, n, (int)runs, k);
  else
    k_physarum_turn<false><<<g, kThreads, 0, s>>>(
        drads, heading, signs, prev, noise, food, action, prev_out,
        heading_out, n, (int)runs, k);
  return (int)cudaGetLastError();
}
