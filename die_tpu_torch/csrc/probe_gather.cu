// Gathers of cells of a whole 256x256 f32 field inside one kernel, repeated
// and summed: by an indexed load, and by one-hot products on the tensor cores.
//
// die_probe_gather (P6): out[b, i] = reps times field[b][cells[b, i] mod
//   65536], added one by one to an f32 zero.  Replaces `gather_taa_fullshape`
//   of tools/tpu_measure2.py (the pallas_call at :86), a take_along_axis of
//   the field broadcast to [8, 65536] lanes.  Mosaic wants idx.shape ==
//   a.shape, so the TPU gathers all 65,536 lanes of each of its 8 rows and
//   keeps the first 8,192; here only the N real cells are gathered, which is
//   the same output.  Two placements of the field:
//   - cluster: the 256 KB field does not fit one block's 227 KB, so a
//     cluster of 4 blocks holds it, 64 KB each, and a cell is read from
//     whichever block holds it through distributed shared memory
//     (cluster.map_shared_rank, as csrc/probe_shift.cu holds a field; an
//     explicit mapa + ld.shared::cluster compiles to the same generic LD);
//   - l2: every read is an __ldg of the field in device memory (it stays in
//     L1 and L2 across the reps).
// die_probe_onehot (P7): the same gather-sum on one field as the TPU kernel
//   `make_gather_onehot_kernel` (:137) computes it: the field as [512, 128],
//   per cell a one-hot row [512] times the field on the matrix unit, then a
//   one-hot pick of the cell's column.  Here the product runs on the tensor
//   cores with mma.sync:
//   - bf16x3, the twin of the TPU's "3x": the field split exactly into bf16
//     hi = bf16(f), mid = bf16(f - hi), lo = f - hi - mid and three bf16
//     products with f32 accumulation; a product row has one non-zero term
//     (1 * part), so each product is its part exactly and (hi + mid) + lo,
//     added on the CUDA cores, is f;
//   - tf32, the card's one pass where the TPU has HIGHEST: one TF32 product
//     (cvt.rna.tf32.f32 of the field), which picks the field rounded to TF32.
//   A block takes 512 cells (32 m16 tiles, 4 a warp) and stages the field in
//   4 bands of 32 columns, transposed (column-major, so a B fragment is one
//   32-bit shared load, the row stride padded so the 32 lanes hit 32 banks);
//   the reps run inside a band, and a cell's sum is kept in shared memory by
//   the one thread whose C fragment holds the cell's column.
//
// Every rep redoes its work.  The TPU code keeps the compiler from hoisting
// a rep's loop-invariant work with `i_ref[:] + k - k` (tpu_measure2.py:80,
// :119), which nvcc folds away.  An empty asm volatile on the cell does not
// do either: it leaves no PTX instruction, and ptxas hoisted the load out of
// the rep loop (seen in the SASS).  So each rep reads the cell at
// `cell + rep * zero`, with `zero` a kernel argument the entry point sets to
// 0: the compiler cannot prove it loop-invariant, so every rep loads (P6) or
// builds its one-hot fragments (P7) anew, for one integer multiply-add.
//
// Bounds: P6 moves the field, the cells and the output once (bytes) against
// B * N * reps f32 adds; its phase is B * N * reps random 4-byte reads at 32
// a cycle an SM over the SMs the placement uses.  P7 does 2 * 1024 * 512 *
// 128 FLOP a 1024-cell chunk a rep a pass (137.4 GFLOP a pass at N = 65,536,
// 16 reps): three bf16 passes at 989 TFLOP/s, one TF32 pass at 495.
// Outputs are bitwise equal to the plain versions (tools/probes2.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 256;
constexpr int kCells = kN * kN;  // 65536
constexpr int kCellMask = kCells - 1;

// ---- P6: cluster -----------------------------------------------------------------
constexpr int kGCta = 4;
constexpr int kGPart = kCells / kGCta;  // 16384 cells (64 KB) a block
constexpr int kGShift = 14;             // cell >> kGShift: the holding block
constexpr int kGThreads = 1024;
constexpr int kGSmem = kGPart * 4;

__global__ void __cluster_dims__(kGCta, 1, 1) __launch_bounds__(kGThreads, 1)
gather_cluster_kernel(const float* __restrict__ field,
                      const int* __restrict__ cells, float* __restrict__ out,
                      int n, int reps, int zero) {
  extern __shared__ float part[];  // [kGPart]: this block's quarter
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const long long env = blockIdx.x / kGCta;
  const float* fe = field + env * kCells + (long long)rank * kGPart;
  for (int e = threadIdx.x; e < kGPart; e += kGThreads) part[e] = fe[e];
  cl.sync();
  const int* ce = cells + env * n;
  float* oe = out + env * n;
  for (int j = rank * kGThreads + threadIdx.x; j < n;
       j += kGCta * kGThreads) {
    const int c0 = ce[j] & kCellMask;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < reps; ++k) {
      const int c = c0 + k * zero;
      const float* src =
          cl.map_shared_rank(part + (c & (kGPart - 1)), c >> kGShift);
      acc = __fadd_rn(acc, *src);
    }
    oe[j] = acc;
  }
  cl.sync();  // no block leaves while another still reads its quarter
}

// ---- P6: through L2 ----------------------------------------------------------------
constexpr int kLThreads = 256;

__global__ void __launch_bounds__(kLThreads)
gather_l2_kernel(const float* __restrict__ field, const int* __restrict__ cells,
                 float* __restrict__ out, int n, int reps, int zero) {
  const long long env = blockIdx.y;
  const int j = blockIdx.x * kLThreads + threadIdx.x;
  if (j >= n) return;
  const float* fe = field + env * kCells;
  const int c0 = cells[env * n + j] & kCellMask;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < reps; ++k) acc = __fadd_rn(acc, __ldg(fe + c0 + k * zero));
  out[env * n + j] = acc;
}

// ---- P7: one-hot products on the tensor cores ------------------------------------
constexpr int kOhK = 512;        // rows of the [512, 128] field: the product's K
constexpr int kOhCols = 128;     // its columns: the product's N
constexpr int kOhBand = 32;      // columns staged at a time
constexpr int kOhBands = kOhCols / kOhBand;
constexpr int kOhNt = kOhBand / 8;   // n8 tiles of a band
constexpr int kOhCellsPerBlock = 512;
constexpr int kOhThreads = 256;
constexpr int kOhWarps = kOhThreads / 32;
constexpr int kOhMt = kOhCellsPerBlock / kOhWarps / 16;  // m16 tiles a warp (4)
constexpr int kBfStride = kOhK + 8;  // bf16 of a staged column: 260 words, so
                                     // lanes (g, t) hit banks 4 g + t
constexpr int kTfStride = kOhK + 4;  // f32 of a staged column: the same
constexpr int kOhHead = 2 * kOhCellsPerBlock * 4;  // sums and cells
constexpr int kOhSmemBf = kOhHead + 3 * kOhBand * kBfStride * 2;
constexpr int kOhSmemTf = kOhHead + kOhBand * kTfStride * 4;
constexpr uint32_t kOneBf16 = 0x3F80u;      // bf16 1.0
constexpr uint32_t kOneF32 = 0x3F800000u;   // f32 (and TF32) 1.0

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t tf32_bits(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ uint16_t bf16_bits(float f) {
  const __nv_bfloat16 h = __float2bfloat16_rn(f);
  return *reinterpret_cast<const uint16_t*>(&h);
}

__device__ __forceinline__ float bf16_value(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// the one-hot pair (k, k + 1) of a row whose 1 sits at r, bf16x2 (k low)
__device__ __forceinline__ uint32_t onehot2(int r, int k) {
  return (r == k ? kOneBf16 : 0u) | (r == k + 1 ? kOneBf16 << 16 : 0u);
}

template <bool BF16X3>
__global__ void __launch_bounds__(kOhThreads)
onehot_kernel(const float* __restrict__ field, const int* __restrict__ cells,
              float* __restrict__ out, int reps, int zero) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* acc_s = reinterpret_cast<float*>(raw);  // [kOhCellsPerBlock] sums
  int* cell_s = reinterpret_cast<int*>(acc_s + kOhCellsPerBlock);  // cells
  // BF16X3: 3 planes (hi, mid, lo) of [kOhBand][kBfStride] bf16;
  // TF32: one plane of [kOhBand][kTfStride] TF32 bit patterns
  uint16_t* bf = reinterpret_cast<uint16_t*>(raw + kOhHead);
  uint32_t* tf = reinterpret_cast<uint32_t*>(raw + kOhHead);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long j0 = (long long)blockIdx.x * kOhCellsPerBlock;
  for (int i = threadIdx.x; i < kOhCellsPerBlock; i += kOhThreads) {
    acc_s[i] = 0.0f;
    cell_s[i] = cells[j0 + i] & kCellMask;
  }

#pragma unroll 1
  for (int band = 0; band < kOhBands; ++band) {
    __syncthreads();  // the last band's fragments are read
    for (int e = threadIdx.x; e < kOhK * kOhBand; e += kOhThreads) {
      const int k = e / kOhBand, n = e % kOhBand;
      const float f = field[k * kOhCols + band * kOhBand + n];
      if constexpr (BF16X3) {
        const uint16_t hi = bf16_bits(f);
        const float r1 = __fsub_rn(f, bf16_value(hi));
        const uint16_t mid = bf16_bits(r1);
        const uint16_t lo = bf16_bits(__fsub_rn(r1, bf16_value(mid)));  // exact
        bf[(0 * kOhBand + n) * kBfStride + k] = hi;
        bf[(1 * kOhBand + n) * kBfStride + k] = mid;
        bf[(2 * kOhBand + n) * kBfStride + k] = lo;
      } else {
        tf[n * kTfStride + k] = tf32_bits(f);
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 1
      for (int q = 0; q < kOhMt; ++q) {
        // rows g and g + 8 of m16 tile q: the cells' field rows (where the
        // one-hot rows hold their 1) and columns (the pick)
        const int i0 = warp * 16 * kOhMt + q * 16 + g, i1 = i0 + 8;
        const int c0 = cell_s[i0] + rep * zero, c1 = cell_s[i1] + rep * zero;
        const int r0 = c0 / kOhCols, r1 = c1 / kOhCols;
        const int nc[2] = {c0 % kOhCols, c1 % kOhCols};
        constexpr int kParts = BF16X3 ? 3 : 1;
        float d[kParts][kOhNt][4];
#pragma unroll
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int nt = 0; nt < kOhNt; ++nt)
            d[p][nt][0] = d[p][nt][1] = d[p][nt][2] = d[p][nt][3] = 0.0f;
        if constexpr (BF16X3) {
          const uint32_t* w = reinterpret_cast<const uint32_t*>(bf);
#pragma unroll 2
          for (int k0 = 0; k0 < kOhK; k0 += 16) {
            const uint32_t a0 = onehot2(r0, k0 + 2 * t);
            const uint32_t a1 = onehot2(r1, k0 + 2 * t);
            const uint32_t a2 = onehot2(r0, k0 + 2 * t + 8);
            const uint32_t a3 = onehot2(r1, k0 + 2 * t + 8);
#pragma unroll
            for (int nt = 0; nt < kOhNt; ++nt) {
              const int n = nt * 8 + g;
#pragma unroll
              for (int p = 0; p < 3; ++p) {
                const uint32_t* col =
                    w + ((p * kOhBand + n) * kBfStride + k0) / 2 + t;
                mma_bf16(d[p][nt], a0, a1, a2, a3, col[0], col[4]);
              }
            }
          }
        } else {
#pragma unroll 4
          for (int k0 = 0; k0 < kOhK; k0 += 8) {
            const uint32_t a0 = r0 == k0 + t ? kOneF32 : 0u;
            const uint32_t a1 = r1 == k0 + t ? kOneF32 : 0u;
            const uint32_t a2 = r0 == k0 + t + 4 ? kOneF32 : 0u;
            const uint32_t a3 = r1 == k0 + t + 4 ? kOneF32 : 0u;
#pragma unroll
            for (int nt = 0; nt < kOhNt; ++nt) {
              const uint32_t* col = tf + (nt * 8 + g) * kTfStride + k0 + t;
              mma_tf32(d[0][nt], a0, a1, a2, a3, col[0], col[4]);
            }
          }
        }
        // C fragment e of tile nt: row g + 8 (e >> 1), column nt * 8 + 2 t +
        // (e & 1) of the band; the one thread holding a cell's column adds
        // its pick (the one-hot column sum of the TPU: one term and zeros)
#pragma unroll
        for (int nt = 0; nt < kOhNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int col = band * kOhBand + nt * 8 + 2 * t + (e & 1);
            if (col == nc[h]) {
              float v = d[0][nt][e];
              if constexpr (BF16X3)
                v = __fadd_rn(__fadd_rn(v, d[1][nt][e]), d[2][nt][e]);
              float& a = acc_s[h ? i1 : i0];
              a = __fadd_rn(a, v);
            }
          }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kOhCellsPerBlock; i += kOhThreads)
    out[j0 + i] = acc_s[i];
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// field: [B, 256, 256] f32; cells: [B, n] int32 (read mod 65536); out: [B, n]
// f32; placement 0 cluster, 1 l2.  Returns the CUDA error of the launch (0 =
// ok, -1 = arguments out of range).
extern "C" int die_probe_gather(const void* field, const void* cells,
                                void* out, int B, int n, int reps,
                                int placement, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || reps < 0 ||
      (placement != 0 && placement != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(field);
  const int* c = static_cast<const int*>(cells);
  float* o = static_cast<float*>(out);
  if (placement == 0) {
    const int rc = prepare(gather_cluster_kernel, kGSmem);
    if (rc) return rc;
    gather_cluster_kernel<<<B * kGCta, kGThreads, kGSmem, s>>>(f, c, o, n,
                                                                reps, 0);
  } else {
    const dim3 grid((n + kLThreads - 1) / kLThreads, B);
    gather_l2_kernel<<<grid, kLThreads, 0, s>>>(f, c, o, n, reps, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// field: [256, 256] f32; cells: [n] int32 (read mod 65536), n a multiple of
// 512; out: [n] f32; leg 0 bf16x3, 1 tf32.
extern "C" int die_probe_onehot(const void* field, const void* cells,
                                void* out, int n, int reps, int leg,
                                void* stream) {
  if (n < 1 || n % kOhCellsPerBlock || reps < 0 || (leg != 0 && leg != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(field);
  const int* c = static_cast<const int*>(cells);
  float* o = static_cast<float*>(out);
  const int grid = n / kOhCellsPerBlock;
  int rc;
  if (leg == 0) {
    rc = prepare(onehot_kernel<true>, kOhSmemBf);
    if (!rc) onehot_kernel<true><<<grid, kOhThreads, kOhSmemBf, s>>>(f, c, o, reps, 0);
  } else {
    rc = prepare(onehot_kernel<false>, kOhSmemTf);
    if (!rc) onehot_kernel<false><<<grid, kOhThreads, kOhSmemTf, s>>>(f, c, o, reps, 0);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
