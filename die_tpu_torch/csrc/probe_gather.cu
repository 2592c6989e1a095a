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
//     cluster of 4 blocks holds it, 64 KB each, brought in by one
//     cp.async.bulk a block.  A field has `per_field` clusters, each with
//     its own copy and a share of `per_cluster` cells (the wrapper's plan,
//     tools/probes2.py gather_plan: 33 clusters at B = 1 on 132 SMs, one a
//     field at B = 64), so every SM works at any B.  Reads are routed to
//     the block that holds them: every block of a cluster scans the
//     cluster's cells, a warp 512 a round with all 16 loads of a lane in
//     flight, keeps those of its own quarter (cell >> 14 == its rank) in a
//     list of its warp, 128 cells at a time (ballot, prefix count), and
//     gathers the list from its own shared memory, every lane on a cell.
//     No read leaves the block.  Reading another block's quarter through
//     distributed shared memory, many loads in flight, was 6x (B = 1) and
//     13x (B = 64) slower.  A block is 72 KB, so that 3 fit an SM and the
//     64 clusters of B = 64 run at once (at 80 KB, 62 did).
//   - l2: every read is an __ldg of the field in device memory (it stays in
//     L1 and L2 across the reps).
// die_probe_onehot (P7): the same gather-sum on one field as the TPU kernel
//   `make_gather_onehot_kernel` (:137) computes it: the field as [512, 128],
//   per cell a one-hot row [512] times the field on the matrix unit, then a
//   one-hot pick of the cell's column.  Here the product runs on wgmma:
//   - bf16x3, the twin of the TPU's "3x": the field split exactly into bf16
//     hi = bf16(f), mid = bf16(f - hi), lo = f - hi - mid and three bf16
//     products with f32 accumulation, one accumulator a part; a product row
//     has one non-zero term (1 * part), so each product is its part exactly
//     and (hi + mid) + lo, added on the CUDA cores, is f;
//   - tf32, the card's one pass where the TPU has HIGHEST: one TF32 product
//     (cvt.rna.tf32.f32 of the field), which picks the field rounded to TF32.
//   A first short kernel of the same call splits the field once into a
//   device scratch already in wgmma's shared-memory layout for B: K-major
//   (each column's 512 rows contiguous, as TF32 requires), 128-byte rows
//   with the 128-byte swizzle, 64 columns a band.  The whole field does not
//   fit a block (bf16x3 384 KB, tf32 256 KB), so the product kernel stages
//   it in 2 bands of 64 columns with all of K resident (192 KB, 128 KB),
//   each band one set of 1-D cp.async.bulk copies on an mbarrier (no tensor
//   map): each block reloads a band from L2 once, where a cluster of 2
//   sharing the bands by multicast would add cluster barriers.  A
//   persistent grid of one block an SM, 2 warpgroups, walks the m64 tiles
//   of cells (block b takes tiles b, b + grid, b + 2 grid, ..., its
//   warpgroups in turn): per band, tile and rep, wgmma m64n64 (k16 bf16,
//   k8 tf32) with A in registers, each thread building its one-hot
//   fragments from its two cells' rows with compares, 16 (bf16) or 32
//   (tf32) k-steps a batch between a wgmma.fence and a wait, while the
//   other warpgroup's products run (3 warpgroups fit only 8 / 16 k-steps a
//   batch, which ran slower).  The one-hot never touches shared memory and
//   no thread loads B.  The thread whose accumulator holds a cell's column
//   adds the pick to the cell's sum and writes it.  All-zero blocks of the
//   one-hot operand are multiplied too: the dense products are the probe.
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
// a cycle an SM over the SMs the plan's grid uses.  P7 does 2 * 1024 * 512 *
// 128 FLOP a 1024-cell chunk a rep a pass (137.4 GFLOP a pass at N = 65,536,
// 16 reps): three bf16 passes at 989 TFLOP/s, one TF32 pass at 495.
// Outputs are bitwise equal to the plain versions (tools/probes2.py) for
// fields whose parts are normal numbers or zero (subnormal parts are outside
// the probe: the tensor cores may flush them).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kN = 256;
constexpr int kCells = kN * kN;  // 65536
constexpr int kCellMask = kCells - 1;

// ---- bulk copies on an mbarrier --------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of copies in this phase
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// waits for the phase of `parity` to complete; a copy that never lands
// traps (the launch then fails) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// `bytes` (a multiple of 16) from device memory to shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- P6: cluster -----------------------------------------------------------------
constexpr int kGCta = 4;
constexpr int kGPart = kCells / kGCta;  // 16384 cells (64 KB) a block
constexpr int kGShift = 14;             // cell >> kGShift: the holding block
constexpr int kGThreads = 512;
constexpr int kGWarps = kGThreads / 32;
constexpr int kGScan = 16;              // cells a lane loads a round
constexpr int kGList = 32 * 4;          // cells a warp lists at a time
constexpr int kGRound = 32 * kGScan;    // cells a warp scans a round
constexpr long long kGStep = kGWarps * kGRound;  // cells a block a round
// 72 KB: 3 blocks an SM, so that B = 64's 64 clusters run in one wave
constexpr int kGSmem = kGPart * 4 + kGWarps * kGList * 4 + 16;

// the block's quarter of its cluster's field copy, by one bulk copy on bar
__device__ __forceinline__ void start_quarter(float* part, uint32_t bar,
                                              const float* field,
                                              long long env, int rank) {
  if (threadIdx.x == 0) {
    bar_init(bar);
    bar_expect(bar, kGPart * 4);
    bulk_load(smem_addr(part), field + env * kCells + (long long)rank * kGPart,
              kGPart * 4, bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
}

__global__ void __cluster_dims__(kGCta, 1, 1) __launch_bounds__(kGThreads)
gather_cluster_kernel(const float* __restrict__ field,
                      const int* __restrict__ cells, float* __restrict__ out,
                      int n, int reps, int zero, int per_field,
                      int per_cluster) {
  extern __shared__ __align__(16) unsigned char raw[];
  float* part = reinterpret_cast<float*>(raw);  // [kGPart]: this quarter
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's list of its own cells: offset in the round << 14 | cell in
  // the quarter
  int* list = reinterpret_cast<int*>(raw + kGPart * 4) + warp * kGList;
  const uint32_t bar = smem_addr(raw + kGPart * 4 + kGWarps * kGList * 4);
  const int rank = (int)cg::this_cluster().block_rank();
  const int cluster = blockIdx.x / kGCta;
  const long long env = cluster / per_field;
  const long long start = (long long)(cluster % per_field) * per_cluster;
  const int end = (int)min((long long)n, start + per_cluster);
  start_quarter(part, bar, field, env, rank);
  const int* ce = cells + env * n;
  float* oe = out + env * n;
  for (long long base = start + warp * kGRound; base < end; base += kGStep) {
    int c[kGScan];  // all of the round's loads in flight before any is used
#pragma unroll
    for (int i = 0; i < kGScan; ++i) {
      const long long j = base + i * 32 + lane;
      c[i] = j < end ? (ce[j] & kCellMask) : -1;
    }
    bar_wait(bar, 0);  // the quarter has landed (at once after the first)
#pragma unroll
    for (int i0 = 0; i0 < kGScan; i0 += kGList / 32) {
      int count = 0;
#pragma unroll
      for (int i = i0; i < i0 + kGList / 32; ++i) {
        const bool mine = (c[i] >> kGShift) == rank;
        const unsigned m = __ballot_sync(0xffffffffu, mine);
        if (mine)
          list[count + __popc(m & ((1u << lane) - 1u))] =
              (i * 32 + lane) << kGShift | (c[i] & (kGPart - 1));
        count += __popc(m);
      }
      __syncwarp();
      for (int q = lane; q < count; q += 32) {
        const int e = list[q];
        const int c0 = e & (kGPart - 1);
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < reps; ++k)
          acc = __fadd_rn(acc, part[(c0 + k * zero) & (kGPart - 1)]);
        oe[base + (e >> kGShift)] = acc;
      }
      __syncwarp();  // the list is read before it is rewritten
    }
  }
  bar_wait(bar, 0);  // no block leaves while its copy is in flight
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

// ---- P7: one-hot products on wgmma -----------------------------------------------
constexpr int kOhK = 512;       // rows of the [512, 128] field: the product's K
constexpr int kOhCols = 128;    // its columns
constexpr int kOhBandCols = 64; // columns a band: the product's N
constexpr int kOhBands = kOhCols / kOhBandCols;
constexpr int kOhTile = 64;     // cells of an m64 tile
constexpr int kOhGroups = 2;    // warpgroups a block
constexpr int kOhThreads = 128 * kOhGroups;
constexpr int kOhRow = 128;     // bytes of K a swizzled row of a column
constexpr int kOhAtom = kOhBandCols * kOhRow;  // 8 KB: one row of each column
constexpr int kOhCopy = 16384;  // bytes a bulk copy
constexpr int kOhSplitThreads = 256;
constexpr uint32_t kOneBf16 = 0x3F80u;     // bf16 1.0
constexpr uint32_t kOneF32 = 0x3F800000u;  // f32 (and TF32) 1.0

template <bool BF16X3>
struct Leg {
  static constexpr int kParts = BF16X3 ? 3 : 1;
  static constexpr int kElem = BF16X3 ? 2 : 4;  // bytes of a B element
  static constexpr int kPartBytes = kOhK * kOhBandCols * kElem;
  static constexpr int kBandBytes = kParts * kPartBytes;
  static constexpr int kStepK = 32 / kElem;     // K a wgmma: 16 bf16, 8 tf32
  static constexpr int kSteps = kOhK / kStepK;  // 32, 64
  static constexpr int kBatch = BF16X3 ? 16 : 32;  // k-steps between waits
  static constexpr int kChunkK = 16 / kElem;      // K of a 16-byte chunk
  static constexpr int kSmem = kBandBytes + 1024 + 16;  // + alignment, barrier
};

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

// Byte offset of the 16-byte chunk holding K rows [k, k + chunk) of band
// column n in a part's K-major, 128-byte-swizzled layout: rows of 128 bytes
// (64 bf16 or 32 tf32 of K) a column, 64 columns an 8 KB atom, atoms along
// K; chunk q of column n's row sits at q ^ (n & 7) (the swizzle wgmma reads
// from an atom on a 1024-byte boundary).
__device__ __forceinline__ int swizzled_chunk(int k_byte, int n) {
  const int atom = k_byte / kOhRow, q = (k_byte % kOhRow) / 16;
  return atom * kOhAtom + n * kOhRow + ((q ^ (n & 7)) * 16);
}

// One 16-byte chunk a thread: kChunkK rows of one field column, every part.
template <bool BF16X3>
__global__ void __launch_bounds__(kOhSplitThreads)
onehot_split_kernel(const float* __restrict__ field,
                    unsigned char* __restrict__ scratch) {
  using L = Leg<BF16X3>;
  const int e = blockIdx.x * kOhSplitThreads + threadIdx.x;
  const int col = e % kOhCols;  // neighbouring threads read neighbouring columns
  const int k0 = (e / kOhCols) * L::kChunkK;
  if (k0 >= kOhK) return;
  const int band = col / kOhBandCols, n = col % kOhBandCols;
  unsigned char* dst = scratch + (size_t)band * L::kBandBytes +
                       swizzled_chunk(k0 * L::kElem, n);
  if constexpr (BF16X3) {
    uint32_t w[3][4];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      uint32_t pair[3] = {0u, 0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float f = field[(k0 + i + h) * kOhCols + col];
        const uint16_t hi = bf16_bits(f);
        const float r1 = __fsub_rn(f, bf16_value(hi));
        const uint16_t mid = bf16_bits(r1);
        const uint16_t lo = bf16_bits(__fsub_rn(r1, bf16_value(mid)));  // exact
        pair[0] |= (uint32_t)hi << (16 * h);
        pair[1] |= (uint32_t)mid << (16 * h);
        pair[2] |= (uint32_t)lo << (16 * h);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) w[p][i / 2] = pair[p];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(dst + p * L::kPartBytes) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = tf32_bits(field[(k0 + i) * kOhCols + col]);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// wgmma's shared-memory descriptor of B: K-major, 128-byte swizzle, 8-column
// groups 1024 bytes apart (the leading offset is unused by this layout)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the 32-byte K slice of k-step s: 4 slices a 128-byte row, atoms 8 KB apart
__device__ __forceinline__ uint32_t step_offset(int s) {
  return (uint32_t)((s >> 2) * kOhAtom + (s & 3) * 32);
}

template <int N>
__device__ __forceinline__ void keep_f(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void keep_r(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define DIE_D32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define DIE_D32_LIST                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}, "

// d (+)= A B on a warpgroup: A [64, K] from registers, B [K, 64] from shared
// memory; d is the m64n64 f32 accumulator (d = A B where accumulate is 0)
template <bool BF16X3>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  if constexpr (BF16X3) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DIE_D32_LIST
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : DIE_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DIE_D32_LIST
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : DIE_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
}

// the bf16x2 one-hot pair (k, k + 1) of a row whose 1 sits at r (k low)
__device__ __forceinline__ uint32_t onehot2(int r, int k) {
  const unsigned d = (unsigned)(r - k);
  return d < 2u ? kOneBf16 << (16 * d) : 0u;
}

// A of k-step s for the warp's rows g (field row r0) and g + 8 (r1), thread
// column t: wgmma's register layout, as mma.sync's m16n8k16 / m16n8k8 A
template <bool BF16X3>
__device__ __forceinline__ void build_a(uint32_t (&a)[4], int s, int r0,
                                        int r1, int t) {
  if constexpr (BF16X3) {
    const int k = s * 16 + 2 * t;
    a[0] = onehot2(r0, k);
    a[1] = onehot2(r1, k);
    a[2] = onehot2(r0, k + 8);
    a[3] = onehot2(r1, k + 8);
  } else {
    const int k = s * 8 + t;
    a[0] = r0 == k ? kOneF32 : 0u;
    a[1] = r1 == k ? kOneF32 : 0u;
    a[2] = r0 == k + 4 ? kOneF32 : 0u;
    a[3] = r1 == k + 4 ? kOneF32 : 0u;
  }
}

template <bool BF16X3>
__global__ void __launch_bounds__(kOhThreads, 1)
onehot_kernel(const unsigned char* __restrict__ scratch,
              const int* __restrict__ cells, float* __restrict__ out, int tiles,
              int reps, int zero) {
  using L = Leg<BF16X3>;
  extern __shared__ __align__(16) unsigned char raw[];
  const uint32_t base = (smem_addr(raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t bar = base + L::kBandBytes;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) bar_init(bar);
  __syncthreads();

#pragma unroll 1
  for (int band = 0; band < kOhBands; ++band) {
    __syncthreads();  // the last band's products are done: its smem is free
    if (tid == 0) {
      bar_expect(bar, L::kBandBytes);
      const unsigned char* src = scratch + (size_t)band * L::kBandBytes;
      for (int off = 0; off < L::kBandBytes; off += kOhCopy)
        bulk_load(base + off, src + off, kOhCopy, bar);
    }
    bar_wait(bar, band & 1);

#pragma unroll 1
    for (int tile = blockIdx.x + wg * gridDim.x; tile < tiles;
         tile += kOhGroups * gridDim.x) {
      // accumulator rows g and g + 8 of warp w: cells i0 and i0 + 8
      const int i0 = tile * kOhTile + 16 * w + g;
      const int cell[2] = {cells[i0] & kCellMask, cells[i0 + 8] & kCellMask};
      float acc[2] = {0.0f, 0.0f};
      float d[L::kParts][32];  // a rep's first k-step overwrites them
#pragma unroll
      for (int p = 0; p < L::kParts; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) d[p][e] = 0.0f;
#pragma unroll 1
      for (int rep = 0; rep < reps; ++rep) {
        const int c0 = cell[0] + rep * zero, c1 = cell[1] + rep * zero;
#pragma unroll 1
        for (int b = 0; b < L::kSteps / L::kBatch; ++b) {
          uint32_t a[L::kBatch][4];
#pragma unroll
          for (int s = 0; s < L::kBatch; ++s) {
            build_a<BF16X3>(a[s], b * L::kBatch + s, c0 >> 7, c1 >> 7, t);
            keep_r(a[s]);
          }
#pragma unroll
          for (int p = 0; p < L::kParts; ++p) keep_f(d[p]);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int s = 0; s < L::kBatch; ++s)
#pragma unroll
            for (int p = 0; p < L::kParts; ++p)
              wgmma<BF16X3>(d[p], a[s],
                            b_desc(base + p * L::kPartBytes +
                                   step_offset(b * L::kBatch + s)),
                            b | s);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
          for (int p = 0; p < L::kParts; ++p) keep_f(d[p]);
        }
        // the pick: accumulator e of thread (g, t) holds row g + 8 (e >> 1
        // & 1), band column 8 (e >> 2) + 2 t + (e & 1); the one thread
        // holding a cell's column adds (the TPU's one-hot column sum: one
        // term and zeros)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (h ? c1 : c0) & (kOhCols - 1);
          if ((col >> 6) != band || ((col & 7) >> 1) != t) continue;
          const int sel = 4 * ((col & 63) >> 3) + 2 * h + (col & 1);
          float v[L::kParts];
#pragma unroll
          for (int p = 0; p < L::kParts; ++p) v[p] = 0.0f;
#pragma unroll
          for (int e = 2 * h; e < 32; e += 4)
#pragma unroll
            for (int o = 0; o < 2; ++o)
              if (sel == e + o)
#pragma unroll
                for (int p = 0; p < L::kParts; ++p) v[p] = d[p][e + o];
          float x = v[0];
          if constexpr (BF16X3) x = __fadd_rn(__fadd_rn(x, v[1]), v[2]);
          acc[h] = __fadd_rn(acc[h], x);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = cell[h] & (kOhCols - 1);
        if ((col >> 6) == band && ((col & 7) >> 1) == t)
          out[i0 + 8 * h] = acc[h];
      }
    }
  }
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool BF16X3>
int launch_onehot(const float* f, const int* c, unsigned char* scratch,
                  float* o, int n, int reps, int grid, cudaStream_t s) {
  using L = Leg<BF16X3>;
  constexpr int kSplit = kOhK / L::kChunkK * kOhCols / kOhSplitThreads;
  onehot_split_kernel<BF16X3><<<kSplit, kOhSplitThreads, 0, s>>>(f, scratch);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = prepare(onehot_kernel<BF16X3>, L::kSmem);
  if (rc) return rc;
  onehot_kernel<BF16X3><<<grid, kOhThreads, L::kSmem, s>>>(
      scratch, c, o, n / kOhTile, reps, 0);
  return (int)cudaGetLastError();
}

}  // namespace

// field: [B, 256, 256] f32; cells: [B, n] int32 (read mod 65536); out: [B, n]
// f32; placement 0 cluster (B * per_field clusters of 4 blocks, each with
// per_cluster cells of its field: tools/probes2.py gather_plan), 1 l2.
// Returns the CUDA error of the launch (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_gather(const void* field, const void* cells,
                                void* out, int B, int n, int reps,
                                int placement, int per_field, int per_cluster,
                                void* stream) {
  if (B < 1 || B > 65535 || n < 1 || reps < 0 ||
      (placement != 0 && placement != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(field);
  const int* c = static_cast<const int*>(cells);
  float* o = static_cast<float*>(out);
  if (placement == 1) {
    const dim3 grid((n + kLThreads - 1) / kLThreads, B);
    gather_l2_kernel<<<grid, kLThreads, 0, s>>>(f, c, o, n, reps, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (per_field < 1 || per_cluster < 1 ||
      (long long)per_field * per_cluster < n ||
      (long long)B * per_field * kGCta > 0x7FFFFFFF)
    return -1;
  const int rc = prepare(gather_cluster_kernel, kGSmem);
  if (rc) return rc;
  gather_cluster_kernel<<<B * per_field * kGCta, kGThreads, kGSmem, s>>>(
      f, c, o, n, reps, 0, per_field, per_cluster);
  return static_cast<int>(cudaGetLastError());
}

// field: [256, 256] f32; cells: [n] int32 (read mod 65536), n a multiple of
// 64; scratch: device bytes for the split field (tools/probes2.py
// ONEHOT_SCRATCH_BYTES[leg]); out: [n] f32; leg 0 bf16x3, 1 tf32; grid: the
// persistent grid's blocks (tools/probes2.py onehot_plan).  Launches the
// split, then the products.
extern "C" int die_probe_onehot(const void* field, const void* cells,
                                void* scratch, void* out, int n, int reps,
                                int leg, int grid, void* stream) {
  if (n < 1 || n % kOhTile || reps < 0 || (leg != 0 && leg != 1) || grid < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(field);
  const int* c = static_cast<const int*>(cells);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  float* o = static_cast<float*>(out);
  return leg == 0 ? launch_onehot<true>(f, c, sc, o, n, reps, grid, s)
                  : launch_onehot<false>(f, c, sc, o, n, reps, grid, s);
}
