// The chem diffusion of one 256x256 f32 field, applied `apps` times, on the
// CUDA cores and on the tensor cores.
//
// die_probe_stencil (P4, stencil leg): y = G(x) * decay with G the separable
//   wrap Gaussian, taps folded from -r to +r, axis 0 and then axis 1: the
//   order of ops/gaussian.py and of K1's phase 7 (lattice_step.cuh); every
//   application performed, each product and sum rounded on its own.  5 or
//   11 taps (sigma 0.5, 1.25), one template instance each.
// die_probe_tc (P4's product legs, P5's product leg): y = (A x A^T) * decay
//   (two-sided) or y = A x + add (one-sided; A the permutation P gives
//   roll(x, 1, 0) + 1), with wgmma on the tensor cores: TF32 inputs
//   (cvt.rna.tf32.f32, the counterpart of the TPU's f32 dot) or bf16 inputs
//   (to nearest even; the counterpart of its bf16 dot, the product between
//   the two sides rounded to bf16 too), f32 accumulation, the decay a
//   separate f32 multiply and the add a separate f32 add; the last product's
//   result leaves the kernel in f32, unrounded.
// Both replace `make_diffuse_kernel` of tools/tpu_mxu_offload.py (the
// pallas_call at :127); the one-sided product replaces the `mxu` leg of
// `make_roll_kernel` (:180).
//
// The stencil keeps the field on chip for all applications, as it stays in
// VMEM on the TPU: a cluster of 2 blocks holds it, 128 rows (128 KB) on each
// beside two sets of halo rows, one block an SM, so 64 fields run at once on
// 128 SMs.  A warp computes a strip of 8 rows in registers, both passes,
// and writes it back in place; the peer's boundary rows arrive by pushes to
// the halo rows and an mbarrier (the note at the stencil section).
//
// The products keep it on chip too, split by columns (the note at the
// tensor-core section): a field's blocks hold 64 or 128 of its columns each,
// K-major in wgmma's swizzled layout, 4 warpgroups a block, warpgroup t
// computing m-tile t with wgmma m64n64.  The matrix is loaded once a block,
// already rounded: bf16, all 256 k of the warpgroup's 64 rows in registers
// (64 a thread); TF32 (256 KB in all, which does not fit beside the field),
// k < 128 in registers and k >= 128 of every row resident in shared memory
// (128 KB).  So a wgmma reads B alone from shared memory (64 bytes a tensor
// cycle), and A too on half of TF32's k-steps (128 bytes, the SM's rate).
// Two-sided, each product's output tiles go to the block that owns them
// next, staged in shared memory and moved by cp.async.bulk across the
// cluster on the destination's mbarrier; one-sided, into the block's own
// buffer, transposed.  A field's blocks are launched at once (B clusters two
// sided).  Every zero block of A and P is multiplied: the dense products are
// the probe.
//
// Bounds: the stencil is 2 (2 ntaps - 1) + 1 fp32 operations a cell an
// application over the CUDA cores' rate (as separate FMUL and FADD under
// --fmad=false: the fp32 lane rate), beside its shared-memory traffic (a
// strip's rows and its halo rows read and the strip written once an
// application) at 128 bytes a clock an SM; a two-sided product is 4 * 256^3
// FLOP an application, a one-sided 2 * 256^3, over the tensor cores' rate
// (495 TFLOP/s TF32, 989 bf16), about 50 times the stencil's arithmetic at
// ntaps = 5.  The stencil is bitwise equal to its plain version; the tensor
// cores' sums follow their own order, so the two-sided legs agree with theirs
// to a tolerance, and the one-sided (one exact product and zeros a sum)
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_push.cuh"

namespace {

constexpr int kN = 256;
constexpr long long kField = (long long)kN * kN;
// ---- tensor cores: wgmma, a field's columns split over its blocks ----------
// Block r of a field's kCl owns kCols of its columns from c0 = kCols r,
// K-major: for each 64 of them a [64][256] sub-buffer whose row n holds a
// column with its 256 k contiguous (TF32 wgmma takes K-major operands only),
// in wgmma's 128-byte swizzle.  A x mixes rows only, so block r computes
// A X[:, its columns] alone, warpgroup t the m64n64 tiles of A's rows 64 t ..
// 64 t + 63.  The right product runs as Z^T = A Y^T, the same form, so one
// routing serves both: output tile (m-tile t, n-tile u) of block r goes to
// the block owning columns 64 t .., d = t / kNt, into sub-buffer t % kNt at
// k c0 + 64 u ..: a straight copy of the accumulator tile, which is the next
// product's K-major operand (Z^T is X' in K-major form).  A tile is written,
// rounded, into a staging slot in the destination's layout and moved by one
// cp.async.bulk into the destination's buffer, counted on its mbarrier (the
// block's own tiles are written in place).
// - bf16, clusters of 2 (128 columns a block; 66 clusters fit the card, so
//   B = 64 runs in one wave): two buffers and two staging sets ping-pong, so
//   a product waits on its mbarrier alone, no cluster barrier.
// - TF32, clusters of 4 (30 fit: B = 64 in three waves): one 64 KB buffer
//   beside A's 128 KB and 2 staging slots.  The buffer's four k-regions are
//   stored rotated by the block's rank (A's columns rotated to match), so
//   its own tile is local region 0.  A product runs region by region, a
//   commit group each, its own region first and each other one after its
//   mbarrier says the tile landed, so the tiles land while the earlier
//   regions' products run.  Then the own tile is written in place, one
//   cluster barrier says every block has read its buffer, and the tiles go
//   to blocks rank + 1, + 2, + 3: the third from slot 0 again once block
//   rank + 1 says (a remote mbarrier arrival) that the first landed.
// One-sided (P x + add, TF32): block r's output stays in block r, stored
// transposed (row i of the output is k of the next round), no cluster.  The
// last product writes `out` from the accumulators.  tools/probes.py tc_plan
// states the layout and routing, and its CPU test composes them.
constexpr int kTcGroups = 4;  // warpgroups a block; t computes m-tile t
constexpr int kTcThreads = 128 * kTcGroups;  // 512
constexpr int kTileN = 64;        // rows and columns of an output tile
constexpr int kSwRow = 128;       // bytes of K in a swizzled row
constexpr int kAtom = 64 * kSwRow;  // 8 KB: a 128-byte row of K of 64 rows
constexpr int kRegSteps = 16;     // k-steps of A in registers: 64 a thread

template <bool BF16>
struct Tc {
  static constexpr int kElem = BF16 ? 2 : 4;             // bytes of an operand
  static constexpr int kStepK = 32 / kElem;              // K of a wgmma: 16, 8
  static constexpr int kSteps = kN / kStepK;             // 16, 32
  static constexpr int kSmemSteps = kSteps - kRegSteps;  // A in smem: 0, 16
  static constexpr int kCl = BF16 ? 2 : 4;  // blocks a field (66, 30 fit)
  static constexpr int kCols = kN / kCl;                 // columns a block
  static constexpr int kNt = kCols / kTileN;             // n-tiles a block
  static constexpr int kTile = kTileN * kTileN * kElem;  // 8 KB, 16 KB
  static constexpr int kSub = kTileN * kN * kElem;       // 32 KB, 64 KB
  static constexpr int kBuf = kNt * kSub;
  static constexpr int kBufs = BF16 ? 2 : 1;             // 2 where they fit
  static constexpr int kRemote = kNt * (kTcGroups - kNt);  // tiles sent away
  static constexpr int kSlots = BF16 ? 2 * kRemote : 2;  // staging tiles
  static constexpr int kATile = kSmemSteps * 32 * 64;    // A in smem an m-tile
  static constexpr int kStage = kBufs * kBuf + kTcGroups * kATile;
  static constexpr int kBars = kStage + kSlots * kTile;  // 5 mbarriers
  static constexpr int kSmem = kBars + 48 + 1024;
};

struct TcParams {
  int apps;
  int two_sided;
  float decay;  // two-sided: y = acc * decay
  float add;    // one-sided: y = acc + add
};

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ uint16_t bf16_bits(float f) {
  const __nv_bfloat16 h = __float2bfloat16_rn(f);
  return *reinterpret_cast<const uint16_t*>(&h);
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | (uint32_t)bf16_bits(hi) << 16;
}

// Byte offset of byte kb of row `row`'s K in a K-major array of 64-row atoms
// with the 128-byte swizzle: 128-byte rows, 64 rows an 8 KB atom, atoms along
// K; the 16-byte chunk q of a row sits at q ^ (row & 7).
__device__ __forceinline__ uint32_t swz(int row, int kb) {
  return (uint32_t)((kb >> 7) * kAtom + row * kSwRow +
                    ((((kb >> 4) & 7) ^ (row & 7)) << 4) + (kb & 15));
}

// the 32-byte K slice of k-step s: 4 slices a 128-byte row, atoms 8 KB apart
__device__ __forceinline__ uint32_t step_offset(int s) {
  return (uint32_t)((s >> 2) * kAtom + (s & 3) * 32);
}

// wgmma's shared-memory descriptor of a K-major operand with the 128-byte
// swizzle, 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void keep_f(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// d (+)= A B on a warpgroup, m64n64: A from registers, B from shared memory
// (d = A B where accumulate is 0)
template <bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  if constexpr (BF16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DIE_D32_LIST
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : DIE_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DIE_D32_LIST
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : DIE_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
}

// d (+)= A B on a warpgroup, m64n64k8 TF32, both operands from shared memory
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DIE_D32_LIST
      "%32, %33, p, 1, 1;\n}\n"
      : DIE_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- moving tiles: mbarriers and bulk copies across the cluster ------------
// one arrival on block `rank`'s mbarrier at `bar`, released to the cluster
__device__ __forceinline__ void bar_arrive_at(uint32_t bar, int rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          map_rank(bar, rank))
      : "memory");
}

// `bytes` of this block's shared memory at `src` to block `rank`'s at the
// same-layout offset `dst`, counted on that block's mbarrier `bar`
__device__ __forceinline__ void bulk_to(int rank, uint32_t dst, uint32_t src,
                                        uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(map_rank(dst, rank)),
      "r"(src), "r"(bytes), "r"(map_rank(bar, rank))
      : "memory");
}

// this thread's generic writes of shared memory made visible to the async
// proxy (wgmma's reads, bulk copies)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the 128 threads of warpgroup wg
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// ---- the products and their epilogues ---------------------------------------
// The k-step of A that local k-step s multiplies: the buffer's four regions
// of 64 k stored rotated by `rot` (region (L + rot) & 3 at local region L).
__device__ __forceinline__ int rotated_step(int s, int steps, int rot) {
  const int per = steps / 4;  // k-steps a region
  return ((s / per + rot) & 3) * per + s % per;
}

// A's local k-steps 0 .. kRegSteps - 1 of the warp's rows m (g) and m + 8
// (g + 8), thread column t: wgmma's register layout, as mma.sync's m16n8k8 /
// m16n8k16 A.  TF32 rounded here (cvt.rna); bf16 A arrives rounded.
template <bool BF16>
__device__ __forceinline__ void load_a(uint32_t (&a)[kRegSteps][4],
                                       const void* A, int m, int t, int rot) {
  if constexpr (BF16) {
    constexpr int kW = kN / 2;  // words (bf16 pairs) of a row
    const uint32_t* r0 = static_cast<const uint32_t*>(A) + m * kW + t;
    const uint32_t* r1 = r0 + 8 * kW;
#pragma unroll
    for (int s = 0; s < kRegSteps; ++s) {
      const int k = 8 * rotated_step(s, Tc<BF16>::kSteps, rot);
      a[s][0] = __ldg(r0 + k);
      a[s][1] = __ldg(r1 + k);
      a[s][2] = __ldg(r0 + k + 4);
      a[s][3] = __ldg(r1 + k + 4);
    }
  } else {
    const float* r0 = static_cast<const float*>(A) + m * kN + t;
    const float* r1 = r0 + 8 * kN;
#pragma unroll
    for (int s = 0; s < kRegSteps; ++s) {
      const int k = 8 * rotated_step(s, Tc<BF16>::kSteps, rot);
      a[s][0] = tf32(__ldg(r0 + k));
      a[s][1] = tf32(__ldg(r1 + k));
      a[s][2] = tf32(__ldg(r0 + k + 4));
      a[s][3] = tf32(__ldg(r1 + k + 4));
    }
  }
}

// d = A[m-tile] . B, B the K-major sub-buffer at `sub`; A's last kSmemSteps
// k-steps from the m-tile's shared-memory tile at `atile`
template <bool BF16>
__device__ __forceinline__ void product(float (&d)[32],
                                        const uint32_t (&a)[kRegSteps][4],
                                        uint32_t sub, uint32_t atile) {
  keep_f(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int s = 0; s < kRegSteps; ++s)
    wgmma_rs<BF16>(d, a[s], desc(sub + step_offset(s)), s);
#pragma unroll
  for (int s = 0; s < Tc<BF16>::kSmemSteps; ++s)
    wgmma_ss_tf32(d, desc(atile + step_offset(s)),
                  desc(sub + step_offset(kRegSteps + s)), 1);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  keep_f(d);
}

// The 8 k-steps of the TF32 buffer's local region L (k 64 L .. 64 L + 63),
// A from registers below local k 128, else from shared memory; the first
// k-step overwrites d where `first`.
template <int L>
__device__ __forceinline__ void region_tf32(float (&d)[32],
                                            const uint32_t (&a)[kRegSteps][4],
                                            uint32_t sub, uint32_t atile) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    constexpr int kS = 8 * L;
    if constexpr (kS < kRegSteps)
      wgmma_rs<false>(d, a[kS + i], desc(sub + step_offset(kS + i)),
                      L > 0 || i > 0);
    else
      wgmma_ss_tf32(d, desc(atile + step_offset(kS - kRegSteps + i)),
                    desc(sub + step_offset(kS + i)), 1);
  }
}

// d = A[m-tile] . B for the TF32 two-sided product, region by region in the
// order the tiles come: local region 0 (the block's own tile), then 3, 2 and
// 1 (the tiles of blocks rank - 1, rank - 2, rank + 1), each, where `wait`,
// after its mbarrier full[L] says the tile landed.  A commit group a region,
// each opened by its own wgmma.fence after the wait, so that a region's
// products run while the next one's tile lands.
template <int L>
__device__ __forceinline__ void region_batch(float (&d)[32],
                                             const uint32_t (&a)[kRegSteps][4],
                                             uint32_t sub, uint32_t atile) {
  keep_f(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  region_tf32<L>(d, a, sub, atile);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  keep_f(d);
}

__device__ __forceinline__ void product_regions(
    float (&d)[32], const uint32_t (&a)[kRegSteps][4], uint32_t sub,
    uint32_t atile, uint32_t full, uint32_t parity, bool wait) {
  region_batch<0>(d, a, sub, atile);
  if (wait) bar_wait(full + 24, (parity >> 3) & 1);
  region_batch<3>(d, a, sub, atile);
  if (wait) bar_wait(full + 16, (parity >> 2) & 1);
  region_batch<2>(d, a, sub, atile);
  if (wait) bar_wait(full + 8, (parity >> 1) & 1);
  region_batch<1>(d, a, sub, atile);
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  keep_f(d);
}

// An operand value into a block's own buffer, rounded as the next product reads
// it: TF32 by cvt.rna, bf16 to nearest even.
template <bool BF16>
__device__ __forceinline__ void put(unsigned char* at, float v) {
  if constexpr (BF16)
    *reinterpret_cast<uint16_t*>(at) = bf16_bits(v);
  else
    *reinterpret_cast<uint32_t*>(at) = tf32(v);
}

// The thread's accumulators (times `scale` where `scaled`), rounded, into a
// tile region laid out as the destination's buffer: accumulator 4 jj + 2 h + o
// of thread (w, g, t) is the tile's row i = 16 w + g + 8 h (the next
// product's n) and column j = 8 jj + 2 t + o (its k).  The offsets are swz(i,
// j * kElem) in closed form, a pair (o = 0, 1) a store.
template <bool BF16>
__device__ __forceinline__ void stage(unsigned char* region,
                                      const float (&d)[32], int w, int g,
                                      int t, bool scaled, float scale) {
  unsigned char* r0 = region + (16 * w + g) * kSwRow;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = d[4 * jj + 2 * h], v1 = d[4 * jj + 2 * h + 1];
      if (scaled) {
        v0 = __fmul_rn(v0, scale);
        v1 = __fmul_rn(v1, scale);
      }
      if constexpr (BF16) {
        *reinterpret_cast<uint32_t*>(r0 + 1024 * h + ((jj ^ g) << 4) +
                                     4 * t) = bf2(v0, v1);
      } else {
        const int c = (2 * (jj & 3)) ^ (t >> 1) ^ g;
        *reinterpret_cast<uint2*>(r0 + (jj >> 2) * kAtom + 1024 * h +
                                  (c << 4) + 8 * (t & 1)) =
            make_uint2(tf32(v0), tf32(v1));
      }
    }
}

// One-sided (TF32): the accumulators plus `add`, rounded, into the block's own
// buffer transposed: row j, k 64 wg + i; swz(j, 4 (64 wg + i)) in closed form.
__device__ __forceinline__ void store_transposed(unsigned char* buf,
                                                 const float (&d)[32], int wg,
                                                 int w, int g, int t,
                                                 float add) {
  const int q = ((4 * w) & 7) + (g >> 2);
  unsigned char* b0 =
      buf + (2 * wg + (w >> 1)) * kAtom + 2 * t * kSwRow + 4 * (g & 3);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 2; ++o)
        *reinterpret_cast<uint32_t*>(b0 + (8 * jj + o) * kSwRow +
                                     (((q + 2 * h) ^ (2 * t + o)) << 4)) =
            tf32(__fadd_rn(d[4 * jj + 2 * h + o], add));
}

template <bool BF16>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const float* __restrict__ x, float* __restrict__ out,
          const void* __restrict__ A, const TcParams p) {
  using T = Tc<BF16>;
  extern __shared__ __align__(16) unsigned char raw[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % T::kCl;  // the cluster rank two-sided
  const long long env = blockIdx.x / T::kCl;
  const float* xe = x + env * kField;
  float* oe = out + env * kField;
  const int c0 = rank * T::kCols;  // the block's first column
  if (p.apps == 0) {
    for (int e = tid; e < kN * T::kCols; e += kTcThreads) {
      const int at = (e / T::kCols) * kN + c0 + e % T::kCols;
      oe[at] = xe[at];
    }
    return;
  }
  const bool cluster = p.two_sided != 0;
  const uint32_t sbase = smem_addr(raw);
  const uint32_t base = (sbase + 1023u) & ~1023u;  // swizzle atoms
  unsigned char* sm = raw + (base - sbase);
  const uint32_t atile = base + T::kBufs * T::kBuf + wg * T::kATile;
  // bf16: [b], the tiles sent to buffer b landed; TF32: [L], the tile for
  // local region L landed, and [4], this block's first tile sent landed
  const uint32_t bars = base + T::kBars;
  if (tid == 0) {
    for (int b = 0; b < 5; ++b) bar_init(bars + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // TF32 two-sided: k-region s of the buffer at local region (s - rank) & 3,
  // so that its own tile is local region 0 (A's columns rotated to match)
  const int rot = !BF16 && cluster ? rank : 0;
  uint32_t a[kRegSteps][4];
  load_a<BF16>(a, A, 64 * wg + 16 * w + g, t, rot);
  if constexpr (T::kSmemSteps > 0) {  // the rest of A's k, every row, TF32
    constexpr int kK = T::kSmemSteps * T::kStepK, k0 = kN - kK;
    const float* Af = static_cast<const float*>(A);
    for (int e = tid; e < kN * kK; e += kTcThreads) {
      const int row = e / kK, k = e % kK;
      const int ka = 8 * rotated_step(k0 / 8 + k / 8, T::kSteps, rot) + k % 8;
      *reinterpret_cast<uint32_t*>(
          sm + T::kBufs * T::kBuf + (row >> 6) * T::kATile +
          swz(row & 63, k * 4)) = tf32(__ldg(Af + row * kN + ka));
    }
  }
  // the block's columns, K-major: row n of the buffer is column c0 + n
  for (int e = tid; e < kN * T::kCols; e += kTcThreads) {
    const int k = e / T::kCols, n = e % T::kCols;
    const int kl = (((k >> 6) - rot) & 3) * 64 + (k & 63);  // local k
    put<BF16>(sm + (n >> 6) * T::kSub + swz(n & 63, kl * T::kElem),
              xe[k * kN + c0 + n]);
  }
  fence_async();
  if (cluster)
    cluster_sync();  // every buffer and mbarrier of the cluster ready
  else
    __syncthreads();

  const int sides = cluster ? 2 : 1;
  const int m0 = 64 * wg;        // the warpgroup's m-tile
  const int dest = wg / T::kNt;  // the block that owns columns m0 .. next
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  int cur = 0;
  uint32_t phase = 0;  // bit b: the parity of mbarrier b's next phase
  bool local = true;   // TF32: every region of the buffer written here
#pragma unroll 1
  for (int app = 0, q = 0; app < p.apps; ++app) {
#pragma unroll 1
    for (int side = 0; side < sides; ++side, ++q) {
      const bool last = app == p.apps - 1 && side == sides - 1;
      const bool scaled = side == 1;
      const int nxt = T::kBufs == 2 ? cur ^ 1 : cur;
      const uint32_t src = base + cur * T::kBuf;
      if (last) {  // the accumulators to `out`
#pragma unroll 1
        for (int u = 0; u < T::kNt; ++u) {
          if constexpr (!BF16) {
            if (cluster)
              product_regions(d, a, src, atile, bars, phase, !local);
            else
              product<BF16>(d, a, src, atile);
          } else {
            product<BF16>(d, a, src + u * T::kSub, atile);
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int o = 0; o < 2; ++o) {
                const int i = 16 * w + g + 8 * h;
                const int j = c0 + 64 * u + 8 * jj + 2 * t + o;
                const float v = d[4 * jj + 2 * h + o];
                if (cluster)  // Z^T[m0 + i][j] = out[j][m0 + i]
                  oe[j * kN + m0 + i] = __fmul_rn(v, p.decay);
                else
                  oe[(m0 + i) * kN + j] = __fadd_rn(v, p.add);
              }
        }
        break;
      }
      if (!cluster) {  // one-sided (TF32 only): into this block's buffer
        if constexpr (!BF16) {
          product<BF16>(d, a, src, atile);
          __syncthreads();  // every read of the buffer is done
          store_transposed(sm + nxt * T::kBuf, d, wg, w, g, t, p.add);
          fence_async();
          __syncthreads();
          cur = nxt;
        }
        continue;
      }
      if constexpr (T::kBufs == 2) {
        const uint32_t bar = bars + 8 * nxt;
        // tiles of product q land in buffer nxt: the peers finished reading
        // it before they sent the tiles of product q - 1, which this block
        // waited for; staging set q & 1 was last read by the copies of
        // product q - 2, all landed before any tile of q - 1 was sent
#pragma unroll 1
        for (int u = 0; u < T::kNt; ++u) {
          product<BF16>(d, a, src + u * T::kSub, atile);
          const uint32_t at = nxt * T::kBuf + (wg % T::kNt) * T::kSub +
                              (T::kNt * rank + u) * T::kTile;
          if (dest == rank) {  // the block's own tile, in place
            stage<BF16>(sm + at, d, w, g, t, scaled, p.decay);
          } else {
            const int rt = wg < T::kNt * rank ? wg : wg - T::kNt;
            const uint32_t slot =
                T::kStage +
                ((q & 1) * T::kRemote + rt * T::kNt + u) * T::kTile;
            stage<BF16>(sm + slot, d, w, g, t, scaled, p.decay);
            fence_async();
            group_sync(wg);
            if ((tid & 127) == 0)
              bulk_to(dest, base + at, base + slot, T::kTile, bar);
          }
        }
        fence_async();
        if (tid == 0) bar_expect(bar, T::kRemote * T::kTile);
        bar_wait(bar, (phase >> nxt) & 1);
        phase ^= 1u << nxt;
        __syncthreads();  // the own tiles' writes are seen too
      } else {
        // one buffer: the own tile is written in place (local region 0)
        // and the cluster barrier says every block has read its buffer; then
        // each block's tiles go to blocks rank + 1, + 2, + 3 (pos 0, 1, 2),
        // into their local region (rank - dest) & 3, through 2 staging
        // slots, the third after block rank + 1 says the first landed
        product_regions(d, a, src, atile, bars, phase, !local);
        if (!local) phase ^= 0xEu;
        local = false;
        __syncthreads();  // this block's reads of its buffer are done
        if (wg == rank) {
          stage<BF16>(sm, d, w, g, t, scaled, p.decay);
          fence_async();
        }
        cluster_sync();
        if (tid == 0)
          for (int r = 1; r < 4; ++r) bar_expect(bars + 8 * r, T::kTile);
        if (wg != rank) {
          const int pos = (wg - rank - 1) & 3, at = (rank - wg) & 3;
          const uint32_t slot = T::kStage + (pos & 1) * T::kTile;
          if (pos == 2) bar_wait(bars + 32, (phase >> 4) & 1);
          stage<BF16>(sm + slot, d, w, g, t, scaled, p.decay);
          fence_async();
          group_sync(wg);
          if ((tid & 127) == 0)
            bulk_to(wg, base + at * T::kTile, base + slot, T::kTile,
                    bars + 8 * at);
        } else {  // block rank - 1's tile, sent from its slot 0, landed here
          bar_wait(bars + 24, (phase >> 3) & 1);
          if ((tid & 127) == 0) bar_arrive_at(bars + 32, (rank - 1) & 3);
        }
        phase ^= 1u << 4;
      }
      cur = nxt;
    }
  }
  if (cluster) cluster_sync();  // no copy out of this block is in flight
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---- stencil: a field on a cluster of 2 blocks, 128 rows each ----------------
// tools/probes.py stencil_plan states this geometry (its CPU test walks it).
// Warp w of a block owns the strip of kStStrip rows v0 = kStStrip w ..
// v0 + kStStrip - 1 in both passes, lane l the columns kStCols l .. kStCols l
// + kStCols - 1 of each of them.  An application:
// - axis 0: the lane streams rows v0 - R .. v0 + kStStrip - 1 + R of its
//   columns from shared memory, two 16-byte loads a row, and adds each row to
//   the outputs whose taps reach it, in tap order (an output's k-th term is
//   its k-th row); rows outside the block come from the block's halo rows
//   (warp 0 above, the last warp below);
// - axis 1: in registers.  A row's R left and R right neighbours come from
//   lanes l - 1 and l + 1 by __shfl_sync, which wraps the torus row at lane
//   31;
// - the outputs times decay stay in registers across a block barrier (every
//   strip has read the field), are written back in place, and a second
//   barrier closes the application.  The last application writes `out`.
// The halo: block b's R rows above (global rows g0 - R .. g0 - 1, on the
// torus) and below (g0 + 128 .. g0 + 127 + R) are its peer's last and first
// R rows.  The peer's last warp and warp 0 push them, as soon as they hold
// them, into this block's halo buffer of the next application's parity (two
// ping-pong) by st.async, whose bytes complete on this block's mbarrier of
// that buffer (a release at cluster scope, with no fence: an arrive.release
// at cluster scope is a MEMBAR.GPU); warps 0 and the last wait on it
// (acquire) before they read the halo, and then expect the buffer's bytes
// of its next use.  A warp pushes into a buffer only after it has waited for
// the push its partner made after reading that buffer, so no cluster
// barrier runs between applications.
// A row's 16-byte chunks q are stored at q ^ ((q >> 3) & 1), so that a warp's
// 16-byte loads and stores at 32-byte lane strides meet every bank once in
// each quarter-warp.
// The radius R is a template parameter: the tap loops unroll, each tap is a
// constant-bank operand of its FMUL, and nothing lives in local memory.
constexpr int kStCl = 2;                      // blocks a field (a cluster)
constexpr int kStRows = kN / kStCl;           // 128 rows a block
constexpr int kStStrip = 8;                   // rows a warp
constexpr int kStCols = 8;                    // columns a lane
constexpr int kStWarps = kStRows / kStStrip;  // 16
constexpr int kStThreads = 32 * kStWarps;     // 512
constexpr int kStMaxTaps = 15;

template <int R>
struct St {
  static constexpr int kTaps = 2 * R + 1;
  static constexpr int kHalo = R * kN;                          // one side
  static constexpr int kBars = (kStRows * kN + 4 * kHalo) * 4;  // bytes
  static constexpr int kSmem = kBars + 4 * 8;  // 4 mbarriers
};

struct StencilParams {
  float taps[kStMaxTaps];
  int apps;
  float decay;
};

__device__ __forceinline__ int st_chunk(int q) { return q ^ ((q >> 3) & 1); }

__device__ __forceinline__ float4 st_scale(float t, float4 v) {
  return make_float4(t * v.x, t * v.y, t * v.z, t * v.w);
}

__device__ __forceinline__ float4 st_add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// rows I0 .. I0 + R - 1 of the strip's outputs into the peer's halo rows at
// `dst`, counted on the peer's mbarrier `bar` (shared::cluster addresses),
// the lane's two chunks of each
template <int R, int I0>
__device__ __forceinline__ void st_push(const float (&z)[kStStrip][kStCols],
                                        uint32_t dst, uint32_t bar, int c0,
                                        int c1) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float* v = z[I0 + k];
    st_async4(dst + (k * kN + c0) * 4, bar, v[0], v[1], v[2], v[3]);
    st_async4(dst + (k * kN + c1) * 4, bar, v[4], v[5], v[6], v[7]);
  }
}

template <int R>
__global__ void __launch_bounds__(kStThreads, 1)
stencil_kernel(const float* __restrict__ x, float* __restrict__ out,
               const StencilParams p) {
  using S = St<R>;
  extern __shared__ __align__(16) float sm[];
  // [kStRows][kN] own rows at 0; halo [parity][above, below][R][kN] after
  constexpr int kHaloAt = kStRows * kN;
  const uint32_t bars = smem_addr(sm) + S::kBars;  // [parity][above, below]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int peer = (int)rank ^ 1, g0 = (int)rank * kStRows;
  const long long env = blockIdx.x / kStCl;
  const float* xe = x + env * kField;
  if (p.apps == 0) {  // y = x
    for (int e = tid; e < kStRows * kN / 4; e += kStThreads)
      reinterpret_cast<float4*>(out + env * kField + (long long)g0 * kN)[e] =
          __ldg(reinterpret_cast<const float4*>(xe + (long long)g0 * kN) + e);
    return;
  }
  // the block's rows and the first application's halo rows, from x
  for (int e = tid; e < (kStRows + 2 * R) * (kN / 4); e += kStThreads) {
    const int r = e / (kN / 4), q = e % (kN / 4), h = r - kStRows;
    const int g = r < kStRows ? g0 + r
                  : h < R     ? g0 - R + h
                              : g0 + kStRows + h - R;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
                               xe + (long long)(g & (kN - 1)) * kN) + q);
    *reinterpret_cast<float4*>(sm + r * kN + 4 * st_chunk(q)) = v;
  }
  if (tid < 4) {  // a halo slot's phase: one local arrival and its bytes
    bar_init(bars + 8 * tid);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_expect(bars + 8 * tid, S::kHalo * 4);  // the slot's first use
  }
  cluster_sync();  // both blocks' mbarriers exist before the first push

  const int v0 = warp * kStStrip;
  const int c0 = 4 * st_chunk(2 * lane), c1 = 4 * st_chunk(2 * lane + 1);
  const bool top = warp == 0, bottom = warp == kStWarps - 1;
  float* own = sm + v0 * kN;
  float z[kStStrip][kStCols];
#pragma unroll 1
  for (int a = 0; a < p.apps; ++a) {
    const int par = a & 1;
    const float* above =
        sm + (top ? kHaloAt + 2 * par * S::kHalo : (v0 - R) * kN);
    const float* below = sm + (bottom ? kHaloAt + (2 * par + 1) * S::kHalo
                                      : (v0 + kStStrip) * kN);
    if (a > 0 && (top || bottom)) {  // the peer's push for this application
      const uint32_t bar = bars + 8 * (2 * par + (top ? 0 : 1));
      bar_wait_cluster(bar, ((a - 1) >> 1) & 1);
      __syncwarp();
      if (lane == 0) bar_expect(bar, S::kHalo * 4);  // its next use, a + 2
    }
    // axis 0: output row v0 + i takes row v0 - R + m as its tap m - i
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h ? c1 : c0;
      float4 acc[kStStrip];
#pragma unroll
      for (int m = 0; m < kStStrip + 2 * R; ++m) {
        const float* row = m < R              ? above + m * kN
                           : m < R + kStStrip ? own + (m - R) * kN
                                              : below + (m - R - kStStrip) * kN;
        const float4 v = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
        for (int i = 0; i < kStStrip; ++i) {
          const int k = m - i;
          if (k < 0 || k >= S::kTaps) continue;
          acc[i] = k == 0 ? st_scale(p.taps[0], v)
                          : st_add(acc[i], st_scale(p.taps[k], v));
        }
      }
#pragma unroll
      for (int i = 0; i < kStStrip; ++i) {
        z[i][4 * h] = acc[i].x;
        z[i][4 * h + 1] = acc[i].y;
        z[i][4 * h + 2] = acc[i].z;
        z[i][4 * h + 3] = acc[i].w;
      }
    }
    // axis 1: column kStCols l + j takes w[j + k] as its tap k
#pragma unroll
    for (int i = 0; i < kStStrip; ++i) {
      float w[kStCols + 2 * R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        w[j] = __shfl_sync(~0u, z[i][kStCols - R + j], (lane + 31) & 31);
        w[R + kStCols + j] = __shfl_sync(~0u, z[i][j], (lane + 1) & 31);
      }
#pragma unroll
      for (int j = 0; j < kStCols; ++j) w[R + j] = z[i][j];
#pragma unroll
      for (int j = 0; j < kStCols; ++j) {
        float acc = p.taps[0] * w[j];
#pragma unroll
        for (int k = 1; k < S::kTaps; ++k) acc = acc + p.taps[k] * w[j + k];
        z[i][j] = acc * p.decay;
      }
    }
    if (a + 1 == p.apps) {
      float* oe = out + env * kField + (long long)(g0 + v0) * kN;
#pragma unroll
      for (int i = 0; i < kStStrip; ++i) {
        float* o = oe + i * kN + kStCols * lane;
        *reinterpret_cast<float4*>(o) =
            make_float4(z[i][0], z[i][1], z[i][2], z[i][3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(z[i][4], z[i][5], z[i][6], z[i][7]);
      }
      break;
    }
    // the next application's halo rows to the peer: warp 0 its first R rows
    // (the peer's rows below), the last warp its last R (the peer's above)
    if (top || bottom) {
      const int side = top ? 1 : 0, slot = 2 * (par ^ 1) + side;
      const uint32_t dst =
          map_rank(smem_addr(sm + kHaloAt + slot * S::kHalo), peer);
      const uint32_t bar = map_rank(bars + 8 * slot, peer);
      if (top)
        st_push<R, 0>(z, dst, bar, c0, c1);
      else
        st_push<R, kStStrip - R>(z, dst, bar, c0, c1);
    }
    __syncthreads();  // every strip has read the field
#pragma unroll
    for (int i = 0; i < kStStrip; ++i) {
      *reinterpret_cast<float4*>(own + i * kN + c0) =
          make_float4(z[i][0], z[i][1], z[i][2], z[i][3]);
      *reinterpret_cast<float4*>(own + i * kN + c1) =
          make_float4(z[i][4], z[i][5], z[i][6], z[i][7]);
    }
    __syncthreads();  // the field is written before the next application
  }
}

template <int R>
cudaLaunchConfig_t stencil_config(int B, cudaLaunchAttribute* attr,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kStCl);
  cfg.blockDim = dim3(kStThreads);
  cfg.dynamicSmemBytes = St<R>::kSmem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kStCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R>
int launch_stencil(const float* x, float* o, int B, const StencilParams& p,
                   cudaStream_t s) {
  const int rc = prepare(stencil_kernel<R>, St<R>::kSmem);
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = stencil_config<R>(B, attr, s);
  const int lrc = (int)cudaLaunchKernelEx(&cfg, stencil_kernel<R>, x, o, p);
  if (lrc) return lrc;
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int stencil_clusters() {
  int n = 0, rc = prepare(stencil_kernel<R>, St<R>::kSmem);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = stencil_config<R>(64, attr, nullptr);
  if (!rc) rc = (int)cudaOccupancyMaxActiveClusters(&n, stencil_kernel<R>, &cfg);
  return rc ? -rc : n;
}

template <bool BF16>
int launch_tc(const float* x, float* o, const void* A, int B, int cluster,
              const TcParams& p, cudaStream_t s) {
  constexpr int kSmem = Tc<BF16>::kSmem;
  const int rc = prepare(tc_kernel<BF16>, kSmem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Tc<BF16>::kCl);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const int lrc = (int)cudaLaunchKernelEx(&cfg, tc_kernel<BF16>, x, o, A, p);
  if (lrc) return lrc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [B, 256, 256] f32 on the device; taps: host array of ntaps f32,
// ntaps 5 or 11 (the probe's two sigmas; any other count is refused).
// Returns the CUDA error of the launch (0 = ok, -1 = arguments out of range).
extern "C" int die_probe_stencil(const void* x, void* out, int B, int apps,
                                 const float* taps, int ntaps, float decay,
                                 void* stream) {
  if (B < 1 || B > 65535 || apps < 0 || (ntaps != 5 && ntaps != 11))
    return -1;
  StencilParams p;
  for (int k = 0; k < kStMaxTaps; ++k) p.taps[k] = k < ntaps ? taps[k] : 0.0f;
  p.apps = apps;
  p.decay = decay;
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ntaps == 5 ? launch_stencil<2>(xi, o, B, p, s)
                    : launch_stencil<5>(xi, o, B, p, s);
}

// How many clusters of die_probe_stencil's launch for ntaps fit the card at
// once (cudaOccupancyMaxActiveClusters), which sets the waves of B fields;
// -(CUDA error) on a failure, -1 for a count it refuses.
extern "C" int die_probe_stencil_clusters(int ntaps) {
  if (ntaps != 5 && ntaps != 11) return -1;
  return ntaps == 5 ? stencil_clusters<2>() : stencil_clusters<5>();
}

// A: [256, 256] on the device, f32 (tf32 leg) or bf16 (bf16 != 0); cluster:
// the blocks of a field launched as one cluster as tools/probes.py tc_plan
// states it, all of them two-sided (its tiles cross the cluster), 1
// one-sided (TF32 only); any other value is refused, so that a launch cannot
// run a layout other than the one the plan's CPU test composes.
extern "C" int die_probe_tc(const void* x, void* out, const void* A, int B,
                            int apps, int bf16, int two_sided, float decay,
                            float add, int cluster, void* stream) {
  if (B < 1 || B > 65535 || apps < 0 ||
      (two_sided ? cluster != (bf16 ? Tc<true>::kCl : Tc<false>::kCl)
                 : bf16 || cluster != 1))
    return -1;
  const TcParams p{apps, two_sided, decay, add};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  return bf16 ? launch_tc<true>(xi, o, A, B, cluster, p, s)
              : launch_tc<false>(xi, o, A, B, cluster, p, s);
}
