// tree_sum_2d: the order-pinned fp32 reward fold, one sum per env of an
// f32 [B, W, H] field (W and H powers of two).
//
// Replaces the reward reduction inside die_tpu/fast/pallas_step.py::
// _multi_step_kernel (fast/env.py::tree_sum_2d on the kernel's gain field).
// Plain twin: die_tpu_torch/fast/env.py::tree_sum_2d; the two agree bit for
// bit.  The pairing is the reference's: fold rows first (at each level row
// i pairs with row i + n/2, for every column), then fold the columns the
// same way.  A band-, tile- or warp-order sum would round differently.
//
// Bound on an H100: bytes.  The kernel reads the field once (4 bytes a
// cell) and does one add a cell.
//
// Design: two kernels.  k_fold_rows runs one block per (env, chunk of CC
// columns): it loads all W rows of its chunk into shared memory (coalesced
// rows of CC floats), folds the rows in place with the stride-halving tree
// (one __syncthreads per level) and writes the chunk's column sums to a
// [B, H] scratch row.  k_fold_cols then folds each env's H column sums the
// same way in one block.  Splitting the columns over blocks keeps enough
// blocks in flight to cover the loads' latency.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void k_fold_rows(const float* __restrict__ x,
                            float* __restrict__ colsum, int W, int H, int CC) {
  extern __shared__ float tile[];  // [W][CC]
  const int chunks = H / CC;
  const int b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - b * chunks) * CC;
  const float* f = x + (long long)b * W * H;
  for (int e = threadIdx.x; e < W * CC; e += blockDim.x) {
    const int r = e / CC, cc = e - r * CC;
    tile[e] = f[(long long)r * H + c0 + cc];
  }
  __syncthreads();
  for (int n = W / 2; n >= 1; n >>= 1) {
    for (int e = threadIdx.x; e < n * CC; e += blockDim.x)
      tile[e] = tile[e] + tile[e + n * CC];
    __syncthreads();
  }
  for (int cc = threadIdx.x; cc < CC; cc += blockDim.x)
    colsum[(long long)b * H + c0 + cc] = tile[cc];
}

__global__ void k_fold_cols(const float* __restrict__ colsum,
                            float* __restrict__ out, int H) {
  extern __shared__ float cs[];  // [H]
  const float* c = colsum + (long long)blockIdx.x * H;
  for (int e = threadIdx.x; e < H; e += blockDim.x) cs[e] = c[e];
  __syncthreads();
  for (int n = H / 2; n >= 1; n >>= 1) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) cs[e] = cs[e] + cs[e + n];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = cs[0];
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// x: f32 [B, W, H] contiguous; colsum: f32 [B, H] scratch; out: f32 [B].
// Returns a cudaError_t.
extern "C" int die_tree_sum_2d(const float* x, float* colsum, float* out,
                               int B, int W, int H, void* stream) {
  if (B < 1 || W < 1 || H < 1 || (W & (W - 1)) || (H & (H - 1)) ||
      (size_t)W * sizeof(float) > 200 * 1024 ||
      (size_t)H * sizeof(float) > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  int cc = 8192 / W;
  if (cc < 1) cc = 1;
  if (cc > 32) cc = 32;
  if (cc > H) cc = H;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t rows_smem = (size_t)W * cc * sizeof(float);
  const size_t cols_smem = (size_t)H * sizeof(float);
  cudaError_t e = allow_smem((const void*)k_fold_rows, rows_smem);
  if (e == cudaSuccess) e = allow_smem((const void*)k_fold_cols, cols_smem);
  if (e != cudaSuccess) return (int)e;
  k_fold_rows<<<(unsigned)(B * (H / cc)), kThreads, rows_smem, st>>>(
      x, colsum, W, H, cc);
  k_fold_cols<<<(unsigned)B, kThreads, cols_smem, st>>>(colsum, out, H);
  return (int)cudaGetLastError();
}
