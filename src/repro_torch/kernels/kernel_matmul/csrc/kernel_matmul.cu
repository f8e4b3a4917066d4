// Fused kernel-matrix matmul for Hopper (sm_90a):
//
//     out = (K(X1, X2) + sigma2 * [row_offset + i == j]) @ M
//
// for prescaled inputs X1 (rows, d), X2 (cols, d), a right-hand side M of
// shape (cols, t) or (batch, cols, t), and a stationary kernel K (rbf,
// matern12/32/52).  K is never written to device memory.
//
// Replaces the TPU kernel kernel_matmul_pallas
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:298), bodies
// _kernel_matmul_kernel (:166, 2-D M) and _kernel_matmul_batched_kernel
// (:199, 3-D M, here the blockIdx.z axis).  There a grid step forms a
// kernel tile in VMEM and feeds it to the MXU.  Same arithmetic as its
// _apply_stationary / _masked_kernel_tile helpers: d2 = |x|^2 + |x'|^2 -
// 2<x, x'> clamped at 0, a sqrt floor of 1e-20 for the Matern family, the
// sigma2 diagonal at global row == global column, and kernel-tile columns
// and M rows >= cols zeroed before they reach the accumulator.
//
// What bounds it on an H100: operations.  Per call it forms rows * cols
// kernel entries (2d + 1 f32 flops and one exp each, on the CUDA cores and
// the SFU) and multiplies them into M (2 * rows * cols * t * batch flops).
// At n = 40,000, d = 8 the tile is 2.7e10 flops and 1.6e9 exps; the
// product is 2.9e10 flops at t = 9 and 8.2e11 at t = 256.  The product
// belongs on the tensor cores, at f32 accuracy: each factor is split into
// two TF32 halves, a = a_hi + a_lo, and a b ~ a_lo b_hi + a_hi b_lo +
// a_hi b_hi (3xTF32; a_lo b_lo is below f32 rounding).  The kernel entries
// split by rounding (a_hi = cvt.rna.tf32(a), a_lo = cvt.rna.tf32(a -
// a_hi)), M by truncation (one AND each: M is split at every fragment
// load; both leave less than 2^-21 of the factor).  One-pass TF32 keeps
// about three decimal digits, far outside the 2e-4 the kernel is held to.
// The design:
//
//   * one block of 8 warps owns 64 output rows and up to 256 output
//     columns; warps 0-3 and 4-7 take the first and the second 32 columns
//     of every 64-column step, each warp 16 rows, so every kernel entry,
//     exp included, is computed once for every column of M (64 x 256 f32
//     accumulators per warp set, 128 registers a thread); the two halves
//     meet once, through shared memory, at the end.  Only t > 256 adds a
//     grid axis of 256-column blocks; t <= 16 runs 16 columns (two n8
//     tiles), three blocks an SM;
//   * the product is mma.sync m16n8k8 tf32, three per k-step and n8 tile,
//     4 tiles' chains interleaved; each thread computes its kernel entries
//     directly in the A fragment's layout (rows g and g + 8 of its warp's
//     16, columns c and c + 4 of the k-step), so the tile never goes to
//     shared memory.  wgmma m64nNk8 tf32 (A from registers, M split into
//     K-major core matrices in shared memory) was built and measured
//     slower at every width: its 128 + 128 accumulator registers (see the
//     next point) left one block of 8 warps an SM and 128 columns a block,
//     so the tile was formed twice at t = 256 (PERF.md section 6);
//   * the tensor cores add into their f32 accumulator by truncation, not
//     by rounding, and one chain over 40,000 columns drifted far outside
//     the tolerance.  So each step's 12 mma of a tile go into a zeroed
//     fragment that is then added to the accumulator in IEEE f32;
//   * the distance stays on the CUDA cores in f32: |x|^2, |x'|^2 and
//     <x, x'> are the same sequential fmaf chain over the features, so
//     coincident points give d2 = 0 exactly (Matern-1/2 at its diagonal);
//     the 8 lanes that share a column share its norm by shuffles;
//   * the X2 / M tiles of 64 columns stream through a ring of 2-4 stages
//     with cp.async (16-byte copies of X2 rows when d = 8 and of M rows
//     when t is a multiple of 4, 8-byte when it is even; rows past cols
//     zero-filled), so the next tiles load while this one is multiplied;
//   * nothing is carried between blocks: no atomics, and each output is
//     written once by one thread.
//
// The tile loop and its helpers live in tf32_tile.cuh (tile_kernel), which
// B3 and the gradient kernel share; this kernel's stores, its epilogue, in
// epilogues.cuh, which the bf16 kernels share.  The launch goes on the caller's stream and the entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "epilogues.cuh"  // the end: the two k-halves meet, the stores
#include "tf32_tile.cuh"  // the tile loop and its helpers

namespace {

// At 16 columns three blocks fit an SM's registers without spills.
template <int KT, int TB, bool D8>
__global__ void __launch_bounds__(NT, TB == 16 ? 3 : 1) kernel_matmul_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2, const float* __restrict__ M,
    const float* __restrict__ scal, float* __restrict__ out, int rows, int cols, int d, int t,
    int row_offset, int flags) {
  constexpr int NCH = TB / 8;
  tile_kernel<KT, TB, D8>(
      X1, X2, M, scal, out, rows, cols, d, t, row_offset, flags,
      [&](float (&acc)[NCH][4], float* red, int kh, int ra, int c, int nch, int i0, int t0,
          long long, float* out) {
        store_product<TB>(acc, red, kh, ra, c, nch, i0, t0, out, rows, t);
      });
}

template <int TB, bool D8>
cudaError_t launch_tb(int kernel_type, int d, dim3 grid, cudaStream_t stream, const float* X1,
                      const float* X2, const float* M, const float* scal, float* out, int rows,
                      int cols, int t, int row_offset, int flags) {
  auto kern = kernel_matmul_kernel<MATERN52, TB, D8>;
  switch (kernel_type) {
    case RBF: kern = kernel_matmul_kernel<RBF, TB, D8>; break;
    case MATERN12: kern = kernel_matmul_kernel<MATERN12, TB, D8>; break;
    case MATERN32: kern = kernel_matmul_kernel<MATERN32, TB, D8>; break;
    default: break;
  }
  const size_t smem = smem_bytes(TB, d, D8);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(X1, X2, M, scal, out, rows, cols, d, t, row_offset, flags);
  return cudaGetLastError();
}

template <bool D8>
cudaError_t launch(int tb, int kernel_type, int d, dim3 grid, cudaStream_t stream,
                   const float* X1, const float* X2, const float* M, const float* scal,
                   float* out, int rows, int cols, int t, int row_offset, int flags) {
  switch (tb) {
    case 16: return launch_tb<16, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, out, rows, cols, t, row_offset, flags);
    case 32: return launch_tb<32, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, out, rows, cols, t, row_offset, flags);
    case 64: return launch_tb<64, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, out, rows, cols, t, row_offset, flags);
    case 128: return launch_tb<128, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, out, rows, cols, t, row_offset, flags);
    default: return launch_tb<256, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, out, rows, cols, t, row_offset, flags);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays; M and out are (batch, cols, t) and
// (batch, rows, t); scal holds [outputscale, sigma2] on the device, so the
// caller never syncs to read a scalar.  Returns cudaGetLastError() after
// the launch (0 = ok), or cudaErrorInvalidValue for arguments the kernel
// does not take (d past what shared memory holds, ~160).
extern "C" int kernel_matmul_f32(const float* X1, const float* X2,
                                 const float* M, const float* scal,
                                 float* out, int rows, int cols, int d,
                                 int t, int batch, int row_offset,
                                 int kernel_type, void* stream) {
  if (rows <= 0 || cols < 0 || d <= 0 || t <= 0 || batch <= 0 ||
      batch > 65535 || kernel_type < RBF || kernel_type > MATERN52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool d8 = d <= 8;
  // the narrowest column block that holds t (at most 256), halved while
  // its shared memory does not fit (large d)
  const int tb = column_block(d, t, 256);
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + BN - 1) / BN, (t + tb - 1) / tb, batch);
  const int flags = staging_flags(X2, M, d, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d8 ? launch<true>(tb, kernel_type, d, grid, s, X1, X2, M, scal, out, rows, cols, t, row_offset, flags)
         : launch<false>(tb, kernel_type, d, grid, s, X1, X2, M, scal, out, rows, cols, t, row_offset, flags);
  return static_cast<int>(err);
}
