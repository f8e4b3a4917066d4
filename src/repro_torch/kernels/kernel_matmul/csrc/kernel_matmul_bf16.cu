// The kernel-matrix matmul with bf16 operands for Hopper (sm_90a), the
// precision="mixed" mode of kernel_matmul.cu:
//
//     out = (K(X1, X2) + sigma2 * [row_offset + i == j]) @ M
//
// with each kernel entry formed in f32 and rounded to bf16, M rounded to
// bf16, and their product summed in f32.  X1 (rows, d) and X2 (cols, d) are
// prescaled (under the mixed policy their values are already bf16-rounded;
// the kernel reads them as f32, as the f32 kernel does); M comes as a bf16
// copy of shape (batch, cols, tp), rows padded to tp, a multiple of 8.
//
// Replaces the TPU kernel kernel_matmul_pallas with compute_dtype="bfloat16"
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:298), bodies
// _kernel_matmul_kernel (:166, 2-D M) and _kernel_matmul_batched_kernel
// (:199, 3-D M, here the blockIdx.z axis); the stages _masked_kernel_tile
// (:119) and _tile_rhs_product (:154).  There the distance's inner product
// and the tile x M product take bf16 operands on the MXU; here the distance
// stays an f32 fmaf chain (the operands are bf16-rounded values, whose
// products f32 holds exactly), so coincident points keep d2 = 0 exactly.
//
// What bounds it on an H100: operations.  The kernel entries are the f32
// kernel's (2d + 1 f32 flops and one exp each on the CUDA cores and the SFU);
// the product is one bf16 product, 2 * rows * cols * t * batch flops at
// 989 TFLOP/s, where the f32 kernel runs three TF32 products at 495.  At
// t = 9 the entries are the limit either way; at t = 256 the product's
// tensor-core instructions fall six-fold (one m16n8k16 per k16 step and n8
// tile against three m16n8k8 per k8 step).  The design is tf32_tile.cuh's,
// with the bf16 product of bf16_tile.cuh and the f32 kernel's epilogue
// (epilogues.cuh: the two k-halves meet through shared memory and each
// output is written once); this file adds only the launch.  No atomics.  The launch goes on
// the caller's stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "bf16_tile.cuh"  // the bf16 tile loop and its helpers
#include "epilogues.cuh"  // the end: the two k-halves meet, the stores

namespace {

// At 16 columns three blocks fit an SM's registers, two where d > 8 (its
// build spills 8 bytes at three).
template <int KT, int TB, bool D8>
__global__ void __launch_bounds__(NT, TB == 16 ? (D8 ? 3 : 2) : 1) kernel_matmul_bf16_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2, const uint16_t* __restrict__ Mb,
    const float* __restrict__ scal, float* __restrict__ out, int rows, int cols, int d, int t,
    int tp, int row_offset, int xvec) {
  constexpr int NCH = TB / 8;
  tile_kernel_bf16<KT, TB, D8>(
      X1, X2, Mb, scal, out, rows, cols, d, t, tp, row_offset, xvec != 0,
      [&](float (&acc)[NCH][4], float* red, int kh, int ra, int c, int nch, int i0, int t0,
          long long, float* out) {
        store_product<TB>(acc, red, kh, ra, c, nch, i0, t0, out, rows, t);
      });
}

template <int TB, bool D8>
cudaError_t launch_tb(int kernel_type, int d, dim3 grid, cudaStream_t stream, const float* X1,
                      const float* X2, const uint16_t* Mb, const float* scal, float* out,
                      int rows, int cols, int t, int tp, int row_offset, int xvec) {
  auto kern = kernel_matmul_bf16_kernel<MATERN52, TB, D8>;
  switch (kernel_type) {
    case RBF: kern = kernel_matmul_bf16_kernel<RBF, TB, D8>; break;
    case MATERN12: kern = kernel_matmul_bf16_kernel<MATERN12, TB, D8>; break;
    case MATERN32: kern = kernel_matmul_bf16_kernel<MATERN32, TB, D8>; break;
    default: break;
  }
  const size_t smem = smem_bytes_bf16(TB, d, D8);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(X1, X2, Mb, scal, out, rows, cols, d, t, tp, row_offset, xvec);
  return cudaGetLastError();
}

template <bool D8>
cudaError_t launch(int tb, int kernel_type, int d, dim3 grid, cudaStream_t stream,
                   const float* X1, const float* X2, const uint16_t* Mb, const float* scal,
                   float* out, int rows, int cols, int t, int tp, int row_offset, int xvec) {
  switch (tb) {
    case 16: return launch_tb<16, D8>(kernel_type, d, grid, stream, X1, X2, Mb, scal, out, rows, cols, t, tp, row_offset, xvec);
    case 32: return launch_tb<32, D8>(kernel_type, d, grid, stream, X1, X2, Mb, scal, out, rows, cols, t, tp, row_offset, xvec);
    case 64: return launch_tb<64, D8>(kernel_type, d, grid, stream, X1, X2, Mb, scal, out, rows, cols, t, tp, row_offset, xvec);
    case 128: return launch_tb<128, D8>(kernel_type, d, grid, stream, X1, X2, Mb, scal, out, rows, cols, t, tp, row_offset, xvec);
    default: return launch_tb<256, D8>(kernel_type, d, grid, stream, X1, X2, Mb, scal, out, rows, cols, t, tp, row_offset, xvec);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  X1, X2, scal and out are device
// pointers to contiguous f32 arrays, Mb to a contiguous bf16 array: X1
// (rows, d), X2 (cols, d), Mb (batch, cols, tp) with tp a multiple of 8 and
// at least t (columns t .. tp - 1 are never read into an output), out
// (batch, rows, t); scal holds [outputscale, sigma2] on the device.
// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take (tp, an Mb
// that is not 16-byte aligned, d past what shared memory holds).
extern "C" int kernel_matmul_bf16(const float* X1, const float* X2,
                                  const void* Mb, const float* scal,
                                  float* out, int rows, int cols, int d,
                                  int t, int tp, int batch, int row_offset,
                                  int kernel_type, void* stream) {
  if (rows <= 0 || cols < 0 || d <= 0 || t <= 0 || batch <= 0 ||
      batch > 65535 || kernel_type < RBF || kernel_type > MATERN52 ||
      tp < t || tp % 8 != 0 || reinterpret_cast<uintptr_t>(Mb) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool d8 = d <= 8;
  const int tb = column_block_bf16(d, t, 256);
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + BN - 1) / BN, (t + tb - 1) / tb, batch);
  const int xvec = d == 8 && reinterpret_cast<uintptr_t>(X2) % 16 == 0;
  const uint16_t* M = static_cast<const uint16_t*>(Mb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d8 ? launch<true>(tb, kernel_type, d, grid, s, X1, X2, M, scal, out, rows, cols, t, tp, row_offset, xvec)
         : launch<false>(tb, kernel_type, d, grid, s, X1, X2, M, scal, out, rows, cols, t, tp, row_offset, xvec);
  return static_cast<int>(err);
}
