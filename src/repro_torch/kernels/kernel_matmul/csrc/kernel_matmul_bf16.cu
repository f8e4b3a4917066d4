// The kernel-matrix matmul with bf16 operands for Hopper (sm_90a), the
// precision="mixed" mode of kernel_matmul.cu:
//
//     out = (K(X1, X2) + sigma2 * [row_offset + i == j]) @ M
//
// with the distance's inner product taken on the tensor cores from bf16
// X/l, each kernel entry rounded to bf16, M rounded to bf16, and their
// product summed in f32.  X1 (rows, dp) and X2 (cols, dp) come as the
// staged bf16 copies of the prescaled inputs (kernel_matmul.stage_bf16: bf16
// values, rows padded with zeros to dp, a multiple of 16 features); M as a
// bf16 copy of shape (batch, cols, tp), rows padded to tp, a multiple of 8.
//
// Replaces the TPU kernel kernel_matmul_pallas with compute_dtype="bfloat16"
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:298), bodies
// _kernel_matmul_kernel (:166, 2-D M) and _kernel_matmul_batched_kernel
// (:199, 3-D M, here the blockIdx.z axis; its entry point :331); the stages
// _masked_kernel_tile (:119) and _tile_rhs_product (:154).  As there, the
// distance's inner product takes bf16 operands with f32 accumulation and
// the norms stay f32.
//
// What bounds it on an H100: operations.  At narrow t (an mBCG iteration,
// t = 9) the kernel map on the SFU (Matern: one rsqrt and one ex2 an entry,
// 16 a clock an SM: 0.77 ms at n = 40,000); at wide t (the cache's Gram
// product, predict's 256 columns) the product on the tensor cores, 2 t
// flops an entry at 989 TFLOP/s, with the map beside it.  The design
// (bf16_tile.cuh) keeps everything but the map off the CUDA cores: the
// distance and the norms on wgmma, the entries formed in registers
// straight into the product's register A operand, the product on wgmma,
// the tiles brought by TMA, each warpgroup's tiles software-pipelined.
// Launches: the norms pass, the product (column blocks of 16 .. 128
// right-hand-side columns, t > 128 taking several, each forming the
// entries again; a block forms each entry once for up to 64 / TB batch
// elements, B2; up to 32 columns one block a chunk of a row tile's
// columns), and then the fold of the chunks' sums.  No atomics.  The launches go
// on the caller's stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "bf16_tile.cuh"  // the bf16 tile loop, its layouts and tensor maps

namespace {

// B1 / B2: each thread stores its sums into out (batch, rows, t), or
// (chunked) its chunk's into the chunks' sums for fold_chunks_kernel.
template <int KT, int TB, int NB>
__global__ void __launch_bounds__(WG_THREADS * warpgroups(TB), min_blocks<TB, NB>())
    kernel_matmul_bf16_kernel(const __grid_constant__ Maps maps, const float* __restrict__ n1,
                              const float* __restrict__ scal, float* __restrict__ chunks,
                              float* __restrict__ out, int rows, int cols, int dp, int t,
                              int batch, int row_offset, int stages) {
  tile_loop_bf16<KT, TB, NB>(
      maps, n1, scal, rows, cols, dp, batch, row_offset, stages,
      [&](float (&acc)[NB][TB / 2], unsigned char*, int wg, int r0, int c, int i0, int t0,
          int b0, int nb) {
        float* o = chunked(TB) ? chunks + static_cast<long long>(blockIdx.y) * batch * rows * t
                               : out;
        store_acc<TB, NB>(acc, o, i0 + TILE * wg, r0, c, t0, b0, nb, rows, t);
      });
}

// One launch of the product at column block TB and NB batch elements a
// block (chunked: one block a chunk of a row tile, then the fold).
template <int TB, int NB>
cudaError_t launch_tb(int kernel_type, const Maps& maps, dim3 grid, int stages,
                      cudaStream_t stream, const float* n1, const float* scal, float* chunks,
                      float* out, int rows, int cols, int dp, int t, int batch, int row_offset) {
  auto kern = kernel_matmul_bf16_kernel<MATERN52, TB, NB>;
  switch (kernel_type) {
    case RBF: kern = kernel_matmul_bf16_kernel<RBF, TB, NB>; break;
    case MATERN12: kern = kernel_matmul_bf16_kernel<MATERN12, TB, NB>; break;
    case MATERN32: kern = kernel_matmul_bf16_kernel<MATERN32, TB, NB>; break;
    default: break;
  }
  const int smem = smem_layout(TB, NB, dp, stages).total;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nchunks = chunk_count(cols);
  if (chunked(TB)) grid.y = nchunks > 0 ? nchunks : 1;
  kern<<<grid, WG_THREADS * warpgroups(TB), smem, stream>>>(maps, n1, scal, chunks, out, rows,
                                                            cols, dp, t, batch, row_offset,
                                                            stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || !chunked(TB)) return err;
  return launch_fold_chunks(chunks, out, static_cast<long long>(batch) * rows * t, nchunks,
                            stream);
}

// One right-hand side (NB = 1), or batch_block(TB) of several a block.
template <int TB>
cudaError_t launch_nb(bool several, int kernel_type, const Maps& maps, dim3 grid, int stages,
                      cudaStream_t stream, const float* n1, const float* scal, float* chunks,
                      float* out, int rows, int cols, int dp, int t, int batch, int row_offset) {
  if (several) {
    return launch_tb<TB, batch_block(TB)>(kernel_type, maps, grid, stages, stream, n1, scal,
                                          chunks, out, rows, cols, dp, t, batch, row_offset);
  }
  return launch_tb<TB, 1>(kernel_type, maps, grid, stages, stream, n1, scal, chunks, out, rows,
                          cols, dp, t, batch, row_offset);
}

}  // namespace

// Plain C entry point (bound with ctypes).  scal, scratch and out are
// device pointers to contiguous f32 arrays, X1, X2 and Mb to contiguous
// bf16 arrays, each 16-byte aligned: X1 (rows, dp) and X2 (cols, dp), the
// staged X/l (bf16 values, dp a multiple of 16, features past d zero); Mb
// (batch, cols, tp) with tp a multiple of 8 and at least t (columns t ..
// tp - 1 are never read into an output); scratch norms_floats(rows, cols)
// floats, plus max(chunk_count(cols), 1) * batch * rows * t when t <= 32 (the
// chunks' sums); out (batch, rows, t); scal holds [outputscale, sigma2] on
// the device.  Returns cudaGetLastError() after the launches (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take (tp, dp,
// alignment, dp past what shared memory holds, a tensor map the driver
// refuses).
extern "C" int kernel_matmul_bf16(const void* X1, const void* X2, const void* Mb,
                                  const float* scal, float* scratch, float* out, int rows,
                                  int cols, int dp, int t, int tp, int batch, int row_offset,
                                  int kernel_type, void* stream) {
  bool ok = rows > 0 && cols >= 0 && dp > 0 && dp % 16 == 0 && t > 0 && batch > 0 &&
            kernel_type >= RBF && kernel_type <= MATERN52 && tp >= t && tp % 8 == 0;
  for (const void* p : {X1, X2, Mb, static_cast<const void*>(scratch)}) {
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tb = column_block_bf16(t, 128);
  const int nb = batch == 1 ? 1 : batch_block(tb);
  const int stages = ring_stages(tb, nb, dp, 0);
  Maps maps;
  if (stages == 0 ||
      !encode_maps(&maps, X1, X2, Mb, scratch, rows, cols, dp, tp, batch, tb, nb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nbb = (batch + nb - 1) / nb;
  if (nbb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* n1 = nullptr;
  cudaError_t err = launch_all_norms(X1, X2, scratch, rows, cols, dp, s, &n1);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* chunks = scratch + norms_floats(rows, cols);
  const dim3 grid((rows + TILE * warpgroups(tb) - 1) / (TILE * warpgroups(tb)), (t + tb - 1) / tb,
                  nbb);
  const bool several = nb > 1;
  switch (tb) {
    case 16: err = launch_nb<16>(several, kernel_type, maps, grid, stages, s, n1, scal, chunks, out, rows, cols, dp, t, batch, row_offset); break;
    case 32: err = launch_nb<32>(several, kernel_type, maps, grid, stages, s, n1, scal, chunks, out, rows, cols, dp, t, batch, row_offset); break;
    case 64: err = launch_tb<64, 1>(kernel_type, maps, grid, stages, s, n1, scal, chunks, out, rows, cols, dp, t, batch, row_offset); break;
    default: err = launch_tb<128, 1>(kernel_type, maps, grid, stages, s, n1, scal, chunks, out, rows, cols, dp, t, batch, row_offset); break;
  }
  return static_cast<int>(err);
}
