// One fused mBCG iteration with bf16 operands for Hopper (sm_90a), the
// precision="mixed" mode of fused_cg_step.cu:
//
//     U' = U + alpha D,   R' = R - alpha V,   D' = gamma R' + beta D
//     V' = (K(X1, X2) + sigma2 * [row_offset + i == j]) @ D'
//     red = [D'^T V'; R'^T R'; R'^T V'; V'^T V']   per (batch, column)
//
// where the product takes the kernel entries (formed in f32) and D' rounded
// to bf16 and sums in f32.  The state, the prologue and the four reductions
// stay f32, as in the f32 step.
//
// Replaces the TPU kernel fused_cg_step_pallas with compute_dtype="bfloat16"
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:487, body
// _fused_cg_step_kernel :373, the bf16 casts of the product :428-429).
//
// What bounds it on an H100: operations, as bf16 B1 (kernel_matmul_bf16.cu):
// the entries on the CUDA cores, the product one bf16 product on the tensor
// cores; the state adds 7 (batch, n, t) f32 reads, 4 f32 writes and one
// bf16 write.  Three launches on the caller's stream, as in the f32 step:
//
//   1. advance_bf16_kernel: U', R', D' of this call's rows, and a bf16 copy
//      of the D' that the product reads, rows padded to tp (a multiple of 8)
//      so that it stages by 16-byte copies: the rows' own D' when the column
//      state is the row state, else D' of every column, from the column
//      state.  Rounded once per element, not once per row block that reads
//      it;
//   2. fused_cg_product_bf16_kernel: bf16_tile.cuh's tile loop with M = the
//      bf16 D', then the f32 step's epilogue (epilogues.cuh): V' and one
//      partial per row block of the four reductions, each summed in a fixed
//      order;
//   3. fold_partials_kernel: the partials summed in a fixed order.
//
// No atomics anywhere, so two runs give the same bits.  The outputs must be
// other buffers than the inputs (the caller ping-pongs them).  alpha, beta,
// gamma, the outputscale and sigma2 are read through device pointers, so
// the host never waits between iterations.

#include <cuda_runtime.h>

#include "bf16_tile.cuh"  // the bf16 tile loop and its helpers
#include "epilogues.cuh"  // the end: V' and the partial reductions

namespace {

constexpr int ADVANCE_THREADS = 256;

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(x));
  return r;
}

// U', R', D' of the rows (e < nr), then D' of the columns (nr <= e < nr +
// nc) when the column state is separate; abg = [alpha; beta; gamma] (3,
// batch, t).  Db (batch, cols, tp) receives the bf16 D' of the columns:
// the rows' when shared, else the columns' (the same advance_r /
// advance_d, so a shared column state gives the same bits either way).
__global__ void __launch_bounds__(ADVANCE_THREADS) advance_bf16_kernel(
    const float* __restrict__ U, const float* __restrict__ R, const float* __restrict__ D,
    const float* __restrict__ V, const float* __restrict__ Rc, const float* __restrict__ Dc,
    const float* __restrict__ Vc, const float* __restrict__ abg, float* __restrict__ Uo,
    float* __restrict__ Ro, float* __restrict__ Do, uint16_t* __restrict__ Db, long long nr,
    long long nc, int rows, int cols, int t, int tp, int batch, int shared) {
  const long long plane = static_cast<long long>(batch) * t;
  const long long stride = static_cast<long long>(gridDim.x) * ADVANCE_THREADS;
  for (long long e = blockIdx.x * static_cast<long long>(ADVANCE_THREADS) + threadIdx.x;
       e < nr + nc; e += stride) {
    const bool row = e < nr;
    const long long f = row ? e : e - nr;
    const long long per_batch = static_cast<long long>(row ? rows : cols) * t;
    const long long s = (f / per_batch) * t + f % t;  // (batch, column) of the scalars
    const long long db = (f / t) * tp + f % t;       // f's place in the padded bf16 copy
    const float alpha = abg[s], beta = abg[plane + s], gamma = abg[2 * plane + s];
    if (row) {
      const float dold = D[f];
      const float rn = advance_r(R[f], alpha, V[f]);
      const float dn = advance_d(rn, dold, beta, gamma);
      Uo[f] = fmaf(alpha, dold, U[f]);
      Ro[f] = rn;
      Do[f] = dn;
      if (shared) Db[db] = bf16_bits(dn);
    } else {
      Db[db] = bf16_bits(advance_d(advance_r(Rc[f], alpha, Vc[f]), Dc[f], beta, gamma));
    }
  }
}

// V' = (K + sigma2 I) D' for rows i0 .. i0 + 63 and columns t0 .. t0 + TB
// of batch element blockIdx.z, from the bf16 D', and this row block's
// partial reductions (f32, from R', D' and V').  Three blocks an SM at 16
// columns, two where d > 8 (its build spills 8 bytes at three).
template <int KT, int TB, bool D8>
__global__ void __launch_bounds__(NT, TB == 16 ? (D8 ? 3 : 2) : 1) fused_cg_product_bf16_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2, const uint16_t* __restrict__ Db,
    const float* __restrict__ scal, const float* __restrict__ Ro, const float* __restrict__ Do,
    float* __restrict__ Vo, float* __restrict__ partial, int rows, int cols, int d, int t,
    int tp, int batch, int row_offset, int xvec) {
  constexpr int NCH = TB / 8;  // n8 tiles of the accumulator
  tile_kernel_bf16<KT, TB, D8>(
      X1, X2, Db, scal, Vo, rows, cols, d, t, tp, row_offset, xvec != 0,
      [&](float (&acc)[NCH][4], float* red, int kh, int ra, int c, int nch, int i0, int t0,
          long long b, float* Vb) {
        store_cg_product<TB>(acc, red, kh, ra, c, nch, i0, t0, b, Vb, Ro, Do, partial, rows, t,
                             batch);
      });
}

template <int TB, bool D8>
cudaError_t launch_product(int kernel_type, int d, dim3 grid, cudaStream_t stream,
                           const float* X1, const float* X2, const uint16_t* Db,
                           const float* scal, const float* Ro, const float* Do, float* Vo,
                           float* partial, int rows, int cols, int t, int tp, int batch,
                           int row_offset, int xvec) {
  auto kern = fused_cg_product_bf16_kernel<MATERN52, TB, D8>;
  switch (kernel_type) {
    case RBF: kern = fused_cg_product_bf16_kernel<RBF, TB, D8>; break;
    case MATERN12: kern = fused_cg_product_bf16_kernel<MATERN12, TB, D8>; break;
    case MATERN32: kern = fused_cg_product_bf16_kernel<MATERN32, TB, D8>; break;
    default: break;
  }
  const size_t smem = smem_bytes_bf16(TB, d, D8);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(X1, X2, Db, scal, Ro, Do, Vo, partial, rows, cols, d, t, tp,
                                   batch, row_offset, xvec);
  return cudaGetLastError();
}

template <bool D8>
cudaError_t launch(int tb, int kernel_type, int d, dim3 grid, cudaStream_t stream,
                   const float* X1, const float* X2, const uint16_t* Db, const float* scal,
                   const float* Ro, const float* Do, float* Vo, float* partial, int rows,
                   int cols, int t, int tp, int batch, int row_offset, int xvec) {
  switch (tb) {
    case 16: return launch_product<16, D8>(kernel_type, d, grid, stream, X1, X2, Db, scal, Ro, Do, Vo, partial, rows, cols, t, tp, batch, row_offset, xvec);
    case 32: return launch_product<32, D8>(kernel_type, d, grid, stream, X1, X2, Db, scal, Ro, Do, Vo, partial, rows, cols, t, tp, batch, row_offset, xvec);
    default: return launch_product<64, D8>(kernel_type, d, grid, stream, X1, X2, Db, scal, Ro, Do, Vo, partial, rows, cols, t, tp, batch, row_offset, xvec);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  As fused_cg_step_f32, with Db,
// a device bf16 array of batch * cols * tp values (tp a multiple of 8 and at
// least t, 16-byte aligned) that receives the bf16 D' of the columns, and
// partial only ceil(rows / 64) * batch * 4 * t floats (the row blocks'
// partial reductions).  X1 (rows, d), X2 (cols, d); the state U, R, D, V
// and the outputs Uo, Ro, Do, Vo (batch, rows, t), which must not overlap
// the inputs; the column state Rc, Dc, Vc (batch, cols, t), which may be
// the same arrays as R, D, V; abg (3, batch, t); scal = [outputscale,
// sigma2]; red (batch, 4, t), the output reductions.  Returns
// cudaGetLastError() after the three launches (0 = ok), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int fused_cg_step_bf16(
    const float* X1, const float* X2, const float* U, const float* R,
    const float* D, const float* V, const float* Rc, const float* Dc,
    const float* Vc, const float* abg, const float* scal, float* Uo,
    float* Ro, float* Do, float* Vo, float* partial, void* Db, float* red,
    int rows, int cols, int d, int t, int tp, int batch, int row_offset,
    int kernel_type, void* stream) {
  if (rows <= 0 || cols < 0 || d <= 0 || t <= 0 || batch <= 0 ||
      batch > 65535 || kernel_type < RBF || kernel_type > MATERN52 ||
      tp < t || tp % 8 != 0 || reinterpret_cast<uintptr_t>(Db) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // up to 64 columns a block: t is the probe count + 1 on the CG paths
  const int tb = column_block_bf16(d, t, 64);
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + BN - 1) / BN;
  const long long m = static_cast<long long>(batch) * 4 * t;
  const bool shared = Rc == R && Dc == D && Vc == V && rows == cols;
  uint16_t* Dbh = static_cast<uint16_t*>(Db);
  const long long nr = static_cast<long long>(batch) * rows * t;
  const long long nc = shared ? 0 : static_cast<long long>(batch) * cols * t;
  const long long adv_blocks = (nr + nc + ADVANCE_THREADS - 1) / ADVANCE_THREADS;
  advance_bf16_kernel<<<static_cast<int>(adv_blocks < 132 * 32 ? adv_blocks : 132 * 32),
                        ADVANCE_THREADS, 0, s>>>(U, R, D, V, Rc, Dc, Vc, abg, Uo, Ro, Do, Dbh,
                                                 nr, nc, rows, cols, t, tp, batch, shared);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // cols = 0 runs no column step: V' = 0, and the reductions still come
  const dim3 grid(row_blocks, (t + tb - 1) / tb, batch);
  const int xvec = d == 8 && reinterpret_cast<uintptr_t>(X2) % 16 == 0;
  err = d <= 8 ? launch<true>(tb, kernel_type, d, grid, s, X1, X2, Dbh, scal, Ro, Do, Vo, partial,
                              rows, cols, t, tp, batch, row_offset, xvec)
               : launch<false>(tb, kernel_type, d, grid, s, X1, X2, Dbh, scal, Ro, Do, Vo,
                               partial, rows, cols, t, tp, batch, row_offset, xvec);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_partials_kernel<<<static_cast<int>(m), FOLD_THREADS, 0, s>>>(partial, red, row_blocks,
                                                                    static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}
