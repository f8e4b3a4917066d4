// One fused mBCG iteration for Hopper (sm_90a), K never formed:
//
//     U' = U + alpha D,   R' = R - alpha V,   D' = gamma R' + beta D
//     V' = (K(X1, X2) + sigma2 * [row_offset + i == j]) @ D'
//     red = [D'^T V'; R'^T R'; R'^T V'; V'^T V']   per (batch, column)
//
// for a state of shape (batch, rows, t) (this call's rows), the column-side
// state (batch, cols, t) that the product reads, per-(batch, column) step
// scalars alpha, beta, gamma, and a stationary kernel (rbf, matern12/32/52)
// of prescaled inputs X1 (rows, d), X2 (cols, d).
//
// Replaces the TPU kernel fused_cg_step_pallas
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:487, body
// _fused_cg_step_kernel :373).  There one grid sweep applies the pending
// update to each tile and recomputes the column-side D' per tile.
//
// What bounds it on an H100: operations, as B1 (the kernel tile is
// n^2 (2d + 1) f32 flops and one exp per entry, the product 2 n^2 t, on the
// tensor cores as three TF32 products); the state adds 7 (batch, n, t)
// reads and 4 writes, ~1e-3 of the time at n = 40,000.  The design, three
// launches on the caller's stream:
//
//   1. advance_kernel: U', R', D' of this call's rows, elementwise; when
//      the column state is other arrays than the row state (row shards
//      with row_offset), also D' of every column, into scratch.  D' is
//      formed once per element, not once per row block that reads it (at
//      n = 40,000 that would be ~2.7 GB of L2 reads a launch);
//   2. fused_cg_product_kernel: B1's tile loop (tf32_tile.cuh: kernel
//      entries in the mma A-fragment layout, 3xTF32 mma.sync with IEEE
//      partial sums, the cp.async ring) with M = D', then an epilogue that
//      writes V' and, from V' and its own rows' R', D', one partial per
//      row block of the four reductions, each summed in a fixed order;
//   3. fold_partials_kernel: the row blocks' partials summed in a fixed
//      order.
//
// No atomics anywhere, so two runs give the same bits.  The outputs must
// be other buffers than the inputs (the caller ping-pongs them): every
// product block reads D' of all columns while the advance pass's outputs
// are the rows'.  alpha/beta/gamma, the outputscale and sigma2 are read
// through device pointers, so the host never waits between iterations.

#include <cuda_runtime.h>

#include "epilogues.cuh"  // the end: V' and the partial reductions
#include "tf32_tile.cuh"  // B1's tile loop and its helpers

namespace {

constexpr int ADVANCE_THREADS = 256;

// U', R', D' of the rows (e < nr), then D' of the columns (nr <= e <
// nr + nc) when the column state is separate; abg = [alpha; beta; gamma]
// (3, batch, t).  The rows' and the columns' D' use the same advance_r /
// advance_d, so a shared column state gives the same bits either way.
__global__ void __launch_bounds__(ADVANCE_THREADS) advance_kernel(
    const float* __restrict__ U, const float* __restrict__ R, const float* __restrict__ D,
    const float* __restrict__ V, const float* __restrict__ Rc, const float* __restrict__ Dc,
    const float* __restrict__ Vc, const float* __restrict__ abg, float* __restrict__ Uo,
    float* __restrict__ Ro, float* __restrict__ Do, float* __restrict__ Dco, long long nr,
    long long nc, int rows, int cols, int t, int batch) {
  const long long plane = static_cast<long long>(batch) * t;
  const long long stride = static_cast<long long>(gridDim.x) * ADVANCE_THREADS;
  for (long long e = blockIdx.x * static_cast<long long>(ADVANCE_THREADS) + threadIdx.x;
       e < nr + nc; e += stride) {
    const bool row = e < nr;
    const long long f = row ? e : e - nr;
    const long long per_batch = static_cast<long long>(row ? rows : cols) * t;
    const long long s = (f / per_batch) * t + f % t;  // (batch, column) of the scalars
    const float alpha = abg[s], beta = abg[plane + s], gamma = abg[2 * plane + s];
    if (row) {
      const float dold = D[f];
      const float rn = advance_r(R[f], alpha, V[f]);
      Uo[f] = fmaf(alpha, dold, U[f]);
      Ro[f] = rn;
      Do[f] = advance_d(rn, dold, beta, gamma);
    } else {
      Dco[f] = advance_d(advance_r(Rc[f], alpha, Vc[f]), Dc[f], beta, gamma);
    }
  }
}

// V' = (K + sigma2 I) D' for rows i0 .. i0 + 63 and columns t0 .. t0 + TB
// of batch element blockIdx.z, and this row block's partial reductions.
// Three blocks an SM at 16 columns as B1, two where d > 8 (B1's
// instantiation there spills 8 bytes at three).
template <int KT, int TB, bool D8>
__global__ void __launch_bounds__(NT, TB == 16 ? (D8 ? 3 : 2) : 1) fused_cg_product_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2, const float* __restrict__ M,
    const float* __restrict__ scal, const float* __restrict__ Ro, const float* __restrict__ Do,
    float* __restrict__ Vo, float* __restrict__ partial, int rows, int cols, int d, int t,
    int batch, int row_offset, int flags) {
  constexpr int NCH = TB / 8;  // n8 tiles of the accumulator
  tile_kernel<KT, TB, D8>(
      X1, X2, M, scal, Vo, rows, cols, d, t, row_offset, flags,
      [&](float (&acc)[NCH][4], float* red, int kh, int ra, int c, int nch, int i0, int t0,
          long long b, float* Vb) {
        store_cg_product<TB>(acc, red, kh, ra, c, nch, i0, t0, b, Vb, Ro, Do, partial, rows, t,
                             batch);
      });
}

template <int TB, bool D8>
cudaError_t launch_product(int kernel_type, int d, dim3 grid, cudaStream_t stream,
                           const float* X1, const float* X2, const float* M, const float* scal,
                           const float* Ro, const float* Do, float* Vo, float* partial, int rows,
                           int cols, int t, int batch, int row_offset, int flags) {
  auto kern = fused_cg_product_kernel<MATERN52, TB, D8>;
  switch (kernel_type) {
    case RBF: kern = fused_cg_product_kernel<RBF, TB, D8>; break;
    case MATERN12: kern = fused_cg_product_kernel<MATERN12, TB, D8>; break;
    case MATERN32: kern = fused_cg_product_kernel<MATERN32, TB, D8>; break;
    default: break;
  }
  const size_t smem = smem_bytes(TB, d, D8);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, stream>>>(X1, X2, M, scal, Ro, Do, Vo, partial, rows, cols, d, t, batch,
                                   row_offset, flags);
  return cudaGetLastError();
}

template <bool D8>
cudaError_t launch(int tb, int kernel_type, int d, dim3 grid, cudaStream_t stream,
                   const float* X1, const float* X2, const float* M, const float* scal,
                   const float* Ro, const float* Do, float* Vo, float* partial, int rows, int cols,
                   int t, int batch, int row_offset, int flags) {
  switch (tb) {
    case 16: return launch_product<16, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, Ro, Do, Vo, partial, rows, cols, t, batch, row_offset, flags);
    case 32: return launch_product<32, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, Ro, Do, Vo, partial, rows, cols, t, batch, row_offset, flags);
    default: return launch_product<64, D8>(kernel_type, d, grid, stream, X1, X2, M, scal, Ro, Do, Vo, partial, rows, cols, t, batch, row_offset, flags);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays: X1 (rows, d), X2 (cols, d); the state
// U, R, D, V and the outputs Uo, Ro, Do, Vo (batch, rows, t), which must
// not overlap the inputs; the column state Rc, Dc, Vc (batch, cols, t),
// which may be the same arrays as R, D, V; abg (3, batch, t) = [alpha;
// beta; gamma]; scal = [outputscale, sigma2]; partial, scratch of
// ceil(rows / 64) * batch * 4 * t floats, and batch * cols * t more (the
// columns' D') unless Rc, Dc, Vc are R, D, V and rows == cols; red (batch, 4, t), the output
// reductions.  Returns cudaGetLastError() after the three launches (0 =
// ok), or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int fused_cg_step_f32(
    const float* X1, const float* X2, const float* U, const float* R,
    const float* D, const float* V, const float* Rc, const float* Dc,
    const float* Vc, const float* abg, const float* scal, float* Uo,
    float* Ro, float* Do, float* Vo, float* partial, float* red, int rows,
    int cols, int d, int t, int batch, int row_offset, int kernel_type,
    void* stream) {
  if (rows <= 0 || cols < 0 || d <= 0 || t <= 0 || batch <= 0 ||
      batch > 65535 || kernel_type < RBF || kernel_type > MATERN52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // up to 64 columns a block: t is the probe count + 1 on the CG paths
  const int tb = column_block(d, t, 64);
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + BN - 1) / BN;
  const long long m = static_cast<long long>(batch) * 4 * t;
  const bool shared = Rc == R && Dc == D && Vc == V && rows == cols;
  float* Dco = shared ? Do : partial + row_blocks * m;  // the columns' D'
  const long long nr = static_cast<long long>(batch) * rows * t;
  const long long nc = shared ? 0 : static_cast<long long>(batch) * cols * t;
  const long long adv_blocks = (nr + nc + ADVANCE_THREADS - 1) / ADVANCE_THREADS;
  advance_kernel<<<static_cast<int>(adv_blocks < 132 * 32 ? adv_blocks : 132 * 32),
                   ADVANCE_THREADS, 0, s>>>(U, R, D, V, Rc, Dc, Vc, abg, Uo, Ro, Do, Dco, nr, nc,
                                            rows, cols, t, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // cols = 0 runs no column step: V' = 0, and the reductions still come
  const dim3 grid(row_blocks, (t + tb - 1) / tb, batch);
  const int flags = staging_flags(X2, Dco, d, t);
  err = d <= 8 ? launch<true>(tb, kernel_type, d, grid, s, X1, X2, Dco, scal, Ro, Do, Vo, partial,
                              rows, cols, t, batch, row_offset, flags)
               : launch<false>(tb, kernel_type, d, grid, s, X1, X2, Dco, scal, Ro, Do, Vo,
                               partial, rows, cols, t, batch, row_offset, flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_partials_kernel<<<static_cast<int>(m), FOLD_THREADS, 0, s>>>(partial, red, row_blocks,
                                                                    static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}
