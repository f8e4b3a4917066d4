// Gradient of the kernel-matrix matmul with respect to its inputs, for
// Hopper (sm_90a), K never formed.  For prescaled inputs X1 (rows, d),
// X2 (cols, d), weights w_ij = <A_i, B_j> from A (rows, t) and B (cols, t)
// and a stationary kernel k = outputscale * f(|x - x'|^2):
//
//     G_i = sum_j w_ij * dk(x1_i, x2_j)/dx1_i
//         = sum_j w_ij * outputscale * 2 f'(r_ij^2) * (x1_i - x2_j)
//     g   = sum_ij w_ij * f(r_ij^2)            (= d/d outputscale)
//
// With A the cotangent C of out = K @ M and B = M this is the vector-Jacobian
// product of B1 for its row inputs and its outputscale; with the roles of
// (X1, A) and (X2, B) swapped, the same kernel gives the column inputs'.
// Autograd carries G through X / lengthscale to the lengthscale (scalar or
// ARD) and on to the raw parameters.
//
// Port-only: the reference takes this gradient from jax.vjp through its
// blackbox matmul (src/repro/core/inference.py:641) and has no TPU kernel
// for it.
//
// What bounds it on an H100: operations.  Per kernel entry and launch: 3d
// for the differences and the distance from them, 2t for the weight, ~20
// for f, f' and the coefficient, 3d for the gradient sum (it forms the
// differences again): ~1.3e11 f32 operations per launch at n = 40,000,
// d = 8, t = 9, against ~3 MB of traffic.  The rows' and the columns'
// sums could share one set of differences, so the least work for both is
// 7d + 2t + 20 per entry.  The design:
//
//   * one block owns BN rows and keeps their G in registers while it loops
//     over all column tiles; nothing is carried between blocks;
//   * per column tile the 64 x 64 coefficients w_ij * 2 f'(r_ij^2) go to
//     shared memory, and a second thread mapping (row, feature) sums
//     coefficient x (x1_i - x2_j) over the tile;
//   * differences, not the norm expansion: (x1_i - x2_j) is exactly 0 at
//     coincident points, and the Matern floor's clip zeroes f' there, so
//     Matern-1/2's unbounded f' never meets them (no NaN, exactly 0);
//   * the outputscale sum folds each block's entries in a fixed order into
//     one partial per block, and fold_partials_kernel sums the blocks in a
//     fixed order: no atomics.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BN = 64;     // rows per block
constexpr int BM = 64;     // X2 rows per column step
constexpr int TK = 16;     // weight columns staged per inner step
constexpr int MAXD = 32;   // features held in shared memory
constexpr int NT = 256;    // threads per block
constexpr int GPT = BN * MAXD / NT;  // (row, feature) pairs per thread

template <int KT>
__global__ void __launch_bounds__(NT) kernel_matmul_grad_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2,
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ scal, float* __restrict__ G,
    float* __restrict__ partial, int rows, int cols, int d, int t) {
  __shared__ float sX1[BN][MAXD + 1];
  __shared__ float sX2[BM][MAXD + 1];
  __shared__ float sA[BN][TK + 1];
  __shared__ float sB[BM][TK + 1];
  __shared__ float sC[BN][BM + 1];
  __shared__ float sRed[NT];

  const float outputscale = scal[0];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BN;
  // entry mapping: a 16 x 16 thread grid, 4 x 4 entries per thread
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int e = tid; e < BN * MAXD; e += NT) {
    const int r = e / MAXD, k = e % MAXD;
    const int gi = i0 + r;
    sX1[r][k] = (gi < rows && k < d) ? X1[static_cast<long long>(gi) * d + k] : 0.0f;
  }

  float g[GPT];
#pragma unroll
  for (int q = 0; q < GPT; ++q) g[q] = 0.0f;
  float fsum = 0.0f;  // this thread's share of sum w_ij f(r_ij^2)

  for (int j0 = 0; j0 < cols; j0 += BM) {
    __syncthreads();  // the previous tile's readers of sX2 / sC are done
    for (int e = tid; e < BM * MAXD; e += NT) {
      const int r = e / MAXD, k = e % MAXD;
      const int gj = j0 + r;
      sX2[r][k] = (gj < cols && k < d) ? X2[static_cast<long long>(gj) * d + k] : 0.0f;
    }

    // ---- weights w_ij = <A_i, B_j> over chunks of TK columns -------------
    float w[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = 0.0f;
    for (int k0 = 0; k0 < t; k0 += TK) {
      __syncthreads();  // the previous chunk's readers of sA / sB are done
      for (int e = tid; e < BN * TK; e += NT) {
        const int r = e / TK, k = e % TK;
        const int gi = i0 + r, gk = k0 + k;
        sA[r][k] = (gi < rows && gk < t) ? A[static_cast<long long>(gi) * t + gk] : 0.0f;
      }
      for (int e = tid; e < BM * TK; e += NT) {
        const int r = e / TK, k = e % TK;
        const int gj = j0 + r, gk = k0 + k;
        sB[r][k] = (gj < cols && gk < t) ? B[static_cast<long long>(gj) * t + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sA[ty + 16 * r][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sB[tx + 16 * c][k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) w[r][c] = fmaf(a[r], bb[c], w[r][c]);
      }
    }

    // ---- distances from differences, f and f', the coefficient tile ------
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int li = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lj = tx + 16 * c;
        float d2 = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float diff = sX1[li][k] - sX2[lj][k];
          d2 = fmaf(diff, diff, d2);
        }
        float f, df2;
        stationary_grad<KT>(d2, &f, &df2);
        // rows >= rows and columns >= cols carry w = 0 (A, B read as 0),
        // and f, f' are finite there, so they add exactly 0
        fsum = fmaf(w[r][c], f, fsum);
        sC[li][lj] = w[r][c] * outputscale * df2;
      }
    }
    __syncthreads();

    // ---- G_i += sum_j coefficient_ij * (x1_i - x2_j), per (row, feature) -
#pragma unroll
    for (int q = 0; q < GPT; ++q) {
      const int e = tid + NT * q;
      if (e < BN * d) {
        const int i = e / d, k = e % d;
        const float xi = sX1[i][k];
        float s = g[q];
        for (int j = 0; j < BM; ++j) s = fmaf(sC[i][j], xi - sX2[j][k], s);
        g[q] = s;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < GPT; ++q) {
    const int e = tid + NT * q;
    if (e < BN * d) {
      const int i = e / d, k = e % d;
      if (i0 + i < rows) G[static_cast<long long>(i0 + i) * d + k] = g[q];
    }
  }
  sRed[tid] = fsum;
  __syncthreads();
  for (int h = NT / 2; h > 0; h /= 2) {  // fixed pairing
    if (tid < h) sRed[tid] += sRed[tid + h];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x] = sRed[0];
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays: X1 (rows, d), X2 (cols, d), A
// (rows, t), B (cols, t); scal = [outputscale, ...]; G (rows, d), the
// output; partial, scratch of ceil(rows / 64) floats; gsum, one float, the
// output sum_ij w_ij f(r_ij^2).  d must be at most 32.  Returns
// cudaGetLastError() after the two launches (0 = ok), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int kernel_matmul_grad_f32(const float* X1, const float* X2,
                                      const float* A, const float* B,
                                      const float* scal, float* G,
                                      float* partial, float* gsum, int rows,
                                      int cols, int d, int t,
                                      int kernel_type, void* stream) {
  if (rows <= 0 || cols < 0 || d <= 0 || d > MAXD || t <= 0 ||
      kernel_type < RBF || kernel_type > MATERN52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + BN - 1) / BN;
  switch (kernel_type) {
    case RBF:
      kernel_matmul_grad_kernel<RBF><<<row_blocks, NT, 0, s>>>(
          X1, X2, A, B, scal, G, partial, rows, cols, d, t);
      break;
    case MATERN12:
      kernel_matmul_grad_kernel<MATERN12><<<row_blocks, NT, 0, s>>>(
          X1, X2, A, B, scal, G, partial, rows, cols, d, t);
      break;
    case MATERN32:
      kernel_matmul_grad_kernel<MATERN32><<<row_blocks, NT, 0, s>>>(
          X1, X2, A, B, scal, G, partial, rows, cols, d, t);
      break;
    default:
      kernel_matmul_grad_kernel<MATERN52><<<row_blocks, NT, 0, s>>>(
          X1, X2, A, B, scal, G, partial, rows, cols, d, t);
      break;
  }
  fold_partials_kernel<<<1, FOLD_THREADS, 0, s>>>(partial, gsum, row_blocks, 1);
  return static_cast<int>(cudaGetLastError());
}
