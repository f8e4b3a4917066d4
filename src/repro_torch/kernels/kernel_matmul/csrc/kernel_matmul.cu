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
// (:199, 3-D M, here the blockIdx.z axis).  Same arithmetic as its
// _apply_stationary / _masked_kernel_tile helpers: d2 = |x|^2 + |x'|^2 -
// 2<x, x'> clamped at 0, a sqrt floor of 1e-20 for the Matern family, the
// sigma2 diagonal at global row == global column, and kernel-tile columns
// and M rows >= cols zeroed by a select before they reach the accumulator.
//
// What bounds it on an H100: operations.  Per call it does
// 2 * rows * cols * (d + t) f32 FMA flops plus one exp per kernel entry,
// against (rows + cols) * d + cols * t + rows * t floats of traffic; at
// n = 40,000, d = 8, t = 9 that is ~5e10 flops and 1.6e9 exps for 5.4 MB.
// The design keeps everything O(n^2) on chip:
//
//   * each block owns BN output rows x BT output columns, with its
//     accumulator in registers;
//   * it loops over column blocks of BM rows of X2 / M, staging the X2
//     feature chunks and the M tile in shared memory, forming the BN x BM
//     kernel tile in shared memory (f32 FMA, no tensor cores: the "highest"
//     precision policy is IEEE f32), and accumulating tile x M;
//   * nothing is carried between blocks: no atomics, no output revisiting.
//
// A grid axis over t-blocks of 16, 32 or 64 columns takes wide right-hand
// sides (the posterior cache's Gram product passes t ~ 234, an uncached
// predict t = 256 in every CG iteration); each t-block recomputes its
// kernel tile, a redundancy that costs something only at those widths.  The launch goes on the caller's stream and the entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include "common.cuh"  // KernelType, stationary()

namespace {

constexpr int BN = 64;        // output rows per block
constexpr int BM = 64;        // X2 rows / M rows per column step
constexpr int DK = 8;         // feature chunk staged per inner step
constexpr int NT = 256;       // threads per block
constexpr int KPAD = BM + 4;  // kernel-tile row stride: float4-aligned rows

template <int KT, int BT>
__global__ void __launch_bounds__(NT) kernel_matmul_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2,
    const float* __restrict__ M, const float* __restrict__ scal,
    float* __restrict__ out, int rows, int cols, int d, int t, int row_offset) {
  __shared__ float sX1[BN][DK + 1];
  __shared__ float sX2[BM][DK + 1];
  __shared__ float sN1[BN];
  __shared__ float sN2[BM];
  __shared__ __align__(16) float sK[BN][KPAD];
  __shared__ float sM[BM][BT];

  const float outputscale = scal[0];
  const float sigma2 = scal[1];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BT;
  const long long b = blockIdx.z;
  M += b * static_cast<long long>(cols) * t;
  out += b * static_cast<long long>(rows) * t;

  // kernel-tile mapping: a 16 x 16 thread grid, 4 x 4 entries per thread
  const int ty = tid / 16;
  const int tx = tid % 16;
  // product mapping: column pc of the t-block, rows pr + RG * r
  constexpr int RG = NT / BT;
  constexpr int RPT = BN / RG;
  const int pc = tid % BT;
  const int pr = tid / BT;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;

  for (int j0 = 0; j0 < cols; j0 += BM) {
    // ---- inner products and norms over feature chunks -------------------
    float inner[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) inner[r][c] = 0.0f;
    float norm = 0.0f;  // tid < BN: |X1 row|^2; BN <= tid < BN + BM: X2 row

    for (int k0 = 0; k0 < d; k0 += DK) {
      __syncthreads();  // the previous readers of sX1 / sX2 are done
      for (int e = tid; e < BN * DK; e += NT) {
        const int r = e / DK, k = e % DK;
        const int gi = i0 + r, gk = k0 + k;
        sX1[r][k] = (gi < rows && gk < d)
                        ? X1[static_cast<long long>(gi) * d + gk] : 0.0f;
      }
      for (int e = tid; e < BM * DK; e += NT) {
        const int r = e / DK, k = e % DK;
        const int gj = j0 + r, gk = k0 + k;
        sX2[r][k] = (gj < cols && gk < d)
                        ? X2[static_cast<long long>(gj) * d + gk] : 0.0f;
      }
      __syncthreads();
      if (tid < BN) {
#pragma unroll
        for (int k = 0; k < DK; ++k) norm = fmaf(sX1[tid][k], sX1[tid][k], norm);
      } else if (tid < BN + BM) {
#pragma unroll
        for (int k = 0; k < DK; ++k)
          norm = fmaf(sX2[tid - BN][k], sX2[tid - BN][k], norm);
      }
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sX1[ty + 16 * r][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sX2[tx + 16 * c][k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inner[r][c] = fmaf(a[r], bb[c], inner[r][c]);
      }
    }
    if (tid < BN) {
      sN1[tid] = norm;
    } else if (tid < BN + BM) {
      sN2[tid - BN] = norm;
    }

    // ---- the M tile: rows >= cols and columns >= t read as 0 -------------
    for (int e = tid; e < BM * BT; e += NT) {
      const int r = e / BT, c = e % BT;
      const int gj = j0 + r, gc = t0 + c;
      sM[r][c] = (gj < cols && gc < t)
                     ? M[static_cast<long long>(gj) * t + gc] : 0.0f;
    }
    __syncthreads();  // norms and the M tile are visible

    // ---- the kernel tile, sigma2 diagonal and column mask ----------------
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int li = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lj = tx + 16 * c;
        const int gj = j0 + lj;
        const float d2 = fmaxf(sN1[li] + sN2[lj] - 2.0f * inner[r][c], 0.0f);
        float kv = stationary<KT>(d2, outputscale);
        if (row_offset + i0 + li == gj) kv += sigma2;
        sK[li][lj] = (gj < cols) ? kv : 0.0f;
      }
    }
    __syncthreads();

    // ---- tile x M, f32 FMA into the register accumulator ----------------
#pragma unroll 4
    for (int j = 0; j < BM; j += 4) {
      const float m0 = sM[j][pc], m1 = sM[j + 1][pc];
      const float m2 = sM[j + 2][pc], m3 = sM[j + 3][pc];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 k4 = *reinterpret_cast<const float4*>(&sK[pr + RG * r][j]);
        float s = acc[r];
        s = fmaf(k4.x, m0, s);
        s = fmaf(k4.y, m1, s);
        s = fmaf(k4.z, m2, s);
        s = fmaf(k4.w, m3, s);
        acc[r] = s;
      }
    }
    __syncthreads();  // sK / sM / sN are rewritten by the next column step
  }

  const int gc = t0 + pc;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gi = i0 + pr + RG * r;
    if (gi < rows && gc < t) out[static_cast<long long>(gi) * t + gc] = acc[r];
  }
}

template <int BT>
void launch_bt(int kernel_type, dim3 grid, cudaStream_t stream,
               const float* X1, const float* X2, const float* M,
               const float* scal, float* out, int rows, int cols, int d, int t,
               int row_offset) {
  switch (kernel_type) {
    case RBF:
      kernel_matmul_kernel<RBF, BT><<<grid, NT, 0, stream>>>(
          X1, X2, M, scal, out, rows, cols, d, t, row_offset);
      break;
    case MATERN12:
      kernel_matmul_kernel<MATERN12, BT><<<grid, NT, 0, stream>>>(
          X1, X2, M, scal, out, rows, cols, d, t, row_offset);
      break;
    case MATERN32:
      kernel_matmul_kernel<MATERN32, BT><<<grid, NT, 0, stream>>>(
          X1, X2, M, scal, out, rows, cols, d, t, row_offset);
      break;
    default:
      kernel_matmul_kernel<MATERN52, BT><<<grid, NT, 0, stream>>>(
          X1, X2, M, scal, out, rows, cols, d, t, row_offset);
      break;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays; M and out are (batch, cols, t) and
// (batch, rows, t); scal holds [outputscale, sigma2] on the device, so the
// caller never syncs to read a scalar.  Returns cudaGetLastError() after
// the launch (0 = ok), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int kernel_matmul_f32(const float* X1, const float* X2,
                                 const float* M, const float* scal,
                                 float* out, int rows, int cols, int d,
                                 int t, int batch, int row_offset,
                                 int kernel_type, void* stream) {
  if (rows <= 0 || cols < 0 || d <= 0 || t <= 0 || batch <= 0 ||
      batch > 65535 || kernel_type < RBF || kernel_type > MATERN52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + BN - 1) / BN;
  if (t <= 16) {
    dim3 grid(row_blocks, (t + 15) / 16, batch);
    launch_bt<16>(kernel_type, grid, s, X1, X2, M, scal, out, rows, cols, d,
                  t, row_offset);
  } else if (t <= 32) {
    dim3 grid(row_blocks, (t + 31) / 32, batch);
    launch_bt<32>(kernel_type, grid, s, X1, X2, M, scal, out, rows, cols, d,
                  t, row_offset);
  } else {
    // wide right-hand sides (the cache's Gram product, predict's solves):
    // 64 columns per block, so the kernel tile is recomputed t/64 times
    dim3 grid(row_blocks, (t + 63) / 64, batch);
    launch_bt<64>(kernel_type, grid, s, X1, X2, M, scal, out, rows, cols, d,
                  t, row_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
