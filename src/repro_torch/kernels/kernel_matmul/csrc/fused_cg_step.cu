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
// _fused_cg_step_kernel :373).  Same arithmetic as the B1 kernel in
// kernel_matmul.cu for the product, plus the state prologue and the four
// reductions over rows < rows.
//
// What bounds it on an H100: operations, as B1 (the kernel tile is
// n^2 (2d + 1) flops and exps, the product 2 n^2 t); the state it adds is
// 7 (batch, n, t) reads and 4 writes, ~1e-3 of the time at n = 40,000.
// The design, for CUDA rather than the TPU's sequential grid:
//
//   * one block owns BN rows x BT columns of one batch element and keeps
//     V' in registers while it loops over all column tiles: no output is
//     revisited, nothing is carried between blocks;
//   * the column-side D' of each tile is recomputed from the OLD column
//     state (R, D, V) by the same advance_r / advance_d as the rows, so
//     every block reads only inputs: the outputs U'/R'/D'/V' must be other
//     buffers than the inputs (the caller ping-pongs them), never updated
//     in place, since other blocks still read the old rows;
//   * the reductions cross blocks: each block folds its rows in a fixed
//     order into one partial per (batch, column), written to a
//     (row_blocks, batch, 4, t) scratch array, and a second small kernel
//     (fold_partials_kernel) sums the row blocks in a fixed order — no
//     atomics, so the result is the same on every run;
//   * alpha/beta/gamma, the outputscale and sigma2 are read through device
//     pointers, so the host never waits on the device between iterations.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BN = 64;        // state rows per block
constexpr int BM = 64;        // X2 rows / column-state rows per column step
constexpr int DK = 8;         // feature chunk staged per inner step
constexpr int NT = 256;       // threads per block
constexpr int KPAD = BM + 4;  // kernel-tile row stride: float4-aligned rows

template <int KT, int BT>
__global__ void __launch_bounds__(NT) fused_cg_step_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2,
    const float* __restrict__ U, const float* __restrict__ R,
    const float* __restrict__ D, const float* __restrict__ V,
    const float* __restrict__ Rc, const float* __restrict__ Dc,
    const float* __restrict__ Vc, const float* __restrict__ abg,
    const float* __restrict__ scal, float* __restrict__ Uo,
    float* __restrict__ Ro, float* __restrict__ Do, float* __restrict__ Vo,
    float* __restrict__ partial, int rows, int cols, int d, int t, int batch,
    int row_offset) {
  __shared__ float sX1[BN][DK + 1];
  __shared__ float sX2[BM][DK + 1];
  __shared__ float sN1[BN];
  __shared__ float sN2[BM];
  __shared__ __align__(16) float sK[BN][KPAD];
  __shared__ float sM[BM][BT];
  __shared__ float sAlpha[BT], sBeta[BT], sGamma[BT];
  constexpr int RG = NT / BT;  // threads that share one column
  constexpr int RPT = BN / RG;  // rows per thread
  __shared__ float sRed[4][RG][BT];

  const float outputscale = scal[0];
  const float sigma2 = scal[1];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BT;
  const int b = blockIdx.z;
  const long long row_base = static_cast<long long>(b) * rows * t;
  const long long col_base = static_cast<long long>(b) * cols * t;

  // step scalars of this batch element's t-block; columns >= t read 0
  if (tid < BT) {
    const int gc = t0 + tid;
    const bool ok = gc < t;
    const long long s = static_cast<long long>(b) * t + gc;
    const long long plane = static_cast<long long>(batch) * t;
    sAlpha[tid] = ok ? abg[s] : 0.0f;
    sBeta[tid] = ok ? abg[plane + s] : 0.0f;
    sGamma[tid] = ok ? abg[2 * plane + s] : 0.0f;
  }
  __syncthreads();  // visible even when cols == 0 skips the column loop

  // kernel-tile mapping: a 16 x 16 thread grid, 4 x 4 entries per thread
  const int ty = tid / 16;
  const int tx = tid % 16;
  // product mapping: column pc of the t-block, rows pr + RG * r
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

    // ---- the column tile of D', recomputed from the old column state;
    //      rows >= cols and columns >= t read as 0 --------------------------
    for (int e = tid; e < BM * BT; e += NT) {
      const int r = e / BT, c = e % BT;
      const int gj = j0 + r, gc = t0 + c;
      float dn = 0.0f;
      if (gj < cols && gc < t) {
        const long long idx = col_base + static_cast<long long>(gj) * t + gc;
        const float rn = advance_r(Rc[idx], sAlpha[c], Vc[idx]);
        dn = advance_d(rn, Dc[idx], sBeta[c], sGamma[c]);
      }
      sM[r][c] = dn;
    }
    __syncthreads();  // norms and the D' tile are visible

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

    // ---- tile x D', f32 FMA into the register accumulator ----------------
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

  // ---- this block's rows: the prologue, the stores, the reductions -------
  const int gc = t0 + pc;
  const float alpha = sAlpha[pc], beta = sBeta[pc], gamma = sGamma[pc];
  float dv = 0.0f, rr = 0.0f, rv = 0.0f, vv = 0.0f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gi = i0 + pr + RG * r;
    if (gi < rows && gc < t) {
      const long long idx = row_base + static_cast<long long>(gi) * t + gc;
      const float dold = D[idx];
      const float rn = advance_r(R[idx], alpha, V[idx]);
      const float dn = advance_d(rn, dold, beta, gamma);
      const float vn = acc[r];
      Uo[idx] = fmaf(alpha, dold, U[idx]);
      Ro[idx] = rn;
      Do[idx] = dn;
      Vo[idx] = vn;
      dv = fmaf(dn, vn, dv);
      rr = fmaf(rn, rn, rr);
      rv = fmaf(rn, vn, rv);
      vv = fmaf(vn, vn, vv);
    }
  }
  sRed[0][pr][pc] = dv;
  sRed[1][pr][pc] = rr;
  sRed[2][pr][pc] = rv;
  sRed[3][pr][pc] = vv;
  __syncthreads();
  if (tid < 4 * BT) {
    const int q = tid / BT, c = tid % BT;
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < RG; ++g) s += sRed[q][g][c];  // fixed order
    if (t0 + c < t) {
      partial[((static_cast<long long>(blockIdx.x) * batch + b) * 4 + q) * t +
              t0 + c] = s;
    }
  }
}

template <int KT, int BT>
void launch_kt(dim3 grid, cudaStream_t stream, const float* X1,
               const float* X2, const float* U, const float* R,
               const float* D, const float* V, const float* Rc,
               const float* Dc, const float* Vc, const float* abg,
               const float* scal, float* Uo, float* Ro, float* Do, float* Vo,
               float* partial, int rows, int cols, int d, int t, int batch,
               int row_offset) {
  fused_cg_step_kernel<KT, BT><<<grid, NT, 0, stream>>>(
      X1, X2, U, R, D, V, Rc, Dc, Vc, abg, scal, Uo, Ro, Do, Vo, partial,
      rows, cols, d, t, batch, row_offset);
}

template <int BT>
void launch_bt(int kernel_type, dim3 grid, cudaStream_t stream,
               const float* X1, const float* X2, const float* U,
               const float* R, const float* D, const float* V,
               const float* Rc, const float* Dc, const float* Vc,
               const float* abg, const float* scal, float* Uo, float* Ro,
               float* Do, float* Vo, float* partial, int rows, int cols,
               int d, int t, int batch, int row_offset) {
  switch (kernel_type) {
    case RBF:
      launch_kt<RBF, BT>(grid, stream, X1, X2, U, R, D, V, Rc, Dc, Vc, abg,
                         scal, Uo, Ro, Do, Vo, partial, rows, cols, d, t,
                         batch, row_offset);
      break;
    case MATERN12:
      launch_kt<MATERN12, BT>(grid, stream, X1, X2, U, R, D, V, Rc, Dc, Vc,
                              abg, scal, Uo, Ro, Do, Vo, partial, rows, cols,
                              d, t, batch, row_offset);
      break;
    case MATERN32:
      launch_kt<MATERN32, BT>(grid, stream, X1, X2, U, R, D, V, Rc, Dc, Vc,
                              abg, scal, Uo, Ro, Do, Vo, partial, rows, cols,
                              d, t, batch, row_offset);
      break;
    default:
      launch_kt<MATERN52, BT>(grid, stream, X1, X2, U, R, D, V, Rc, Dc, Vc,
                              abg, scal, Uo, Ro, Do, Vo, partial, rows, cols,
                              d, t, batch, row_offset);
      break;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays: X1 (rows, d), X2 (cols, d); the state
// U, R, D, V and the outputs Uo, Ro, Do, Vo (batch, rows, t), which must
// not overlap the inputs; the column state Rc, Dc, Vc (batch, cols, t),
// which may be the same arrays as R, D, V; abg (3, batch, t) = [alpha;
// beta; gamma]; scal = [outputscale, sigma2]; partial, scratch of
// (ceil(rows / 64), batch, 4, t); red (batch, 4, t), the output
// reductions.  Returns cudaGetLastError() after the two launches (0 = ok),
// or cudaErrorInvalidValue for arguments the kernel does not take.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + BN - 1) / BN;
  if (t <= 16) {
    dim3 grid(row_blocks, (t + 15) / 16, batch);
    launch_bt<16>(kernel_type, grid, s, X1, X2, U, R, D, V, Rc, Dc, Vc, abg,
                  scal, Uo, Ro, Do, Vo, partial, rows, cols, d, t, batch,
                  row_offset);
  } else if (t <= 32) {
    dim3 grid(row_blocks, (t + 31) / 32, batch);
    launch_bt<32>(kernel_type, grid, s, X1, X2, U, R, D, V, Rc, Dc, Vc, abg,
                  scal, Uo, Ro, Do, Vo, partial, rows, cols, d, t, batch,
                  row_offset);
  } else {
    dim3 grid(row_blocks, (t + 63) / 64, batch);
    launch_bt<64>(kernel_type, grid, s, X1, X2, U, R, D, V, Rc, Dc, Vc, abg,
                  scal, Uo, Ro, Do, Vo, partial, rows, cols, d, t, batch,
                  row_offset);
  }
  const int m = batch * 4 * t;
  fold_partials_kernel<<<m, FOLD_THREADS, 0, s>>>(partial, red, row_blocks, m);
  return static_cast<int>(cudaGetLastError());
}
