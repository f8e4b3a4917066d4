// The ends of the f32 kernel-matrix tile loop (tile_kernel in
// tf32_tile.cuh), shared by f32 B1 and B3: the two k-halves of a block
// meet through shared memory (the
// second half's warps leave their sums in `red`, BN x TB, the first half's
// add them in that fixed order), then B1 stores its outputs and B3 stores
// V' and one partial per row block of its four reductions.  Each .cu file
// is its own library, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

#include "tf32_tile.cuh"  // BN, NT

namespace {

// B1: out[i0 + li][t0 + lc] = the block's sum, for rows < rows, columns < t.
template <int TB, int NCH>
__device__ __forceinline__ void store_product(float (&acc)[NCH][4], float* red, int kh, int ra,
                                              int c, int nch, int i0, int t0, float* out,
                                              int rows, int t) {
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n < nch) red[(ra + 8 * (e / 2)) * TB + 8 * n + 2 * c + e % 2] = acc[n][e];
      }
    }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = ra + 8 * (e / 2);
        const int lc = 8 * n + 2 * c + e % 2;
        if (n < nch && i0 + li < rows && t0 + lc < t) {
          out[static_cast<long long>(i0 + li) * t + t0 + lc] = acc[n][e] + red[li * TB + lc];
        }
      }
    }
  }
}

// B3: V' as B1 stores its outputs, then the reductions [D'^T V'; R'^T R';
// R'^T V'; V'^T V'] over this block's rows < rows of batch element b, from
// V' (kept in shared memory) and the advance pass's R', D': thread (rg,
// col) sums rows rg, rg + RG, ... in order, then the RG sums of a column in
// order, into partial[row block][b][4][t].  The ring holds red, V' and the
// row-group sums: 2 BN TB + 4 NT floats.
template <int TB, int NCH>
__device__ __forceinline__ void store_cg_product(float (&acc)[NCH][4], float* red, int kh, int ra,
                                                 int c, int nch, int i0, int t0, long long b,
                                                 float* Vb, const float* __restrict__ Ro,
                                                 const float* __restrict__ Do,
                                                 float* __restrict__ partial, int rows, int t,
                                                 int batch) {
  constexpr int RG = NT / TB;  // row groups of the reductions
  float* sV = red + BN * TB;
  float* sRed = sV + BN * TB;  // [4][RG][TB]
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n < nch) red[(ra + 8 * (e / 2)) * TB + 8 * n + 2 * c + e % 2] = acc[n][e];
      }
    }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = ra + 8 * (e / 2);
        const int lc = 8 * n + 2 * c + e % 2;
        if (n < nch) {
          const float v = acc[n][e] + red[li * TB + lc];
          sV[li * TB + lc] = v;
          if (i0 + li < rows && t0 + lc < t) {
            Vb[static_cast<long long>(i0 + li) * t + t0 + lc] = v;
          }
        }
      }
    }
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int col = tid % TB, rg = tid / TB;
  const int gc = t0 + col;
  const long long row_base = b * rows * t;
  float dv = 0.0f, rr = 0.0f, rv = 0.0f, vv = 0.0f;
  if (gc < t) {
    for (int li = rg; li < BN && i0 + li < rows; li += RG) {
      const long long idx = row_base + static_cast<long long>(i0 + li) * t + gc;
      const float rn = Ro[idx], dn = Do[idx], vn = sV[li * TB + col];
      dv = fmaf(dn, vn, dv);
      rr = fmaf(rn, rn, rr);
      rv = fmaf(rn, vn, rv);
      vv = fmaf(vn, vn, vv);
    }
  }
  sRed[(0 * RG + rg) * TB + col] = dv;
  sRed[(1 * RG + rg) * TB + col] = rr;
  sRed[(2 * RG + rg) * TB + col] = rv;
  sRed[(3 * RG + rg) * TB + col] = vv;
  __syncthreads();
  if (tid < 4 * TB) {
    const int q = tid / TB, cc = tid % TB;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < RG; ++r) s += sRed[(q * RG + r) * TB + cc];  // fixed order
    if (t0 + cc < t) {
      partial[((static_cast<long long>(blockIdx.x) * batch + b) * 4 + q) * t + t0 + cc] = s;
    }
  }
}

}  // namespace
