// The bf16 tile loop of the kernel-matrix kernels under precision="mixed",
// shared by kernel_matmul_bf16.cu (B1/B2) and fused_cg_step_bf16.cu (B3).
//
// The same block as tf32_tile.cuh's tile_kernel (64 output rows, 8 warps in
// two k-halves, the X2 tiles through a cp.async ring, each thread forming
// its kernel entries in f32 directly in the mma A-fragment layout, IEEE
// partial sums), with the product as ONE bf16 mma.sync m16n8k16 per k16
// step and n8 tile in place of three TF32 m16n8k8 per k8 step:
//
//   * the entry is formed in f32 exactly as the f32 kernel forms it (|x|^2,
//     |x'|^2 and <x, x'> one fmaf chain each, so coincident points give
//     d2 = 0 exactly), then rounded to bf16 to nearest (cvt.rn.bf16x2.f32,
//     two entries to a register);
//   * the right-hand side comes as a bf16 copy with rows padded to tp (a
//     multiple of 8) columns: B1's wrapper makes it by one cast, B3's
//     advance pass writes it beside the f32 D'.  So every M row is staged
//     by 16-byte cp.async copies, and a stage holds half the bytes of the
//     f32 ring's; its row stride of TB + 8 values puts the 8 rows of an
//     ldmatrix on 8 distinct 16-byte bank groups;
//   * B fragments come from shared memory by ldmatrix.x4.trans, two n8
//     tiles x k16 a load (the M tile is row-major in k);
//   * the tensor cores add into their accumulator by truncation, so each
//     step's two k16 mma of a tile go into a zeroed fragment that is then
//     added to the accumulator in IEEE f32, as in the f32 kernel.
//
// A-fragment layout of m16n8k16 (lane = 4 g + c): register 0 holds row g,
// k columns 2c and 2c + 1 (the lower column in the low half), register 1
// row g + 8 at the same columns, registers 2 and 3 the same rows at 2c + 8
// and 2c + 9.  The f32 kernel's TF32 fragment holds columns c and c + 4.
//
// tf32_tile.cuh is included for its constants and helpers and is not
// changed: the f32 kernels compile as before.  Each .cu file is its own
// library, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_tile.cuh"  // BN, BM, NT, stages, x_stride, Walk, dot, cp_async, ...

namespace {

// Row stride (bf16 values) of a bf16 M tile of TB columns.
__host__ __device__ constexpr int mb_stride(int tb) { return tb + 8; }

// Floats of one ring stage: an X2 tile (f32) and a bf16 M tile (two values
// to a float).
__host__ __device__ inline int stage_floats_bf16(int tb, int dp) {
  return BM * dp + BM * mb_stride(tb) / 2;
}

// The X1 tile and its norms, then the larger of the ring and what the
// epilogues reuse of it (B3's: the second k-half's sums, V' and the
// reductions' row-group sums, 2 BN TB + 4 NT floats).
inline size_t smem_bytes_bf16(int tb, int d, bool d8) {
  const int dp = x_stride(d, d8);
  const size_t ring = static_cast<size_t>(stages(tb)) * stage_floats_bf16(tb, dp);
  const size_t epi = 2 * static_cast<size_t>(BN) * tb + 4 * NT;
  return sizeof(float) * (BN * (dp + 1) + (ring > epi ? ring : epi));
}

// The narrowest column block of 16 .. max_tb that holds t, halved while its
// shared memory does not fit (large d); 0 when even 16 columns do not fit.
inline int column_block_bf16(int d, int t, int max_tb) {
  const bool d8 = d <= 8;
  int tb = 16;
  while (tb < t && tb < max_tb) tb *= 2;
  while (tb > 16 && smem_bytes_bf16(tb, d, d8) > SMEM_MAX) tb /= 2;
  return smem_bytes_bf16(tb, d, d8) > SMEM_MAX ? 0 : tb;
}

// Two f32 values rounded to bf16 (to nearest, ties to even) and packed, lo
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit values, transposed: lanes 8q .. 8q + 7 give
// the row addresses of matrix q, and r[q] is this lane's fragment of it.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Stage column tile j0 into sX2 / sMb with cp.async: X2 rows as in
// stage_tile, and rows j0 .. j0 + 63 of the bf16 M (row stride tp values)
// from column t0 in 16-byte copies of 8 values, at a row stride of ldb
// values.  Rows >= cols are zero-filled; columns past the copies are not
// written (they reach only output columns the epilogue drops).
__device__ __forceinline__ void stage_tile_bf16(float* sX2, uint16_t* sMb, const float* X2,
                                                const uint16_t* Mb, int j0, int t0, int cols,
                                                int d, int dp, int tp, bool xvec, const Walk& wx,
                                                const Walk& wm, int ldb) {
  wx([&](int r, int q) {
    const bool ok = j0 + r < cols;
    const float* src = X2 + static_cast<long long>(ok ? j0 + r : 0) * d;
    if (xvec) {
      cp_async<16>(sX2 + r * dp + 4 * q, src + 4 * q, ok ? 16 : 0);
    } else {
      cp_async<4>(sX2 + r * dp + q, src + q, ok ? 4 : 0);
    }
  });
  wm([&](int r, int q) {
    const bool ok = j0 + r < cols;
    const uint16_t* src = Mb + static_cast<long long>(ok ? j0 + r : 0) * tp + t0 + 8 * q;
    cp_async<16>(sMb + r * ldb + 8 * q, src, ok ? 16 : 0);
  });
}

// The kernel entries of one step for this thread, rounded to bf16 and
// packed in the m16n8k16 A-fragment order: for each of its warp's 2 k16
// steps kk, rows (ra, ra + 8) x columns 32 kh + 16 kk + {2c, 2c + 1, 2c + 8,
// 2c + 9}.  Lane l takes the norm of column 32 kh + l and the lanes share
// them by shuffles (the same fmaf chain as the inner products).
template <int KT, bool D8>
__device__ __forceinline__ void entries_bf16(uint32_t (&a)[2][4], const float* x2,
                                             const float* x1a, const float* x1b, float n1a,
                                             float n1b, int dp, int kh, int lane, int c, int gra,
                                             int j0, int cols, float outputscale, float sigma2) {
  const float* mine = x2 + (32 * kh + lane) * dp;
  const float n2_mine = dot<D8>(mine, mine, dp);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2][2];  // [row ra + 8 r][column 2c + 8 h + p]
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int o = 16 * kk + 8 * h + 2 * c + p;  // column within the warp's 32
        const int lc = 32 * kh + o;
        const float n2 = __shfl_sync(0xffffffffu, n2_mine, o);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float inner = dot<D8>(r ? x1b : x1a, x2 + lc * dp, dp);
          const float d2 = fmaxf((r ? n1b : n1a) + n2 - 2.0f * inner, 0.0f);
          float val = stationary<KT>(d2, outputscale);
          if (gra + 8 * r == j0 + lc) val += sigma2;
          v[r][p] = j0 + lc < cols ? val : 0.0f;
        }
      }
      a[kk][2 * h] = pack_bf16x2(v[0][0], v[0][1]);
      a[kk][2 * h + 1] = pack_bf16x2(v[1][0], v[1][1]);
    }
  }
}

// tile_kernel with bf16 operands: rows i0 .. i0 + 63 of (K(X1, X2) + sigma2
// [row_offset + i == j]) @ Mb[:, t0 .. t0 + TB) of batch element blockIdx.z,
// Mb the bf16 copy of M, (batch, cols, tp).  The epilogue contract is
// tile_kernel's: epi(acc, ring, kh, ra, c, nch, i0, t0, b, out), the ring
// holding at least 2 BN TB + 4 NT floats.
template <int KT, int TB, bool D8, typename Epilogue>
__device__ __forceinline__ void tile_kernel_bf16(const float* __restrict__ X1,
                                                 const float* __restrict__ X2,
                                                 const uint16_t* __restrict__ Mb,
                                                 const float* __restrict__ scal,
                                                 float* __restrict__ out, int rows, int cols,
                                                 int d, int t, int tp, int row_offset,
                                                 bool xvec, Epilogue epi) {
  constexpr int NCH = TB / 8;           // n8 tiles of the accumulator (even)
  constexpr int G = NCH < 4 ? NCH : 4;  // n8 tiles of one partial group (even)
  constexpr int LDB = mb_stride(TB);
  constexpr int S = stages(TB);
  extern __shared__ __align__(16) float smem[];
  const int dp = x_stride(d, D8);
  const int sf = stage_floats_bf16(TB, dp);
  float* sX1 = smem;            // BN x dp
  float* sN1 = sX1 + BN * dp;   // BN
  float* ring = sN1 + BN;       // S stages of [X2 tile BM x dp | bf16 M tile BM x LDB]

  const float outputscale = scal[0];
  const float sigma2 = scal[1];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int kh = warp / 4;  // this warp's k-half of every step: columns 32 kh .. 32 kh + 31
  const int ra = 16 * (warp % 4) + g;  // its A-fragment rows: ra and ra + 8
  const int i0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * TB;
  const long long b = blockIdx.z;
  Mb += b * static_cast<long long>(cols) * tp;
  out += b * static_cast<long long>(rows) * t;
  const int tc = min(TB, t - t0);  // columns of M this block reads
  const int nch = (tc + 7) / 8;    // n8 tiles holding them
  const int steps = (cols + BM - 1) / BM;
  const Walk wx(xvec ? 2 : d), wm(nch);

  // the X tiles' feature padding stays zero: cp.async writes only k < d
  for (int e = tid; e < BN * dp; e += NT) sX1[e] = 0.0f;
  for (int st = 0; st < S; ++st) {
    for (int e = tid; e < BM * dp; e += NT) ring[st * sf + e] = 0.0f;
  }
  __syncthreads();
  for (int st = 0; st < S - 1; ++st) {
    if (st < steps) {
      stage_tile_bf16(ring + st * sf, reinterpret_cast<uint16_t*>(ring + st * sf + BM * dp), X2,
                      Mb, st * BM, t0, cols, d, dp, tp, xvec, wx, wm, LDB);
    }
    cp_async_commit();
  }
  for (int e = tid; e < BN * d; e += NT) {
    const int r = e / d, k = e - r * d;
    sX1[r * dp + k] = i0 + r < rows ? X1[static_cast<long long>(i0 + r) * d + k] : 0.0f;
  }
  __syncthreads();
  if (tid < BN) sN1[tid] = dot<false>(sX1 + tid * dp, sX1 + tid * dp, dp);
  __syncthreads();
  const float* x1a = sX1 + ra * dp;
  const float* x1b = x1a + 8 * dp;
  const float n1[2] = {sN1[ra], sN1[ra + 8]};

  const int gra = row_offset + i0 + ra;  // global row of ra (the sigma2 diagonal)
  float acc[NCH][4];
#pragma unroll
  for (int n = 0; n < NCH; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  // this lane's ldmatrix row: matrix q = lane / 8 covers k rows 8 (q % 2)
  // .. + 7 of a k16 step and n columns 8 (q / 2) .. + 7 of an n8 tile pair
  const int lm_off = (32 * kh + 8 * ((lane / 8) % 2) + lane % 8) * LDB + 8 * (lane / 16);

  for (int s = 0; s < steps; ++s) {
    const int j0 = s * BM;
    cp_async_wait<S - 2>();
    __syncthreads();  // tile s is staged; step s - 1 is done with its stage
    {
      const int next = s + S - 1;
      if (next < steps) {
        float* st = ring + (next % S) * sf;
        stage_tile_bf16(st, reinterpret_cast<uint16_t*>(st + BM * dp), X2, Mb, next * BM, t0,
                        cols, d, dp, tp, xvec, wx, wm, LDB);
      }
      cp_async_commit();
    }
    const float* x2 = ring + (s % S) * sf;
    const uint32_t mbase = smem_addr(reinterpret_cast<const uint16_t*>(x2 + BM * dp) + lm_off);

    uint32_t a[2][4];
    entries_bf16<KT, D8>(a, x2, x1a, x1b, n1[0], n1[1], dp, kh, lane, c, gra, j0, cols,
                         outputscale, sigma2);

    // the product, G n8 tiles at a time: one ldmatrix.x4.trans gives the B
    // fragments of two tiles, one mma per tile and k16 step, into a zeroed
    // fragment added to acc in IEEE f32
#pragma unroll
    for (int n0 = 0; n0 < NCH; n0 += G) {
      if (n0 < nch) {
        float part[G][4];
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[gi][e] = 0.0f;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int gi = 0; gi < G; gi += 2) {
            if (n0 + gi < nch) {
              uint32_t bq[4];
              ldmatrix_x4_trans(bq, mbase + 2 * (16 * kk * LDB + 8 * (n0 + gi)));
              mma_bf16(part[gi], a[kk], bq[0], bq[1]);
              if (n0 + gi + 1 < nch) mma_bf16(part[gi + 1], a[kk], bq[2], bq[3]);
            }
          }
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n0 + gi][e] += part[gi][e];
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  epi(acc, ring, kh, ra, c, nch, i0, t0, b, out);
}

}  // namespace
