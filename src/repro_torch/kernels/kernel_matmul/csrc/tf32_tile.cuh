// The tensor-core tile loop of the kernel-matrix kernels, shared by
// kernel_matmul.cu (B1/B2), fused_cg_step.cu (B3) and kernel_matmul_grad.cu:
// cp.async staging through a ring of X2 / right-hand-side tiles, the 3xTF32
// split, mma.sync m16n8k8 tf32, the f32 distance as one fmaf chain, and the
// kernel entries formed directly in the A-fragment layout.  The design and
// the reasons for it are in kernel_matmul.cu's header comment.  Each .cu
// file is its own library, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"  // KernelType, stationary()

namespace {

constexpr int BN = 64;   // output rows per block: 4 row groups of 16
constexpr int BM = 64;   // X2 rows / M rows per column step: 8 k-steps of 8
constexpr int NT = 256;  // 8 warps: row group w % 4, k-half w / 4
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use

// Row stride (floats) of an M tile of TB columns: TB + 8 puts the 4 k-rows
// x 8 columns of a B fragment load on 32 distinct banks.
__host__ __device__ constexpr int m_stride(int tb) { return tb + 8; }

// Stages of the X2 / M ring: deeper for narrow tiles, whose steps are short.
__host__ __device__ constexpr int stages(int tb) { return tb <= 64 ? 4 : tb == 128 ? 3 : 2; }

// Row stride (floats) of the X tiles: 8 on the d <= 8 path, else d rounded
// up to 4 for float4 reads.
__host__ __device__ inline int x_stride(int d, bool d8) { return d8 ? 8 : (d + 3) & ~3; }

// Floats of one ring stage: an X2 tile and an M tile.
__host__ __device__ inline int stage_floats(int tb, int dp) { return BM * (dp + m_stride(tb)); }

inline size_t smem_bytes(int tb, int d, bool d8) {
  const int dp = x_stride(d, d8);
  // the X1 tile and its norms, then the ring
  return sizeof(float) * (BN * (dp + 1) + static_cast<size_t>(stages(tb)) * stage_floats(tb, dp));
}

// The narrowest column block of 16 .. max_tb that holds t, halved while its
// shared memory does not fit (large d); 0 when even 16 columns do not fit.
inline int column_block(int d, int t, int max_tb) {
  const bool d8 = d <= 8;
  int tb = 16;
  while (tb < t && tb < max_tb) tb *= 2;
  while (tb > 16 && smem_bytes(tb, d, d8) > SMEM_MAX) tb /= 2;
  return smem_bytes(tb, d, d8) > SMEM_MAX ? 0 : tb;
}

// Wide staging copies: X2 rows by 16 bytes when d = 8; M rows by 16 bytes
// when t is a multiple of 4, by 8 when it is even.
inline int staging_flags(const float* X2, const float* M, int d, int t) {
  const uintptr_t m_align = reinterpret_cast<uintptr_t>(M);
  return (d == 8 && reinterpret_cast<uintptr_t>(X2) % 16 == 0 ? 1 : 0) |
         (t % 4 == 0 && m_align % 16 == 0 ? 2 : 0) | (t % 2 == 0 && m_align % 8 == 0 ? 4 : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-, 8- or 16-byte asynchronous copy; src_bytes = 0 zero-fills the
// destination.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else if (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 (three instructions in SASS)...
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ... and truncated toward zero (one instruction), for M's split, which
// runs at every fragment load: hi = trunc(m) and lo = trunc(m - hi) leave
// less than 2^-21 |m|.
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// c += a (16 x 8, row) b (8 x 8, col), TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// <a, b> over dp features (dp a multiple of 4, zero past d) as one fmaf
// chain from 0 in feature order: the norms use it too, so a row against
// itself gives |x|^2 bit for bit.  D8: dp is 8, unrolled.
template <bool D8>
__device__ __forceinline__ float dot(const float* a, const float* b, int dp) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < (D8 ? 8 : dp); k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + k);
    const float4 y = *reinterpret_cast<const float4*>(b + k);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// A thread's walk over the flat index e = tid, tid + NT, ... of a BM x w
// tile as (row, column), stepped without a division in the loop.
struct Walk {
  int r0, q0, dr, dq, w;
  __device__ explicit Walk(int width)
      : r0(threadIdx.x / width), q0(threadIdx.x % width), dr(NT / width), dq(NT % width),
        w(width) {}
  template <typename F>
  __device__ __forceinline__ void operator()(F&& f) const {
    int r = r0, q = q0;
    while (r < BM) {
      f(r, q);
      r += dr;
      q += dq;
      if (q >= w) {
        q -= w;
        ++r;
      }
    }
  }
};

// Stage column tile j0 (64 rows of X2, and of M's columns t0 .. t0 + tc)
// into sX2 / sM with cp.async: X2 rows as two 16-byte copies (xvec: d = 8
// and X2 16-byte aligned) or by element, M rows in copies of mw floats (4
// when t is a multiple of 4, 2 when it is even, else 1) at a row stride of
// ld floats.  Rows >= cols are zero-filled, M columns past tc are not
// written (the caller zeroes them once where they reach a product).
__device__ __forceinline__ void stage_tile(float* sX2, float* sM, const float* X2,
                                           const float* M, int j0, int t0, int cols, int d,
                                           int dp, int t, bool xvec, int mw, const Walk& wx,
                                           const Walk& wm, int ld) {
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
    const float* src = M + static_cast<long long>(ok ? j0 + r : 0) * t + t0;
    float* dst = sM + r * ld;
    if (mw == 4) {
      cp_async<16>(dst + 4 * q, src + 4 * q, ok ? 16 : 0);
    } else if (mw == 2) {
      cp_async<8>(dst + 2 * q, src + 2 * q, ok ? 8 : 0);
    } else {
      cp_async<4>(dst + q, src + q, ok ? 4 : 0);
    }
  });
}

// The kernel entries of one step for this thread, split into TF32 halves:
// for each of its warps' 4 k-steps kq, rows (ra, ra + 8) x columns (ca,
// ca + 4), ca = 32 kh + 8 kq + c, in the m16n8k8 A-fragment order.  Lane
// (g, c) takes the norm of column 32 kh + 4 g + c and the 8 lanes of a c
// share them by shuffles (the same fmaf chain as the inner products).
template <int KT, bool D8>
__device__ __forceinline__ void entries(uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                        const float* x2, const float* x1a, const float* x1b,
                                        float n1a, float n1b, int dp, int kh, int g, int c,
                                        int gra, int j0, int cols, float outputscale,
                                        float sigma2) {
  const float* mine = x2 + (32 * kh + 4 * g + c) * dp;
  const float n2_mine = dot<D8>(mine, mine, dp);
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lc = 32 * kh + 8 * kq + 4 * h + c;
      const float n2 = __shfl_sync(0xffffffffu, n2_mine, 4 * (2 * kq + h) + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inner = dot<D8>(r ? x1b : x1a, x2 + lc * dp, dp);
        const float d2 = fmaxf((r ? n1b : n1a) + n2 - 2.0f * inner, 0.0f);
        float v = stationary<KT>(d2, outputscale);
        if (gra + 8 * r == j0 + lc) v += sigma2;
        v = j0 + lc < cols ? v : 0.0f;
        const float hi = tf32(v);
        ah[kq][2 * h + r] = __float_as_uint(hi);
        al[kq][2 * h + r] = __float_as_uint(tf32(v - hi));
      }
    }
  }
}

// B1's kernel body for one block: rows i0 .. i0 + 63 of (K(X1, X2) +
// sigma2 [row_offset + i == j]) @ M[:, t0 .. t0 + TB) of batch element
// blockIdx.z, every 64-column step of X2 / M through the cp.async ring.
// Then, with the ring's copies landed and the block synchronised,
// epi(acc, ring, kh, ra, c, nch, i0, t0, b, out): this warp's acc[n][e]
// holds row ra + 8 (e / 2), column 8 n + 2 c + e % 2 summed over its
// k-half kh of every step (warps 0-3 the first 32 columns, 4-7 the second),
// the ring (at least 4 BM (TB + 16) floats) is free to reuse, and M and
// out have been advanced to batch element b.  The epilogue adds the two
// halves and stores.
template <int KT, int TB, bool D8, typename Epilogue>
__device__ __forceinline__ void tile_kernel(const float* __restrict__ X1,
                                            const float* __restrict__ X2,
                                            const float* __restrict__ M,
                                            const float* __restrict__ scal,
                                            float* __restrict__ out, int rows, int cols, int d,
                                            int t, int row_offset, int flags, Epilogue epi) {
  constexpr int NCH = TB / 8;           // n8 tiles of the accumulator
  constexpr int G = NCH < 4 ? NCH : 4;  // n8 tiles whose mma chains interleave
  constexpr int LD = m_stride(TB);
  constexpr int S = stages(TB);
  extern __shared__ __align__(16) float smem[];
  const int dp = x_stride(d, D8);
  const int sf = stage_floats(TB, dp);
  float* sX1 = smem;            // BN x dp
  float* sN1 = sX1 + BN * dp;   // BN
  float* ring = sN1 + BN;       // S stages of [X2 tile BM x dp | M tile BM x LD]

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
  M += b * static_cast<long long>(cols) * t;
  out += b * static_cast<long long>(rows) * t;
  const int tc = min(TB, t - t0);  // columns of M this block reads
  const int nch = (tc + 7) / 8;    // n8 tiles holding them
  const int steps = (cols + BM - 1) / BM;
  const bool xvec = flags & 1;
  const int mw = flags & 2 ? 4 : flags & 4 ? 2 : 1;  // floats per copy of M
  const Walk wx(xvec ? 2 : d), wm(tc / mw);

  // the X tiles' feature padding stays zero: cp.async writes only k < d
  for (int e = tid; e < BN * dp; e += NT) sX1[e] = 0.0f;
  for (int st = 0; st < S; ++st) {
    for (int e = tid; e < BM * dp; e += NT) ring[st * sf + e] = 0.0f;
  }
  __syncthreads();
  for (int st = 0; st < S - 1; ++st) {
    if (st < steps) {
      stage_tile(ring + st * sf, ring + st * sf + BM * dp, X2, M, st * BM, t0, cols, d, dp, t,
                 xvec, mw, wx, wm, LD);
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

  for (int s = 0; s < steps; ++s) {
    const int j0 = s * BM;
    cp_async_wait<S - 2>();
    __syncthreads();  // tile s is staged; step s - 1 is done with its stage
    {
      const int next = s + S - 1;
      if (next < steps) {
        float* st = ring + (next % S) * sf;
        stage_tile(st, st + BM * dp, X2, M, next * BM, t0, cols, d, dp, t, xvec, mw, wx, wm,
                   LD);
      }
      cp_async_commit();
    }
    const float* x2 = ring + (s % S) * sf;
    const float* sM = x2 + BM * dp;

    // kernel entries and their TF32 halves
    uint32_t a_hi[4][4], a_lo[4][4];
    entries<KT, D8>(a_hi, a_lo, x2, x1a, x1b, n1[0], n1[1], dp, kh, g, c, gra, j0, cols,
                    outputscale, sigma2);

    // the product, G n8 tiles at a time so that their mma chains
    // interleave; M's TF32 halves are taken as its fragments are loaded.
    // The tensor cores add into their f32 accumulator by truncation, so
    // each tile's 12 mma of this step go into a zeroed fragment that is
    // then added to acc in IEEE f32.
    const float* mb = sM + (32 * kh + c) * LD + g;
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
        for (int kq = 0; kq < 4; ++kq) {
          float h0[G], h1[G], l0[G], l1[G];
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float m0 = mb[8 * kq * LD + 8 * (n0 + gi)];
            const float m1 = mb[(8 * kq + 4) * LD + 8 * (n0 + gi)];
            h0[gi] = tf32_trunc(m0);
            h1[gi] = tf32_trunc(m1);
            l0[gi] = tf32_trunc(m0 - h0[gi]);
            l1[gi] = tf32_trunc(m1 - h1[gi]);
          }
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (n0 + gi < nch) mma_tf32(part[gi], a_lo[kq], h0[gi], h1[gi]);
          }
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (n0 + gi < nch) mma_tf32(part[gi], a_hi[kq], l0[gi], l1[gi]);
          }
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (n0 + gi < nch) mma_tf32(part[gi], a_hi[kq], h0[gi], h1[gi]);
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
