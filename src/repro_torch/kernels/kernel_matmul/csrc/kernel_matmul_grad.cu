// Gradient of the kernel-matrix matmul with respect to its inputs, for
// Hopper (sm_90a), K never formed.  For prescaled inputs X1 (rows, d),
// X2 (cols, d), weights w_ij = <A_i, B_j> from A (rows, k) and B (cols, k)
// and a stationary kernel k = outputscale * f(|x - x'|^2):
//
//     G_i = sum_j w_ij * dk(x1_i, x2_j)/dx1_i
//         = sum_j w_ij * outputscale * 2 f'(r_ij^2) * (x1_i - x2_j)
//     g   = sum_ij w_ij * f(r_ij^2)
//
// With A the cotangent C of out = K @ M and B = M this is the
// vector-Jacobian product of B1 for its row inputs and its outputscale;
// with the roles of (X1, A) and (X2, B) swapped, the column inputs'.  When
// X1 and X2 are one X (training), A = [C | M] and B = [M | C] (k = 2t)
// give the gradient for the shared X in one launch, every pair's
// difference, distance and f' formed once: w_ij = <C_i, M_j> + <M_i, C_j>,
// and g is twice d/d outputscale (f is symmetric).  Autograd carries G
// through X / lengthscale to the lengthscale (scalar or ARD) and on to the
// raw parameters.
//
// Port-only: the reference takes this gradient from jax.vjp through its
// blackbox matmul (src/repro/core/inference.py:641) and has no TPU kernel
// for it.
//
// What bounds it on an H100: operations.  Per kernel entry: d differences
// and d FMAs for the distance, f, f' and the coefficient (~20, one exp on
// the SFU), d FMAs for the gradient sum, all f32 on the CUDA cores; and
// 2k flops for the weight.  ~5.6e10 CUDA-core and 5.8e10 weight flops per
// symmetric launch at n = 40,000, d = 8, t = 9, against ~4 MB of traffic.
// The design, B1's (tf32_tile.cuh) where it applies:
//
//   * one block of 8 warps owns 64 rows and keeps their G in registers
//     while it loops over all 64-column steps; warps 0-3 and 4-7 take the
//     first and the second 32 columns of every step, each warp 16 rows; the
//     two halves and the 4 lanes that share a row meet once at the end;
//   * the weights are a 16 x 32 tile per warp and step on the tensor cores,
//     3xTF32 mma.sync m16n8k8 with k padded to 8 (A's rows split by
//     rounding once per block into shared memory, B split by truncation at
//     each fragment load; each 4 k-steps into a zeroed fragment added in
//     IEEE f32).  Each thread then holds w_ij for its entries in the C
//     fragment's layout and forms those entries there;
//   * the distance from differences on the CUDA cores in f32, with DP (8
//     or 32 features, zero past d) a template parameter so the loops
//     unroll and G stays in registers.  At DP = 8 x1_i and the differences
//     live in registers too; wider rows re-form the differences from shared
//     memory and walk their entries in a loop rather than spill.  (x1_i -
//     x2_j) is exactly 0 at coincident points, and the Matern floor's clip
//     zeroes f' there, so Matern-1/2's unbounded f' never meets them (no
//     NaN, exactly 0); near-coincident points keep their exact difference;
//   * the X2 / B tiles stream through a 3-stage cp.async ring (X2 rows at a
//     stride of DP + 4 floats so the 4 rows a warp reads at once fall on
//     distinct banks; A / B rows at k + 4);
//   * the outputscale sum folds each block's entries in a fixed order into
//     one partial per block, and fold_partials_kernel sums the blocks in a
//     fixed order: no atomics.  k past 128 runs in launches of 128 weight
//     columns, each adding to the previous one's G and partials.

#include <cuda_runtime.h>

#include "tf32_tile.cuh"  // cp.async, the TF32 split, mma.sync, Walk, stage_tile

namespace {

constexpr int MAXD = 32;     // features the kernel takes
constexpr int GS = 3;        // stages of the X2 / B ring
constexpr int KC_MAX = 128;  // weight columns per launch

__host__ __device__ inline int k_pad(int kc) { return (kc + 7) & ~7; }
// Row stride of the A / B tiles: k + 4 puts the 8 rows x 4 columns of a
// fragment load on 32 distinct banks.
__host__ __device__ inline int ab_stride(int kp) { return kp + 4; }
// Row stride of the X2 tile.
__host__ __device__ constexpr int x2_stride(int dp) { return dp + 4; }

// DP > 8 parks each thread's 16 weights of a step in shared memory (16 x NT
// floats after the ring), so that its entries run in a loop, not unrolled.
inline size_t grad_smem_bytes(int dp, int kc) {
  const int lb = ab_stride(k_pad(kc));
  return sizeof(float) * (BN * dp + 2 * BN * lb + GS * BM * (x2_stride(dp) + lb) +
                          (dp > 8 ? 16 * NT : 0));
}

template <int KT, int DP>
__global__ void __launch_bounds__(NT, DP == 8 ? 2 : 1) kernel_matmul_grad_kernel(
    const float* __restrict__ X1, const float* __restrict__ X2, const float* __restrict__ A,
    const float* __restrict__ B, const float* __restrict__ scal, float* __restrict__ G,
    float* __restrict__ partial, int rows, int cols, int d, int lda, int k0, int kc,
    int accumulate, int flags) {
  constexpr int XS = x2_stride(DP);
  extern __shared__ __align__(16) float smem[];
  const int kp = k_pad(kc), lb = ab_stride(kp), ks = kp / 8;
  const int sf = BM * (XS + lb);
  float* sX1 = smem;           // BN x DP
  float* sAh = sX1 + BN * DP;  // BN x lb: A's rows, TF32 high halves ...
  float* sAl = sAh + BN * lb;  // ... and low halves
  float* ring = sAl + BN * lb;  // GS stages of [X2 tile BM x XS | B tile BM x lb]

  const float outputscale = scal[0];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int kh = warp / 4;  // this warp's half of every step: columns 32 kh .. 32 kh + 31
  const int ra = 16 * (warp % 4) + g;  // its rows: ra and ra + 8
  const int i0 = blockIdx.x * BN;
  const int steps = (cols + BM - 1) / BM;
  const bool xvec = flags & 1;
  const int mw = flags & 2 ? 4 : flags & 4 ? 2 : 1;  // floats per copy of B
  const Walk wx(xvec ? 2 : d), wb(kc / mw);

  // feature padding past d and weight padding past kc stay zero: cp.async
  // writes only inside them
  for (int e = tid; e < GS * sf; e += NT) ring[e] = 0.0f;
  for (int e = tid; e < BN * DP; e += NT) sX1[e] = 0.0f;
  __syncthreads();
  for (int st = 0; st < GS - 1; ++st) {
    if (st < steps) {
      stage_tile(ring + st * sf, ring + st * sf + BM * XS, X2, B, st * BM, k0, cols, d, XS, lda,
                 xvec, mw, wx, wb, lb);
    }
    cp_async_commit();
  }
  for (int e = tid; e < BN * d; e += NT) {
    const int r = e / d, k = e - r * d;
    sX1[r * DP + k] = i0 + r < rows ? X1[static_cast<long long>(i0 + r) * d + k] : 0.0f;
  }
  for (int e = tid; e < BN * kp; e += NT) {
    const int r = e / kp, k = e - r * kp;
    const float v =
        i0 + r < rows && k < kc ? A[static_cast<long long>(i0 + r) * lda + k0 + k] : 0.0f;
    const float hi = tf32(v);
    sAh[r * lb + k] = hi;
    sAl[r * lb + k] = tf32(v - hi);
  }
  __syncthreads();

  // DP = 8: the two rows' features and each entry's differences live in
  // registers, and the 16 entries of a step unroll; wider rows are read from
  // shared memory, the differences formed again for the gradient sum and
  // the entries walked in a loop, so that G alone holds registers
  constexpr bool KEEP = DP == 8;
  float xi[2][KEEP ? DP : 1];
  if constexpr (KEEP) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < DP; ++k) xi[r][k] = sX1[(ra + 8 * r) * DP + k];
    }
  }
  float* sW = ring + GS * sf;  // DP > 8: 16 x NT, this thread's weights in column tid
  float gacc[2][DP];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < DP; ++k) gacc[r][k] = 0.0f;
  }
  float fsum = 0.0f;  // this thread's share of sum w_ij f(r_ij^2)
  const float* pah = sAh + ra * lb + c;
  const float* pal = sAl + ra * lb + c;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<GS - 2>();
    __syncthreads();  // tile s is staged; step s - 1 is done with its stage
    {
      const int next = s + GS - 1;
      if (next < steps) {
        float* st = ring + (next % GS) * sf;
        stage_tile(st, st + BM * XS, X2, B, next * BM, k0, cols, d, XS, lda, xvec, mw, wx, wb,
                   lb);
      }
      cp_async_commit();
    }
    const float* x2 = ring + (s % GS) * sf;
    const float* pb = x2 + BM * XS + (32 * kh + g) * lb + c;

    // w[n][e]: row ra + 8 (e / 2), column 32 kh + 8 n + 2 c + e % 2
    float w[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[n][e] = 0.0f;
    }
    for (int q0 = 0; q0 < ks; q0 += 4) {
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
      }
      const int q1 = min(q0 + 4, ks);
      for (int kq = q0; kq < q1; ++kq) {
        const int o = 8 * kq;
        const uint32_t ah[4] = {__float_as_uint(pah[o]), __float_as_uint(pah[8 * lb + o]),
                                __float_as_uint(pah[o + 4]),
                                __float_as_uint(pah[8 * lb + o + 4])};
        const uint32_t al[4] = {__float_as_uint(pal[o]), __float_as_uint(pal[8 * lb + o]),
                                __float_as_uint(pal[o + 4]),
                                __float_as_uint(pal[8 * lb + o + 4])};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float b0 = pb[8 * n * lb + o], b1 = pb[8 * n * lb + o + 4];
          const float h0 = tf32_trunc(b0), h1 = tf32_trunc(b1);
          mma_tf32(part[n], al, h0, h1);
          mma_tf32(part[n], ah, tf32_trunc(b0 - h0), tf32_trunc(b1 - h1));
          mma_tf32(part[n], ah, h0, h1);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[n][e] += part[n][e];
      }
    }

    // this thread's 16 entries: distance from differences, f and 2 f', the
    // outputscale sum and G.  Rows >= rows and columns >= cols carry w = 0
    // (A, B read as 0) and finite f, f', so they add exactly 0.
    if constexpr (KEEP) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const float* xj = x2 + (32 * kh + 8 * n + 2 * c + e % 2) * XS;
          float diff[DP];
          float d2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DP; k += 4) {
            const float4 y = *reinterpret_cast<const float4*>(xj + k);
            diff[k] = xi[r][k] - y.x;
            diff[k + 1] = xi[r][k + 1] - y.y;
            diff[k + 2] = xi[r][k + 2] - y.z;
            diff[k + 3] = xi[r][k + 3] - y.w;
          }
#pragma unroll
          for (int k = 0; k < DP; ++k) d2 = fmaf(diff[k], diff[k], d2);
          float f, df2;
          stationary_grad<KT>(d2, &f, &df2);
          fsum = fmaf(w[n][e], f, fsum);
          const float coef = w[n][e] * outputscale * df2;
#pragma unroll
          for (int k = 0; k < DP; ++k) gacc[r][k] = fmaf(coef, diff[k], gacc[r][k]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sW[(4 * n + e) * NT + tid] = w[n][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* xr = sX1 + (ra + 8 * r) * DP;
#pragma unroll 1
        for (int q = 0; q < 8; ++q) {  // column 8 (q / 2) + 2 c + q % 2 of the half
          const int n = q / 2, h = q % 2;
          const float wv = sW[(4 * n + 2 * r + h) * NT + tid];
          const float* xj = x2 + (32 * kh + 8 * n + 2 * c + h) * XS;
          float d2 = 0.0f;
#pragma unroll
          for (int k = 0; k < DP; k += 4) {
            const float4 x = *reinterpret_cast<const float4*>(xr + k);
            const float4 y = *reinterpret_cast<const float4*>(xj + k);
            const float a0 = x.x - y.x, a1 = x.y - y.y, a2 = x.z - y.z, a3 = x.w - y.w;
            d2 = fmaf(a0, a0, d2);
            d2 = fmaf(a1, a1, d2);
            d2 = fmaf(a2, a2, d2);
            d2 = fmaf(a3, a3, d2);
          }
          float f, df2;
          stationary_grad<KT>(d2, &f, &df2);
          fsum = fmaf(wv, f, fsum);
          const float coef = wv * outputscale * df2;
#pragma unroll
          for (int k = 0; k < DP; k += 4) {
            const float4 x = *reinterpret_cast<const float4*>(xr + k);
            const float4 y = *reinterpret_cast<const float4*>(xj + k);
            gacc[r][k] = fmaf(coef, x.x - y.x, gacc[r][k]);
            gacc[r][k + 1] = fmaf(coef, x.y - y.y, gacc[r][k + 1]);
            gacc[r][k + 2] = fmaf(coef, x.z - y.z, gacc[r][k + 2]);
            gacc[r][k + 3] = fmaf(coef, x.w - y.w, gacc[r][k + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the 4 lanes of a row add their sums (a fixed pairing: every lane gets
  // the same bits), the second half's warps leave theirs in shared memory,
  // the first half's add them and store; lane c stores features c, c + 4..
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < DP; ++k) {
      gacc[r][k] += __shfl_xor_sync(0xffffffffu, gacc[r][k], 1);
      gacc[r][k] += __shfl_xor_sync(0xffffffffu, gacc[r][k], 2);
    }
  }
  float* red = ring;               // BN x DP
  float* sRed = ring + BN * DP;    // NT
  if (kh == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        if ((k & 3) == c) red[(ra + 8 * r) * DP + k] = gacc[r][k];
      }
    }
  }
  sRed[tid] = fsum;
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gi = i0 + ra + 8 * r;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        if ((k & 3) == c && k < d && gi < rows) {
          const float v = gacc[r][k] + red[(ra + 8 * r) * DP + k];
          const long long idx = static_cast<long long>(gi) * d + k;
          G[idx] = accumulate ? G[idx] + v : v;
        }
      }
    }
  }
  for (int h = NT / 2; h > 0; h /= 2) {  // fixed pairing
    if (tid < h) sRed[tid] += sRed[tid + h];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x] = accumulate ? partial[blockIdx.x] + sRed[0] : sRed[0];
}

template <int DP>
cudaError_t launch(int kernel_type, int row_blocks, cudaStream_t stream, const float* X1,
                   const float* X2, const float* A, const float* B, const float* scal,
                   float* G, float* partial, int rows, int cols, int d, int lda, int k0, int kc,
                   int accumulate, int flags) {
  auto kern = kernel_matmul_grad_kernel<MATERN52, DP>;
  switch (kernel_type) {
    case RBF: kern = kernel_matmul_grad_kernel<RBF, DP>; break;
    case MATERN12: kern = kernel_matmul_grad_kernel<MATERN12, DP>; break;
    case MATERN32: kern = kernel_matmul_grad_kernel<MATERN32, DP>; break;
    default: break;
  }
  const size_t smem = grad_smem_bytes(DP, kc);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<row_blocks, NT, smem, stream>>>(X1, X2, A, B, scal, G, partial, rows, cols, d, lda, k0,
                                         kc, accumulate, flags);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers to contiguous f32 arrays: X1 (rows, d), X2 (cols, d), A
// (rows, t), B (cols, t); scal = [outputscale, ...]; G (rows, d), the
// output; partial, scratch of ceil(rows / 64) floats; gsum, one float, the
// output sum_ij w_ij f(r_ij^2).  d must be at most 32.  t up to 128 is one
// launch of the gradient kernel, each further 128 one more.  Returns
// cudaGetLastError() after the launches (0 = ok), or cudaErrorInvalidValue
// for arguments the kernel does not take.
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
  for (int k0 = 0; k0 < t; k0 += KC_MAX) {
    const int kc = min(KC_MAX, t - k0);
    const int flags = staging_flags(X2, B + k0, d, t);
    const int acc = k0 > 0;
    const cudaError_t err =
        d <= 8 ? launch<8>(kernel_type, row_blocks, s, X1, X2, A, B, scal, G, partial, rows,
                           cols, d, t, k0, kc, acc, flags)
               : launch<32>(kernel_type, row_blocks, s, X1, X2, A, B, scal, G, partial, rows,
                            cols, d, t, k0, kc, acc, flags);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fold_partials_kernel<<<1, FOLD_THREADS, 0, s>>>(partial, gsum, row_blocks, 1);
  return static_cast<int>(cudaGetLastError());
}
