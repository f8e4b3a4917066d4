// Device functions shared by the kernel-matrix kernels of this directory:
// the stationary kernel map, its derivative, the CG state advance and the
// fixed-order fold of per-block partial sums.  Each .cu file is its own
// library, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

namespace {

enum KernelType { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

// The SFU's exp (as __expf: ex2 of x log2 e) and reciprocal square root,
// flushing subnormals to 0.  For normal arguments and results they equal
// __expf / rsqrtf; they skip the subnormal fix-ups that the default
// (no -ftz) compilation wraps around every call.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Squared distance -> kernel value, with the Matern family's sqrt floor of
// 1e-20 (the reference's _apply_stationary).  The map is most of a tile's
// instructions, so it uses the hardware's approximate exp and reciprocal
// square root (a few ulp, far inside the 2e-4 the kernels are held to;
// kernel values below 1.2e-38 flush to 0) and multiplies by 1/3 instead of
// dividing by 3.
template <int KT>
__device__ __forceinline__ float stationary(float d2, float outputscale) {
  if (KT == RBF) {
    return outputscale * exp_ftz(-0.5f * d2);
  }
  const float r2 = fmaxf(d2, 1e-20f);
  const float d = r2 * rsqrt_ftz(r2);
  if (KT == MATERN12) {
    return outputscale * exp_ftz(-d);
  }
  if (KT == MATERN32) {
    const float a = 1.7320508075688772f * d;
    return outputscale * (1.0f + a) * exp_ftz(-a);
  }
  const float a = 2.23606797749979f * d;
  return outputscale * (1.0f + a + a * a * (1.0f / 3.0f)) * exp_ftz(-a);
}

// The unit-outputscale kernel value f(r^2) and 2 f'(r^2), so that
// dk(x, x')/dx = outputscale * 2 f'(r^2) * (x - x').  Below the Matern
// floor (r^2 < 1e-20) the floor's clip has zero derivative, as under
// autodiff of the reference, so coincident points contribute exactly 0
// (Matern-1/2's f' = -e^-r / 2r is unbounded there).
template <int KT>
__device__ __forceinline__ void stationary_grad(float d2, float* f, float* df2) {
  if (KT == RBF) {
    *f = __expf(-0.5f * d2);
    *df2 = -*f;
    return;
  }
  const bool clipped = d2 < 1e-20f;
  const float r2 = fmaxf(d2, 1e-20f);
  const float rinv = rsqrtf(r2);
  const float d = r2 * rinv;
  float g;
  if (KT == MATERN12) {
    const float e = __expf(-d);
    *f = e;
    g = -e * rinv;  // 2 * (-e^-r / 2r)
  } else if (KT == MATERN32) {
    const float a = 1.7320508075688772f * d;
    const float e = __expf(-a);
    *f = (1.0f + a) * e;
    g = -3.0f * e;
  } else {
    const float a = 2.23606797749979f * d;
    const float e = __expf(-a);
    *f = (1.0f + a + a * a * (1.0f / 3.0f)) * e;
    g = -(5.0f / 3.0f) * (1.0f + a) * e;
  }
  *df2 = clipped ? 0.0f : g;
}

// The CG state advance, one function for every place that applies it (the
// fused step's own rows and its recomputed column tiles), so both round
// alike:  r' = r - alpha v,  d' = gamma r' + beta d.
__device__ __forceinline__ float advance_r(float r, float alpha, float v) {
  return fmaf(-alpha, v, r);
}
__device__ __forceinline__ float advance_d(float rn, float d, float beta,
                                           float gamma) {
  return fmaf(gamma, rn, beta * d);
}

constexpr int FOLD_THREADS = 256;

// out[k] = sum over blk < blocks of partial[blk * m + k], one block per k.
// Each thread sums a fixed stride of blocks in order and the block halves
// the 256 partial sums in a fixed pairing: the result does not depend on
// scheduling, so two runs on the same inputs agree bit for bit (no
// atomics).
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_partials_kernel(const float* __restrict__ partial,
                         float* __restrict__ out, int blocks, int m) {
  __shared__ float s[FOLD_THREADS];
  const int k = blockIdx.x;
  float acc = 0.0f;
  for (int blk = threadIdx.x; blk < blocks; blk += FOLD_THREADS) {
    acc += partial[static_cast<long long>(blk) * m + k];
  }
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = FOLD_THREADS / 2; h > 0; h /= 2) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = s[0];
}

}  // namespace
