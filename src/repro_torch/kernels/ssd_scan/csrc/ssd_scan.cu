// Chunked SSD (state-space duality) scan for Hopper (sm_90a), Mamba-2's
// sequence mixer:
//
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t (x_t (x) B_t)     state (dh x ds)
//     y_t = h_t C_t
//
// for x (b, h, l, dh), dt (b, h, l) f32, A (h,) f32 and B, C (b, l, ds)
// shared across heads, x / B / C / y in f32 or bf16, all math in f32.
//
// Replaces the TPU kernel ssd_scan_pallas
// (src/repro/kernels/ssd_scan/ssd_scan.py:91, body _ssd_kernel :29).  The
// same terms per chunk of c steps: the inclusive cumsum of dt A in chunk
// order (cum_i); the intra-chunk term (C B^T) o exp(seg_ij) o dt_j on the
// lower triangle times x; the inter-chunk term exp(cum_i) C h_prev^T; the
// carried state exp(cum_last) h_prev + sum_j exp(seg_last,j) dt_j x_j (x)
// B_j.  seg_ij = dt_{j+1} A + ... + dt_i A is summed directly, and only
// for i >= j (so no exponent is positive), where the TPU kernel takes
// cum_i - cum_j: cumulative sums reach -10^3 within a chunk at the
// model's decays, and their difference keeps only ~1e-4 absolute of a
// segment's sum, which the exp turns into a relative error of each decay.
//
// Work: per chunk 2 c^2 ds flops for C B^T, the same for every head, and
// per chunk and head 2 c^2 dh + 4 c dh ds, against x and y of (c dh)
// elements and B, C of (c ds): at the serving slice (b = 4, 112 heads,
// l = 512, dh = ds = 64, chunk 128, bf16) 7.5 GFLOP for 59 MB.  At the
// card's rates for these types (bf16 tensor cores, the products with an
// f32 operand as two bf16 products) the bytes bound it.  This first
// version runs every product in f32 on the CUDA cores and recomputes
// C B^T per head, as the TPU kernel does: c^2 ds of its c^2 (ds + dh) +
// 2 c dh ds multiply-adds, a third of the kernel's work (11.3 GFLOP).
//
// Design: one block of 256 threads owns one (batch, head) and walks its
// chunks in order (the TPU kernel's sequential grid axis), the (dh x ds)
// f32 state in shared memory, transposed.  Per chunk it stages x, C and
// B^T in shared memory as f32 (zero beyond the chunk, dh and ds, so the
// products need no guards; 16-byte loads, up to 4 in flight a thread, when
// rows are 16-byte aligned), one thread takes the cumsum in order while
// thread j sums column j's segments down the rows, and every product runs
// as 4 x 8 register tiles over shared memory with odd row strides
// (conflict-free per-lane rows, broadcast columns):
//   M = (C B^T) o decay o dt   (c x c, lower triangle),
//   y = M x + exp(cum) o (C H)  written to y,
//   H = exp(total) H + (B^T o coef) x.
// At c = 128, dh = ds = 64 that is 184 KB of dynamic shared memory, one
// block an SM.  The launch goes on the caller's stream and the entry point
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int RM = 4;    // rows of a thread's register tile
constexpr int RN = 8;    // columns of a thread's register tile
constexpr size_t MAX_SMEM = 232448;

struct Strides {
  long long xb, xh, xl, db, dh, dl, Bb, Bl, Cb, Cl, yb, yh, yl;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

constexpr int UNROLL = 4;  // 16-byte loads in flight per thread while staging

// The f32 values of the 16 bytes in `bits`: 4 floats or 8 bf16.
__device__ __forceinline__ void unpack(const uint4& bits, float* out, float) {
  const float4 v = *reinterpret_cast<const float4*>(&bits);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& bits, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&bits);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

// Stage rows [0, rows) of n elements of src (row stride `stride`; rows at
// or past `valid` read as 0) as f32: element (r, c) goes to dst[r * rs +
// c * cs], so a transposed copy is cs = ld, rs = 1.  With `vec` (16-byte
// aligned rows of a multiple of 16 bytes) each thread keeps up to UNROLL
// 16-byte loads in flight; otherwise one element a thread.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int rs, int cs, const T* __restrict__ src,
                                      long long stride, int rows, int valid, int n, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int nv = n / V;
    const int total = rows * nv;
    for (int base = threadIdx.x; base < total; base += NT * UNROLL) {
      uint4 buf[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * NT;
        buf[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total) {
          const int r = i / nv;
          if (r < valid) {
            buf[u] = __ldg(reinterpret_cast<const uint4*>(src + r * stride + (i - r * nv) * V));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * NT;
        if (i < total) {
          const int r = i / nv, c = (i - r * nv) * V;
          float f[V];
          unpack(buf[u], f, T());
#pragma unroll
          for (int e = 0; e < V; ++e) dst[r * rs + (c + e) * cs] = f[e];
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * n; i += NT) {
    const int r = i / n, c = i - r * n;
    dst[r * rs + c * cs] = r < valid ? to_f32(src[r * stride + c]) : 0.0f;
  }
}

// The shared-memory layout, in floats, for a chunk, head dim and state dim.
struct Layout {
  int cp, dhp, dsp;       // padded chunk, head dim and state dim
  int lc, lbt, lx, lm, lh;  // row strides (odd where rows are read per lane)
  int oC, oBt, oX, oM, oH, oDt, oCum, oE, oCoef, total;
  __host__ __device__ Layout(int chunk, int dh, int ds) {
    cp = round8(chunk);
    dhp = round8(dh);
    dsp = round8(ds);
    lc = dsp + 1;
    lbt = cp + 1;
    lx = dhp + 1;
    lm = cp + 1;
    lh = dhp + 1;
    oC = 0;
    oBt = oC + cp * lc;
    oX = oBt + dsp * lbt;
    oM = oX + cp * lx;
    oH = oM + cp * lm;
    oDt = oH + dsp * lh;
    oCum = oDt + cp;
    oE = oCum + cp;
    oCoef = oE + cp;
    total = oCoef + cp;
  }
};

// acc[a][b] += sum_k A(r0 + rstep a, k) * kscale[k] * B(k, c0 + b), A and B
// row-major in shared memory (kscale optional).
__device__ __forceinline__ void tile_mm(float (&acc)[RM][RN], const float* A, int lda,
                                        int r0, int rstep, const float* B, int ldb, int c0,
                                        int K, const float* kscale) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
    const float ks = kscale ? kscale[k] : 1.0f;
#pragma unroll
    for (int a = 0; a < RM; ++a) av[a] = A[(r0 + rstep * a) * lda + k] * ks;
#pragma unroll
    for (int b = 0; b < RN; ++b) bv[b] = B[k * ldb + c0 + b];
#pragma unroll
    for (int a = 0; a < RM; ++a) {
#pragma unroll
      for (int b = 0; b < RN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int a = 0; a < RM; ++a) {
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y, Strides st,
    int h, int l, int dh, int ds, int chunk, int vec) {
  extern __shared__ float smem[];
  const Layout L(chunk, dh, ds);
  float* sC = smem + L.oC;      // cp x lc      C of the chunk
  float* sBt = smem + L.oBt;    // dsp x lbt    B of the chunk, transposed
  float* sX = smem + L.oX;      // cp x lx      x of the chunk
  float* sM = smem + L.oM;      // cp x lm      the masked decay matrix
  float* sH = smem + L.oH;      // dsp x lh     the state, transposed (s, p)
  float* sDt = smem + L.oDt;    // dt of the chunk (0 past its end)
  float* sCum = smem + L.oCum;  // inclusive cumsum of dt A
  float* sE = smem + L.oE;      // exp(cum_i)
  float* sCoef = smem + L.oCoef;  // exp(seg from j + 1 to the chunk's end) dt_j

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  x += bi * st.xb + hi * st.xh;
  dt += bi * st.db + hi * st.dh;
  Bm += bi * st.Bb;
  Cm += bi * st.Cb;
  y += bi * st.yb + hi * st.yh;
  const float a_h = A[hi];
  const int cp = L.cp, dhp = L.dhp, dsp = L.dsp;

  // zero once: the state, and the padding of the staged tiles, which the
  // staging never writes
  for (int i = tid; i < L.total; i += NT) smem[i] = 0.0f;

  for (int c0 = 0; c0 < l; c0 += chunk) {
    const int len = min(chunk, l - c0);
    __syncthreads();  // the last chunk's reads of sX / sC / sBt / sM are done
    stage(sX, L.lx, 1, x + c0 * st.xl, st.xl, cp, len, dh, vec);
    stage(sC, L.lc, 1, Cm + c0 * st.Cl, st.Cl, cp, len, ds, vec);
    stage(sBt, 1, L.lbt, Bm + c0 * st.Bl, st.Bl, cp, len, ds, vec);
    for (int r = tid; r < cp; r += NT) sDt[r] = r < len ? dt[(c0 + r) * st.dl] : 0.0f;
    __syncthreads();
    // in chunk order, by the thread with the shortest column below; rows
    // past the end add dt = 0
    if (tid == NT - 1) {
      float c = 0.0f;
#pragma unroll 8
      for (int r = 0; r < cp; ++r) {
        c += sDt[r] * a_h;
        sCum[r] = c;
      }
    }
    // column j of the decay matrix, exp(seg_ij) dt_j for i >= j, with the
    // segment sum seg_ij = dt_{j+1} A + ... + dt_i A summed in order down
    // the column (never above the diagonal, so the exponent stays <= 0);
    // its last row is the carried state's coefficient
    for (int j = tid; j < cp; j += NT) {
      const float dtj = sDt[j];
      float seg = 0.0f;
      sM[j * L.lm + j] = dtj;
      for (int i = j + 1; i < cp; ++i) {
        seg += sDt[i] * a_h;
        sM[i * L.lm + j] = expf(seg) * dtj;
      }
      sCoef[j] = expf(seg) * dtj;
    }
    __syncthreads();
    const float total = sCum[cp - 1];
    for (int r = tid; r < cp; r += NT) sE[r] = expf(sCum[r]);

    // M = (C B^T) o exp(seg_ij) o dt_j on the lower triangle
    {
      const int rg = cp / RM, tiles = rg * (cp / RN);
      for (int t = tid; t < tiles; t += NT) {
        const int r0 = t % rg, cc = (t / rg) * RN;
        float acc[RM][RN];
        zero(acc);
        tile_mm(acc, sC, L.lc, r0, rg, sBt, L.lbt, cc, dsp, nullptr);
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          const int i = r0 + rg * a;
#pragma unroll
          for (int b = 0; b < RN; ++b) {
            const int j = cc + b;
            sM[i * L.lm + j] = j <= i ? acc[a][b] * sM[i * L.lm + j] : 0.0f;
          }
        }
      }
    }
    __syncthreads();

    // y = M x + exp(cum) o (C H), H the state before this chunk
    {
      const int rg = cp / RM, tiles = rg * (dhp / RN);
      for (int t = tid; t < tiles; t += NT) {
        const int r0 = t % rg, cc = (t / rg) * RN;
        float intra[RM][RN], inter[RM][RN];
        zero(intra);
        zero(inter);
        tile_mm(intra, sM, L.lm, r0, rg, sX, L.lx, cc, cp, nullptr);
        tile_mm(inter, sC, L.lc, r0, rg, sH, L.lh, cc, dsp, nullptr);
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          const int i = r0 + rg * a;
          if (i >= len) continue;
          T* yr = y + (c0 + i) * st.yl;
#pragma unroll
          for (int b = 0; b < RN; ++b) {
            const int p = cc + b;
            if (p < dh) yr[p] = from_f32<T>(intra[a][b] + sE[i] * inter[a][b]);
          }
        }
      }
    }
    __syncthreads();

    // H = exp(total) H + (B^T o coef) x
    {
      const float decay = expf(total);
      const int rg = dsp / RM, tiles = rg * (dhp / RN);
      for (int t = tid; t < tiles; t += NT) {
        const int r0 = t % rg, cc = (t / rg) * RN;
        float acc[RM][RN];
        zero(acc);
        tile_mm(acc, sBt, L.lbt, r0, rg, sX, L.lx, cc, cp, sCoef);
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          float* hr = sH + (r0 + rg * a) * L.lh + cc;
#pragma unroll
          for (int b = 0; b < RN; ++b) hr[b] = decay * hr[b] + acc[a][b];
        }
      }
    }
  }
}

// 16-byte staging loads need 16-byte aligned bases and rows of x, B, C.
template <typename T>
bool vectorizable(const void* x, const void* B, const void* C, const Strides& st, int dh,
                  int ds) {
  const long long strides[] = {st.xb, st.xh, st.xl, st.Bb, st.Bl, st.Cb, st.Cl};
  bool ok = (dh * sizeof(T)) % 16 == 0 && (ds * sizeof(T)) % 16 == 0;
  for (const void* p : {x, B, C}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : strides) ok = ok && (s * static_cast<long long>(sizeof(T))) % 16 == 0;
  return ok;
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B,
                   const void* C, void* y, const Strides& st, int b, int h, int l, int dh,
                   int ds, int chunk, cudaStream_t stream) {
  const Layout L(chunk, dh, ds);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<b * h, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<T*>(y), st, h, l, dh, ds, chunk, vectorizable<T>(x, B, C, st, dh, ds) ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// strides: 13 element strides — x (batch, head, step), dt (batch, head,
// step), B (batch, step), C (batch, step), y (batch, head, step); the last
// dim of x, B, C and y is contiguous.  dtype (of x, B, C, y): 0 f32, 1 bf16.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, const long long* strides, int dtype, int b, int h, int l, int dh, int ds, int chunk, void* stream) {
  if (chunk < 1 || dh < 1 || ds < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0 || l == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2],  strides[3], strides[4],
                   strides[5], strides[6], strides[7],  strides[8], strides[9],
                   strides[10], strides[11], strides[12]};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(x, dtf, Af, B, C, y, st, b, h, l, dh, ds, chunk, s)
          : launch<__nv_bfloat16>(x, dtf, Af, B, C, y, st, b, h, l, dh, ds, chunk, s);
  return static_cast<int>(err);
}
