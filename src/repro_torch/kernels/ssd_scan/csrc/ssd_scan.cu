// Chunked SSD (state-space duality) scan for Hopper (sm_90a), Mamba-2's
// sequence mixer:
//
//     h_t = exp(dt_t A_h) h_{t-1} + dt_t (x_t (x) B_t)     state (dh x ds)
//     y_t = h_t C_t
//
// for x (b, h, l, dh), dt (b, h, l) f32, A (h,) f32 and B, C (b, l, ds)
// shared across heads, x / B / C / y in f32 or bf16, all decay math in f32.
//
// Replaces the TPU kernel ssd_scan_pallas
// (src/repro/kernels/ssd_scan/ssd_scan.py:91, body _ssd_kernel :29).  The
// same terms per chunk of c steps: the intra-chunk term (C B^T) o
// exp(seg_ij) o dt_j on the lower triangle times x; the inter-chunk term
// exp(cum_i) C h_prev^T; the carried state exp(cum_last) h_prev + sum_j
// exp(seg_last,j) dt_j x_j (x) B_j.  seg_ij = dt_{j+1} A + ... + dt_i A is
// never the TPU kernel's cum_i - cum_j: cumulative sums reach -10^3 within
// a chunk at the model's decays, and their difference keeps only ~1e-4
// absolute of a segment's sum, which the exp turns into a relative error of
// each decay.  Every route below sums segments directly (all terms <= 0).
//
// Work: per chunk 2 c^2 ds flops for C B^T, the same for every head, and
// per chunk and head 2 c^2 dh + 4 c dh ds, against x and y of (c dh)
// elements and B, C of (c ds): at the serving slice (b = 4, 112 heads,
// l = 512, dh = ds = 64, chunk 128, bf16) 7.5 GFLOP for 60 MB.  At the
// card's rates for these types (bf16 tensor cores, the products with an
// f32 operand as two bf16 products: 15 us) the bytes bound it, 18 us; in
// f32 (120 MB) the operations do, as three TF32 products 46 us (113 us
// at the CUDA cores' 67 TFLOP/s).
//
// Three routes, chosen by the entry point from the dtype, the widths and
// the alignment alone (tc::takes, tf::takes; ssd_scan.py's b5_route
// mirrors them):
//
// bf16 on the tensor cores (bf16, dh and ds multiples of 16 up to 128, the
// chunk a multiple of 16, 16-byte aligned bases and strides), kernel
// ssd_scan_tc_kernel:
//   * one block of 8 warps owns one (batch, head) and walks its chunks in
//     order, the (dh x ds) state on chip: H^T in f32 in shared memory, and
//     as its bf16 high and low halves for the products (design (a): no
//     state goes through device memory);
//   * per chunk x, B and C arrive by cp.async into bf16 tiles (rows padded
//     by 8 elements: conflict-free ldmatrix); dt A gives, per 16-step tile,
//     each step's in-tile prefix and suffix sums (<= 16 terms, in order),
//     and from them exp(pre_i), exp(suf_j) dt_j, the tile-to-tile factors
//     exp(tot_{J+1} + ... + tot_{I-1}), exp(cum_i), the state coefficients
//     and, for the diagonal 16 x 16 tiles, exp(seg_ij) dt_j from sums down
//     each column (<= 15 terms).  Below the diagonal tile the decay is the
//     product exp(pre_i) exp(between) exp(suf_j) dt_j: every factor <= 1,
//     so nothing overflows, and no sum is a difference;
//   * warp quad q owns row tiles q and c/16 - 1 - q, so the causal slabs
//     balance, and each of its two warps half of the head dim.  For each
//     16-column slab J <= I a warp forms G = C B^T in its accumulator
//     fragments (mma.sync m16n8k16, bf16 x bf16 -> f32), multiplies in the
//     decay there, and turns the two n-tiles into the A fragment of M x,
//     split into bf16 high and low halves (M is f32; hi + lo keeps ~16
//     bits): M never touches shared memory.  The next slab's G is issued
//     before this slab's M x, so the two overlap.  y starts as exp(cum_i)
//     C H^T (H^T hi / lo) and gathers M x on top; it is stored from the
//     fragments in x's dtype;
//   * then H^T = exp(total) H^T + (coef o B)^T x, coef o B split hi / lo,
//     quad q owning 16 state rows, each warp half of the head dim;
//   * C B^T is recomputed per head, by both warps of a quad: 576 of the
//     ~2,200 mma a chunk and head takes at the slice.  What sets the pace
//     is how many blocks share an SM (their loads, decay sums and barriers
//     overlap the others' products), and sharing C B^T costs that: across
//     heads it needs a 16 x 128 f32 row slab per warp held across heads or
//     32 KB more shared memory, within a quad a split of the slabs and a
//     reduction.  A 4-warp block that forms it once (two blocks an SM) and
//     one that also fits three blocks an SM (the state in registers,
//     swizzled tiles) both ran slower on the H100 than this one, and so
//     did one block an SM with double-buffered tiles (PERF.md §6);
//   * the tensor cores add into the accumulator by truncation; the chains
//     here are at most 2 c / 16 + 2 ds / 16 mma long (24 at the slice), a
//     drift of ~1e-6 relative against the bf16 output's 2e-3;
//   * no atomics, one fixed order: two runs give the same bits.
//   At c = 128, dh = ds = 64 that is 104,704 bytes of dynamic shared
//   memory and 107 registers a thread, two blocks (16 warps) an SM: 448
//   blocks, 1.7 waves.
//
// f32 on the tensor cores (f32, the same widths, chunks and alignment as
// bf16), kernel ssd_scan_tf32_kernel: the bf16 route's design with every
// product 3xTF32 mma.sync m16n8k8 (../../hopper/csrc/tf32_mma.cuh: each f32
// operand split into TF32 halves hi = tf32(x), lo = tf32(x - hi), rounded
// as cvt.rna rounds; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi):
//   * the same blocks, warps, chunk walk, decays (blocked_decays) and
//     balanced causal slabs; no atomics, one fixed order;
//   * x, B and C arrive by cp.async as f32 at padded widths (dh rounded up
//     to 32, 64 or 128, ds to 64 or 128, the columns past them zero), rows
//     padded by 4 floats: B and C read 8 rows x 4 columns, x and B read 4
//     row pairs x 8 columns, 32 distinct banks either way; H^T is f32 with
//     rows padded by 8 (read 4 rows x 8 columns).  ldmatrix moves 16-bit
//     elements, so fragments load as plain 32-bit reads and are split in
//     registers.  At mamba2-370m's ds = 128 (c = 128, dh = 64) that is
//     219,392 bytes: the whole state fits one block (the CUDA-core route
//     cuts it into three slices);
//   * C's A fragments for a row tile are split once and held; G = C B^T,
//     C H^T, M x (G decayed in registers and turned straight into the A
//     fragment: its accumulator fragment serves unchanged with x's rows
//     read in the permuted order of tf32_mma.cuh) and the state update
//     (coef o B)^T x (the chunk's steps summed in that same order) each
//     sum 16 of their index (6 mma) into a zeroed fragment added in IEEE
//     f32: the tensor cores add by truncation, and the padded widths
//     leave no guard inside a product loop, so the chains of a slab run
//     side by side;
//   * at the slice 243 registers a thread and one block (8 warps) an SM;
//     at mamba2's ds = 128 the held C fragments push it to 255 and spills.
//     Instruction throughput and latency bound it, not the tensor cores
//     (PERF.md section 6).
//
// Everything else (f32 and bf16 that neither route takes) runs the port's
// first kernel, ssd_scan_kernel, all f32 on the CUDA cores: one
// block of 256 threads owns one (batch, head) and walks its chunks in
// order, the (dh x ds) f32 state in shared memory, transposed.  Per chunk
// it stages x, C and B^T in shared memory as f32 (zero beyond the chunk,
// dh and ds, so the products need no guards; 16-byte loads, up to 4 in
// flight a thread, when rows are 16-byte aligned), one thread takes the
// cumsum in order while thread j sums column j's segments down the rows,
// and every product runs as 4 x 8 register tiles over shared memory with
// odd row strides (conflict-free per-lane rows, broadcast columns):
//   M = (C B^T) o decay o dt   (c x c, lower triangle),
//   y = M x + exp(cum) o (C H)  written to y,
//   H = exp(total) H + (B^T o coef) x.
// At c = 128, dh = ds = 64 that is 184 KB of dynamic shared memory, one
// block an SM.  Where that layout does not fit a block (mamba2-370m's
// ds = 128 needs 266,752 bytes at c = 128, dh = 64), ssd_scan_split_kernel
// stages C and B^T in slices of the state dim, w columns (a multiple of 8)
// at a time, the fewest slices that fit: both products over ds are sums of
// the slices' products, added in slice order (G = C B^T into the c x c
// tile, C H into a c x dh tile beside it), and the state update and C H are
// separable over ds, so each slice updates its own rows of H after C H has
// read them.  The decay then multiplies G in place, by the same direct
// column sums.  At c = 128, dh = 64, ds = 128 that is three slices of 48,
// 48 and 32 columns in 217,792 bytes; every layout that fits whole keeps
// ssd_scan_kernel, so those calls give the bits they gave before.
//
// Launches go on the caller's stream and the entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../hopper/csrc/tf32_mma.cuh"  // 3xTF32 mma.sync, cp.async

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

// The layout of ssd_scan_split_kernel, in floats: C and B^T of one slice
// of w state columns, x, G (then M), H (all ds rows), the c x dh sum C H
// and the four per-step vectors.
struct SplitLayout {
  int cp, dhp, dsp, w;
  int lc, lbt, lx, lm, lh;
  int oC, oBt, oX, oM, oH, oY, oDt, oCum, oE, oCoef, total;
  __host__ __device__ SplitLayout(int chunk, int dh, int ds, int width) {
    cp = round8(chunk);
    dhp = round8(dh);
    dsp = round8(ds);
    w = width;
    lc = w + 1;
    lbt = cp + 1;
    lx = dhp + 1;
    lm = cp + 1;
    lh = dhp + 1;
    oC = 0;
    oBt = oC + cp * lc;
    oX = oBt + w * lbt;
    oM = oX + cp * lx;
    oH = oM + cp * lm;
    oY = oH + dsp * lh;
    oDt = oY + cp * lx;
    oCum = oDt + cp;
    oE = oCum + cp;
    oCoef = oE + cp;
    total = oCoef + cp;
  }
};

// The state slice width of the CUDA-core route: ds where the whole-state
// Layout fits a block, else the widest multiple of 8 that fits when ds is
// cut into the fewest equal slices, or 0 if none does (exported as
// ssd_scan_cuda_core_layout below).
__host__ inline int ds_slice(int chunk, int dh, int ds) {
  if (sizeof(float) * static_cast<size_t>(Layout(chunk, dh, ds).total) <= MAX_SMEM) return ds;
  for (int ns = 2;; ++ns) {
    const int w = round8((ds + ns - 1) / ns);
    if (sizeof(float) * static_cast<size_t>(SplitLayout(chunk, dh, ds, w).total) <= MAX_SMEM) {
      return w;
    }
    if (w == 8) return 0;
  }
}

// ssd_scan_kernel with C and B^T staged w state columns at a time (the
// header above): per chunk x and dt, the cumsum and the state coefficients
// first; then per slice G += C_s B_s^T, Y += C_s H_s, and H_s's update;
// then M = G o decay o dt by the column sums, and y = M x + exp(cum) o Y.
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_scan_split_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y, Strides st,
    int h, int l, int dh, int ds, int chunk, int width, int vec) {
  extern __shared__ float smem[];
  const SplitLayout L(chunk, dh, ds, width);
  float* sC = smem + L.oC;      // cp x lc      C of the chunk, one slice
  float* sBt = smem + L.oBt;    // w x lbt      B of the chunk, one slice, transposed
  float* sX = smem + L.oX;      // cp x lx      x of the chunk
  float* sM = smem + L.oM;      // cp x lm      G = C B^T, then the masked decay matrix
  float* sH = smem + L.oH;      // dsp x lh     the state, transposed (s, p)
  float* sY = smem + L.oY;      // cp x lx      C H, H the state before this chunk
  float* sDt = smem + L.oDt;
  float* sCum = smem + L.oCum;
  float* sE = smem + L.oE;
  float* sCoef = smem + L.oCoef;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  x += bi * st.xb + hi * st.xh;
  dt += bi * st.db + hi * st.dh;
  Bm += bi * st.Bb;
  Cm += bi * st.Cb;
  y += bi * st.yb + hi * st.yh;
  const float a_h = A[hi];
  const int cp = L.cp, dhp = L.dhp;

  for (int i = tid; i < L.total; i += NT) smem[i] = 0.0f;

  for (int c0 = 0; c0 < l; c0 += chunk) {
    const int len = min(chunk, l - c0);
    __syncthreads();
    stage(sX, L.lx, 1, x + c0 * st.xl, st.xl, cp, len, dh, vec);
    for (int r = tid; r < cp; r += NT) sDt[r] = r < len ? dt[(c0 + r) * st.dl] : 0.0f;
    __syncthreads();
    if (tid == NT - 1) {
      float c = 0.0f;
#pragma unroll 8
      for (int r = 0; r < cp; ++r) {
        c += sDt[r] * a_h;
        sCum[r] = c;
      }
    }
    // the carried state's coefficients, summed down the columns as below
    for (int j = tid; j < cp; j += NT) {
      float seg = 0.0f;
      for (int i = j + 1; i < cp; ++i) seg += sDt[i] * a_h;
      sCoef[j] = expf(seg) * sDt[j];
    }
    __syncthreads();
    const float decay = expf(sCum[cp - 1]);
    for (int r = tid; r < cp; r += NT) sE[r] = expf(sCum[r]);

    for (int s0 = 0; s0 < ds; s0 += width) {
      const int n = min(width, ds - s0);
      const bool first = s0 == 0;
      __syncthreads();  // the last slice's reads of sC / sBt are done
      stage(sC, L.lc, 1, Cm + c0 * st.Cl + s0, st.Cl, cp, len, n, vec);
      stage(sBt, 1, L.lbt, Bm + c0 * st.Bl + s0, st.Bl, cp, len, n, vec);
      __syncthreads();
      // G (+)= C_s B_s^T
      {
        const int rg = cp / RM, tiles = rg * (cp / RN);
        for (int t = tid; t < tiles; t += NT) {
          const int r0 = t % rg, cc = (t / rg) * RN;
          float acc[RM][RN];
          zero(acc);
          tile_mm(acc, sC, L.lc, r0, rg, sBt, L.lbt, cc, n, nullptr);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            float* mr = sM + (r0 + rg * a) * L.lm + cc;
#pragma unroll
            for (int b = 0; b < RN; ++b) mr[b] = first ? acc[a][b] : mr[b] + acc[a][b];
          }
        }
      }
      // Y (+)= C_s H_s
      {
        const int rg = cp / RM, tiles = rg * (dhp / RN);
        for (int t = tid; t < tiles; t += NT) {
          const int r0 = t % rg, cc = (t / rg) * RN;
          float acc[RM][RN];
          zero(acc);
          tile_mm(acc, sC, L.lc, r0, rg, sH + s0 * L.lh, L.lh, cc, n, nullptr);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            float* yr = sY + (r0 + rg * a) * L.lx + cc;
#pragma unroll
            for (int b = 0; b < RN; ++b) yr[b] = first ? acc[a][b] : yr[b] + acc[a][b];
          }
        }
      }
      __syncthreads();  // C_s H_s has read H_s
      // H_s = exp(total) H_s + (B_s^T o coef) x, rows past n left alone
      {
        const int rg = (n + RM - 1) / RM, tiles = rg * (dhp / RN);
        for (int t = tid; t < tiles; t += NT) {
          const int r0 = t % rg, cc = (t / rg) * RN;
          float acc[RM][RN];
          zero(acc);
          tile_mm(acc, sBt, L.lbt, r0, rg, sX, L.lx, cc, cp, sCoef);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            const int r = r0 + rg * a;
            if (r >= n) continue;
            float* hr = sH + (s0 + r) * L.lh + cc;
#pragma unroll
            for (int b = 0; b < RN; ++b) hr[b] = decay * hr[b] + acc[a][b];
          }
        }
      }
    }
    __syncthreads();
    // M = G o exp(seg_ij) o dt_j on the lower triangle, 0 above it
    for (int j = tid; j < cp; j += NT) {
      const float dtj = sDt[j];
      for (int i = 0; i < j; ++i) sM[i * L.lm + j] = 0.0f;
      float seg = 0.0f;
      sM[j * L.lm + j] *= dtj;
      for (int i = j + 1; i < cp; ++i) {
        seg += sDt[i] * a_h;
        sM[i * L.lm + j] *= expf(seg) * dtj;
      }
    }
    __syncthreads();
    // y = M x + exp(cum) o Y
    {
      const int rg = cp / RM, tiles = rg * (dhp / RN);
      for (int t = tid; t < tiles; t += NT) {
        const int r0 = t % rg, cc = (t / rg) * RN;
        float intra[RM][RN];
        zero(intra);
        tile_mm(intra, sM, L.lm, r0, rg, sX, L.lx, cc, cp, nullptr);
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          const int i = r0 + rg * a;
          if (i >= len) continue;
          T* yr = y + (c0 + i) * st.yl;
          const float* ys = sY + i * L.lx + cc;
#pragma unroll
          for (int b = 0; b < RN; ++b) {
            const int p = cc + b;
            if (p < dh) yr[p] = from_f32<T>(intra[a][b] + sE[i] * ys[b]);
          }
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
  const int width = ds_slice(chunk, dh, ds);
  if (width == 0) return cudaErrorInvalidValue;
  const int vec = vectorizable<T>(x, B, C, st, dh, ds) ? 1 : 0;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  T* yt = static_cast<T*>(y);
  if (width == ds) {
    const size_t smem = sizeof(float) * static_cast<size_t>(Layout(chunk, dh, ds).total);
    auto kern = ssd_scan_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<b * h, NT, smem, stream>>>(xt, dt, A, Bt, Ct, yt, st, h, l, dh, ds, chunk, vec);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(SplitLayout(chunk, dh, ds, width).total);
  auto kern = ssd_scan_split_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<b * h, NT, smem, stream>>>(xt, dt, A, Bt, Ct, yt, st, h, l, dh, ds, chunk, width, vec);
  return cudaGetLastError();
}

// The per-step shared vectors of one chunk's decays on the tensor-core
// routes, and the tables built from them.
struct Decays {
  const float *dt, *la;  // dt and dt A of the chunk's steps
  float *pre, *suf;      // in-tile inclusive prefix / exclusive suffix sums of dt A
  float *erow, *rowf, *colf, *coef;  // exp(cum_i), exp(pre_i), exp(suf_j) dt_j, exp(seg_last,j) dt_j
  float *tilef;  // [J][I] exp(tot_{J+1} + ... + tot_{I-1}), 0 for J >= I
  float *diag;   // [I][a][b] exp(seg) dt of the diagonal 16 x 16 tiles, 0 above
};

// The decays of one chunk for the tensor-core routes (the header above),
// by a block of NTH threads, from dc.dt and dc.la; ends with a barrier.
template <int NTH>
__device__ __forceinline__ void blocked_decays(const Decays& dc, int chunk) {
  const int nrt = chunk / 16;
  // the decays from direct sums of dt A (all terms <= 0, never a
  // difference): within each 16-step tile the inclusive prefix and the
  // exclusive suffix of every step, summed in step order
  for (int p = static_cast<int>(threadIdx.x); p < 2 * chunk; p += NTH) {
    const int k = p % chunk, t0 = k & ~15;
    float s = 0.0f;
    if (p < chunk) {
      for (int m = t0; m <= k; ++m) s += dc.la[m];
      dc.pre[k] = s;
    } else {
      for (int m = k + 1; m < t0 + 16; ++m) s += dc.la[m];
      dc.suf[k] = s;
    }
  }
  __syncthreads();
  // tile sums tot_K = pre of a tile's last step; cum_i = (tot_0 + ... +
  // tot_{I-1}) + pre_i; the carried state's seg_last,j = suf_j + (tot_{J+1}
  // + ... + tot_{nrt-1}); the diagonal tiles' column b walks its rows
  // with seg summed in order; the tile-to-tile factors
  for (int p = static_cast<int>(threadIdx.x); p < 2 * chunk + nrt * nrt; p += NTH) {
    if (p < chunk) {
      const int I = p / 16;
      float before = 0.0f, after = 0.0f;
      for (int K = 0; K < I; ++K) before += dc.pre[16 * K + 15];
      for (int K = I + 1; K < nrt; ++K) after += dc.pre[16 * K + 15];
      const float d = dc.dt[p];
      dc.erow[p] = expf(before + dc.pre[p]);
      dc.rowf[p] = expf(dc.pre[p]);
      dc.colf[p] = expf(dc.suf[p]) * d;
      dc.coef[p] = expf(dc.suf[p] + after) * d;
    } else if (p < 2 * chunk) {
      const int q = p - chunk, I = q / 16, b = q % 16;
      float* D = dc.diag + 256 * I;
      const float d = dc.dt[q];
      for (int a = 0; a < b; ++a) D[16 * a + b] = 0.0f;
      D[17 * b] = d;
      float s = 0.0f;
      for (int a = b + 1; a < 16; ++a) {
        s += dc.la[16 * I + a];
        D[16 * a + b] = expf(s) * d;
      }
    } else {
      const int q = p - 2 * chunk, J = q / nrt, I = q % nrt;
      float s = 0.0f;
      for (int K = J + 1; K < I; ++K) s += dc.pre[16 * K + 15];
      dc.tilef[q] = J < I ? expf(s) : 0.0f;
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------------------
// The bf16 tensor-core route: mma.sync m16n8k16, every product on the
// tensor cores, the decay matrix never in shared memory
// --------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NW = 8;              // warps per block: two quads of 4
constexpr int NT = 32 * NW;        // threads per block

__host__ __device__ inline int take(int& at, int bytes) {
  const int o = at;
  at += (bytes + 15) & ~15;
  return o;
}

// The shared-memory layout in bytes (ssd_scan.py's tc_shared_bytes mirrors
// it): x, B and C of the chunk in bf16, rows padded by 8 elements (an odd
// number of 16-byte pieces a row, so ldmatrix's 8 rows hit 8 distinct bank
// groups); the state H^T (ds x dh) in f32 and as its bf16 high and low
// halves; eight per-step vectors; the (nrt x nrt) tile-to-tile decays and
// the (16 x 16) decay tables of the nrt diagonal tiles.
struct Layout {
  int ldx, ldb, ldh, nrt;
  int oX, oB, oC, oHhi, oHlo, oH, oDt, oLa, oPre, oSuf, oErow, oRowf, oColf, oCoef, oTilef,
      oDiag, total;
  __host__ __device__ Layout(int chunk, int dh, int ds) {
    ldx = dh + 8;
    ldb = ds + 8;
    ldh = dh + 8;
    nrt = chunk / 16;
    int at = 0;
    oX = take(at, chunk * ldx * 2);
    oB = take(at, chunk * ldb * 2);
    oC = take(at, chunk * ldb * 2);
    oHhi = take(at, ds * ldh * 2);
    oHlo = take(at, ds * ldh * 2);
    oH = take(at, ds * ldh * 4);
    oDt = take(at, chunk * 4);
    oLa = take(at, chunk * 4);
    oPre = take(at, chunk * 4);
    oSuf = take(at, chunk * 4);
    oErow = take(at, chunk * 4);
    oRowf = take(at, chunk * 4);
    oColf = take(at, chunk * 4);
    oCoef = take(at, chunk * 4);
    oTilef = take(at, nrt * nrt * 4);
    oDiag = take(at, chunk * 16 * 4);
    total = at;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulator (no side effects, so
// not volatile: the compiler may schedule it freely)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi): hi + lo keeps
// ~16 of f32's 24 bits, where bf16 alone keeps 8
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// rows x n bf16 (n a multiple of 8) from src (row stride `stride`) into
// dst (row stride ld), 16 bytes a copy
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                          long long stride, int rows, int n) {
  const int per_row = n / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    cp_async16(dst + r * ld + c, src + r * stride + c);
  }
}

// What one warp needs of the block's shared memory, and the head-dim pairs
// (16 columns each) [np0, np1) it owns.
struct Warp {
  const Layout& L;
  const bf16 *sX, *sB, *sC, *sHhi, *sHlo;
  const float *sErow, *sRowf, *sColf, *sTilef, *sDiag;
  int lane, g, t, np0, np1, ksd;
};

// G = C B^T for the 16 rows whose C fragments are cf and the 16 columns of
// tile J (two n-tiles of 8)
template <int DSMAX>
__device__ __forceinline__ void gram(float (&gs)[2][4], const uint32_t (&cf)[DSMAX / 16][4],
                                     const Warp& w, int J) {
#pragma unroll
  for (int n = 0; n < 2; ++n) gs[n][0] = gs[n][1] = gs[n][2] = gs[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DSMAX / 16; ++kk) {
    if (kk >= w.ksd) break;
    uint32_t bf[4];
    ldsm_x4(bf, w.sB + (16 * J + w.lane % 8 + 8 * (w.lane / 16)) * w.L.ldb + 16 * kk +
                    8 * ((w.lane / 8) % 2));
    mma(gs[0], cf[kk], bf[0], bf[1]);
    mma(gs[1], cf[kk], bf[2], bf[3]);
  }
}

// y rows of row tile I, head-dim pairs [np0, np1): acc = exp(cum_i) (C
// H^T)_i + sum_{j <= i} M_ij x_j, M = (C B^T) o decay formed slab by slab
// in registers; the next slab's C B^T is issued before this slab's M x
template <int DSMAX, int NP>
__device__ __forceinline__ void row_tile(const Warp& w, int I, bool inter, bf16* y,
                                         long long yl) {
  const int lane = w.lane, g = w.g, t = w.t;
  uint32_t cf[DSMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < DSMAX / 16; ++kk) {
    if (kk < w.ksd) {
      ldsm_x4(cf[kk], w.sC + (16 * I + lane % 16) * w.L.ldb + 16 * kk + 8 * (lane / 16));
    }
  }
  float acc[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  if (inter) {
    // C H^T, H^T as its high and low halves (B operand: k = state, n = head dim)
#pragma unroll
    for (int kk = 0; kk < DSMAX / 16; ++kk) {
      if (kk >= w.ksd) break;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (w.np0 + q >= w.np1) break;
        const int off = (16 * kk + lane % 16) * w.L.ldh + 16 * (w.np0 + q) + 8 * (lane / 16);
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, w.sHhi + off);
        ldsm_x4_t(bl, w.sHlo + off);
        mma(acc[2 * q], cf[kk], bl[0], bl[1]);
        mma(acc[2 * q], cf[kk], bh[0], bh[1]);
        mma(acc[2 * q + 1], cf[kk], bl[2], bl[3]);
        mma(acc[2 * q + 1], cf[kk], bh[2], bh[3]);
      }
    }
    const float e0 = w.sErow[16 * I + g], e1 = w.sErow[16 * I + g + 8];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
      acc[n][0] *= e0, acc[n][1] *= e0, acc[n][2] *= e1, acc[n][3] *= e1;
    }
  }

  const float rf0 = w.sRowf[16 * I + g], rf1 = w.sRowf[16 * I + g + 8];
  float gs[2][4];
  gram<DSMAX>(gs, cf, w, 0);
  for (int J = 0; J <= I; ++J) {
    // M = G o decay: below the diagonal tile exp(seg_ij) dt_j is
    // (exp(pre_i) exp(between tiles)) (exp(suf_j) dt_j), each factor <= 1;
    // in the diagonal tile it is read from the table of direct sums
    float m[2][4];
    if (J < I) {
      const float tf = w.sTilef[J * w.L.nrt + I];
      const float r0 = rf0 * tf, r1 = rf1 * tf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * J + 8 * nt + 2 * t;
        const float c0 = w.sColf[j], c1 = w.sColf[j + 1];
        m[nt][0] = gs[nt][0] * (r0 * c0);
        m[nt][1] = gs[nt][1] * (r0 * c1);
        m[nt][2] = gs[nt][2] * (r1 * c0);
        m[nt][3] = gs[nt][3] * (r1 * c1);
      }
    } else {
      const float* D = w.sDiag + 256 * I;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int bcol = 8 * nt + 2 * t;
        m[nt][0] = gs[nt][0] * D[16 * g + bcol];
        m[nt][1] = gs[nt][1] * D[16 * g + bcol + 1];
        m[nt][2] = gs[nt][2] * D[16 * (g + 8) + bcol];
        m[nt][3] = gs[nt][3] * D[16 * (g + 8) + bcol + 1];
      }
    }
    if (J < I) gram<DSMAX>(gs, cf, w, J + 1);
    // the accumulator fragments of the two n-tiles are the A fragment of
    // the 16 x 16 slab, split into bf16 high and low halves
    uint32_t ah[4], al[4];
    split(m[0][0], m[0][1], ah[0], al[0]);
    split(m[0][2], m[0][3], ah[1], al[1]);
    split(m[1][0], m[1][1], ah[2], al[2]);
    split(m[1][2], m[1][3], ah[3], al[3]);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (w.np0 + q >= w.np1) break;
      uint32_t xf[4];
      ldsm_x4_t(xf, w.sX + (16 * J + lane % 16) * w.L.ldx + 16 * (w.np0 + q) + 8 * (lane / 16));
      mma(acc[2 * q], al, xf[0], xf[1]);
      mma(acc[2 * q], ah, xf[0], xf[1]);
      mma(acc[2 * q + 1], al, xf[2], xf[3]);
      mma(acc[2 * q + 1], ah, xf[2], xf[3]);
    }
  }

  bf16* y0 = y + (16 * I + g) * yl;
  bf16* y1 = y0 + 8 * yl;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
    if (2 * w.np0 + n >= 2 * w.np1) break;
    const int p = 16 * w.np0 + 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(y0 + p) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(y1 + p) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// Warp quad w % 4 owns row tiles (and state rows), half w / 4 its half of
// the head dim
template <int DHMAX, int DSMAX>
__global__ void __launch_bounds__(NT) ssd_scan_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, bf16* __restrict__ y, Strides st,
    int h, int l, int dh, int ds, int chunk) {
  constexpr int NP = DHMAX / 32;  // 16-column head-dim pairs a warp owns, at most
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(chunk, dh, ds);
  bf16* sX = reinterpret_cast<bf16*>(smem + L.oX);      // chunk x ldx  x
  bf16* sB = reinterpret_cast<bf16*>(smem + L.oB);      // chunk x ldb  B
  bf16* sC = reinterpret_cast<bf16*>(smem + L.oC);      // chunk x ldb  C
  bf16* sHhi = reinterpret_cast<bf16*>(smem + L.oHhi);  // ds x ldh     H^T, high half
  bf16* sHlo = reinterpret_cast<bf16*>(smem + L.oHlo);  // ds x ldh     H^T, low half
  float* sH = reinterpret_cast<float*>(smem + L.oH);    // ds x ldh     H^T in f32
  float* sDt = reinterpret_cast<float*>(smem + L.oDt);
  float* sLa = reinterpret_cast<float*>(smem + L.oLa);      // dt A
  float* sPre = reinterpret_cast<float*>(smem + L.oPre);    // in-tile inclusive prefix sums
  float* sSuf = reinterpret_cast<float*>(smem + L.oSuf);    // in-tile exclusive suffix sums
  float* sErow = reinterpret_cast<float*>(smem + L.oErow);  // exp(cum_i)
  float* sRowf = reinterpret_cast<float*>(smem + L.oRowf);  // exp(pre_i)
  float* sColf = reinterpret_cast<float*>(smem + L.oColf);  // exp(suf_j) dt_j
  float* sCoef = reinterpret_cast<float*>(smem + L.oCoef);  // exp(seg_last,j) dt_j
  float* sTilef = reinterpret_cast<float*>(smem + L.oTilef);  // [J][I] exp(tiles J+1..I-1)
  float* sDiag = reinterpret_cast<float*>(smem + L.oDiag);    // [I][a][b] exp(seg) dt, a >= b
  const Decays dec{sDt, sLa, sPre, sSuf, sErow, sRowf, sColf, sCoef, sTilef, sDiag};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = warp % 4, half = warp / 4;
  const int per = (dh / 16 + 1) / 2;
  const Warp w{L, sX, sB, sC, sHhi, sHlo, sErow, sRowf, sColf, sTilef, sDiag,
               lane, lane / 4, lane % 4, half * per, min(dh / 16, (half + 1) * per), ds / 16};
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  x += bi * st.xb + hi * st.xh;
  dt += bi * st.db + hi * st.dh;
  Bm += bi * st.Bb;
  Cm += bi * st.Cb;
  y += bi * st.yb + hi * st.yh;
  const float a_h = A[hi];
  const int nrt = L.nrt;

  for (int i = tid; i < ds * L.ldh; i += NT) {
    sH[i] = 0.0f;
    sHhi[i] = __float2bfloat16(0.0f);
    sHlo[i] = __float2bfloat16(0.0f);
  }

  for (int c0 = 0; c0 < l; c0 += chunk) {
    __syncthreads();  // the last chunk's reads of the tiles and vectors are done
    copy_tile(sX, L.ldx, x + c0 * st.xl, st.xl, chunk, dh);
    copy_tile(sB, L.ldb, Bm + c0 * st.Bl, st.Bl, chunk, ds);
    copy_tile(sC, L.ldb, Cm + c0 * st.Cl, st.Cl, chunk, ds);
    for (int k = tid; k < chunk; k += NT) {
      const float d = dt[(c0 + k) * st.dl];
      sDt[k] = d;
      sLa[k] = d * a_h;
    }
    cp_async_wait_all();
    __syncthreads();

    blocked_decays<NT>(dec, chunk);

    // y: quad q takes row tiles q and nrt - 1 - q (then q + 4, ...), so
    // the causal slabs balance across quads
    const bool inter = c0 > 0;
    for (int pr = quad; pr < (nrt + 1) / 2; pr += 4) {
      row_tile<DSMAX, NP>(w, pr, inter, y + c0 * st.yl, st.yl);
      if (nrt - 1 - pr != pr) row_tile<DSMAX, NP>(w, nrt - 1 - pr, inter, y + c0 * st.yl, st.yl);
    }
    if (c0 + chunk >= l) break;
    __syncthreads();  // every warp has read H^T

    // H^T = exp(total) H^T + (coef o B)^T x: quad q owns state rows
    // [16 q, 16 q + 16) (then + 64, ...) for its share of the head dim;
    // coef o B is f32, split hi / lo
    float total = 0.0f;
    for (int K = 0; K < nrt; ++K) total += sPre[16 * K + 15];
    const float decay = expf(total);
    for (int mt = quad; mt < ds / 16; mt += 4) {
      float acc[2 * NP][4];
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
      for (int kk = 0; kk < nrt; ++kk) {
        uint32_t bt[4];
        ldsm_x4_t(bt, sB + (16 * kk + lane % 8 + 8 * (lane / 16)) * L.ldb + 16 * mt +
                          8 * ((lane / 8) % 2));
        const float q0 = sCoef[16 * kk + 2 * w.t], q1 = sCoef[16 * kk + 2 * w.t + 1];
        const float q2 = sCoef[16 * kk + 2 * w.t + 8], q3 = sCoef[16 * kk + 2 * w.t + 9];
        uint32_t ah[4], al[4];
        float2 v = unpack(bt[0]);
        split(v.x * q0, v.y * q1, ah[0], al[0]);
        v = unpack(bt[1]);
        split(v.x * q0, v.y * q1, ah[1], al[1]);
        v = unpack(bt[2]);
        split(v.x * q2, v.y * q3, ah[2], al[2]);
        v = unpack(bt[3]);
        split(v.x * q2, v.y * q3, ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          if (w.np0 + q >= w.np1) break;
          uint32_t xf[4];
          ldsm_x4_t(xf, sX + (16 * kk + lane % 16) * L.ldx + 16 * (w.np0 + q) + 8 * (lane / 16));
          mma(acc[2 * q], al, xf[0], xf[1]);
          mma(acc[2 * q], ah, xf[0], xf[1]);
          mma(acc[2 * q + 1], al, xf[2], xf[3]);
          mma(acc[2 * q + 1], ah, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
        if (2 * w.np0 + n >= 2 * w.np1) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int at = (16 * mt + w.g + 8 * hf) * L.ldh + 16 * w.np0 + 8 * n + 2 * w.t;
          float2 hv = *reinterpret_cast<float2*>(sH + at);
          hv.x = decay * hv.x + acc[n][2 * hf];
          hv.y = decay * hv.y + acc[n][2 * hf + 1];
          *reinterpret_cast<float2*>(sH + at) = hv;
          uint32_t hb, lb;
          split(hv.x, hv.y, hb, lb);
          *reinterpret_cast<uint32_t*>(sHhi + at) = hb;
          *reinterpret_cast<uint32_t*>(sHlo + at) = lb;
        }
      }
    }
  }
}

// The route: bf16 (checked by the caller), dh, ds and the chunk multiples
// of 16, dh and ds at most 128, whole chunks, 16-byte aligned bases and
// strides (a size-1 dimension's stride is never stepped), and the layout
// within a block's shared memory.  ssd_scan.py's b5_route mirrors it.
bool takes(const void* x, const void* B, const void* C, const Strides& st, int b, int h, int l,
           int dh, int ds, int chunk) {
  bool ok = dh % 16 == 0 && ds % 16 == 0 && chunk % 16 == 0 && dh <= 128 && ds <= 128 &&
            l % chunk == 0;
  for (const void* p : {x, B, C}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const long long strides[] = {st.xb, st.xh, st.xl, st.Bb, st.Bl, st.Cb, st.Cl};
  const int sizes[] = {b, h, l, b, l, b, l};
  for (int i = 0; i < 7; ++i) ok = ok && (sizes[i] == 1 || (strides[i] * 2) % 16 == 0);
  return ok && static_cast<size_t>(Layout(chunk, dh, ds).total) <= MAX_SMEM;
}

template <int DHMAX, int DSMAX>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   void* y, const Strides& st, int b, int h, int l, int dh, int ds, int chunk,
                   cudaStream_t stream) {
  const int smem = Layout(chunk, dh, ds).total;
  auto kern = ssd_scan_tc_kernel<DHMAX, DSMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<b * h, NT, smem, stream>>>(static_cast<const bf16*>(x), dt, A,
                                         static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                                         static_cast<bf16*>(y), st, h, l, dh, ds, chunk);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const float* dt, const float* A, const void* B,
                     const void* C, void* y, const Strides& st, int b, int h, int l, int dh,
                     int ds, int chunk, cudaStream_t stream) {
  if (dh <= 64 && ds <= 64) {
    return launch<64, 64>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
  }
  return launch<128, 128>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
}

}  // namespace tc

// --------------------------------------------------------------------------
// The f32 tensor-core route: 3xTF32 mma.sync m16n8k8, every product on the
// tensor cores, the decay matrix never in shared memory
// --------------------------------------------------------------------------

namespace tf {

// split, split_a, mma3, cp.async: ../../hopper/csrc/tf32_mma.cuh
using namespace tf32;
using tc::take;

constexpr int NW = 8;        // warps per block: two quads of 4
constexpr int NT = 32 * NW;  // threads per block

// The widths the kernel is built for: the head dim rounded up to 32, 64 or
// 128 (each warp half owns half of it), the state dim to 64 or 128; the
// columns past dh and ds are zero, so every product loop has a fixed count.
__host__ __device__ inline int padded_dh(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }
__host__ __device__ inline int padded_ds(int ds) { return ds <= 64 ? 64 : 128; }

// The shared-memory layout in bytes (ssd_scan.py's tf32_shared_bytes
// mirrors it): x, B and C of the chunk in f32 at the padded widths, rows
// padded by 4 floats more (B and C read 8 rows x 4 columns, x and B read 4
// row pairs x 8 columns: 32 distinct banks either way); the state H^T
// (padded ds x padded dh) in f32, rows padded by 8 (read 4 rows x 8
// columns); eight per-step vectors; the (nrt x nrt) tile-to-tile decays
// and the (16 x 16) decay tables of the diagonal tiles.
struct Layout {
  int ldx, ldb, ldh, nrt;
  int oX, oB, oC, oH, oDt, oLa, oPre, oSuf, oErow, oRowf, oColf, oCoef, oTilef, oDiag, total;
  __host__ __device__ Layout(int chunk, int dh, int ds) {
    ldx = padded_dh(dh) + 4;
    ldb = padded_ds(ds) + 4;
    ldh = padded_dh(dh) + 8;
    nrt = chunk / 16;
    int at = 0;
    oX = take(at, chunk * ldx * 4);
    oB = take(at, chunk * ldb * 4);
    oC = take(at, chunk * ldb * 4);
    oH = take(at, padded_ds(ds) * ldh * 4);
    oDt = take(at, chunk * 4);
    oLa = take(at, chunk * 4);
    oPre = take(at, chunk * 4);
    oSuf = take(at, chunk * 4);
    oErow = take(at, chunk * 4);
    oRowf = take(at, chunk * 4);
    oColf = take(at, chunk * 4);
    oCoef = take(at, chunk * 4);
    oTilef = take(at, nrt * nrt * 4);
    oDiag = take(at, chunk * 16 * 4);
    total = at;
  }
};

// rows x w f32 (w a multiple of 4) into dst (row stride ld) from src (row
// stride `stride`), 16 bytes a copy, the columns past n zero-filled
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* __restrict__ src,
                                          long long stride, int rows, int n, int w) {
  const int per_row = w / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    const bool ok = c < n;
    cp_async16(dst + r * ld + c, src + (ok ? r * stride + c : 0), ok ? 16 : 0);
  }
}

// What one warp needs of the block's shared memory, and the first of the
// head-dim pairs (16 columns each) it owns.  Every product below sums 16 of
// its index (two k-steps) into a zeroed fragment, then adds it in IEEE f32:
// chains of 6 mma, and no guard in a product loop.
struct Warp {
  const Layout& L;
  const float *sX, *sB, *sC, *sH;
  const float *sErow, *sRowf, *sColf, *sTilef, *sDiag;
  int g, t, np0;
};

// C's A fragments for rows 16 I + g and 16 I + g + 8 over the state dim,
// split into TF32 halves once per row tile
template <int DSP>
__device__ __forceinline__ void c_frags(uint32_t (&ch)[DSP / 8][4], uint32_t (&cl)[DSP / 8][4],
                                        const Warp& w, int I) {
  const float* c0 = w.sC + (16 * I + w.g) * w.L.ldb + w.t;
  const float* c1 = c0 + 8 * w.L.ldb;
#pragma unroll
  for (int kk = 0; kk < DSP / 8; ++kk) {
    split_a(ch[kk], cl[kk], c0[8 * kk], c1[8 * kk], c0[8 * kk + 4], c1[8 * kk + 4]);
  }
}

// G = C B^T for this warp's 16 rows and the 16 columns of tile J (two
// n-tiles of 8), summed over the state 16 at a time
template <int DSP>
__device__ __forceinline__ void gram(float (&gs)[2][4], const uint32_t (&ch)[DSP / 8][4],
                                     const uint32_t (&cl)[DSP / 8][4], const Warp& w, int J) {
#pragma unroll
  for (int n = 0; n < 2; ++n) gs[n][0] = gs[n][1] = gs[n][2] = gs[n][3] = 0.0f;
#pragma unroll
  for (int kp = 0; kp < DSP / 16; ++kp) {
    float part[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
    for (int kk = 2 * kp; kk < 2 * kp + 2; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* br = w.sB + (16 * J + 8 * nt + w.g) * w.L.ldb + 8 * kk + w.t;
        mma3(part[nt], ch[kk], cl[kk], br[0], br[4]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[n][e] += part[n][e];
    }
  }
}

// y rows of row tile I, this warp's NP head-dim pairs (those past dh are
// computed on zero columns and not stored): acc = exp(cum_i) (C H^T)_i,
// then + M_iJ x_J slab by slab (J = 0 .. I, each slab's product in a
// zeroed fragment), M = (C B^T) o decay formed in registers; the next
// slab's C B^T is started before this slab's M x
template <int DSP, int NP>
__device__ __forceinline__ void row_tile(const Warp& w, int I, bool inter, float* y,
                                         long long yl, int dh) {
  const int g = w.g, t = w.t;
  uint32_t ch[DSP / 8][4], cl[DSP / 8][4];
  c_frags<DSP>(ch, cl, w, I);
  float acc[2 * NP][4];
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  if (inter) {
    // C H^T (B operand: k = state, n = head dim), 16 states at a time
#pragma unroll
    for (int kp = 0; kp < DSP / 16; ++kp) {
      float part[2 * NP][4];
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
      for (int kk = 2 * kp; kk < 2 * kp + 2; ++kk) {
        const float* h0 = w.sH + (8 * kk + t) * w.L.ldh + 16 * w.np0 + g;
        const float* h1 = h0 + 4 * w.L.ldh;
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n) mma3(part[n], ch[kk], cl[kk], h0[8 * n], h1[8 * n]);
      }
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
    }
    const float e0 = w.sErow[16 * I + g], e1 = w.sErow[16 * I + g + 8];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
      acc[n][0] *= e0, acc[n][1] *= e0, acc[n][2] *= e1, acc[n][3] *= e1;
    }
  }

  const float rf0 = w.sRowf[16 * I + g], rf1 = w.sRowf[16 * I + g + 8];
  float gs[2][4];
  gram<DSP>(gs, ch, cl, w, 0);
  for (int J = 0; J <= I; ++J) {
    // M = G o decay, as on the bf16 route
    float m[2][4];
    if (J < I) {
      const float tf = w.sTilef[J * w.L.nrt + I];
      const float r0 = rf0 * tf, r1 = rf1 * tf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * J + 8 * nt + 2 * t;
        const float c0 = w.sColf[j], c1 = w.sColf[j + 1];
        m[nt][0] = gs[nt][0] * (r0 * c0);
        m[nt][1] = gs[nt][1] * (r0 * c1);
        m[nt][2] = gs[nt][2] * (r1 * c0);
        m[nt][3] = gs[nt][3] * (r1 * c1);
      }
    } else {
      const float* D = w.sDiag + 256 * I;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int bcol = 8 * nt + 2 * t;
        m[nt][0] = gs[nt][0] * D[16 * g + bcol];
        m[nt][1] = gs[nt][1] * D[16 * g + bcol + 1];
        m[nt][2] = gs[nt][2] * D[16 * (g + 8) + bcol];
        m[nt][3] = gs[nt][3] * D[16 * (g + 8) + bcol + 1];
      }
    }
    if (J < I) gram<DSP>(gs, ch, cl, w, J + 1);
    // each n-tile's accumulator fragment is the A fragment of one k-step,
    // x's rows read in the matching order (tf32_mma.cuh)
    uint32_t mh[2][4], ml[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) split_a(mh[nt], ml[nt], m[nt][0], m[nt][2], m[nt][1], m[nt][3]);
    float pv[2 * NP][4];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* x0 = w.sX + (16 * J + 8 * nt + 2 * t) * w.L.ldx + 16 * w.np0 + g;
      const float* x1 = x0 + w.L.ldx;
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) mma3(pv[n], mh[nt], ml[nt], x0[8 * n], x1[8 * n]);
    }
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += pv[n][e];
    }
  }

  float* y0 = y + (16 * I + g) * yl;
  float* y1 = y0 + 8 * yl;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
    if (16 * w.np0 + 8 * n >= dh) break;
    const int p = 16 * w.np0 + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(y0 + p) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(y1 + p) = make_float2(acc[n][2], acc[n][3]);
  }
}

// Warp quad w % 4 owns row tiles (and state rows), half w / 4 its half of
// the head dim (DHP = padded_dh(dh), DSP = padded_ds(ds)), as on the bf16
// route
template <int DHP, int DSP>
__global__ void __launch_bounds__(NT, 1) ssd_scan_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    Strides st, int h, int l, int dh, int ds, int chunk) {
  constexpr int NP = DHP / 32;  // 16-column head-dim pairs a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(chunk, dh, ds);
  float* sX = reinterpret_cast<float*>(smem + L.oX);  // chunk x ldx  x
  float* sB = reinterpret_cast<float*>(smem + L.oB);  // chunk x ldb  B
  float* sC = reinterpret_cast<float*>(smem + L.oC);  // chunk x ldb  C
  float* sH = reinterpret_cast<float*>(smem + L.oH);  // ds x ldh     H^T
  float* sDt = reinterpret_cast<float*>(smem + L.oDt);
  float* sLa = reinterpret_cast<float*>(smem + L.oLa);
  float* sPre = reinterpret_cast<float*>(smem + L.oPre);
  float* sCoef = reinterpret_cast<float*>(smem + L.oCoef);
  const Decays dec{sDt, sLa, sPre,
                   reinterpret_cast<float*>(smem + L.oSuf),
                   reinterpret_cast<float*>(smem + L.oErow),
                   reinterpret_cast<float*>(smem + L.oRowf),
                   reinterpret_cast<float*>(smem + L.oColf), sCoef,
                   reinterpret_cast<float*>(smem + L.oTilef),
                   reinterpret_cast<float*>(smem + L.oDiag)};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = warp % 4, half = warp / 4;
  const Warp w{L, sX, sB, sC, sH, dec.erow, dec.rowf, dec.colf, dec.tilef, dec.diag,
               lane / 4, lane % 4, half * NP};
  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  x += bi * st.xb + hi * st.xh;
  dt += bi * st.db + hi * st.dh;
  Bm += bi * st.Bb;
  Cm += bi * st.Cb;
  y += bi * st.yb + hi * st.yh;
  const float a_h = A[hi];
  const int nrt = L.nrt;

  for (int i = tid; i < DSP * L.ldh; i += NT) sH[i] = 0.0f;

  for (int c0 = 0; c0 < l; c0 += chunk) {
    __syncthreads();  // the last chunk's reads of the tiles and vectors are done
    copy_tile(sX, L.ldx, x + c0 * st.xl, st.xl, chunk, dh, DHP);
    copy_tile(sB, L.ldb, Bm + c0 * st.Bl, st.Bl, chunk, ds, DSP);
    copy_tile(sC, L.ldb, Cm + c0 * st.Cl, st.Cl, chunk, ds, DSP);
    cp_async_commit();
    for (int k = tid; k < chunk; k += NT) {
      const float d = dt[(c0 + k) * st.dl];
      sDt[k] = d;
      sLa[k] = d * a_h;
    }
    cp_async_wait<0>();
    __syncthreads();

    blocked_decays<NT>(dec, chunk);

    // y: quad q takes row tiles q and nrt - 1 - q (then q + 4, ...)
    const bool inter = c0 > 0;
    for (int pr = quad; pr < (nrt + 1) / 2; pr += 4) {
      row_tile<DSP, NP>(w, pr, inter, y + c0 * st.yl, st.yl, dh);
      if (nrt - 1 - pr != pr) {
        row_tile<DSP, NP>(w, nrt - 1 - pr, inter, y + c0 * st.yl, st.yl, dh);
      }
    }
    if (c0 + chunk >= l) break;
    __syncthreads();  // every warp has read H^T

    // H^T = exp(total) H^T + (coef o B)^T x: quad q owns state rows
    // [16 q, 16 q + 16) (then + 64, ...) for its share of the head dim; the
    // chunk's steps are the summed index, A's columns t and t + 4 standing
    // for steps 2t and 2t + 1 of each k-step (tf32_mma.cuh), 16 steps at a
    // time
    float total = 0.0f;
    for (int K = 0; K < nrt; ++K) total += sPre[16 * K + 15];
    const float decay = expf(total);
    for (int mt = quad; mt < ds / 16; mt += 4) {
      float acc[2 * NP][4];
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
      for (int kp = 0; kp < nrt; ++kp) {
        float part[2 * NP][4];
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
        for (int kk = 2 * kp; kk < 2 * kp + 2; ++kk) {
          const int r0 = 8 * kk + 2 * w.t;
          const float q0 = sCoef[r0], q1 = sCoef[r0 + 1];
          const float* b0 = sB + r0 * L.ldb + 16 * mt + w.g;
          const float* b1 = b0 + L.ldb;
          uint32_t ah[4], al[4];
          split_a(ah, al, q0 * b0[0], q0 * b0[8], q1 * b1[0], q1 * b1[8]);
          const float* x0 = sX + r0 * L.ldx + 16 * w.np0 + w.g;
          const float* x1 = x0 + L.ldx;
#pragma unroll
          for (int n = 0; n < 2 * NP; ++n) mma3(part[n], ah, al, x0[8 * n], x1[8 * n]);
        }
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float* hp = sH + (16 * mt + w.g + 8 * hf) * L.ldh + 16 * w.np0 + 8 * n + 2 * w.t;
          float2 hv = *reinterpret_cast<float2*>(hp);
          hv.x = decay * hv.x + acc[n][2 * hf];
          hv.y = decay * hv.y + acc[n][2 * hf + 1];
          *reinterpret_cast<float2*>(hp) = hv;
        }
      }
    }
  }
}

// The route: f32 (checked by the caller), dh, ds and the chunk multiples of
// 16, dh and ds at most 128, whole chunks, 16-byte aligned bases and
// strides (a size-1 dimension's stride is never stepped), and the layout
// within a block's shared memory.  ssd_scan.py's b5_route mirrors it.
bool takes(const void* x, const void* B, const void* C, const Strides& st, int b, int h, int l,
           int dh, int ds, int chunk) {
  bool ok = dh % 16 == 0 && ds % 16 == 0 && chunk % 16 == 0 && dh <= 128 && ds <= 128 &&
            l % chunk == 0;
  for (const void* p : {x, B, C}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const long long strides[] = {st.xb, st.xh, st.xl, st.Bb, st.Bl, st.Cb, st.Cl};
  const int sizes[] = {b, h, l, b, l, b, l};
  for (int i = 0; i < 7; ++i) ok = ok && (sizes[i] == 1 || strides[i] % 4 == 0);
  return ok && static_cast<size_t>(Layout(chunk, dh, ds).total) <= MAX_SMEM;
}

template <int DHP, int DSP>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B, const void* C,
                   void* y, const Strides& st, int b, int h, int l, int dh, int ds, int chunk,
                   cudaStream_t stream) {
  const int smem = Layout(chunk, dh, ds).total;
  auto kern = ssd_scan_tf32_kernel<DHP, DSP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<b * h, NT, smem, stream>>>(static_cast<const float*>(x), dt, A,
                                    static_cast<const float*>(B), static_cast<const float*>(C),
                                    static_cast<float*>(y), st, h, l, dh, ds, chunk);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const float* dt, const float* A, const void* B,
                     const void* C, void* y, const Strides& st, int b, int h, int l, int dh,
                     int ds, int chunk, cudaStream_t stream) {
  const int dhp = padded_dh(dh), dsp = padded_ds(ds);
  if (dhp == 32 && dsp == 64) return launch<32, 64>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
  if (dhp == 64 && dsp == 64) return launch<64, 64>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
  if (dhp <= 64) return launch<64, 128>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
  if (dsp == 64) return launch<128, 64>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
  return launch<128, 128>(x, dt, A, B, C, y, st, b, h, l, dh, ds, chunk, stream);
}

}  // namespace tf

}  // namespace

// strides: 13 element strides — x (batch, head, step), dt (batch, head,
// step), B (batch, step), C (batch, step), y (batch, head, step); the last
// dim of x, B, C and y is contiguous.  dtype (of x, B, C, y): 0 f32, 1 bf16
// (each on its tensor-core kernel where tf::takes / tc::takes, else the
// CUDA-core kernel), 2 bf16 and 3 f32 on the CUDA-core kernel whatever the
// shapes (for comparisons).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y, const long long* strides, int dtype, int b, int h, int l, int dh, int ds, int chunk, void* stream) {
  if (chunk < 1 || dh < 1 || ds < 1 || dtype < 0 || dtype > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0 || l == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2],  strides[3], strides[4],
                   strides[5], strides[6], strides[7],  strides[8], strides[9],
                   strides[10], strides[11], strides[12]};
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && tf::takes(x, B, C, st, b, h, l, dh, ds, chunk)) {
    err = tf::dispatch(x, dtf, Af, B, C, y, st, b, h, l, dh, ds, chunk, s);
  } else if (dtype == 0 || dtype == 3) {
    err = launch<float>(x, dtf, Af, B, C, y, st, b, h, l, dh, ds, chunk, s);
  } else if (dtype == 1 && tc::takes(x, B, C, st, b, h, l, dh, ds, chunk)) {
    err = tc::dispatch(x, dtf, Af, B, C, y, st, b, h, l, dh, ds, chunk, s);
  } else {
    err = launch<__nv_bfloat16>(x, dtf, Af, B, C, y, st, b, h, l, dh, ds, chunk, s);
  }
  return static_cast<int>(err);
}

// The CUDA-core kernel's plan for these shapes: returns ds_slice's width
// (ds: the whole-state Layout; less: SplitLayout; 0: none fits a block) and
// sets *smem_bytes to the layout's dynamic shared memory (at a width of 8
// where none fits).
extern "C" int ssd_scan_cuda_core_layout(int chunk, int dh, int ds, long long* smem_bytes) {
  if (chunk < 1 || dh < 1 || ds < 1) return 0;
  const int width = ds_slice(chunk, dh, ds);
  const int total = width == ds ? Layout(chunk, dh, ds).total
                                : SplitLayout(chunk, dh, ds, width == 0 ? 8 : width).total;
  *smem_bytes = static_cast<long long>(sizeof(float)) * total;
  return width;
}
