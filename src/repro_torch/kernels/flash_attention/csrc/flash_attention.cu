// Flash attention forward for Hopper (sm_90a):
//
//     o = softmax(q k^T * scale, causal mask rows >= cols) v
//
// for q (b, hq, sq, dh) and k, v (b, hkv, skv, dh), hq a multiple of hkv
// (GQA: q head h reads kv head h / (hq / hkv)), f32 or bf16 storage, f32
// softmax and accumulation, output in q's type.  The score matrix is never
// written to device memory.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:83, body
// _flash_kernel :26; its GQA wrapper ops.py:14 repeats the kv heads, here
// the kernel indexes them).  Same softmax: an online softmax with f32
// running max m, normaliser l and accumulator, masked scores at -1e30,
// p = 0 and the rescale factor 0 where they meet a masked value, and l = 0
// (a fully masked row) giving an output of 0.  Unlike the TPU kernel,
// ragged sq / skv are masked in the kernel (no multiple-of-128
// requirement), and causal kv tiles that lie wholly above the diagonal are
// skipped; blocks take the heaviest causal q tiles first.
//
// What bounds it on an H100.  Per head it does 4 sq skv dh flops (halved
// under the causal mask) against (2 sq + 2 skv) dh elements of traffic; at
// the serving slice (b = 4, 32 heads, sq = skv = 512, dh = 224) 15 GFLOP
// for 117 MB in bf16, 235 MB in f32.  Three routes, chosen by the entry
// point from the dtype, the head dim and the alignment alone
// (flash_attention.py's b4_route mirrors the choice):
//
// bf16 on the tensor cores (tc::, dh a multiple of 16, 16-byte aligned
// bases and strides: TMA needs both).  q k^T at 989 TFLOP/s and P v as two
// bf16 products to keep P's f32 precision: the bytes bound it, 0.035 ms:
//
//   * one block of two warpgroups (256 threads) owns 128 query rows of one
//     (batch, head), 64 rows a warpgroup; its Q tile stays in shared
//     memory and both warpgroups read every K / V tile, so one's softmax
//     overlaps the other's products; a warpgroup whose rows lie wholly
//     above a causal tile skips it;
//   * K / V tiles of 64 rows are loaded by TMA (one thread issues a 5-D
//     tensor-map copy per tile; rows past skv arrive as zeros) into a
//     two-stage ring with an mbarrier a stage, so tile i + 1 loads while
//     tile i is multiplied;
//   * shared memory holds each tile in the no-swizzle core-matrix layout
//     [dh / 8][rows][8 elements]: every 8 x 16-byte core matrix is 128
//     contiguous bytes, which wgmma reads without bank conflicts for any
//     dh that is a multiple of 16 (224 = 14 x 16), so dh needs no padding
//     and no swizzle;
//   * S = Q K^T is wgmma m64n64k16 bf16 x bf16 -> f32 with both operands
//     from shared memory (dh / 16 k-steps); the scale is applied to S in
//     f32 after the product (the reference pre-scales q in f32: the two
//     differ by f32 rounding);
//   * the online softmax runs on the accumulator fragments in registers,
//     each row reduced across the 4 lanes that hold it; P never goes to
//     shared memory;
//   * O += P V: P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//     each fed from registers as wgmma's A operand (the S fragment is
//     already A's layout) against V from shared memory read transposed
//     (MN-major), m64n32k16 per 32 output columns (plus one m64n16k16 for
//     a 16-column tail); the 64 x dh f32 accumulator lives in registers
//     (up to 128 a thread); at dh = 224 the Q tile and the K / V ring take
//     169 KB of shared memory, one block an SM.
//
// f32 on the tensor cores (tf::, dh a multiple of 8 up to 256, 16-byte
// aligned bases and strides).  "Highest" is f32 accuracy, so both products
// are 3xTF32 (../../hopper/csrc/tf32_mma.cuh): each f32 operand split into
// TF32 halves hi = tf32(x), lo = tf32(x - hi), rounded as cvt.rna rounds,
// and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi; one-pass TF32 misses the
// 2e-4 tolerance.  Three TF32 products at 495 TFLOP/s bound the slice at
// 0.091 ms (0.224 ms at the CUDA cores' 67):
//
//   * one block of 8 warps owns 128 query rows, 16 a warp; heaviest
//     causal tiles first; a warp whose rows lie past sq or wholly above a
//     causal tile skips it;
//   * Q (128 rows) and a two-stage ring of K / V tiles of 32 rows arrive
//     by cp.async (rows past sq / skv and columns past dh zero-filled) in
//     f32, rows of dh rounded up to 32 floats with element (r, c) at
//     column c ^ 4 (r % 8): every fragment load meets 32 distinct banks
//     with no padding, so dh = 224 fits Q and two stages in 229,376 bytes
//     (dh 232-256: one stage, 196,608);
//   * S = Q K^T is mma.sync m16n8k8 TF32, three a k-step, with the split
//     done in registers as the fragments load (the shared tiles stay f32:
//     hi and lo copies of Q, K and V would not fit); the tensor cores add
//     into their accumulator by truncation, so each 4 k-steps (12 mma) go
//     into a zeroed fragment added to S in IEEE f32;
//   * the online softmax runs on S's accumulator fragments in registers;
//     P's fragments serve as P V's A fragments unchanged, V's rows read in
//     the matching permuted order (tf32_mma.cuh), so P never goes to
//     shared memory;
//   * each kv tile's P V (4 k-steps, 12 mma) goes into a zeroed fragment,
//     then O = alpha O + P V in IEEE f32 (whisper's encoder sums 1,500 kv
//     rows); every product loop runs in guard-free groups of 4 independent
//     chains (32 columns; the zero-filled columns past dh add 0);
//   * what remains is instruction throughput and latency: mma.sync
//     reaches a fraction of the TF32 peak, every warp splits its own copy
//     of each K / V fragment (a few integer instructions a value, where
//     cvt.rna's longer sequence cost much of the time), and one block of 8
//     warps an SM at dh = 224 (PERF.md section 6).
//
// Everything else (f32 or bf16 that neither route takes) runs the CUDA-core
// kernel of the port's first version: one block of 256 threads per 64 query
// rows, f32 tiles staged into ~188 KB of shared memory, both products as
// scalar f32 FMAs.
//
// The launch goes on the caller's stream and the entry point returns
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and the cuTensorMapEncodeTiled prototype
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "../../hopper/csrc/hopper.cuh"    // TMA, mbarriers, wgmma
#include "../../hopper/csrc/tf32_mma.cuh"  // 3xTF32 mma.sync, cp.async

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per step
constexpr int NT = 256;         // threads per block
constexpr int PS = BK + 4;      // row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DH = 256;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
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

// f32 copies of the 16 bytes in `bits` (4 floats or 8 bf16), times `mul`,
// stored at dst (16-byte aligned).
__device__ __forceinline__ void store_f32(float* dst, const uint4& bits, float mul, float) {
  const float4 v = *reinterpret_cast<const float4*>(&bits);
  *reinterpret_cast<float4*>(dst) = make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul);
}
__device__ __forceinline__ void store_f32(float* dst, const uint4& bits, float mul, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&bits);
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
  *reinterpret_cast<float4*>(dst) = make_float4(f[0].x * mul, f[0].y * mul, f[1].x * mul, f[1].y * mul);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(f[2].x * mul, f[2].y * mul, f[3].x * mul, f[3].y * mul);
}

constexpr int UNROLL = 8;  // 16-byte loads in flight per thread while staging

// Stage `rows` rows of dh elements of src (row stride `stride` elements;
// rows at or past `valid` read as 0) into dst (row stride ld floats) as f32
// times `mul`.  With `vec` (16-byte aligned rows of a multiple of 16 bytes)
// each thread keeps up to UNROLL 16-byte loads in flight; otherwise one
// element a lane.  Columns past dh are left as they are (zero).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           long long stride, int rows, int valid, int dh,
                                           float mul, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int nv = dh / V;
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
          const int r = i / nv;
          store_f32(dst + r * ld + (i - r * nv) * V, buf[u], mul, T());
        }
      }
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    const bool ok = r < valid;
    const T* row = src + r * stride;
    for (int c = lane; c < dh; c += 32) dst[r * ld + c] = ok ? to_f32(row[c]) * mul : 0.0f;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// Row stride (floats) of the Q and K tiles: dh rounded up to 4 for float4
// reads, with stride / 4 odd, so that the eight lanes of a quarter warp
// reading eight consecutive rows hit 32 distinct banks.
__host__ __device__ inline int qk_stride(int dh) {
  const int d4 = (dh + 3) & ~3;
  return ((d4 / 4) % 2 == 0) ? d4 + 4 : d4;
}

__host__ __device__ inline int v_stride(int dh) { return (dh + 31) & ~31; }

inline size_t smem_bytes(int dh) {
  const int ds = qk_stride(dh), dv = v_stride(dh);
  return sizeof(float) * (static_cast<size_t>(BQ + BK) * ds + BK * dv + BQ * PS + 3 * BQ);
}

template <typename T, int DHMAX>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides st, int hq, int group, int sq, int skv, int dh,
    float scale, int causal, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int DS = qk_stride(dh);
  const int DV = v_stride(dh);
  const int nj = DV / 32;  // active 32-column groups of the accumulator
  const int d4 = (dh + 3) & ~3;
  float* sQ = smem;            // BQ x DS, pre-scaled
  float* sK = sQ + BQ * DS;    // BK x DS
  float* sV = sK + BK * DS;    // BK x DV
  float* sP = sV + BK * DV;    // BQ x PS
  float* sM = sP + BQ * PS;    // running max
  float* sL = sM + BQ;         // running normaliser
  float* sA = sL + BQ;         // this step's rescale factor

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = bh / hq, h = bh % hq, hk = h / group;
  q += b * st.qb + h * st.qh;
  k += b * st.kb + hk * st.kh;
  v += b * st.vb + hk * st.vh;
  o += b * st.ob + h * st.oh;

  // zero once: the columns past dh of the Q / K / V tiles stay zero
  for (int i = tid; i < (BQ + BK) * DS + BK * DV; i += NT) smem[i] = 0.0f;
  __syncthreads();
  stage_rows(sQ, DS, q + static_cast<long long>(q0) * st.qs, st.qs, BQ, sq - q0, dh, scale, vec);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.0f;
  }

  // S-phase mapping: rows ty + 16 i, columns tx + 16 j (i, j < 4)
  const int ty = tid / 16, tx = tid % 16;
  // PV-phase mapping: rows warp + 8 i (i < 8), columns lane + 32 j
  constexpr int NJ = DHMAX / 32;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + BQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last step's reads of sK / sV / sP are done
    stage_rows(sK, DS, k + static_cast<long long>(k0) * st.ks, st.ks, BK, skv - k0, dh, 1.0f, vec);
    stage_rows(sV, DV, v + static_cast<long long>(k0) * st.vs, st.vs, BK, skv - k0, dh, 1.0f, vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < d4; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * DS + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * DS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
        }
      }
    }

    // mask, then the online softmax of each row across its 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < skv && (!causal || row >= col);
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= 0.5f * NEG_INF ? 0.0f : __expf(s[i][j] - m_new);
        sP[r * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float alpha = m_prev <= 0.5f * NEG_INF ? 0.0f : __expf(m_prev - m_new);
      __syncwarp();  // every lane has read sM[r] before lane 0 writes it
      if (tx == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = sA[warp + 8 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[i] = *reinterpret_cast<const float4*>(sP + (warp + 8 * i) * PS + kk);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const float vv = sV[(kk + t) * DV + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(lane_of(p[i], t), vv, acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();  // sL is final (and initialised when no kv tile ran)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    const int row = q0 + r;
    if (row >= sq) continue;
    float l = sL[r];
    l = l == 0.0f ? 1.0f : l;  // a fully masked row gives 0
    T* orow = o + static_cast<long long>(row) * st.os;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (j < nj && c < dh) orow[c] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int DHMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
                   int vec, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DHMAX>;
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, hq, hq / hkv, sq, skv, dh, scale, causal, vec);
  return cudaGetLastError();
}

// 16-byte staging loads need 16-byte aligned bases and rows of q, k, v.
template <typename T>
bool vectorizable(const void* q, const void* k, const void* v, const Strides& st, int dh) {
  const long long strides[] = {st.qb, st.qh, st.qs, st.kb, st.kh, st.ks, st.vb, st.vh, st.vs};
  bool ok = (dh * sizeof(T)) % 16 == 0;
  for (const void* p : {q, k, v}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : strides) ok = ok && (s * static_cast<long long>(sizeof(T))) % 16 == 0;
  return ok;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                     int b, int hq, int hkv, int sq, int skv, int dh, float scale,
                     int causal, cudaStream_t stream) {
  const int vec = vectorizable<T>(q, k, v, st, dh) ? 1 : 0;
  if (dh <= 64) return launch<T, 64>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, vec, stream);
  if (dh <= 128) return launch<T, 128>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, vec, stream);
  return launch<T, 256>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, vec, stream);
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core path: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WQ = 64;   // query rows per warpgroup (one wgmma M)
constexpr int BQ = 128;  // query rows per block: two warpgroups
constexpr int BK = 64;   // kv rows per tile (S's wgmma N)
constexpr int NT = 256;  // two warpgroups
constexpr int CORE = 128;  // bytes of one 8 x 16-byte core matrix

// The three tensor maps go to the kernel as one __grid_constant__ struct.
struct Maps {
  CUtensorMap q, k, v;
};

// TMA, mbarriers and wgmma: ../../hopper/csrc/hopper.cuh
using namespace hopper;

// One tile of a (8, rows, dh / 8, heads, batch) tensor map: box
// (8, box rows, dh / 8, 1, 1), which lands as [dh / 8][box rows][8] in
// shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head, int batch) {
  tma_load_5d(dst, map, bar, 0, row, 0, head, batch);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x - float(bf16(x)), the part of x that bf16 drops
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ inline size_t tile_bytes(int rows, int dh) {
  return static_cast<size_t>(rows) * dh * 2;
}

// Q, two K and two V stages, plus 1 KB to align the base to 1,024 bytes.
inline size_t smem_bytes(int dh) { return tile_bytes(BQ, dh) + 4 * tile_bytes(BK, dh) + 1024; }

// Accumulator fragment of wgmma m64nN (f32): register 4i + e of thread
// (warp w, lane l) holds row 16 w + l / 4 + 8 (e / 2) and column
// 8 i + 2 (l % 4) + e % 2 of its 64 x N tile.
template <int DHMAX>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tc_kernel(
    const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o, long long ob,
    long long oh, long long os, int hq, int group, int sq, int skv, int dh, float scale,
    int causal) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // Q, K/V stage 0, K/V stage 1
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const size_t tq = tile_bytes(BQ, dh), tb = tile_bytes(BK, dh);
  // Q, then K and V of stage 0, then of stage 1 (by offset: an array of
  // pointers indexed by the stage would live in local memory)
  unsigned char* sQ = base;
  auto sK = [&](int st) { return base + tq + 2 * st * tb; };
  auto sV = [&](int st) { return base + tq + (2 * st + 1) * tb; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // warpgroup: query rows q0 + 64 wg ..
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q_last = min(q0 + BQ, sq) - 1;  // the block's last row: its kv tiles
  const int wq0 = q0 + WQ * wg;             // this warpgroup's first row
  const int wq_last = min(wq0 + WQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int tiles = (kv_end + BK - 1) / BK;
  const uint32_t kv_bytes = static_cast<uint32_t>(2 * tb);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], static_cast<uint32_t>(tq));
    tma_load(sQ, &maps.q, &bars[0], q0, h, b);
    for (int s = 0; s < 2 && s < tiles; ++s) {
      mbar_expect_tx(&bars[1 + s], kv_bytes);
      tma_load(sK(s), &maps.k, &bars[1 + s], s * BK, hk, b);
      tma_load(sV(s), &maps.v, &bars[1 + s], s * BK, hk, b);
    }
  }

  constexpr int NC = DHMAX / 32;  // 32-column tiles of the accumulator
  const int full = dh / 32;       // of which this dh fills
  const bool tail = (dh % 32) != 0;  // plus one 16-column tile
  float acc[NC][16];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[c][e] = 0.0f;
  }
  // two rows a thread: wq0 + r0 and wq0 + r0 + 8, r0 = 16 (warp % 4) + lane / 4
  const int r0 = 16 * (warp % 4) + lane / 4;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.0f, 0.0f};  // this thread's columns' share

  // this warpgroup's 64 rows of the Q tile: rows are 16 bytes apart within
  // a column of core matrices, which are BQ * 16 bytes apart
  const uint32_t q_addr = smem_addr(sQ) + WQ * 16 * wg;
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    const int k0 = it * BK;
    mbar_wait(&bars[1 + st], (it >> 1) & 1);
    const uint32_t k_addr = smem_addr(sK(st));
    const uint32_t v_addr = smem_addr(sV(st));
    // a warpgroup whose rows all lie past sq, or (causal) above this whole
    // tile, has nothing to add: it only keeps the block's barriers
    if (wq0 < sq && !(causal && k0 > wq_last)) {

      // ---- S = Q K^T: K-major operands, LBO = next 8 features (a 64-row
      // column of core matrices, 1,024 bytes), SBO = next 8 rows (128) ----
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DHMAX / 16; ++j) {
        if (j < dh / 16) {
          const uint32_t off = j * 2 * BK * 16;
          wgmma_ss_n64(s, desc(q_addr + 2 * j * BQ * 16, BQ * 16, CORE),
                       desc(k_addr + off, BK * 16, CORE), j > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_group<0>();
      fence_regs(s);

      // ---- mask, scale and the online softmax in registers ----
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = wq0 + r0 + 8 * hr;
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * i + 2 * (lane % 4) + e;
            const bool ok = col < skv && (!causal || row >= col);
            float& v = s[4 * i + 2 * hr + e];
            v = ok ? v * scale : NEG_INF;
            mx = fmaxf(mx, v);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = s[4 * i + 2 * hr + e];
            v = v <= 0.5f * NEG_INF ? 0.0f : __expf(v - m_new);
            sum += v;
          }
        }
        alpha[hr] = m_run[hr] <= 0.5f * NEG_INF ? 0.0f : __expf(m_run[hr] - m_new);
        m_run[hr] = m_new;
        l_run[hr] = l_run[hr] * alpha[hr] + sum;
      }

      // ---- P hi / lo as wgmma A fragments: k-step j covers S columns
      // 16 j .. 16 j + 15, S's n8 tiles 2 j and 2 j + 1 ----
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // r: (row r0, cols 2c..) (r0 + 8, 2c..) (r0, 2c + 8..) (r0 + 8, 2c + 8..)
          const int i = 2 * j + r / 2;
          const int e = 2 * (r % 2);
          const float x = s[4 * i + e], y = s[4 * i + e + 1];
          p_hi[j][r] = pack_bf16(x, y);
          p_lo[j][r] = pack_bf16(bf16_rest(x), bf16_rest(y));
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[c][e] *= alpha[(e / 2) % 2];
      }

      // ---- O += P_lo V + P_hi V: V MN-major, LBO = next 8 kv rows (128
      // bytes), SBO = next 8 features (1,024) ----
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint64_t dv = desc(v_addr + j * 2 * CORE + c * 4 * BK * 16, CORE, BK * 16);
          if (c < full) {
            wgmma_rs<32>(acc[c], p_lo[j], dv);
            wgmma_rs<32>(acc[c], p_hi[j], dv);
          } else if (c == full && tail) {
            // the first 8 registers of the 32-column tile
            float(&lo)[8] = *reinterpret_cast<float(*)[8]>(&acc[c][0]);
            wgmma_rs<16>(lo, p_lo[j], dv);
            wgmma_rs<16>(lo, p_hi[j], dv);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_group<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    }

    __syncthreads();  // every warp is done with this stage's K and V
    if (tid == 0 && it + 2 < tiles) {
      mbar_expect_tx(&bars[1 + st], kv_bytes);
      tma_load(sK(st), &maps.k, &bars[1 + st], k0 + 2 * BK, hk, b);
      tma_load(sV(st), &maps.v, &bars[1 + st], k0 + 2 * BK, hk, b);
    }
  }

  // ---- o = acc / l (l = 0: a fully masked row gives 0) ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;
    const int row = wq0 + r0 + 8 * hr;
    if (row >= sq) continue;
    __nv_bfloat16* orow = o + b * ob + h * oh + static_cast<long long>(row) * os;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * c + 8 * i + 2 * (lane % 4);
        if (col < dh) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[c][4 * i + 2 * hr] * inv, acc[c][4 * i + 2 * hr + 1] * inv);
        }
      }
    }
  }
}

// (8, rows, dh / 8, heads, batch) view of a bf16 tensor with element strides
// (batch, head, row); box (8, box_rows, dh / 8, 1, 1).
bool encode(CUtensorMap* map, const void* ptr, int batch, int heads, int rows, int dh,
            long long sb, long long sh, long long sr, int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {8, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(dh / 8),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sr) * 2, 16,
                                 static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(dh / 8), 1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes 16-byte aligned bases and byte strides (a size-1 dimension's
// stride is never used and may be anything) and no empty dimension, and the
// k-steps need dh a multiple of 16.
bool takes(const void* q, const void* k, const void* v, const Strides& st, int b, int hq,
           int hkv, int sq, int skv, int dh) {
  bool ok = dh % 16 == 0 && skv > 0;
  for (const void* p : {q, k, v}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const long long strides[] = {st.qb, st.qh, st.qs, st.kb, st.kh, st.ks, st.vb, st.vh, st.vs};
  const int sizes[] = {b, hq, sq, b, hkv, skv, b, hkv, skv};
  for (int i = 0; i < 9; ++i) {
    ok = ok && (sizes[i] == 1 || ((strides[i] * 2) % 16 == 0 && strides[i] > 0));
  }
  return ok && (st.os * 2) % 4 == 0;
}

template <int DHMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
                   cudaStream_t stream) {
  Maps maps;
  // a size-1 dimension's stride is never stepped: give TMA a legal one
  auto fix = [](long long s, int n) { return n == 1 ? 16LL : s; };
  if (!encode(&maps.q, q, b, hq, sq, dh, fix(st.qb, b), fix(st.qh, hq), fix(st.qs, sq), BQ) ||
      !encode(&maps.k, k, b, hkv, skv, dh, fix(st.kb, b), fix(st.kh, hkv), fix(st.ks, skv), BK) ||
      !encode(&maps.v, v, b, hkv, skv, dh, fix(st.vb, b), fix(st.vh, hkv), fix(st.vs, skv), BK)) {
    return cudaErrorInvalidValue;
  }
  auto kern = flash_fwd_tc_kernel<DHMAX>;
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(maps, static_cast<__nv_bfloat16*>(o), st.ob, st.oh, st.os,
                                   hq, hq / hkv, sq, skv, dh, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                     int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
                     cudaStream_t stream) {
  if (dh <= 64) return launch<64>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, stream);
  if (dh <= 128) return launch<128>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, stream);
  return launch<256>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The f32 tensor-core path: 3xTF32 mma.sync m16n8k8, cp.async, swizzled tiles
// ---------------------------------------------------------------------------

namespace tf {

constexpr int BQ = 128;  // query rows per block: 8 warps of 16
constexpr int BK = 32;   // kv rows per tile: 4 n8 tiles of S, 4 k-steps of P V
constexpr int NT = 256;  // threads per block
constexpr int KG = 4;    // k-steps of S summed into one zeroed partial (12 mma)

// Row stride (floats) of every tile: dh rounded up to 32, so that the
// swizzle below stays within a row.
__host__ __device__ inline int row_stride(int dh) { return (dh + 31) & ~31; }

// Q, then `stages` pairs of K and V tiles.
inline size_t smem_bytes(int dh, int stages) {
  return sizeof(float) * row_stride(dh) * static_cast<size_t>(BQ + 2 * BK * stages);
}

// Two stages where they fit (dh <= 224), else one.
inline int stages(int dh) { return smem_bytes(dh, 2) <= MAX_SMEM ? 2 : 1; }

// split, mma3, split_a, cp.async: ../../hopper/csrc/tf32_mma.cuh
using namespace tf32;

// Tiles are stored row-major at row_stride(dh) floats with element (r, c)
// at column c ^ 4 (r % 8): the 16-byte pieces of a row stay whole, and
// each fragment load below (8 rows x 4 columns of Q or K, 4 row pairs x 8
// columns of V) meets 32 distinct banks.  P's accumulator fragments serve
// as P V's A fragments with V's rows read in the permuted order of
// tf32_mma.cuh.
template <int DHMAX>
__global__ void __launch_bounds__(NT, DHMAX <= 64 ? 2 : 1) flash_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, Strides st, int hq, int group, int sq, int skv, int dh, float scale,
    int causal, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(dh);
  float* sQ = smem;  // BQ x ld, then the K / V stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  q += b * st.qb + h * st.qh;
  k += b * st.kb + hk * st.kh;
  v += b * st.vb + hk * st.vh;
  o += b * st.ob + h * st.oh;
  const int q_last = min(q0 + BQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int tiles = (kv_end + BK - 1) / BK;
  const int wq0 = q0 + 16 * warp;  // this warp's first row
  const int wq_last = min(wq0 + 16, sq) - 1;
  const int nd = dh / 8;  // k-steps of S, n8 tiles of O
  const int pieces = ld / 4;

  // rows [0, rows) of src into dst, swizzled; rows >= valid and the
  // columns past dh zero-filled, so that the products run in whole groups
  // of 4 k-steps or n8 tiles (32 columns) with no guard inside a group
  auto stage = [&](float* dst, const float* src, long long stride, int rows, int valid) {
    for (int i = tid; i < rows * pieces; i += NT) {
      const int r = i / pieces, c = 4 * (i - r * pieces);
      const bool ok = r < valid && c < dh;
      cp_async16(dst + r * ld + (c ^ ((r & 7) << 2)), src + (ok ? r * stride + c : 0),
                 ok ? 16 : 0);
    }
  };
  auto sK = [&](int s) { return smem + (BQ + 2 * BK * s) * ld; };
  auto load_tile = [&](int it, int s) {
    if (it < tiles) {
      const int k0 = it * BK;
      stage(sK(s), k + k0 * st.ks, st.ks, BK, skv - k0);
      stage(sK(s) + BK * ld, v + k0 * st.vs, st.vs, BK, skv - k0);
    }
    cp_async_commit();  // one group a tile, empty past the last
  };
  stage(sQ, q + q0 * st.qs, st.qs, BQ, sq - q0);
  load_tile(0, 0);
  if (stages == 2) load_tile(1, 1);

  // Q / K columns: 32 (kk / 4) + qsw[2 (kk % 4) + half] + t for rows = g mod 8
  int qsw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qsw[j] = 4 * (j ^ g);
  // V columns of n8 tile n for rows 2t, 2t + 1 mod 8: 32 (n / 4) + vsw[n % 4]
  // + g, resp. + (g ^ 4)
  int vsw[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) vsw[m] = 8 * (m ^ t);

  constexpr int ND = DHMAX / 8;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.0f, 0.0f};  // this thread's columns' share
  const float* qa = sQ + (16 * warp + g) * ld;

  for (int it = 0; it < tiles; ++it) {
    const int s_ = stages == 2 ? it & 1 : 0;
    if (stages == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = it * BK;
    // a warp whose rows all lie past sq, or (causal) above this whole
    // tile, has nothing to add
    if (wq0 < sq && !(causal && k0 > wq_last)) {
      const float* kt = sK(s_);
      const float* vt = kt + BK * ld;

      // ---- S = Q K^T, in partials of KG k-steps ----
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kg = 0; kg < ND; kg += KG) {
        if (kg < nd) {
          float part[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
          for (int kk = kg; kk < kg + KG; ++kk) {
            const int c0 = 32 * (kk / 4) + qsw[2 * (kk % 4)] + t;
            const int c1 = 32 * (kk / 4) + qsw[2 * (kk % 4) + 1] + t;
            uint32_t ah[4], al[4];
            split_a(ah, al, qa[c0], qa[8 * ld + c0], qa[c1], qa[8 * ld + c1]);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float* kr = kt + (8 * n + g) * ld;
              mma3(part[n], ah, al, kr[c0], kr[c1]);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
          }
        }
      }

      // ---- mask, scale and the online softmax in registers ----
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = wq0 + g + 8 * hr;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * n + 2 * t + e;
            const bool ok = col < skv && (!causal || row >= col);
            float& x = s[n][2 * hr + e];
            x = ok ? x * scale : NEG_INF;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * hr + e];
            x = x <= 0.5f * NEG_INF ? 0.0f : __expf(x - m_new);
            sum += x;
          }
        }
        alpha[hr] = m_run[hr] <= 0.5f * NEG_INF ? 0.0f : __expf(m_run[hr] - m_new);
        m_run[hr] = m_new;
        l_run[hr] = l_run[hr] * alpha[hr] + sum;
      }

      // ---- P as A fragments (k-step j = S's n8 tile j, columns permuted) ----
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_a(ph[j], pl[j], s[j][0], s[j][2], s[j][1], s[j][3]);

      // ---- O = alpha O + P V, each n8 tile's P V in a zeroed fragment,
      // four n8 tiles (32 columns) at a time ----
      const float* v0 = vt + 2 * t * ld;  // kv rows 2t and 2t + 1 of each k-step
#pragma unroll
      for (int n0 = 0; n0 < ND; n0 += 4) {
        if (n0 < nd) {
          float pv[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int col = 32 * (n0 / 4) + vsw[n];
              mma3(pv[n], ph[j], pl[j], v0[8 * j * ld + col + g],
                   v0[(8 * j + 1) * ld + col + (g ^ 4)]);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float* a = acc[n0 + n];
            a[0] = a[0] * alpha[0] + pv[n][0];
            a[1] = a[1] * alpha[0] + pv[n][1];
            a[2] = a[2] * alpha[1] + pv[n][2];
            a[3] = a[3] * alpha[1] + pv[n][3];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage's K and V
    load_tile(it + stages, s_);
  }
  cp_async_wait<0>();

  // ---- o = acc / l (l = 0: a fully masked row gives 0) ----
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;
    const int row = wq0 + g + 8 * hr;
    if (row >= sq) continue;
    float* orow = o + static_cast<long long>(row) * st.os;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (n < nd) {
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
            make_float2(acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
      }
    }
  }
}

// The route: f32 (checked by the caller) with dh a multiple of 8, and
// 16-byte aligned bases and (batch, head, row) strides of q, k and v (a
// size-1 dimension's stride is never stepped).  flash_attention.py's
// b4_route mirrors it.
bool takes(const void* q, const void* k, const void* v, const Strides& st, int b, int hq,
           int hkv, int sq, int skv, int dh) {
  bool ok = dh % 8 == 0;
  for (const void* p : {q, k, v}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const long long strides[] = {st.qb, st.qh, st.qs, st.kb, st.kh, st.ks, st.vb, st.vh, st.vs};
  const int sizes[] = {b, hq, sq, b, hkv, skv, b, hkv, skv};
  for (int i = 0; i < 9; ++i) ok = ok && (sizes[i] == 1 || (strides[i] > 0 && strides[i] % 4 == 0));
  return ok;
}

template <int DHMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
                   cudaStream_t stream) {
  const int ns = stages(dh);
  const size_t smem = smem_bytes(dh, ns);
  auto kern = flash_fwd_tf32_kernel<DHMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(o), st, hq,
                                   hq / hkv, sq, skv, dh, scale, causal, ns);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                     int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
                     cudaStream_t stream) {
  if (dh <= 64) return launch<64>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, stream);
  if (dh <= 128) return launch<128>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, stream);
  return launch<256>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, stream);
}

}  // namespace tf

}  // namespace

// strides: 12 element strides (batch, head, sequence) of q, k, v and o, in
// that order; the head dimension is contiguous.  dtype: 0 f32, 1 bf16, each
// on its tensor-core route where tf::takes / tc::takes, else on the
// CUDA-core kernel.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, const long long* strides, int dtype, int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal, void* stream) {
  if (dh < 1 || dh > MAX_DH || hkv < 1 || hq % hkv != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && tf::takes(q, k, v, st, b, hq, hkv, sq, skv, dh)) {
    err = tf::dispatch(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  } else if (dtype == 0) {
    err = dispatch<float>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  } else if (tc::takes(q, k, v, st, b, hq, hkv, sq, skv, dh)) {
    err = tc::dispatch(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  } else {
    err = dispatch<__nv_bfloat16>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  }
  return static_cast<int>(err);
}

namespace {

// For each of n f32 bit patterns x, four words: the 3xTF32 split's hi and
// lo (tf32_mma.cuh), and cvt.rna.tf32.f32 of x and of x - hi.
__global__ void tf32_split_check_kernel(const uint32_t* in, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __uint_as_float(in[i]);
  uint32_t hi, lo, cvt_hi, cvt_lo;
  tf32::split(x, hi, lo);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(cvt_hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(cvt_lo) : "f"(x - __uint_as_float(hi)));
  out[4 * i] = hi;
  out[4 * i + 1] = lo;
  out[4 * i + 2] = cvt_hi;
  out[4 * i + 3] = cvt_lo;
}

}  // namespace

// A test hook beside the entry point: out (4 n words) gets the split and
// cvt.rna's rounding of n uint32 bit patterns, so that a test holds the
// 3xTF32 split to cvt.rna.
extern "C" int tf32_split_check(const void* in, void* out, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  tf32_split_check_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
