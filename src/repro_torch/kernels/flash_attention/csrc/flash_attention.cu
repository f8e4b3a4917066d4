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
// the serving slice (b = 4, 32 heads, sq = skv = 512, dh = 224, bf16)
// 15 GFLOP for 117 MB.  On the bf16 tensor cores (q k^T at 989 TFLOP/s,
// P v as two bf16 products to keep P's f32 precision) the bytes bound it,
// 0.035 ms; on the CUDA cores in f32 the operations do, 0.22 ms.  So the
// bf16 path runs both products on the tensor cores:
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
// The f32 path, and bf16 whose head dim is not a multiple of 16 or whose
// rows are not 16-byte aligned (TMA needs both), keep the CUDA-core kernel
// of the port's first version: one block of 256 threads per 64 query
// rows, f32 tiles staged into ~188 KB of shared memory, both products as
// scalar f32 FMAs.  The dtype and the strides choose the path.
//
// The launch goes on the caller's stream and the entry point returns
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and the cuTensorMapEncodeTiled prototype
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per step
constexpr int NT = 256;         // threads per block
constexpr int PS = BK + 4;      // row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DH = 256;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of this parity completes.  A phase that
// never completes (a wrong byte count) traps after ~10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > (1LL << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One tile of a (8, rows, dh / 8, heads, batch) tensor map: box
// (8, box rows, dh / 8, 1, 1), which lands as [dh / 8][box rows][8] in
// shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(0), "r"(head), "r"(batch),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle (layout type 0): start
// address, leading-dimension and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses of a wgmma accumulator across
// the asynchronous instructions that own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) = (acc ? d : 0) + A (64 x 16) B (16 x 64), both bf16 from
// shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 32, f32) += A (64 x 16, bf16 in registers) B (16 x 32, bf16 from
// shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same for 16 output columns: the first 8 registers of an n32 tile.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
      wgmma_wait();
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
            wgmma_rs_n32(acc[c], p_lo[j], dv);
            wgmma_rs_n32(acc[c], p_hi[j], dv);
          } else if (c == full && tail) {
            wgmma_rs_n16(acc[c], p_lo[j], dv);
            wgmma_rs_n16(acc[c], p_hi[j], dv);
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
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

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled of the CUDA driver API, looked up once in
// libcuda.so.1, which the process has already loaded (no link-time
// dependency on libcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
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

}  // namespace

// strides: 12 element strides (batch, head, sequence) of q, k, v and o, in
// that order; the head dimension is contiguous.  dtype: 0 f32, 1 bf16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, const long long* strides, int dtype, int b, int hq, int hkv, int sq, int skv, int dh, float scale, int causal, void* stream) {
  if (dh < 1 || dh > MAX_DH || hkv < 1 || hq % hkv != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                   strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  } else if (tc::takes(q, k, v, st, b, hq, hkv, sq, skv, dh)) {
    err = tc::dispatch(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  } else {
    err = dispatch<__nv_bfloat16>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  }
  return static_cast<int>(err);
}
