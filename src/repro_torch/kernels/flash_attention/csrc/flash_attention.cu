// Flash attention forward for Hopper (sm_90a):
//
//     o = softmax(q k^T * scale, causal mask rows >= cols) v
//
// for q (b, hq, sq, dh) and k, v (b, hkv, skv, dh), hq a multiple of hkv
// (GQA: q head h reads kv head h / (hq / hkv)), f32 or bf16 storage, f32
// math, output in q's type.  The score matrix is never written to device
// memory.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py:83, body
// _flash_kernel :26; its GQA wrapper ops.py:14 repeats the kv heads, here
// the kernel indexes them).  Same arithmetic: q cast to f32 and scaled
// before its dot, an online softmax with f32 running max m, normaliser l
// and accumulator, masked scores at -1e30, p = 0 and the rescale factor 0
// where they meet a masked value, and l = 0 (a fully masked row) giving
// an output of 0.  Unlike the TPU kernel, ragged sq / skv are masked in
// the kernel (no multiple-of-128 requirement), and causal kv tiles that
// lie wholly above the diagonal are skipped.
//
// Work: per head 4 sq skv dh flops (halved under the causal mask) against
// (2 sq + 2 skv) dh elements of traffic; at the serving slice (b = 4,
// 32 heads, sq = skv = 512, dh = 224, bf16) 15 GFLOP for 117 MB.  At the
// card's rates for these types (q k^T on the bf16 tensor cores, P v as
// two bf16 products to keep P's f32 precision) the bytes bound it.  This
// first version does all of it in f32 on the CUDA cores (f32 math, as
// the reference; no tensor cores yet).  The design keeps the scores on
// chip:
//
//   * one block of 256 threads owns 64 query rows of one (batch, head),
//     its scaled Q tile in shared memory and its 64 x dh f32 accumulator
//     in registers (8 rows x dh/32 columns a thread);
//   * it walks 64-row K / V tiles in order: S = Q K^T from shared memory
//     (a 4 x 4 register tile a thread, float4 reads along dh with row
//     strides padded so that eight rows land on distinct banks), the
//     online softmax by 16-lane shuffles, P to shared memory, then
//     O = alpha O + P V;
//   * tiles are staged from device memory with 16-byte loads, up to 8 in
//     flight a thread, when rows are 16-byte aligned (the model's views
//     are); one element a lane otherwise;
//   * dh = 224 needs ~188 KB of dynamic shared memory (one block an SM);
//   * blocks take the heaviest causal q tiles first.
//
// The launch goes on the caller's stream and the entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s)
                 : dispatch<__nv_bfloat16>(q, k, v, o, st, b, hq, hkv, sq, skv, dh, scale, causal, s);
  return static_cast<int>(err);
}
