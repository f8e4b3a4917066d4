// The bf16 tile loop of the kernel-matrix kernels under precision="mixed",
// shared by kernel_matmul_bf16.cu (B1/B2) and fused_cg_step_bf16.cu (B3):
// the counterpart of the TPU kernels' mixed tile, _masked_kernel_tile
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:119, the distance's
// inner product on the MXU from bf16 operands with f32 accumulation,
// :133-138) and _tile_rhs_product (:154), on Hopper's warpgroup
// instructions.
//
// What bounds it on an H100: at narrow t (a CG iteration, t = 9) the
// kernel map on the SFU (common.cuh's stationary<KT>: one ex2 an entry for
// RBF, one rsqrt and one ex2 for Matern, 16 a clock an SM: 0.77 ms for
// Matern at n = 40,000) with ~12 f32 instructions an entry beside it; at
// wide t (the Gram product, predict's 256 columns) the product on the
// tensor cores, 2 t flops an entry.  The design leaves only the map on
// the CUDA cores:
//
//   * X/l comes as bf16, rows padded with zeros to dp (a multiple of 16)
//     features: one staged copy a solve (kernel_matmul.stage_bf16), never
//     one a launch; zero features change no distance.  So the kernels
//     require X to hold bf16 values (the staging rounds it to them);
//   * S = X1 X2^T for a warpgroup's 64 rows and a 64-column tile is wgmma
//     m64n64k16 with both operands in shared memory, dp / 16 k-steps, each
//     into a zeroed fragment added in IEEE f32 (the tensor cores add by
//     truncation);
//   * the norms |x|^2 are the diagonals of a tile's product with itself,
//     taken by those instructions (norms_bf16_kernel, a pass of a few
//     microseconds before the product): products of bf16 values are exact
//     in f32 and equal vectors give equal sums, so coincident points (the
//     diagonal of K(X, X) among them) give d2 = n1 + n2 - 2 S = 0 exactly
//     with no branch, also where X1 and X2 are other points (a cross
//     product keeps its own diagonal's distances).  A column tile's 64
//     norms come by TMA with it;
//   * the entries are formed in registers in S's accumulator layout:
//     d2 = max(n1 + n2 - 2 S, 0), stationary<KT>, sigma2 added only in a
//     tile that meets the global diagonal and the column mask applied only
//     in the ragged last tile (every other tile runs the map without a
//     branch), then rounded to bf16 to nearest two at a time straight into
//     wgmma's register A layout (S's n8 tiles 2j and 2j + 1 are the A
//     fragment of k-step j), as B4 packs P; nothing goes to shared memory;
//   * out += A M_tile is wgmma m64nTBk16 (TB = 16 .. 128 columns a block)
//     with A from registers and the M tile (MN-major) from shared memory,
//     four k-steps into a zeroed fragment, added to the running sum in
//     IEEE f32;
//   * a block owns 64 rows a warpgroup: one warpgroup (four blocks an SM at
//     16 columns), or two at 128 columns sharing every column tile.
//     Thread 0 keeps a ring of column tiles in flight by TMA (the X tile,
//     the bf16 M tiles of the block's batch elements and the norms; rows
//     past cols arrive as zeros), one mbarrier a stage for its bytes and
//     one for its release by every consumer warp.  Each warpgroup runs its
//     tiles as a software pipeline (tile_loop_bf16), so that the tensor
//     cores' round trips hide behind the map;
//   * up to 32 columns a block sums its products in chunks of 32 column
//     tiles, each from zero, and fold_chunks_kernel adds the chunks in
//     order: the sum's order is fixed by the columns alone, so a row tile's
//     chunks are split over blocks as the card's waves call for (40,000
//     rows are 625 warpgroup row tiles: 1.18 waves of four an SM) without
//     changing a bit, and row slices, shards and B2 keep B1's bits;
//   * B2: a block applies each tile's entries to up to 64 / TB batch
//     elements' M tiles, one product each, so an entry is formed once per
//     (row, column) for up to that many right-hand sides; per element the
//     instructions and the order of the sums are B1's, so B2's outputs
//     are b B1 launches' bits.
//
// The entries do not depend on the column block (the S and norm
// instructions are the same at every TB), so bf16 B1 against identity
// columns reads the entries that B3 multiplies.  No atomics.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "../../hopper/csrc/hopper.cuh"  // TMA, mbarriers, wgmma
#include "common.cuh"                    // stationary<KT>, the kernel types

namespace {

using namespace hopper;

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int TILE = 64;         // a warpgroup's rows; the columns of a tile
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // the most dynamic shared memory a block takes

// The column block of t columns (TB, the product's N): the narrowest of
// 16 .. max_tb that holds t.
inline int column_block_bf16(int t, int max_tb) {
  int tb = 16;
  while (tb < t && tb < max_tb) tb *= 2;
  return tb;
}

// Batch elements a block takes at a column block of tb when there are
// several: their accumulators together span 64 columns (B2 forms each entry
// once for that many).  One right-hand side takes 1.
__host__ __device__ constexpr int batch_block(int tb) { return tb >= 64 ? 1 : 64 / tb; }

// Consumer warpgroups a block: two at 128 columns (they share every column
// tile's M, the larger load), one below.
__host__ __device__ constexpr int warpgroups(int tb) { return tb >= 128 ? 2 : 1; }

// Shared memory of a block, in bytes from a 1,024-aligned base: the X1 rows
// ([dp / 8][64 wg][8] bf16), `stages` ring stages of an X2 tile
// ([dp / 8][64][8]) and the M tiles of the block's nb batch elements
// ([nb][tb / 8][64][8]), then each stage's 64 column norms.
struct Smem {
  int x1, x_tile, m_tile, stage, norms, total;
};

__host__ __device__ inline Smem smem_layout(int tb, int nb, int dp, int stages) {
  Smem s;
  s.x1 = TILE * warpgroups(tb) * dp * 2;
  s.x_tile = TILE * dp * 2;
  s.m_tile = TILE * tb * 2 * nb;
  s.stage = s.x_tile + s.m_tile;
  s.norms = s.x1 + stages * s.stage;
  s.total = s.norms + stages * TILE * 4 + 1024;  // + the base's alignment
  return s;
}

// The most stages (3 .. MAX_STAGES: the pipeline reads a tile's stage one
// step after it refills the stage two tiles back) whose shared memory
// fits, at least `floor_bytes` of ring (the epilogue's reuse); 0 when none
// fits.
inline int ring_stages(int tb, int nb, int dp, size_t floor_bytes) {
  for (int st = MAX_STAGES; st >= 3; --st) {
    const Smem s = smem_layout(tb, nb, dp, st);
    if (s.total <= SMEM_LIMIT && static_cast<size_t>(st) * s.stage >= floor_bytes) return st;
  }
  return 0;
}

// The tensor maps of a launch, one __grid_constant__ kernel argument.
struct Maps {
  CUtensorMap x1, x2, m, n2;
};

// Tensor maps over the staged X (rows, dp) bf16, viewed as (8, rows, dp / 8)
// with a box of (8, box_rows, dp / 8); over the bf16 right-hand side
// (batch, cols, tp), viewed as (8, cols, tp / 8, batch) with a box of
// (8, 64, tb / 8, nb); over the column norms (cols) f32, a box of 64.  The
// first two land in the core-matrix layouts of hopper.cuh.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_fn();
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_x(CUtensorMap* map, const void* X, int rows, int dp, int box_rows) {
  const cuuint64_t dims[3] = {8, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(dp / 8)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dp) * 2, 16};
  const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(dp / 8)};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, X, dims, strides, box);
}

// All four maps of a launch; with cols = 0 only X1's (no column tile is
// ever loaded).
inline bool encode_maps(Maps* maps, const void* X1, const void* X2, const void* M,
                        const float* n2, int rows, int cols, int dp, int tp, int batch, int tb,
                        int nb) {
  *maps = Maps{};
  if (!encode_x(&maps->x1, X1, rows, dp, TILE * warpgroups(tb))) return false;
  if (cols == 0) return true;
  const cuuint64_t m_dims[4] = {8, static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(tp / 8),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t m_strides[3] = {static_cast<cuuint64_t>(tp) * 2, 16,
                                   static_cast<cuuint64_t>(cols) * tp * 2};
  const cuuint32_t m_box[4] = {8, TILE, static_cast<cuuint32_t>(tb / 8),
                               static_cast<cuuint32_t>(nb)};
  const cuuint64_t n_dims[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint64_t n_strides[1] = {0};  // a rank-1 map has no stride
  const cuuint32_t n_box[1] = {TILE};
  return encode_x(&maps->x2, X2, cols, dp, TILE) &&
         encode(&maps->m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, M, m_dims, m_strides, m_box) &&
         encode(&maps->n2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, n2, n_dims, n_strides, n_box);
}

// f = A B^T for two K-major 64-row bf16 tiles in shared memory (A at a_addr
// with leading offset a_lbo, B at b_addr with b_lbo; rows 128 bytes apart
// within a core matrix), ks k-steps of 16 features, each into a zeroed
// fragment added in IEEE f32 in k order: gram_issue issues and commits
// k-step 0, gram_finish (once that group has completed) takes the others.
__device__ __forceinline__ void gram_issue(float (&f)[32], uint32_t a_addr, uint32_t a_lbo,
                                           uint32_t b_addr, uint32_t b_lbo) {
  wgmma_fence();
  wgmma_ss_n64_first(f, desc(a_addr, a_lbo, 128), desc(b_addr, b_lbo, 128));
  wgmma_commit();
}

__device__ __forceinline__ void gram_finish(float (&f)[32], uint32_t a_addr, uint32_t a_lbo,
                                            uint32_t b_addr, uint32_t b_lbo, int ks) {
  fence_regs(f);
  for (int j = 1; j < ks; ++j) {
    float g[32];
    gram_issue(g, a_addr + 2 * j * a_lbo, a_lbo, b_addr + 2 * j * b_lbo, b_lbo);
    wgmma_wait_group<0>();
    fence_regs(g);
#pragma unroll
    for (int e = 0; e < 32; ++e) f[e] += g[e];
  }
}

// |x|^2 of every staged row i < n of X (n, dp): the diagonal of its 64-row
// tile's Gram matrix, taken by the instructions that take S.  Row
// 16 w + g + 8 hr of the tile sits at column 8 (2 w + hr) + 2 c + e of the
// fragment, so the lanes with c == g / 2 hold it, in register
// 4 (2 w + hr) + 2 hr + (g & 1).  One warpgroup a tile; the tile staged by
// 16-byte loads into the core-matrix layout.
__global__ void __launch_bounds__(WG_THREADS) norms_bf16_kernel(const uint16_t* __restrict__ X,
                                                                float* __restrict__ out, int n,
                                                                int dp) {
  extern __shared__ __align__(128) unsigned char tile[];  // [dp / 8][64][8] bf16
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = blockIdx.x * TILE;
  for (int e = tid; e < TILE * (dp / 8); e += WG_THREADS) {
    const int q = e / TILE, r = e % TILE;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) {
      v = *reinterpret_cast<const uint4*>(X + static_cast<long long>(row0 + r) * dp + 8 * q);
    }
    *reinterpret_cast<uint4*>(tile + (q * TILE + r) * 16) = v;
  }
  fence_proxy_async();
  __syncthreads();
  float f[32];
  const uint32_t a = smem_addr(tile);
  gram_issue(f, a, TILE * 16, a, TILE * 16);
  wgmma_wait_group<0>();
  gram_finish(f, a, TILE * 16, a, TILE * 16, dp / 16);
  if (c == g / 2) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (warp == w) {  // warp-uniform: compile-time register indices
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int k = 4 * (2 * w + hr) + 2 * hr;
          const int row = row0 + 16 * w + g + 8 * hr;
          if (row < n) out[row] = (g & 1) ? f[k + 1] : f[k];
        }
      }
    }
  }
}

// The norms pass of one staged X into out (n floats).
inline cudaError_t launch_norms(const void* X, float* out, int n, int dp, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int smem = TILE * dp * 2;
  cudaError_t err = cudaFuncSetAttribute(norms_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  norms_bf16_kernel<<<(n + TILE - 1) / TILE, WG_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(X), out, n, dp);
  return cudaGetLastError();
}

// The norms of X2's columns into scratch[0 .. cols), and in *n1 X1's rows'
// norms: inside those when X1's rows are rows of X2 (X1 is X2, or a row
// panel or band of the same staged copy), else X1's own pass into
// scratch[cols .. cols + rows).
inline cudaError_t launch_all_norms(const void* X1, const void* X2, float* scratch, int rows,
                                    int cols, int dp, cudaStream_t stream, const float** n1) {
  const cudaError_t err = launch_norms(X2, scratch, cols, dp, stream);
  if (err != cudaSuccess) return err;
  const long long row_bytes = 2LL * dp;
  const long long gap = static_cast<const char*>(X1) - static_cast<const char*>(X2);
  if (gap >= 0 && gap % row_bytes == 0 && gap / row_bytes + rows <= cols) {
    *n1 = scratch + gap / row_bytes;
    return cudaSuccess;
  }
  *n1 = scratch + cols;
  return launch_norms(X1, scratch + cols, rows, dp, stream);
}

// Two f32 values rounded to bf16 (to nearest, ties to even) and packed, lo
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The kernel entries of one warpgroup tile, formed in place in S's
// fragment: s[4 i + 2 hr + e] becomes the entry of row r0 + 8 hr (global
// row grow + 8 hr) and tile column 8 i + 2 c + e (global column j0 + ...),
// n2 the tile's 64 column norms.  The one device function that forms B1's,
// B2's and B3's entries.
template <int KT>
__device__ __forceinline__ void entries(float (&s)[32], const float (&n1)[2], const float* n2,
                                        int c, int grow, int j0, int cols, float outputscale,
                                        float sigma2, bool diag, bool ragged) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 nc = *reinterpret_cast<const float2*>(n2 + 8 * i + 2 * c);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * i + 2 * hr + e];
        const float x = fmaf(-2.0f, v, n1[hr] + (e ? nc.y : nc.x));
        // max(x, 0); the Matern map's floor max(., 1e-20) subsumes it
        v = stationary<KT>(KT == RBF ? fmaxf(x, 0.0f) : x, outputscale);
      }
    }
  }
  if (diag) {  // the tile meets the global diagonal row == column
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (grow + 8 * (k / 2) == j0 + 8 * i + 2 * c + k % 2) s[4 * i + k] += sigma2;
      }
    }
  }
  if (ragged) {  // the last tile: columns past cols are zero
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + 8 * i + 2 * c + k % 2 >= cols) s[4 * i + k] = 0.0f;
      }
    }
  }
}

// The entries as wgmma's register A operand: k-step j covers tile columns
// 16 j .. 16 j + 15, S's n8 tiles 2 j and 2 j + 1.
__device__ __forceinline__ void pack_a(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 2 * j + r / 2;
      const int e = 2 * (r % 2);
      a[j][r] = pack_bf16x2(s[4 * i + e], s[4 * i + e + 1]);
    }
  }
}

// Chunks: at up to 32 right-hand-side columns each block sums the products
// of one chunk of a row tile's column tiles (chunk_tiles of them, from
// zero) and stores that sum; fold_chunks_kernel (B3:
// cg_epilogue_bf16_kernel) adds a row tile's chunks in order.  The sum's
// order is fixed by the columns alone, so the launch's blocks (row tiles
// x chunks) fill the card's waves at any row count without changing a
// bit.  At most MAX_CHUNKS chunks of at least 32 tiles (2,048 columns), so
// the chunks' sums stay a small multiple of the output.  Wider blocks
// keep one running sum over all the columns and store it.
constexpr int MAX_CHUNKS = 16;
__host__ __device__ constexpr bool chunked(int tb) { return tb <= 32; }
__host__ __device__ inline int chunk_tiles(int cols) {
  const int spread = ((cols + TILE - 1) / TILE + MAX_CHUNKS - 1) / MAX_CHUNKS;
  return spread > 32 ? spread : 32;
}
__host__ __device__ inline int chunk_count(int cols) {
  return ((cols + TILE - 1) / TILE + chunk_tiles(cols) - 1) / chunk_tiles(cols);
}

// The launch's scratch (the wrapper allocates it, kernel_matmul.py's
// _bf16_scratch mirrors this): the norms of X2's columns and X1's rows,
// rounded up to 4 floats, then (chunked) the chunks' sums, (chunk_count but
// at least 1, batch, rows, t).
inline long long norms_floats(int rows, int cols) { return (rows + cols + 3LL) / 4 * 4; }

// out[e] = chunks[0][e] + chunks[1][e] + ... in that order (0 without
// chunks), e < elems.
__global__ void __launch_bounds__(256) fold_chunks_kernel(const float* __restrict__ chunks,
                                                          float* __restrict__ out,
                                                          long long elems, int nchunks) {
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < elems; e += gridDim.x * 256LL) {
    float v = 0.0f;
    for (int k = 0; k < nchunks; ++k) v += chunks[k * elems + e];
    out[e] = v;
  }
}

inline cudaError_t launch_fold_chunks(const float* chunks, float* out, long long elems,
                                      int nchunks, cudaStream_t stream) {
  if (elems == 0) return cudaSuccess;
  const long long blocks = (elems + 255) / 256;
  fold_chunks_kernel<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                       stream>>>(chunks, out, elems, nchunks);
  return cudaGetLastError();
}

// A block's accumulators acc[q][4 i + 2 hr + e] (its warpgroup's row
// r0 + 8 hr, column t0 + 8 i + 2 c + e, batch element b0 + q < b0 + nb)
// stored into o (batch, rows, t), rows < rows and columns < t.
template <int TB, int NB>
__device__ __forceinline__ void store_acc(const float (&acc)[NB][TB / 2], float* __restrict__ o,
                                          int row0, int r0, int c, int t0, int b0, int nb,
                                          int rows, int t) {
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    if (q >= nb) continue;
    float* ob = o + static_cast<long long>(b0 + q) * rows * t;
#pragma unroll
    for (int k = 0; k < TB / 2; ++k) {
      const int row = row0 + r0 + 8 * ((k / 2) % 2);
      const int col = t0 + 8 * (k / 4) + 2 * c + k % 2;
      if (row < rows && col < t) ob[static_cast<long long>(row) * t + col] = acc[q][k];
    }
  }
}

// Blocks an SM each instantiation is built for, the most that its
// registers allow without a spill: four at 16 columns and one right-hand
// side (a CG iteration), three up to 64 columns, two with several batch
// elements (their products and sums), one block of two warpgroups at 128.
template <int TB, int NB>
constexpr int min_blocks() {
  return TB >= 128 ? 1 : (NB > 1 ? 2 : (TB == 16 ? 4 : 3));
}

// One block of the bf16 kernel-matrix product: rows i0 .. i0 + 64 WG - 1
// (i0 = blockIdx.x 64 WG) of (K(X1, X2) + sigma2 [row_offset + i == j]) @ M
// for the columns t0 .. t0 + TB - 1 (t0 = blockIdx.y TB; chunked, t0 = 0
// and blockIdx.y is the chunk) of batch elements b0 .. b0 + nb - 1
// (b0 = blockIdx.z NB, nb <= NB), over all the columns or (chunked) the
// chunk's.  maps: the staged X1, X2 (dp features), the bf16 M (batch,
// cols, tp) and X2's norms; n1g X1's norms.  At the end each thread holds
// acc[q][4 i + 2 hr + e] = the sum of its warpgroup's row r0 + 8 hr and
// column t0 + 8 i + 2 c + e of batch element b0 + q, and calls
// epi(acc, smem, wg, r0, c, i0, t0, b0, nb) after a __syncthreads (the
// ring is then free for the epilogue).
//
// A warpgroup's tiles run as a software pipeline, so that the tensor
// cores' latency (hundreds of clocks a round trip) hides behind the map:
// while it forms tile it's entries, S of tile it + 1 and (when a thread's
// products in flight fit 8 registers, LAG) the product of tile it - 1 run.
// Tile it's step: the entries from S(it), packed into A; S(it + 1) and the
// product P(it) issued; then (LAG) wait for P(it - 1), fold it, release its
// stage, wait for S(it + 1); or (otherwise) wait for both, fold P(it) and
// release its stage.  The groups complete in the order they were
// committed, which the waits count on.  Buffers of A and P alternate between even and odd
// tiles (compile-time indices: two steps a loop trip).
template <int KT, int TB, int NB, typename Epilogue>
__device__ __forceinline__ void tile_loop_bf16(const Maps& maps, const float* __restrict__ n1g,
                                               const float* __restrict__ scal, int rows,
                                               int cols, int dp, int batch, int row_offset,
                                               int stages, Epilogue epi) {
  constexpr int WG = warpgroups(TB);
  constexpr int NF = TB / 2;  // accumulator registers of one batch element
  constexpr bool LAG = NB * NF <= 8;
  constexpr int PB = LAG ? 2 : 1;  // buffers of A and of the products
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES], x1_bar;
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Smem L = smem_layout(TB, NB, dp, stages);

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int c = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows of its warpgroup's 64: r0, r0 + 8
  const int i0 = blockIdx.x * TILE * WG;
  const int t0 = chunked(TB) ? 0 : blockIdx.y * TB;
  const int b0 = blockIdx.z * NB;
  const int nb = min(NB, batch - b0);
  // this block's column tiles tile_lo .. tile_lo + tiles - 1: all of them,
  // or (chunked) its chunk's
  int tile_lo = 0, tiles = (cols + TILE - 1) / TILE;
  if constexpr (chunked(TB)) {
    tile_lo = blockIdx.y * chunk_tiles(cols);
    tiles = max(min(tile_lo + chunk_tiles(cols), tiles) - tile_lo, 0);
  }
  const int ks = dp / 16;
  const uint32_t stage_bytes = static_cast<uint32_t>(L.stage + TILE * 4);
  const float outputscale = scal[0];
  const float sigma2 = scal[1];

  auto load = [&](int tile, int st) {  // thread 0 only: the block's tile `tile` into stage st
    unsigned char* dst = base + L.x1 + st * L.stage;
    const int j = (tile_lo + tile) * TILE;
    mbar_expect_tx(&full[st], stage_bytes);
    tma_load_3d(dst, &maps.x2, &full[st], 0, j, 0);
    tma_load_4d(dst + L.x_tile, &maps.m, &full[st], 0, j, t0 / 8, b0);
    tma_load_1d(base + L.norms + st * TILE * 4, &maps.n2, &full[st], j);
  };
  if (tid == 0) {
    for (int st = 0; st < MAX_STAGES; ++st) {
      mbar_init(&full[st]);
      mbar_init(&empty[st], 4 * WG);  // one arrival per consumer warp
    }
    mbar_init(&x1_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && tiles > 0) {
    mbar_expect_tx(&x1_bar, static_cast<uint32_t>(L.x1));
    tma_load_3d(base, &maps.x1, &x1_bar, 0, i0, 0);
    for (int tile = 0; tile < stages && tile < tiles; ++tile) load(tile, tile);
  }

  float acc[NB][NF];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[q][e] = 0.0f;
  }

  if (tiles > 0) {
    // this warpgroup's 64 rows of the X1 tile: rows 16 bytes apart within
    // a column of core matrices, which are 64 WG * 16 bytes apart
    const uint32_t x1_lbo = TILE * WG * 16;
    const uint32_t x1_addr = smem_addr(base) + TILE * 16 * wg;
    const uint32_t ring = smem_addr(base + L.x1);
    const int lrow = i0 + TILE * wg + r0;  // this thread's first row in X1
    float n1[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) n1[hr] = lrow + 8 * hr < rows ? n1g[lrow + 8 * hr] : 0.0f;
    const int grow = row_offset + lrow;             // its global row
    const int wrow0 = row_offset + i0 + TILE * wg;  // the warpgroup's first

    float s[32];
    uint32_t a[PB][4][4];
    float part[PB][NB][NF];

    // S = X1 X2^T of the tile in stage st, as gram_issue / gram_finish take
    // it (written out here: the function call form cost B3 a spill)
    auto issue_s = [&](int st) {
      wgmma_fence();
      wgmma_ss_n64_first(s, desc(x1_addr, x1_lbo, 128), desc(ring + st * L.stage, TILE * 16, 128));
      wgmma_commit();
    };
    auto finish_s = [&](int st) {
      fence_regs(s);
      for (int j = 1; j < ks; ++j) {
        float g[32];
        wgmma_fence();
        wgmma_ss_n64_first(g, desc(x1_addr + 2 * j * x1_lbo, x1_lbo, 128),
                           desc(ring + st * L.stage + 2 * j * TILE * 16, TILE * 16, 128));
        wgmma_commit();
        wgmma_wait_group<0>();
        fence_regs(g);
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] += g[e];
      }
    };
    // P = A M_q for each batch element: M (MN-major) [TB / 8][64][8],
    // leading offset 128 (the next 8 k rows), stride offset 64 * 16 (the
    // next 8 columns); four k-steps into a zeroed fragment
    auto issue_p = [&](auto pb, int st) {
      constexpr int P = decltype(pb)::value;
      const uint32_t m0 = ring + st * L.stage + L.x_tile;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (q < nb) {
          const uint32_t mq = m0 + q * TILE * TB * 2;
          wgmma_rs_first<TB>(part[P][q], a[P][0], desc(mq, 128, TILE * 16));
#pragma unroll
          for (int j = 1; j < 4; ++j) {
            wgmma_rs<TB>(part[P][q], a[P][j], desc(mq + j * 256, 128, TILE * 16));
          }
        }
      }
      wgmma_commit();
    };
    // a completed P added to the running sums in IEEE f32; its A operand
    // stays untouched until here
    auto fold = [&](auto pb) {
      constexpr int P = decltype(pb)::value;
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (q < nb) {
          fence_regs(part[P][q]);
#pragma unroll
          for (int e = 0; e < NF; ++e) acc[q][e] += part[P][q][e];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(a[P][j]);
    };
    // every consumer warp releases tile `tile`'s stage st (phase ph); once
    // all have, thread 0 refills it with tile + stages
    auto release = [&](int tile, int st, int ph) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (tid == 0 && tile + stages < tiles) {
        mbar_wait(&empty[st], ph);
        load(tile + stages, st);
      }
    };

    mbar_wait(&x1_bar, 0);
    mbar_wait(&full[0], 0);
    issue_s(0);
    wgmma_wait_group<0>();
    finish_s(0);
    int st = 0, ph = 0;    // tile it's stage and its phase
    int pst = 0, pph = 0;  // tile it - 1's
    auto step = [&](auto pb, int it) {
      const int j0 = (tile_lo + it) * TILE;
      const bool more = it + 1 < tiles;
      int nst = st + 1, nph = ph;
      if (nst == stages) {
        nst = 0;
        nph ^= 1;
      }
      const bool diag = wrow0 < j0 + TILE && j0 < wrow0 + TILE;
      entries<KT>(s, n1, reinterpret_cast<const float*>(base + L.norms + st * TILE * 4), c, grow,
                  j0, cols, outputscale, sigma2, diag, j0 + TILE > cols);
      pack_a(s, a[decltype(pb)::value]);
      if (more) {
        mbar_wait(&full[nst], nph);
        issue_s(nst);
      }
      issue_p(pb, st);
      if constexpr (LAG) {
        if (it > 0) {
          if (more) {
            wgmma_wait_group<2>();
          } else {
            wgmma_wait_group<1>();
          }
          fold(std::integral_constant<int, 1 - decltype(pb)::value>{});
          release(it - 1, pst, pph);
        }
        if (more) {
          wgmma_wait_group<1>();
          finish_s(nst);
        }
      } else {
        wgmma_wait_group<0>();
        fold(pb);
        release(it, st, ph);
        if (more) finish_s(nst);
      }
      pst = st;
      pph = ph;
      st = nst;
      ph = nph;
    };
    for (int it = 0; it < tiles; it += 2) {
      step(std::integral_constant<int, 0>{}, it);
      if (it + 1 < tiles) step(std::integral_constant<int, PB - 1>{}, it + 1);
    }
    if constexpr (LAG) {  // the last tile's product
      wgmma_wait_group<0>();
      if ((tiles - 1) % 2 == 0) {
        fold(std::integral_constant<int, 0>{});
      } else {
        fold(std::integral_constant<int, 1>{});
      }
    }
  }
  __syncthreads();  // every TMA has landed and every warp is done: the ring is free
  epi(acc, base + L.x1, wg, r0, c, i0, t0, b0, nb);
}

}  // namespace
