// One fused mBCG iteration with bf16 operands for Hopper (sm_90a), the
// precision="mixed" mode of fused_cg_step.cu:
//
//     U' = U + alpha D,   R' = R - alpha V,   D' = gamma R' + beta D
//     V' = (K(X1, X2) + sigma2 * [row_offset + i == j]) @ D'
//     red = [D'^T V'; R'^T R'; R'^T V'; V'^T V']   per (batch, column)
//
// where the product takes the kernel entries (formed from bf16 X/l as bf16
// B1 forms them) and D' rounded to bf16 and sums in f32.  The state, the
// prologue and the four reductions stay f32, as in the f32 step.
//
// Replaces the TPU kernel fused_cg_step_pallas with compute_dtype="bfloat16"
// (src/repro/kernels/kernel_matmul/kernel_matmul.py:487, body
// _fused_cg_step_kernel :373, the bf16 casts of the product :428-429).
//
// What bounds it on an H100: operations, as bf16 B1 (kernel_matmul_bf16.cu):
// at the CG width (t = 9) the kernel map on the SFU (Matern: one rsqrt and
// one ex2 an entry); the state adds 7 (batch, n, t) f32 reads, 4 f32
// writes and one bf16 write.  The product is bf16_tile.cuh's tile loop (the
// distance and the norms on wgmma, the entries in the product's register
// A operand, the product on wgmma, TMA), the same device function that
// forms bf16 B1's entries.  Launches on the caller's stream:
//
//   1. advance_bf16_kernel: U', R', D' of this call's rows, and a bf16 copy
//      of the D' that the product reads, rows padded to tp (a multiple of 8)
//      so that TMA takes its rows: the rows' own D' when the column state is
//      the row state, else D' of every column, from the column state.
//      Rounded once per element, not once per row block that reads it;
//   2. norms_bf16_kernel: |x|^2 of the columns (and of the rows, unless
//      they are rows of the columns' copy), as bf16_tile.cuh takes them;
//   3. fused_cg_product_bf16_kernel: the tile loop with M = the bf16 D' (up
//      to 64 columns a block, one warpgroup of 64 rows); at up to 32
//      columns one block a chunk of a row tile's columns, each storing its
//      chunk's sums (bf16_tile.cuh), and
//   4. cg_epilogue_bf16_kernel adds them in order; either way V' and one
//      partial per 64-row block of the four reductions follow, each summed
//      in a fixed order from V' in shared memory and R', D' from the
//      advance;
//   5. fold_partials_kernel: the partials summed in a fixed order.
//
// No atomics anywhere, so two runs give the same bits.  The outputs must be
// other buffers than the inputs (the caller ping-pongs them).  alpha, beta,
// gamma, the outputscale and sigma2 are read through device pointers, so
// the host never waits between iterations.

#include <cuda_runtime.h>

#include "bf16_tile.cuh"  // the bf16 tile loop, its layouts and tensor maps

namespace {

constexpr int ADVANCE_THREADS = 256;
constexpr int FUSED_MAX_TB = 64;  // t is the probe count + 1 on the CG paths

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(x));
  return r;
}

// U', R', D' of the rows (e < nr), then D' of the columns (nr <= e < nr +
// nc) when the column state is separate; abg = [alpha; beta; gamma] (3,
// batch, t).  Db (batch, cols, tp) receives the bf16 D' of the columns:
// the rows' when shared, else the columns' (the same advance_r /
// advance_d, so a shared column state gives the same bits either way).
__global__ void __launch_bounds__(ADVANCE_THREADS) advance_bf16_kernel(
    const float* __restrict__ U, const float* __restrict__ R, const float* __restrict__ D,
    const float* __restrict__ V, const float* __restrict__ Rc, const float* __restrict__ Dc,
    const float* __restrict__ Vc, const float* __restrict__ abg, float* __restrict__ Uo,
    float* __restrict__ Ro, float* __restrict__ Do, uint16_t* __restrict__ Db, long long nr,
    long long nc, int rows, int cols, int t, int tp, int batch, int shared) {
  const long long plane = static_cast<long long>(batch) * t;
  const long long stride = static_cast<long long>(gridDim.x) * ADVANCE_THREADS;
  for (long long e = blockIdx.x * static_cast<long long>(ADVANCE_THREADS) + threadIdx.x;
       e < nr + nc; e += stride) {
    const bool row = e < nr;
    const long long f = row ? e : e - nr;
    const long long per_batch = static_cast<long long>(row ? rows : cols) * t;
    const long long s = (f / per_batch) * t + f % t;  // (batch, column) of the scalars
    const long long db = (f / t) * tp + f % t;       // f's place in the padded bf16 copy
    const float alpha = abg[s], beta = abg[plane + s], gamma = abg[2 * plane + s];
    if (row) {
      const float dold = D[f];
      const float rn = advance_r(R[f], alpha, V[f]);
      const float dn = advance_d(rn, dold, beta, gamma);
      Uo[f] = fmaf(alpha, dold, U[f]);
      Ro[f] = rn;
      Do[f] = dn;
      if (shared) Db[db] = bf16_bits(dn);
    } else {
      Db[db] = bf16_bits(advance_d(advance_r(Rc[f], alpha, Vc[f]), Dc[f], beta, gamma));
    }
  }
}

// Row block blockIdx.x's partial reductions of batch element b over the
// columns t0 .. t0 + TB - 1, from V' in shared memory (sV, [64][TB]) and
// R', D' from the advance: thread (rg, col) sums rows rg, rg + RG, ... in
// order, then the RG sums of a column in order, into
// partial[row block][b][4][t].  Every thread of the block's warpgroup
// calls it; sRed holds 4 * 128 floats.
template <int TB>
__device__ __forceinline__ void block_reductions(const float* sV, float* sRed,
                                                 const float* __restrict__ Ro,
                                                 const float* __restrict__ Do,
                                                 float* __restrict__ partial, long long b, int i0,
                                                 int t0, int rows, int t, int batch) {
  constexpr int RG = WG_THREADS / TB;  // row groups of the reductions
  const int tid = threadIdx.x;
  const int col = tid % TB, rg = tid / TB;
  const int gc = t0 + col;
  float dv = 0.0f, rr = 0.0f, rv = 0.0f, vv = 0.0f;
  if (gc < t) {
    for (int li = rg; li < TILE && i0 + li < rows; li += RG) {
      const long long idx = (b * rows + i0 + li) * t + gc;
      const float rn = Ro[idx], dn = Do[idx], vn = sV[li * TB + col];
      dv = fmaf(dn, vn, dv);
      rr = fmaf(rn, rn, rr);
      rv = fmaf(rn, vn, rv);
      vv = fmaf(vn, vn, vv);
    }
  }
  sRed[(0 * RG + rg) * TB + col] = dv;
  sRed[(1 * RG + rg) * TB + col] = rr;
  sRed[(2 * RG + rg) * TB + col] = rv;
  sRed[(3 * RG + rg) * TB + col] = vv;
  __syncthreads();
  for (int e = tid; e < 4 * TB; e += WG_THREADS) {
    const int qq = e / TB, cc = e % TB;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < RG; ++r) sum += sRed[(qq * RG + r) * TB + cc];  // fixed order
    if (t0 + cc < t) {
      partial[((static_cast<long long>(blockIdx.x) * batch + b) * 4 + qq) * t + t0 + cc] = sum;
    }
  }
  __syncthreads();  // sV and sRed are rewritten for the next element
}

// V' = (K + sigma2 I) D' for the 64 rows i0 .. i0 + 63 and the columns
// t0 .. t0 + TB - 1 of batch elements b0 .. b0 + nb - 1, from the bf16 D'.
// Chunked (TB <= 32), the block stores its chunk's sums and
// cg_epilogue_bf16_kernel goes on; else V' goes to shared memory and the
// row block's partial reductions follow here.
template <int KT, int TB, int NB>
__global__ void __launch_bounds__(WG_THREADS, min_blocks<TB, NB>()) fused_cg_product_bf16_kernel(
    const __grid_constant__ Maps maps, const float* __restrict__ n1,
    const float* __restrict__ scal, float* __restrict__ chunks, const float* __restrict__ Ro,
    const float* __restrict__ Do, float* __restrict__ Vo, float* __restrict__ partial, int rows,
    int cols, int dp, int t, int batch, int row_offset, int stages) {
  tile_loop_bf16<KT, TB, NB>(
      maps, n1, scal, rows, cols, dp, batch, row_offset, stages,
      [&](float (&acc)[NB][TB / 2], unsigned char* ring, int, int r0, int c, int i0, int t0,
          int b0, int nb) {
        if constexpr (chunked(TB)) {
          store_acc<TB, NB>(acc, chunks + static_cast<long long>(blockIdx.y) * batch * rows * t,
                            i0, r0, c, t0, b0, nb, rows, t);
        } else {
          float* sV = reinterpret_cast<float*>(ring);  // [TILE][TB]
          float* sRed = sV + TILE * TB;                // [4][RG][TB]
#pragma unroll
          for (int q = 0; q < NB; ++q) {
            if (q >= nb) break;
            const long long b = b0 + q;
            float* Vb = Vo + b * rows * t;
#pragma unroll
            for (int k = 0; k < TB / 2; ++k) {
              const int li = r0 + 8 * ((k / 2) % 2);
              const int lc = 8 * (k / 4) + 2 * c + k % 2;
              const float v = acc[q][k];
              sV[li * TB + lc] = v;
              if (i0 + li < rows && t0 + lc < t) {
                Vb[static_cast<long long>(i0 + li) * t + t0 + lc] = v;
              }
            }
            __syncthreads();
            block_reductions<TB>(sV, sRed, Ro, Do, partial, b, i0, t0, rows, t, batch);
          }
        }
      });
}

// The chunked product's end: V' of row block blockIdx.x, columns
// t0 .. t0 + TB - 1 (t0 = blockIdx.y TB), batch element blockIdx.z, the
// chunks' sums added in order (as fold_chunks_kernel adds them), stored
// and kept in shared memory for the block's partial reductions.
template <int TB>
__global__ void __launch_bounds__(WG_THREADS) cg_epilogue_bf16_kernel(
    const float* __restrict__ chunks, const float* __restrict__ Ro, const float* __restrict__ Do,
    float* __restrict__ Vo, float* __restrict__ partial, int rows, int t, int batch,
    int nchunks) {
  __shared__ float sV[TILE * TB];
  __shared__ float sRed[4 * WG_THREADS];
  const int i0 = blockIdx.x * TILE, t0 = blockIdx.y * TB;
  const long long b = blockIdx.z;
  const long long plane = static_cast<long long>(batch) * rows * t;
  for (int e = threadIdx.x; e < TILE * TB; e += WG_THREADS) {
    const int li = e / TB, lc = e % TB;
    float v = 0.0f;
    if (i0 + li < rows && t0 + lc < t) {
      const long long idx = (b * rows + i0 + li) * t + t0 + lc;
      for (int k = 0; k < nchunks; ++k) v += chunks[k * plane + idx];
      Vo[idx] = v;
    }
    sV[e] = v;
  }
  __syncthreads();
  block_reductions<TB>(sV, sRed, Ro, Do, partial, b, i0, t0, rows, t, batch);
}

template <int TB, int NB>
cudaError_t launch_product(int kernel_type, const Maps& maps, dim3 grid, int stages,
                           cudaStream_t stream, const float* n1, const float* scal,
                           float* chunks, const float* Ro, const float* Do, float* Vo,
                           float* partial, int rows, int cols, int dp, int t, int batch,
                           int row_offset) {
  auto kern = fused_cg_product_bf16_kernel<MATERN52, TB, NB>;
  switch (kernel_type) {
    case RBF: kern = fused_cg_product_bf16_kernel<RBF, TB, NB>; break;
    case MATERN12: kern = fused_cg_product_bf16_kernel<MATERN12, TB, NB>; break;
    case MATERN32: kern = fused_cg_product_bf16_kernel<MATERN32, TB, NB>; break;
    default: break;
  }
  const int smem = smem_layout(TB, NB, dp, stages).total;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks = grid;
  const int nchunks = chunk_count(cols);
  if (chunked(TB)) grid.y = nchunks > 0 ? nchunks : 1;
  kern<<<grid, WG_THREADS, smem, stream>>>(maps, n1, scal, chunks, Ro, Do, Vo, partial, rows,
                                           cols, dp, t, batch, row_offset, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || !chunked(TB)) return err;
  cg_epilogue_bf16_kernel<TB><<<dim3(blocks.x, blocks.y, batch), WG_THREADS, 0, stream>>>(
      chunks, Ro, Do, Vo, partial, rows, t, batch, nchunks);
  return cudaGetLastError();
}

// One batch element a block (NB = 1), or batch_block(TB) of several.
template <int TB>
cudaError_t launch_nb(bool several, int kernel_type, const Maps& maps, dim3 grid, int stages,
                      cudaStream_t stream, const float* n1, const float* scal, float* chunks,
                      const float* Ro, const float* Do, float* Vo, float* partial, int rows,
                      int cols, int dp, int t, int batch, int row_offset) {
  if (several) {
    return launch_product<TB, batch_block(TB)>(kernel_type, maps, grid, stages, stream, n1, scal,
                                               chunks, Ro, Do, Vo, partial, rows, cols, dp, t,
                                               batch, row_offset);
  }
  return launch_product<TB, 1>(kernel_type, maps, grid, stages, stream, n1, scal, chunks, Ro, Do,
                               Vo, partial, rows, cols, dp, t, batch, row_offset);
}

}  // namespace

// Plain C entry point (bound with ctypes).  As fused_cg_step_f32, with X1
// (rows, dp) and X2 (cols, dp) the staged bf16 X/l (bf16 values, dp a
// multiple of 16, features past d zero, 16-byte aligned), Db a device bf16
// array of batch * cols * tp values (tp a multiple of 8 and at least t,
// 16-byte aligned) that receives the bf16 D' of the columns, scratch
// norms_floats(rows, cols) floats, plus max(chunk_count(cols), 1) * batch * rows * t
// when t <= 32 (the chunks' sums), 16-byte aligned, and
// partial ceil(rows / 64) * batch * 4 * t floats (the row blocks' partial
// reductions).  The state U, R, D, V and the outputs Uo, Ro, Do, Vo (batch,
// rows, t), which must not overlap the inputs; the column state Rc, Dc, Vc
// (batch, cols, t), which may be the same arrays as R, D, V; abg (3, batch,
// t); scal = [outputscale, sigma2]; red (batch, 4, t), the output
// reductions.  Returns cudaGetLastError() after the launches (0 =
// ok), or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int fused_cg_step_bf16(
    const void* X1, const void* X2, const float* U, const float* R,
    const float* D, const float* V, const float* Rc, const float* Dc,
    const float* Vc, const float* abg, const float* scal, float* Uo,
    float* Ro, float* Do, float* Vo, float* partial, void* Db, float* scratch, float* red,
    int rows, int cols, int dp, int t, int tp, int batch, int row_offset,
    int kernel_type, void* stream) {
  bool ok = rows > 0 && cols >= 0 && dp > 0 && dp % 16 == 0 && t > 0 && batch > 0 &&
            batch <= 65535 && kernel_type >= RBF && kernel_type <= MATERN52 && tp >= t &&
            tp % 8 == 0;
  for (const void* p : {X1, X2, static_cast<const void*>(Db), static_cast<const void*>(scratch)}) {
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tb = column_block_bf16(t, FUSED_MAX_TB);
  const int nb = batch == 1 ? 1 : batch_block(tb);
  // the epilogue reuses the ring for V' and the reductions' row-group sums
  const size_t epi = sizeof(float) * (TILE * tb + 4 * WG_THREADS);
  const int stages = ring_stages(tb, nb, dp, epi);
  Maps maps;
  if (stages == 0 ||
      !encode_maps(&maps, X1, X2, Db, scratch, rows, cols, dp, tp, batch, tb, nb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + TILE - 1) / TILE;
  const long long m = static_cast<long long>(batch) * 4 * t;
  const bool shared = Rc == R && Dc == D && Vc == V && rows == cols;
  uint16_t* Dbh = static_cast<uint16_t*>(Db);
  const long long nr = static_cast<long long>(batch) * rows * t;
  const long long nc = shared ? 0 : static_cast<long long>(batch) * cols * t;
  const long long adv_blocks = (nr + nc + ADVANCE_THREADS - 1) / ADVANCE_THREADS;
  advance_bf16_kernel<<<static_cast<int>(adv_blocks < 132 * 32 ? adv_blocks : 132 * 32),
                        ADVANCE_THREADS, 0, s>>>(U, R, D, V, Rc, Dc, Vc, abg, Uo, Ro, Do, Dbh,
                                                 nr, nc, rows, cols, t, tp, batch, shared);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* n1 = nullptr;
  err = launch_all_norms(X1, X2, scratch, rows, cols, dp, s, &n1);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* chunks = scratch + norms_floats(rows, cols);
  // cols = 0 runs no column tile: V' = 0, and the reductions still come
  const dim3 grid(row_blocks, (t + tb - 1) / tb, (batch + nb - 1) / nb);
  const bool several = nb > 1;
  switch (tb) {
    case 16: err = launch_nb<16>(several, kernel_type, maps, grid, stages, s, n1, scal, chunks, Ro, Do, Vo, partial, rows, cols, dp, t, batch, row_offset); break;
    case 32: err = launch_nb<32>(several, kernel_type, maps, grid, stages, s, n1, scal, chunks, Ro, Do, Vo, partial, rows, cols, dp, t, batch, row_offset); break;
    default: err = launch_product<64, 1>(kernel_type, maps, grid, stages, s, n1, scal, chunks, Ro, Do, Vo, partial, rows, cols, dp, t, batch, row_offset); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_partials_kernel<<<static_cast<int>(m), FOLD_THREADS, 0, s>>>(partial, red, row_blocks,
                                                                    static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}
