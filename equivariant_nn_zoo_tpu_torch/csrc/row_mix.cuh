// The mix stage shared by the convolution and pairwise kernels, forward and
// backward.
//
// Forward (full_conv.cu K1, uvu_conv.cu K6, pairwise_tp.cu K5): per mix
// problem q (output-irrep group, component, output slot) a 64x64-tiled
// shared-memory product
//
//   out[r, c_off(q) + w * c_stride(q)] =
//       sum_k S[r, a_col(q) + k] * wsel[b_off(q) + k * wo(q) + w]
//
// over the rows r of the unmixed scratch S [rows, KM] (one row per node, per
// edge or per element).  Every output element belongs to at most one problem
// and is written once with a plain store: no atomics (mix_rows_kernel).  The
// problem table is ConvTables' (six ints per problem, on the device).
//
// Backward (full_conv_bwd.cu K2, full_conv_ext.cu K4, uvu_conv.cu K6b,
// pairwise_tp.cu K5m): the two adjoint products of the same problems,
//
//   dS[r, a_col(q) + k]        += sum_w gout[r, c(q, w)] * wsel_q[k, w]
//   dwsel[b_off(q) + k*wo + w] += sum_r S[r, a_col(q) + k] * gout[r, c(q, w)]
//
// as strided-operand descriptors of one 64x64-tiled kernel
// (tile_gemm_kernel, a batch of descriptors per launch) that adds its tiles
// into zeroed outputs with atomics: problems of one output-irrep group share
// their scratch columns, and dwsel is split over chunks of rows, so neither
// needs a second pass and the order of summation varies from run to run.
// The problem table is read on the host here.  The same kernel serves the
// radial MLP's products of K2 and the scattered forward mix of K4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace rowmix {

constexpr int kProbFields = 6;
constexpr int kTile = 64;
constexpr int kTileK = 16;

// grid: (row tiles, problem, output-column tiles); 256 threads, 4x4 each
static __global__ void mix_rows_kernel(
    const float* __restrict__ S, int rows, int KM,
    const float* __restrict__ wsel, const int* __restrict__ probs,
    float* __restrict__ out, int out_dim) {
  const int* pr = probs + blockIdx.y * kProbFields;
  const int a_col = pr[0], kdim = pr[1], b_off = pr[2], wo = pr[3];
  const int c_off = pr[4], c_stride = pr[5];
  const int r0 = blockIdx.x * kTile, w0 = blockIdx.z * kTile;
  if (w0 >= wo) return;

  __shared__ float As[kTileK][kTile + 1];
  __shared__ float Bs[kTileK][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      const int r = i / kTileK, c = i % kTileK, row = r0 + r, k = k0 + c;
      As[c][r] = (row < rows && k < kdim)
                     ? S[(size_t)row * KM + a_col + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      const int r = i / kTile, c = i % kTile, k = k0 + r, wc = w0 + c;
      Bs[r][c] = (k < kdim && wc < wo) ? wsel[b_off + (size_t)k * wo + wc]
                                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int wc = w0 + tx * 4 + j;
      if (wc < wo)
        out[(size_t)row * out_dim + c_off + wc * c_stride] = acc[i][j];
    }
  }
}

// Launch the mix of every problem over ``rows`` scratch rows.
static inline cudaError_t mix_rows(const float* S, int rows, int KM,
                                   const float* wsel, const int* probs,
                                   int n_probs, int max_wo, float* out,
                                   int out_dim, cudaStream_t s) {
  if (rows <= 0 || n_probs <= 0 || max_wo <= 0) return cudaSuccess;
  dim3 grid((rows + kTile - 1) / kTile, n_probs,
            (max_wo + kTile - 1) / kTile);
  mix_rows_kernel<<<grid, 256, 0, s>>>(S, rows, KM, wsel, probs, out,
                                       out_dim);
  return cudaGetLastError();
}

// How many CG paths one block of the sweep kernels walks: the paths are
// split over blockIdx.y until the grid holds about kTargetBlocks blocks, so
// that a small batch (tens of rows) still fills the card.  Paths write
// disjoint scratch rows, so the split needs no synchronisation.
constexpr int kRowsPerBlock = 4;   // blockDim.y of the sweep kernels
constexpr int kTargetBlocks = 2048;

static inline int paths_per_block(int rows, int P) {
  const int row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  int chunks = (kTargetBlocks + row_blocks - 1) / row_blocks;
  if (chunks > P) chunks = P;
  if (chunks < 1) chunks = 1;
  return (P + chunks - 1) / chunks;
}

// ---------------------------------------------------------------------------
// Tiled products over strided operands, summed into C with atomics.

constexpr int kMaxBatch = 24;      // descriptors per launch
constexpr int kSplitRows = 256;    // reduction rows per split-K block

// C(m, n) += sum_k A(m, k) B(k, n), element (i, j) of X at X + i*s0 + j*s1
struct GemmDesc {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, k_chunk;
  int sam, sak, sbk, sbn, scm, scn;
};

struct GemmBatch {
  int count;
  GemmDesc d[kMaxBatch];
};

// grid: (M tiles * N tiles, descriptor, K chunks); 256 threads, 4x4 each
static __global__ void tile_gemm_kernel(const GemmBatch batch) {
  const GemmDesc& g = batch.d[blockIdx.y];
  const int tiles_n = (g.N + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / tiles_n) * kTile;
  const int n0 = (blockIdx.x % tiles_n) * kTile;
  const int k_begin = blockIdx.z * g.k_chunk;
  if (m0 >= g.M || k_begin >= g.K) return;
  const int k_end = min(g.K, k_begin + g.k_chunk);

  __shared__ float As[kTileK][kTile + 1];
  __shared__ float Bs[kTileK][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      // neighbouring threads walk the operand's unit-stride axis
      int r, c;
      if (g.sak == 1) { r = i / kTileK; c = i % kTileK; }
      else { c = i / kTile; r = i % kTile; }
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < g.M && k < k_end)
                     ? g.A[(size_t)m * g.sam + (size_t)k * g.sak] : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      int r, c;
      if (g.sbn == 1) { r = i / kTile; c = i % kTile; }
      else { c = i / kTileK; r = i % kTileK; }
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < k_end && n < g.N)
                     ? g.B[(size_t)k * g.sbk + (size_t)n * g.sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N)
        atomicAdd(g.C + (size_t)m * g.scm + (size_t)n * g.scn, acc[i][j]);
    }
  }
}

// ``split``: the reduction runs over chunks of kSplitRows rows, one block
// each.
static inline GemmDesc gemm_desc(const float* A, int sam, int sak,
                                 const float* B, int sbk, int sbn, float* C,
                                 int scm, int scn, int M, int N, int K,
                                 bool split) {
  GemmDesc g;
  g.A = A; g.B = B; g.C = C;
  g.M = M; g.N = N; g.K = K;
  g.k_chunk = split ? kSplitRows : (K > 0 ? K : 1);
  g.sam = sam; g.sak = sak; g.sbk = sbk; g.sbn = sbn; g.scm = scm; g.scn = scn;
  return g;
}

// Launch the descriptors in batches of kMaxBatch.
static inline cudaError_t run_gemms(const GemmDesc* descs, int count,
                                    cudaStream_t s) {
  for (int b0 = 0; b0 < count; b0 += kMaxBatch) {
    GemmBatch batch;
    batch.count = std::min(kMaxBatch, count - b0);
    int tiles = 0, splits = 0;
    for (int i = 0; i < batch.count; ++i) {
      const GemmDesc& g = descs[b0 + i];
      batch.d[i] = g;
      tiles = std::max(tiles, ((g.M + kTile - 1) / kTile) *
                                  ((g.N + kTile - 1) / kTile));
      splits = std::max(splits, (g.K + g.k_chunk - 1) / g.k_chunk);
    }
    if (tiles == 0 || splits == 0) continue;
    dim3 grid(tiles, batch.count, splits);
    tile_gemm_kernel<<<grid, 256, 0, s>>>(batch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The per-problem products of the mix over ``rows`` scratch rows, from the
// problem table on the host; C is zeroed by the caller.
//   kMixScatter: out[r, c(q, w)] += S[r, a_col + k] wsel_q[k, w]
//   kMixRows:    dS[r, a_col + k] += gout[r, c(q, w)] wsel_q[k, w]
//   kMixWeights: dwsel_q[k, w]    += S[r, a_col + k] gout[r, c(q, w)]
enum MixProduct { kMixScatter = 0, kMixRows = 1, kMixWeights = 2 };

static inline cudaError_t mix_products(MixProduct which, const int* probs_host,
                                       int n_probs, int rows, int KM,
                                       int out_dim, const float* S,
                                       const float* wsel, const float* gout,
                                       float* C, cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  GemmDesc descs[kMaxBatch];
  int count = 0;
  for (int q = 0; q < n_probs; ++q) {
    const int* pr = probs_host + q * kProbFields;
    const int a_col = pr[0], kdim = pr[1], b_off = pr[2], wo = pr[3];
    const int c_off = pr[4], c_stride = pr[5];
    if (which == kMixScatter)
      descs[count++] = gemm_desc(S + a_col, KM, 1, wsel + b_off, wo, 1,
                                 C + c_off, out_dim, c_stride, rows, wo, kdim,
                                 false);
    else if (which == kMixRows)
      descs[count++] = gemm_desc(gout + c_off, out_dim, c_stride,
                                 wsel + b_off, 1, wo, C + a_col, KM, 1, rows,
                                 kdim, wo, false);
    else
      descs[count++] = gemm_desc(S + a_col, 1, KM, gout + c_off, out_dim,
                                 c_stride, C + b_off, wo, 1, kdim, wo, rows,
                                 true);
    if (count == kMaxBatch || q == n_probs - 1) {
      cudaError_t err = run_gemms(descs, count, s);
      if (err != cudaSuccess) return err;
      count = 0;
    }
  }
  return cudaSuccess;
}

}  // namespace rowmix
