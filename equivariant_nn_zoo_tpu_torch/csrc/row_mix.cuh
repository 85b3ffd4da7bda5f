// The mix stage shared by the whole-convolution forward (full_conv.cu, K1),
// the per-edge conv (uvu_conv.cu, K6) and the pairwise expansion
// (pairwise_tp.cu, K5): per mix problem q (output-irrep group, component,
// output slot) a 64x64-tiled shared-memory product
//
//   out[r, c_off(q) + w * c_stride(q)] =
//       sum_k S[r, a_col(q) + k] * wsel[b_off(q) + k * wo(q) + w]
//
// over the rows r of the unmixed scratch S [rows, KM] (one row per node, per
// edge or per element).  Every output element belongs to at most one problem
// and is written once with a plain store: no atomics.  The problem table is
// ConvTables' (six ints per problem, on the device).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace rowmix
