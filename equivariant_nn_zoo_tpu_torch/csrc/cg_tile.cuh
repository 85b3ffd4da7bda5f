// Device pieces shared by the fused CG-tile kernels of pairwise_tp.cu (K5,
// K5m) and uvu_conv.cu (K6, K6b): 16-byte cp.async staging of operand rows
// and non-zero tables, and the 3xTF32 mix of a CG tile made in shared
// memory by a slice of the mix matrices, stored column by column.
//
// A fused kernel makes a tile S[component][element][channel] of one CG
// path in shared memory from its non-zeros (sorted by component, with run
// bounds), then multiplies it there by the path's rows of the mix matrices
// wsel on the tensor cores (row_mix.cuh's fragments: x = hi + lo in TF32,
// three mma.sync m16n8k8 per product, the small terms first).  The kernels
// differ in how the operand rows are staged and how a value of S is made;
// the pieces here are the parts they share.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace cgtile {

using rowmix::cp_async16;
using rowmix::mma_tf32;
using rowmix::split_tf32;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// the pitch of staged rows of `floats` floats: the least at or above it
// that is r or 32 - r mod 32 (either keeps the lanes' banks apart)
static inline int row_pitch(int floats, int r) {
  const int p = (floats + 31) / 32 * 32 + r;
  return r > 0 && p - 2 * r >= floats ? p - 2 * r : p;
}

// q / d for 0 <= q < 2^16 and 0 < d < 2^16 by a multiply: m = magic(d),
// ceil(2^32 / d)
__device__ __forceinline__ uint64_t magic(uint32_t d) {
  return (0x100000000ull + d - 1) / d;
}
__device__ __forceinline__ int div_by(int q, uint64_t m) {
  return (int)(((uint64_t)q * m) >> 32);
}

// Stage `lines` lines of `width` floats (a multiple of 4) by 16-byte
// cp.async: line l from src(l) to dst(l).  Floats at or past `valid` of a
// line, and every float of a line whose src is null, are zero-filled (the
// copy reads nothing, from `any`, a valid address).
template <class Src, class Dst>
__device__ __forceinline__ void stage_lines(int lines, int width, int valid,
                                            const float* any, Src src,
                                            Dst dst) {
  const int per = width >> 2;
  const uint64_t m = magic(per);
  for (int i = threadIdx.x; i < lines * per; i += blockDim.x) {
    const int l = div_by(i, m), c = (i - l * per) << 2;
    const float* s = src(l);
    const bool ok = s != nullptr && c < valid;
    cp_async16(dst(l) + c, ok ? s + c : any, ok ? 16 : 0);
  }
}

// A path's non-zeros into zs: n_z entries from z0 (even), two a copy (the
// host pads every path's block to an even length).
__device__ __forceinline__ void stage_nz(int2* zs, const int2* nz, int z0,
                                         int n_z) {
  for (int i = threadIdx.x; i < (n_z + 1) >> 1; i += blockDim.x)
    cp_async16(reinterpret_cast<float*>(zs + 2 * i),
               reinterpret_cast<const float*>(nz + z0 + 2 * i), 16);
}

// One 8-deep step of the mix on the tensor cores: acc[i][n] += the S tile
// of component i (rows = elements, tile i's row r at ss + (i * rows + r) *
// sp) at columns [kk, kk + 8) times the mix slice's rows [kk, kk + 8)
// (pitch wp) at the warp's columns n0 + 8 n.  The fragments of m16n8k8:
// element g (+ 8), column q4 (+ 4) of S; row q4 (+ 4), column g of the slice.
template <int NM3, int NT>
__device__ __forceinline__ void mix_step(float (&acc)[NM3][NT][4],
                                         const float* ss, int rows, int sp,
                                         const float* wb, int wp, int kk,
                                         int n0, int lane) {
  const int g = lane >> 2, q4 = lane & 3;
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      split_tf32(wb[(kk + q4 + 4 * h) * wp + n0 + 8 * n + g], bh[n][h],
                 bl[n][h]);
#pragma unroll
  for (int i = 0; i < NM3; ++i) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      split_tf32(ss[(i * rows + g + 8 * (h & 1)) * sp + kk + q4 + 4 * (h >> 1)],
                 ah[h], al[h]);
    // the small terms first
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma_tf32(acc[i][n], al, bh[n]);
      mma_tf32(acc[i][n], ah, bl[n]);
      mma_tf32(acc[i][n], ah, bh[n]);
    }
  }
}

// Each output column of a unit once: element rows m0 + g (+ 8) below
// m0 + live, mix columns j = n0 + 8 n + 2 q4 (+ 1) below wo, the unit's
// NM3 components of column j side by side at out_col + j * d3 + m3_0.
template <int NM3, int NT>
__device__ __forceinline__ void store_cols(const float (&acc)[NM3][NT][4],
                                           float* out, int out_dim, int m0,
                                           int live, int out_col, int d3,
                                           int m3_0, int wo, int n0,
                                           int lane) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int j = n0 + 8 * n + 2 * q4;
    if (j >= wo) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r >= live) continue;
      float* o = out + (size_t)(m0 + r) * out_dim + out_col + j * d3 + m3_0;
#pragma unroll
      for (int i = 0; i < NM3; ++i) {
        o[i] = acc[i][n][2 * h];
        o[d3 + i] = acc[i][n][2 * h + 1];
      }
    }
  }
}

// One component's step of a dwsel unit on the tensor cores: acc[n] +=
// S[m3]^T gout[m3] over a tile of `rows` (8) elements.  S tile m3's element
// r at ss + (m3 * rows + r) * sp, the warp's channels [wr, wr + 16); the
// staged gout rows (pitch gp) at columns j * d3 + m3 for the warp's 8-wide
// column tiles from wc, those below wo.
template <int NT>
__device__ __forceinline__ void dws_step(float (&acc)[NT][4], const float* ss,
                                         int rows, int sp, const float* gs,
                                         int gp, int d3, int m3, int wr,
                                         int wc, int wo, int lane) {
  const int g = lane >> 2, q4 = lane & 3;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    split_tf32(ss[(m3 * rows + q4 + 4 * (h >> 1)) * sp + wr + g + 8 * (h & 1)],
               ah[h], al[h]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (wc + 8 * n >= wo) continue;
    uint32_t bh[2], bl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      split_tf32(gs[(q4 + 4 * h) * gp + (wc + 8 * n + g) * d3 + m3], bh[h],
                 bl[h]);
    mma_tf32(acc[n], al, bh);
    mma_tf32(acc[n], ah, bl);
    mma_tf32(acc[n], ah, bh);
  }
}

// A dwsel unit's tile once: channels u0 + wr + g (+ 8) below mul, columns
// wc + 8 n + 2 q4 (+ 1) below wo, at dst + u * wo + j.
template <int NT>
__device__ __forceinline__ void store_dws(const float (&acc)[NT][4],
                                          float* dst, int mul, int u0,
                                          int wr, int wc, int wo, int lane) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int j = wc + 8 * n + 2 * q4;
    if (j >= wo) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + wr + g + 8 * h;
      if (u < mul)
        *reinterpret_cast<float2*>(dst + (size_t)u * wo + j) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// out[i] = the sum of the chunks' ws[k * len + i], in chunk order (the
// body of each kernel file's chunk-sum kernel)
__device__ __forceinline__ void chunk_sum(const float* __restrict__ ws,
                                          int n, int len,
                                          float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += ws[(size_t)k * len + i];
    out[i] = s;
  }
}

}  // namespace cgtile
