// Per-edge uvu tensor-product convolution without the edge sum, forward
// (K6) and backward (K6b).
//
// The forward replaces the TPU kernel PallasUVUConv._fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py (the body at :233,
// launched from _pallas_fn at :409), whose only live use is the neighbor
// conv of the hamiltonian head (Pairwise, reduce=False).  It computes, per
// edge e and with no reduction over edges,
//
//   S[e, row(p, m3), u] = w[e, wcol(p) + u]
//                         * sum_nz C_p * x[src_e, m1, u] * sh[e, m2]
//   out[e, cols(q)]     = S[e, a_col(q) : +kdim(q)] @ wsel_q    per problem q
//
// with K1's row and table conventions (paths sorted by output irrep,
// scratch rows component-major inside each output-irrep group, host-built
// wigner_3j non-zeros sorted by m3, path weights folded into C, the mix
// Linear's alphas folded into wsel).  The TPU kernel receives x already
// gathered by XLA and keeps its (u, e) lane layout, 128-lane padding and
// dense C2 operator for the MXU; here the gather is an indexed load, the CG
// contraction walks the non-zeros, and rows are edge-major.
//
// Two kernels on the caller's stream from one C entry:
//
// 1. uvu_edge_kernel: thread (u, edge) walks a chunk of the paths and
//    writes each weighted, unmixed CG row of its edge ONCE with a plain
//    store (every (path, m3) has a non-zero, checked on the host when the
//    tables are built), so the scratch needs no zero fill and no atomics.
//    Paths are split over blockIdx.y so that a 96-edge batch still fills
//    the card.  An edge whose source lies outside [0, N) reads x as zero.
// 2. rowmix::gemm_kernel (row_mix.cuh): the per-edge mix on the tensor
//    cores (3xTF32), one owner per output tile, plain stores.
//
// What bounds it on the card: the scratch round trip (K * mul floats per
// edge written and read: 143 KB per edge at the hamiltonian head, K = 560,
// mul = 64) and the mix (2 * mul * mul_out * K FLOPs per edge) on the
// tensor cores; the radial weights [E, P * mul] are read once.  Fusing the mix
// into the edge kernel would drop the round trip.
//
// The backward replaces PallasUVUConv._bwd_kernel (fused_conv.py:278,
// launched at :447).  Given gout = dL/dout and the forward's scratch S (the
// weighted, unmixed rows, saved: the forward writes them anyway) it returns
// dx [N, in_dim], dsh [E, J], dw [E, P * mul] and dwsel:
//
// 1. rowmix::mix_products (row_mix.cuh, the tensor-core GEMM): dS = gout_q
//    @ wsel_q^T per edge, one owner per tile of each block of scratch
//    columns, and dwsel_q = S_q^T @ gout_q over the d components of a
//    (group, slot), split over chunks of edges as far as the card needs
//    blocks and added in split order: plain stores, a fixed order.
// 2. uvu_bwd_edge_kernel: the forward's sweep run backwards.  Thread
//    (u, edge) walks a chunk of the paths; per path it reads dS[e, row(m3)]
//    once per component, recomputes mid[m3] over the non-zeros, stores
//    dw[e, wcol + u] = sum_m3 dS * mid once, adds w * sum C * dS * sh into
//    dx[src_e] with atomics (edges share sources; the mirror of the
//    forward's gather), and reduces w * sum C * dS * x over the channels
//    with warp shuffles into a shared-memory row of dsh, which the block
//    adds to dsh[e] with one atomic per (edge, j) (paths are split over
//    blockIdx.y as in the forward, so several blocks share an edge).
//
// The TPU kernel recomputes mid from the dense C2 operator and streams the
// adjoint through C2T per output group; here the adjoint is the same walk
// over the non-zeros with two more multiply-adds each.  What bounds the
// backward: the dS round trip (as wide as S, written by the mix product
// and read by the sweep) and the two mix products (4 * mul * mul_out * K
// FLOPs per edge, on the tensor cores in 3xTF32); dx and dsh are the only
// outputs summed with atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace {

constexpr int kMaxSh = 16;
constexpr int kMaxD = 9;           // components of an l <= 4 irrep
constexpr int kPathFields = 9;
constexpr int kRows = rowmix::kRowsPerBlock;

__global__ void uvu_edge_kernel(
    const float* __restrict__ x, int N, int in_dim,
    const float* __restrict__ sh, int J,
    const float* __restrict__ w, int PC,
    const long long* __restrict__ src, int E,
    const int* __restrict__ paths, int P, int paths_per_block,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    float* __restrict__ S, int KM) {
  __shared__ float s_sh[kRows][kMaxSh];

  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int el = threadIdx.y;
  const int e0 = blockIdx.x * kRows;
  for (int i = el * mul + u; i < kRows * J; i += mul * kRows) {
    const int r = i / J, j = i % J;
    s_sh[r][j] = e0 + r < E ? sh[(size_t)(e0 + r) * J + j] : 0.f;
  }
  __syncthreads();
  const int e = e0 + el;
  if (e >= E) return;

  const long long s = src[e];
  const bool valid = s >= 0 && s < N;
  const float* xrow = x + (valid ? (size_t)s * in_dim : 0);
  const float* wrow = w + (size_t)e * PC + u;
  float* srow = S + (size_t)e * KM + u;

  const int p_begin = blockIdx.y * paths_per_block;
  const int p_end = min(P, p_begin + paths_per_block);
  for (int p = p_begin; p < p_end; ++p) {
    const int* pi = paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], j0 = pi[2];
    const int row_base = pi[4], row_stride = pi[5], wcol = pi[6];
    const int nz0 = pi[7], nz1 = pi[8];
    const float wv = valid ? wrow[wcol] : 0.f;
    const float* xs = xrow + x_off + u * d1;
    int m3_cur = -1;
    float acc = 0.f;
    for (int z = nz0; z < nz1; ++z) {
      const int code = nz_idx[z];
      const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
      if (m3 != m3_cur) {
        if (m3_cur >= 0)
          srow[(size_t)(row_base + m3_cur * row_stride) * mul] = wv * acc;
        m3_cur = m3;
        acc = 0.f;
      }
      acc += nz_c[z] * __ldg(xs + m1) * s_sh[el][j0 + m2];
    }
    if (m3_cur >= 0)
      srow[(size_t)(row_base + m3_cur * row_stride) * mul] = wv * acc;
  }
}

__global__ void uvu_bwd_edge_kernel(
    const float* __restrict__ x, int N, int in_dim,
    const float* __restrict__ sh, int J,
    const float* __restrict__ w, int PC,
    const long long* __restrict__ src, int E,
    const int* __restrict__ paths, int P, int paths_per_block,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    const float* __restrict__ dS, int KM,
    float* __restrict__ dx, float* __restrict__ dsh, float* __restrict__ dw) {
  __shared__ float s_sh[kRows][kMaxSh];
  __shared__ float s_dsh[kRows][kMaxSh];

  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int el = threadIdx.y;
  const int tid = el * mul + u;
  const int e0 = blockIdx.x * kRows;
  for (int i = tid; i < kRows * J; i += mul * kRows) {
    const int r = i / J, j = i % J;
    s_sh[r][j] = e0 + r < E ? sh[(size_t)(e0 + r) * J + j] : 0.f;
    s_dsh[r][j] = 0.f;
  }
  __syncthreads();

  // the lanes of one edge inside a warp (mul is a power of two below 32 or
  // a multiple of 32): the dsh partial sums are reduced over them
  const int lanes = mul < 32 ? mul : 32;
  const int lane = tid & 31;
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu
                  : (((1u << lanes) - 1u) << (lane & ~(lanes - 1)));

  // an edge past E, or with a source outside [0, N), contributes nothing
  // (the forward reads its x and w as zero); its dw row is zero
  const int e = e0 + el;
  const long long s = e < E ? src[e] : -1;
  const bool valid = s >= 0 && s < N;
  const float* xrow = x + (valid ? (size_t)s * in_dim : 0);
  const size_t e_at = e < E ? (size_t)e : 0;
  const float* wrow = w + e_at * PC + u;
  const float* grow = dS + e_at * KM + u;

  const int p_begin = blockIdx.y * paths_per_block;
  const int p_end = min(P, p_begin + paths_per_block);
  for (int p = p_begin; p < p_end; ++p) {
    const int* pi = paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], j0 = pi[2], d2 = pi[3];
    const int row_base = pi[4], row_stride = pi[5], wcol = pi[6];
    const int nz0 = pi[7], nz1 = pi[8];
    float dxl[kMaxD], dshl[kMaxD];
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) dxl[i] = dshl[i] = 0.f;

    if (valid) {
      const float wv = wrow[wcol];
      const float* xs = xrow + x_off + u * d1;
      float dwv = 0.f, mid = 0.f, gv = 0.f;
      int m3_cur = -1;
      for (int z = nz0; z < nz1; ++z) {
        const int code = nz_idx[z];
        const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
        if (m3 != m3_cur) {
          dwv += gv * mid;
          m3_cur = m3;
          mid = 0.f;
          gv = __ldg(grow + (size_t)(row_base + m3 * row_stride) * mul);
        }
        const float c = nz_c[z];
        const float xv = __ldg(xs + m1);
        const float sv = s_sh[el][j0 + m2];
        mid += c * xv * sv;
        const float v = c * gv * wv;           // douter(m1, m2)
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) {
          if (i == m1) dxl[i] += v * sv;
          if (i == m2) dshl[i] += v * xv;
        }
      }
      dwv += gv * mid;
      dw[(size_t)e * PC + wcol + u] = dwv;
      float* dxs = dx + (size_t)s * in_dim + x_off + u * d1;
#pragma unroll
      for (int i = 0; i < kMaxD; ++i)
        if (i < d1) atomicAdd(dxs + i, dxl[i]);
    } else if (e < E) {
      dw[(size_t)e * PC + wcol + u] = 0.f;
    }

    // dsh[e, j0 + m2]: over the edge's channels in a warp, then over its
    // warps and the block's paths in shared memory
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      if (i >= d2) continue;
      float v = dshl[i];
      for (int off = lanes / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(gmask, v, off);
      if ((lane & (lanes - 1)) == 0 && valid) atomicAdd(&s_dsh[el][j0 + i], v);
    }
  }

  __syncthreads();
  for (int i = tid; i < kRows * J; i += mul * kRows) {
    const int r = i / J, j = i % J;
    if (e0 + r < E) atomicAdd(dsh + (size_t)(e0 + r) * J + j, s_dsh[r][j]);
  }
}

}  // namespace

extern "C" int uvu_conv_fwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* w, int PC,
    const long long* src, int E,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs_host, int n_probs,
    float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0) return (int)cudaGetLastError();
  if (P > 0) {
    const int ppb = rowmix::paths_per_block(E, P);
    dim3 block(mul, kRows);
    dim3 grid((E + kRows - 1) / kRows, (P + ppb - 1) / ppb);
    uvu_edge_kernel<<<grid, block, 0, s>>>(x, N, in_dim, sh, J, w, PC, src, E,
                                           paths, P, ppb, nz_idx, nz_c,
                                           scratch, KM);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowmix::mix_rows(scratch, E, KM, wsel, probs_host, n_probs,
                               out, out_dim, s);
}

// probs_host: the mix problem table, on the host.  scratch: the forward's
// weighted, unmixed rows [E, K * mul].  dS: work buffer of that shape; ws
// [ws_len]: the split products' partial tiles.
extern "C" int uvu_conv_bwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* w, int PC,
    const long long* src, int E,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    const float* scratch, int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* dS, float* dx, float* dsh, float* dw, float* dwsel, float* ws,
    int ws_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t f = sizeof(float);
  struct { void* p; size_t n; } zero[] = {
      {dx, (size_t)N * in_dim}, {dsh, (size_t)E * J}};
  for (auto& b : zero) {
    cudaError_t err = cudaMemsetAsync(b.p, 0, b.n * f, s);
    if (err != cudaSuccess) return (int)err;
  }
  // dwsel (zero when there is no edge), then dS
  cudaError_t err = rowmix::mix_products(
      rowmix::kMixWeights, probs_host, n_probs, E, KM, out_dim, scratch,
      nullptr, gout, dwsel, wsel_len, ws, ws_len, s);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaGetLastError();
  err = rowmix::mix_products(rowmix::kMixRows, probs_host, n_probs, E, KM,
                             out_dim, nullptr, wsel, gout, dS, wsel_len, ws,
                             ws_len, s);
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    const int ppb = rowmix::paths_per_block(E, P);
    dim3 block(mul, kRows);
    dim3 grid((E + kRows - 1) / kRows, (P + ppb - 1) / ppb);
    uvu_bwd_edge_kernel<<<grid, block, 0, s>>>(
        x, N, in_dim, sh, J, w, PC, src, E, paths, P, ppb, nz_idx, nz_c, dS,
        KM, dx, dsh, dw);
  }
  return (int)cudaGetLastError();
}
