// Per-edge uvu tensor-product convolution without the edge sum (K6).
//
// Replaces the TPU kernel PallasUVUConv._fwd_kernel in
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
// 2. rowmix::mix_rows_kernel (row_mix.cuh): the per-edge mix, plain stores.
//
// What bounds it on the card: the scratch round trip (K * mul floats per
// edge written and read: 143 KB per edge at the hamiltonian head, K = 560,
// mul = 64) and the f32 FMAs of the mix (2 * mul * mul_out * K per edge) on
// CUDA cores; the radial weights [E, P * mul] are read once.  Fusing the mix
// into the edge kernel would drop the round trip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace {

constexpr int kMaxSh = 16;
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

}  // namespace

extern "C" int uvu_conv_fwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* w, int PC,
    const long long* src, int E,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs, int n_probs, int max_wo,
    float* out, int out_dim, int zero_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0) return (int)cudaGetLastError();
  if (zero_out) {
    // some output columns belong to no mix problem: they stay zero
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)E * (size_t)out_dim * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
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
  return (int)rowmix::mix_rows(scratch, E, KM, wsel, probs, n_probs, max_wo,
                               out, out_dim, s);
}
