// Internal-weight all-uvu tensor-product expansion of the hamiltonian head
// (K5): outer product, CG contraction and mix of PairwiseTP.
//
// Replaces the TPU kernel PallasPairwiseTP._fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/pairwise.py (the body at :410, launched
// from _pallas_fn at :642).  As there, stage 1 -- the per-path weighting of
// the right operand, bw_p[m, u, j] = sum_v W_p[u, v] b[m, v, j] -- is a
// plain product outside the kernel (the wrapper's, in PyTorch); the kernel
// computes, per element m,
//
//   S[m, row(p, m3), u] = sum_nz C_p * a[m, m1, u] * bw[m, r0(p) + m2, u]
//   out[m, cols(q)]     = S[m, a_col(q) : +kdim(q)] @ wsel_q    per problem q
//
// over the mix-reachable paths p, sorted by output irrep, with scratch rows
// component-major inside each output-irrep group (K1's conventions), the
// path weights folded into the host-built wigner_3j non-zeros C and the mix
// Linear's alphas into wsel.  The TPU kernel's per-(i1, i2) sections, dense
// C2 operators (229,024 entries against 52,092 non-zeros at the full-width
// head), K8 row padding and (u, e) lane layout are MXU devices and are not
// carried over: the contraction walks the non-zeros.
//
// Two kernels on the caller's stream from one C entry:
//
// 1. pairwise_cg_kernel: thread (u, element) walks a chunk of the paths;
//    a is read through L1 (d1 neighbouring floats per thread), bw
//    [M, R, mul] coalesced over u; every scratch row of the element is
//    written once with a plain store (each (path, m3) has a non-zero,
//    checked on the host).  Paths are split over blockIdx.y so that a
//    48-element batch still fills the card.
// 2. rowmix::mix_rows_kernel (row_mix.cuh): the mix, plain stores.
//
// What bounds it on the card: f32 FMAs on CUDA cores (2 * mul per CG
// non-zero and 2 * mul * mul_out per scratch row: ~19 MFLOP per element at
// the full-width head) and the scratch round trip (R * mul floats of bw
// read, as many of S written and read again: 384 KB each per element).
// Keeping S in shared memory per output-irrep group, and tensor cores for
// the mix, are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace {

constexpr int kPathFields = 9;
constexpr int kRows = rowmix::kRowsPerBlock;

__global__ void pairwise_cg_kernel(
    const float* __restrict__ a, int M, int a_dim,
    const float* __restrict__ bw, int R,
    const int* __restrict__ paths, int P, int paths_per_block,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    float* __restrict__ S, int KM) {
  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int m = blockIdx.x * kRows + threadIdx.y;
  if (m >= M) return;
  const float* arow = a + (size_t)m * a_dim;
  const float* brow = bw + (size_t)m * R * mul + u;
  float* srow = S + (size_t)m * KM + u;

  const int p_begin = blockIdx.y * paths_per_block;
  const int p_end = min(P, p_begin + paths_per_block);
  for (int p = p_begin; p < p_end; ++p) {
    const int* pi = paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], r0 = pi[2];
    const int row_base = pi[4], row_stride = pi[5];
    const int nz0 = pi[7], nz1 = pi[8];
    const float* as = arow + x_off + u * d1;
    const float* bs = brow + (size_t)r0 * mul;
    int m3_cur = -1;
    float acc = 0.f;
    for (int z = nz0; z < nz1; ++z) {
      const int code = nz_idx[z];
      const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
      if (m3 != m3_cur) {
        if (m3_cur >= 0)
          srow[(size_t)(row_base + m3_cur * row_stride) * mul] = acc;
        m3_cur = m3;
        acc = 0.f;
      }
      acc += nz_c[z] * __ldg(as + m1) * __ldg(bs + m2 * mul);
    }
    if (m3_cur >= 0)
      srow[(size_t)(row_base + m3_cur * row_stride) * mul] = acc;
  }
}

}  // namespace

extern "C" int pairwise_tp_fwd(
    const float* a, int M, int a_dim,
    const float* bw, int R,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs, int n_probs, int max_wo,
    float* out, int out_dim, int zero_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return (int)cudaGetLastError();
  if (zero_out) {
    // some output columns belong to no mix problem: they stay zero
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)M * (size_t)out_dim * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (P > 0) {
    const int ppb = rowmix::paths_per_block(M, P);
    dim3 block(mul, kRows);
    dim3 grid((M + kRows - 1) / kRows, (P + ppb - 1) / ppb);
    pairwise_cg_kernel<<<grid, block, 0, s>>>(a, M, a_dim, bw, R, paths, P,
                                              ppb, nz_idx, nz_c, scratch, KM);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowmix::mix_rows(scratch, M, KM, wsel, probs, n_probs, max_wo,
                               out, out_dim, s);
}
