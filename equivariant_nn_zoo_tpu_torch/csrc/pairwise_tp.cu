// Internal-weight all-uvu tensor-product expansion of the hamiltonian head:
// outer product, CG contraction and mix of PairwiseTP, forward (K5) and
// backward (K5m, K5a, K5b).
//
// The forward replaces the TPU kernel PallasPairwiseTP._fwd_kernel in
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
// 2. rowmix::gemm_kernel (row_mix.cuh): the mix on the tensor cores
//    (3xTF32), one owner per output tile, plain stores.
//
// What bounds it on the card: the scratch round trip (R * mul floats of bw
// read, as many of S written and read again: 384 KB each per element) and
// the CG sweep's f32 FMAs on CUDA cores (2 * mul per CG non-zero); the mix
// (2 * mul * mul_out per scratch row, ~12 MFLOP per element at the
// full-width head) runs on the tensor cores.  Keeping S in shared memory
// per output-irrep group is the next step.
//
// The backward replaces the three TPU kernels _bwd_kernel_dws,
// _bwd_kernel_da and _bwd_kernel_dbw (pairwise.py:504, :556, :591; launched
// at :655, :670, :684).  Given gout = dL/dout it returns dwsel, da [M, a_dim]
// and dbw [M, R, mul] from one C entry:
//
// 0. pairwise_cg_kernel again: S is recomputed, not saved (1.05 MFLOP per
//    element against 12.3 for the mix, and a saved S would double what a
//    training step keeps per element beside bw).
// 1. K5m, rowmix::mix_products (row_mix.cuh, the tensor-core GEMM):
//    dwsel_q = S_q^T @ gout_q over the d components of a (group, slot),
//    split over chunks of elements as far as the card needs blocks, the
//    partial tiles added in split order (no atomics, a fixed order); the
//    same GEMM gives dS = gout_q @ wsel_q^T with one owner per tile,
//    which K5a and K5b read (on the TPU each of them recomputes it per
//    section).
// 2. K5a, pairwise_da_kernel: da[m, m1, u] = sum over the paths with this
//    left irrep, sum_nz C * bw[m, r0(p) + m2, u] * dS[m, row(p, m3), u].
//    The columns of a left irrep are shared by all its paths, so a block
//    row takes one left irrep (blockIdx.y) and thread (u, element) walks
//    that irrep's paths with the d1 <= 9 sums in registers and stores them
//    once: no atomics, whatever M is.
// 3. K5b, pairwise_dbw_kernel: dbw[m, r0(p) + m2, u] = sum_nz C *
//    a[m, m1, u] * dS[m, row(p, m3), u].  Every bw row belongs to one path,
//    so thread (u, element) keeps the d2 <= 9 sums of a path in registers
//    and stores them once; paths are split over blockIdx.y as in the
//    forward.
//
// dS[row(m3)] is read once per run of equal m3 (the non-zeros are sorted by
// m3 for the forward's one-store-per-row trick; the same order serves the
// adjoint).  What bounds the backward: four scratch-sized streams (S, dS,
// bw, dbw: 384 KB per element each) and the two mix products (2 x 12.3
// MFLOP per element, on the tensor cores in 3xTF32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace {

constexpr int kPathFields = 9;
constexpr int kSlotFields = 4;     // x_off, d1, first and last+1 slot path
constexpr int kMaxD = 9;           // components of an l <= 4 irrep
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

// K5a.  grid: (element rows, left irreps); slot_paths lists the paths of
// each left irrep.
__global__ void pairwise_da_kernel(
    const float* __restrict__ bw, int M, int R,
    const float* __restrict__ dS, int KM,
    const int* __restrict__ paths, const int* __restrict__ slots,
    const int* __restrict__ slot_paths,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    float* __restrict__ da, int a_dim) {
  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int m = blockIdx.x * kRows + threadIdx.y;
  if (m >= M) return;
  const int* sl = slots + blockIdx.y * kSlotFields;
  const int x_off = sl[0], d1 = sl[1];
  const float* brow = bw + (size_t)m * R * mul + u;
  const float* grow = dS + (size_t)m * KM + u;
  float dal[kMaxD];
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) dal[i] = 0.f;

  for (int k = sl[2]; k < sl[3]; ++k) {
    const int* pi = paths + slot_paths[k] * kPathFields;
    const int r0 = pi[2], row_base = pi[4], row_stride = pi[5];
    const int nz0 = pi[7], nz1 = pi[8];
    const float* bs = brow + (size_t)r0 * mul;
    int m3_cur = -1;
    float gv = 0.f;
    for (int z = nz0; z < nz1; ++z) {
      const int code = nz_idx[z];
      const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
      if (m3 != m3_cur) {
        m3_cur = m3;
        gv = __ldg(grow + (size_t)(row_base + m3 * row_stride) * mul);
      }
      const float v = nz_c[z] * gv * __ldg(bs + m2 * mul);
#pragma unroll
      for (int i = 0; i < kMaxD; ++i)
        if (i == m1) dal[i] += v;
    }
  }
  float* out = da + (size_t)m * a_dim + x_off + u * d1;
#pragma unroll
  for (int i = 0; i < kMaxD; ++i)
    if (i < d1) out[i] = dal[i];
}

// K5b.  grid: (element rows, path chunks).
__global__ void pairwise_dbw_kernel(
    const float* __restrict__ a, int M, int a_dim,
    const float* __restrict__ dS, int KM,
    const int* __restrict__ paths, int P, int paths_per_block,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    float* __restrict__ dbw, int R) {
  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int m = blockIdx.x * kRows + threadIdx.y;
  if (m >= M) return;
  const float* arow = a + (size_t)m * a_dim;
  const float* grow = dS + (size_t)m * KM + u;
  float* drow = dbw + (size_t)m * R * mul + u;

  const int p_begin = blockIdx.y * paths_per_block;
  const int p_end = min(P, p_begin + paths_per_block);
  for (int p = p_begin; p < p_end; ++p) {
    const int* pi = paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], r0 = pi[2], d2 = pi[3];
    const int row_base = pi[4], row_stride = pi[5];
    const int nz0 = pi[7], nz1 = pi[8];
    const float* as = arow + x_off + u * d1;
    float dbl[kMaxD];
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) dbl[i] = 0.f;
    int m3_cur = -1;
    float gv = 0.f;
    for (int z = nz0; z < nz1; ++z) {
      const int code = nz_idx[z];
      const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
      if (m3 != m3_cur) {
        m3_cur = m3;
        gv = __ldg(grow + (size_t)(row_base + m3 * row_stride) * mul);
      }
      const float v = nz_c[z] * gv * __ldg(as + m1);
#pragma unroll
      for (int i = 0; i < kMaxD; ++i)
        if (i == m2) dbl[i] += v;
    }
    float* out = drow + (size_t)r0 * mul;
#pragma unroll
    for (int i = 0; i < kMaxD; ++i)
      if (i < d2) out[(size_t)i * mul] = dbl[i];
  }
}

}  // namespace

extern "C" int pairwise_tp_fwd(
    const float* a, int M, int a_dim,
    const float* bw, int R,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs_host, int n_probs,
    float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return (int)cudaGetLastError();
  if (P > 0) {
    const int ppb = rowmix::paths_per_block(M, P);
    dim3 block(mul, kRows);
    dim3 grid((M + kRows - 1) / kRows, (P + ppb - 1) / ppb);
    pairwise_cg_kernel<<<grid, block, 0, s>>>(a, M, a_dim, bw, R, paths, P,
                                              ppb, nz_idx, nz_c, scratch, KM);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowmix::mix_rows(scratch, M, KM, wsel, probs_host, n_probs,
                               out, out_dim, s);
}

// probs_host: the mix problem table, on the host.  slots / slot_paths: the
// left irreps with their paths (device).  S and dS: work buffers
// [M, K * mul]; ws [ws_len]: the split products' partial tiles.  parts:
// which cotangents to compute, 1 dwsel (K5m), 2 d left (K5a), 4 dbw (K5b);
// the others' buffers are left untouched.
// Every bw row belongs to a path, so dbw needs no zero fill.
extern "C" int pairwise_tp_bwd(
    const float* a, int M, int a_dim,
    const float* bw, int R,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    const int* slots, int n_slots, const int* slot_paths,
    int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* S, float* dS, float* da, float* dbw, float* dwsel, int parts,
    float* ws, int ws_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_m = parts & 1, want_a = parts & 2, want_b = parts & 4;
  const size_t f = sizeof(float);
  cudaError_t err = cudaSuccess;
  if (want_m && (M <= 0 || P <= 0))
    err = cudaMemsetAsync(dwsel, 0, (size_t)wsel_len * f, s);
  if (err == cudaSuccess && want_a)
    err = cudaMemsetAsync(da, 0, (size_t)M * a_dim * f, s);
  if (err == cudaSuccess && want_b && P <= 0)
    err = cudaMemsetAsync(dbw, 0, (size_t)M * R * mul * f, s);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || P <= 0) return (int)cudaGetLastError();
  const int ppb = rowmix::paths_per_block(M, P);
  const dim3 block(mul, kRows);
  const unsigned row_blocks = (M + kRows - 1) / kRows;
  const dim3 by_path(row_blocks, (P + ppb - 1) / ppb);
  if (want_m) {
    pairwise_cg_kernel<<<by_path, block, 0, s>>>(a, M, a_dim, bw, R, paths, P,
                                                 ppb, nz_idx, nz_c, S, KM);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = rowmix::mix_products(rowmix::kMixWeights, probs_host, n_probs, M, KM,
                               out_dim, S, nullptr, gout, dwsel, wsel_len, ws,
                               ws_len, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (want_a || want_b) {
    err = rowmix::mix_products(rowmix::kMixRows, probs_host, n_probs, M, KM,
                               out_dim, nullptr, wsel, gout, dS, wsel_len, ws,
                               ws_len, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (want_a && n_slots > 0) {
    pairwise_da_kernel<<<dim3(row_blocks, n_slots), block, 0, s>>>(
        bw, M, R, dS, KM, paths, slots, slot_paths, nz_idx, nz_c, da, a_dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (want_b)
    pairwise_dbw_kernel<<<by_path, block, 0, s>>>(a, M, a_dim, dS, KM, paths,
                                                  P, ppb, nz_idx, nz_c, dbw,
                                                  R);
  return (int)cudaGetLastError();
}
