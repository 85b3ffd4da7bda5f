// Species-table self-connection forward (K3).
//
// Replaces the TPU kernel SpeciesScalarFCTP._fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/sc.py (the body at :181, launched at
// :301).  When the node attributes are a pure per-species embedding, the
// self-connection FullyConnectedTensorProduct reduces to
//
//   out_l[n] = x_l[n] @ A_l[species_n],   A_l[t] = rep_t @ W_l * pw / sqrt(d)
//
// per instruction l (input slot -> output slot).  The tables A are tiny
// (one [types, sum of mul1 * mul_out] matrix; row t holds A_l[t] of every
// instruction l) and are built in plain PyTorch by the wrapper, as the TPU
// package builds them in XLA; this kernel is the per-node, per-species
// product.  A block takes 8 nodes and one output
// slot; thread (node, w) sums x[n, x_off + u*d + m] * A[t, u, w] over u for
// every component m and every instruction writing that slot, and stores
// the result in the irreps column order (w, m).  Out-of-range species give
// zero rows, as the TPU kernel's species masks do.
//
// What bounds it on the card: reading the per-species tables through L2
// (mul1 * mul_out floats per node and instruction; the tables, ~1 MB per
// layer, stay L2-resident) — about 2 * 64 * 2432 FLOPs per node in a hot
// layer, small beside the convolution.  Consecutive threads take
// consecutive w, so table reads are coalesced and x reads are broadcasts.
// The TPU kernel's e/o slot pairing was an MXU-occupancy device and is not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodesPerBlock = 8;
constexpr int kOutFields = 5;
constexpr int kItemFields = 3;

__global__ void species_sc_kernel(
    const float* __restrict__ x, int N, int in_dim,
    const long long* __restrict__ species, int types,
    const float* __restrict__ tables, int a_stride,
    const int* __restrict__ outs, const int* __restrict__ items,
    float* __restrict__ out, int out_dim) {
  const int* po = outs + blockIdx.y * kOutFields;
  const int out_off = po[0], d = po[1], mo = po[2], it0 = po[3], it1 = po[4];
  const int n0 = blockIdx.x * kNodesPerBlock;
  for (int i = threadIdx.x; i < kNodesPerBlock * mo; i += blockDim.x) {
    const int n = n0 + i / mo, w = i % mo;
    if (n >= N) continue;
    const long long t = species[n];
    const bool valid = t >= 0 && t < types;
    for (int m = 0; m < d; ++m) {
      float acc = 0.f;
      if (valid) {
        for (int it = it0; it < it1; ++it) {
          const int x_off = items[it * kItemFields];
          const int mul1 = items[it * kItemFields + 1];
          const int a_off = items[it * kItemFields + 2];
          const float* xr = x + (size_t)n * in_dim + x_off + m;
          const float* A = tables + (size_t)t * a_stride + a_off + w;
          for (int u = 0; u < mul1; ++u)
            acc += __ldg(xr + u * d) * __ldg(A + (size_t)u * mo);
        }
      }
      out[(size_t)n * out_dim + out_off + w * d + m] = acc;
    }
  }
}

}  // namespace

extern "C" int species_sc_fwd(
    const float* x, int N, int in_dim, const long long* species, int types,
    const float* tables, int a_stride, const int* outs, int n_outs,
    const int* items, float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)N * (size_t)out_dim * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && n_outs > 0) {
    dim3 grid((N + kNodesPerBlock - 1) / kNodesPerBlock, n_outs);
    species_sc_kernel<<<grid, 256, 0, s>>>(x, N, in_dim, species, types,
                                           tables, a_stride, outs, items,
                                           out, out_dim);
  }
  return (int)cudaGetLastError();
}
