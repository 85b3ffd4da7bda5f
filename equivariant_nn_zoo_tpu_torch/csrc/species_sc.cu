// Species-table self-connection, forward (K3) and backward (K3b).
//
// The forward replaces the TPU kernel SpeciesScalarFCTP._fwd_kernel in
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
//
// The backward replaces SpeciesScalarFCTP._bwd_kernel (sc.py:208, launched
// at :315).  Given g = dL/dout it computes, in two kernels:
//
// 1. species_sc_dx_kernel: dx[n, x_off + u*d + m] =
//      sum over the instructions reading that input slot, sum_w
//      g[n, out_off + w*d + m] * A[species_n, a_off + u*mul_out + w];
//    a block takes 8 nodes and one input slot, thread (node, u) keeps the
//    components in registers and writes its row once (no atomics); compiled
//    for 7 register rows (l <= 3) and for 9 (l = 4, the hamiltonian trunk),
//    the host picks by the widest irrep.
// 2. species_sc_dA_kernel: dA[t, a_off + u*mul_out + w] =
//      sum_{n: species_n = t} sum_m x[n, x_off + u*d + m] * g[n, out_off +
//      w*d + m],
//    a reduction over nodes.  A block takes one 128-node chunk, one
//    instruction, one species and one 64x64 tile of (u, w); it compacts
//    the chunk's nodes of that species into shared memory, runs a tiled
//    product over (node, m) and adds its tile into dA with one atomic per
//    element (chunks x tiles atomics in all, ~N/128 per table entry).
//
// The backward reads x, g and the tables once per instruction, as the
// forward does; dA's atomics are few (one per chunk and element).
// Out-of-range species give zero dx rows and add nothing to dA.

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

constexpr int kBwdItemFields = 6;  // x_off, mul1, a_off, out_off, d, mul_out
constexpr int kInFields = 5;       // x_off, d, mul1, item begin, item end
constexpr int kChunk = 128;        // nodes per dA block
constexpr int kTile = 64;
constexpr int kTileK = 16;

// kD: register rows, the components of the widest irrep
template <int kD>
__global__ void species_sc_dx_kernel(
    const float* __restrict__ g, int N, int out_dim,
    const long long* __restrict__ species, int types,
    const float* __restrict__ tables, int a_stride,
    const int* __restrict__ ins, const int* __restrict__ items,
    float* __restrict__ dx, int in_dim) {
  const int* pi = ins + blockIdx.y * kInFields;
  const int x_off = pi[0], d = pi[1], mul1 = pi[2], it0 = pi[3], it1 = pi[4];
  const int n0 = blockIdx.x * kNodesPerBlock;
  for (int i = threadIdx.x; i < kNodesPerBlock * mul1; i += blockDim.x) {
    const int n = n0 + i / mul1, u = i % mul1;
    if (n >= N) continue;
    const long long t = species[n];
    float acc[kD];
#pragma unroll
    for (int m = 0; m < kD; ++m) acc[m] = 0.f;
    if (t >= 0 && t < types) {
      for (int it = it0; it < it1; ++it) {
        const int* pt = items + it * kBwdItemFields;
        const int a_off = pt[2], out_off = pt[3], mo = pt[5];
        const float* A = tables + (size_t)t * a_stride + a_off + (size_t)u * mo;
        const float* gr = g + (size_t)n * out_dim + out_off;
        for (int w = 0; w < mo; ++w) {
          const float a = __ldg(A + w);
#pragma unroll
          for (int m = 0; m < kD; ++m)
            if (m < d) acc[m] += __ldg(gr + w * d + m) * a;
        }
      }
    }
    float* out = dx + (size_t)n * in_dim + x_off + u * d;
#pragma unroll
    for (int m = 0; m < kD; ++m)
      if (m < d) out[m] = acc[m];
  }
}

// grid: (node chunks, instructions, types * u tiles * w tiles)
__global__ void species_sc_dA_kernel(
    const float* __restrict__ x, int N, int in_dim,
    const float* __restrict__ g, int out_dim,
    const long long* __restrict__ species, int types,
    const int* __restrict__ items, int tiles_u, int tiles_w,
    float* __restrict__ dA, int a_stride) {
  const int* pt = items + blockIdx.y * kBwdItemFields;
  const int x_off = pt[0], mul1 = pt[1], a_off = pt[2], out_off = pt[3];
  const int d = pt[4], mo = pt[5];
  const int t = blockIdx.z / (tiles_u * tiles_w);
  const int tile = blockIdx.z % (tiles_u * tiles_w);
  const int u0 = (tile / tiles_w) * kTile, w0 = (tile % tiles_w) * kTile;
  if (u0 >= mul1 || w0 >= mo) return;

  __shared__ int s_nodes[kChunk];
  __shared__ int s_count;
  __shared__ float Xs[kTileK][kTile];
  __shared__ float Gs[kTileK][kTile];
  const int c0 = blockIdx.x * kChunk;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int i = 0; i < kChunk && c0 + i < N; ++i)
      if (species[c0 + i] == t) s_nodes[c++] = c0 + i;
    s_count = c;
  }
  __syncthreads();
  const int K = s_count * d;  // reduction over (node, component) pairs
  if (K == 0) return;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      const int kk = i / kTile, c = i % kTile, k = k0 + kk;
      float xv = 0.f, gv = 0.f;
      if (k < K) {
        const int n = s_nodes[k / d], m = k % d;
        if (u0 + c < mul1)
          xv = x[(size_t)n * in_dim + x_off + (u0 + c) * d + m];
        if (w0 + c < mo)
          gv = g[(size_t)n * out_dim + out_off + (w0 + c) * d + m];
      }
      Xs[kk][c] = xv;
      Gs[kk][c] = gv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Gs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  float* out = dA + (size_t)t * a_stride + a_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + ty * 4 + i;
    if (u >= mul1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + tx * 4 + j;
      if (w < mo) atomicAdd(out + (size_t)u * mo + w, acc[i][j]);
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

extern "C" int species_sc_bwd(
    const float* x, int N, int in_dim, const long long* species, int types,
    const float* tables, int a_stride, const float* g, int out_dim,
    const int* ins, int n_ins, const int* items, int n_items, int max_mul1,
    int max_mo, int max_d, float* dx, float* dA, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_d > 9) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      dx, 0, (size_t)N * (size_t)in_dim * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dA, 0, (size_t)types * (size_t)a_stride * sizeof(float),
                        s);
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && n_ins > 0) {
    dim3 grid((N + kNodesPerBlock - 1) / kNodesPerBlock, n_ins);
    auto kernel = species_sc_dx_kernel<7>;
    if (max_d > 7) kernel = species_sc_dx_kernel<9>;
    kernel<<<grid, 256, 0, s>>>(g, N, out_dim, species, types, tables,
                                a_stride, ins, items, dx, in_dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0 && n_items > 0 && types > 0) {
    const int tiles_u = (max_mul1 + kTile - 1) / kTile;
    const int tiles_w = (max_mo + kTile - 1) / kTile;
    dim3 grid((N + kChunk - 1) / kChunk, n_items, types * tiles_u * tiles_w);
    species_sc_dA_kernel<<<grid, 256, 0, s>>>(x, N, in_dim, g, out_dim,
                                              species, types, items, tiles_u,
                                              tiles_w, dA, a_stride);
  }
  return (int)cudaGetLastError();
}
