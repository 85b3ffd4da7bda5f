// Whole-convolution forward for one NequIP message-passing layer (K1).
//
// Replaces the TPU kernel PallasFullConv._full_fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py (the body at :926,
// launched from _make_pallas_fn at :2322).  It computes
//
//   out[n] = Mix( sum_{e: dst_e = n}  w_e (.) CG(x[src_e] (x) sh_e) )
//
// with w_e = MLP(edge_radial_e) the bias-free shifted-softplus radial MLP
// (weights pre-divided by sqrt(fan_in)), CG the uvu Clebsch-Gordan paths
// with their path weights, and Mix the TensorProductExpansion Linear with
// its alphas and 1/sqrt(avg_num_neighbors) folded into the mix matrices.
//
// Four kernels, launched back to back on the caller's stream by one C
// entry:
//
// 1. walk::mlp_hidden_kernel (edge_walk.cuh): the MLP's hidden layers per
//    edge, the last layer's activations into a work buffer [E, H].
// 2. k1_walk_kernel: the destination-major walk of edge_walk.cuh.  A block
//    takes one work item (the runs of a few destination nodes, about cap
//    edges, at most 4 * cap) and a chunk of up to four CG paths of one left
//    irrep: the paths are split over blockIdx.y, so 96 edges still make a
//    thousand blocks.  Per stage of 16 edges it forms the radial weights
//    of its paths' columns from the staged hidden activations and W_out
//    (read through L1), and the CG matrices M = C . sh per (edge, path);
//    thread (u, g) then adds w * M x[src] of each edge into the node's d3
//    sums in registers and, when the destination changes, stores the
//    node's UNMIXED rows of the f32 scratch [N, K * mul] once, with a
//    plain store.  Nodes without incoming edges are stored as zeros: every
//    row of every node is written, so the scratch needs no zero fill and
//    no atomics.  Rows are component-major inside each output-irrep group
//    so the mix reads contiguous columns.
// 3. walk::walk_piece_sum_kernel: the rows of the few long runs (the dummy
//    node of the padded edges, a hub), which several items walk in pieces
//    into a pieces buffer [T, K * mul], summed in item order.  A second
//    small pass and not atomics into zeroed rows: the sums keep a fixed
//    order, and only the long nodes' rows are read twice.
// 4. rowmix::gemm_kernel (row_mix.cuh, the tensor-core GEMM shared with
//    every other conv and pairwise kernel): the mix, a product
//    [N, n_paths * mul] x [n_paths * mul, mul_out] per (output-irrep group,
//    component, output slot) in 3xTF32, written straight into the irreps
//    columns with plain stores, one owner per tile.
//
// What bounds it on the card: instruction issue in the walk, at 16 warps
// per SM (two blocks of ~80 KB of shared memory and 128 registers).  The
// walk's own work is f32 FMAs fed by shared-memory loads: the radial
// weights (H * P * mul per edge, 9.6 GFLOP at config_energy's hot layer
// with E = 24386, a broadcast float4 load per four FMAs) and the dense
// per-edge products with M (sum over paths of d3 * pitch(d1) FMAs per
// channel).  Left out one at a time (chip_smoke.py --walk-ablation, H100),
// the parts of the walk's 1.58 ms at that layer cost: radial weights 31 %,
// per-edge products 25 %, CG matrices 17 %, staging and syncs alone 16 %.
// The scratch is written once (110 MB at N = 2022, K = 212, mul = 64) and
// read once by the mix; the radial weights and the per-edge products
// never reach device memory.  Every sum runs in a fixed order, so scratch
// and output repeat bit for bit.  Padded edges need no special case:
// their edge_radial is masked to zero and the MLP has no bias, so their
// weights, and their messages, are zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"
#include "row_mix.cuh"

using namespace walk;

namespace {

// kRows: register rows of the node sums and of x, at least the components
// of the widest irrep on either side (7: l <= 3; 9: l <= 4; 16: l <= 7)
template <int kRows>
__global__ void __launch_bounds__(256, 2) k1_walk_kernel(
    const float* __restrict__ x, int in_dim,
    const float* __restrict__ sh, int J,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    const int* __restrict__ perm, const int* __restrict__ ptr, int N,
    int cap, int T,
    const float* __restrict__ h_last, int H,
    const float* __restrict__ w_out, int PC,
    const int* __restrict__ walk_tab, const int* __restrict__ chunks,
    const int* __restrict__ cells, const float2* __restrict__ nz,
    float* __restrict__ scratch, float* __restrict__ pieces, int KM) {
  constexpr int kP = pitch(kRows);
  extern __shared__ __align__(16) unsigned char smem[];
  const int mul = blockDim.x, u = threadIdx.x, g = threadIdx.y;
  const int tid = g * mul + u, nthr = mul * kGroups;
  const int t = blockIdx.x;
  const int c0 = chunks[2 * blockIdx.y], cn = chunks[2 * blockIdx.y + 1];
  const int* first = walk_tab + (size_t)c0 * kWalkFields;
  const int* last = walk_tab + (size_t)(c0 + cn - 1) * kWalkFields;
  const int x_off = first[kXOff], d1 = first[kD1], xw = d1 * mul;
  const int k0 = first[kCell0], k1 = last[kCell0] + last[kD3] * d1 + 1;
  const int z0 = cells[k0], z1 = cells[k1 - 1];
  const Stage st = carve(smem, z1 - z0, k1 - k0, xw, nthr);
  stage_chunk(st, nz, z0, z1, cells, k0, k1, tid, nthr);
  const Staged staged = {h_last, H, sh, nullptr, J, x, nullptr, in_dim, x_off,
                         xw, x_vectors(x, in_dim, x_off, xw), nullptr,
                         nullptr, 0, 0};

  const bool active = g < cn;
  const int* pi = walk_tab + (size_t)(c0 + (active ? g : 0)) * kWalkFields;
  const int j0 = pi[kJ0], d3 = pi[kD3];
  const int row_base = pi[kRowBase], row_stride = pi[kRowStride];
  const int* my_cells = st.cells + (pi[kCell0] - k0);

  const Item it = item_walk(ptr, N, t, T, cap);
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  int cur = it.first;
  auto flush = [&](int n) {
    float* row = (n == it.head ? pieces + (size_t)t * KM
                               : scratch + (size_t)n * KM) +
                 (size_t)row_base * mul + u;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (m < d3) row[(size_t)m * row_stride * mul] = acc[m];
      acc[m] = 0.f;
    }
  };

  for (int pos0 = it.e_lo; pos0 < it.e_hi; pos0 += kStage) {
    const int nq = min(kStage, it.e_hi - pos0);
    stage_edges(st, pos0, nq, perm, src, dst, true, staged, tid, nthr);
    if (active) {
      cg_matrices<kRows>(st, st.sh, st.m, nq, g, my_cells, d1, d3, j0, u,
                         mul);
      radial_weights(st, w_out, H, PC, pi[kWCol] + u, tid, nthr);
    }
    __syncthreads();
    if (!active) continue;
    for (int q = 0; q < nq; ++q) {
      const int nd = st.node[q];
      for (; cur < nd; ++cur) flush(cur);
      const float w = st.w[q * nthr + tid];
      float xr[kP];
      load_x<kRows>(xr, st.x + q * xw + u * d1, d1);
      const float4* mq = reinterpret_cast<const float4*>(
          st.m + (q * kGroups + g) * kRows * kP);
#pragma unroll
      for (int m3 = 0; m3 < kRows; ++m3) {
        if (m3 >= d3) break;
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < kP / 4; ++k) {
          if (4 * k >= d1) break;
          const float4 v = mq[m3 * (kP / 4) + k];
          a += v.x * xr[4 * k] + v.y * xr[4 * k + 1] + v.z * xr[4 * k + 2] +
               v.w * xr[4 * k + 3];
        }
        acc[m3] += w * a;
      }
    }
  }
  if (active)
    for (; cur < it.end; ++cur) flush(cur);
}

}  // namespace

// walk_tab, chunks, nz: the walk tables (ConvTables); perm, ptr: the
// destination-major edge order; h_work [E, H] and pieces [T, KM]: work
// buffers (f32, uninitialised); probs_host: the mix problem table, on the
// host.
extern "C" int full_conv_fwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* er, int R,
    const long long* src, const long long* dst, int E,
    const float* w_hidden, int H, int n_hidden,
    const float* w_out, int PC, float act_cst,
    const int* walk_tab, const int* chunks, int n_chunks, const int* cells,
    const float* nz, int max_chunk_nz, int max_d1, int max_d3,
    const int* perm, const int* ptr, int cap, int T,
    float* h_work, float* pieces,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs_host, int n_probs,
    float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = max_d1 > max_d3 ? max_d1 : max_d3;
  if (rows > 16 || R > kMaxRadial || cap < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (E > 0) {
    const unsigned blocks = (E + kHiddenEdges - 1) / kHiddenEdges;
    mlp_hidden_kernel<<<blocks, 256, 0, s>>>(er, R, E, w_hidden, H, n_hidden,
                                             act_cst, nullptr, h_work, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0 && n_chunks > 0) {
    const int kr = walk_rows(rows);
    const size_t bytes =
        stage_bytes(max_chunk_nz, max_d1, max_d3, max_d1 * mul,
                    mul * kGroups, kr);
    auto kernel = kr == 16      ? k1_walk_kernel<16>
                  : kr == kMaxD ? k1_walk_kernel<kMaxD>
                                : k1_walk_kernel<7>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(T, n_chunks), dim3(mul, kGroups), bytes, s>>>(
        x, in_dim, sh, J, src, dst, perm, ptr, N, cap, T, h_work, H, w_out,
        PC, walk_tab, chunks, cells, reinterpret_cast<const float2*>(nz),
        scratch, pieces, KM);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sum_pieces(ptr, N, T, cap, pieces, KM, scratch, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowmix::mix_rows(scratch, N, KM, wsel, probs_host, n_probs,
                               out, out_dim, s);
}
