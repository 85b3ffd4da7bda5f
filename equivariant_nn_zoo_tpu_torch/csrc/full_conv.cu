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
// Two kernels, launched back to back on the caller's stream by one C entry:
//
// 1. full_conv_edge_kernel: a block takes 16 edges.  It runs the MLP's
//    hidden layers for them in shared memory, then walks the CG paths; for
//    each path, thread (u, edge group) forms the radial weight w[p, u] from
//    the last MLP layer (read through L1/L2, reused over the thread's 4
//    edges), contracts x[src] with sh over the path's host-built table of
//    wigner_3j non-zeros, and adds the weighted, UNMIXED result into an f32
//    scratch [N, K * mul] with atomicAdd (one atomic per edge, CG row and
//    channel).  Rows are component-major inside each output-irrep group so
//    the mix reads contiguous columns.
// 2. full_conv_mix_kernel: a 64x64-tiled shared-memory product
//    [N, n_paths * mul] x [n_paths * mul, mul_out] per (output-irrep group,
//    component, output slot), written straight into the irreps columns.
//
// What bounds it on the card: the edge kernel's atomics into the scratch
// (E * K * mul of them, ~390 M per hot layer at E = 28672, K = 212,
// mul = 64) and its f32 FMAs (the last MLP layer alone is 64 * P * mul per
// edge).  The design keeps the mix after the scatter (it commutes with the
// edge sum), so the widest product runs per node, not per edge, and keeps
// the radial weights and the per-edge TP out of device memory.  Padded
// edges need no special case: their edge_radial is masked to zero and the
// MLP has no bias, so their weights, and their messages, are zero.
// Atomics make the order of summation vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdgeGroups = 4;     // blockDim.y of the edge kernel
constexpr int kEdgesPerThread = 4;
constexpr int kEdgesPerBlock = kEdgeGroups * kEdgesPerThread;
constexpr int kMaxHidden = 64;
constexpr int kMaxRadial = 16;
constexpr int kMaxSh = 16;
constexpr int kPathFields = 9;
constexpr int kProbFields = 6;
constexpr int kTile = 64;
constexpr int kTileK = 16;

__device__ __forceinline__ float ssp(float v, float cst) {
  // (softplus(v) - log 2) * cst, softplus as max(v, 0) + log1p(exp(-|v|))
  float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return (sp - 0.69314718055994530942f) * cst;
}

__global__ void full_conv_edge_kernel(
    const float* __restrict__ x, int in_dim,
    const float* __restrict__ sh, int J,
    const float* __restrict__ er, int R,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    int E, int N,
    const float* __restrict__ w_hidden, int H, int n_hidden,
    const float* __restrict__ w_out, int PC, float act_cst,
    const int* __restrict__ paths, int P,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    float* __restrict__ scratch, int KM) {
  __shared__ float s_h[2][kEdgesPerBlock][kMaxHidden];
  __shared__ float s_er[kEdgesPerBlock][kMaxRadial];
  __shared__ float s_sh[kEdgesPerBlock][kMaxSh];

  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int eg = threadIdx.y;
  const int tid = eg * mul + u;
  const int nthr = mul * kEdgeGroups;
  const int e0 = blockIdx.x * kEdgesPerBlock;

  for (int i = tid; i < kEdgesPerBlock * R; i += nthr) {
    int el = i / R, r = i % R, e = e0 + el;
    s_er[el][r] = e < E ? er[(size_t)e * R + r] : 0.f;
  }
  for (int i = tid; i < kEdgesPerBlock * J; i += nthr) {
    int el = i / J, j = i % J, e = e0 + el;
    s_sh[el][j] = e < E ? sh[(size_t)e * J + j] : 0.f;
  }
  __syncthreads();

  // hidden layers of the radial MLP: R -> H -> ... -> H, ssp after each
  for (int i = tid; i < kEdgesPerBlock * H; i += nthr) {
    int el = i / H, h = i % H;
    float acc = 0.f;
    for (int r = 0; r < R; ++r) acc += s_er[el][r] * w_hidden[r * H + h];
    s_h[0][el][h] = ssp(acc, act_cst);
  }
  __syncthreads();
  int cur = 0;
  const float* wl = w_hidden + R * H;
  for (int layer = 1; layer < n_hidden; ++layer) {
    for (int i = tid; i < kEdgesPerBlock * H; i += nthr) {
      int el = i / H, h = i % H;
      float acc = 0.f;
      for (int k = 0; k < H; ++k) acc += s_h[cur][el][k] * wl[k * H + h];
      s_h[cur ^ 1][el][h] = ssp(acc, act_cst);
    }
    __syncthreads();
    cur ^= 1;
    wl += H * H;
  }

  // edges past E, or with an endpoint outside [0, N), are skipped (as a
  // segment sum drops out-of-range ids): marked by e_src = -1
  long long e_src[kEdgesPerThread], e_dst[kEdgesPerThread];
#pragma unroll
  for (int q = 0; q < kEdgesPerThread; ++q) {
    int e = e0 + eg + kEdgeGroups * q;
    e_src[q] = e < E ? src[e] : -1;
    e_dst[q] = e < E ? dst[e] : -1;
    if (e_src[q] < 0 || e_src[q] >= N || e_dst[q] < 0 || e_dst[q] >= N)
      e_src[q] = -1;
  }

  for (int p = 0; p < P; ++p) {
    const int* pi = paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], j0 = pi[2];
    const int row_base = pi[4], row_stride = pi[5], wcol = pi[6];
    const int nz0 = pi[7], nz1 = pi[8];

    // radial weight of this path and channel for the thread's edges
    float w[kEdgesPerThread];
#pragma unroll
    for (int q = 0; q < kEdgesPerThread; ++q) w[q] = 0.f;
    for (int h = 0; h < H; ++h) {
      float wv = __ldg(w_out + (size_t)h * PC + wcol + u);
#pragma unroll
      for (int q = 0; q < kEdgesPerThread; ++q)
        w[q] += s_h[cur][eg + kEdgeGroups * q][h] * wv;
    }

#pragma unroll
    for (int q = 0; q < kEdgesPerThread; ++q) {
      const int el = eg + kEdgeGroups * q;
      if (e_src[q] < 0) continue;
      const float* xs = x + (size_t)e_src[q] * in_dim + x_off + u * d1;
      float* orow = scratch + (size_t)e_dst[q] * KM + u;
      int m3_cur = -1;
      float acc = 0.f;
      for (int z = nz0; z < nz1; ++z) {
        const int code = nz_idx[z];
        const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
        if (m3 != m3_cur) {
          if (m3_cur >= 0)
            atomicAdd(orow + (size_t)(row_base + m3_cur * row_stride) * mul,
                      w[q] * acc);
          m3_cur = m3;
          acc = 0.f;
        }
        acc += nz_c[z] * __ldg(xs + m1) * s_sh[el][j0 + m2];
      }
      if (m3_cur >= 0)
        atomicAdd(orow + (size_t)(row_base + m3_cur * row_stride) * mul,
                  w[q] * acc);
    }
  }
}

// out[n, c_off + w * c_stride] =
//     sum_k scratch[n, a_col + k] * wsel[b_off + k * wo + w]
__global__ void full_conv_mix_kernel(
    const float* __restrict__ scratch, int N, int KM,
    const float* __restrict__ wsel, const int* __restrict__ probs,
    float* __restrict__ out, int out_dim) {
  const int* pr = probs + blockIdx.y * kProbFields;
  const int a_col = pr[0], kdim = pr[1], b_off = pr[2], wo = pr[3];
  const int c_off = pr[4], c_stride = pr[5];
  const int n0 = blockIdx.x * kTile, w0 = blockIdx.z * kTile;
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
      int r = i / kTileK, c = i % kTileK, n = n0 + r, k = k0 + c;
      As[c][r] = (n < N && k < kdim) ? scratch[(size_t)n * KM + a_col + k]
                                     : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      int r = i / kTile, c = i % kTile, k = k0 + r, wc = w0 + c;
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
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int wc = w0 + tx * 4 + j;
      if (wc < wo) out[(size_t)n * out_dim + c_off + wc * c_stride] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int full_conv_fwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* er, int R,
    const long long* src, const long long* dst, int E,
    const float* w_hidden, int H, int n_hidden,
    const float* w_out, int PC, float act_cst,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs, int n_probs, int max_wo,
    float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)N * (size_t)KM * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(out, 0, (size_t)N * (size_t)out_dim * sizeof(float),
                        s);
  if (err != cudaSuccess) return (int)err;
  if (E > 0 && P > 0) {
    dim3 block(mul, kEdgeGroups);
    dim3 grid((E + kEdgesPerBlock - 1) / kEdgesPerBlock);
    full_conv_edge_kernel<<<grid, block, 0, s>>>(
        x, in_dim, sh, J, er, R, src, dst, E, N, w_hidden, H, n_hidden,
        w_out, PC, act_cst, paths, P, nz_idx, nz_c, scratch, KM);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0 && n_probs > 0) {
    dim3 grid((N + kTile - 1) / kTile, n_probs, (max_wo + kTile - 1) / kTile);
    full_conv_mix_kernel<<<grid, 256, 0, s>>>(scratch, N, KM, wsel, probs,
                                              out, out_dim);
  }
  return (int)cudaGetLastError();
}
