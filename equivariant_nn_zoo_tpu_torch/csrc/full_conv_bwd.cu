// Whole-convolution backward for one NequIP message-passing layer (K2): the
// VJP of the forward in full_conv.cu (K1).
//
// Replaces the TPU kernel PallasFullConv._full_bwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py (the body at :1051,
// launched at :2396; its contract is f_bwd, :2421-2433) with the
// spherical-harmonics cotangent off (compute_dsh=False, the first-order
// energy path).  The forward is
//
//   h_0 = er,  z_i = h_i W_i,  h_{i+1} = ssp(z_i)        (hidden layers)
//   w = h_L W_out                                       [E, P * mul]
//   S[dst_e, row(p, m3), u] += w[e, p, u] * sum_nz C * x[src_e, m1, u] *
//                                                       sh[e, m2]
//   out[n, cols(q)] = S[n, a_col(q) : +kdim] @ wsel_q     per mix problem q
//
// and, given gout = dL/dout and the forward's f32 scratch S (saved, the
// card's counterpart of the TPU kernel's save_mid; per node, not per edge),
// this entry computes dx, d er, dW_hidden, dW_out and dwsel in three stages
// of hand-written kernels on the caller's stream:
//
// a. node stage (rowmix::mix_products in row_mix.cuh, the mix backward
//    shared with the per-edge conv and the pairwise expansion):
//    dS = gout_q @ wsel_q^T, added over the problems that read the same
//    scratch columns, and dwsel_q = S^T @ gout_q, split over node chunks.
// b. edge stage (k2_edge_kernel): a block takes 16 edges, recomputes the
//    MLP's hidden layers in shared memory as the forward does and stores
//    the pre-activations z and activations h; then per CG path, thread
//    (u, edge group) recomputes w[p, u], gathers dS[dst] (no atomics),
//    recomputes mid[m3] over the path's wigner_3j non-zeros, writes
//    dw[e, p, u] = sum_m3 dS * mid in w_out's column order, and adds
//    w * sum_m3 dS * C * sh into dx[src] with atomics (the mirror of the
//    forward's scatter).
// c. MLP stage (rowmix::tile_gemm_kernel and k2_act_grad_kernel): dW_out =
//    h_L^T dw
//    (split over edge chunks), dh = dw W_out^T, then per hidden layer from
//    the last: dz = dh * ssp'(z) (ssp' = sigmoid * act_cst), dW_i = h_i^T dz,
//    dh_i = dz W_i^T, the last of which is d er.
//
// What bounds it on the card: the edge stage's dx atomics (E * mul * sum_p
// d1(p), ~300 M per hot layer) and its f32 FMAs, as in the forward; then
// the f32 products of the MLP stage (2 * E * 64 * 3072 FMAs for dW_out and
// dh) and the per-edge cotangent dw, [E, P * mul] in f32 (~300 MB at
// E = 24386, written once and read twice).  The products are a plain
// 64x64-tiled shared-memory kernel on CUDA cores; every output is summed
// with atomics into a zeroed buffer, so split reductions need no second
// pass and the order of summation varies from run to run.  Padded edges
// need no special case (zero edge_radial, bias-free MLP); edges with an
// endpoint outside [0, N), skipped by the forward, get zero dw.
//
// The edge kernel keeps one register row per component of the left irrep
// (the dx partial sums of a path) and is compiled for 7 rows (l <= 3) and
// for 9 (l = 4, the hamiltonian trunk); the host picks by the layer's
// widest left irrep, so a layer of l <= 3 runs the code it always had.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "row_mix.cuh"

namespace {

using rowmix::gemm_desc;
using rowmix::GemmDesc;
using rowmix::run_gemms;

constexpr int kEdgeGroups = 4;     // blockDim.y of the edge kernel
constexpr int kEdgesPerThread = 4;
constexpr int kEdgesPerBlock = kEdgeGroups * kEdgesPerThread;
constexpr int kMaxHidden = 64;
constexpr int kMaxRadial = 16;
constexpr int kMaxSh = 16;
constexpr int kPathFields = 9;

__device__ __forceinline__ float ssp(float v, float cst) {
  // (softplus(v) - log 2) * cst, softplus as max(v, 0) + log1p(exp(-|v|))
  float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return (sp - 0.69314718055994530942f) * cst;
}

// dz = dh * ssp'(z), ssp'(v) = sigmoid(v) * act_cst
__global__ void k2_act_grad_kernel(const float* __restrict__ dh,
                                   const float* __restrict__ z, size_t count,
                                   float act_cst, float* __restrict__ dz) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    dz[i] = dh[i] * act_cst / (1.f + expf(-z[i]));
}

// kD: register rows, the components of the widest left irrep
template <int kD>
__global__ void k2_edge_kernel(
    const float* __restrict__ x, int in_dim,
    const float* __restrict__ sh, int J,
    const float* __restrict__ er, int R,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    int E, int N,
    const float* __restrict__ w_hidden, int H, int n_hidden,
    const float* __restrict__ w_out, int PC, float act_cst,
    const int* __restrict__ paths, int P,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    const float* __restrict__ dS, int KM,
    float* __restrict__ z_all, float* __restrict__ h_all,
    float* __restrict__ dw, float* __restrict__ dx) {
  __shared__ float s_h[2][kEdgesPerBlock][kMaxHidden];
  __shared__ float s_er[kEdgesPerBlock][kMaxRadial];
  __shared__ float s_sh[kEdgesPerBlock][kMaxSh];

  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int eg = threadIdx.y;
  const int tid = eg * mul + u;
  const int nthr = mul * kEdgeGroups;
  const int e0 = blockIdx.x * kEdgesPerBlock;
  const size_t EH = (size_t)E * H;

  for (int i = tid; i < kEdgesPerBlock * R; i += nthr) {
    int el = i / R, r = i % R, e = e0 + el;
    s_er[el][r] = e < E ? er[(size_t)e * R + r] : 0.f;
  }
  for (int i = tid; i < kEdgesPerBlock * J; i += nthr) {
    int el = i / J, j = i % J, e = e0 + el;
    s_sh[el][j] = e < E ? sh[(size_t)e * J + j] : 0.f;
  }
  __syncthreads();

  // hidden layers, as the forward computes them; z and h kept for stage c
  int cur = 0;
  const float* wl = w_hidden;
  for (int layer = 0; layer < n_hidden; ++layer) {
    const int fan = layer == 0 ? R : H;
    for (int i = tid; i < kEdgesPerBlock * H; i += nthr) {
      int el = i / H, hh = i % H, e = e0 + el;
      float acc = 0.f;
      if (layer == 0)
        for (int k = 0; k < fan; ++k) acc += s_er[el][k] * wl[k * H + hh];
      else
        for (int k = 0; k < fan; ++k) acc += s_h[cur][el][k] * wl[k * H + hh];
      const float hv = ssp(acc, act_cst);
      s_h[layer == 0 ? 0 : cur ^ 1][el][hh] = hv;
      if (e < E) {
        z_all[layer * EH + (size_t)e * H + hh] = acc;
        h_all[layer * EH + (size_t)e * H + hh] = hv;
      }
    }
    __syncthreads();
    if (layer > 0) cur ^= 1;
    wl += fan * H;
  }

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

    float w[kEdgesPerThread];
#pragma unroll
    for (int q = 0; q < kEdgesPerThread; ++q) w[q] = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      float wv = __ldg(w_out + (size_t)hh * PC + wcol + u);
#pragma unroll
      for (int q = 0; q < kEdgesPerThread; ++q)
        w[q] += s_h[cur][eg + kEdgeGroups * q][hh] * wv;
    }

#pragma unroll
    for (int q = 0; q < kEdgesPerThread; ++q) {
      const int el = eg + kEdgeGroups * q;
      if (e_src[q] < 0) continue;
      const float* xs = x + (size_t)e_src[q] * in_dim + x_off + u * d1;
      const float* grow = dS + (size_t)e_dst[q] * KM + u;
      float dxl[kD];
#pragma unroll
      for (int i = 0; i < kD; ++i) dxl[i] = 0.f;
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
        const float cs = nz_c[z] * s_sh[el][j0 + m2];
        mid += cs * __ldg(xs + m1);
        const float v = cs * gv;
#pragma unroll
        for (int i = 0; i < kD; ++i)
          if (i == m1) dxl[i] += v;
      }
      dwv += gv * mid;
      dw[(size_t)(e0 + el) * PC + wcol + u] = dwv;
      float* dxs = dx + (size_t)e_src[q] * in_dim + x_off + u * d1;
#pragma unroll
      for (int i = 0; i < kD; ++i)
        if (i < d1) atomicAdd(dxs + i, w[q] * dxl[i]);
    }
  }
}

}  // namespace

// probs_host: the mix problem table of the forward, on the host.
// work buffers (f32, uninitialised): dS [N, KM], dw [E, PC],
// z_all and h_all [n_hidden, E, H], dh and dz [E, H].
extern "C" int full_conv_bwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* er, int R,
    const long long* src, const long long* dst, int E,
    const float* w_hidden, int H, int n_hidden,
    const float* w_out, int PC, float act_cst,
    const int* paths, int P, int max_d1, const int* nz_idx, const float* nz_c,
    const float* scratch, int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* dS, float* dw, float* z_all, float* h_all, float* dh, float* dz,
    float* dx, float* der, float* dw_hidden, int w_hidden_len,
    float* dw_out, float* dwsel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_d1 > 9) return (int)cudaErrorInvalidValue;
  const size_t f = sizeof(float);
  struct { void* p; size_t n; } zero[] = {
      {dS, (size_t)N * KM}, {dw, (size_t)E * PC}, {dh, (size_t)E * H},
      {dx, (size_t)N * in_dim}, {der, (size_t)E * R},
      {dw_hidden, (size_t)w_hidden_len}, {dw_out, (size_t)H * PC},
      {dwsel, (size_t)wsel_len}};
  for (auto& b : zero) {
    cudaError_t err = cudaMemsetAsync(b.p, 0, b.n * f, s);
    if (err != cudaSuccess) return (int)err;
  }

  // a. node stage: dS and dwsel per mix problem
  cudaError_t err = rowmix::mix_products(rowmix::kMixRows, probs_host, n_probs,
                                         N, KM, out_dim, nullptr, wsel, gout,
                                         dS, s);
  if (err != cudaSuccess) return (int)err;
  err = rowmix::mix_products(rowmix::kMixWeights, probs_host, n_probs, N, KM,
                             out_dim, scratch, nullptr, gout, dwsel, s);
  if (err != cudaSuccess) return (int)err;

  // b. edge stage
  if (E > 0 && P > 0) {
    dim3 block(mul, kEdgeGroups);
    dim3 grid((E + kEdgesPerBlock - 1) / kEdgesPerBlock);
    auto kernel = k2_edge_kernel<7>;
    if (max_d1 > 7) kernel = k2_edge_kernel<9>;
    kernel<<<grid, block, 0, s>>>(
        x, in_dim, sh, J, er, R, src, dst, E, N, w_hidden, H, n_hidden,
        w_out, PC, act_cst, paths, P, nz_idx, nz_c, dS, KM, z_all, h_all, dw,
        dx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (E == 0) return (int)cudaGetLastError();

  // c. MLP stage: last layer, then the hidden layers from the last
  const size_t EH = (size_t)E * H;
  const float* h_last = h_all + (size_t)(n_hidden - 1) * EH;
  GemmDesc last[2] = {
      // dW_out[h, c] = sum_e h_last[e, h] dw[e, c]
      gemm_desc(h_last, 1, H, dw, PC, 1, dw_out, PC, 1, H, PC, E, true),
      // dh[e, h] = sum_c dw[e, c] W_out[h, c]
      gemm_desc(dw, PC, 1, w_out, 1, PC, dh, H, 1, E, H, PC, false)};
  err = run_gemms(last, 2, s);
  if (err != cudaSuccess) return (int)err;

  size_t w_ofs = (size_t)R * H + (size_t)(n_hidden - 1) * H * H;
  for (int i = n_hidden - 1; i >= 0; --i) {
    const int fan = i == 0 ? R : H;
    w_ofs -= (size_t)fan * H;
    const float* a_in = i == 0 ? er : h_all + (size_t)(i - 1) * EH;
    const unsigned blocks = (unsigned)std::min<size_t>((EH + 255) / 256, 4096);
    k2_act_grad_kernel<<<blocks, 256, 0, s>>>(dh, z_all + (size_t)i * EH, EH,
                                              act_cst, dz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* d_in = der;
    if (i > 0) {
      err = cudaMemsetAsync(dh, 0, EH * f, s);
      if (err != cudaSuccess) return (int)err;
      d_in = dh;
    }
    GemmDesc layer[2] = {
        // dW_i[k, h] = sum_e a_in[e, k] dz[e, h]
        gemm_desc(a_in, 1, fan, dz, H, 1, dw_hidden + w_ofs, H, 1, fan, H, E,
                  true),
        // d a_in[e, k] = sum_h dz[e, h] W_i[k, h]
        gemm_desc(dz, H, 1, w_hidden + w_ofs, 1, H, d_in, fan, 1, E, fan, H,
                  false)};
    err = run_gemms(layer, 2, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
