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
// a. node stage (k2_gemm_kernel, one batch of descriptors per mix problem):
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
// c. MLP stage (k2_gemm_kernel and k2_act_grad_kernel): dW_out = h_L^T dw
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

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kEdgeGroups = 4;     // blockDim.y of the edge kernel
constexpr int kEdgesPerThread = 4;
constexpr int kEdgesPerBlock = kEdgeGroups * kEdgesPerThread;
constexpr int kMaxHidden = 64;
constexpr int kMaxRadial = 16;
constexpr int kMaxSh = 16;
constexpr int kMaxD = 7;           // components of an l <= 3 irrep
constexpr int kPathFields = 9;
constexpr int kProbFields = 6;
constexpr int kTile = 64;
constexpr int kTileK = 16;
constexpr int kMaxBatch = 24;      // GEMM descriptors per launch
constexpr int kSplitRows = 256;    // reduction rows per split-K block

__device__ __forceinline__ float ssp(float v, float cst) {
  // (softplus(v) - log 2) * cst, softplus as max(v, 0) + log1p(exp(-|v|))
  float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return (sp - 0.69314718055994530942f) * cst;
}

// C(m, n) += sum_k A(m, k) B(k, n), element (i, j) of X at X + i*s0 + j*s1
struct GemmDesc {
  const float* A;
  const float* B;
  float* C;
  int M, N, K, k_chunk;
  int sam, sak, sbk, sbn, scm, scn;
};

struct GemmBatch {
  int count;
  GemmDesc d[kMaxBatch];
};

// grid: (M tiles * N tiles, descriptor, K chunks); 256 threads, 4x4 each
__global__ void k2_gemm_kernel(const GemmBatch batch) {
  const GemmDesc& g = batch.d[blockIdx.y];
  const int tiles_n = (g.N + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / tiles_n) * kTile;
  const int n0 = (blockIdx.x % tiles_n) * kTile;
  const int k_begin = blockIdx.z * g.k_chunk;
  if (m0 >= g.M || k_begin >= g.K) return;
  const int k_end = min(g.K, k_begin + g.k_chunk);

  __shared__ float As[kTileK][kTile + 1];
  __shared__ float Bs[kTileK][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      // neighbouring threads walk the operand's unit-stride axis
      int r, c;
      if (g.sak == 1) { r = i / kTileK; c = i % kTileK; }
      else { c = i / kTile; r = i % kTile; }
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < g.M && k < k_end)
                     ? g.A[(size_t)m * g.sam + (size_t)k * g.sak] : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * kTileK; i += blockDim.x) {
      int r, c;
      if (g.sbn == 1) { r = i / kTile; c = i % kTile; }
      else { c = i / kTileK; r = i % kTileK; }
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < k_end && n < g.N)
                     ? g.B[(size_t)k * g.sbk + (size_t)n * g.sbn] : 0.f;
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
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N)
        atomicAdd(g.C + (size_t)m * g.scm + (size_t)n * g.scn, acc[i][j]);
    }
  }
}

// dz = dh * ssp'(z), ssp'(v) = sigmoid(v) * act_cst
__global__ void k2_act_grad_kernel(const float* __restrict__ dh,
                                   const float* __restrict__ z, size_t count,
                                   float act_cst, float* __restrict__ dz) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    dz[i] = dh[i] * act_cst / (1.f + expf(-z[i]));
}

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
      float dxl[kMaxD];
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) dxl[i] = 0.f;
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
        for (int i = 0; i < kMaxD; ++i)
          if (i == m1) dxl[i] += v;
      }
      dwv += gv * mid;
      dw[(size_t)(e0 + el) * PC + wcol + u] = dwv;
      float* dxs = dx + (size_t)e_src[q] * in_dim + x_off + u * d1;
#pragma unroll
      for (int i = 0; i < kMaxD; ++i)
        if (i < d1) atomicAdd(dxs + i, w[q] * dxl[i]);
    }
  }
}

// Launch the descriptors in batches of kMaxBatch.
cudaError_t run_gemms(const GemmDesc* descs, int count, cudaStream_t s) {
  for (int b0 = 0; b0 < count; b0 += kMaxBatch) {
    GemmBatch batch;
    batch.count = std::min(kMaxBatch, count - b0);
    int tiles = 0, splits = 0;
    for (int i = 0; i < batch.count; ++i) {
      GemmDesc g = descs[b0 + i];
      if (g.k_chunk <= 0) g.k_chunk = g.K > 0 ? g.K : 1;
      batch.d[i] = g;
      tiles = std::max(tiles, ((g.M + kTile - 1) / kTile) *
                                  ((g.N + kTile - 1) / kTile));
      splits = std::max(splits, (g.K + g.k_chunk - 1) / g.k_chunk);
    }
    if (tiles == 0 || splits == 0) continue;
    dim3 grid(tiles, batch.count, splits);
    k2_gemm_kernel<<<grid, 256, 0, s>>>(batch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

GemmDesc desc(const float* A, int sam, int sak, const float* B, int sbk,
              int sbn, float* C, int scm, int scn, int M, int N, int K,
              bool split) {
  GemmDesc g;
  g.A = A; g.B = B; g.C = C;
  g.M = M; g.N = N; g.K = K;
  g.k_chunk = split ? kSplitRows : K;
  g.sam = sam; g.sak = sak; g.sbk = sbk; g.sbn = sbn; g.scm = scm; g.scn = scn;
  return g;
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
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    const float* scratch, int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* dS, float* dw, float* z_all, float* h_all, float* dh, float* dz,
    float* dx, float* der, float* dw_hidden, int w_hidden_len,
    float* dw_out, float* dwsel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (N > 0 && n_probs > 0) {
    GemmDesc descs[2 * kMaxBatch];
    int count = 0;
    for (int q = 0; q < n_probs; ++q) {
      const int* pr = probs_host + q * kProbFields;
      const int a_col = pr[0], kdim = pr[1], b_off = pr[2], wo = pr[3];
      const int c_off = pr[4], c_stride = pr[5];
      // dS[n, a_col + k] += sum_w gout[n, c_off + w*c_stride] wsel[k*wo + w]
      descs[count++] = desc(gout + c_off, out_dim, c_stride, wsel + b_off, 1,
                            wo, dS + a_col, KM, 1, N, kdim, wo, false);
      // dwsel[k*wo + w] += sum_n S[n, a_col + k] gout[n, c_off + w*c_stride]
      descs[count++] = desc(scratch + a_col, 1, KM, gout + c_off, out_dim,
                            c_stride, dwsel + b_off, wo, 1, kdim, wo, N, true);
      if (count == 2 * kMaxBatch || q == n_probs - 1) {
        cudaError_t err = run_gemms(descs, count, s);
        if (err != cudaSuccess) return (int)err;
        count = 0;
      }
    }
  }

  // b. edge stage
  if (E > 0 && P > 0) {
    dim3 block(mul, kEdgeGroups);
    dim3 grid((E + kEdgesPerBlock - 1) / kEdgesPerBlock);
    k2_edge_kernel<<<grid, block, 0, s>>>(
        x, in_dim, sh, J, er, R, src, dst, E, N, w_hidden, H, n_hidden,
        w_out, PC, act_cst, paths, P, nz_idx, nz_c, dS, KM, z_all, h_all, dw,
        dx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (E == 0) return (int)cudaGetLastError();

  // c. MLP stage: last layer, then the hidden layers from the last
  const size_t EH = (size_t)E * H;
  const float* h_last = h_all + (size_t)(n_hidden - 1) * EH;
  GemmDesc last[2] = {
      // dW_out[h, c] = sum_e h_last[e, h] dw[e, c]
      desc(h_last, 1, H, dw, PC, 1, dw_out, PC, 1, H, PC, E, true),
      // dh[e, h] = sum_c dw[e, c] W_out[h, c]
      desc(dw, PC, 1, w_out, 1, PC, dh, H, 1, E, H, PC, false)};
  cudaError_t err = run_gemms(last, 2, s);
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
        desc(a_in, 1, fan, dz, H, 1, dw_hidden + w_ofs, H, 1, fan, H, E,
             true),
        // d a_in[e, k] = sum_h dz[e, h] W_i[k, h]
        desc(dz, H, 1, w_hidden + w_ofs, 1, H, d_in, fan, 1, E, fan, H,
             false)};
    err = run_gemms(layer, 2, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
