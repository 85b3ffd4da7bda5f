// External-weight convolution core of the force path (K4f), its VJP (K4b)
// and its one-pass second-order backward (K4g).
//
// Replace the TPU kernels PallasFullConv._full_fwd_kernel_ext,
// _full_bwd_kernel_ext and _grad2_fused_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py (bodies at :1348, :1432
// and :1618; launched at :1937, :1989 and :2060).  On the force path the
// radial MLP runs outside the kernels, so they see the 4-linear core
//
//   S[dst_e, row(p, m3), u] += w[e, wcol(p) + u] * sum_nz C * x[src_e, m1, u]
//                                                          * sh[e, m2]
//   out[n, cols(q)] = S[n, a_col(q) : +kdim] @ wsel_q       per mix problem q
//
// with K1's row and table conventions (paths sorted by output irrep, scratch
// rows component-major inside each output-irrep group, host-built
// wigner_3j non-zeros sorted by m3).  Three C entries, each a short
// sequence of kernels on the caller's stream:
//
// K4f  full_conv_ext_fwd(x, sh, w, wsel) -> out: the edge kernel scatters
//      mid * w into the f32 scratch S with atomics; the forward mix gives
//      out.
// K4b  full_conv_ext_bwd(x, sh, w, wsel, gout) -> dx, dsh, dw, dwsel:
//      node stage dS = mix^T(gout); edge stage gathers dS[dst], recomputes
//      mid, writes dw = sum_m3 dS * mid, adds w * C^T(dS) contracted with sh
//      into dx[src] (atomics), and reduces C^T(dS) * w contracted with
//      x[src] into dsh (warp shuffles, then shared memory, then one store
//      per edge); it also scatters S of THESE operands (in the pairing rule
//      they are substituted cotangents, so no saved forward scratch would
//      do), and dwsel = S^T gout follows.
// K4g  full_conv_ext_grad2(x, cx, sh, csh, w, cw, wsel, gout) ->
//      c_x, c_s, c_w, c_m, c_g in one edge sweep (fused_conv.py:1636-1640):
//      with mid_a = mid(cx, sh), mid_b = mid(x, csh), mid_c = mid(x, sh),
//      S_sum = scatter((mid_a + mid_b) w + mid_c cw), c_g = mix(S_sum),
//      c_m = S_sum^T gout, c_w = sum_m3 dS (mid_a + mid_b), and with
//      douter_w = C^T(dS w), douter_c = C^T(dS cw):
//      c_x[src] += sum_j csh_j douter_w + sh_j douter_c,
//      c_s = sum (douter_w cx[src] + douter_c x[src]).
//
// Every edge is treated alike: no early exit on a zero weight and no
// skipped padded edge, because the second-order rule substitutes unmasked
// cotangents into the w and sh slots and the three kernels must stay exact
// adjoints of one multilinear map (the TPU kernels' forced trailing-pad
// flush, :1401-1408).  Edges with an endpoint outside [0, N) are dropped,
// as by K1 (a segment sum drops out-of-range ids).
//
// What bounds them on the card: the edge kernel's f32 atomics (E * K * mul
// into S, E * mul * sum_p d1(p) into dx) and its per-edge CG loops on CUDA
// cores; w and its cotangent ([E, P * mul] f32, ~110 MB each at the hot
// layer of a 64-graph protein batch) are read and written once per call.
// The design keeps mid and the CG outer products in registers, gathers
// dS[dst] instead of scattering, and reduces dsh per edge in the block, so
// the only global atomics are the scatter into S and the dx adds (so S, dx
// and what is computed from S vary in their last bits from run to run).
// The mix and the node-stage products are row_mix.cuh's tensor-core GEMM
// (3xTF32, shared with every conv and pairwise kernel): the forward mix
// (out, c_g) and dS with one owner per output tile and plain stores, dwsel
// split over node chunks and added in split order; none of these outputs
// is zero-filled first, and their summation order is fixed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace {

using rowmix::kMixRows;
using rowmix::kMixWeights;
using rowmix::mix_products;
using rowmix::mix_rows;

constexpr int kEdgeGroups = 4;     // blockDim.y of the edge kernel
constexpr int kEdgesPerThread = 4;
constexpr int kEdgesPerBlock = kEdgeGroups * kEdgesPerThread;
constexpr int kMaxSh = 16;
constexpr int kMaxD = 7;           // components of an l <= 3 irrep
constexpr int kPathFields = 9;

enum Mode { kFwd = 0, kBwd = 1, kGrad2 = 2 };

struct EdgeArgs {
  const float* x;     // [N, in_dim]
  const float* cx;    // [N, in_dim], K4g only
  const float* sh;    // [E, J]
  const float* csh;   // [E, J], K4g only
  const float* w;     // [E, PC]
  const float* cw;    // [E, PC], K4g only
  const float* dS;    // [N, KM], K4b and K4g
  const long long* src;
  const long long* dst;
  const int* paths;
  const int* nz_idx;
  const float* nz_c;
  float* S;           // [N, KM], zeroed: the scatter of mid * w
  float* dx;          // [N, in_dim], zeroed
  float* dsh;         // [E, J], written for every edge
  float* dw;          // [E, PC], zeroed
  int in_dim, J, PC, E, N, P, KM;
};

// One edge sweep.  A block takes 16 edges; thread (u, edge group) handles
// channel u of 4 edges, path by path.
template <int MODE>
__global__ void ext_edge_kernel(const EdgeArgs a) {
  __shared__ float s_sh[kEdgesPerBlock][kMaxSh];
  __shared__ float s_csh[kEdgesPerBlock][kMaxSh];
  __shared__ float s_dsh[kEdgesPerBlock][kMaxSh];

  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int eg = threadIdx.y;
  const int tid = eg * mul + u;
  const int nthr = mul * kEdgeGroups;
  const int e0 = blockIdx.x * kEdgesPerBlock;

  for (int i = tid; i < kEdgesPerBlock * a.J; i += nthr) {
    const int el = i / a.J, j = i % a.J, e = e0 + el;
    s_sh[el][j] = e < a.E ? a.sh[(size_t)e * a.J + j] : 0.f;
    if (MODE == kGrad2)
      s_csh[el][j] = e < a.E ? a.csh[(size_t)e * a.J + j] : 0.f;
    s_dsh[el][j] = 0.f;
  }
  __syncthreads();

  // the lanes of one edge group inside a warp (mul is a power of two below
  // 32 or a multiple of 32): the dsh partial sums are reduced over them
  const int lanes = mul < 32 ? mul : 32;
  const int lane = tid & 31;
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu
                  : (((1u << lanes) - 1u) << (lane & ~(lanes - 1)));

  // edges past E, or with an endpoint outside [0, N), are skipped: e_src -1
  long long e_src[kEdgesPerThread], e_dst[kEdgesPerThread];
#pragma unroll
  for (int q = 0; q < kEdgesPerThread; ++q) {
    const int e = e0 + eg + kEdgeGroups * q;
    e_src[q] = e < a.E ? a.src[e] : -1;
    e_dst[q] = e < a.E ? a.dst[e] : -1;
    if (e_src[q] < 0 || e_src[q] >= a.N || e_dst[q] < 0 || e_dst[q] >= a.N)
      e_src[q] = -1;
  }

  for (int p = 0; p < a.P; ++p) {
    const int* pi = a.paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], j0 = pi[2], d2 = pi[3];
    const int row_base = pi[4], row_stride = pi[5], wcol = pi[6];
    const int nz0 = pi[7], nz1 = pi[8];

#pragma unroll
    for (int q = 0; q < kEdgesPerThread; ++q) {
      const int el = eg + kEdgeGroups * q;
      float dshl[kMaxD];
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) dshl[i] = 0.f;

      if (e_src[q] >= 0) {
        const size_t e = (size_t)(e0 + el);
        const float wv = a.w[e * a.PC + wcol + u];
        const float cwv = MODE == kGrad2 ? a.cw[e * a.PC + wcol + u] : 0.f;
        const size_t x_at = (size_t)e_src[q] * a.in_dim + x_off + u * d1;
        const float* xs = a.x + x_at;
        const float* cxs = MODE == kGrad2 ? a.cx + x_at : a.x + x_at;
        float* srow = a.S + (size_t)e_dst[q] * a.KM + u;
        const float* grow =
            MODE == kFwd ? nullptr : a.dS + (size_t)e_dst[q] * a.KM + u;
        float dxl[kMaxD];
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) dxl[i] = 0.f;
        float dwv = 0.f, g = 0.f;
        float mid_a = 0.f, mid_b = 0.f, mid_c = 0.f;
        int m3_cur = -1;

        // close component m3 of the path: scatter into S, add to dw
        auto flush = [&](int m3) {
          float* at = srow + (size_t)(row_base + m3 * row_stride) * mul;
          if (MODE == kGrad2) {
            atomicAdd(at, (mid_a + mid_b) * wv + mid_c * cwv);
            dwv += g * (mid_a + mid_b);
          } else {
            atomicAdd(at, wv * mid_c);
            dwv += g * mid_c;
          }
        };

        for (int z = nz0; z < nz1; ++z) {
          const int code = a.nz_idx[z];
          const int m1 = code & 0xff, m2 = (code >> 8) & 0xff;
          const int m3 = code >> 16;
          if (m3 != m3_cur) {
            if (m3_cur >= 0) flush(m3_cur);
            m3_cur = m3;
            mid_a = mid_b = mid_c = 0.f;
            if (MODE != kFwd)
              g = __ldg(grow + (size_t)(row_base + m3 * row_stride) * mul);
          }
          const float c = a.nz_c[z];
          const float xv = __ldg(xs + m1);
          const float sv = s_sh[el][j0 + m2];
          mid_c += c * xv * sv;
          if (MODE == kBwd) {
            const float v = c * g * wv;        // douter(m1, m2)
#pragma unroll
            for (int i = 0; i < kMaxD; ++i) {
              if (i == m1) dxl[i] += v * sv;
              if (i == m2) dshl[i] += v * xv;
            }
          } else if (MODE == kGrad2) {
            const float cxv = __ldg(cxs + m1);
            const float csv = s_csh[el][j0 + m2];
            mid_a += c * cxv * sv;
            mid_b += c * xv * csv;
            const float vw = c * g * wv;       // douter_w(m1, m2)
            const float vc = c * g * cwv;      // douter_c(m1, m2)
#pragma unroll
            for (int i = 0; i < kMaxD; ++i) {
              if (i == m1) dxl[i] += csv * vw + sv * vc;
              if (i == m2) dshl[i] += vw * cxv + vc * xv;
            }
          }
        }
        if (m3_cur >= 0) flush(m3_cur);

        if (MODE != kFwd) {
          a.dw[e * a.PC + wcol + u] = dwv;
          float* dxs = a.dx + x_at;
#pragma unroll
          for (int i = 0; i < kMaxD; ++i)
            if (i < d1) atomicAdd(dxs + i, dxl[i]);
        }
      }

      if (MODE != kFwd) {
        // dsh[e, j0 + m2]: reduce over the group's channels, then over the
        // edge groups of other warps and over paths in shared memory
#pragma unroll
        for (int i = 0; i < kMaxD; ++i) {
          if (i >= d2) continue;
          float v = dshl[i];
          for (int off = lanes / 2; off > 0; off >>= 1)
            v += __shfl_xor_sync(gmask, v, off);
          if ((lane & (lanes - 1)) == 0 && e_src[q] >= 0)
            atomicAdd(&s_dsh[el][j0 + i], v);
        }
      }
    }
  }

  if (MODE != kFwd) {
    __syncthreads();
    for (int i = tid; i < kEdgesPerBlock * a.J; i += nthr) {
      const int el = i / a.J, j = i % a.J, e = e0 + el;
      if (e < a.E) a.dsh[(size_t)e * a.J + j] = s_dsh[el][j];
    }
  }
}

template <int MODE>
cudaError_t edge_sweep(const EdgeArgs& a, int mul, cudaStream_t s) {
  if (a.E <= 0 || a.P <= 0 || a.N <= 0) return cudaSuccess;
  dim3 block(mul, kEdgeGroups);
  dim3 grid((a.E + kEdgesPerBlock - 1) / kEdgesPerBlock);
  ext_edge_kernel<MODE><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t zero(cudaStream_t s, float* p, size_t n) {
  return cudaMemsetAsync(p, 0, n * sizeof(float), s);
}

EdgeArgs edge_args(int N, int in_dim, int J, const long long* src,
                   const long long* dst, int E, int PC, const int* paths,
                   int P, const int* nz_idx, const float* nz_c, int KM) {
  EdgeArgs a = {};
  a.src = src; a.dst = dst; a.paths = paths; a.nz_idx = nz_idx;
  a.nz_c = nz_c;
  a.in_dim = in_dim; a.J = J; a.PC = PC; a.E = E; a.N = N; a.P = P;
  a.KM = KM;
  return a;
}

#define EXT_TRY(expr)                        \
  do {                                       \
    cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// Arguments common to the three entries: sizes, the edge list, the path
// and CG tables (device), the mix problem table (host).
#define EXT_COMMON                                                        \
  int N, int in_dim, int J, const long long *src, const long long *dst,   \
      int E, int PC, const int *paths, int P, const int *nz_idx,          \
      const float *nz_c, int KM, int mul, const int *probs_host,          \
      int n_probs, int out_dim

extern "C" int full_conv_ext_fwd(EXT_COMMON, const float* x, const float* sh,
                                 const float* w, const float* wsel,
                                 float* scratch, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EXT_TRY(zero(s, scratch, (size_t)N * KM));
  EdgeArgs a = edge_args(N, in_dim, J, src, dst, E, PC, paths, P, nz_idx,
                         nz_c, KM);
  a.x = x; a.sh = sh; a.w = w; a.S = scratch;
  EXT_TRY(edge_sweep<kFwd>(a, mul, s));
  EXT_TRY(mix_rows(scratch, N, KM, wsel, probs_host, n_probs, out, out_dim,
                   s));
  return (int)cudaGetLastError();
}

extern "C" int full_conv_ext_bwd(EXT_COMMON, const float* x, const float* sh,
                                 const float* w, const float* wsel,
                                 const float* gout, float* scratch, float* dS,
                                 float* dx, float* dsh, float* dw,
                                 float* dwsel, int wsel_len, float* ws,
                                 int ws_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EXT_TRY(zero(s, scratch, (size_t)N * KM));
  EXT_TRY(zero(s, dx, (size_t)N * in_dim));
  EXT_TRY(zero(s, dsh, (size_t)E * J));
  EXT_TRY(zero(s, dw, (size_t)E * PC));
  EXT_TRY(mix_products(kMixRows, probs_host, n_probs, N, KM, out_dim, nullptr,
                       wsel, gout, dS, wsel_len, ws, ws_len, s));
  EdgeArgs a = edge_args(N, in_dim, J, src, dst, E, PC, paths, P, nz_idx,
                         nz_c, KM);
  a.x = x; a.sh = sh; a.w = w; a.dS = dS; a.S = scratch;
  a.dx = dx; a.dsh = dsh; a.dw = dw;
  EXT_TRY(edge_sweep<kBwd>(a, mul, s));
  EXT_TRY(mix_products(kMixWeights, probs_host, n_probs, N, KM, out_dim,
                       scratch, nullptr, gout, dwsel, wsel_len, ws, ws_len,
                       s));
  return (int)cudaGetLastError();
}

extern "C" int full_conv_ext_grad2(
    EXT_COMMON, const float* x, const float* cx, const float* sh,
    const float* csh, const float* w, const float* cw, const float* wsel,
    const float* gout, float* scratch, float* dS, float* c_x, float* c_s,
    float* c_w, float* c_m, float* c_g, int wsel_len, float* ws, int ws_len,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EXT_TRY(zero(s, scratch, (size_t)N * KM));
  EXT_TRY(zero(s, c_x, (size_t)N * in_dim));
  EXT_TRY(zero(s, c_s, (size_t)E * J));
  EXT_TRY(zero(s, c_w, (size_t)E * PC));
  EXT_TRY(mix_products(kMixRows, probs_host, n_probs, N, KM, out_dim, nullptr,
                       wsel, gout, dS, wsel_len, ws, ws_len, s));
  EdgeArgs a = edge_args(N, in_dim, J, src, dst, E, PC, paths, P, nz_idx,
                         nz_c, KM);
  a.x = x; a.cx = cx; a.sh = sh; a.csh = csh; a.w = w; a.cw = cw;
  a.dS = dS; a.S = scratch; a.dx = c_x; a.dsh = c_s; a.dw = c_w;
  EXT_TRY(edge_sweep<kGrad2>(a, mul, s));
  EXT_TRY(mix_rows(scratch, N, KM, wsel, probs_host, n_probs, c_g, out_dim,
                   s));
  EXT_TRY(mix_products(kMixWeights, probs_host, n_probs, N, KM, out_dim,
                       scratch, nullptr, gout, c_m, wsel_len, ws, ws_len, s));
  return (int)cudaGetLastError();
}
