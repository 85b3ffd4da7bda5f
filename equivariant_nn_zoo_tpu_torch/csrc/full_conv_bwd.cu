// Whole-convolution backward for one NequIP message-passing layer (K2): the
// VJP of the forward in full_conv.cu (K1).
//
// Replaces the TPU kernel PallasFullConv._full_bwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py (the body at :1051,
// launched at :2396; its contract is f_bwd, :2421-2433), with its
// spherical-harmonics cotangent (compute_dsh, :1307-1325) computed when
// the caller asks for it: the forces of a first-order model through
// positions.  The forward is
//
//   h_0 = er,  z_i = h_i W_i,  h_{i+1} = ssp(z_i)        (hidden layers)
//   w = h_L W_out                                       [E, P * mul]
//   S[dst_e, row(p, m3), u] += w[e, p, u] * sum_nz C * x[src_e, m1, u] *
//                                                       sh[e, m2]
//   out[n, cols(q)] = S[n, a_col(q) : +kdim] @ wsel_q     per mix problem q
//
// and, given gout = dL/dout and the forward's f32 scratch S (saved, the
// card's counterpart of the TPU kernel's save_mid; per node, not per edge),
// this entry computes dx, d er, dW_hidden, dW_out, dwsel and, when asked,
// dsh in four stages of hand-written kernels on the caller's stream:
//
// a. node stage (rowmix::mix_products in row_mix.cuh, the tensor-core GEMM
//    shared with every conv and pairwise kernel): per block of scratch
//    columns dS = sum over the problems that read it of gout_q @ wsel_q^T,
//    one owner per tile; per mix matrix dwsel_q = sum over its d components
//    of S^T @ gout_q, split over node chunks as far as the card needs
//    blocks, the partial tiles added in split order by a second pass.
// b. edge stage: walk::mlp_hidden_kernel (edge_walk.cuh) recomputes the
//    MLP's hidden layers per edge and stores the pre-activations z and
//    activations h; k2_walk_kernel walks the edges source-major (the
//    mirror of K1's destination-major walk): a block takes one work item
//    (the runs of a few source nodes, at most 4 * cap edges) and a chunk of
//    up to four CG paths of one left irrep, split over blockIdx.y.  Per
//    edge it gathers dS[dst], stores dw[e, p, u] in w_out's column order
//    with a plain store, and sums w * M^T dS over the node's outgoing
//    edges in registers; when the source changes it stores the node's
//    per-path dx row once, with a plain store, into a path-major work
//    buffer dxp [N, sum_p d1(p) * mul].  Long runs are walked in pieces
//    and summed in item order by walk::walk_piece_sum_kernel (as in K1: a
//    second small pass, not atomics, so the order of summation is fixed);
//    walk::walk_dx_kernel then adds each left irrep's paths in path order
//    into dx.
//    No dx atomics, no dx zero fill (unless some input column is read by
//    no path), and dx repeats bit for bit.  M^T dS is a dense product over
//    compile-time register indices, so no channel selects its left
//    component at run time.
//    With dsh asked for, the same walk (k2_walk_kernel<kRows, true>) also
//    forms each node's X[m3][m2] = sum_m1 C x[src, m1, u] once, per edge
//    y = dS[dst]^T X and the channel's share w * y of dsh[e], sums the
//    shares over the lanes and the chunk's paths (edge_walk.cuh, the sh
//    cotangent: K4b's scheme) into one row per path chunk, and
//    walk::walk_chunk_sum_kernel adds the chunks' rows in chunk order:
//    no atomics and no memset, so dsh repeats bit for bit.  Without it
//    the walk is compiled without any of this.
// c. MLP stage (rowmix::matmul, the same GEMM, and k2_act_grad_kernel):
//    dW_out = h_L^T dw (split over edge chunks), dh = dw W_out^T, then per
//    hidden layer from the last: dz = dh * ssp'(z) (ssp' = sigmoid *
//    act_cst), dW_i = h_i^T dz, dh_i = dz W_i^T, the last of which is d er.
//    Each output tile has one owner, so none of them is zero-filled.
//
// What bounds it on the card: the edge walk and the MLP stage's tiled
// products take about half each at config_energy's hot layer (E = 24386).
// The walk is bound as K1's is (instruction issue at 16 warps per SM:
// the radial weights recomputed, H * P * mul FMAs per edge, and the dense
// products with M, fed by shared-memory loads) plus the dS gathers, K *
// mul floats per edge read through L2 (an edge's destination rows are its
// molecule's).  Left out one at a time (chip_smoke.py --walk-ablation,
// H100), the parts of the walk's 2.07 ms there cost: the per-edge products
// with the gathers and dw stores 43 %, radial weights 29 %, CG matrices
// 15 %, staging and syncs alone 12 %.  The products run on the tensor
// cores in 3xTF32 (2 * E * 64 * 3072 FMAs for dW_out and dh, bound at a
// third of the TF32 rate) with plain stores and a fixed order of
// summation, so every output repeats bit for bit; the per-edge cotangent
// dw, [E, P * mul] in f32 (~300 MB at E = 24386), is written once and read
// twice.  Padded edges need no
// special case (zero edge_radial, bias-free MLP); edges with an endpoint
// outside [0, N), skipped by the forward, get zero dw.
//
// The walk keeps the dx sums of one left irrep in registers, up to nine
// of them (l <= 4, the hamiltonian trunk); the host refuses wider left
// irreps.
//
// The bfloat16 variant (full_conv_bwd_bf16) computes the TPU kernel's
// backward contract at compute_dtype=bfloat16, its own rounding points
// (fused_conv.py:1126-1312) and not the adjoint of the rounded forward.
// x, sh, the weights, the mix matrices and gout are read from bfloat16
// tensors.  a. dS and dwsel by the GEMM's bfloat16 products (S rounded as
// it is loaded).  b. the MLP recomputed with rounded activations
// (mlp_hidden_kernel<true>), then k2_bf16_walk_kernel (bf16_walk.cuh): the
// source-major items, a block per item and left irrep with ALL its paths
// (the TPU kernel's C^T dot sums every path of a sh irrep section,
// :886-905), 4 warps of 16 channels at mul = 64; per stage the radial
// weights as tensor-core MMAs, per edge mid = bf16(O C) as in K1, g =
// bf16(dS[dst]), dw = the bfloat16 sum over the path's components of
// bf16(g mid), dmid = bf16(g w), douter = bf16(dmid C^T) as a second chain
// of MMAs whose A fragments are dmid's C fragments packed (one rounding per
// (j, m1)), then dx_e[m1] = the bfloat16 sum over j in order of bf16(sh_j
// douter[j][m1]) (:1293-1306), summed over the node's edges in float32 and
// written once per node (long runs in pieces, as above).  c. the MLP stage
// with every cotangent rounded (:1264-1285): the GEMM's bfloat16 products,
// k2_act_grad_kernel<true>.  dx, dW and dwsel are rounded as they are
// stored into bfloat16 outputs (the caller casts them to the inputs'
// dtypes, :2421-2433), d er is float32, rounded.  No sh cotangent:
// refused.  What bounds the walk: a warp's per-edge chain (the dS gather,
// the two MMA chains, the roundings of the epilogue and of the ordered
// sums), at 16 warps per SM (4 blocks of ~51 KB of shared memory and at
// most 128 registers at config_energy's widths); dS is read per edge
// through L2 (K * mul floats).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bf16.cuh"
#include "bf16_walk.cuh"
#include "edge_walk.cuh"
#include "row_mix.cuh"

using namespace walk;

namespace {

using rowmix::matmul;

// dz = dh * ssp'(z), ssp'(v) = sigmoid(v) * act_cst; kBf16: dh and dz
// rounded to bfloat16
template <bool kBf16 = false>
__global__ void k2_act_grad_kernel(const float* __restrict__ dh,
                                   const float* __restrict__ z, size_t count,
                                   float act_cst, float* __restrict__ dz) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    if constexpr (kBf16)
      dz[i] = bf16::rn(bf16::rn(dh[i]) * act_cst / (1.f + expf(-z[i])));
    else
      dz[i] = dh[i] * act_cst / (1.f + expf(-z[i]));
  }
}

// The source-major walk (edge_walk.cuh) of the edge stage.  Thread (u, g)
// owns channel u of the chunk's g-th path (all of one left irrep) and, per
// staged edge e with source s = the walk's key, with the stage's radial
// weights w and CG matrices M[m3][m1] = sum_m2 C sh[e, m2]:
//   g[m3]  = dS[dst_e, row(p, m3), u]                    (a gather)
//   t[m1]  = sum_m3 M[m3][m1] * g[m3]
//   dw[e, wcol + u] = sum_m1 x[s, m1, u] * t[m1]         (plain store)
//   dxp[s, dcol(p) + m1 * mul + u] += w * t[m1]          (registers until s
//                                                         changes, then one
//                                                         plain store)
// and with kDsh (sh needs a gradient), with X of x[s] built once per node
// (edge_walk.cuh, the sh cotangent):
//   y[m2]  = sum_m3 g[m3] X[m3][m2]
//   dsh[e, j0 + m2] += w * y[m2]       (over channels and paths: shuffles,
//                                       shared memory, then one row per
//                                       chunk into part [n_chunks, E, J])
// kRows: register rows of g, at least the widest irrep on either side (7:
// l <= 3; 9: l <= 4; 16: output irreps up to l = 7, not with kDsh); the
// left irrep has at most kMaxD components.
template <int kRows, bool kDsh>
__global__ void __launch_bounds__(256, 2) k2_walk_kernel(
    const float* __restrict__ x, int in_dim,
    const float* __restrict__ sh, int J,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    const int* __restrict__ perm, const int* __restrict__ ptr, int N, int E,
    int cap, int T,
    const float* __restrict__ h_last, int H,
    const float* __restrict__ w_out, int PC,
    const int* __restrict__ walk_tab, const int* __restrict__ chunks,
    const int* __restrict__ cells, const float2* __restrict__ nz,
    const float* __restrict__ dS, int KM,
    float* __restrict__ dw, float* __restrict__ dxp,
    float* __restrict__ pieces, int KMd, float* __restrict__ part) {
  // kL: register rows of the left irrep (at most kMaxD); kC: columns of
  // the node matrix X (the sh irrep's components, at most 7)
  constexpr int kL = kRows < kMaxD ? kRows : kMaxD;
  constexpr int kP = pitch(kRows), kD = pitch(kL);
  constexpr int kC = kRed - 1;
  constexpr int kCd = kRows * kRows * kRed;  // one path's dense CG
  extern __shared__ __align__(16) unsigned char smem[];
  const int mul = blockDim.x, u = threadIdx.x, g = threadIdx.y;
  const int tid = g * mul + u, nthr = mul * kGroups;
  const int t = blockIdx.x;
  const int c0 = chunks[2 * blockIdx.y], cn = chunks[2 * blockIdx.y + 1];
  const int* tab = walk_tab + (size_t)c0 * kWalkFields;
  const int* last = tab + (size_t)(cn - 1) * kWalkFields;
  const int x_off = tab[kXOff], d1 = tab[kD1], xw = d1 * mul;
  const int k0 = tab[kCell0], k1 = last[kCell0] + last[kD3] * d1 + 1;
  const int z0 = cells[k0], z1 = cells[k1 - 1];
  const Stage st = carve(smem, z1 - z0, k1 - k0, xw, nthr, kRows);
  // kDsh: the chunk's dense CG [kGroups][kCd], then the dsh shares of a
  // stage [kStage][lane groups][kRed]
  const int lanes = mul < 32 ? mul : 32;
  const int n_grp = nthr / lanes, nsub = mul / lanes;
  float* cd = st.end;
  float* red = cd + kGroups * kCd;
  stage_chunk(st, nz, z0, z1, cells, k0, k1, tid, nthr);
  if (kDsh) dense_cg<kRows>(cd, st, tab, cn, d1, k0, tid, nthr);
  const Staged staged = {h_last, H, sh, nullptr, J, x, nullptr, in_dim, x_off,
                         xw, x_vectors(x, in_dim, x_off, xw), nullptr,
                         nullptr, 0, 0};

  const bool active = g < cn;
  const int* pi = tab + (size_t)(active ? g : 0) * kWalkFields;
  const int j0 = pi[kJ0], d3 = pi[kD3], d2 = pi[kD2];
  const int row_base = pi[kRowBase], row_stride = pi[kRowStride];
  const int wcol_u = pi[kWCol] + u, dcol_u = pi[kDCol] + u;
  const int* my_cells = st.cells + (pi[kCell0] - k0);
  const float* my_cd = cd + (active ? g : 0) * kCd;
  const int dv = kDsh ? dsh_width(tab, cn, d2, mul) : 0;
  const int lane = tid & 31, grp = tid / lanes, r = u % lanes;

  const Item it = item_walk(ptr, N, t, T, cap);
  float dxv[kL];
#pragma unroll
  for (int m = 0; m < kL; ++m) dxv[m] = 0.f;
  float X[kRows][kC];
  int x_node = -1;
  int cur = it.first;
  auto flush = [&](int n) {
    float* row = (n == it.head ? pieces + (size_t)t * KMd
                               : dxp + (size_t)n * KMd) + dcol_u;
#pragma unroll
    for (int m = 0; m < kL; ++m) {
      if (m < d1) row[(size_t)m * mul] = dxv[m];
      dxv[m] = 0.f;
    }
  };

  for (int pos0 = it.e_lo; pos0 < it.e_hi; pos0 += kStage) {
    const int nq = min(kStage, it.e_hi - pos0);
    stage_edges(st, pos0, nq, perm, src, dst, false, staged, tid, nthr);
    if (active) {
      cg_matrices<kRows>(st, st.sh, st.m, nq, g, my_cells, d1, d3, j0, u,
                         mul);
      radial_weights(st, w_out, H, PC, wcol_u, tid, nthr);
    }
    __syncthreads();
    // with kDsh every lane takes part in the dsh sums
    if (!active && !kDsh) continue;
    for (int q = 0; q < nq; ++q) {
      float rv[kRed];
#pragma unroll
      for (int m = 0; m < kRed; ++m) rv[m] = 0.f;
      if (active) {
        const int nd = st.node[q];
        for (; cur < nd; ++cur) flush(cur);
        const float* grow = dS + (size_t)st.other[q] * KM +
                            (size_t)row_base * mul + u;
        float gv[kRows];
#pragma unroll
        for (int m3 = 0; m3 < kRows; ++m3)
          gv[m3] = m3 < d3 ? __ldg(grow + (size_t)m3 * row_stride * mul)
                           : 0.f;
        float tv[kD];
#pragma unroll
        for (int m = 0; m < kD; ++m) tv[m] = 0.f;
        const float4* mq = reinterpret_cast<const float4*>(
            st.m + (q * kGroups + g) * kRows * kP);
#pragma unroll
        for (int m3 = 0; m3 < kRows; ++m3) {
          if (m3 >= d3) break;
#pragma unroll
          for (int k = 0; k < kD / 4; ++k) {
            if (4 * k >= d1) break;
            const float4 v = mq[m3 * (kP / 4) + k];
            tv[4 * k] += v.x * gv[m3];
            tv[4 * k + 1] += v.y * gv[m3];
            tv[4 * k + 2] += v.z * gv[m3];
            tv[4 * k + 3] += v.w * gv[m3];
          }
        }
        float xr[kD];
        load_x<kL>(xr, st.x + q * xw + u * d1, d1);
        const float w = st.w[q * nthr + tid];
        float dwv = 0.f;
#pragma unroll
        for (int m = 0; m < kL; ++m) {
          dwv += xr[m] * tv[m];
          dxv[m] += w * tv[m];
        }
        dw[(size_t)st.edge[q] * PC + wcol_u] = dwv;
        if constexpr (kDsh) {
          if (nd != x_node) {
            node_matrix<kRows, kC>(
                X, my_cd, x + (size_t)nd * in_dim + x_off + u * d1, d1, d3);
            x_node = nd;
          }
          float y[kC];
          contract<kRows, kC>(y, X, gv, d3);
#pragma unroll
          for (int m2 = 0; m2 < kC; ++m2) rv[m2] = w * y[m2];
        }
      }
      // the path's dsh shares of edge q, summed over its lanes
      if (kDsh)
        lane_dsh(rv, dv, lanes, lane, r, active, d2,
                 red + (q * n_grp + grp) * kRed);
    }
    if (kDsh) {
      __syncthreads();
      dsh_rows(red, tab, cn, nsub, n_grp, st.edge, nq, J,
               part + (size_t)blockIdx.y * E * J, tid, nthr);
    }
  }
  // edges outside [0, N) are walked by no one: their dw and dsh are zero
  const int lo = max(t * cap, ptr[N]), hi = min(t * cap + cap, E);
  if (kDsh)
    for (int i = tid; i < (hi - lo) * J; i += nthr)
      part[((size_t)blockIdx.y * E + perm[lo + i / J]) * J + i % J] = 0.f;
  if (!active) return;
  for (; cur < it.end; ++cur) flush(cur);
  for (int pos = lo; pos < hi; ++pos)
    dw[(size_t)perm[pos] * PC + wcol_u] = 0.f;
}

}  // namespace

// probs_host: the mix problem table of the forward, on the host; walk_tab,
// chunks, nz, irreps: the walk tables (ConvTables); perm, ptr: the
// source-major edge order.  Work buffers (f32, uninitialised): dS [N, KM],
// dw [E, PC], z_all and h_all [n_hidden, E, H], dh and dz [E, H], dxp
// [N, KMd], pieces [T, KMd]; ws [ws_len]: the split products' partial
// tiles.  dsh [E, J] and its chunks' rows part [n_chunks, E, J]: the sh
// cotangent, computed when dsh is not null (left and output irreps up to
// l = 4, sh irreps up to l = 3, mul a multiple of min(mul, 32), a power of
// two, and at least 8).
extern "C" int full_conv_bwd(
    const float* x, int N, int in_dim,
    const float* sh, int J,
    const float* er, int R,
    const long long* src, const long long* dst, int E,
    const float* w_hidden, int H, int n_hidden,
    const float* w_out, int PC, float act_cst,
    const int* walk_tab, const int* chunks, int n_chunks, const int* cells,
    const float* nz, int max_chunk_nz, int max_d1, int max_d3,
    const int* irreps, int n_irreps, int KMd, int dx_covered,
    const int* perm, const int* ptr, int cap, int T,
    const float* scratch, int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* dS, float* dw, float* z_all, float* h_all, float* dh, float* dz,
    float* dxp, float* pieces,
    float* dx, float* der, float* dw_hidden, int w_hidden_len,
    float* dw_out, float* dwsel, float* dsh, float* part, float* ws,
    int ws_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_d1 > kMaxD || max_d3 > 16 || R > kMaxRadial || cap < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const size_t f = sizeof(float);
  cudaError_t err = cudaSuccess;
  const int lanes = mul < 32 ? mul : 32;
  if (dsh && (max_d1 > kMaxD || max_d3 > kMaxD || J > kMaxSh || mul < 8 ||
              (lanes & (lanes - 1)) || mul % lanes))
    return (int)cudaErrorInvalidValue;
  if (!dx_covered) err = cudaMemsetAsync(dx, 0, (size_t)N * in_dim * f, s);
  if (err != cudaSuccess) return (int)err;
  if (dsh && n_chunks == 0)  // no path reads sh
    err = cudaMemsetAsync(dsh, 0, (size_t)E * J * f, s);
  if (err != cudaSuccess) return (int)err;

  // a. node stage: dS and dwsel
  err = rowmix::mix_products(rowmix::kMixRows, probs_host, n_probs, N, KM,
                             out_dim, nullptr, wsel, gout, dS, wsel_len, ws,
                             ws_len, s);
  if (err != cudaSuccess) return (int)err;
  err = rowmix::mix_products(rowmix::kMixWeights, probs_host, n_probs, N, KM,
                             out_dim, scratch, nullptr, gout, dwsel, wsel_len,
                             ws, ws_len, s);
  if (err != cudaSuccess) return (int)err;

  // b. edge stage
  const size_t EH = (size_t)E * H;
  if (E > 0) {
    const unsigned blocks = (E + kHiddenEdges - 1) / kHiddenEdges;
    mlp_hidden_kernel<false><<<blocks, 256, 0, s>>>(
        er, R, E, w_hidden, H, n_hidden, act_cst, z_all, h_all, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_chunks > 0) {  // with N = 0 it still zeroes every edge's dw
    const int kr = walk_rows(max_d1 > max_d3 ? max_d1 : max_d3);
    const int nthr = mul * kGroups;
    const size_t bytes =
        stage_bytes(max_chunk_nz, max_d1, max_d3, max_d1 * mul, nthr, kr) +
        (dsh ? dsh_bytes(kr, nthr, mul) : 0);
    auto kernel = dsh ? (kr == kMaxD ? k2_walk_kernel<kMaxD, true>
                                     : k2_walk_kernel<7, true>)
                  : kr == 16    ? k2_walk_kernel<16, false>
                  : kr == kMaxD ? k2_walk_kernel<kMaxD, false>
                                : k2_walk_kernel<7, false>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(T, n_chunks), dim3(mul, kGroups), bytes, s>>>(
        x, in_dim, sh, J, src, dst, perm, ptr, N, E, cap, T,
        h_all + (size_t)(n_hidden - 1) * EH, H, w_out, PC, walk_tab, chunks,
        cells, reinterpret_cast<const float2*>(nz), dS, KM, dw, dxp, pieces,
        KMd, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sum_pieces(ptr, N, T, cap, pieces, KMd, dxp, s);
    if (err != cudaSuccess) return (int)err;
    err = sum_dx(dxp, N, KMd, irreps, n_irreps, mul, dx, in_dim, s);
    if (err != cudaSuccess) return (int)err;
    if (dsh) err = sum_chunks(part, n_chunks, (size_t)E * J, dsh, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (E == 0) {  // no edge: the MLP's gradients are zero
    struct { void* p; size_t n; } zero[] = {
        {dw_hidden, (size_t)w_hidden_len}, {dw_out, (size_t)H * PC}};
    for (auto& b : zero) {
      err = cudaMemsetAsync(b.p, 0, b.n * f, s);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  }

  // c. MLP stage: last layer, then the hidden layers from the last
  const float* h_last = h_all + (size_t)(n_hidden - 1) * EH;
  // dW_out[h, c] = sum_e h_last[e, h] dw[e, c]
  err = matmul(h_last, false, dw, false, dw_out, H, PC, E, true, ws, ws_len,
               s);
  if (err != cudaSuccess) return (int)err;
  // dh[e, h] = sum_c dw[e, c] W_out[h, c]
  err = matmul(dw, true, w_out, true, dh, E, H, PC, false, nullptr, 0, s);
  if (err != cudaSuccess) return (int)err;

  size_t w_ofs = (size_t)R * H + (size_t)(n_hidden - 1) * H * H;
  for (int i = n_hidden - 1; i >= 0; --i) {
    const int fan = i == 0 ? R : H;
    w_ofs -= (size_t)fan * H;
    const float* a_in = i == 0 ? er : h_all + (size_t)(i - 1) * EH;
    const unsigned blocks = (unsigned)std::min<size_t>((EH + 255) / 256, 4096);
    k2_act_grad_kernel<false><<<blocks, 256, 0, s>>>(
        dh, z_all + (size_t)i * EH, EH, act_cst, dz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // dW_i[k, h] = sum_e a_in[e, k] dz[e, h]
    err = matmul(a_in, false, dz, false, dw_hidden + w_ofs, fan, H, E, true,
                 ws, ws_len, s);
    if (err != cudaSuccess) return (int)err;
    // d a_in[e, k] = sum_h dz[e, h] W_i[k, h]
    err = matmul(dz, true, w_hidden + w_ofs, true, i == 0 ? der : dh, E, fan,
                 H, false, nullptr, 0, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The bfloat16 variant: the arguments of full_conv_bwd with x, sh, the
// MLP weights, the mix matrices, gout, dx, dw_hidden, dw_out and dwsel
// bfloat16 (d er float32); in place of the float32 walk tables, the
// bfloat16 walk's (tab, tiles, n_units, dims: see full_conv_fwd_bf16);
// pieces [T, in_dim] the float32 sums of the long runs' dx pieces, wt
// [PC, 64] W_out transposed (work buffers); no sh cotangent.
extern "C" int full_conv_bwd_bf16(
    const bf16::T* x, int N, int in_dim,
    const bf16::T* sh, int J,
    const float* er, int R,
    const long long* src, const long long* dst, int E,
    const bf16::T* w_hidden, int H, int n_hidden,
    const bf16::T* w_out, int PC, float act_cst,
    const int* tab, const int* tiles, int n_units, const int* dims,
    int dx_covered,
    const int* perm, const int* ptr, int cap, int T,
    const float* scratch, int KM, int mul,
    const bf16::T* wsel, int wsel_len, const int* probs_host, int n_probs,
    const bf16::T* gout, int out_dim,
    float* dS, float* dw, float* z_all, float* h_all, float* dh, float* dz,
    float* pieces, bf16::T* wt,
    bf16::T* dx, float* der, bf16::T* dw_hidden, int w_hidden_len,
    bf16::T* dw_out, bf16::T* dwsel, float* ws, int ws_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > kMaxRadial || cap < 1 || T < 1 || n_hidden < 1 ||
      n_units != dims[bwalk::kDUnits])
    return (int)cudaErrorInvalidValue;
  const size_t f = sizeof(float), b = sizeof(bf16::T);
  cudaError_t err = cudaSuccess;
  if (!dx_covered) {
    err = cudaMemsetAsync(dx, 0, (size_t)N * in_dim * b, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(pieces, 0, (size_t)T * in_dim * f, s);
    if (err != cudaSuccess) return (int)err;
  }

  // a. node stage: dS and dwsel, the bfloat16 products
  err = rowmix::mix_products<bf16::T>(rowmix::kMixRows, probs_host, n_probs,
                                      N, KM, out_dim, nullptr, wsel, gout, dS,
                                      wsel_len, ws, ws_len, s, true);
  if (err != cudaSuccess) return (int)err;
  err = rowmix::mix_products(rowmix::kMixWeights, probs_host, n_probs, N, KM,
                             out_dim, scratch, nullptr, gout, dwsel, wsel_len,
                             ws, ws_len, s, true);
  if (err != cudaSuccess) return (int)err;

  // b. edge stage
  const size_t EH = (size_t)E * H;
  if (E > 0) {
    const unsigned blocks = (E + kHiddenEdges - 1) / kHiddenEdges;
    mlp_hidden_kernel<true><<<blocks, 256, 0, s>>>(
        er, R, E, w_hidden, H, n_hidden, act_cst, z_all, h_all, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float* h_last = h_all + (size_t)(n_hidden - 1) * EH;
  if (n_units > 0) {  // with N = 0 it still zeroes every edge's dw
    const bool wide = dims[bwalk::kDNT] > 6 || dims[bwalk::kDXw] > 8 * mul;
    auto kernel = wide ? bwalk::k2_bf16_walk_kernel<12, 2, bwalk::kMlp>
                       : bwalk::k2_bf16_walk_kernel<6, 1, bwalk::kMlp>;
    bwalk::Layout l;
    err = bwalk::prepare(kernel, dims, mul, J, H, true, false, l);
    if (err == cudaSuccess) err = bwalk::transpose_w(w_out, H, PC, wt, s);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(T, n_units), 32 * ((mul + 15) / 16), l.end, s>>>(
        x, in_dim, sh, J, src, dst, perm, ptr, N, E, cap, T, h_last, H, wt,
        PC, tab, tiles, l, dS, KM, mul, dw, dx, pieces, nullptr, nullptr,
        bwalk::Cot{});
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = sum_pieces(ptr, N, T, cap, pieces, in_dim, dx, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    err = cudaMemsetAsync(dw, 0, (size_t)E * PC * f, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dx, 0, (size_t)N * in_dim * b, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (E == 0) {  // no edge: the MLP's gradients are zero
    err = cudaMemsetAsync(dw_hidden, 0, (size_t)w_hidden_len * b, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dw_out, 0, (size_t)H * PC * b, s);
    return (int)err;
  }

  // c. MLP stage, every cotangent rounded (the bfloat16 dW stored rounded,
  // d er rounded as it is stored)
  err = matmul(h_last, false, dw, false, dw_out, H, PC, E, true, ws, ws_len,
               s, true);
  if (err != cudaSuccess) return (int)err;
  err = matmul(dw, true, w_out, true, dh, E, H, PC, false, nullptr, 0, s,
               true);
  if (err != cudaSuccess) return (int)err;
  size_t w_ofs = (size_t)w_hidden_len;
  for (int i = n_hidden - 1; i >= 0; --i) {
    const int fan = i == 0 ? R : H;
    w_ofs -= (size_t)fan * H;
    const float* a_in = i == 0 ? er : h_all + (size_t)(i - 1) * EH;
    const unsigned blocks =
        (unsigned)std::min<size_t>((EH + 255) / 256, 4096);
    k2_act_grad_kernel<true><<<blocks, 256, 0, s>>>(
        dh, z_all + (size_t)i * EH, EH, act_cst, dz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = matmul(a_in, false, dz, false, dw_hidden + w_ofs, fan, H, E, true,
                 ws, ws_len, s, true);
    if (err != cudaSuccess) return (int)err;
    err = matmul(dz, true, w_hidden + w_ofs, true, i == 0 ? der : dh, E, fan,
                 H, false, nullptr, 0, s, true, i == 0);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
