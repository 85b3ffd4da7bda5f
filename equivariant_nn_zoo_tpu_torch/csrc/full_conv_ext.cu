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
// wigner_3j non-zeros).  The edge work is two node-major walks of
// edge_walk.cuh over the edge order that the model's forward built once
// (K1's and K2's, with external radial weights in place of the MLP):
//
// - the destination-major walk (K1's) sums the messages of each node's
//   incoming edges in registers and stores the node's scratch rows once:
//   S = scatter(w * M(sh) x[src]), and for K4g
//   S_sum = scatter(w * (M(sh) cx + M(csh) x) + cw * M(sh) x), with
//   M(sh)[m3][m1] = sum_m2 C[m1, m2, m3] sh[m2] built per (edge, path) in
//   shared memory;
// - the source-major walk (K2's) gathers dS[dst] per edge (K * mul floats,
//   as K2 does), sums the dx rows of each node's outgoing edges in
//   registers and stores them once (per path, then added by left irrep),
//   stores the per-edge dw with a plain store, and reduces the per-edge
//   dsh over the channels in the block.  With the node's x held as
//   X[m3][m2] = sum_m1 C[m1, m2, m3] x[src, m1, u] (registers, once per
//   node, from a dense copy of the chunk's CG in shared memory), per edge
//   y[m2] = sum_m3 dS[dst, m3] X[m3][m2] gives dw = sh . y and the
//   channel's share w * y of dsh, and dx[src] += w * M(sh)^T dS[dst].
//   The shares are summed over the lanes of each path (warp shuffles,
//   halving the values at each step), then over the chunk's paths in
//   order in shared memory, into a per-chunk row [n_src_chunks, E, J] that
//   a second pass adds up in chunk order.  Its chunks may span the left
//   irreps of one width, since it does not stage x.
//
// Three C entries, each a short sequence of kernels on the caller's stream:
//
// K4f  full_conv_ext_fwd(x, sh, w, wsel) -> out, scratch S: the
//      destination-major walk, then the forward mix.  S is returned: the
//      autograd Function saves it for K4b.
// K4b  full_conv_ext_bwd(x, sh, w, wsel, gout[, S]) -> dx, dsh, dw, dwsel:
//      dS = mix^T(gout); dwsel = S^T gout on the forward's saved S, or,
//      when none is given (the pairing rule substitutes cotangents into
//      the operand slots, and no saved scratch is of those operands), on S
//      recomputed by the destination-major walk; then the source-major
//      walk.
// K4g  full_conv_ext_grad2(x, cx, sh, csh, w, cw, wsel, gout) ->
//      c_x, c_s, c_w, c_m, c_g (fused_conv.py:1636-1640): dS; the
//      destination-major walk of S_sum, c_g = mix(S_sum), c_m = S_sum^T
//      gout; then the source-major walk with two operands: with yx, yc the
//      y of x and of cx,
//      c_x[src] += w M(csh)^T dS + cw M(sh)^T dS, c_w = sh . yc + csh . yx,
//      c_s = sum over paths and channels of w yc + cw yx.
//
// Every edge is treated alike: no early exit on a zero weight and no
// skipped padded edge, because the second-order rule substitutes unmasked
// cotangents into the w and sh slots and the three kernels must stay exact
// adjoints of one multilinear map (the TPU kernels' forced trailing-pad
// flush, :1401-1408).  Edges with an endpoint outside [0, N) sit past
// ptr[N] in the order and are walked by no one, as by K1 (a segment sum
// drops out-of-range ids); each item writes zeros into the dw and dsh rows
// of the tail positions it owns, so no output is zero-filled first.
//
// What bounds them on the card: instruction issue and latency between the
// walks' barriers, as in K1 and K2 (16 warps per SM), not bytes: w and its
// cotangent ([E, P * mul] f32, 105 MB each at config_energy_force's hot
// layer, N 1012, E 13692) are read or written once per call, and the
// entries run at 0.06-0.09 of their byte bound.  Left out one at a time
// there (chip_smoke.py --walk-ablation, H100), the parts of K4b's
// source-major walk (0.72 ms) cost: the per-edge products with the dS
// gathers 73 %, the dsh lane sums 21 %, the CG matrices 10 %, staging and
// barriers alone 12 %; of K4f's destination-major walk (0.40 ms): the
// per-edge products 45 %, the CG matrices 39 %, staging 24 %.  An L1
// prefetch of the dS rows a few edges ahead made the source walk slower.
// No global atomics and no memsets of S, dx or dw: every sum runs in a
// fixed order, so every output repeats bit for bit.  The mix and the
// node-stage products are row_mix.cuh's tensor-core GEMM (3xTF32, shared
// with every conv and pairwise kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"
#include "row_mix.cuh"

using namespace walk;

namespace {

using rowmix::kMixRows;
using rowmix::kMixWeights;
using rowmix::mix_products;
using rowmix::mix_rows;

// dsh values of one (edge, path) reduced over the channels: the sh irrep's
// components (at most 7, l <= 3), padded; also the m2 pitch of the dense CG
constexpr int kRed = 8;

// The operands of one walk, in either direction.
struct ExtWalk {
  const float* x;     // [N, in_dim]
  const float* cx;    // [N, in_dim], K4g only
  const float* sh;    // [E, J]
  const float* csh;   // [E, J], K4g only
  const float* w;     // [E, PC]
  const float* cw;    // [E, PC], K4g only
  const float* dS;    // [N, KM], the source-major walk
  const long long* src;
  const long long* dst;
  const int* perm;    // the walk's edge order and its row pointers
  const int* ptr;
  const int* walk_tab;
  const int* chunks;
  const int* cells;
  const float2* nz;
  int N, E, in_dim, J, PC, KM, KMd, cap, T;
  float* rows;        // destination-major: S [N, KM]; source-major: the
                      // per-path dx rows [N, KMd]
  float* pieces;      // the long runs' pieces of those rows, [T, width]
  float* dw;          // [E, PC], source-major
  float* part;        // [n_src_chunks, E, J], source-major: each chunk's dsh
};

// sum_k M[m3][k] v[k] over one row of a staged CG matrix, k < d1
template <int kRows>
__device__ __forceinline__ float row_dot(const float4* mrow,
                                         const float (&v)[pitch(kRows)],
                                         int d1) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < pitch(kRows) / 4; ++k) {
    if (4 * k >= d1) break;
    const float4 c = mrow[k];
    a += c.x * v[4 * k] + c.y * v[4 * k + 1] + c.z * v[4 * k + 2] +
         c.w * v[4 * k + 3];
  }
  return a;
}

// The destination-major walk (K1's, edge_walk.cuh) with external radial
// weights: thread (u, g) owns channel u of the chunk's g-th path and adds,
// per incoming edge, w * M(sh) x[src] (kTwo: w * (M(sh) cx + M(csh) x) +
// cw * M(sh) x) into the node's d3 sums; when the destination changes it
// stores the node's scratch rows once.  kRows: register rows, at least the
// widest irrep on any side (5: l <= 2; 7: l <= 3).
template <int kRows, bool kTwo>
__global__ void __launch_bounds__(256, 2)
    ext_dst_walk_kernel(const ExtWalk a) {
  constexpr int kP = pitch(kRows);
  extern __shared__ __align__(16) unsigned char smem[];
  const int mul = blockDim.x, u = threadIdx.x, g = threadIdx.y;
  const int tid = g * mul + u, nthr = mul * kGroups;
  const int t = blockIdx.x;
  const int c0 = a.chunks[2 * blockIdx.y], cn = a.chunks[2 * blockIdx.y + 1];
  const int* first = a.walk_tab + (size_t)c0 * kWalkFields;
  const int* last = a.walk_tab + (size_t)(c0 + cn - 1) * kWalkFields;
  const int x_off = first[kXOff], d1 = first[kD1], xw = d1 * mul;
  const int k0 = first[kCell0], k1 = last[kCell0] + last[kD3] * d1 + 1;
  const int z0 = a.cells[k0], z1 = a.cells[k1 - 1];
  const Stage st =
      carve(smem, z1 - z0, k1 - k0, xw, nthr, kRows, kTwo ? 2 : 1, false);
  stage_chunk(st, a.nz, z0, z1, a.cells, k0, k1, tid, nthr, false);

  const bool active = g < cn;
  const int* pi = a.walk_tab + (size_t)(c0 + (active ? g : 0)) * kWalkFields;
  const int j0 = pi[kJ0], d3 = pi[kD3];
  const int row_base = pi[kRowBase], row_stride = pi[kRowStride];
  const int* my_cells = st.cells + (pi[kCell0] - k0);
  const bool x_vec = x_vectors(a.x, a.in_dim, x_off, xw) &&
                     (!kTwo || x_vectors(a.cx, a.in_dim, x_off, xw));
  const Staged staged = {nullptr, 0, a.sh, kTwo ? a.csh : nullptr, a.J,
                         a.x, kTwo ? a.cx : nullptr, a.in_dim, x_off, xw,
                         x_vec, a.w, kTwo ? a.cw : nullptr, a.PC,
                         pi[kWCol] + u};

  const Item it = item_walk(a.ptr, a.N, t, a.T, a.cap);
  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;
  int cur = it.first;
  auto flush = [&](int n) {
    float* row = (n == it.head ? a.pieces + (size_t)t * a.KM
                               : a.rows + (size_t)n * a.KM) +
                 (size_t)row_base * mul + u;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (m < d3) row[(size_t)m * row_stride * mul] = acc[m];
      acc[m] = 0.f;
    }
  };

  for (int pos0 = it.e_lo; pos0 < it.e_hi; pos0 += kStage) {
    const int nq = min(kStage, it.e_hi - pos0);
    stage_edges<kTwo>(st, pos0, nq, a.perm, a.src, a.dst, true, staged, tid,
                      nthr);
    if (active) {
      cg_matrices<kRows>(st, st.sh, st.m, nq, g, my_cells, d1, d3, j0, u,
                         mul);
      if (kTwo)
        cg_matrices<kRows>(st, st.sh2, st.m2, nq, g, my_cells, d1, d3, j0, u,
                           mul);
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
      if (!kTwo) {
#pragma unroll
        for (int m3 = 0; m3 < kRows; ++m3) {
          if (m3 >= d3) break;
          acc[m3] += w * row_dot<kRows>(mq + m3 * (kP / 4), xr, d1);
        }
      } else {
        // w (M(sh) cx + M(csh) x) + cw M(sh) x
        //   = M(sh) (w cx + cw x) + w M(csh) x
        const float cw = st.w2[q * nthr + tid];
        float vr[kP];
        load_x<kRows>(vr, st.x2 + q * xw + u * d1, d1);
#pragma unroll
        for (int m = 0; m < kP; ++m) vr[m] = w * vr[m] + cw * xr[m];
        const float4* cq = reinterpret_cast<const float4*>(
            st.m2 + (q * kGroups + g) * kRows * kP);
#pragma unroll
        for (int m3 = 0; m3 < kRows; ++m3) {
          if (m3 >= d3) break;
          acc[m3] += row_dot<kRows>(mq + m3 * (kP / 4), vr, d1) +
                     w * row_dot<kRows>(cq + m3 * (kP / 4), xr, d1);
        }
      }
    }
  }
  if (active)
    for (; cur < it.end; ++cur) flush(cur);
}

// Sums v[0..kV) over each aligned group of ``lanes`` lanes (a power of
// two, kV <= lanes <= 32) by halving: at each of the first log2(kV) steps
// a lane keeps half of its values and adds its partner's copy of them, so
// the kV sums take kV - 1 + log2(lanes / kV) shuffles.  Afterwards lane r
// of a group holds in v[0] the group's sum of value r / (lanes / kV).  All
// 32 lanes of the warp take part.
template <int kV>
__device__ __forceinline__ float lane_sums(float (&v)[kV], int lanes,
                                           int lane) {
  int off = lanes >> 1;
#pragma unroll
  for (int n = kV / 2; n >= 1; n /= 2) {
    const bool hi = lane & off;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = hi ? v[i] : v[i + n];
      const float keep = hi ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    off >>= 1;
  }
  for (; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

// X[m3][m2] = sum_m1 C[m1, m2, m3] x[m1] of one node and channel, from the
// path's dense CG cd[m3][m1][m2] (m2 pitch kRed) and the node's x slice xs
template <int kRows>
__device__ __forceinline__ void node_matrix(float (&X)[kRows][kRows],
                                            const float* cd,
                                            const float* __restrict__ xs,
                                            int d1, int d3) {
  float xr[kRows];
#pragma unroll
  for (int m1 = 0; m1 < kRows; ++m1) xr[m1] = m1 < d1 ? __ldg(xs + m1) : 0.f;
#pragma unroll
  for (int m3 = 0; m3 < kRows; ++m3)
#pragma unroll
    for (int m2 = 0; m2 < kRows; ++m2) X[m3][m2] = 0.f;
#pragma unroll
  for (int m3 = 0; m3 < kRows; ++m3) {
    if (m3 >= d3) break;
#pragma unroll
    for (int m1 = 0; m1 < kRows; ++m1) {
      if (m1 >= d1) break;
      const float4* c =
          reinterpret_cast<const float4*>(cd + (m3 * kRows + m1) * kRed);
      const float4 lo = c[0], hi = c[1];
      const float cv[kRed] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int m2 = 0; m2 < kRows; ++m2) X[m3][m2] += cv[m2] * xr[m1];
    }
  }
}

// y[m2] = sum_m3 g[m3] X[m3][m2]
template <int kRows>
__device__ __forceinline__ void contract(float (&y)[kRows],
                                         const float (&X)[kRows][kRows],
                                         const float (&gv)[kRows], int d3) {
#pragma unroll
  for (int m2 = 0; m2 < kRows; ++m2) y[m2] = 0.f;
#pragma unroll
  for (int m3 = 0; m3 < kRows; ++m3) {
    if (m3 >= d3) break;
#pragma unroll
    for (int m2 = 0; m2 < kRows; ++m2) y[m2] += gv[m3] * X[m3][m2];
  }
}

// The source-major walk (K2's, edge_walk.cuh) of K4b and (kTwo) K4g, on
// its own chunk table: x is not staged, so a chunk may hold up to kGroups
// consecutive paths of several left irreps of one width (fewer idle
// groups than K2's one-irrep chunks).
// Thread (u, g) owns channel u of the chunk's g-th path and, per outgoing
// edge e of its source s (the walk's key) with destination d:
//   g[m3]  = dS[d, row(p, m3), u]                        (a gather)
//   y[m2]  = sum_m3 g[m3] X[m3][m2]        (X of x[s], once per node)
//   dw[e, wcol + u] = sh[e] . y                          (plain store)
//   dxp[s, dcol + m1 * mul + u] += w * (M(sh)^T g)[m1]   (registers until s
//                                                         changes)
//   dsh[e, j0 + m2] += w * y[m2]             (over channels and paths:
//                                             shuffles, shared memory,
//                                             then one row per chunk)
// kTwo (K4g), with yx, yc the y of x and cx, and cw the weight cotangent:
// c_w = sh . yc + csh . yx, c_x += (M(csh)^T g) w + (M(sh)^T g) cw,
// c_s += w yc + cw yx.  The node's x is read from device memory once per
// node (not staged: it is the key).
template <int kRows, bool kTwo>
__global__ void __launch_bounds__(256, 2)
    ext_src_walk_kernel(const ExtWalk a) {
  constexpr int kP = pitch(kRows);
  constexpr int kCd = kRows * kRows * kRed;  // one path's dense CG
  extern __shared__ __align__(16) unsigned char smem[];
  const int mul = blockDim.x, u = threadIdx.x, g = threadIdx.y;
  const int tid = g * mul + u, nthr = mul * kGroups;
  const int t = blockIdx.x;
  const int c0 = a.chunks[2 * blockIdx.y], cn = a.chunks[2 * blockIdx.y + 1];
  const int* tab = a.walk_tab + (size_t)c0 * kWalkFields;
  const int* first = tab;
  const int* last = tab + (size_t)(cn - 1) * kWalkFields;
  const int d1 = first[kD1];
  const int k0 = first[kCell0], k1 = last[kCell0] + last[kD3] * d1 + 1;
  const int z0 = a.cells[k0], z1 = a.cells[k1 - 1];
  const Stage st =
      carve(smem, z1 - z0, k1 - k0, 0, nthr, kRows, kTwo ? 2 : 1, false);
  // the chunk's dense CG [kGroups][kCd], then the dsh shares of a stage
  // [kStage][lane groups][kRed]
  const int lanes = mul < 32 ? mul : 32;
  const int n_grp = nthr / lanes, nsub = mul / lanes;
  float* cd = st.end;
  float* red = cd + kGroups * kCd;
  stage_chunk(st, a.nz, z0, z1, a.cells, k0, k1, tid, nthr, false);
  for (int i = tid; i < kGroups * kCd; i += nthr) cd[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < cn * kRows * kRows; i += nthr) {
    const int gg = i / (kRows * kRows), r = i % (kRows * kRows);
    const int m3 = r / kRows, m1 = r % kRows;
    const int* pg = tab + (size_t)gg * kWalkFields;
    if (m3 >= pg[kD3] || m1 >= d1) continue;
    const int* cl = st.cells + (pg[kCell0] - k0) + m3 * d1 + m1;
    for (int z = cl[0]; z < cl[1]; ++z) {
      const float2 e = st.nz[z];
      cd[gg * kCd + (m3 * kRows + m1) * kRed + __float_as_int(e.y)] = e.x;
    }
  }
  // (the first stage's leading barrier orders these writes before use)

  const bool active = g < cn;
  const int* pi = tab + (size_t)(active ? g : 0) * kWalkFields;
  const int x_off = pi[kXOff], j0 = pi[kJ0], d3 = pi[kD3], d2 = pi[kD2];
  const int row_base = pi[kRowBase], row_stride = pi[kRowStride];
  const int wcol_u = pi[kWCol] + u, dcol_u = pi[kDCol] + u;
  const int* my_cells = st.cells + (pi[kCell0] - k0);
  const float* my_cd = cd + (active ? g : 0) * kCd;
  // values reduced per edge: the path's d2, or the chunk's widest when
  // the paths share warps (mul < 32), so that a warp takes one branch
  int dv = d2;
  if (mul < 32)
    for (int gg = 0; gg < cn; ++gg)
      dv = max(dv, tab[(size_t)gg * kWalkFields + kD2]);
  const Staged staged = {nullptr, 0, a.sh, kTwo ? a.csh : nullptr, a.J,
                         nullptr, nullptr, a.in_dim, 0, 0, false, a.w,
                         kTwo ? a.cw : nullptr, a.PC, wcol_u};
  const int lane = tid & 31, grp = tid / lanes, r = u % lanes;

  const Item it = item_walk(a.ptr, a.N, t, a.T, a.cap);
  float dxv[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) dxv[m] = 0.f;
  float X[kRows][kRows], CX[kRows][kRows];
  int x_node = -1;
  int cur = it.first;
  auto flush = [&](int n) {
    float* row = (n == it.head ? a.pieces + (size_t)t * a.KMd
                               : a.rows + (size_t)n * a.KMd) + dcol_u;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (m < d1) row[(size_t)m * mul] = dxv[m];
      dxv[m] = 0.f;
    }
  };
  // dxv[m1] += sum_m3 gv[m3] (a M[m3][m1] + b M2[m3][m1]), M2 for kTwo
  auto add_dx = [&](const float4* mq, const float4* m2q,
                    const float (&gv)[kRows], float a, float b) {
#pragma unroll
    for (int m3 = 0; m3 < kRows; ++m3) {
      if (m3 >= d3) break;
#pragma unroll
      for (int k = 0; k < kP / 4; ++k) {
        if (4 * k >= d1) break;
        const float4 v = mq[m3 * (kP / 4) + k];
        float c[4] = {a * v.x, a * v.y, a * v.z, a * v.w};
        if (kTwo) {
          const float4 v2 = m2q[m3 * (kP / 4) + k];
          c[0] += b * v2.x; c[1] += b * v2.y;
          c[2] += b * v2.z; c[3] += b * v2.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * k + i < kRows) dxv[4 * k + i] += c[i] * gv[m3];
      }
    }
  };

  for (int pos0 = it.e_lo; pos0 < it.e_hi; pos0 += kStage) {
    const int nq = min(kStage, it.e_hi - pos0);
    stage_edges<kTwo>(st, pos0, nq, a.perm, a.src, a.dst, false, staged, tid,
                      nthr);
    if (active) {
      cg_matrices<kRows>(st, st.sh, st.m, nq, g, my_cells, d1, d3, j0, u,
                         mul);
      if (kTwo)
        cg_matrices<kRows>(st, st.sh2, st.m2, nq, g, my_cells, d1, d3, j0, u,
                           mul);
    }
    __syncthreads();
    if (active || mul < 32) {
      for (int q = 0; q < nq; ++q) {
        float rv[kRed];
#pragma unroll
        for (int m = 0; m < kRed; ++m) rv[m] = 0.f;
        if (active) {
          const int nd = st.node[q];
          for (; cur < nd; ++cur) flush(cur);
          if (nd != x_node) {
            const size_t at = (size_t)nd * a.in_dim + x_off + u * d1;
            node_matrix<kRows>(X, my_cd, a.x + at, d1, d3);
            if (kTwo) node_matrix<kRows>(CX, my_cd, a.cx + at, d1, d3);
            x_node = nd;
          }
          const float* grow = a.dS + (size_t)st.other[q] * a.KM +
                              (size_t)row_base * mul + u;
          float gv[kRows];
#pragma unroll
          for (int m3 = 0; m3 < kRows; ++m3)
            gv[m3] = m3 < d3 ? __ldg(grow + (size_t)m3 * row_stride * mul)
                             : 0.f;
          const float w = st.w[q * nthr + tid];
          const float* shq = st.sh + q * kMaxSh + j0;
          const float4* mq = reinterpret_cast<const float4*>(
              st.m + (q * kGroups + g) * kRows * kP);
          float dwv = 0.f;
          if (!kTwo) {
            float y[kRows];
            contract<kRows>(y, X, gv, d3);
#pragma unroll
            for (int m2 = 0; m2 < kRows; ++m2) {
              if (m2 >= d2) break;
              dwv += shq[m2] * y[m2];
            }
#pragma unroll
            for (int m2 = 0; m2 < kRows; ++m2) rv[m2] = w * y[m2];
            add_dx(mq, mq, gv, w, 0.f);
          } else {
            const float cw = st.w2[q * nthr + tid];
            const float* cshq = st.sh2 + q * kMaxSh + j0;
            const float4* cq = reinterpret_cast<const float4*>(
                st.m2 + (q * kGroups + g) * kRows * kP);
            float yx[kRows], yc[kRows];
            contract<kRows>(yx, X, gv, d3);
            contract<kRows>(yc, CX, gv, d3);
#pragma unroll
            for (int m2 = 0; m2 < kRows; ++m2) {
              if (m2 >= d2) break;
              dwv += shq[m2] * yc[m2] + cshq[m2] * yx[m2];
            }
#pragma unroll
            for (int m2 = 0; m2 < kRows; ++m2)
              rv[m2] = w * yc[m2] + cw * yx[m2];
            // c_x += M(sh)^T (cw g) + M(csh)^T (w g)
            add_dx(mq, cq, gv, cw, w);
          }
          a.dw[(size_t)st.edge[q] * a.PC + wcol_u] = dwv;
        }
        // the path's dsh shares of edge q, summed over its lanes
        float sum;
        int v, keep;
        if (dv > 4) {
          sum = lane_sums<8>(rv, lanes, lane);
          v = r / (lanes / 8);
          keep = r % (lanes / 8) == 0;
        } else if (dv > 1) {
          float r4[4] = {rv[0], rv[1], rv[2], rv[3]};
          sum = lane_sums<4>(r4, lanes, lane);
          v = r / (lanes / 4);
          keep = r % (lanes / 4) == 0;
        } else {
          float r1[1] = {rv[0]};
          sum = lane_sums<1>(r1, lanes, lane);
          v = 0;
          keep = r == 0;
        }
        if (active && keep && v < d2)
          red[(q * n_grp + grp) * kRed + v] = sum;
      }
    }
    __syncthreads();
    // the chunk's dsh rows of the stage's edges: its paths' lane groups
    // added in order, zero where no path of the chunk reads sh
    for (int i = tid; i < nq * a.J; i += nthr) {
      const int q = i / a.J, j = i - q * a.J;
      float s = 0.f;
      for (int gg = 0; gg < cn; ++gg) {
        const int* pg = tab + (size_t)gg * kWalkFields;
        const int jj = j - pg[kJ0];
        if (jj < 0 || jj >= pg[kD2]) continue;
        for (int k = 0; k < nsub; ++k)
          s += red[(q * n_grp + gg * nsub + k) * kRed + jj];
      }
      a.part[((size_t)blockIdx.y * a.E + st.edge[q]) * a.J + j] = s;
    }
  }
  if (active)
    for (; cur < it.end; ++cur) flush(cur);
  // edges outside [0, N) are walked by no one: their dw and dsh are zero
  const int lo = max(t * a.cap, a.ptr[a.N]), hi = min(t * a.cap + a.cap, a.E);
  if (active)
    for (int pos = lo; pos < hi; ++pos)
      a.dw[(size_t)a.perm[pos] * a.PC + wcol_u] = 0.f;
  for (int i = tid; i < (hi - lo) * a.J; i += nthr)
    a.part[((size_t)blockIdx.y * a.E + a.perm[lo + i / a.J]) * a.J +
           i % a.J] = 0.f;
}

// out[i] = sum over the chunks of part[c][i], in chunk order
__global__ void ext_chunk_sum_kernel(const float* __restrict__ part,
                                     int n_chunks, size_t count,
                                     float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * count + i];
    out[i] = s;
  }
}

// The sizes and tables every entry takes (the C entries' leading
// arguments, see EXT_COMMON).
struct Tables {
  int rows;           // register rows of the walks' templates (5 or 7)
  int max_chunk_nz, max_d1, max_d3, n_chunks, mul;
  const int* src_chunks;  // the source-major walk's chunks
  int n_src_chunks;
  const int* irreps;  // ConvTables.walk_irreps: the per-path dx rows' sums
  int n_irreps;
};

template <bool kTwo>
cudaError_t dst_walk(const ExtWalk& a, const Tables& tb, cudaStream_t s) {
  if (a.N <= 0 || tb.n_chunks <= 0) return cudaSuccess;
  const size_t bytes =
      stage_bytes(tb.max_chunk_nz, tb.max_d1, tb.max_d3, tb.max_d1 * tb.mul,
                  tb.mul * kGroups, tb.rows, kTwo ? 2 : 1, false);
  auto kernel = tb.rows == 5 ? ext_dst_walk_kernel<5, kTwo>
                             : ext_dst_walk_kernel<7, kTwo>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.T, tb.n_chunks), dim3(tb.mul, kGroups), bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_pieces(a.ptr, a.N, a.T, a.cap, a.pieces, a.KM, a.rows, s);
}

// The source-major walk, then its second passes: the long runs' pieces,
// the per-path dx rows into dx, the chunks' dsh rows into dsh.
template <bool kTwo>
cudaError_t src_walk(ExtWalk a, const Tables& tb, float* dx, float* dsh,
                     cudaStream_t s) {
  if (tb.n_src_chunks <= 0) return cudaSuccess;  // N = 0: zeroes dw, dsh
  a.chunks = tb.src_chunks;
  const int nthr = tb.mul * kGroups;
  const int lanes = tb.mul < 32 ? tb.mul : 32;
  const size_t bytes =
      stage_bytes(tb.max_chunk_nz, tb.max_d1, tb.max_d3, 0, nthr, tb.rows,
                  kTwo ? 2 : 1, false) +
      ((size_t)kGroups * tb.rows * tb.rows * kRed +
       (size_t)kStage * (nthr / lanes) * kRed) * sizeof(float);
  auto kernel = tb.rows == 5 ? ext_src_walk_kernel<5, kTwo>
                             : ext_src_walk_kernel<7, kTwo>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.T, tb.n_src_chunks), dim3(tb.mul, kGroups), bytes, s>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_pieces(a.ptr, a.N, a.T, a.cap, a.pieces, a.KMd, a.rows, s);
  if (err != cudaSuccess) return err;
  err = sum_dx(a.rows, a.N, a.KMd, tb.irreps, tb.n_irreps, tb.mul, dx,
               a.in_dim, s);
  if (err != cudaSuccess) return err;
  const size_t count = (size_t)a.E * a.J;
  if (count == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((count + 255) / 256 < 4096
                                         ? (count + 255) / 256 : 4096);
  ext_chunk_sum_kernel<<<blocks, 256, 0, s>>>(a.part, tb.n_src_chunks,
                                              count, dsh);
  return cudaGetLastError();
}

#define EXT_TRY(expr)                          \
  do {                                         \
    cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

// Arguments common to the three entries: sizes, the edge list, the walk
// tables of ConvTables (device; both chunk tables), the left irreps of the
// per-path dx rows, both node-major orders of the edges (edge_order.py)
// with their work items, the mix problem table (host).
#define EXT_COMMON                                                           \
  int N, int in_dim, int J, const long long *src, const long long *dst,      \
      int E, int PC, const int *walk_tab, const int *chunks, int n_chunks,   \
      const int *src_chunks, int n_src_chunks, const int *cells,             \
      const float *nz, int max_chunk_nz, int max_d1, int max_d2, int max_d3, \
      const int *irreps, int n_irreps, int KMd,                              \
      int dx_covered, const int *dst_perm, const int *dst_ptr,               \
      const int *src_perm, const int *src_ptr, int cap, int T, int KM,       \
      int mul, const int *probs_host, int n_probs, int out_dim

// The walk operands and tables from EXT_COMMON, for the destination-major
// order; ``ok`` is false for sizes the kernels do not take.
#define EXT_SETUP()                                                          \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                        \
  const int widest = max_d1 > max_d2 ? (max_d1 > max_d3 ? max_d1 : max_d3)  \
                                     : (max_d2 > max_d3 ? max_d2 : max_d3);  \
  if (widest > 7 || J > kMaxSh || cap < 1 || T < 1)                          \
    return (int)cudaErrorInvalidValue;                                       \
  const Tables tb = {widest <= 5 ? 5 : 7, max_chunk_nz, max_d1, max_d3,      \
                     n_chunks, mul, src_chunks, n_src_chunks, irreps,        \
                     n_irreps};                                              \
  ExtWalk a = {};                                                            \
  a.src = src; a.dst = dst; a.perm = dst_perm; a.ptr = dst_ptr;              \
  a.walk_tab = walk_tab; a.chunks = chunks; a.cells = cells;                 \
  a.nz = reinterpret_cast<const float2*>(nz);                                \
  a.N = N; a.E = E; a.in_dim = in_dim; a.J = J; a.PC = PC; a.KM = KM;        \
  a.KMd = KMd; a.cap = cap; a.T = T

// scratch: S [N, KM] (returned: the autograd Function saves it for K4b);
// pieces [T, KM]: work.
extern "C" int full_conv_ext_fwd(EXT_COMMON, const float* x, const float* sh,
                                 const float* w, const float* wsel,
                                 float* scratch, float* pieces, float* out,
                                 void* stream) {
  EXT_SETUP();
  a.x = x; a.sh = sh; a.w = w; a.rows = scratch; a.pieces = pieces;
  EXT_TRY(dst_walk<false>(a, tb, s));
  EXT_TRY(mix_rows(scratch, N, KM, wsel, probs_host, n_probs, out, out_dim,
                   s));
  return (int)cudaGetLastError();
}

// saved: K4f's scratch of these operands, or null (then recomputed into
// scratch).  Work: scratch [N, KM], dS [N, KM], dxp [N, KMd], pieces
// [T, max(KM, KMd)], part [n_src_chunks, E, J]; ws [ws_len]: the split
// products' partial tiles.
extern "C" int full_conv_ext_bwd(EXT_COMMON, const float* x, const float* sh,
                                 const float* w, const float* wsel,
                                 const float* gout, const float* saved,
                                 float* scratch, float* dS, float* dxp,
                                 float* pieces, float* part, float* dx,
                                 float* dsh, float* dw, float* dwsel,
                                 int wsel_len, float* ws, int ws_len,
                                 void* stream) {
  EXT_SETUP();
  if (!dx_covered)
    EXT_TRY(cudaMemsetAsync(dx, 0, (size_t)N * in_dim * sizeof(float), s));
  EXT_TRY(mix_products(kMixRows, probs_host, n_probs, N, KM, out_dim, nullptr,
                       wsel, gout, dS, wsel_len, ws, ws_len, s));
  a.x = x; a.sh = sh; a.w = w; a.pieces = pieces;
  const float* S = saved;
  if (!S) {
    a.rows = scratch;
    EXT_TRY(dst_walk<false>(a, tb, s));
    S = scratch;
  }
  EXT_TRY(mix_products(kMixWeights, probs_host, n_probs, N, KM, out_dim, S,
                       nullptr, gout, dwsel, wsel_len, ws, ws_len, s));
  a.perm = src_perm; a.ptr = src_ptr; a.dS = dS; a.rows = dxp;
  a.dw = dw; a.part = part;
  EXT_TRY(src_walk<false>(a, tb, dx, dsh, s));
  return (int)cudaGetLastError();
}

// Work as K4b's (scratch holds S_sum).
extern "C" int full_conv_ext_grad2(
    EXT_COMMON, const float* x, const float* cx, const float* sh,
    const float* csh, const float* w, const float* cw, const float* wsel,
    const float* gout, float* scratch, float* dS, float* dxp, float* pieces,
    float* part, float* c_x, float* c_s, float* c_w, float* c_m, float* c_g,
    int wsel_len, float* ws, int ws_len, void* stream) {
  EXT_SETUP();
  if (!dx_covered)
    EXT_TRY(cudaMemsetAsync(c_x, 0, (size_t)N * in_dim * sizeof(float), s));
  EXT_TRY(mix_products(kMixRows, probs_host, n_probs, N, KM, out_dim, nullptr,
                       wsel, gout, dS, wsel_len, ws, ws_len, s));
  a.x = x; a.cx = cx; a.sh = sh; a.csh = csh; a.w = w; a.cw = cw;
  a.rows = scratch; a.pieces = pieces;
  EXT_TRY(dst_walk<true>(a, tb, s));
  EXT_TRY(mix_rows(scratch, N, KM, wsel, probs_host, n_probs, c_g, out_dim,
                   s));
  EXT_TRY(mix_products(kMixWeights, probs_host, n_probs, N, KM, out_dim,
                       scratch, nullptr, gout, c_m, wsel_len, ws, ws_len, s));
  a.perm = src_perm; a.ptr = src_ptr; a.dS = dS; a.rows = dxp;
  a.dw = c_w; a.part = part;
  EXT_TRY(src_walk<true>(a, tb, c_x, c_s, s));
  return (int)cudaGetLastError();
}
