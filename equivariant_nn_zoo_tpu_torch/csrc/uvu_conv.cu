// Per-edge uvu tensor-product convolution without the edge sum, forward
// (K6) and backward (K6b).
//
// The forward replaces the TPU kernel PallasUVUConv._fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/fused_conv.py (the body at :233,
// launched from _pallas_fn at :409), whose only live use is the neighbor
// conv of the hamiltonian head (Pairwise, reduce=False).  It computes, per
// edge e and with no reduction over edges,
//
//   S[e, p, m3, u] = w[e, wcol(p) + u]
//                    * sum_nz C_p * x[src_e, x_off(p) + u * d1 + m1]
//                                 * sh[e, j0(p) + m2]
//   out[e, c(io) + j * d3 + m3] = sum_{p in g} sum_u S[e, p, m3, u]
//                                 * wsel_{g,io}[k(p) * mul + u, j]
//
// over the CG paths p, sorted by output irrep and cut into output-irrep
// groups g (K1's tables, ops/cuda/full_conv.py ConvTables), the path
// weights folded into the host-built wigner_3j non-zeros C and the mix
// Linear's alphas into wsel.  The TPU kernel receives x already gathered
// by XLA and keeps its (u, e) lanes, 128-lane padding and dense C2
// operator for the MXU; here the gather is an indexed load, the CG
// contraction walks the non-zeros and the unmixed S never goes to device
// memory.  An edge whose source lies outside [0, N) reads x as zero.
//
// uvu_fwd_kernel (K6) is K5's fused forward (pairwise_tp.cu) on K6's
// operands: a block is one unit, (group g, output slot io, a set of g's
// components, a tile of kFT edges), over the same host tables
// (ops/cuda/pairwise_tp.py fused_tables and forward_plan, on ConvTables'
// path table).  Its K loop runs over chunks of kFKC channels and, inside
// each, g's paths.  A step stages the path's x rows of those channels
// (gathered at src, zero-filled past E and outside [0, N)), its radial
// weights w, its kFKC x wo slice of wsel and its non-zeros, one step ahead
// into the other of two buffers; every thread makes its values of the
// unit's S tiles from the non-zeros' m3 runs, (C * sh[m2]) * x summed and
// times w, into shared memory; the tensor cores multiply the tiles by the
// wsel slice (cg_tile.cuh, 3xTF32 mma.sync) into one register accumulator
// per component, and each output column is stored once.  No scratch, no
// atomics, no memset.  K5's unit is reused rather than templated because
// the operands differ beyond their staging: K6 gathers x by source, folds
// w per (path, channel) and sh per m2, and makes a value of S with one
// multiply-add per non-zero and channel where K5 takes two products.
//
// The backward replaces PallasUVUConv._bwd_kernel (fused_conv.py:278,
// launched at :447), which recomputes the forward's mid instead of saving
// it.  Given gout = dL/dout it returns dwsel, dx [N, in_dim], dsh [E, J]
// and dw [E, P * mul] from one C entry, with nothing saved by the forward:
//
// 1. dwsel, uvu_dws_kernel: dwsel_{g,io}[k * mul + u, j] = sum_e sum_m3
//    S[e, p, m3, u] * gout[e, c(io) + j * d3 + m3], S made again tile by
//    tile in shared memory as in the forward (K5m's unit on K6's operands:
//    a unit is (path p, slot io, kMKC channels, a chunk of edge tiles);
//    S[m3]^T gout[m3] on the tensor cores).  A chunk's tile is stored once,
//    into dwsel or a workspace whose chunks uvu_chunk_sum_kernel adds in
//    chunk order.
// 2. dx, dsh, dw, uvu_adj_kernel: a unit is (a chunk of consecutive paths
//    of one left irrep, kAKC channels, a tile of kAT edges), on 8 warps.
//    Per path it makes the cotangent of the path's S rows, dS[e, m3, u] =
//    sum_io sum_j gout[e, c(io) + j d3 + m3] wsel_{g,io}[k mul + u, j], on
//    the tensor cores into shared memory (as dS^T = wsel gout^T: one wsel
//    fragment serves every component, whose products are independent
//    chains), then walks the path's non-zeros in two host-sorted orders
//    (ops/cuda/pairwise_tp.py adjoint_tables), with no select per
//    non-zero, while the next path's gout block, wsel rows and w rows are
//    copied in:
//      m1-major: dxe[e, x_off + u d1 + m1] += w * sum C * sh[m2] * dS[m3],
//                a register sum per (channel, m1) over the chunk's paths;
//      m2-major: t[m2] = sum C * x[u d1 + m1] * dS[m3] per channel, then
//                dw[e, wcol + u] = sum_m2 sh[m2] * t[m2] (stored once per
//                path) and dsh[e, j0 + m2] += sum_u w * t[m2], summed over
//                the edge's lanes by shuffles and over the unit's paths in
//                a shared-memory row that one thread per edge owns.
//    Each unit stores its dx columns per edge (dxe) and its dsh row of
//    every edge of its tile into workspaces, once.
// 3. uvu_chunk_sum_kernel adds the units' dsh rows in unit order, and
//    uvu_dx_sum_kernel adds each source node's edges' dxe rows (and each
//    irrep's chunks) in the order of the source-major edge order of
//    ops/cuda/edge_order.py: one owner per (node, column), edges past the
//    order's last run (an endpoint outside [0, N)) checked one by one.
//    No atomics, no memsets: every output repeats bit for bit.
//
// What bounds it on the card: the mix products on the tensor cores in
// 3xTF32 (2 * K * mul * wo FLOPs per edge and product: 4.6 MFLOP at the
// hamiltonian head, K = 560 rows of mul = 64, wo = 64; the forward makes
// one, the backward two) and the CG sweeps from shared memory (2650
// non-zeros x 64 channels per edge, a few operand reads each); the bytes
// moved are x, w, gout and the outputs, ~50 KB per edge.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cg_tile.cuh"
#include "row_mix.cuh"

namespace {

using cgtile::round4;
using cgtile::row_pitch;
using cgtile::stage_lines;
using cgtile::stage_nz;
using rowmix::cp_async4;
using rowmix::cp_async_commit;
using rowmix::cp_async_wait;
using rowmix::mma_tf32;
using rowmix::split_tf32;

constexpr int kMaxD = 9;           // components of an l <= 4 irrep
constexpr int kMaxSh = 16;         // sh columns, at most
constexpr int kMaxWo = 64;         // output multiplicity, at most

// K6: threads of a block, edges x channels of a step (K5's block; twice
// its channels a step: K6's steps are lighter, so fewer barriers pay)
constexpr int kFThreads = 128, kFWarps = kFThreads / 32, kFBlocks = 3;
constexpr int kFT = 16, kFKC = 32;
// thread t makes kFV values of edge t / kFQ: channels t % kFQ + kFQ * i
constexpr int kFV = kFT * kFKC / kFThreads, kFQ = kFKC / kFV;
constexpr int kFN = 8 / kFWarps;   // a warp's 8-wide column tiles
// pitches (floats): S tiles (4 mod 32), the wsel slice (8 mod 32), the
// staged w rows (a warp's 4 edges x 8 lanes on distinct banks)
constexpr int kFSPitch = kFKC + 4;
constexpr int kWPitch = kMaxWo + 8;
constexpr int kFWRow = kFKC + 8;

// K6b stage 1 (dwsel): K5m's shape
constexpr int kMThreads = 256, kMWarps = kMThreads / 32, kMBlocks = 2;
constexpr int kMT = 8, kMKC = 64;
constexpr int kMV = kMT * kMKC / kMThreads, kMQ = kMKC / kMV;
constexpr int kMRows = kMKC / 16, kMN = 8 * kMRows / kMWarps;
constexpr int kMSPitch = kMKC + 8;

// K6b stage 2 (the adjoint sweep): threads, edges x channels of a unit;
// thread t takes edge t / kAQ, channels t % kAQ + kAQ * v
constexpr int kAThreads = 256, kAWarps = kAThreads / 32, kABlocks = 2;
constexpr int kAT = 16, kAKC = 32;
constexpr int kAV = kAT * kAKC / kAThreads, kAQ = kAKC / kAV;
// dS's products: warp w takes channels [16 ((w >> 1) & 1), +16) and edges
// [8 (w & 1), +8) (the MMA's rows and columns) of the components of
// parity w >> 2
static_assert(kAT == 16 && kAKC == 32 && kAWarps == 8,
              "the dS products' warp tiles cover 32 channels x 16 edges");
constexpr int kAM3 = (kMaxD + 1) / 2;   // a warp's components, at most
// pitches: the dS tile and the w rows (16 mod 32: the sweep's 2 edges x
// 16 lanes apart), the staged wsel rows (4 mod 32: the B fragments' 8 rows
// x 4 columns)
constexpr int kADPitch = kAKC + 16;
constexpr int kAWRow = kAKC + 16;
constexpr int kAShPitch = kMaxSh + 1;   // the sweep's 2 edges' sh rows apart
constexpr int kAWtPitch = kMaxWo + 4;
static_assert(kFQ == 8 && kAQ == 16 && kMQ == 32,
              "the thread layouts assume these lane groups");

// table fields (ops/cuda/uvu_conv.py, UVUTables; ops/cuda/pairwise_tp.py,
// FusedTables and AdjointTables)
constexpr int kRuns = 7;                       // fused path: runs of m3
constexpr int kPathFields = kRuns + kMaxD + 1;
constexpr int kFUnitFields = 8;  // p0, n_paths, d3, m3_0, nm3, out_col, wo, b_off
constexpr int kMUnitFields = 5;  // path, out_col, wo, b_off, u0
constexpr int kRunsA = 7, kRunsB = kRunsA + kMaxD + 1;
constexpr int kAdjPathFields = kRunsB + kMaxD + 1;
constexpr int kExtFields = 3;    // wcol, first path-slot, count
constexpr int kSlotFields = 3;   // out_col, wo, b_off of the path
constexpr int kChunkFields = 5;  // x_off, d1, p0, p1, ws_col
constexpr int kAUnitFields = 2;  // chunk, u0
constexpr int kIrrepFields = 4;  // x_off, width, ws_col, chunks

struct FusedArgs {
  const float* x;
  const float* sh;
  const float* w;
  const long long* src;
  const float* wsel;
  const float* gout;
  const int* paths;     // [P, kPathFields]
  const int2* nz;       // (m1 | m2 << 8, coefficient bits), sorted by m3
  const int* wcols;     // [P]: the path's radial-weight column
  const int* units;     // K6: [U, kFUnitFields]; dwsel: [U, kMUnitFields]
  float* out;           // K6: out; dwsel: dwsel or its chunks' workspace
  int N, E, in_dim, J, PC, mul, out_dim, wsel_len;
  int max_nz, max_paths, a_pitch, g_pitch, chunk_tiles;
};

// stage a tile's sh rows [rows][pitch] by 4-byte cp.async, zeros past
// the tile's live edges and past J
__device__ __forceinline__ void stage_sh(float* dst, const float* sh, int J,
                                         int m0, int live, int rows,
                                         int pitch) {
  for (int i = threadIdx.x; i < rows * kMaxSh; i += blockDim.x) {
    const int r = i / kMaxSh, j = i - r * kMaxSh;
    const bool ok = r < live && j < J;
    cp_async4(dst + r * pitch + j, ok ? sh + (size_t)(m0 + r) * J + j : sh,
              ok ? 4 : 0);
  }
}

// x's row of edge m (its source's), or null past E or outside [0, N)
template <class Args>
__device__ __forceinline__ const float* x_row(const Args& p, int m) {
  const long long s = m < p.E ? p.src[m] : -1;
  return s >= 0 && s < p.N ? p.x + (size_t)s * p.in_dim : nullptr;
}

// V values of a path's S tile at one component: channels c + CS * i of
// one edge, whose staged x row (at channel c, m1 minor) is xr, w row (at
// channel c) wr and sh row shr, over the run [z, z1) of this component.
template <int CS, int V>
__device__ __forceinline__ void s_run(const int2* zs, int z, int z1,
                                      const float* xr, const float* wr,
                                      const float* shr, int d1,
                                      float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.f;
#pragma unroll 4
  for (; z < z1; ++z) {
    const int2 e = zs[z];
    const float cs = __int_as_float(e.y) * shr[e.x >> 8];
    const float* a = xr + (e.x & 0xff);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += cs * a[i * CS * d1];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] *= wr[i * CS];
}

// K6, one unit: the components [m3_0, m3_0 + NM3) of group g, output slot
// io, edges [kFT * blockIdx.x, +kFT).  K steps: channels [kFKC * c, +kFKC)
// of path k of g, c-major, so that consecutive steps of one left irrep
// share its staged x rows.  Warp w owns kFN 8-wide MMA tiles of output
// columns, from 8 kFN w, for each of the NM3 components.
template <int NM3>
__device__ __forceinline__ void fwd_unit(const FusedArgs& p, float* smem,
                                         const int* un) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = un[0], n_paths = un[1], d3 = un[2], m3_0 = un[3];
  const int out_col = un[5], wo = un[6], b_off = un[7];
  const int m0 = blockIdx.x * kFT, live = min(kFT, p.E - m0);
  const int steps = n_paths * ((p.mul + kFKC - 1) / kFKC);

  // the unit's path rows and radial-weight columns, the tile's sh rows;
  // two buffers each of a path's non-zeros, x rows, w rows and wsel
  // slice; the S tiles
  int* ps = reinterpret_cast<int*>(smem);
  int* wc = ps + round4(p.max_paths * kPathFields);
  float* shs = reinterpret_cast<float*>(wc + round4(p.max_paths));
  int2* zs = reinterpret_cast<int2*>(shs + kFT * kMaxSh);
  float* as = reinterpret_cast<float*>(zs + 2 * p.max_nz);
  float* ws = as + 2 * kFT * p.a_pitch;
  float* wt = ws + 2 * kFT * kFWRow;
  float* ss = wt + 2 * kFKC * kWPitch;

  for (int i = tid; i < n_paths * kPathFields; i += kFThreads)
    ps[i] = p.paths[(size_t)p0 * kPathFields + i];
  for (int i = tid; i < n_paths; i += kFThreads) wc[i] = p.wcols[p0 + i];
  stage_sh(shs, p.sh, p.J, m0, live, kFT, kMaxSh);
  __syncthreads();

  // whether step s's left irrep differs from step s - 1's
  auto new_left = [&](int s) {
    const int k = s % n_paths;
    return k == 0 || ps[k * kPathFields] != ps[(k - 1) * kPathFields];
  };
  // stage step s into buffer s & 1 (its x rows into buffer a_buf)
  auto stage = [&](int s, int a_buf) {
    const int c = s / n_paths, k = s - c * n_paths, u0 = c * kFKC;
    const int buf = s & 1;
    const int* pi = ps + k * kPathFields;
    const int x_off = pi[0], d1 = pi[1];
    const int vch = min(kFKC, p.mul - u0);
    if (new_left(s)) {
      float* ad = as + a_buf * kFT * p.a_pitch;
      stage_lines(
          kFT, kFKC * d1, vch * d1, p.x,
          [&](int e) {
            const float* xr = e < live ? x_row(p, m0 + e) : nullptr;
            return xr ? xr + x_off + u0 * d1 : nullptr;
          },
          [&](int e) { return ad + e * p.a_pitch; });
    }
    const int wcol = wc[k] + u0;
    stage_lines(
        kFT, kFKC, vch, p.w,
        [&](int e) {
          return e < live ? p.w + (size_t)(m0 + e) * p.PC + wcol : nullptr;
        },
        [&](int e) { return ws + (buf * kFT + e) * kFWRow; });
    const float* w0 = p.wsel + b_off + ((size_t)k * p.mul + u0) * wo;
    float* wd = wt + buf * kFKC * kWPitch;
    stage_lines(
        kFKC, wo, wo, p.wsel,
        [&](int r) { return r < vch ? w0 + (size_t)r * wo : nullptr; },
        [&](int r) { return wd + r * kWPitch; });
    stage_nz(zs + buf * p.max_nz, p.nz, pi[5], pi[6]);
  };

  const int e = tid / kFQ, q = tid % kFQ;
  const int n0 = 8 * kFN * warp;
  float acc[NM3][kFN][4];
#pragma unroll
  for (int i = 0; i < NM3; ++i)
#pragma unroll
    for (int n = 0; n < kFN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

  int a_buf = 0;
  stage(0, a_buf);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    const int a_cur = a_buf, buf = s & 1;
    if (s + 1 < steps) {
      if (new_left(s + 1)) a_buf ^= 1;
      stage(s + 1, a_buf);
      cp_async_commit();
    }
    {  // the step's S tiles, from the path's runs of its components
      const int* pi = ps + (s % n_paths) * kPathFields;
      const int d1 = pi[1];
      const float* xr = as + (a_cur * kFT + e) * p.a_pitch + q * d1;
      const float* wr = ws + (buf * kFT + e) * kFWRow + q;
      const float* shr = shs + e * kMaxSh + pi[2];
      const int2* zb = zs + buf * p.max_nz;
#pragma unroll
      for (int i = 0; i < NM3; ++i) {
        float v[kFV];
        s_run<kFQ>(zb, pi[kRuns + m3_0 + i], pi[kRuns + m3_0 + i + 1], xr, wr,
                   shr, d1, v);
        float* sr = ss + (i * kFT + e) * kFSPitch + q;
#pragma unroll
        for (int j = 0; j < kFV; ++j) sr[j * kFQ] = v[j];
      }
    }
    __syncthreads();
    if (n0 < wo) {
      const float* wb = wt + buf * kFKC * kWPitch;
#pragma unroll
      for (int kk = 0; kk < kFKC; kk += 8)
        cgtile::mix_step(acc, ss, kFT, kFSPitch, wb, kWPitch, kk, n0, lane);
    }
  }
  cgtile::store_cols(acc, p.out, p.out_dim, m0, live, out_col, d3, m3_0, wo,
                     n0, lane);
}

// grid: (edge tiles, units); kFThreads threads
__global__ void __launch_bounds__(kFThreads, kFBlocks)
    uvu_fwd_kernel(const FusedArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int* un = p.units + blockIdx.y * kFUnitFields;
  switch (un[4]) {
    case 1: fwd_unit<1>(p, smem, un); break;
    case 2: fwd_unit<2>(p, smem, un); break;
    case 3: fwd_unit<3>(p, smem, un); break;
    case 4: fwd_unit<4>(p, smem, un); break;
    case 5: fwd_unit<5>(p, smem, un); break;
    case 6: fwd_unit<6>(p, smem, un); break;
    case 7: fwd_unit<7>(p, smem, un); break;
    case 8: fwd_unit<8>(p, smem, un); break;
    case 9: fwd_unit<9>(p, smem, un); break;
  }
}

// K6b's dwsel, one unit: path p, output slot io, channels [u0, u0 +
// kMKC), the edge tiles [chunk_tiles * blockIdx.y, +chunk_tiles).  Per
// tile of kMT edges: the path's d3 S tiles, then acc[u, j] += sum_m3
// S[m3]^T gout[m3].  A tile's x, w and sh rows are staged a tile ahead
// into the other of two buffers, its gout rows while the tile before is
// being made (K5m's schedule).
__device__ __forceinline__ void dws_unit(const FusedArgs& p, float* smem,
                                         const int* un) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int path = un[0], out_col = un[1], wo = un[2], b_off = un[3];
  const int u0 = un[4];
  const int n_tiles = (p.E + kMT - 1) / kMT;
  const int t0 = blockIdx.y * p.chunk_tiles;
  const int t1 = min(n_tiles, t0 + p.chunk_tiles);

  // the path row, its non-zeros; two buffers of a tile's x, w and sh rows;
  // its gout rows; the S tiles
  int* ps = reinterpret_cast<int*>(smem);
  int2* zs = reinterpret_cast<int2*>(ps + round4(kPathFields));
  float* as = reinterpret_cast<float*>(zs + p.max_nz);
  float* ws = as + 2 * kMT * p.a_pitch;
  float* shs = ws + 2 * kMT * kMKC;
  float* gs = shs + 2 * kMT * kMaxSh;
  float* ss = gs + kMT * p.g_pitch;

  const int* pg = p.paths + (size_t)path * kPathFields;
  if (tid < kPathFields) ps[tid] = pg[tid];
  const int x_off = pg[0], d1 = pg[1], d3 = pg[4];
  const int wcol = p.wcols[path] + u0;
  const int vch = min(kMKC, p.mul - u0);
  stage_nz(zs, p.nz, pg[5], pg[6]);

  auto stage_rows = [&](int t) {
    const int m0 = t * kMT, live = min(kMT, p.E - m0);
    float* ad = as + (t & 1) * kMT * p.a_pitch;
    stage_lines(
        kMT, kMKC * d1, vch * d1, p.x,
        [&](int e) {
          const float* xr = e < live ? x_row(p, m0 + e) : nullptr;
          return xr ? xr + x_off + u0 * d1 : nullptr;
        },
        [&](int e) { return ad + e * p.a_pitch; });
    stage_lines(
        kMT, kMKC, vch, p.w,
        [&](int e) {
          return e < live ? p.w + (size_t)(m0 + e) * p.PC + wcol : nullptr;
        },
        [&](int e) { return ws + ((t & 1) * kMT + e) * kMKC; });
    stage_sh(shs + (t & 1) * kMT * kMaxSh, p.sh, p.J, m0, live, kMT,
             kMaxSh);
  };
  auto stage_gout = [&](int t) {
    const int m0 = t * kMT, live = min(kMT, p.E - m0);
    stage_lines(
        kMT, wo * d3, wo * d3, p.gout,
        [&](int e) {
          return e < live ? p.gout + (size_t)(m0 + e) * p.out_dim + out_col
                          : nullptr;
        },
        [&](int e) { return gs + e * p.g_pitch; });
  };

  const int e = tid / kMQ, q = tid % kMQ;
  const int wr = 16 * (warp % kMRows), wc = 8 * kMN * (warp / kMRows);
  float acc[kMN][4];
#pragma unroll
  for (int n = 0; n < kMN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  // copy groups: rows(t0) with the non-zeros, gout(t0); then per tile
  // rows(t + 1) while S(t) is made, gout(t + 1) after the tile's MMAs
  if (t0 < t1) stage_rows(t0);
  cp_async_commit();
  if (t0 < t1) stage_gout(t0);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<1>();     // rows(t); gout(t) may still be in flight
    __syncthreads();
    if (t + 1 < t1) stage_rows(t + 1);
    cp_async_commit();
    {  // the tile's S[m3], every component of the path
      const float* xr = as + ((t & 1) * kMT + e) * p.a_pitch + q * d1;
      const float* wrow = ws + ((t & 1) * kMT + e) * kMKC + q;
      const float* shr = shs + ((t & 1) * kMT + e) * kMaxSh + pg[2];
      for (int m3 = 0; m3 < d3; ++m3) {
        float v[kMV];
        s_run<kMQ>(zs, ps[kRuns + m3], ps[kRuns + m3 + 1], xr, wrow, shr, d1,
                   v);
        float* sr = ss + (m3 * kMT + e) * kMSPitch + q;
#pragma unroll
        for (int j = 0; j < kMV; ++j) sr[j * kMQ] = v[j];
      }
    }
    cp_async_wait<1>();     // gout(t); rows(t + 1) may still be in flight
    __syncthreads();
    for (int m3 = 0; m3 < d3; ++m3)
      cgtile::dws_step(acc, ss, kMT, kMSPitch, gs, p.g_pitch, d3, m3, wr, wc,
                       wo, lane);
    __syncthreads();
    if (t + 1 < t1) stage_gout(t + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the unit's tile, once: into dwsel or the chunk's part of the workspace
  float* dst = p.out + (size_t)blockIdx.y * (gridDim.y > 1 ? p.wsel_len : 0) +
               b_off;
  cgtile::store_dws(acc, dst, p.mul, u0, wr, wc, wo, lane);
}

// grid: (units, edge chunks); kMThreads threads
__global__ void __launch_bounds__(kMThreads, kMBlocks)
    uvu_dws_kernel(const FusedArgs p) {
  extern __shared__ __align__(16) float smem[];
  dws_unit(p, smem, p.units + blockIdx.x * kMUnitFields);
}

// out[i] = the sum of the chunks' ws[k * len + i], in chunk order (dwsel's
// edge chunks; dsh's units)
__global__ void uvu_chunk_sum_kernel(const float* __restrict__ ws, int n,
                                     int len, float* __restrict__ out) {
  cgtile::chunk_sum(ws, n, len, out);
}

struct AdjArgs {
  const float* x;
  const float* sh;
  const float* w;
  const long long* src;
  const float* wsel;
  const float* gout;
  const int* paths;     // [P, kAdjPathFields], left-irrep order
  const int* ext;       // [P, kExtFields]
  const int* slots;     // [path-slots, kSlotFields]
  const int2* nz;       // [2][n_nz]: (first | m3 << 8, coefficient bits)
  const int* chunks;    // [n_chunks, kChunkFields]
  const int* units;     // [n_units, kAUnitFields]
  float* dw;
  float* dx_ws;         // per-edge dx columns of every chunk
  float* dsh_ws;        // [n_units, E, J]: each unit's dsh rows
  int N, E, in_dim, J, PC, mul, out_dim, n_nz;
  int max_nz, max_paths, a_pitch, g_pitch;
};

// K6b's adjoint sweep, one unit: the chunk's paths (one left irrep of D1
// components), channels [u0, u0 + kAKC), edges [kAT * blockIdx.y, +kAT).
template <int D1>
__device__ __forceinline__ void adj_unit(const AdjArgs& p, float* smem,
                                         const int* un) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int* ch = p.chunks + un[0] * kChunkFields;
  const int x_off = ch[0], p0 = ch[2], n_p = ch[3] - ch[2], ws_col = ch[4];
  const int u0 = un[1];
  const int m0 = blockIdx.y * kAT, live = min(kAT, p.E - m0);
  const int vch = min(kAKC, p.mul - u0);
  const int* P0 = p.paths + (size_t)p0 * kAdjPathFields;
  const int z_base = P0[5];
  const int n_z = P0[(n_p - 1) * kAdjPathFields + 6] - z_base;

  // the chunk's path rows and non-zeros in both orders; the tile's sh rows
  // and dsh accumulators; its x rows of the irrep; two buffers of a path's
  // w rows; a slot's gout block and wsel rows; the dS tiles
  int* ps = reinterpret_cast<int*>(smem);
  int2* ta = reinterpret_cast<int2*>(ps + round4(p.max_paths * kAdjPathFields));
  int2* tb = ta + p.max_nz;
  float* shs = reinterpret_cast<float*>(tb + p.max_nz);
  float* dsh_s = shs + kAT * kAShPitch;
  float* xs = dsh_s + kAT * kMaxSh;
  float* wrs = xs + kAT * p.a_pitch;
  float* gs = wrs + 2 * kAT * kAWRow;
  float* wt = gs + kAT * p.g_pitch;
  float* ds = wt + kAKC * kAWtPitch;

  stage_lines(
      kAT, kAKC * D1, vch * D1, p.x,
      [&](int e) {
        const float* xr = e < live ? x_row(p, m0 + e) : nullptr;
        return xr ? xr + x_off + u0 * D1 : nullptr;
      },
      [&](int e) { return xs + e * p.a_pitch; });
  stage_sh(shs, p.sh, p.J, m0, live, kAT, kAShPitch);
  cp_async_commit();
  for (int i = tid; i < n_p * kAdjPathFields; i += kAThreads) ps[i] = P0[i];
  for (int i = tid; i < n_z; i += kAThreads) {
    ta[i] = p.nz[z_base + i];
    tb[i] = p.nz[p.n_nz + z_base + i];
  }
  for (int i = tid; i < kAT * kMaxSh; i += kAThreads) dsh_s[i] = 0.f;
  __syncthreads();

  const int e = tid / kAQ, q = tid % kAQ;
  float dxl[D1][kAV];
#pragma unroll
  for (int i = 0; i < D1; ++i)
#pragma unroll
    for (int v = 0; v < kAV; ++v) dxl[i][v] = 0.f;

  // A path's copies go in stages, one per slot of its group (at least
  // one): the first also stages its w rows, into the buffer of the path's
  // parity.  The next stage is issued as soon as the MMAs have read the
  // current one, so that its copies overlap the current path's sweep.
  auto stage = [&](int k, int si) {
    const int d3 = ps[k * kAdjPathFields + 4];
    const int* ext = p.ext + (size_t)(p0 + k) * kExtFields;
    if (si == 0) {
      const int wcol = ext[0] + u0;
      float* wd = wrs + (k & 1) * kAT * kAWRow;
      stage_lines(
          kAT, kAKC, vch, p.w,
          [&](int r) {
            return r < live ? p.w + (size_t)(m0 + r) * p.PC + wcol : nullptr;
          },
          [&](int r) { return wd + r * kAWRow; });
    }
    if (si < ext[2]) {
      const int* sl = p.slots + (size_t)(ext[1] + si) * kSlotFields;
      const int out_col = sl[0], wo = sl[1];
      const float* w0 = p.wsel + sl[2] + (size_t)u0 * wo;
      stage_lines(
          kAT, wo * d3, wo * d3, p.gout,
          [&](int r) {
            return r < live ? p.gout + (size_t)(m0 + r) * p.out_dim + out_col
                            : nullptr;
          },
          [&](int r) { return gs + r * p.g_pitch; });
      stage_lines(
          kAKC, wo, wo, p.wsel,
          [&](int r) { return r < vch ? w0 + (size_t)r * wo : nullptr; },
          [&](int r) { return wt + r * kAWtPitch; });
    }
  };
  stage(0, 0);
  cp_async_commit();

  for (int k = 0; k < n_p; ++k) {
    const int* pi = ps + k * kAdjPathFields;
    const int j0 = pi[0], d2 = pi[1], d3 = pi[4];
    const int* ext = p.ext + (size_t)(p0 + k) * kExtFields;
    const int wcol = ext[0] + u0, s0 = ext[1], n_slots = ext[2];
    const int n_stages = max(n_slots, 1);
    const int ur = 16 * ((warp >> 1) & 1), ec = 8 * (warp & 1);
    const int par = warp >> 2;

    // dS[m3][e][u] = sum over the group's slots of gout x wsel^T (zero for
    // a group that the mix does not read), as dS^T[u][e] = sum_j
    // wsel[u][j] gout[e][j d3 + m3]: a wsel fragment serves every
    // component, whose products are independent chains
    float acc[kAM3][4];
#pragma unroll
    for (int i = 0; i < kAM3; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int si = 0; si < n_stages; ++si) {
      cp_async_wait<0>();
      __syncthreads();
      if (si < n_slots) {
        const int wo = p.slots[(size_t)(s0 + si) * kSlotFields + 1];
        for (int kk = 0; kk < wo; kk += 8) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int h = 0; h < 4; ++h)
            split_tf32(wt[(ur + g + 8 * (h & 1)) * kAWtPitch + kk + q4 +
                          4 * (h >> 1)],
                       ah[h], al[h]);
          const float* gb = gs + (ec + g) * p.g_pitch + (kk + q4) * d3 + par;
#pragma unroll
          for (int i = 0; i < kAM3; ++i) {
            if (par + 2 * i >= d3) break;
            uint32_t bh[2], bl[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              split_tf32(gb[4 * h * d3 + 2 * i], bh[h], bl[h]);
            mma_tf32(acc[i], al, bh);
            mma_tf32(acc[i], ah, bl);
            mma_tf32(acc[i], ah, bh);
          }
        }
      }
      __syncthreads();   // gs and wt are read: the next stage may land
      if (si + 1 < n_stages)
        stage(k, si + 1);
      else if (k + 1 < n_p)
        stage(k + 1, 0);
      cp_async_commit();
    }
    // the C fragments: channels ur + g (+ 8), edges ec + 2 q4 (+ 1), of
    // component par + 2 i
#pragma unroll
    for (int i = 0; i < kAM3; ++i) {
      const int m3 = par + 2 * i;
      if (m3 >= d3) break;
      float* d = ds + (m3 * kAT + ec + 2 * q4) * kADPitch + ur + g;
      d[0] = acc[i][0];
      d[kADPitch] = acc[i][1];
      d[8] = acc[i][2];
      d[kADPitch + 8] = acc[i][3];
    }
    __syncthreads();

    {  // the sweep: dx by runs of equal m1, dsh and dw by runs of equal m2
      float wv[kAV];
#pragma unroll
      for (int v = 0; v < kAV; ++v)
        wv[v] = wrs[((k & 1) * kAT + e) * kAWRow + q + kAQ * v];
      const float* shr = shs + e * kAShPitch + j0;
      const float* xr = xs + e * p.a_pitch + q * D1;
      const float* dsr = ds + e * kADPitch + q;
#pragma unroll
      for (int i = 0; i < D1; ++i) {
        float a[kAV];
#pragma unroll
        for (int v = 0; v < kAV; ++v) a[v] = 0.f;
        const int z1 = pi[kRunsA + 1 + i] - z_base;
#pragma unroll 2
        for (int z = pi[kRunsA + i] - z_base; z < z1; ++z) {
          const int2 t = ta[z];
          const float cs = __int_as_float(t.y) * shr[t.x & 0xff];
          const float* dr = dsr + (t.x >> 8) * (kAT * kADPitch);
#pragma unroll
          for (int v = 0; v < kAV; ++v) a[v] += cs * dr[kAQ * v];
        }
#pragma unroll
        for (int v = 0; v < kAV; ++v) dxl[i][v] += wv[v] * a[v];
      }
      float dwv[kAV];
#pragma unroll
      for (int v = 0; v < kAV; ++v) dwv[v] = 0.f;
      for (int i = 0; i < d2; ++i) {
        float t2[kAV];
#pragma unroll
        for (int v = 0; v < kAV; ++v) t2[v] = 0.f;
        const int z1 = pi[kRunsB + 1 + i] - z_base;
#pragma unroll 2
        for (int z = pi[kRunsB + i] - z_base; z < z1; ++z) {
          const int2 t = tb[z];
          const float c = __int_as_float(t.y);
          const float* xa1 = xr + (t.x & 0xff);
          const float* dr = dsr + (t.x >> 8) * (kAT * kADPitch);
#pragma unroll
          for (int v = 0; v < kAV; ++v)
            t2[v] += c * xa1[kAQ * v * D1] * dr[kAQ * v];
        }
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < kAV; ++v) {
          dwv[v] += shr[i] * t2[v];
          part += wv[v] * t2[v];
        }
        // over the edge's kAQ lanes, then into its row (one owner: lane 0)
#pragma unroll
        for (int off = kAQ / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (q == 0) dsh_s[e * kMaxSh + j0 + i] += part;
      }
      if (e < live) {
#pragma unroll
        for (int v = 0; v < kAV; ++v)
          if (q + kAQ * v < vch)
            p.dw[(size_t)(m0 + e) * p.PC + wcol + q + kAQ * v] = dwv[v];
      }
    }
  }

  // the unit's dx columns of each edge, once
  if (e < live) {
    float* out = p.dx_ws + (size_t)p.E * ws_col +
                 (size_t)(m0 + e) * p.mul * D1 + (size_t)(u0 + q) * D1;
#pragma unroll
    for (int v = 0; v < kAV; ++v)
      if (q + kAQ * v < vch)
#pragma unroll
        for (int i = 0; i < D1; ++i) out[kAQ * v * D1 + i] = dxl[i][v];
  }
  // and its dsh row of each edge, once every lane 0 has added its last
  __syncthreads();
  for (int i = tid; i < kAT * p.J; i += kAThreads) {
    const int r = i / p.J, j = i - r * p.J;
    if (r < live)
      p.dsh_ws[((size_t)blockIdx.x * p.E + m0 + r) * p.J + j] =
          dsh_s[r * kMaxSh + j];
  }
}

// grid: (units, edge tiles); kAThreads threads
__global__ void __launch_bounds__(kAThreads, kABlocks)
    uvu_adj_kernel(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int* un = p.units + blockIdx.x * kAUnitFields;
  switch (p.chunks[un[0] * kChunkFields + 1]) {
    case 1: adj_unit<1>(p, smem, un); break;
    case 3: adj_unit<3>(p, smem, un); break;
    case 5: adj_unit<5>(p, smem, un); break;
    case 7: adj_unit<7>(p, smem, un); break;
    case 9: adj_unit<9>(p, smem, un); break;
  }
}

// dx[n, col] = the sum over source node n's edges, in the source-major
// edge order (then those past its last run whose source is n, in order),
// of each of col's irrep's chunks' dx columns, in chunk order; zeros for
// an irrep that no path reads.  irreps [n_irreps, kIrrepFields] in column
// order, covering [0, in_dim).
__global__ void uvu_dx_sum_kernel(const float* __restrict__ ws,
                                  const int* __restrict__ irreps,
                                  int n_irreps,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ ptr,
                                  const long long* __restrict__ src, int N,
                                  int E, int in_dim, float* __restrict__ dx) {
  const long long total = (long long)N * in_dim;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i / in_dim), col = (int)(i - (long long)n * in_dim);
    int r = 0;
    while (r + 1 < n_irreps && irreps[(r + 1) * kIrrepFields] <= col) ++r;
    const int* ir = irreps + r * kIrrepFields;
    const int width = ir[1], n_chunks = ir[3];
    const float* base = ws + (size_t)E * ir[2] + (col - ir[0]);
    float s = 0.f;
    auto add = [&](int e) {
      for (int k = 0; k < n_chunks; ++k)
        s += base[(size_t)E * k * width + (size_t)e * width];
    };
    for (int pos = ptr[n]; pos < ptr[n + 1]; ++pos) add(perm[pos]);
    for (int pos = ptr[N]; pos < E; ++pos)
      if (src[perm[pos]] == n) add(perm[pos]);
    dx[i] = s;
  }
}

template <class Kernel, class Args>
static cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                          const Args& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

static inline int blocks_for(long long n, int threads) {
  return (int)std::max(1LL, std::min(4096LL, (n + threads - 1) / threads));
}

// dims: max d1, d2, d3, non-zeros of a path (even), wo, paths of a group
static bool dims_ok(const int* dims, int mul, int J) {
  return dims[0] >= 1 && dims[0] <= kMaxD && dims[1] >= 1 &&
         dims[1] <= kMaxD && dims[2] >= 1 && dims[2] <= kMaxD &&
         dims[3] % 2 == 0 && dims[4] % 8 == 0 && dims[4] <= kMaxWo &&
         mul % 4 == 0 && mul >= 4 && J >= 1 && J <= kMaxSh;
}

}  // namespace

// K6.  paths, nz, dims: the fused tables (ops/cuda/pairwise_tp.py,
// FusedTables, of the conv's path table) on the device and, for dims, the
// host; wcols [P]: the paths' radial-weight columns; units [n_units,
// kFUnitFields]: the cut of the groups' components that the wrapper chose
// for E.  Every output column of a mix problem is stored once by one unit
// (the wrapper zero-fills the columns of none).
extern "C" int uvu_conv_fwd(
    const float* x, int N, int in_dim, const float* sh, int J, const float* w,
    int PC, const long long* src, int E, const int* paths, const int* nz,
    const int* dims, const int* wcols, const int* units, int n_units, int mul,
    const float* wsel, float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || n_units <= 0) return (int)cudaGetLastError();
  if (!dims_ok(dims, mul, J) || n_units > 65535)
    return (int)cudaErrorInvalidValue;
  FusedArgs p{x, sh, w, src, wsel, nullptr, paths,
              reinterpret_cast<const int2*>(nz), wcols, units, out,
              N, E, in_dim, J, PC, mul, out_dim, 0};
  p.max_nz = dims[3];
  p.max_paths = dims[5];
  p.a_pitch = row_pitch(kFKC * dims[0], kFQ % 32);
  const size_t floats =
      round4(p.max_paths * kPathFields) + round4(p.max_paths) +
      kFT * kMaxSh + 2 * (size_t)p.max_nz * 2 +
      2 * ((size_t)kFT * (p.a_pitch + kFWRow) + kFKC * kWPitch) +
      (size_t)dims[2] * kFT * kFSPitch;
  return (int)launch(uvu_fwd_kernel, dim3((E + kFT - 1) / kFT, n_units),
                     kFThreads, floats * sizeof(float), p, s);
}

// K6b.  paths, nz, dims, wcols: as for uvu_conv_fwd; dws_units
// [n_dws_units, kMUnitFields] over chunks of dws_chunk_tiles edge tiles
// (dws_ws: their partial dwsel, wsel_len floats per chunk, where there are
// several).  The adjoint sweep's tables (ops/cuda/uvu_conv.py, UVUTables):
// adj_paths [P, kAdjPathFields] and their non-zeros in two orders
// (adj_n_nz each), adj_ext [P, kExtFields], adj_slots; one cut's chunks
// (device and host copies), units [n_adj_units, kAUnitFields] and irreps
// [n_irreps, kIrrepFields]; adj_dims (host): the most paths and non-zeros
// of a chunk, d1, d3 and wo.  dx_ws: each chunk's dx columns per edge;
// dsh_ws: each unit's dsh rows [n_adj_units, E, J].  src_perm, src_ptr:
// the source-major edge order of ops/cuda/edge_order.py.  Every output
// element has one owner that stores it once: no atomics, no memsets.
extern "C" int uvu_conv_bwd(
    const float* x, int N, int in_dim, const float* sh, int J, const float* w,
    int PC, const long long* src, int E, const int* paths, const int* nz,
    const int* dims, const int* wcols, const int* dws_units, int n_dws_units,
    int dws_chunk_tiles, const int* adj_paths, const int* adj_ext,
    const int* adj_slots, const int* adj_nz, int adj_n_nz,
    const int* adj_chunks, const int* adj_units, int n_adj_units,
    const int* irreps, int n_irreps, const int* adj_dims,
    const int* src_perm, const int* src_ptr, int mul, const float* wsel,
    int wsel_len, const float* gout, int out_dim, float* dx, float* dsh,
    float* dw, float* dwsel, float* dws_ws, float* dx_ws, float* dsh_ws,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || N <= 0 || n_dws_units <= 0 || n_adj_units <= 0)
    return (int)cudaErrorInvalidValue;   // the wrapper handles these
  const int tiles = (E + kMT - 1) / kMT;
  const int chunks = (tiles + dws_chunk_tiles - 1) / std::max(dws_chunk_tiles, 1);
  if (!dims_ok(dims, mul, J) || dws_chunk_tiles < 1 || chunks > 65535 ||
      (E + kAT - 1) / kAT > 65535 || adj_dims[2] > kMaxD ||
      adj_dims[3] > kMaxD || adj_dims[4] > kMaxWo ||
      (chunks > 1 && dws_ws == nullptr))
    return (int)cudaErrorInvalidValue;

  // 1. dwsel
  FusedArgs m{x, sh, w, src, wsel, gout, paths,
              reinterpret_cast<const int2*>(nz), wcols, dws_units,
              chunks > 1 ? dws_ws : dwsel, N, E, in_dim, J, PC, mul, out_dim,
              wsel_len};
  m.max_nz = dims[3];
  m.a_pitch = row_pitch(kMKC * dims[0], kMQ % 32);
  m.g_pitch = row_pitch(dims[4] * dims[2], 8);
  m.chunk_tiles = dws_chunk_tiles;
  const size_t m_floats =
      round4(kPathFields) + 2 * (size_t)m.max_nz +
      kMT * (size_t)(2 * m.a_pitch + 2 * kMKC + 2 * kMaxSh + m.g_pitch) +
      (size_t)dims[2] * kMT * kMSPitch;
  cudaError_t err = launch(uvu_dws_kernel, dim3(n_dws_units, chunks),
                           kMThreads, m_floats * sizeof(float), m, s);
  if (err != cudaSuccess) return (int)err;
  if (chunks > 1) {
    uvu_chunk_sum_kernel<<<blocks_for(wsel_len, 256), 256, 0, s>>>(
        dws_ws, chunks, wsel_len, dwsel);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 2. the adjoint sweep: dw, and the dx and dsh partials
  AdjArgs a{x, sh, w, src, wsel, gout, adj_paths, adj_ext, adj_slots,
            reinterpret_cast<const int2*>(adj_nz), adj_chunks, adj_units, dw,
            dx_ws, dsh_ws, N, E, in_dim, J, PC, mul, out_dim, adj_n_nz};
  a.max_paths = adj_dims[0];
  a.max_nz = adj_dims[1] + adj_dims[1] % 2;
  a.a_pitch = row_pitch(kAKC * adj_dims[2], kAQ % 32);
  a.g_pitch = row_pitch(adj_dims[4] * adj_dims[3], 4);
  const size_t a_floats =
      round4(a.max_paths * kAdjPathFields) + 4 * (size_t)a.max_nz +
      kAT * (kAShPitch + kMaxSh) +
      kAT * (size_t)(a.a_pitch + 2 * kAWRow + a.g_pitch) + kAKC * kAWtPitch +
      (size_t)adj_dims[3] * kAT * kADPitch;
  err = launch(uvu_adj_kernel, dim3(n_adj_units, (E + kAT - 1) / kAT),
               kAThreads, a_floats * sizeof(float), a, s);
  if (err != cudaSuccess) return (int)err;

  // 3. dsh and dx, each summed in a fixed order
  uvu_chunk_sum_kernel<<<blocks_for((long long)E * J, 256), 256, 0, s>>>(
      dsh_ws, n_adj_units, E * J, dsh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  uvu_dx_sum_kernel<<<blocks_for((long long)N * in_dim, 256), 256, 0, s>>>(
      dx_ws, irreps, n_irreps, src_perm, src_ptr, src, N, E, in_dim, dx);
  return (int)cudaGetLastError();
}
