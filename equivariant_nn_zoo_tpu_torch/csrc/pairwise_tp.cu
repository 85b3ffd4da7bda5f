// Internal-weight all-uvu tensor-product expansion of the hamiltonian head:
// outer product, CG contraction and mix of PairwiseTP, forward (K5) and
// backward (K5m, K5a, K5b).
//
// The forward replaces the TPU kernel PallasPairwiseTP._fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/pairwise.py (the body at :410, launched
// from _pallas_fn at :642).  As there, stage 1 -- the per-path weighting of
// the right operand, bw_p[m, u, j] = sum_v W_p[u, v] b[m, v, j] -- is a
// plain product outside the kernel (the wrapper's, in PyTorch); the kernel
// computes, per element m,
//
//   S[m, p, m3, u]      = sum_nz C_p * a[m, m1, u] * bw[m, r0(p) + m2, u]
//   out[m, c(io) + j*d + m3] = sum_{p in g} sum_u S[m, p, m3, u] *
//                              wsel_{g,io}[p * mul + u, j]
//
// over the mix-reachable paths p, sorted by output irrep and cut into
// output-irrep groups g, the path weights folded into the host-built
// wigner_3j non-zeros C and the mix Linear's alphas into wsel.  As in the
// TPU kernel, the unmixed S never goes to device memory: it is made one
// path at a time and mixed at once ("only ONE section's mid is live at a
// time", pairwise.py:418-450).  Its dense C2 operators, K8 row padding and
// (u, e) lanes are MXU devices and are not carried over: the contraction
// walks the non-zeros.
//
// pairwise_fwd_kernel (K5): a block is one unit, (group g, output slot io,
// a set of g's components m3, a tile of kFT elements).  Its K loop runs
// over chunks of kFKC channels and, inside each, g's paths (a left irrep's
// paths are consecutive, so they share its staged rows).  A step stages
// the path's left and bw rows of those channels (cp.async, lines past M
// and channels past mul zero-filled), its kFKC x wo slice of wsel and its
// non-zeros, one step ahead into the other of two buffers; every thread
// makes its part of the S tiles of the unit's components from the
// non-zeros, held in shared memory sorted by m3 with run bounds (no table
// load from device memory, no select per non-zero), into shared memory;
// the tensor cores multiply the tiles there into one register accumulator
// per component (3xTF32 mma.sync, row_mix.cuh's fragments).  At the end
// each output column is stored once (the unit's components of one j side
// by side): one owner, no atomics, no memset.  The units hold whole groups
// at large M; at small M the components are split over units (no sum
// needed: they own disjoint columns), so that 49 elements still give 200
// blocks.
//
// What bounds it on the card: bw (R * mul floats per element, 384 KB at
// the full-width head) read once, and the mix on the tensor cores in
// 3xTF32 (12.3 MFLOP per element, three TF32 products each); the CG sweep
// (2 * mul FLOPs per non-zero) runs on the CUDA cores from shared memory.
// Measured, neither: the staging copies (left rows again per group, the
// wsel slices once per tile) and the non-zero loops take turns instead of
// overlapping, and each unit's steps wait at two barriers
// (chip_smoke.py --walk-ablation pairwise_tp.cu).
//
// The backward replaces the three TPU kernels _bwd_kernel_dws,
// _bwd_kernel_da and _bwd_kernel_dbw (pairwise.py:504, :556, :591; launched
// at :655, :670, :684).  Given gout = dL/dout it returns dwsel, da [M, a_dim]
// and dbw [M, R, mul] from one C entry:
//
// 1. K5m, pairwise_dws_kernel: dwsel_{g,io}[p * mul + u, j] =
//    sum_m sum_m3 S[m, p, m3, u] * gout[m, c(io) + j * d + m3], S made
//    again tile by tile as in the forward (1.05 MFLOP per element against
//    12.3 for the mix; a saved S would double what a training step keeps).
//    A block is one unit, (path p, slot io, kMKC channels, a chunk of
//    elements): per tile of kMT elements it stages the path's rows and
//    gout's block of the slot, makes the path's d3 tiles S[m3] in shared
//    memory and adds S[m3]^T gout[m3] on the tensor cores (3xTF32) into a
//    register tile; the tile is stored once per chunk, into dwsel or, where
//    the elements are cut into several chunks, into a workspace whose
//    chunks pairwise_chunk_sum_kernel adds in chunk order.  No atomics.
// 2. rowmix::mix_products (row_mix.cuh, the tensor-core GEMM): dS =
//    gout_q @ wsel_q^T with one owner per tile, which K5a and K5b read (on
//    the TPU each of them recomputes it per section).
// 3. K5a and K5b, pairwise_adj_kernel, one sweep for both cotangents:
//
//      da[m, m1, u]            = sum_p sum_nz C * bw[m, r0(p) + m2, u]
//                                              * dS[m, row(p, m3), u]
//      dbw[m, r0(p) + m2, u]   = sum_nz C * a[m, m1, u] * dS[m, row(p, m3), u]
//
//    over the paths p of a left irrep for da, of one path for a dbw row.
//    The TPU kernels' per-section dense C2T operators and (u, e) lanes are
//    MXU devices and are not carried over.  Units of work are (a tile of
//    elements, a chunk of consecutive paths of one left irrep); the host
//    cuts each irrep's paths into chunks of about equal non-zero count,
//    coarse at large M and fine at small M, where the longest unit bounds
//    the launch.  A unit reads dS, bw and a once for both cotangents,
//    stores each of its dbw rows once and its irrep's d left, or its
//    partial in a workspace where the irrep has several chunks; then
// 4. pairwise_da_sum_kernel adds those partials in chunk order (zeros for
//    an irrep no path reads).  No atomics, no memsets: da and dbw repeat
//    bit for bit.
//
//    Each path's non-zeros come in two host-sorted orders, m1-major for da
//    (a register sum per (channel, m1) over the runs of equal m1, the run
//    loop unrolled over a compile-time d1) and m2-major for dbw (one
//    register sum per run of equal m2, stored when the run ends): no
//    select per non-zero.  The operands are read from shared memory at the
//    non-zeros' offsets.
//
// What bounds the backward: the scratch-sized streams (dS, bw, dbw: 384
// KB per element each) and the mix products (2 x 12.3 MFLOP per element,
// on the tensor cores in 3xTF32).  The adjoint sweep alone moves dS, bw
// and dbw once (1.08 ms of bytes at M = 3072 on an H100); its
// shared-memory reads (two operands per non-zero, order and channel) come
// close, and its speed follows the warps a multiprocessor holds, which its
// shared memory bounds (chip_smoke.py --pw-times, --walk-ablation).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cg_tile.cuh"
#include "row_mix.cuh"

namespace {

using cgtile::div_by;
using cgtile::magic;
using cgtile::round4;
using cgtile::row_pitch;
using cgtile::stage_lines;
using cgtile::stage_nz;
using rowmix::cp_async4;
using rowmix::cp_async_commit;
using rowmix::cp_async_wait;

constexpr int kMaxD = 9;           // components of an l <= 4 irrep

// The forward (K5) and K5m: threads of a block, elements x channels of a
// step, and the fields of their tables (ops/cuda/pairwise_tp.py,
// FusedTables).
constexpr int kFThreads = 128, kFWarps = kFThreads / 32;  // K5's blocks
constexpr int kMThreads = 256, kMWarps = kMThreads / 32;  // K5m's blocks
constexpr int kFBlocks = 3, kMBlocks = 2;  // blocks a multiprocessor holds
constexpr int kFT = 16, kFKC = 16;   // K5: elements of a tile, channels a step
constexpr int kMT = 8, kMKC = 64;    // K5m: elements of a tile, channels a unit
constexpr int kMaxWo = 64;           // output multiplicity, at most
// A thread makes kFV (K5) or kMV (K5m) values of a step's S tiles: element
// t / kFQ, channels t % kFQ + kFQ * i (K5m: kMQ).
constexpr int kFV = kFT * kFKC / kFThreads, kFQ = kFKC / kFV;
constexpr int kMV = kMT * kMKC / kMThreads, kMQ = kMKC / kMV;
static_assert(kFV >= 1 && kMV >= 1 && kFQ <= 32 && kMQ <= 32,
              "a step's S tiles need a value for every thread");
// K5's warps own kFN 8-wide column tiles each; K5m's warps a row block of
// 16 of its channels and kMN column tiles
constexpr int kFN = 8 / kFWarps;
constexpr int kMRows = kMKC / 16, kMN = 8 * kMRows / kMWarps;
// Row pitches (floats) of the tiles that the fragments read: the S tiles
// (K5: rows (component, element), 20 mod 32; K5m: rows (component,
// element) read transposed, 8 mod 32) and K5's wsel slice (rows u, 8 mod
// 32), so that a warp's fragment loads hit 32 distinct banks.  The staged
// left and bw rows take pitches of kFQ (K5) and kMQ (K5m) mod 32: the
// producer's lanes then read distinct banks at every non-zero (the left
// rows at channel stride d1, odd).
constexpr int kFSPitch = kFKC + 4;
constexpr int kMSPitch = kMKC + 8;
constexpr int kWPitch = kMaxWo + 8;
// a path row: x_off, d1, r0, d2, d3, z0, n_z, then the bounds of its runs
// of equal m3, relative to z0 (padded with the last)
constexpr int kFRuns = 7;
constexpr int kFPathFields = kFRuns + kMaxD + 1;
constexpr int kFUnitFields = 8;  // p0, n_paths, d3, m3_0, nm3, out_col, wo, b_off
constexpr int kMUnitFields = 5;  // path, out_col, wo, b_off, u0

// the adjoint sweep: floats of a staged row, rows of a warp's ring, threads
// per block at most, and the fields of its tables (ops/cuda/pairwise_tp.py,
// AdjointTables)
constexpr int kAdjRow = 64;      // floats of a staged row: the warp's lanes
// a warp's ring of staged rows, at least: room for the largest path (18
// rows at l = 4) and little more, so that three blocks of 8 warps share a
// multiprocessor (more warps, not more paths in flight, is what hides the
// sweep's latency)
constexpr int kAdjRingRows = 20;
constexpr int kAdjSlots = 8;     // a warp's paths in flight, at most
constexpr int kAdjThreads = 256;
// a path row: r0, d2, row_base, row_stride, d3, nz0, nz1, then the
// bounds of its runs of equal m1 (order 0) and of equal m2 (order 1)
constexpr int kAdjRunsA = 7, kAdjRunsB = kAdjRunsA + kMaxD + 1;
constexpr int kAdjPathFields = kAdjRunsB + kMaxD + 1;
constexpr int kAdjChunkFields = 5;         // x_off, d1, p0, p1, ws_col
constexpr int kAdjSumFields = 4;           // x_off, width, ws_col, n

struct FusedArgs {
  const float* a;
  const float* bw;
  const float* wsel;
  const float* gout;
  const int* paths;     // [P, kFPathFields]
  const int2* nz;       // (m1 | m2 << 8, coefficient bits), sorted by m3
  const int* units;     // K5: [U, kFUnitFields]; K5m: [U, kMUnitFields]
  float* out;           // K5: out; K5m: dwsel, or the chunks' workspace
  int M, a_dim, R, mul, out_dim, wsel_len;
  int max_nz, max_paths, a_pitch, b_pitch, g_pitch, chunk_tiles;
};

// One thread's V values of a path's S tile at component m3: channels c +
// CS * i of one element, whose staged left row (at channel c, m1 minor, d1
// a channel) is ar and bw rows (at channel c, KC a row) br, summed over the
// path's run [z, z1) of non-zeros of this m3.
template <int KC, int CS, int V>
__device__ __forceinline__ void cg_run(const int2* zs, int z, int z1,
                                       const float* ar, const float* br,
                                       int d1, float (&acc)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (; z < z1; ++z) {
    const int2 e = zs[z];
    const float c = __int_as_float(e.y);
    const float* a = ar + (e.x & 0xff);
    const float* b = br + (e.x >> 8) * KC;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += c * a[i * CS * d1] * b[i * CS];
  }
}

// K5, one unit: the components [m3_0, m3_0 + NM3) of group g, output slot
// io, elements [kFT * blockIdx.x, +kFT).  K steps: channels [kFKC * c,
// +kFKC) of path k of g, c-major, so that consecutive steps of one left
// irrep share its staged rows.  A step's rows (left, where its irrep is
// new; bw; the wsel slice; the non-zeros) are staged one step ahead into
// the other of two buffers.  Thread t makes kFV values of element t / kFQ
// of every S tile; warp w owns kFN 8-wide MMA tiles of output columns,
// from 8 kFN w, for each of the NM3 components.
template <int NM3>
__device__ __forceinline__ void fwd_unit(const FusedArgs& p, float* smem,
                                         const int* un) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = un[0], n_paths = un[1], d3 = un[2], m3_0 = un[3];
  const int out_col = un[5], wo = un[6], b_off = un[7];
  const int m0 = blockIdx.x * kFT, live = min(kFT, p.M - m0);
  const int steps = n_paths * ((p.mul + kFKC - 1) / kFKC);

  // the unit's path rows; two buffers each of a path's non-zeros, left
  // rows, bw rows and wsel slice; the S tiles
  int* ps = reinterpret_cast<int*>(smem);
  int2* zs = reinterpret_cast<int2*>(ps + round4(p.max_paths * kFPathFields));
  float* as = reinterpret_cast<float*>(zs + 2 * p.max_nz);
  float* bs = as + 2 * kFT * p.a_pitch;
  float* wt = bs + 2 * kFT * p.b_pitch;
  float* ss = wt + 2 * kFKC * kWPitch;

  for (int i = tid; i < n_paths * kFPathFields; i += kFThreads)
    ps[i] = p.paths[(size_t)p0 * kFPathFields + i];
  __syncthreads();

  // whether step s's left irrep differs from step s - 1's
  auto new_left = [&](int s) {
    const int k = s % n_paths;
    return k == 0 || ps[k * kFPathFields] != ps[(k - 1) * kFPathFields];
  };
  // stage step s into buffer s & 1 (its left rows into buffer a_buf)
  auto stage = [&](int s, int a_buf) {
    const int c = s / n_paths, k = s - c * n_paths, u0 = c * kFKC;
    const int buf = s & 1;
    const int* pi = ps + k * kFPathFields;
    const int x_off = pi[0], d1 = pi[1], r0 = pi[2], d2 = pi[3];
    const int vch = min(kFKC, p.mul - u0);
    const uint64_t md2 = magic(d2);
    if (new_left(s)) {
      float* ad = as + a_buf * kFT * p.a_pitch;
      stage_lines(
          kFT, kFKC * d1, vch * d1, p.a,
          [&](int e) {
            return e < live ? p.a + (size_t)(m0 + e) * p.a_dim + x_off +
                                  u0 * d1
                            : nullptr;
          },
          [&](int e) { return ad + e * p.a_pitch; });
    }
    float* bd = bs + buf * kFT * p.b_pitch;
    stage_lines(
        kFT * d2, kFKC, vch, p.bw,
        [&](int l) {
          const int e = div_by(l, md2);
          return e < live ? p.bw + ((size_t)(m0 + e) * p.R + r0 + l -
                                    e * d2) * p.mul + u0
                          : nullptr;
        },
        [&](int l) {
          const int e = div_by(l, md2);
          return bd + e * p.b_pitch + (l - e * d2) * kFKC;
        });
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
      const int* pi = ps + (s % n_paths) * kFPathFields;
      const int d1 = pi[1];
      const float* ar = as + a_cur * kFT * p.a_pitch + e * p.a_pitch + q * d1;
      const float* br = bs + buf * kFT * p.b_pitch + e * p.b_pitch + q;
      const int2* zb = zs + buf * p.max_nz;
#pragma unroll
      for (int i = 0; i < NM3; ++i) {
        float v[kFV];
        cg_run<kFKC, kFQ>(zb, pi[kFRuns + m3_0 + i],
                          pi[kFRuns + m3_0 + i + 1], ar, br, d1, v);
        float* sr = ss + (i * kFT + e) * kFSPitch + q;
#pragma unroll
        for (int j = 0; j < kFV; ++j) sr[j * kFQ] = v[j];
      }
    }
    __syncthreads();
    if (n0 < wo) {
      // acc += S tile x wsel slice, the warp's columns
      const float* wb = wt + buf * kFKC * kWPitch;
#pragma unroll
      for (int kk = 0; kk < kFKC; kk += 8)
        cgtile::mix_step(acc, ss, kFT, kFSPitch, wb, kWPitch, kk, n0, lane);
    }
  }

  // each output column once: the unit's components of columns j and j + 1
  // side by side
  cgtile::store_cols(acc, p.out, p.out_dim, m0, live, out_col, d3, m3_0, wo,
                     n0, lane);
}

// grid: (element tiles, units); kFThreads threads
__global__ void __launch_bounds__(kFThreads, kFBlocks)
    pairwise_fwd_kernel(const FusedArgs p) {
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

// K5m, one unit: path p, output slot io, channels [u0, u0 + kMKC), the
// element tiles [chunk_tiles * blockIdx.y, +chunk_tiles).  Per tile of kMT
// elements: the path's d3 S tiles, then acc[u, j] += sum_m3 S[m3]^T
// gout[m3] (one 8-deep MMA step per component).  A tile's left and bw
// rows are staged a tile ahead into the other of two buffers, its gout
// rows while the tile before is being made.  Thread t makes kMV values
// of element t / kMQ of every S tile; warp w owns rows [16 (w % kMRows),
// +16) and kMN 8-wide column tiles, from 8 kMN (w / kMRows), of the
// unit's [kMKC x wo] tile.
__device__ __forceinline__ void dws_unit(const FusedArgs& p, float* smem,
                                         const int* un) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int path = un[0], out_col = un[1], wo = un[2], b_off = un[3];
  const int u0 = un[4];
  const int n_tiles = (p.M + kMT - 1) / kMT;
  const int t0 = blockIdx.y * p.chunk_tiles;
  const int t1 = min(n_tiles, t0 + p.chunk_tiles);

  // the path row, its non-zeros, a tile's staged left, bw and gout rows,
  // the S tiles
  int* ps = reinterpret_cast<int*>(smem);
  int2* zs = reinterpret_cast<int2*>(ps + round4(kFPathFields));
  float* as = reinterpret_cast<float*>(zs + p.max_nz);   // two buffers
  float* bs = as + 2 * kMT * p.a_pitch;                  // two buffers
  float* gs = bs + 2 * kMT * p.b_pitch;
  float* ss = gs + kMT * p.g_pitch;

  const int* pg = p.paths + (size_t)path * kFPathFields;
  if (tid < kFPathFields) ps[tid] = pg[tid];
  const int x_off = pg[0], d1 = pg[1], r0 = pg[2], d2 = pg[3], d3 = pg[4];
  const int vch = min(kMKC, p.mul - u0);
  stage_nz(zs, p.nz, pg[5], pg[6]);

  const uint64_t md2 = magic(d2);
  auto stage_rows = [&](int t) {
    const int m0 = t * kMT, live = min(kMT, p.M - m0);
    float* ad = as + (t & 1) * kMT * p.a_pitch;
    float* bd = bs + (t & 1) * kMT * p.b_pitch;
    stage_lines(
        kMT, kMKC * d1, vch * d1, p.a,
        [&](int e) {
          return e < live ? p.a + (size_t)(m0 + e) * p.a_dim + x_off +
                                u0 * d1
                          : nullptr;
        },
        [&](int e) { return ad + e * p.a_pitch; });
    stage_lines(
        kMT * d2, kMKC, vch, p.bw,
        [&](int l) {
          const int e = div_by(l, md2);
          return e < live ? p.bw + ((size_t)(m0 + e) * p.R + r0 + l -
                                    e * d2) * p.mul + u0
                          : nullptr;
        },
        [&](int l) {
          const int e = div_by(l, md2);
          return bd + e * p.b_pitch + (l - e * d2) * kMKC;
        });
  };
  auto stage_gout = [&](int t) {
    const int m0 = t * kMT, live = min(kMT, p.M - m0);
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
      const float* ar = as + (t & 1) * kMT * p.a_pitch + e * p.a_pitch +
                        q * d1;
      const float* br = bs + (t & 1) * kMT * p.b_pitch + e * p.b_pitch + q;
      for (int m3 = 0; m3 < d3; ++m3) {
        float v[kMV];
        cg_run<kMKC, kMQ>(zs, ps[kFRuns + m3], ps[kFRuns + m3 + 1], ar, br,
                          d1, v);
        float* sr = ss + (m3 * kMT + e) * kMSPitch + q;
#pragma unroll
        for (int j = 0; j < kMV; ++j) sr[j * kMQ] = v[j];
      }
    }
    cp_async_wait<1>();     // gout(t); rows(t + 1) may still be in flight
    __syncthreads();
    // A = S[m3]^T (rows u, columns the tile's elements), B = gout[m3]
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

// grid: (units, element chunks); kMThreads threads
__global__ void __launch_bounds__(kMThreads, kMBlocks)
    pairwise_dws_kernel(const FusedArgs p) {
  extern __shared__ __align__(16) float smem[];
  dws_unit(p, smem, p.units + blockIdx.x * kMUnitFields);
}

// out[i] = the sum of the chunks' ws[k * len + i], in chunk order
__global__ void pairwise_chunk_sum_kernel(const float* __restrict__ ws,
                                          int n, int len,
                                          float* __restrict__ out) {
  cgtile::chunk_sum(ws, n, len, out);
}

// K5a and K5b, the adjoint sweep.  A block is one unit: a tile of
// elements and one chunk of consecutive paths of one left irrep.  Each
// warp takes 64 / mul of the tile's elements and walks the chunk on its
// own: lane l holds channels 2l, 2l + 1 of a 64-float row that packs the
// warp's elements (element 2l / mul, channel 2l % mul).  The warp stages
// its own rows by bulk copies (the copy engine, counted on a barrier per
// path in flight) into its own ring of rows, the next paths as far as the
// ring holds them while it computes one, so that after the unit's tables
// are staged only __syncwarp orders it.  A path's stage holds its d2 bw
// rows, then its d3 dS rows; the non-zeros come as (byte offset of the
// first operand's row | byte offset of the dS row << 16, coefficient
// bits), d left's first operand a bw row m2 of the stage, dbw's a row m1
// of the warp's left rows (staged transposed, [m1][64], by cp.async).
struct AdjArgs {
  const float* a;
  const float* bw;
  const float* dS;
  const int* paths;     // [P, kAdjPathFields], left-irrep order
  const int2* nz;       // [2][n_nz]: (offsets, coefficient bits)
  const int* chunks;    // [n_chunks, kAdjChunkFields]
  float* da;
  float* dbw;
  float* ws;            // partial d left of the irreps cut into chunks
  int M, a_dim, R, KM, log_mul, n_nz, tile, max_nz, max_paths, ring_rows,
      max_d1;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   rowmix::smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          rowmix::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the phase of `bar` with this parity; a wait of seconds (copies
// that never land) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(rowmix::smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

// a bulk copy of `bytes` (a multiple of 16) by the copy engine, counted
// on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(rowmix::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(rowmix::smem_addr(bar))
      : "memory");
}

// One path's rows into the warp's ring at `dst` by bulk copies: its d2 bw
// rows (for d left) and, after them, its d3 dS rows, each of mul floats
// per element at its element's place in the 64-float row (one copy for
// the d2 bw rows of an element when mul is 64: they are consecutive on
// both sides).  Lane 0 announces the bytes on `bar`, then the lanes issue
// the copies; the rows of elements past M are not copied (nothing reads
// them into an output).
template <bool A>
__device__ __forceinline__ void stage_path(float* dst, const int* pi,
                                           int m_warp, const AdjArgs& p,
                                           int lane, uint64_t* bar) {
  const int mul = 1 << p.log_mul, per_warp = kAdjRow >> p.log_mul;
  const int live = min(per_warp, p.M - m_warp);
  const int d2 = pi[1], d3 = pi[4];
  const bool whole = mul == kAdjRow;      // an element fills the row
  const int bw_copies = A ? (whole ? 1 : d2) : 0;
  const int per_elem = bw_copies + d3;
  if (lane == 0)
    mbar_expect_tx(bar, (uint32_t)(live * ((A ? d2 : 0) + d3) * mul * 4));
  __syncwarp();
  for (int i = lane; i < live * per_elem; i += 32) {
    const int e = i / per_elem, c = i - e * per_elem;
    const size_t m = (size_t)(m_warp + e);
    float* d = dst + e * mul;
    if (c < bw_copies) {
      const int r = whole ? 0 : c;
      bulk_copy(d + r * kAdjRow, p.bw + (m * p.R + pi[0] + r) * mul,
                (whole ? d2 : 1) * mul * 4, bar);
    } else {
      const int m3 = c - bw_copies;
      bulk_copy(d + (d2 + m3) * kAdjRow,
                p.dS + m * p.KM + (size_t)(pi[2] + m3 * pi[3]) * mul,
                mul * 4, bar);
    }
  }
}

// cp.async the warp's elements' columns of one left irrep of a,
// transposed to rows [m1][64]: channel u of element e, a[m(e), x_off +
// u * D1 + m1], to dst[m1 * 64 + e * mul + u].
template <int D1>
__device__ __forceinline__ void stage_left(float* dst, int x_off, int m_warp,
                                           const AdjArgs& p, int lane) {
  const int mul = 1 << p.log_mul;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = 2 * lane + h;
    const int m = m_warp + (f >> p.log_mul);
    const bool live = m < p.M;
    const float* s = live ? p.a + (size_t)m * p.a_dim + x_off +
                                (f & (mul - 1)) * D1
                          : p.a;
#pragma unroll
    for (int m1 = 0; m1 < D1; ++m1)
      cp_async4(dst + m1 * kAdjRow + f, live ? s + m1 : s, live ? 4 : 0);
  }
}

// the ring position at which `rows` consecutive rows start, from `pos` on,
// without wrapping around the ring's end
__device__ __forceinline__ int ring_start(int pos, int rows, int ring_rows) {
  const int r = pos % ring_rows;
  return r + rows > ring_rows ? pos + ring_rows - r : pos;
}

__device__ __forceinline__ float2 lds2(const float* base, int bytes) {
  return *reinterpret_cast<const float2*>(
      reinterpret_cast<const char*>(base) + bytes);
}

template <int D1, bool A, bool B>
__device__ __forceinline__ void adj_unit(const AdjArgs& p, float* smem,
                                         const int* ch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mul = 1 << p.log_mul;
  const int m_warp = blockIdx.y * p.tile + (warp << (6 - p.log_mul));
  const int x_off = ch[0], ws_col = ch[4], n_p = ch[3] - ch[2];
  const int* P0 = p.paths + (size_t)ch[2] * kAdjPathFields;
  const int z_base = P0[5];
  const int n_z = P0[(n_p - 1) * kAdjPathFields + 6] - z_base;

  // the unit's tables, shared by its warps; then per warp its barriers,
  // its left rows (dbw) and its ring of staged rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * kAdjSlots;
  int2* tab_a = reinterpret_cast<int2*>(
      reinterpret_cast<uint64_t*>(smem) + (blockDim.x >> 5) * kAdjSlots);
  int2* tab_b = tab_a + (A ? p.max_nz : 0);
  int* ps = reinterpret_cast<int*>(tab_b + (B ? p.max_nz : 0));
  float* a_s = reinterpret_cast<float*>(ps + p.max_paths * kAdjPathFields) +
               (size_t)warp * kAdjRow * ((B ? p.max_d1 : 0) + p.ring_rows);
  float* ring = a_s + (B ? p.max_d1 : 0) * kAdjRow;

  if (B && m_warp < p.M) stage_left<D1>(a_s, x_off, m_warp, p, lane);
  cp_async_commit();
  if (lane < kAdjSlots) mbar_init(bars + lane);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = threadIdx.x; i < n_z; i += blockDim.x) {
    if (A) tab_a[i] = p.nz[z_base + i];
    if (B) tab_b[i] = p.nz[p.n_nz + z_base + i];
  }
  for (int i = threadIdx.x; i < n_p * kAdjPathFields; i += blockDim.x)
    ps[i] = P0[i];
  __syncthreads();
  if (m_warp >= p.M) return;   // a warp past the last element

  float dal[2][D1];
#pragma unroll
  for (int i = 0; i < D1; ++i) dal[0][i] = dal[1][i] = 0.f;
  const int f0 = 2 * lane;
  const int m_lane = m_warp + (f0 >> p.log_mul);
  const int u0 = f0 & (mul - 1);

  // Paths go through the ring in order, each in consecutive rows (none
  // wraps: a path that would is placed at the ring's start), at most
  // kAdjSlots of them in flight, path j's copies counted on barrier
  // j % kAdjSlots; positions count rows from the unit's start.  j: the
  // next path to stage.
  int j = 0, ipos = 0, cpos = 0;
  for (int k = 0; k < n_p; ++k) {
    const int* pi = ps + k * kAdjPathFields;
    const int ck = ring_start(cpos, pi[1] + pi[4], p.ring_rows);
    // keep the ring full: stage the next paths whose rows fit beside k's
    for (; j < n_p && j - k < kAdjSlots; ++j) {
      const int* pj = ps + j * kAdjPathFields;
      const int nj = pj[1] + pj[4];
      const int sj = ring_start(ipos, nj, p.ring_rows);
      if (j > k && sj + nj > ck + p.ring_rows) break;
      stage_path<A>(ring + (sj % p.ring_rows) * kAdjRow, pj, m_warp, p, lane,
                    bars + j % kAdjSlots);
      ipos = sj + nj;
    }
    mbar_wait(bars + k % kAdjSlots, (k / kAdjSlots) & 1);
    if (B && k == 0) cp_async_wait<0>();   // the left rows
    __syncwarp();
    const float* st = ring + (ck % p.ring_rows) * kAdjRow + f0;
    if (A) {
      // d left: runs of equal m1, a register sum per (channel, m1)
#pragma unroll
      for (int i = 0; i < D1; ++i) {
        const int z1 = pi[kAdjRunsA + 1 + i] - z_base;
        for (int z = pi[kAdjRunsA + i] - z_base; z < z1; ++z) {
          const int2 e = tab_a[z];
          const float c = __int_as_float(e.y);
          const float2 b2 = lds2(st, e.x & 0xffff);
          const float2 g3 = lds2(st, e.x >> 16);
          dal[0][i] += c * b2.x * g3.x;
          dal[1][i] += c * b2.y * g3.y;
        }
      }
    }
    if (B) {
      // dbw: runs of equal m2, each bw row stored once by its path's unit
      const float* as = a_s + f0;
      float* out = p.dbw + ((size_t)m_lane * p.R + pi[0]) * mul + u0;
      for (int i = 0; i < pi[1]; ++i) {
        float acc0 = 0.f, acc1 = 0.f;
        const int z1 = pi[kAdjRunsB + 1 + i] - z_base;
        for (int z = pi[kAdjRunsB + i] - z_base; z < z1; ++z) {
          const int2 e = tab_b[z];
          const float c = __int_as_float(e.y);
          const float2 a1 = lds2(as, e.x & 0xffff);
          const float2 g3 = lds2(st, e.x >> 16);
          acc0 += c * a1.x * g3.x;
          acc1 += c * a1.y * g3.y;
        }
        if (m_lane < p.M)
          *reinterpret_cast<float2*>(out + (size_t)i * mul) =
              make_float2(acc0, acc1);
      }
    }
    __syncwarp();
    cpos = ck + pi[1] + pi[4];
  }
  if (A && m_lane < p.M) {
    // channels u0 and u0 + 1: 2 * D1 consecutive columns
    float* out = (ws_col < 0 ? p.da + (size_t)m_lane * p.a_dim + x_off
                             : p.ws + (size_t)p.M * ws_col +
                                   (size_t)m_lane * mul * D1) +
                 u0 * D1;
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      const int c0 = 2 * i, c1 = 2 * i + 1;
      reinterpret_cast<float2*>(out)[i] =
          make_float2(c0 < D1 ? dal[0][c0] : dal[1][c0 - D1],
                      c1 < D1 ? dal[0][c1] : dal[1][c1 - D1]);
    }
  }
}

// grid: (chunks, tiles); block: 32 x the warps of a tile.  A: d left,
// B: dbw.
template <bool A, bool B>
__global__ void __launch_bounds__(kAdjThreads, 3)
    pairwise_adj_kernel(const AdjArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int* ch = p.chunks + blockIdx.x * kAdjChunkFields;
  switch (ch[1]) {
    case 1: adj_unit<1, A, B>(p, smem, ch); break;
    case 3: adj_unit<3, A, B>(p, smem, ch); break;
    case 5: adj_unit<5, A, B>(p, smem, ch); break;
    case 7: adj_unit<7, A, B>(p, smem, ch); break;
    case 9: adj_unit<9, A, B>(p, smem, ch); break;
  }
}

// d left of the irreps cut into several chunks: their partials added in
// chunk order; zeros for an irrep that no path reads.  grid: (row blocks,
// sum entries).
__global__ void pairwise_da_sum_kernel(const float* __restrict__ ws,
                                       const int* __restrict__ sums, int M,
                                       float* __restrict__ da, int a_dim) {
  const int* e = sums + blockIdx.y * kAdjSumFields;
  const int x_off = e[0], width = e[1], col = e[2], n = e[3];
  const size_t total = (size_t)M * width;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += ws[(size_t)M * (col + k * width) + i];
    const size_t m = i / width;
    da[m * a_dim + x_off + (i - m * width)] = s;
  }
}

}  // namespace

// The shared memory of the fused kernels' blocks, from the host's table
// dimensions dims: max d1, d2, d3, non-zeros of a path (even), wo, paths
// of a unit; k5m: true for pairwise_dws_kernel.  Sets the pitches of `p`.
static size_t fused_smem(FusedArgs& p, const int* dims, bool k5m) {
  const int max_d1 = dims[0], max_d2 = dims[1], max_d3 = dims[2];
  p.max_nz = dims[3];
  p.max_paths = dims[5];
  size_t floats = round4(p.max_nz * 2);
  if (k5m) {
    p.a_pitch = row_pitch(kMKC * max_d1, kMQ % 32);
    p.b_pitch = row_pitch(kMKC * max_d2, kMQ % 32);
    p.g_pitch = row_pitch(dims[4] * max_d3, 8);
    floats += round4(kFPathFields) +
              kMT * (size_t)(2 * p.a_pitch + 2 * p.b_pitch + p.g_pitch) +
              (size_t)max_d3 * kMT * kMSPitch;
  } else {
    p.a_pitch = row_pitch(kFKC * max_d1, kFQ % 32);
    p.b_pitch = row_pitch(kFKC * max_d2, kFQ % 32);
    p.g_pitch = 0;
    floats += round4(p.max_nz * 2) + round4(p.max_paths * kFPathFields) +
              2 * (kFT * (size_t)(p.a_pitch + p.b_pitch) + kFKC * kWPitch) +
              (size_t)max_d3 * kFT * kFSPitch;
  }
  return floats * sizeof(float);
}

static bool fused_dims_ok(const int* dims, int mul) {
  return dims[0] >= 1 && dims[0] <= kMaxD && dims[1] >= 1 &&
         dims[1] <= kMaxD && dims[2] >= 1 && dims[2] <= kMaxD &&
         dims[3] % 2 == 0 && dims[4] % 8 == 0 && dims[4] <= kMaxWo &&
         mul % 4 == 0 && mul >= 4;
}

template <class Kernel>
static cudaError_t launch_fused(Kernel kernel, dim3 grid, int threads,
                                size_t smem, const FusedArgs& p,
                                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// K5.  paths, nz: the fused tables (ops/cuda/pairwise_tp.py, FusedTables)
// on the device; dims: their dimensions (kFusedDims), on the host; units
// [n_units, kFUnitFields]: the cut of the groups' components that the
// wrapper chose for M.  Every output column of a mix problem is stored
// once by one unit (the wrapper zero-fills the columns of none).
extern "C" int pairwise_tp_fwd(
    const float* a, int M, int a_dim, const float* bw, int R, int mul,
    const int* paths, const int* nz, const int* dims, const int* units,
    int n_units, const float* wsel, float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || n_units <= 0) return (int)cudaGetLastError();
  if (!fused_dims_ok(dims, mul) || n_units > 65535)
    return (int)cudaErrorInvalidValue;
  FusedArgs p{a, bw, wsel, nullptr, paths,
              reinterpret_cast<const int2*>(nz), units, out, M, a_dim, R,
              mul, out_dim, 0};
  const size_t smem = fused_smem(p, dims, false);
  const dim3 grid((M + kFT - 1) / kFT, n_units);
  return (int)launch_fused(pairwise_fwd_kernel, grid, kFThreads, smem, p, s);
}

// The adjoint sweep's launch: what the chunks need of shared memory (from
// the host copies of the tables), the sweep, then the ordered sum of d
// left's partials.  tile: elements per block, a multiple of a warp's
// 64 / mul.
static cudaError_t adjoint_sweep(AdjArgs p, bool want_a, bool want_b,
                                 const int* paths_host,
                                 const int* chunks_host, int n_chunks,
                                 const int* sums, int n_sums, int mul,
                                 int tile, long long ws_len, cudaStream_t s) {
  int log_mul = 0;
  while ((2 << log_mul) <= mul) ++log_mul;
  const int per_warp = kAdjRow / mul;
  if (mul != 1 << log_mul || mul < 4 || mul > kAdjRow || tile <= 0 ||
      tile % per_warp || tile / per_warp * 32 > kAdjThreads)
    return cudaErrorInvalidValue;
  const int warps = tile / per_warp;
  p.log_mul = log_mul;
  p.tile = tile;
  p.max_nz = p.max_paths = p.ring_rows = p.max_d1 = 0;
  long long ws_need = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int* ch = chunks_host + c * kAdjChunkFields;
    const int d1 = ch[1];
    if (d1 < 1 || d1 > kMaxD || d1 % 2 == 0 || ch[3] <= ch[2])
      return cudaErrorInvalidValue;
    const int* pf = paths_host + (size_t)ch[2] * kAdjPathFields;
    const int* pl = paths_host + (size_t)(ch[3] - 1) * kAdjPathFields;
    p.max_nz = std::max(p.max_nz, pl[6] - pf[5]);
    p.max_paths = std::max(p.max_paths, ch[3] - ch[2]);
    p.max_d1 = std::max(p.max_d1, d1);
    for (const int* pi = pf; pi <= pl; pi += kAdjPathFields)
      p.ring_rows = std::max(p.ring_rows, pi[1] + pi[4]);
    if (ch[4] >= 0)
      ws_need = std::max(ws_need, (long long)p.M * (ch[4] + mul * d1));
  }
  if (want_a && ws_need > ws_len) return cudaErrorInvalidValue;
  p.ring_rows = std::max(p.ring_rows, kAdjRingRows);
  // the float sections start 16-byte aligned
  p.max_nz += p.max_nz & 1;
  while (p.max_paths * kAdjPathFields % 4) ++p.max_paths;
  const size_t smem =
      sizeof(uint64_t) * kAdjSlots * warps +
      sizeof(int2) * p.max_nz * (want_a + want_b) +
      sizeof(int) * p.max_paths * kAdjPathFields +
      sizeof(float) * kAdjRow * warps *
          ((size_t)(want_b ? p.max_d1 : 0) + p.ring_rows);
  if (n_chunks > 0) {
    void (*kernel)(AdjArgs) = pairwise_adj_kernel<false, true>;
    if (want_a)
      kernel = want_b ? pairwise_adj_kernel<true, true>
                      : pairwise_adj_kernel<true, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(n_chunks, (p.M + tile - 1) / tile);
    kernel<<<grid, 32 * warps, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (want_a && n_sums > 0) {
    const long long floats = (long long)p.M * mul * kMaxD;
    const int blocks = (int)std::min<long long>(1024, (floats + 255) / 256);
    pairwise_da_sum_kernel<<<dim3(std::max(blocks, 1), n_sums), 256, 0, s>>>(
        p.ws, sums, p.M, p.da, p.a_dim);
  }
  return cudaGetLastError();
}

// paths, nz, dims: the fused tables, as for pairwise_tp_fwd; dws_units
// [n_dws_units, kMUnitFields]: K5m's units, over chunks of dws_chunk_tiles
// element tiles each (dws_ws: their partial dwsel, a wsel_len floats per
// chunk, where there are several).  probs_host: the mix problem table, on the
// host.  adj_*: the adjoint sweep's tables (ops/cuda/pairwise_tp.py,
// AdjointTables), on the device and, for the paths and chunks, on the
// host; tile: elements per block of the sweep.  dS: a work buffer [M, K *
// mul]; ws [ws_len]: gout made component-major for the dS product; da_ws
// [da_ws_len]: the partial d left of the irreps cut into several chunks.
// parts: which cotangents to compute, 1 dwsel (K5m), 2 d left (K5a), 4 dbw
// (K5b); the others' buffers are left untouched.  Every output element
// has one owner that stores it once: no atomics, no memsets (bar dwsel
// with no path or element).
extern "C" int pairwise_tp_bwd(
    const float* a, int M, int a_dim, const float* bw, int R, int P,
    const int* paths, const int* nz, const int* dims,
    const int* dws_units, int n_dws_units, int dws_chunk_tiles,
    const int* adj_paths, const int* adj_paths_host,
    const int* adj_nz, int adj_n_nz,
    const int* adj_chunks, const int* adj_chunks_host, int n_chunks,
    const int* adj_sums, int n_sums, int tile,
    int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* dS, float* da, float* dbw, float* dwsel, int parts,
    float* ws, int ws_len, float* da_ws, int da_ws_len, float* dws_ws,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_m = parts & 1, want_a = parts & 2, want_b = parts & 4;
  cudaError_t err = cudaSuccess;
  if (want_m && (M <= 0 || P <= 0 || n_dws_units <= 0))
    err = cudaMemsetAsync(dwsel, 0, (size_t)wsel_len * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaGetLastError();
  if (want_m && P > 0 && n_dws_units > 0) {
    const int tiles = (M + kMT - 1) / kMT;
    if (!fused_dims_ok(dims, mul) || dws_chunk_tiles < 1 ||
        (tiles + dws_chunk_tiles - 1) / dws_chunk_tiles > 65535)
      return (int)cudaErrorInvalidValue;
    FusedArgs p{a, bw, wsel, gout, paths, reinterpret_cast<const int2*>(nz),
                dws_units, dwsel, M, a_dim, R, mul, out_dim, wsel_len};
    const size_t smem = fused_smem(p, dims, true);
    p.chunk_tiles = dws_chunk_tiles;
    const int chunks = (tiles + p.chunk_tiles - 1) / p.chunk_tiles;
    if (chunks > 1) {
      if (dws_ws == nullptr) return (int)cudaErrorInvalidValue;
      p.out = dws_ws;
    }
    err = launch_fused(pairwise_dws_kernel, dim3(n_dws_units, chunks),
                       kMThreads, smem, p, s);
    if (err != cudaSuccess) return (int)err;
    if (chunks > 1) {
      const int blocks = std::min(1024, (wsel_len + 255) / 256);
      pairwise_chunk_sum_kernel<<<std::max(blocks, 1), 256, 0, s>>>(
          dws_ws, chunks, wsel_len, dwsel);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (!want_a && !want_b) return (int)cudaGetLastError();
  if (P > 0) {
    err = rowmix::mix_products(rowmix::kMixRows, probs_host, n_probs, M, KM,
                               out_dim, nullptr, wsel, gout, dS, wsel_len,
                               ws, ws_len, s);
    if (err != cudaSuccess) return (int)err;
  }
  AdjArgs p{a, bw, dS, adj_paths, reinterpret_cast<const int2*>(adj_nz),
            adj_chunks, da, dbw, da_ws, M, a_dim, R, KM, 0, adj_n_nz};
  return (int)adjoint_sweep(p, want_a, want_b, adj_paths_host,
                            adj_chunks_host, P > 0 ? n_chunks : 0, adj_sums,
                            n_sums, mul, tile, da_ws_len, s);
}
