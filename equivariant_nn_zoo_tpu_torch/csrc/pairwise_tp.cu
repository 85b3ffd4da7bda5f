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
//   S[m, row(p, m3), u] = sum_nz C_p * a[m, m1, u] * bw[m, r0(p) + m2, u]
//   out[m, cols(q)]     = S[m, a_col(q) : +kdim(q)] @ wsel_q    per problem q
//
// over the mix-reachable paths p, sorted by output irrep, with scratch rows
// component-major inside each output-irrep group (K1's conventions), the
// path weights folded into the host-built wigner_3j non-zeros C and the mix
// Linear's alphas into wsel.  The TPU kernel's per-(i1, i2) sections, dense
// C2 operators (229,024 entries against 52,092 non-zeros at the full-width
// head), K8 row padding and (u, e) lane layout are MXU devices and are not
// carried over: the contraction walks the non-zeros.
//
// Two kernels on the caller's stream from one C entry:
//
// 1. pairwise_cg_kernel: thread (u, element) walks a chunk of the paths;
//    a is read through L1 (d1 neighbouring floats per thread), bw
//    [M, R, mul] coalesced over u; every scratch row of the element is
//    written once with a plain store (each (path, m3) has a non-zero,
//    checked on the host).  Paths are split over blockIdx.y so that a
//    48-element batch still fills the card.
// 2. rowmix::gemm_kernel (row_mix.cuh): the mix on the tensor cores
//    (3xTF32), one owner per output tile, plain stores.
//
// What bounds it on the card: the scratch round trip (R * mul floats of bw
// read, as many of S written and read again: 384 KB each per element) and
// the CG sweep's f32 FMAs on CUDA cores (2 * mul per CG non-zero); the mix
// (2 * mul * mul_out per scratch row, ~12 MFLOP per element at the
// full-width head) runs on the tensor cores.  Keeping S in shared memory
// per output-irrep group is the next step.
//
// The backward replaces the three TPU kernels _bwd_kernel_dws,
// _bwd_kernel_da and _bwd_kernel_dbw (pairwise.py:504, :556, :591; launched
// at :655, :670, :684).  Given gout = dL/dout it returns dwsel, da [M, a_dim]
// and dbw [M, R, mul] from one C entry:
//
// 0. pairwise_cg_kernel again: S is recomputed, not saved (1.05 MFLOP per
//    element against 12.3 for the mix, and a saved S would double what a
//    training step keeps per element beside bw).
// 1. K5m, rowmix::mix_products (row_mix.cuh, the tensor-core GEMM):
//    dwsel_q = S_q^T @ gout_q over the d components of a (group, slot),
//    split over chunks of elements as far as the card needs blocks, the
//    partial tiles added in split order (no atomics, a fixed order); the
//    same GEMM gives dS = gout_q @ wsel_q^T with one owner per tile,
//    which K5a and K5b read (on the TPU each of them recomputes it per
//    section).
// 2. K5a and K5b, pairwise_adj_kernel, one sweep for both cotangents:
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
// 3. pairwise_da_sum_kernel adds those partials in chunk order (zeros for
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
// What bounds the backward: the scratch-sized streams (S, dS, bw, dbw: 384
// KB per element each) and the two mix products (2 x 12.3 MFLOP per
// element, on the tensor cores in 3xTF32).  The adjoint sweep alone moves
// dS, bw and dbw once (1.08 ms of bytes at M = 3072 on an H100); its
// shared-memory reads (two operands per non-zero, order and channel) come
// close, and its speed follows the warps a multiprocessor holds, which its
// shared memory bounds (chip_smoke.py --pw-times, --walk-ablation).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "row_mix.cuh"

namespace {

using rowmix::cp_async4;
using rowmix::cp_async_commit;
using rowmix::cp_async_wait;

constexpr int kPathFields = 9;
constexpr int kMaxD = 9;           // components of an l <= 4 irrep
constexpr int kRows = rowmix::kRowsPerBlock;
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

__global__ void pairwise_cg_kernel(
    const float* __restrict__ a, int M, int a_dim,
    const float* __restrict__ bw, int R,
    const int* __restrict__ paths, int P, int paths_per_block,
    const int* __restrict__ nz_idx, const float* __restrict__ nz_c,
    float* __restrict__ S, int KM) {
  const int mul = blockDim.x;
  const int u = threadIdx.x;
  const int m = blockIdx.x * kRows + threadIdx.y;
  if (m >= M) return;
  const float* arow = a + (size_t)m * a_dim;
  const float* brow = bw + (size_t)m * R * mul + u;
  float* srow = S + (size_t)m * KM + u;

  const int p_begin = blockIdx.y * paths_per_block;
  const int p_end = min(P, p_begin + paths_per_block);
  for (int p = p_begin; p < p_end; ++p) {
    const int* pi = paths + p * kPathFields;
    const int x_off = pi[0], d1 = pi[1], r0 = pi[2];
    const int row_base = pi[4], row_stride = pi[5];
    const int nz0 = pi[7], nz1 = pi[8];
    const float* as = arow + x_off + u * d1;
    const float* bs = brow + (size_t)r0 * mul;
    int m3_cur = -1;
    float acc = 0.f;
    for (int z = nz0; z < nz1; ++z) {
      const int code = nz_idx[z];
      const int m1 = code & 0xff, m2 = (code >> 8) & 0xff, m3 = code >> 16;
      if (m3 != m3_cur) {
        if (m3_cur >= 0)
          srow[(size_t)(row_base + m3_cur * row_stride) * mul] = acc;
        m3_cur = m3;
        acc = 0.f;
      }
      acc += nz_c[z] * __ldg(as + m1) * __ldg(bs + m2 * mul);
    }
    if (m3_cur >= 0)
      srow[(size_t)(row_base + m3_cur * row_stride) * mul] = acc;
  }
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

extern "C" int pairwise_tp_fwd(
    const float* a, int M, int a_dim,
    const float* bw, int R,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    float* scratch, int KM, int mul,
    const float* wsel, const int* probs_host, int n_probs,
    float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return (int)cudaGetLastError();
  if (P > 0) {
    const int ppb = rowmix::paths_per_block(M, P);
    dim3 block(mul, kRows);
    dim3 grid((M + kRows - 1) / kRows, (P + ppb - 1) / ppb);
    pairwise_cg_kernel<<<grid, block, 0, s>>>(a, M, a_dim, bw, R, paths, P,
                                              ppb, nz_idx, nz_c, scratch, KM);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowmix::mix_rows(scratch, M, KM, wsel, probs_host, n_probs,
                               out, out_dim, s);
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

// probs_host: the mix problem table, on the host.  adj_*: the adjoint
// sweep's tables (ops/cuda/pairwise_tp.py, AdjointTables), on the device
// and, for the paths and chunks, on the host; tile: elements per block of
// the sweep.  S and dS: work buffers [M, K * mul]; ws [ws_len]: the split
// products' partial tiles; da_ws [da_ws_len]: the partial d left of the
// irreps cut into several chunks.  parts: which cotangents to compute, 1
// dwsel (K5m), 2 d left (K5a), 4 dbw (K5b); the others' buffers are left
// untouched.  Every output element has one owner that stores it once: no
// atomics, no memsets (bar dwsel with no path or element).
extern "C" int pairwise_tp_bwd(
    const float* a, int M, int a_dim,
    const float* bw, int R,
    const int* paths, int P, const int* nz_idx, const float* nz_c,
    const int* adj_paths, const int* adj_paths_host,
    const int* adj_nz, int adj_n_nz,
    const int* adj_chunks, const int* adj_chunks_host, int n_chunks,
    const int* adj_sums, int n_sums, int tile,
    int KM, int mul,
    const float* wsel, int wsel_len, const int* probs_host, int n_probs,
    const float* gout, int out_dim,
    float* S, float* dS, float* da, float* dbw, float* dwsel, int parts,
    float* ws, int ws_len, float* da_ws, int da_ws_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_m = parts & 1, want_a = parts & 2, want_b = parts & 4;
  cudaError_t err = cudaSuccess;
  if (want_m && (M <= 0 || P <= 0))
    err = cudaMemsetAsync(dwsel, 0, (size_t)wsel_len * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return (int)cudaGetLastError();
  if (P > 0) {
    const int ppb = rowmix::paths_per_block(M, P);
    const dim3 by_path((M + kRows - 1) / kRows, (P + ppb - 1) / ppb);
    if (want_m) {
      pairwise_cg_kernel<<<by_path, dim3(mul, kRows), 0, s>>>(
          a, M, a_dim, bw, R, paths, P, ppb, nz_idx, nz_c, S, KM);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      err = rowmix::mix_products(rowmix::kMixWeights, probs_host, n_probs, M,
                                 KM, out_dim, S, nullptr, gout, dwsel,
                                 wsel_len, ws, ws_len, s);
      if (err != cudaSuccess) return (int)err;
    }
    if (want_a || want_b) {
      err = rowmix::mix_products(rowmix::kMixRows, probs_host, n_probs, M, KM,
                                 out_dim, nullptr, wsel, gout, dS, wsel_len,
                                 ws, ws_len, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (!want_a && !want_b) return (int)cudaGetLastError();
  AdjArgs p{a, bw, dS, adj_paths, reinterpret_cast<const int2*>(adj_nz),
            adj_chunks, da, dbw, da_ws, M, a_dim, R, KM, 0, adj_n_nz};
  return (int)adjoint_sweep(p, want_a, want_b, adj_paths_host,
                            adj_chunks_host, P > 0 ? n_chunks : 0, adj_sums,
                            n_sums, mul, tile, da_ws_len, s);
}
