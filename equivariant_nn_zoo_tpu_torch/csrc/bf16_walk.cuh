// The bfloat16 edge walks of K1 and K2 (full_conv.cu k1_bf16_walk_kernel,
// full_conv_bwd.cu k2_bf16_walk_kernel): the TPU kernel's CG step at
// compute_dtype=bfloat16 as what it is there, a bfloat16 matrix product
// with float32 accumulation, rounded once
// (dot_general(C2vs.astype(cd), outer_p, preferred_element_type=f32)
// .astype(cd), fused_conv.py:871-875), here on the tensor cores (mma.sync
// m16n8k16 bf16).  A product of two bfloat16 values is exact in float32,
// so the MMA sums the same products as the TPU and the plain contracts
// (ops/cuda/full_conv.py plain_forward_bf16, plain_backward_bf16), in
// another order.
//
// The walk is edge_walk.cuh's node-major walk (work items, long runs in
// pieces, every node written once, no atomics).  A block is one work item
// and one unit, a left irrep L with all its paths (the tables of
// FullConv._bf16_walk_tables: the paths' (path, m3) columns sorted by sh
// irrep and padded to a multiple of 16, the rounded CG cut into B tiles of
// 16 x 8 stored as the 32 lanes' fragments, only the non-zero ones, and
// the maps that name them).  Warp w of the block owns channels 16 w ..
// 16 w + 15 (blockDim.x = 32 * ceil(mul / 16), at most 4 warps); an MMA
// row is (edge, channel).  Per stage of kStage = 16 edges (edge ids, the
// last hidden layer's activations, sh and the x slice staged with
// cp.async, as the float32 walk stages them), each warp:
//
// 1. radial weights as an MMA: w[q, slot, c] = bf16(h_last[q] .
//    W_out[:, wcol(slot) + c]) for the 16 staged edges and its 16
//    channels of every path of L: [16 x H] x [H x 16] per path, h_last's
//    rows (already rounded) packed from shared memory, W_out's pairs of
//    rows read from L2/L1, the result rounded into the warp's slice of
//    shared memory;
// 2. per edge, the outer product O[(j, m1)] = bf16(sh_j x[m1]) formed once
//    per channel and component pair, straight into the A fragments (k-step
//    (jp, mb): j = 2 jp, 2 jp + 1, m1 = 8 mb .. 8 mb + 7; each lane holds
//    its two channels' x[m1] for its two m1 in registers);
// 3. mid = bf16(O C) as MMAs over the unit's non-zero forward tiles, one
//    f32 accumulator per n-tile of 8 columns, rounded once;
// then K1's epilogue (full_conv.cu) or K2's steps (full_conv_bwd.cu) on
// the accumulators in registers.
//
// Why mma.sync m16n8k16 and not wgmma: an MMA row is (edge, channel) and a
// warp takes 16 channels, so mul = 32 (config_dipole) fills two warps
// where wgmma's 64-row tile would leave half a warpgroup idle; the CG
// tiles are skipped one 16 x 8 tile at a time (216 of 342 are kept at
// config_energy's hot layer), and a wgmma of 8 columns pays its fence,
// commit and wait per edge for the same work; K2's dmid goes from the C fragments of the first product straight
// into the A fragments of the second, which the m16n8k16 layouts allow
// (two n-tiles' C registers are one k-step's A registers).  The MMAs are
// not what bounds the walks: a warp's chain per edge is (chip_smoke.py
// --walk-ablation bf16).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "edge_walk.cuh"
#include "row_mix.cuh"

namespace bwalk {

using walk::kMaxHidden;
using walk::kMaxSh;
using walk::kStage;

// the unit header (full_conv.py BF16_UNIT_FIELDS): x_off, d1, MB
// (ceil(d1 / 8)), paths, columns, n-tiles NT (even), forward k-steps KS,
// ints of the region, its first tile and tile count, then the offsets in
// the region of the columns (srow, slot), the slots (wcol, first column,
// d3), the forward map's KS rows and the backward map's J * MB rows, each
// row (mask, base): its tiles are base + the set bits of mask below an
// n-tile (forward, over NT) or a k-step (backward, over NT / 2)
enum {
  kUXOff = 0, kUD1, kUMB, kUPaths, kUN, kUNT, kUKS, kUInts, kUTile0,
  kUTiles, kUCol, kUSlot, kUFmap, kUBmap, kUnitFields = 16
};
constexpr int kJP = kMaxSh / 2;   // j pairs of the forward k-steps
constexpr int kWarps = 4;         // at most: mul <= 64

// the host's dimensions of the tables (full_conv.py bf16_walk_dims)
enum { kDUnits = 0, kDNT, kDKS, kDPaths, kDXw, kDInts, kDTiles, kDims };

// Byte offsets of the dynamic shared memory's regions, computed on the
// host (layout()) and passed by value, so that host and device agree: the
// unit's tiles (32 lanes x uint2 each), the staged edges' last hidden
// layer [kStage][kMaxHidden] f32 (zero past H) and x slices [kStage][xs]
// bf16, the unit's region of the tables, the edge ids and endpoints, sh
// [kStage][kMaxSh] f32 (zero past J), per warp the radial weights
// [kStage][paths][16] bf16 and (K2) the dw products [16][pr_pitch] bf16.
struct Layout {
  int tiles, h, x, itab, idx, sh, w, pr, end;
  int xs;          // x row pitch (elements, a multiple of 8)
  int w_warp;      // elements of a warp's radial weights
  int pr_pitch;    // elements of a row of a warp's dw products
};

static inline int align16(int b) { return (b + 15) & ~15; }

static inline Layout layout(const int* dims, int warps, bool k2) {
  Layout l;
  int at = 0;
  l.tiles = at;
  at += align16(dims[kDTiles] * 32 * 8);
  l.h = at;
  at += kStage * kMaxHidden * 4;
  l.xs = (dims[kDXw] + 7) & ~7;
  l.x = at;
  at += align16(kStage * l.xs * 2);
  l.itab = at;
  at += align16(dims[kDInts] * 4);
  l.idx = at;
  at += align16(3 * kStage * 4);
  l.sh = at;
  at += kStage * kMaxSh * 4;
  l.w_warp = kStage * dims[kDPaths] * 16;
  l.w = at;
  at += align16(warps * l.w_warp * 2);
  l.pr_pitch = 8 * dims[kDNT] + 2;
  l.pr = at;
  if (k2) at += align16(warps * 16 * l.pr_pitch * 2);
  l.end = at;
  return l;
}

// The block's pointers into the dynamic shared memory.
struct Smem {
  uint2* tiles;
  float* h;
  bf16::T* x;
  int* itab;
  int* edge;
  int* node;
  int* other;
  float* sh;
  bf16::T* w;      // this warp's radial weights
  bf16::T* pr;     // this warp's dw products (K2)
};

__device__ __forceinline__ Smem carve(unsigned char* base, const Layout& l,
                                      int warp) {
  Smem s;
  s.tiles = reinterpret_cast<uint2*>(base + l.tiles);
  s.h = reinterpret_cast<float*>(base + l.h);
  s.x = reinterpret_cast<bf16::T*>(base + l.x);
  s.itab = reinterpret_cast<int*>(base + l.itab);
  s.edge = reinterpret_cast<int*>(base + l.idx);
  s.node = s.edge + kStage;
  s.other = s.node + kStage;
  s.sh = reinterpret_cast<float*>(base + l.sh);
  s.w = reinterpret_cast<bf16::T*>(base + l.w) + warp * l.w_warp;
  s.pr = reinterpret_cast<bf16::T*>(base + l.pr) + warp * 16 * l.pr_pitch;
  return s;
}

// Once per block: the unit's region of the tables and its tiles into
// shared memory, the staged h and sh zeroed (their columns past H and J
// are never copied).  The caller's barrier follows.
__device__ __forceinline__ void stage_unit(const Smem& s,
                                           const int* __restrict__ tab,
                                           const int* __restrict__ tiles,
                                           int unit, int tid, int nthr) {
  const int* r = tab + __ldg(tab + unit);
  const int4* reg = reinterpret_cast<const int4*>(r);
  const int4* tl =
      reinterpret_cast<const int4*>(tiles + (size_t)__ldg(r + kUTile0) * 64);
  const int ints = __ldg(r + kUInts), n_tiles = __ldg(r + kUTiles);
  int4* it4 = reinterpret_cast<int4*>(s.itab);
  for (int i = tid; i < ints / 4; i += nthr) it4[i] = __ldg(reg + i);
  int4* t4 = reinterpret_cast<int4*>(s.tiles);
  for (int i = tid; i < n_tiles * 16; i += nthr) t4[i] = __ldg(tl + i);
  for (int i = tid; i < kStage * kMaxHidden; i += nthr) s.h[i] = 0.f;
  for (int i = tid; i < kStage * kMaxSh; i += nthr) s.sh[i] = 0.f;
}

// What a stage copies: the last hidden layer h_last [E, H] (rounded f32),
// sh [E, J] and the x slice [x_off, x_off + xw) of the walk's source node
// (the other endpoint when the key is the destination), both bfloat16;
// x_vec: the slices copy in 16-byte pieces.
struct Operands {
  const float* h_last;
  int H;
  const bf16::T* sh;
  int J;
  const bf16::T* x;
  int in_dim, x_off, xw;
  bool x_vec;
};

// Stage positions [pos0, pos0 + nq) of the order (edge_walk.cuh's
// stage_edges, for the bfloat16 operands): edge ids and endpoints, then h
// and x by cp.async (all of a stage's gathers in flight at once) and sh
// widened by plain loads.  Every thread of the block calls it; it first
// waits for the previous stage's readers.
__device__ __forceinline__ void stage_edges(
    const Smem& s, const Layout& l, int pos0, int nq,
    const int* __restrict__ perm, const long long* __restrict__ src,
    const long long* __restrict__ dst, bool key_is_dst, const Operands& op,
    int tid, int nthr) {
  __syncthreads();
  for (int i = tid; i < nq; i += nthr) {
    const int e = perm[pos0 + i];
    s.edge[i] = e;
    s.node[i] = (int)(key_is_dst ? dst[e] : src[e]);
    s.other[i] = (int)(key_is_dst ? src[e] : dst[e]);
  }
  __syncthreads();
  const int H = op.H;
  if (H % 4 == 0) {
    const int h4 = H / 4;
    for (int i = tid; i < nq * h4; i += nthr) {
      const int q = i / h4, c = i - q * h4;
      __pipeline_memcpy_async(s.h + q * kMaxHidden + 4 * c,
                              op.h_last + (size_t)s.edge[q] * H + 4 * c, 16);
    }
  } else {
    for (int i = tid; i < nq * H; i += nthr) {
      const int q = i / H, c = i - q * H;
      __pipeline_memcpy_async(s.h + q * kMaxHidden + c,
                              op.h_last + (size_t)s.edge[q] * H + c, 4);
    }
  }
  const int xw = op.xw;
  if (op.x_vec) {
    const int x8 = xw / 8;
    for (int i = tid; i < nq * x8; i += nthr) {
      const int q = i / x8, c = i - q * x8;
      const int n = key_is_dst ? s.other[q] : s.node[q];
      __pipeline_memcpy_async(
          s.x + q * l.xs + 8 * c,
          op.x + (size_t)n * op.in_dim + op.x_off + 8 * c, 16);
    }
  } else {
    for (int i = tid; i < nq * xw; i += nthr) {
      const int q = i / xw, c = i - q * xw;
      const int n = key_is_dst ? s.other[q] : s.node[q];
      s.x[q * l.xs + c] = op.x[(size_t)n * op.in_dim + op.x_off + c];
    }
  }
  const int J = op.J;
  for (int i = tid; i < nq * J; i += nthr) {
    const int q = i / J, j = i - q * J;
    s.sh[q * kMaxSh + j] = bf16::f(op.sh[(size_t)s.edge[q] * J + j]);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Whether the x slices [x_off, x_off + xw) of every row copy in 16-byte
// pieces.
__device__ __forceinline__ bool x_vectors(const bf16::T* x, int in_dim,
                                          int x_off, int xw) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0 && in_dim % 8 == 0 &&
         x_off % 8 == 0 && xw % 8 == 0;
}

// W_out [H, PC] transposed into wt [PC, kMaxHidden] (zero past H), so
// that a lane's B fragment of the radial product is one 8-byte load; one
// thread an element.  Launched by the C entries before the walk.
static __global__ void transpose_w_kernel(const bf16::T* __restrict__ w_out,
                                          int H, int PC,
                                          bf16::T* __restrict__ wt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PC * kMaxHidden) return;
  const int c = i / kMaxHidden, k = i % kMaxHidden;
  wt[i] = k < H ? w_out[(size_t)k * PC + c] : __float2bfloat16_rn(0.f);
}

static inline cudaError_t transpose_w(const bf16::T* w_out, int H, int PC,
                                      bf16::T* wt, cudaStream_t s) {
  const int n = PC * kMaxHidden;
  transpose_w_kernel<<<(n + 255) / 256, 256, 0, s>>>(w_out, H, PC, wt);
  return cudaGetLastError();
}

// 1. The radial weights of the stage's edges for this warp's channels c0
// .. c0 + 15 of each of the unit's paths, rounded, into s.w[q][slot][c]:
// per path and half of the channels one 16 x 8 tile, kMaxHidden / 16 MMAs
// (h_last's rows q = g, g + 8 from shared memory, zero past H).  The MMA's
// k slots (2t, 2t + 1, 2t + 8, 2t + 9) of a k-step hold the hidden units
// 16 ks + 4t .. 16 ks + 4t + 3, so that a lane's A fragment is one float4
// of each of its two rows and its B fragment one 8-byte load of wt (the
// transposed W_out).  Rows past the stage's nq edges hold what their
// stale h rows give and are not read.
__device__ __forceinline__ void radial_mma(
    const Smem& s, const bf16::T* __restrict__ wt, int mul, int c0,
    int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int P = s.itab[kUPaths];
  const int* slots = s.itab + s.itab[kUSlot];
  uint32_t a[kMaxHidden / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxHidden / 16; ++ks) {
    const float4 h0 = *reinterpret_cast<const float4*>(
        s.h + g * kMaxHidden + 16 * ks + 4 * t);
    const float4 h1 = *reinterpret_cast<const float4*>(
        s.h + (g + 8) * kMaxHidden + 16 * ks + 4 * t);
    a[ks][0] = rowmix::pack_bf16(h0.x, h0.y);
    a[ks][1] = rowmix::pack_bf16(h1.x, h1.y);
    a[ks][2] = rowmix::pack_bf16(h0.z, h0.w);
    a[ks][3] = rowmix::pack_bf16(h1.z, h1.w);
  }
  // two paths an iteration, every B fragment of both loaded first
#pragma unroll 2
  for (int sl = 0; sl < P; ++sl) {
    const int wcol = slots[3 * sl];
    uint32_t b[2][kMaxHidden / 16][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 8 * hh + g;
      const uint2* col = reinterpret_cast<const uint2*>(
          wt + (size_t)(wcol + (c < mul ? c : 0)) * kMaxHidden);
#pragma unroll
      for (int ks = 0; ks < kMaxHidden / 16; ++ks) {
        const uint2 v = __ldg(col + 4 * ks + t);
        b[hh][ks][0] = v.x;
        b[hh][ks][1] = v.y;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kMaxHidden / 16; ++ks)
        rowmix::mma_bf16(acc, a[ks], b[hh][ks]);
      // rows q = g, g + 8; columns c0 + 8 hh + 2 t, + 1
      bf16::T* w0 = s.w + (g * P + sl) * 16 + 8 * hh + 2 * t;
      *reinterpret_cast<uint32_t*>(w0) = rowmix::pack_bf16(acc[0], acc[1]);
      *reinterpret_cast<uint32_t*>(w0 + 8 * P * 16) =
          rowmix::pack_bf16(acc[2], acc[3]);
    }
  }
}

// x[src, m1, u] of staged edge q for this lane's rows u = c0 + g + 8 r and
// columns m1 = 8 mb + 2 t + b, zero past d1 and mul
template <int kMB>
__device__ __forceinline__ void load_x(bf16::T2 (&xr)[kMB][2], const Smem& s,
                                       const Layout& l, int q, int d1,
                                       int mul, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16::T* xq = s.x + q * l.xs;
  const bf16::T zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = c0 + g + 8 * r, m1 = 8 * mb + 2 * t;
      const bf16::T* xu = xq + u * d1 + m1;
      xr[mb][r] = __halves2bfloat162(u < mul && m1 < d1 ? xu[0] : zero,
                                     u < mul && m1 + 1 < d1 ? xu[1] : zero);
    }
}

// 2. and 3.: acc[nt] = O C over the unit's forward tiles for staged edge q,
// f32 (the caller rounds).  The outer products are formed as each k-step's
// A fragment, two a bfloat16x2 product (rounded once, as the f32 product
// rounded): a0 (row g, j = 2 jp), a1 (row g + 8), a2 (row g, j = 2 jp + 1),
// a3 (row g + 8), columns m1 = 8 mb + 2 t, + 1.
template <int kNt, int kMB>
__device__ __forceinline__ void mid_mma(float (&acc)[kNt][4], const Smem& s,
                                        int q, const bf16::T2 (&xr)[kMB][2],
                                        int lane) {
  const int* u = s.itab;
  const int NT = u[kUNT], MB = u[kUMB], JP = u[kUKS] / MB;
  const int2* fmap = reinterpret_cast<const int2*>(u + u[kUFmap]);
  const float* shq = s.sh + q * kMaxSh;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
  for (int jp = 0; jp < kJP; ++jp) {
    if (jp >= JP) break;
    const bf16::T2 s0 = __float2bfloat162_rn(shq[2 * jp]);
    const bf16::T2 s1 = __float2bfloat162_rn(shq[2 * jp + 1]);
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      if (mb >= MB) break;
      const uint32_t a[4] = {bf16::bits(__hmul2_rn(s0, xr[mb][0])),
                             bf16::bits(__hmul2_rn(s0, xr[mb][1])),
                             bf16::bits(__hmul2_rn(s1, xr[mb][0])),
                             bf16::bits(__hmul2_rn(s1, xr[mb][1]))};
      const int2 fm = fmap[jp * MB + mb];   // (mask, base)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        if (!(fm.x >> nt & 1)) continue;
        const int ti = fm.y + __popc(fm.x & ((1 << nt) - 1));
        const uint2 bv = s.tiles[ti * 32 + lane];
        const uint32_t b[2] = {bv.x, bv.y};
        rowmix::mma_bf16(acc[nt], a, b);
      }
    }
  }
}

// the radial weights of staged edge q, local channel c, path slots s0 and
// s1 (two neighbouring columns)
__device__ __forceinline__ bf16::T2 radial2(const Smem& s, int q, int s0,
                                            int s1, int c) {
  const bf16::T* w = s.w + q * s.itab[kUPaths] * 16 + c;
  return __halves2bfloat162(w[s0 * 16], w[s1 * 16]);
}

// The launch's shared memory and the kernel's: dims the host table
// dimensions; refuses what the tables or the templates cannot hold.
template <typename Kernel>
static inline cudaError_t prepare(Kernel kernel, const int* dims, int mul,
                                  int J, int H, bool k2, Layout& l) {
  if (mul < 1 || mul > 16 * kWarps || J > kMaxSh || H > kMaxHidden ||
      dims[kDNT] > 12 || dims[kDXw] < 1)
    return cudaErrorInvalidValue;
  l = layout(dims, (mul + 15) / 16, k2);
  if (l.end > 227 * 1024) return cudaErrorInvalidValue;
  return walk::allow_smem(kernel, l.end);
}

}  // namespace bwalk
