// The bfloat16 edge walks of K1 and K2 (k1_bf16_walk_kernel,
// k2_bf16_walk_kernel, launched by full_conv.cu and full_conv_bwd.cu), and
// of K4f and K4b on the caller's radial weights and of K4g's two walks on
// them and their cotangents (the same kernels with kOps 1 and 2, launched
// by full_conv_ext.cu): the TPU kernel's CG step at
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

#include <type_traits>

#include "bf16.cuh"
#include "edge_walk.cuh"
#include "row_mix.cuh"

namespace bwalk {

using walk::kMaxHidden;
using walk::kMaxSh;
using walk::kStage;

// What a walk's radial weights are (the kernels' kOps): the MLP's, made
// in the walk (K1, K2), the caller's w (K4f, K4b), or the caller's w and
// its cotangent cw, with the cotangents cx and csh of x and sh (K4g)
enum : int { kMlp = 0, kExt = 1, kExt2 = 2 };

// K4g's cotangent operands (kOps kExt2; null otherwise): cx [N, in_dim],
// csh [E, J], cw [E, PC], bfloat16
struct Cot {
  const bf16::T* x;
  const bf16::T* sh;
  const bf16::T* w;
};

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
// [kStage][paths][16] bf16 and (K2) the dw products [16][pr_pitch] bf16;
// (two: K4g) the cotangents' cx slices, csh and per warp cw, as x, sh, w.
struct Layout {
  int tiles, h, x, itab, idx, sh, w, pr, x2, sh2, w2, end;
  int xs;          // x row pitch (elements, a multiple of 8)
  int w_warp;      // elements of a warp's radial weights
  int pr_pitch;    // elements of a row of a warp's dw products
};

static inline int align16(int b) { return (b + 15) & ~15; }

static inline Layout layout(const int* dims, int warps, bool k2,
                            bool two) {
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
  l.x2 = at;
  if (two) at += align16(kStage * l.xs * 2);
  l.sh2 = at;
  if (two) at += kStage * kMaxSh * 4;
  l.w2 = at;
  if (two) at += align16(warps * l.w_warp * 2);
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
  bf16::T* x2;     // (K4g) cx, csh and this warp's cw, as x, sh, w
  float* sh2;
  bf16::T* w2;
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
  s.x2 = reinterpret_cast<bf16::T*>(base + l.x2);
  s.sh2 = reinterpret_cast<float*>(base + l.sh2);
  s.w2 = reinterpret_cast<bf16::T*>(base + l.w2) + warp * l.w_warp;
  return s;
}

// Once per block: the unit's region of the tables and its tiles into
// shared memory, the staged h and sh (two: and csh) zeroed (their columns
// past H and J are never copied).  The caller's barrier follows.
__device__ __forceinline__ void stage_unit(const Smem& s,
                                           const int* __restrict__ tab,
                                           const int* __restrict__ tiles,
                                           int unit, int tid, int nthr,
                                           bool two) {
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
  if (two)
    for (int i = tid; i < kStage * kMaxSh; i += nthr) s.sh2[i] = 0.f;
}

// What a stage copies: the last hidden layer h_last [E, H] (rounded f32),
// sh [E, J] and the x slice [x_off, x_off + xw) of the walk's source node
// (the other endpoint when the key is the destination), both bfloat16;
// x_vec: the slices copy in 16-byte pieces; (K4g) cx and csh, staged as x
// and sh, or null.
struct Operands {
  const float* h_last;
  int H;
  const bf16::T* sh;
  int J;
  const bf16::T* x;
  int in_dim, x_off, xw;
  bool x_vec;
  const bf16::T* x2;
  const bf16::T* sh2;
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
  auto stage_x = [&](bf16::T* sx, const bf16::T* __restrict__ x) {
    if (op.x_vec) {
      const int x8 = xw / 8;
      for (int i = tid; i < nq * x8; i += nthr) {
        const int q = i / x8, c = i - q * x8;
        const int n = key_is_dst ? s.other[q] : s.node[q];
        __pipeline_memcpy_async(
            sx + q * l.xs + 8 * c,
            x + (size_t)n * op.in_dim + op.x_off + 8 * c, 16);
      }
    } else {
      for (int i = tid; i < nq * xw; i += nthr) {
        const int q = i / xw, c = i - q * xw;
        const int n = key_is_dst ? s.other[q] : s.node[q];
        sx[q * l.xs + c] = x[(size_t)n * op.in_dim + op.x_off + c];
      }
    }
  };
  stage_x(s.x, op.x);
  if (op.x2) stage_x(s.x2, op.x2);
  const int J = op.J;
  for (int i = tid; i < nq * J; i += nthr) {
    const int q = i / J, j = i - q * J;
    s.sh[q * kMaxSh + j] = bf16::f(op.sh[(size_t)s.edge[q] * J + j]);
    if (op.sh2)
      s.sh2[q * kMaxSh + j] = bf16::f(op.sh2[(size_t)s.edge[q] * J + j]);
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

// 1'. (kExt, the K4 family) the stage's radial weights for this warp's
// channels c0 .. c0 + 15 of each of the unit's paths, from the caller's
// bfloat16 w [E, PC] (already rounded; K4g: and cw into sw = s.w2), into
// sw[q][slot][c] = s.w[q][slot][c] (zero past the stage's nq edges and
// past mul).
__device__ __forceinline__ void stage_w(const Smem& s, bf16::T* sw,
                                        const bf16::T* __restrict__ w,
                                        int PC, int mul, int c0, int lane,
                                        int nq) {
  const int P = s.itab[kUPaths];
  const int* slots = s.itab + s.itab[kUSlot];
  for (int i = lane; i < kStage * P * 16; i += 32) {
    const int c = i & 15, r = i >> 4, q = r / P, sl = r - q * P;
    sw[i] = q < nq && c0 + c < mul
                 ? w[(size_t)s.edge[q] * PC + slots[3 * sl] + c0 + c]
                 : __float2bfloat16_rn(0.f);
  }
}

// x[src, m1, u] of staged edge q for this lane's rows u = c0 + g + 8 r and
// columns m1 = 8 mb + 2 t + b, zero past d1 and mul; sx: the staged x
// slices (s.x, or K4g's s.x2 for cx)
template <int kMB>
__device__ __forceinline__ void load_x(bf16::T2 (&xr)[kMB][2],
                                       const bf16::T* sx, const Layout& l,
                                       int q, int d1, int mul, int c0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16::T* xq = sx + q * l.xs;
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

// 2. and 3.: acc[nt] = O C over the unit's forward tiles for one staged
// edge, shq its staged sh row (or K4g's csh row), xr its x (or cx), f32
// (the caller rounds).  The outer products are formed as each k-step's
// A fragment, two a bfloat16x2 product (rounded once, as the f32 product
// rounded): a0 (row g, j = 2 jp), a1 (row g + 8), a2 (row g, j = 2 jp + 1),
// a3 (row g + 8), columns m1 = 8 mb + 2 t, + 1.
template <int kNt, int kMB>
__device__ __forceinline__ void mid_mma(float (&acc)[kNt][4], const Smem& s,
                                        const float* shq,
                                        const bf16::T2 (&xr)[kMB][2],
                                        int lane) {
  const int* u = s.itab;
  const int NT = u[kUNT], MB = u[kUMB], JP = u[kUKS] / MB;
  const int2* fmap = reinterpret_cast<const int2*>(u + u[kUFmap]);
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

// K4g's ab = bf16(mid_a + mid_b) of staged edge q: mid_a = bf16(O(sh, cx)
// C), mid_b = bf16(O(csh, x) C) (fused_conv.py:1755-1756), in the C
// fragments' layout; acc is left holding mid_b's sums.
template <int kNt, int kMB>
__device__ __forceinline__ void mid_ab(bf16::T2 (&ab)[kNt][2],
                                       float (&acc)[kNt][4], const Smem& s,
                                       int q, const bf16::T2 (&xr)[kMB][2],
                                       const bf16::T2 (&cxr)[kMB][2],
                                       int lane) {
  mid_mma<kNt, kMB>(acc, s, s.sh + q * kMaxSh, cxr, lane);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      ab[nt][r] = __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
  mid_mma<kNt, kMB>(acc, s, s.sh2 + q * kMaxSh, xr, lane);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      ab[nt][r] = __hadd2_rn(
          ab[nt][r],
          __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]));
}

// the radial weights (sw: s.w, or K4g's cotangents s.w2) of staged edge q,
// local channel c, path slots s0 and s1 (two neighbouring columns)
__device__ __forceinline__ bf16::T2 radial2(const Smem& s, const bf16::T* sw,
                                            int q, int s0, int s1, int c) {
  const bf16::T* w = sw + q * s.itab[kUPaths] * 16 + c;
  return __halves2bfloat162(w[s0 * 16], w[s1 * 16]);
}

// A unit's stage operands: x's slice [x_off, x_off + xw) and (K4g) cx's
__device__ __forceinline__ Operands operands(const float* h_last, int H,
                                             const bf16::T* sh, int J,
                                             const bf16::T* x, int in_dim,
                                             int x_off, int xw,
                                             const Cot& cot) {
  const bool vec = x_vectors(x, in_dim, x_off, xw) &&
                   (!cot.x || x_vectors(cot.x, in_dim, x_off, xw));
  return {h_last, H, sh, J, x, in_dim, x_off, xw, vec, cot.x, cot.sh};
}

// The launch's shared memory and the kernel's: dims the host table
// dimensions; refuses what the tables or the templates cannot hold.
template <typename Kernel>
static inline cudaError_t prepare(Kernel kernel, const int* dims, int mul,
                                  int J, int H, bool k2, bool two,
                                  Layout& l) {
  if (mul < 1 || mul > 16 * kWarps || J > kMaxSh || H > kMaxHidden ||
      dims[kDNT] > 12 || dims[kDXw] < 1)
    return cudaErrorInvalidValue;
  l = layout(dims, (mul + 15) / 16, k2, two);
  if (l.end > 227 * 1024) return cudaErrorInvalidValue;
  return walk::allow_smem(kernel, l.end);
}


// The walks of K1 and K2 (and, kExt, of K4f and K4b; kExt2, of K4g): see
// the head of the file.
using walk::Item;
using walk::item_walk;

// The bfloat16 walk (bf16_walk.cuh; see the head of the file).  grid (T
// items, units), block 32 x ceil(mul / 16) threads, warp w channels 16 w ..
// 16 w + 15.  Per staged edge q each warp forms mid = bf16(O C) of its 16
// channels and the unit's columns, then adds bf16(mid * w) to the node's
// sums in registers (the C fragments' layout: rows g, g + 8, columns 8 nt +
// 2 t, + 1); when the destination changes it stores the node's rows of
// the f32 scratch once (zeros for nodes without edges; a long run's piece
// into pieces), plain stores.  kNt: n-tiles of the widest unit (at most);
// kMB: m1 blocks of 8 of the widest left irrep.  kOps kExt (K4f): the
// radial weights are the caller's bfloat16 w [E, PC] (stage_w), not the
// MLP's; kExt2 (K4g's S_sum, fused_conv.py:1768): per edge w2d =
// bf16(bf16(ab w) + bf16(mid_c cw)) with ab = mid_ab's and mid_c = bf16(O
// C), so three CG chains an edge.
template <int kNt, int kMB, int kOps>
static __global__ void __launch_bounds__(
    128, kNt <= 6 ? (kOps == kExt2 ? 3 : 5) : 2)
    k1_bf16_walk_kernel(
    const bf16::T* __restrict__ x, int in_dim,
    const bf16::T* __restrict__ sh, int J,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    const int* __restrict__ perm, const int* __restrict__ ptr, int N,
    int cap, int T,
    const float* __restrict__ h_last, int H,
    const bf16::T* __restrict__ wt,
    const int* __restrict__ tab, const int* __restrict__ tiles,
    const bwalk::Layout l,
    float* __restrict__ scratch, float* __restrict__ pieces, int KM,
    int mul, const bf16::T* __restrict__ w_ext, int PC, const Cot cot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int c0 = 16 * warp, t = blockIdx.x;
  const bwalk::Smem s = bwalk::carve(smem, l, warp);
  bwalk::stage_unit(s, tab, tiles, blockIdx.y, tid, nthr, kOps == kExt2);
  __syncthreads();
  const int* unit = tab + __ldg(tab + blockIdx.y);
  const int x_off = __ldg(unit + bwalk::kUXOff);
  const int d1 = __ldg(unit + bwalk::kUD1);
  const int NT = __ldg(unit + bwalk::kUNT);
  const int* cols = s.itab + __ldg(unit + bwalk::kUCol);
  const bwalk::Operands op = operands(h_last, H, sh, J, x, in_dim, x_off,
                                      d1 * mul, cot);

  const Item it = item_walk(ptr, N, t, T, cap);
  float nacc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) nacc[nt][i] = 0.f;
  int cur = it.first;
  auto flush = [&](int n) {
    float* row = n == it.head ? pieces + (size_t)t * KM
                              : scratch + (size_t)n * KM;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      if (nt >= NT) break;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int srow = cols[2 * (8 * nt + 2 * tq + b)];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int u = c0 + g + 8 * r;
          if (srow >= 0 && u < mul)
            row[(size_t)srow * mul + u] = nacc[nt][2 * r + b];
          nacc[nt][2 * r + b] = 0.f;
        }
      }
    }
  };

  for (int pos0 = it.e_lo; pos0 < it.e_hi; pos0 += kStage) {
    const int nq = min(kStage, it.e_hi - pos0);
    bwalk::stage_edges(s, l, pos0, nq, perm, src, dst, true, op, tid, nthr);
    if constexpr (kOps == kMlp)
      radial_mma(s, wt, mul, c0, lane);
    else
      stage_w(s, s.w, w_ext, PC, mul, c0, lane, nq);
    if constexpr (kOps == kExt2) stage_w(s, s.w2, cot.w, PC, mul, c0, lane, nq);
    __syncwarp();
    for (int q = 0; q != nq; ++q) {
      const int nd = s.node[q];
      for (; cur < nd; ++cur) flush(cur);
      bf16::T2 xr[kMB][2];
      bwalk::load_x<kMB>(xr, s.x, l, q, d1, mul, c0, lane);
      float acc[kNt][4];
      if constexpr (kOps == kExt2) {
        bf16::T2 cxr[kMB][2], ab[kNt][2];
        bwalk::load_x<kMB>(cxr, s.x2, l, q, d1, mul, c0, lane);
        bwalk::mid_ab<kNt, kMB>(ab, acc, s, q, xr, cxr, lane);
        bwalk::mid_mma<kNt, kMB>(acc, s, s.sh + q * kMaxSh, xr, lane);
        // w2d = bf16(bf16(ab w) + bf16(bf16(mid_c) cw)), summed over the
        // node in f32
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          if (nt >= NT) break;
          const int col = 8 * nt + 2 * tq;
          const int s0 = cols[2 * col + 1], s1 = cols[2 * col + 3];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bf16::T2 mc =
                __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
            const bf16::T2 ww = bwalk::radial2(s, s.w, q, s0, s1, g + 8 * r);
            const bf16::T2 wc = bwalk::radial2(s, s.w2, q, s0, s1, g + 8 * r);
            const float2 p = __bfloat1622float2(
                __hadd2_rn(__hmul2_rn(ab[nt][r], ww), __hmul2_rn(mc, wc)));
            nacc[nt][2 * r] += p.x;
            nacc[nt][2 * r + 1] += p.y;
          }
        }
        continue;
      }
      bwalk::mid_mma<kNt, kMB>(acc, s, s.sh + q * kMaxSh, xr, lane);
      // w2d = bf16(bf16(mid) * w), two columns a bfloat16x2 product,
      // summed over the node in f32
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        if (nt >= NT) break;
        const int col = 8 * nt + 2 * tq;
        const int s0 = cols[2 * col + 1], s1 = cols[2 * col + 3];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16::T2 m =
              __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
          const bf16::T2 w = bwalk::radial2(s, s.w, q, s0, s1, g + 8 * r);
          const float2 p = __bfloat1622float2(__hmul2_rn(m, w));
          nacc[nt][2 * r] += p.x;
          nacc[nt][2 * r + 1] += p.y;
        }
      }
    }
  }
  for (; cur < it.end; ++cur) flush(cur);
}


// The bfloat16 edge walk (bf16_walk.cuh; see the head of the file).  grid
// (T items, units), block 32 x ceil(mul / 16) threads, warp w channels 16 w
// .. 16 w + 15.  Per staged edge q (source s = the walk's key, destination
// dn) each warp, on the C fragments of its 16 channels and the unit's
// columns (rows g, g + 8; columns 8 nt + 2 t, + 1):
//   g     = bf16(dS[dn, srow(col), u])              (a gather, f32 rounded)
//   mid   = bf16(O C)                               (bf16_walk.cuh)
//   prod  = bf16(g mid)    -> the warp's shared rows; dw[e, wcol + u] = the
//                             bf16 sum over the path's m3 in order
//   dmid  = bf16(g w)      -> packed, two n-tiles a k-step, as the A
//                             fragments of douter = bf16(dmid C^T), one MMA
//                             chain per (j, m1 block) over the unit's
//                             non-zero backward tiles
//   dx_e  = the bf16 sum over j in order of bf16(sh_j douter[j])   (in the
//           lane: its two channels' m1 = 8 mb + 2 t, + 1 of every j)
// and sums dx_e over the node's edges in f32, stored once per node (dx
// rounded; a long run's piece into pieces [T, in_dim], f32).  kNt, kMB as
// in K1's k1_bf16_walk_kernel.  kOps kExt (K4b): the radial weights are
// the caller's bfloat16 w [E, PC] (stage_w); dw is stored bfloat16 and dx
// float32 (K4b's raw outputs), and the unit's share of the sh cotangent,
// per edge, j and channel the float32 sum over the unit's components of
// bf16(douter[j, m1] x[m1]), goes to part [units, E, J, mul] (dsh_sum adds
// the units and the channels).  kExt2 (K4g's c_w, c_x and c_s,
// fused_conv.py:1786-1870): mid is ab (mid_ab), so prod = bf16(g ab)
// gives c_w; dow = bf16(bf16(g w) C^T) and doc = bf16(bf16(g cw) C^T) are
// two C^T chains on the same tiles; c_x's term is bf16(bf16(csh_j dow) +
// bf16(sh_j doc)), summed over j in bfloat16; the shares of dow . cx and
// of doc . x go to part's two halves [2, units, E, J, mul].
template <int kNt, int kMB, int kOps>
static __global__ void __launch_bounds__(128, kNt <= 6 ? 4 : 2)
    k2_bf16_walk_kernel(
    const bf16::T* __restrict__ x, int in_dim,
    const bf16::T* __restrict__ sh, int J,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    const int* __restrict__ perm, const int* __restrict__ ptr, int N, int E,
    int cap, int T,
    const float* __restrict__ h_last, int H,
    const bf16::T* __restrict__ wt, int PC,
    const int* __restrict__ tab, const int* __restrict__ tiles,
    const bwalk::Layout l,
    const float* __restrict__ dS, int KM, int mul,
    std::conditional_t<kOps != kMlp, bf16::T, float>* __restrict__ dw,
    std::conditional_t<kOps != kMlp, float, bf16::T>* __restrict__ dx,
    float* __restrict__ pieces, const bf16::T* __restrict__ w_ext,
    float* __restrict__ part, const Cot cot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int c0 = 16 * warp, t = blockIdx.x;
  const bwalk::Smem s = bwalk::carve(smem, l, warp);
  bwalk::stage_unit(s, tab, tiles, blockIdx.y, tid, nthr, kOps == kExt2);
  __syncthreads();
  const int* unit = tab + __ldg(tab + blockIdx.y);
  const int x_off = __ldg(unit + bwalk::kUXOff);
  const int d1 = __ldg(unit + bwalk::kUD1);
  const int NT = __ldg(unit + bwalk::kUNT), MB = __ldg(unit + bwalk::kUMB);
  const int P = __ldg(unit + bwalk::kUPaths);
  const int* cols = s.itab + __ldg(unit + bwalk::kUCol);
  const int* slots = s.itab + __ldg(unit + bwalk::kUSlot);
  const int2* bmap =
      reinterpret_cast<const int2*>(s.itab + __ldg(unit + bwalk::kUBmap));
  const bwalk::Operands op = operands(h_last, H, sh, J, x, in_dim, x_off,
                                      d1 * mul, cot);
  constexpr int kKk = kNt / 2;
  // (K4g) the second half of part: the shares of doc . x
  float* const part2 = part + (size_t)gridDim.y * E * J * mul;

  const Item it = item_walk(ptr, N, t, T, cap);
  float dxv[kMB][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) dxv[mb][i] = 0.f;
  int cur = it.first;
  auto flush = [&](int n) {
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = c0 + g + 8 * (i >> 1), m1 = 8 * mb + 2 * tq + (i & 1);
        if (u < mul && m1 < d1) {
          const size_t col = (size_t)x_off + u * d1 + m1;
          if (n == it.head)
            pieces[(size_t)t * in_dim + col] = dxv[mb][i];
          else
            bf16::put(dx + (size_t)n * in_dim + col, dxv[mb][i]);
        }
        dxv[mb][i] = 0.f;
      }
  };

  for (int pos0 = it.e_lo; pos0 < it.e_hi; pos0 += kStage) {
    const int nq = min(kStage, it.e_hi - pos0);
    bwalk::stage_edges(s, l, pos0, nq, perm, src, dst, false, op, tid, nthr);
    if constexpr (kOps == kMlp)
      radial_mma(s, wt, mul, c0, lane);
    else
      stage_w(s, s.w, w_ext, PC, mul, c0, lane, nq);
    if constexpr (kOps == kExt2) stage_w(s, s.w2, cot.w, PC, mul, c0, lane, nq);
    __syncwarp();
    for (int q = 0; q != nq; ++q) {
      const int nd = s.node[q];
      for (; cur < nd; ++cur) flush(cur);
      // the cotangent rows of the destination, gathered first
      const float* grow = dS + (size_t)s.other[q] * KM;
      float gv[kNt][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        if (nt >= NT) break;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int srow = cols[2 * (8 * nt + 2 * tq + b)];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int u = c0 + g + 8 * r;
            gv[nt][2 * r + b] = srow >= 0 && u < mul
                                    ? __ldg(grow + (size_t)srow * mul + u)
                                    : 0.f;
          }
        }
      }
      bf16::T2 xr[kMB][2];
      bwalk::load_x<kMB>(xr, s.x, l, q, d1, mul, c0, lane);
      float acc[kNt][4];
      // (K4g) cx's rows, ab, and the A fragments of bf16(g cw)
      bf16::T2 cxr[kOps == kExt2 ? kMB : 1][2];
      bf16::T2 ab[kOps == kExt2 ? kNt : 1][2];
      uint32_t apc[kOps == kExt2 ? kKk : 1][4];
      if constexpr (kOps == kExt2) {
        bwalk::load_x<kMB>(cxr, s.x2, l, q, d1, mul, c0, lane);
        bwalk::mid_ab<kNt, kMB>(ab, acc, s, q, xr, cxr, lane);
      } else {
        bwalk::mid_mma<kNt, kMB>(acc, s, s.sh + q * kMaxSh, xr, lane);
      }
      // prod = bf16(g mid) into the warp's rows, dmid = bf16(g w) as the
      // A fragments of douter, two columns a bfloat16x2 product (each
      // product of two bfloat16 values rounded once, as the f32 product
      // rounded)
      uint32_t ap[kKk][4];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        if (nt >= NT) break;
        const int col = 8 * nt + 2 * tq;
        const int s0 = cols[2 * col + 1], s1 = cols[2 * col + 3];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bf16::T2 gb =
              __floats2bfloat162_rn(gv[nt][2 * r], gv[nt][2 * r + 1]);
          bf16::T2 m;
          if constexpr (kOps == kExt2)
            m = ab[nt][r];
          else
            m = __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
          *reinterpret_cast<bf16::T2*>(s.pr + (g + 8 * r) * l.pr_pitch +
                                       col) = __hmul2_rn(gb, m);
          ap[nt / 2][2 * (nt & 1) + r] = bf16::bits(
              __hmul2_rn(gb, bwalk::radial2(s, s.w, q, s0, s1, g + 8 * r)));
          if constexpr (kOps == kExt2)
            apc[nt / 2][2 * (nt & 1) + r] = bf16::bits(__hmul2_rn(
                gb, bwalk::radial2(s, s.w2, q, s0, s1, g + 8 * r)));
        }
      }
      // douter per (j, m1 block), then dx_e over j in order: rows g, g + 8,
      // columns m1 = 8 mb + 2 t, + 1, bfloat16x2 (a sum of two bfloat16
      // values rounded once equals the f32 sum rounded; the _rn forms keep
      // the compiler from fusing the product and the sum into one FMA,
      // which would round once where the contract rounds twice)
      const float* shq = s.sh + q * kMaxSh;
      const float* cshq = s.sh2 + q * kMaxSh;   // (K4g)
      bf16::T2 dxb[kMB][2];
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int r = 0; r < 2; ++r) dxb[mb][r] = __float2bfloat162_rn(0.f);
      const int e = s.edge[q];
#pragma unroll
      for (int j = 0; j < kMaxSh; ++j) {
        if (j >= J) break;
        const bf16::T2 sj = __float2bfloat162_rn(shq[j]);
        // kExt: rows g, g + 8's dsh shares (K4g: of dow . cx, doc . x)
        float dsp[2] = {0.f, 0.f}, dsp2[2] = {0.f, 0.f};
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
          if (mb >= MB) break;
          const int2 bm = bmap[j * MB + mb];     // (mask, base)
          // a j that no path of the unit reads adds bf16(sh_j 0): nothing
          if (!bm.x) continue;
          float c[4] = {0.f, 0.f, 0.f, 0.f}, cc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kKk; ++kk) {
            if (!(bm.x >> kk & 1)) continue;
            const int ti = bm.y + __popc(bm.x & ((1 << kk) - 1));
            const uint2 bv = s.tiles[ti * 32 + lane];
            const uint32_t b[2] = {bv.x, bv.y};
            rowmix::mma_bf16(c, ap[kk], b);
            if constexpr (kOps == kExt2) rowmix::mma_bf16(cc, apc[kk], b);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const bf16::T2 d = __floats2bfloat162_rn(c[2 * r], c[2 * r + 1]);
            if constexpr (kOps == kExt2) {
              // d = dow, dc = doc
              const bf16::T2 dc =
                  __floats2bfloat162_rn(cc[2 * r], cc[2 * r + 1]);
              const bf16::T2 cj = __float2bfloat162_rn(cshq[j]);
              dxb[mb][r] = __hadd2_rn(
                  dxb[mb][r],
                  __hadd2_rn(__hmul2_rn(cj, d), __hmul2_rn(sj, dc)));
              const float2 p = __bfloat1622float2(__hmul2_rn(d, cxr[mb][r]));
              const float2 p2 = __bfloat1622float2(__hmul2_rn(dc, xr[mb][r]));
              dsp[r] += p.x + p.y;
              dsp2[r] += p2.x + p2.y;
            } else {
              dxb[mb][r] = __hadd2_rn(dxb[mb][r], __hmul2_rn(sj, d));
              if constexpr (kOps == kExt) {
                const float2 p = __bfloat1622float2(__hmul2_rn(d, xr[mb][r]));
                dsp[r] += p.x + p.y;
              }
            }
          }
        }
        if constexpr (kOps != kMlp) {
          // the row's sum over the unit's components: the four lanes of a
          // row hold its columns (m1 = 8 mb + 2 t, + 1)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            dsp[r] += __shfl_xor_sync(0xffffffffu, dsp[r], 1);
            dsp[r] += __shfl_xor_sync(0xffffffffu, dsp[r], 2);
            if constexpr (kOps == kExt2) {
              dsp2[r] += __shfl_xor_sync(0xffffffffu, dsp2[r], 1);
              dsp2[r] += __shfl_xor_sync(0xffffffffu, dsp2[r], 2);
            }
            const int u = c0 + g + 8 * r;
            const size_t at = (((size_t)blockIdx.y * E + e) * J + j) * mul + u;
            if (tq == 0 && u < mul) {
              part[at] = dsp[r];
              if constexpr (kOps == kExt2) part2[at] = dsp2[r];
            }
          }
        }
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = __bfloat1622float2(dxb[mb][r]);
          dxv[mb][2 * r] += v.x;
          dxv[mb][2 * r + 1] += v.y;
        }
      // dw: the bf16 sum over each path's m3 in order, lane (row, slot),
      // four (row, slot) pairs' chains at a time
      __syncwarp();
      for (int i0 = lane; i0 < 16 * P; i0 += 4 * 32) {
        bf16::T v[4];
        const bf16::T* pp[4];
        int d3[4], d3_max = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + 32 * k, row = i & 15;
          const bool ok = i < 16 * P && c0 + row < mul;
          const int* sp = slots + 3 * (ok ? i >> 4 : 0);
          pp[k] = s.pr + row * l.pr_pitch + sp[1];
          d3[k] = ok ? sp[2] : 0;
          v[k] = pp[k][0];
          d3_max = max(d3_max, d3[k]);
        }
        for (int m3 = 1; m3 < d3_max; ++m3)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (m3 < d3[k]) v[k] = __hadd_rn(v[k], pp[k][m3]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + 32 * k;
          if (d3[k])
            bf16::put(dw + (size_t)e * PC + slots[3 * (i >> 4)] + c0 +
                          (i & 15),
                      __bfloat162float(v[k]));
        }
      }
      __syncwarp();
    }
  }
  for (; cur < it.end; ++cur) flush(cur);
  // edges outside [0, N) are walked by no one: their dw is zero
  const int lo = max(t * cap, ptr[N]), hi = min(t * cap + cap, E);
  for (int i = tid; i < (hi - lo) * P * mul; i += nthr) {
    const int pos = lo + i / (P * mul), r = i % (P * mul);
    bf16::put(dw + (size_t)perm[pos] * PC + slots[3 * (r / mul)] + r % mul,
              0.f);
  }
  if constexpr (kOps != kMlp)
    for (int i = tid; i < (hi - lo) * J * mul; i += nthr) {
      const size_t at =
          ((size_t)blockIdx.y * E + perm[lo + i / (J * mul)]) * J * mul +
          i % (J * mul);
      part[at] = 0.f;
      if constexpr (kOps == kExt2) part2[at] = 0.f;
    }
}


}  // namespace bwalk
