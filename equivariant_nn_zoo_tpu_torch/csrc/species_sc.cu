// Species-table self-connection, forward (K3) and backward (K3b).
//
// The forward replaces the TPU kernel SpeciesScalarFCTP._fwd_kernel in
// equivariant_nn_zoo_tpu/ops/pallas/sc.py (the body at :181, launched at
// :301).  When the node attributes are a pure per-species embedding, the
// self-connection FullyConnectedTensorProduct reduces to
//
//   out_l[n] = x_l[n] @ A_l[species_n],   A_l[t] = rep_t @ W_l * pw / sqrt(d)
//
// per instruction ("item") l, input slot -> output slot.  The tables A (one
// [types, sum of mul1 * mul_out] matrix; row t holds A_l[t] of every item)
// are built in plain PyTorch by the wrapper; these kernels are the
// per-species products.  The backward replaces
// SpeciesScalarFCTP._bwd_kernel (sc.py:208, launched at :315):
//
//   dx_l[n] = g_l[n] @ A_l[species_n]^T,
//   dA_l[t] = sum over nodes n of species t of x_l[n]^T g_l[n].
//
// Every kernel walks the nodes species-major, on the order of
// ops/cuda/species_order.py: perm lists the node ids sorted by species and
// ptr[t]: ptr[t + 1] is species t's run; nodes of an out-of-range species
// lie past ptr[types].  The kernels cut each run into tiles of consecutive
// positions themselves: a launch's blocks are its entries' tiles in turn,
// an entry's tiles are its runs' tiles in turn, and each block finds its
// own by a short scan of the entries and of ptr (tile_bound bounds an
// entry's count; the blocks past the real tiles return at once).  A tile
// holds one species, so its block stages that species' table once.
//
// K3 and K3b's dx (table_product_kernel): a block takes one tile of one
// entry, an output slot (dx: an input slot) and a 64-wide tile of its
// columns.  A tile holds up to 128 (node, component) rows, fewer where the
// slot's reduction is longer than one 64-long chunk (dx of the 0e slot,
// which feeds the gate's wide scalar slot), so that blocks do like work;
// the entry carries its nodes per tile.  Per item of the slot and 64-long
// chunk of its reduction, the block stages by cp.async A_t's [64 x 64]
// tile in shared memory (dx: transposed) and its nodes' input rows, mul1 *
// d contiguous floats per node read coalesced and stored transposed to
// (node, m) rows; then each thread keeps 8 rows x 4 columns in registers
// (a float4 of A against a float4 of the rows per step).  The items of
// the slot are summed in registers; the tile goes out through shared
// memory, each element stored once, coalesced along the node's (w, m)
// columns.  A tile of the tail run
// (out-of-range species) and a slot no item writes store zeros: no
// memset.
//
// K3b's dtables (table_grad_kernel, table_grad_sum_kernel): a block takes
// one chunk of one species' run (chunk_rows / d nodes) and one 64 x 64
// (u, w) tile of one item, stages its x and g rows in rounds of 64 (node,
// m) rows, two rounds in flight, and sums X^T G over them, 4 x 4 per
// thread; its tile goes to the workspace whole.  A second pass adds each
// species' chunk tiles in chunk order and writes dA, zeros for a species
// with no node.  No atomics: every output repeats bit for bit.  The chunk
// length is the wrapper's choice, from N and the card's multiprocessor
// count.
//
// What bounds them: each reads its operands once and writes each output
// once, so the bytes (x, g, out or dx) bound K3 and dx, and the float32
// products (2 N mul1 mul_out d per item) dtables.  On the card the blocks
// spend their time in the float32 products and in staging, which overlap
// little (chip_smoke.py --walk-ablation species_sc.cu).
//
// The TPU kernels' dense per-species products with species masks over
// [(Tn * d), M1] tiles and their e/o slot pairing were MXU devices and are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_mix.cuh"

namespace {

using rowmix::cp_async4;
using rowmix::cp_async_commit;
using rowmix::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kCols = 64;          // columns of a tile: w (K3), u (dx)
constexpr int kK = 64;             // reduction chunk: u (K3), w (dx)
constexpr int kRows = 128;         // (node, component) rows of a tile, at most
constexpr int kPitch = kCols + 4;  // shared row pitch, in floats
constexpr int kRound = 64;         // rows per staging round of dtables
constexpr int kSlotFields = 5;     // dst offset, d, width, item begin, end
constexpr int kFwdItemFields = 3;  // x_off, mul1, a_off
constexpr int kBwdItemFields = 6;  // x_off, mul1, a_off, out_off, d, mul_out
constexpr int kEntryFields = 4;    // slot, first column, d, nodes per tile
constexpr int kGradEntryFields = 4;  // item, u0, w0, d
constexpr int kTile = kCols * kCols;  // floats of a dtables tile
constexpr int kProductSmem = (kK + kRows) * kPitch * (int)sizeof(float);
constexpr int kGradSmem = 2 * 2 * kRound * kPitch * (int)sizeof(float);

__host__ __device__ inline int tile_nodes(int rows, int d) {
  return rows / d > 1 ? rows / d : 1;
}

// at most this many tiles: each run's last one may be short
__host__ __device__ inline int tile_bound(int N, int tn, int runs) {
  return (N + tn - 1) / tn + runs;
}

// nodes per tile of an entry: its last field (K3, dx: rows == 0), or
// `rows` (node, component) rows at the d of its last field (dtables)
__host__ __device__ inline int entry_nodes(const int* pe, int fields,
                                           int rows) {
  return rows > 0 ? tile_nodes(rows, pe[fields - 1]) : pe[fields - 1];
}

// Block b's entry e, the tiles of the entries before it (base) and b's
// tile index within e.
__device__ inline bool find_entry(int& b, const int* entries, int n_entries,
                                  int fields, int rows, int N, int runs,
                                  int& e, int& base) {
  base = 0;
  for (e = 0; e < n_entries; ++e) {
    const int bound =
        tile_bound(N, entry_nodes(entries + e * fields, fields, rows), runs);
    if (b < bound) return true;
    b -= bound;
    base += bound;
  }
  return false;
}

// Tile i of the runs in tiles of tn positions: run r < types is species
// r's, run types (when runs = types + 1) the tail of out-of-range species.
__device__ inline bool find_tile(int i, int tn, const int* ptr, int types,
                                 int runs, int N, int& r, int& p0, int& p1) {
  for (r = 0; r < runs; ++r) {
    const int b = ptr[r], e = r < types ? ptr[r + 1] : N;
    const int nt = (e - b + tn - 1) / tn;
    if (i < nt) {
      p0 = b + i * tn;
      p1 = min(p0 + tn, e);
      return true;
    }
    i -= nt;
  }
  return false;
}

// rows_s[(nl * d + m) * kPitch + k] <- src[nodes[nl], off + k * d + m] for
// nl < nn and k < kK by cp.async, zero for k >= kc: a warp per node, its
// lanes along the node's contiguous floats.  The caller commits and waits.
__device__ inline void stage_rows(float* rows_s, const int* nodes, int nn,
                                  const float* __restrict__ src, int src_dim,
                                  int off, int d, int kc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int span = kK * d, dk = 32 / d, dm = 32 % d;
  for (int nl = warp; nl < nn; nl += kThreads / 32) {
    const float* row = src + (size_t)nodes[nl] * src_dim + off;
    float* dst = rows_s + nl * d * kPitch;
    int k = lane / d, m = lane % d;
    for (int j = lane; j < span; j += 32) {
      const bool live = k < kc;
      cp_async4(dst + m * kPitch + k, live ? row + j : src, live ? 4 : 0);
      k += dk;
      m += dm;
      if (m >= d) {
        m -= d;
        k += 1;
      }
    }
  }
}

// kBwd false, K3:  out[n, out_off + w*d + m] = sum over the slot's items,
//                    sum_u x[n, x_off + u*d + m] A[t, a_off + u*mo + w];
// kBwd true, dx:   dx[n, x_off + u*d + m] = sum over the slot's items,
//                    sum_w g[n, out_off + w*d + m] A[t, a_off + u*mo + w].
// Thread (rg, cg) keeps rows rg + 16 r (r < 8) by columns 4 cg .. 4 cg + 3.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 3) table_product_kernel(
    const float* __restrict__ src, int src_dim,
    const int* __restrict__ perm, const int* __restrict__ ptr, int types,
    int N, const float* __restrict__ tables, int a_stride,
    const int* __restrict__ slots, const int* __restrict__ items,
    const int* __restrict__ entries, int n_entries,
    float* __restrict__ dst, int dst_dim) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [kK][kPitch]: A[k][c]
  float* x_s = A_s + kK * kPitch;  // [kRows][kPitch], then the out tile
  __shared__ int s_nodes[kRows];

  int b = blockIdx.x, e, base, t, p0, p1;
  if (!find_entry(b, entries, n_entries, kEntryFields, 0, N, types + 1, e,
                  base))
    return;
  const int* pe = entries + e * kEntryFields;
  const int* ps = slots + pe[0] * kSlotFields;
  const int c0 = pe[1], d = pe[2], tn = pe[3];
  const int dst_off = ps[0], width = ps[2], it0 = ps[3], it1 = ps[4];
  if (!find_tile(b, tn, ptr, types, types + 1, N, t, p0, p1)) return;
  const int cnt = p1 - p0, cw = min(kCols, width - c0), nrows = cnt * d;
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;
  const int rmax = rg < nrows ? (nrows - 1 - rg) / 16 + 1 : 0;
  for (int i = tid; i < cnt; i += kThreads) s_nodes[i] = perm[p0 + i];

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int it = t < types ? it0 : it1; it < it1; ++it) {
    int src_off, K, a_off, mo;
    if (kBwd) {
      const int* pi = items + it * kBwdItemFields;
      src_off = pi[3], K = pi[5], a_off = pi[2], mo = pi[5];
    } else {
      const int* pi = items + it * kFwdItemFields;
      src_off = pi[0], K = pi[1], a_off = pi[2], mo = width;
    }
    const float* A = tables + (size_t)t * a_stride + a_off;
    for (int k0 = 0; k0 < K; k0 += kK) {
      const int kc = min(kK, K - k0);
      __syncthreads();  // the nodes are in; the previous chunk's reads done
      for (int i = tid; i < kK * kCols; i += kThreads) {
        int k, c;
        size_t at;
        if (kBwd) {  // A[u = c][w = k]: unit stride along k; a warp takes
                     // 8 k x 4 c, so its shared stores hit 32 banks
          const int lane = i % 32, grp = i / 32;
          k = (grp % 8) * 8 + lane % 8;
          c = (grp / 8) * 4 + lane / 8;
          at = (size_t)(c0 + c) * mo + k0 + k;
        } else {     // A[u = k][w = c]: unit stride along c
          k = i / kCols;
          c = i % kCols;
          at = (size_t)(k0 + k) * mo + c0 + c;
        }
        const bool live = k < kc && c < cw;
        cp_async4(A_s + k * kPitch + c, live ? A + at : A, live ? 4 : 0);
      }
      stage_rows(x_s, s_nodes, cnt, src, src_dim, src_off + k0 * d, d, kc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int k = 0; k < kc; k += 4) {
        float4 a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[j] = *reinterpret_cast<const float4*>(A_s + (k + j) * kPitch +
                                                  cg * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r >= rmax) break;
          const float4 xv = *reinterpret_cast<const float4*>(
              x_s + (rg + 16 * r) * kPitch + k);
          acc[r][0] += xv.x * a[0].x + xv.y * a[1].x + xv.z * a[2].x +
                       xv.w * a[3].x;
          acc[r][1] += xv.x * a[0].y + xv.y * a[1].y + xv.z * a[2].y +
                       xv.w * a[3].y;
          acc[r][2] += xv.x * a[0].z + xv.y * a[1].z + xv.z * a[2].z +
                       xv.w * a[3].z;
          acc[r][3] += xv.x * a[0].w + xv.y * a[1].w + xv.z * a[2].w +
                       xv.w * a[3].w;
        }
      }
    }
  }

  // the tile through shared memory: out_s[nl][c * d + m], node stride kK * d
  __syncthreads();
  const int span = kCols * d;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r >= rmax) break;
    const int q = rg + 16 * r, nl = q / d, m = q - nl * d;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x_s[nl * span + (cg * 4 + c) * d + m] = acc[r][c];
  }
  __syncthreads();
  const int lane = tid % 32, warp = tid / 32, n_out = cw * d;
  for (int nl = warp; nl < cnt; nl += kThreads / 32) {
    float* row = dst + (size_t)s_nodes[nl] * dst_dim + dst_off + c0 * d;
    for (int j = lane; j < n_out; j += 32) row[j] = x_s[nl * span + j];
  }
}

// dtables partials: block (entry, chunk) writes its [64 u x 64 w] tile
// sum over the chunk's (node, m) rows of x[n, x_off + (u0+u)*d + m]
// g[n, out_off + (w0+w)*d + m] to ws[(base + chunk) * kTile].  The rows
// come in rounds of kRound / d nodes, the next round's copies in flight
// while the block sums the current one.
__global__ void __launch_bounds__(kThreads) table_grad_kernel(
    const float* __restrict__ x, int in_dim, const float* __restrict__ g,
    int out_dim, const int* __restrict__ perm, const int* __restrict__ ptr,
    int types, int N, const int* __restrict__ items,
    const int* __restrict__ entries, int n_entries, int chunk_rows,
    float* __restrict__ ws) {
  extern __shared__ float4 smem4[];
  float* bufs = reinterpret_cast<float*>(smem4);  // [2][x rows, g rows]

  int b = blockIdx.x, e, base, t, p0, p1;
  if (!find_entry(b, entries, n_entries, kGradEntryFields, chunk_rows, N,
                  types, e, base))
    return;
  const int* pe = entries + e * kGradEntryFields;
  const int* pi = items + pe[0] * kBwdItemFields;
  const int u0 = pe[1], w0 = pe[2], d = pe[3];
  const int x_off = pi[0], mul1 = pi[1], out_off = pi[3], mo = pi[5];
  if (!find_tile(b, tile_nodes(chunk_rows, d), ptr, types, types, N, t, p0,
                 p1))
    return;
  const int tid = threadIdx.x, ug = tid / 16, wg = tid % 16;
  const int per_round = kRound / d;
  const int n_rounds = (p1 - p0 + per_round - 1) / per_round;
  const int uc = min(kCols, mul1 - u0), wc = min(kCols, mo - w0);
  auto stage = [&](int i) {
    const int p = p0 + i * per_round, nr = min(per_round, p1 - p);
    float* x_s = bufs + (i & 1) * 2 * kRound * kPitch;
    stage_rows(x_s, perm + p, nr, x, in_dim, x_off + u0 * d, d, uc);
    stage_rows(x_s + kRound * kPitch, perm + p, nr, g, out_dim,
               out_off + w0 * d, d, wc);
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  stage(0);
  cp_async_commit();
  for (int i = 0; i < n_rounds; ++i) {
    if (i + 1 < n_rounds) stage(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* x_s = bufs + (i & 1) * 2 * kRound * kPitch;
    const float* g_s = x_s + kRound * kPitch;
    const int rows = min(per_round, p1 - p0 - i * per_round) * d;
    for (int r = 0; r < rows; ++r) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x_s + r * kPitch + ug * 4);
      const float4 gv =
          *reinterpret_cast<const float4*>(g_s + r * kPitch + wg * 4);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += xa[ii] * ga[jj];
    }
    __syncthreads();  // this buffer is staged again two rounds on
  }
  float* out = ws + (size_t)(base + b) * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (ug * 4 + i) * kCols + wg * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// dA[t, a_off + u*mo + w] = sum over species t's chunks, in chunk order, of
// the partial tiles; zero for a species with no node.  grid: (types,
// entries); four consecutive w per thread.
__global__ void __launch_bounds__(kThreads) table_grad_sum_kernel(
    const int* __restrict__ ptr, int types, int N,
    const int* __restrict__ items, const int* __restrict__ entries,
    int chunk_rows, const float* __restrict__ ws, float* __restrict__ dA,
    int a_stride) {
  const int t = blockIdx.x, e = blockIdx.y;
  int base = 0;
  for (int f = 0; f < e; ++f)
    base += tile_bound(N,
                       entry_nodes(entries + f * kGradEntryFields,
                                   kGradEntryFields, chunk_rows),
                       types);
  const int* pe = entries + e * kGradEntryFields;
  const int* pi = items + pe[0] * kBwdItemFields;
  const int u0 = pe[1], w0 = pe[2];
  const int tn = entry_nodes(pe, kGradEntryFields, chunk_rows);
  const int mul1 = pi[1], a_off = pi[2], mo = pi[5];
  int i0 = 0;
  for (int r = 0; r < t; ++r) i0 += (ptr[r + 1] - ptr[r] + tn - 1) / tn;
  const int nt = (ptr[t + 1] - ptr[t] + tn - 1) / tn;
  const float* part = ws + (size_t)(base + i0) * kTile;
  float* out = dA + (size_t)t * a_stride + a_off;
  for (int el = threadIdx.x * 4; el < kTile; el += kThreads * 4) {
    const int u = u0 + el / kCols, w = w0 + el % kCols;
    if (u >= mul1 || w >= mo) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nt; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(part + (size_t)c * kTile + el);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float* o = out + (size_t)u * mo + w;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (w + j < mo) o[j] = sv[j];
  }
}

// blocks of a K3 / dx launch, or -1 unless every entry's tile fits
// (1 <= d, 1 <= nodes, nodes * d <= kRows)
int product_blocks(const int* host_entries, int n_entries, int N, int runs) {
  long long n = 0;
  for (int e = 0; e < n_entries; ++e) {
    const int* pe = host_entries + e * kEntryFields;
    if (pe[2] < 1 || pe[3] < 1 || pe[2] * pe[3] > kRows) return -1;
    n += tile_bound(N, pe[3], runs);
  }
  return n > INT32_MAX ? -1 : (int)n;
}

// blocks of the dtables partials (the workspace's tiles; the wrapper
// counts them by the same rule), or -1 unless every d is in [1, kRound]
int grad_blocks(const int* host_entries, int n_entries, int N, int types,
                int chunk_rows) {
  long long n = 0;
  for (int e = 0; e < n_entries; ++e) {
    const int* pe = host_entries + e * kGradEntryFields;
    if (pe[3] < 1 || pe[3] > kRound) return -1;
    n += tile_bound(N, entry_nodes(pe, kGradEntryFields, chunk_rows), types);
  }
  return n > INT32_MAX ? -1 : (int)n;
}

// the product and dtables kernels' shared memory exceeds the default
// 48 KB: raise the limit once per device
cudaError_t size_kernels() {
  static unsigned sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (sized >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(table_product_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kProductSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(table_product_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kProductSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(table_grad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGradSmem);
  if (err != cudaSuccess) return err;
  if (dev < 32) sized |= 1u << dev;
  return cudaSuccess;
}

}  // namespace

extern "C" int species_sc_fwd(
    const float* x, int N, int in_dim, const int* perm, const int* ptr,
    int types, const float* tables, int a_stride, const int* slots,
    const int* items, const int* entries, const int* host_entries,
    int n_entries, float* out, int out_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = product_blocks(host_entries, n_entries, N, types + 1);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || blocks == 0) return (int)cudaSuccess;
  cudaError_t err = size_kernels();
  if (err != cudaSuccess) return (int)err;
  table_product_kernel<false><<<blocks, kThreads, kProductSmem, s>>>(
      x, in_dim, perm, ptr, types, N, tables, a_stride, slots, items,
      entries, n_entries, out, out_dim);
  return (int)cudaGetLastError();
}

extern "C" int species_sc_bwd(
    const float* x, int N, int in_dim, const int* perm, const int* ptr,
    int types, const float* tables, int a_stride, const float* g,
    int out_dim, const int* in_slots, const int* items,
    const int* dx_entries, const int* host_dx_entries, int n_dx_entries,
    const int* grad_entries, const int* host_grad_entries,
    int n_grad_entries, int chunk_rows, float* ws, int ws_len,
    float* dx, float* dA, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dx_blocks =
      product_blocks(host_dx_entries, n_dx_entries, N, types + 1);
  const int n_grad = chunk_rows < 1 ? -1
                                    : grad_blocks(host_grad_entries,
                                                  n_grad_entries, N, types,
                                                  chunk_rows);
  if (dx_blocks < 0 || n_grad < 0 || (long long)n_grad * kTile > ws_len)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = size_kernels();
  if (err != cudaSuccess) return (int)err;
  if (N > 0 && dx_blocks > 0) {
    table_product_kernel<true><<<dx_blocks, kThreads, kProductSmem, s>>>(
        g, out_dim, perm, ptr, types, N, tables, a_stride, in_slots, items,
        dx_entries, n_dx_entries, dx, in_dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0 && n_grad > 0) {
    table_grad_kernel<<<n_grad, kThreads, kGradSmem, s>>>(
        x, in_dim, g, out_dim, perm, ptr, types, N, items, grad_entries,
        n_grad_entries, chunk_rows, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (types > 0 && n_grad_entries > 0)
    table_grad_sum_kernel<<<dim3(types, n_grad_entries), kThreads, 0, s>>>(
        ptr, types, N, items, grad_entries, chunk_rows, ws, dA, a_stride);
  return (int)cudaGetLastError();
}
