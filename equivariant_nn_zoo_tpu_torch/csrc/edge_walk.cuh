// The node-major edge walk shared by the whole-convolution forward (K1,
// full_conv.cu) and its backward (K2, full_conv_bwd.cu), and by the force
// path's external-weight kernels (K4f, K4b, K4g, full_conv_ext.cu).
//
// An edge order (ops/cuda/edge_order.py, built once per model forward in
// plain PyTorch) lists the edges sorted by one endpoint, the key (the
// destination for K1, the source for K2): perm[pos] is the edge at sorted
// position pos, ptr[n] .. ptr[n + 1] the positions of node n's run, and the
// edges with an endpoint outside [0, N) sit past ptr[N] and are walked by
// no one.
//
// Work items.  Item t owns the positions [t * cap, (t + 1) * cap) in the
// sense below; a block is one (item, chunk of paths) pair, so the grid is
// T = ceil(E / cap) items by the chunks, and the host picks cap so that
// even 96 edges give a thousand blocks.
// - A node is short when its run holds at most cap edges.  Item t walks
//   every short node whose run starts in [t * cap, (t + 1) * cap) (nodes
//   without edges included, so every node is written), the whole run, and
//   writes the node's result once with a plain store.  A short run never
//   reaches past the next item's first position by more than cap.
// - A long node (more than cap edges: a hub, or the dummy node that every
//   padded edge points at) is cut into pieces: item floor(a / cap) + 1
//   walks [a, (that item + 1) * cap), every later item it covers walks its
//   own cap positions, each into its own row of a pieces buffer [T, width]
//   with plain stores, and walk_piece_sum_kernel adds a long node's pieces
//   in item order into its row.  An item holds at most one piece (its
//   head), so no block walks more than 4 * cap edges, and no long run
//   sets the time of the whole call.
// Every sum is taken in a fixed order, so the results repeat bit for bit
// from launch to launch.
//
// Inside a block, thread (u, g) owns channel u of the chunk's g-th path
// (all paths of a chunk share one left irrep) and walks the item's edges in
// key order, keeping the node's running sums in registers until the key
// changes.  The edges are staged kStage at a time (hidden activations or
// external radial weights, sh, the x[src] slice, and for K4g a second sh
// and x operand: contiguous rows, copied with cp.async so that all of a
// stage's gathers are in flight together), then per stage:
// - K1 and K2's radial weights w[q] = h_L[q] . W_out[:, wcol + u] of all
//   staged edges at once, kStage independent sums per thread, each W_out
//   element read once per stage (through L1/L2) and used for kStage
//   edges (the K4 kernels stage their own column of w instead);
// - per (edge, path) the CG matrix contracted with sh,
//   M[q][m3][m1] = sum_m2 C[m1, m2, m3] sh[q, m2], built once by the
//   path's 64 threads from the wigner_3j non-zeros (by cell (m3, m1)),
//   so that each channel's work is a small dense product with
//   compile-time register indices: K1 adds w * M x into its d3 sums, K2
//   forms t = M^T g from the gathered cotangent rows.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr int kGroups = 4;       // blockDim.y: paths walked per block
constexpr int kStage = 16;       // edges staged in shared memory at a time
constexpr int kMaxHidden = 64;
constexpr int kMaxSh = 16;
constexpr int kMaxRadial = 64;   // radial MLP inputs (edge_radial's width)
constexpr int kMaxD = 9;         // components of an l <= 4 irrep
constexpr int kPieceThreads = 256;

// per-path fields of the walk table (ConvTables.walk_table): the paths in
// walk order (sorted by left irrep); kCell0 is the path's first entry in
// the cell table, whose d3 * d1 + 1 entries bound the path's wigner_3j
// non-zeros (sorted by m3, m1, m2) of each cell (m3, m1), absolute; kD2
// the components of the path's sh irrep
enum {
  kXOff = 0, kD1, kJ0, kD3, kRowBase, kRowStride, kWCol, kDCol, kCell0, kD2,
  kWalkFields
};

__device__ __forceinline__ float ssp(float v, float cst) {
  // (softplus(v) - log 2) * cst, softplus as max(v, 0) + log1p(exp(-|v|))
  float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
  return (sp - 0.69314718055994530942f) * cst;
}

// The radial MLP's hidden layers per edge, in edge order: a block takes
// kHiddenEdges edges and stages their R <= kMaxRadial inputs.  Stores the last layer's activations into h_out
// [E, H], or, with keep_all, every layer's pre-activations into z_all and
// activations into h_out, both [n_hidden, E, H].
constexpr int kHiddenEdges = 16;

static __global__ void mlp_hidden_kernel(
    const float* __restrict__ er, int R, int E,
    const float* __restrict__ w_hidden, int H, int n_hidden, float act_cst,
    float* __restrict__ z_all, float* __restrict__ h_out, int keep_all) {
  __shared__ float s_h[2][kHiddenEdges][kMaxHidden];
  __shared__ float s_er[kHiddenEdges][kMaxRadial];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int e0 = blockIdx.x * kHiddenEdges;
  const size_t EH = (size_t)E * H;
  for (int i = tid; i < kHiddenEdges * R; i += nthr) {
    int el = i / R, r = i % R, e = e0 + el;
    s_er[el][r] = e < E ? er[(size_t)e * R + r] : 0.f;
  }
  __syncthreads();
  int cur = 0;
  const float* wl = w_hidden;
  for (int layer = 0; layer < n_hidden; ++layer) {
    const int fan = layer == 0 ? R : H;
    const int next = layer == 0 ? 0 : cur ^ 1;
    for (int i = tid; i < kHiddenEdges * H; i += nthr) {
      int el = i / H, hh = i % H, e = e0 + el;
      float acc = 0.f;
      if (layer == 0)
        for (int k = 0; k < fan; ++k) acc += s_er[el][k] * wl[k * H + hh];
      else
        for (int k = 0; k < fan; ++k) acc += s_h[cur][el][k] * wl[k * H + hh];
      const float hv = ssp(acc, act_cst);
      s_h[next][el][hh] = hv;
      if (e >= E) continue;
      if (keep_all) {
        z_all[layer * EH + (size_t)e * H + hh] = acc;
        h_out[layer * EH + (size_t)e * H + hh] = hv;
      } else if (layer == n_hidden - 1) {
        h_out[(size_t)e * H + hh] = hv;
      }
    }
    __syncthreads();
    cur = next;
    wl += fan * H;
  }
}

// first n in [0, count) with a[n] >= v, or count
__device__ __forceinline__ int lower_bound(const int* __restrict__ a,
                                           int count, int v) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// What item t walks: positions [e_lo, e_hi) and nodes [first, end) in key
// order; ``head`` is the long node whose piece the item holds, or -1.
struct Item {
  int e_lo, e_hi, first, end, head;
};

__device__ __forceinline__ Item item_walk(const int* __restrict__ ptr, int N,
                                          int t, int T, int cap) {
  const int s = t * cap, f = s + cap;
  const int n_lo = min(N, lower_bound(ptr, N + 1, s));
  int n_hi = t == T - 1 ? N : min(N, lower_bound(ptr, N + 1, f));
  // a long node starting here is walked from the next item on
  if (n_hi > n_lo && ptr[n_hi] - ptr[n_hi - 1] > cap) --n_hi;
  Item it;
  it.head = -1;
  it.first = n_lo;
  it.end = n_hi;
  it.e_lo = ptr[n_lo];
  it.e_hi = ptr[n_hi];
  if (n_lo > 0) {
    const int h = n_lo - 1, a = ptr[h], b = ptr[h + 1];
    if (a < s && b > s && b - a > cap) {
      it.head = h;
      it.first = h;
      it.e_lo = a >= s - cap ? a : s;
      if (n_hi == n_lo) it.e_hi = min(b, f);
    }
  }
  return it;
}

// rows[head] = the sum of a long node's pieces, in item order; grid (T
// items, column blocks): the item holding a node's first piece sums it,
// one column per thread.
static __global__ void walk_piece_sum_kernel(
    const int* __restrict__ ptr, int N, int T, int cap,
    const float* __restrict__ pieces, int width, float* __restrict__ rows) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const Item it = item_walk(ptr, N, t, T, cap);
  if (it.head < 0 || c >= width) return;
  const int a = ptr[it.head], b = ptr[it.head + 1];
  if (t != a / cap + 1) return;
  float s = 0.f;
  for (int tt = t; tt <= (b - 1) / cap; ++tt)
    s += pieces[(size_t)tt * width + c];
  rows[(size_t)it.head * width + c] = s;
}

// Shared memory of the walk kernels, carved from one dynamic buffer: the
// chunk's CG non-zeros and cell bounds, then per staged edge its hidden
// activations (K1 and K2 only), sh and x slice (twice for K4g: sh and csh,
// x and cx), the edge indices, each thread's radial weights (twice for
// K4g: w and cw) and each (edge, path) CG matrix [kRows][pitch(kRows)]
// (twice for K4g: of sh and of csh).  ``sets`` is 1, or 2 for K4g's second
// operands; a region a kernel does not use holds no bytes.
__host__ __device__ constexpr int pitch(int rows) { return (rows + 3) & ~3; }

struct Stage {
  float2* nz;
  int* cells;    // the chunk's cell bounds, relative to its first non-zero
  float* h;      // [kStage][kMaxHidden], zero past H
  float* sh;     // [kStage][kMaxSh]
  float* sh2;    // [kStage][kMaxSh], sets = 2
  float* x;      // [kStage][xw]
  float* x2;     // [kStage][xw], sets = 2
  int* edge;     // [kStage] edge ids
  int* node;     // [kStage] the walk's key node
  int* other;    // [kStage] the other endpoint
  float* w;      // [kStage][threads]
  float* w2;     // [kStage][threads], sets = 2
  float* m;      // [kStage][kGroups][rows][pitch]
  float* m2;     // [kStage][kGroups][rows][pitch], sets = 2
  float* end;    // first float past the stage (16-byte aligned)
};

// the non-zeros are padded to an even count so the float4 reads of what
// follows stay 16-byte aligned
static __host__ __device__ inline int even(int n) { return (n + 1) & ~1; }

// the cell bounds of a chunk of paths whose irreps have at most d1 and d3
// components, padded to a multiple of 4
static __host__ __device__ inline int chunk_cells(int d1, int d3) {
  return pitch(kGroups * (d1 * d3 + 1));
}

static __host__ __device__ inline size_t stage_bytes(int max_nz, int max_d1,
                                                     int max_d3, int xw,
                                                     int threads, int rows,
                                                     int sets = 1,
                                                     bool hidden = true) {
  return (size_t)even(max_nz) * sizeof(float2) +
         (size_t)chunk_cells(max_d1, max_d3) * sizeof(int) +
         (size_t)kStage * ((hidden ? kMaxHidden : 0) + 3 +
                           sets * (kMaxSh + xw + threads +
                                   kGroups * rows * pitch(rows))) *
             sizeof(float);
}

__device__ __forceinline__ Stage carve(void* base, int n_nz, int n_cells,
                                       int xw, int threads, int rows = 0,
                                       int sets = 1, bool hidden = true) {
  Stage st;
  const int two = sets > 1 ? 1 : 0;
  st.nz = static_cast<float2*>(base);
  st.cells = reinterpret_cast<int*>(st.nz + even(n_nz));
  st.h = reinterpret_cast<float*>(st.cells + pitch(n_cells));
  st.sh = st.h + (hidden ? kStage * kMaxHidden : 0);
  st.sh2 = st.sh + kStage * kMaxSh;
  st.x = st.sh2 + two * kStage * kMaxSh;
  st.x2 = st.x + kStage * xw;
  st.edge = reinterpret_cast<int*>(st.x2 + two * kStage * xw);
  st.node = st.edge + kStage;
  st.other = st.node + kStage;
  // every region above holds a multiple of 4 words (kStage = 16), so the
  // M rows' float4 reads stay 16-byte aligned
  st.w = reinterpret_cast<float*>(st.other + kStage);
  st.w2 = st.w + kStage * threads;
  st.m = st.w2 + two * kStage * threads;
  st.m2 = st.m + kStage * kGroups * rows * pitch(rows);
  st.end = st.m2 + two * kStage * kGroups * rows * pitch(rows);
  return st;
}

// What stage_edges copies for each staged edge besides its indices: the
// last hidden layer's activations (h_last, H; none when H = 0), sh and a
// second sh operand (sh2), the x slice [x_off, x_off + xw) of the edge's
// source and a second x operand (x2; none when x is null), and this
// thread's column ``col`` of the external radial weights and of a second
// weight operand (w, w2; w null when the kernel computes them).  The second
// operands are read only by stage_edges<true>.
struct Staged {
  const float* h_last;
  int H;
  const float* sh;
  const float* sh2;
  int J;
  const float* x;
  const float* x2;
  int in_dim, x_off, xw;
  bool x_vec;
  const float* w;
  const float* w2;
  int PC, col;
};

// Stage positions [pos0, pos0 + nq) of the order: edge ids, key and other
// endpoints, then what ``op`` names (kTwo: its second operands too, K4g's;
// a compile-time flag, so K1 and K2 keep their one-operand loops).
// ``key_is_dst`` picks the walk's key.
// Every thread of the block calls it; it first waits for the previous
// stage's readers.  The gathers are asynchronous copies (cp.async), all in
// flight at once: the stage waits for one round trip to memory, not one
// per element.  h and x go in 16-byte pieces when H, resp. the x slice,
// allow it (``x_vec``); st.h's columns past H stay as stage_chunk zeroed
// them.
template <bool kTwo = false>
__device__ __forceinline__ void stage_edges(
    const Stage& st, int pos0, int nq, const int* __restrict__ perm,
    const long long* __restrict__ src, const long long* __restrict__ dst,
    bool key_is_dst, const Staged& op, int tid, int nthr) {
  __syncthreads();
  for (int i = tid; i < nq; i += nthr) {
    const int e = perm[pos0 + i];
    st.edge[i] = e;
    st.node[i] = (int)(key_is_dst ? dst[e] : src[e]);
    st.other[i] = (int)(key_is_dst ? src[e] : dst[e]);
  }
  __syncthreads();
  const int H = op.H;
  if (H % 4 == 0) {
    const int h4 = H / 4;
    for (int i = tid; i < nq * h4; i += nthr) {
      const int q = i / h4, c = i - q * h4;
      __pipeline_memcpy_async(st.h + q * kMaxHidden + 4 * c,
                              op.h_last + (size_t)st.edge[q] * H + 4 * c, 16);
    }
  } else {
    for (int i = tid; i < nq * H; i += nthr) {
      const int q = i / H, c = i - q * H;
      __pipeline_memcpy_async(st.h + q * kMaxHidden + c,
                              op.h_last + (size_t)st.edge[q] * H + c, 4);
    }
  }
  const int J = op.J;
  for (int i = tid; i < nq * J; i += nthr) {
    const int q = i / J, j = i - q * J;
    const size_t at = (size_t)st.edge[q] * J + j;
    __pipeline_memcpy_async(st.sh + q * kMaxSh + j, op.sh + at, 4);
    if (kTwo)
      __pipeline_memcpy_async(st.sh2 + q * kMaxSh + j, op.sh2 + at, 4);
  }
  if (op.x) {
    const int xw = op.xw, n = op.x_vec ? xw / 4 : xw;
    for (int q = 0; q < nq; ++q) {
      const int s = key_is_dst ? st.other[q] : st.node[q];
      const size_t at = (size_t)s * op.in_dim + op.x_off;
      for (int c = tid; c < n; c += nthr) {
        if (op.x_vec) {
          __pipeline_memcpy_async(st.x + q * xw + 4 * c, op.x + at + 4 * c,
                                  16);
          if (kTwo)
            __pipeline_memcpy_async(st.x2 + q * xw + 4 * c,
                                    op.x2 + at + 4 * c, 16);
        } else {
          __pipeline_memcpy_async(st.x + q * xw + c, op.x + at + c, 4);
          if (kTwo)
            __pipeline_memcpy_async(st.x2 + q * xw + c, op.x2 + at + c, 4);
        }
      }
    }
  }
  if (op.w) {
    for (int q = 0; q < nq; ++q) {
      const size_t at = (size_t)st.edge[q] * op.PC + op.col;
      __pipeline_memcpy_async(st.w + q * nthr + tid, op.w + at, 4);
      if (kTwo)
        __pipeline_memcpy_async(st.w2 + q * nthr + tid, op.w2 + at, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Whether the x slices [x_off, x_off + xw) of every row can be copied in
// 16-byte pieces.
__device__ __forceinline__ bool x_vectors(const float* x, int in_dim,
                                          int x_off, int xw) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0 && in_dim % 4 == 0 &&
         x_off % 4 == 0 && xw % 4 == 0;
}

// Radial weights of the staged edges for column ``col``: w[q] = h[q] .
// w_out[:, col], kStage independent sums, stored in this thread's slots of
// st.w (read back by the same thread).
__device__ __forceinline__ void radial_weights(const Stage& st,
                                               const float* __restrict__ w_out,
                                               int H, int PC, int col,
                                               int tid, int nthr) {
  float w[kStage];
#pragma unroll
  for (int q = 0; q < kStage; ++q) w[q] = 0.f;
  const float4* h4 = reinterpret_cast<const float4*>(st.h);
  for (int k = 0; k < (H + 3) / 4; ++k) {
    float c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = 4 * k + j < H ? __ldg(w_out + (size_t)(4 * k + j) * PC + col)
                           : 0.f;
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const float4 v = h4[q * (kMaxHidden / 4) + k];
      w[q] += v.x * c[0] + v.y * c[1] + v.z * c[2] + v.w * c[3];
    }
  }
#pragma unroll
  for (int q = 0; q < kStage; ++q) st.w[q * nthr + tid] = w[q];
}

// This path's CG matrices of the nq staged edges, M[q][m3][m1] = sum over
// the cell's non-zeros of C * shs[q, j0 + m2], for m3 < d3 and m1 <
// pitch(d1) (zero past d1: the products read whole float4s of a row and
// stop at pitch(d1)), into ``ms`` (st.m, or st.m2 for K4g's csh); built by
// the path's ``mul`` threads from the staged sh rows ``shs`` (st.sh or
// st.sh2).  ``cells``: the path's cell bounds in st.cells.
template <int kRows>
__device__ __forceinline__ void cg_matrices(const Stage& st,
                                            const float* shs, float* ms,
                                            int nq, int g, const int* cells,
                                            int d1, int d3, int j0, int u,
                                            int mul) {
  constexpr int kCells = kRows * pitch(kRows);
  const int cols = pitch(d1), per_edge = d3 * cols;
  for (int i = u; i < nq * per_edge; i += mul) {
    const int q = i / per_edge, r = i % per_edge;
    const int m3 = r / cols, m1 = r % cols;
    float v = 0.f;
    if (m1 < d1) {
      const int c = m3 * d1 + m1;
      const float* shq = shs + q * kMaxSh + j0;
      for (int z = cells[c]; z < cells[c + 1]; ++z) {
        const float2 e = st.nz[z];
        v += e.x * shq[__float_as_int(e.y)];
      }
    }
    ms[(q * kGroups + g) * kCells + m3 * pitch(kRows) + m1] = v;
  }
}

// x[src, m1, u] of staged edge q for m1 < d1, zero past it
template <int kRows>
__device__ __forceinline__ void load_x(float (&xr)[pitch(kRows)],
                                       const float* xq, int d1) {
#pragma unroll
  for (int m = 0; m < pitch(kRows); ++m) xr[m] = m < d1 ? xq[m] : 0.f;
}

// Once per block: copy the chunk's CG non-zeros [z0, z1) and its cell
// bounds [c0, c1) (made relative to z0) into shared memory, and zero the
// staged hidden activations (their columns past H are never copied) when
// the stage holds them.
__device__ __forceinline__ void stage_chunk(const Stage& st,
                                            const float2* __restrict__ nz,
                                            int z0, int z1,
                                            const int* __restrict__ cells,
                                            int c0, int c1, int tid,
                                            int nthr, bool hidden = true) {
  for (int z = z0 + tid; z < z1; z += nthr) st.nz[z - z0] = nz[z];
  for (int c = c0 + tid; c < c1; c += nthr) st.cells[c - c0] = cells[c] - z0;
  if (hidden)
    for (int i = tid; i < kStage * kMaxHidden; i += nthr) st.h[i] = 0.f;
}

// Launch the piece sum when some item may hold a piece (T > 1).
static inline cudaError_t sum_pieces(const int* ptr, int N, int T, int cap,
                                     const float* pieces, int width,
                                     float* rows, cudaStream_t s) {
  if (T <= 1 || width <= 0) return cudaSuccess;
  const dim3 grid(T, (width + kPieceThreads - 1) / kPieceThreads);
  walk_piece_sum_kernel<<<grid, kPieceThreads, 0, s>>>(ptr, N, T, cap,
                                                       pieces, width, rows);
  return cudaGetLastError();
}

// dx[n, x_off + u * d1 + m1] = sum over the left irrep's paths of
// dxp[n, dcol + m1 * mul + u], in path order: the per-path dx rows of a
// source-major walk (K2, K4b, K4g) added up.  grid (N, left irreps);
// ``irreps``: ConvTables.walk_irreps (x_off, d1, dcol, paths).
static __global__ void walk_dx_kernel(const float* __restrict__ dxp, int KMd,
                                      const int* __restrict__ irreps, int mul,
                                      float* __restrict__ dx, int in_dim) {
  const int n = blockIdx.x;
  const int* ir = irreps + 4 * blockIdx.y;
  const int x_off = ir[0], d1 = ir[1], dcol = ir[2], np = ir[3];
  const int width = d1 * mul;
  const float* row = dxp + (size_t)n * KMd + dcol;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < np; ++k) s += row[(size_t)k * width + c];
    dx[(size_t)n * in_dim + x_off + (c % mul) * d1 + c / mul] = s;
  }
}

static inline cudaError_t sum_dx(const float* dxp, int N, int KMd,
                                 const int* irreps, int n_irreps, int mul,
                                 float* dx, int in_dim, cudaStream_t s) {
  if (N <= 0 || n_irreps <= 0) return cudaSuccess;
  walk_dx_kernel<<<dim3(N, n_irreps), 256, 0, s>>>(dxp, KMd, irreps, mul,
                                                   dx, in_dim);
  return cudaGetLastError();
}

// The register rows of a walk kernel's template for irreps of at most
// ``rows`` components: 7 (l <= 3), kMaxD (l = 4) or 16 (l <= 7).
static inline int walk_rows(int rows) {
  return rows > kMaxD ? 16 : rows > 7 ? kMaxD : 7;
}

// Allow a kernel the dynamic shared memory it asks for.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace walk
