// The mix stage shared by the convolution and pairwise kernels, forward and
// backward, and the backward's other tiled products: one tensor-core GEMM.
//
// Forward (full_conv.cu K1, uvu_conv.cu K6, pairwise_tp.cu K5, and the
// scattered mix of full_conv_ext.cu K4f / K4g): per mix problem q
// (output-irrep group, component, output slot)
//
//   out[r, c_off(q) + w * c_stride(q)] =
//       sum_k S[r, a_col(q) + k] * wsel[b_off(q) + k * wo(q) + w]
//
// over the rows r of the unmixed scratch S [rows, KM] (one row per node, per
// edge or per element).  Backward (full_conv_bwd.cu K2, full_conv_ext.cu
// K4b / K4g, uvu_conv.cu K6b, pairwise_tp.cu K5m), the two adjoints:
//
//   dS[r, a_col + k]       = sum_{q: a_col(q) = a_col} sum_w
//                                gout[r, c(q, w)] * wsel_q[k, w]
//   dwsel[b_off + k*wo + w] = sum_{q: b_off(q) = b_off} sum_r
//                                S[r, a_col(q) + k] * gout[r, c(q, w)]
//
// The problems that share a_col are one output group's slots, and those
// that share b_off are the d components of one (group, slot): they are one
// product each, with the members' reductions concatenated (the TPU kernel's
// "one dot per group", ops/pallas/pairwise.py:504-506).  K2's radial MLP
// (dW = h^T dw, dh = dw W^T) goes through the same kernel.
//
// Replaces the mix dots of the TPU kernels (PallasFullConv._full_fwd_kernel
// and _full_bwd_kernel, fused_conv.py:926 and :1051; PallasUVUConv,
// fused_conv.py:233 and :278; PallasPairwiseTP._fwd_kernel and
// _bwd_kernel_dws, pairwise.py:410 and :504), which run on the MXU.
//
// Design (gemm_kernel):
// - One owner per output tile.  A block computes a 64x64 tile of one
//   product over all its members' reductions, in a fixed order, and stores
//   it once with plain stores.  A product that reduces over rows (dwsel,
//   dW) is split over row chunks only as far as the card needs blocks
//   (kTargetBlocks); each split stores a partial tile into a workspace and
//   reduce_kernel adds the partials in split order.  No atomics: every
//   output repeats bit for bit from launch to launch.
// - Tensor cores at float32 accuracy (3xTF32): each operand x is split
//   into x_hi = tf32(x) and x_lo = tf32(x - x_hi), rounded to nearest
//   (cvt.rna: a raw float fed to the MMA would be truncated), and
//   acc += a_lo b_hi + a_hi b_lo + a_hi b_hi with mma.sync m16n8k8 TF32,
//   accumulated in float32.  The dropped a_lo b_lo term is ~2^-22 of each
//   product.
// - A ring of kStages stages of cp.async copies, so that the loads of the
//   next tiles overlap the MMAs.  An operand is staged as it lies in
//   memory: kBK (32) lines of 64 floats along its strided axis, or 64 lines
//   of 32, with 16-byte copies where its lines and its start are 16-byte
//   aligned (every operand at the configs' widths) and 4-byte copies
//   otherwise (small test widths); zero fill past the ragged edge.  The
//   line pitch is padded so that the fragment loads of a warp hit 32
//   distinct banks.
// - gout's columns of one problem sit at stride c_stride = d.  Before the
//   backward's products, deinterleave_kernel rewrites each (group, slot)'s
//   block of gout, [rows, wo * d] component-minor, into a work copy in
//   which component dd's wo columns are contiguous (one pass over gout,
//   coalesced reads).  So every operand of every product is unit-stride,
//   the stages hold no column that the MMAs do not read, and no copy is a
//   4-byte gather at the configs' widths.
// - The descriptors of a launch (jobs: outputs; members: the operand pairs
//   of their reductions) travel as one __grid_constant__ parameter block,
//   built on the host from the problem table.
//
// What bounds it on the card: at the full-width shapes these products are
// bound by bytes (the scratch S or dS, rows x KM floats, read or written
// once) or, for K2's MLP stage (2 x 2 x E x 64 x 3072 FLOPs), by the
// tensor cores at a third of the TF32 rate; mma.sync reaches only part of
// Hopper's TF32 rate (wgmma is the way to all of it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <vector>

// launches of gemm_kernel, for the forward mix [0] and for the backward's
// products [1] (defined in row_mix.cu; read by the Python wrappers)
extern "C" long long rowmix_launches[2];

namespace rowmix {

constexpr int kProbFields = 6;
constexpr int kWarpM = 32, kWarpN = 32; // a warp's part of the tile
constexpr int kBM = 2 * kWarpM, kBN = 2 * kWarpN;   // output tile, 2x2 warps
constexpr int kBK = 32;                 // reduction depth of a stage
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kMaxJobs = 24, kMaxMembers = 48;   // per launch
constexpr int kTargetBlocks = 4 * 132;  // a split product's blocks: 4 per SM
constexpr int kMinSplitRows = 64;
// workspace for the partial tiles of split products, in floats: a split
// product has fewer than kTargetBlocks tiles, so splits * tiles stays below
// 2 * kTargetBlocks
constexpr long long kWorkspaceFloats = 2LL * kTargetBlocks * kBM * kBN;

// element j of line l at p[l * ld + start + j]; vec: p + start and ld are
// 16-byte aligned, so lines take 16-byte copies
struct Operand {
  const float* p;
  int ld, start, vec, pad;
};

// one reduction of a product: sum_k A(m, k) B(k, n), k < K
struct Member {
  Operand a, b;
  int K, pad;
};

// one product C(m, n), m < M, n < N, at C[m * scm + n * scn], summed over
// members [m0, m0 + nm) of the batch
struct Job {
  float* C;
  long long ws_off;
  int scm, scn, M, N;
  int m0, nm, tile0, tiles_n;
};

struct Batch {
  float* ws;
  int n_jobs, splits, k_chunk, tiles;
  Job jobs[kMaxJobs];
  Member members[kMaxMembers];
};
static_assert(sizeof(Batch) <= 4000, "kernel parameters are limited to 4 KB");

// an operand's stage; KC: lines along the tile's rows (kRows of them), of
// kBK floats, which a warp's fragment loads read 8 lines x 4 columns at a
// time (pitch = 4 mod 8 words: 32 banks), else kBK lines of kRows floats,
// read 4 lines x 8 columns (pitch = 8 mod 32)
template <bool KC, int kRows>
struct StageShape {
  static constexpr int lines = KC ? kRows : kBK;
  static constexpr int width = KC ? kBK : kRows;
  static constexpr int pitch = KC ? kBK + 4 : kRows + 8;
  static constexpr int floats = lines * pitch;
  static_assert(pitch % 32 == (KC ? 4 : 8) || pitch % 32 == (KC ? 20 : 24),
                "a pitch with bank conflicts");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32, rounded to nearest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage lines [l0, l0 + lines) x elements [j0, j0 + width) of an operand
// into dst; lines at or past l_lim and elements at or past j_lim are zero.
template <class Shape>
__device__ __forceinline__ void stage_operand(float* dst, const Operand& o,
                                              int l0, int l_lim, int j0,
                                              int j_lim, int tid) {
  const float* base = o.p + o.start + j0;
  const int valid = j_lim - j0;   // elements of a line
  if (o.vec) {
    constexpr int chunks = Shape::width / 4;
#pragma unroll
    for (int n = 0; n < Shape::lines * chunks / kThreads; ++n) {
      const int i = tid + n * kThreads;
      const int l = i / chunks, c = 4 * (i % chunks);
      int bytes = 0;
      const float* src = o.p;
      if (l0 + l < l_lim && c < valid) {
        bytes = valid - c >= 4 ? 16 : 4 * (valid - c);
        src = base + (size_t)(l0 + l) * o.ld + c;
      }
      cp_async16(dst + l * Shape::pitch + c, src, bytes);
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < Shape::lines * Shape::width / kThreads; ++n) {
      const int i = tid + n * kThreads;
      const int l = i / Shape::width, c = i % Shape::width;
      const bool ok = l0 + l < l_lim && c < valid;
      cp_async4(dst + l * Shape::pitch + c,
                ok ? base + (size_t)(l0 + l) * o.ld + c : o.p, ok ? 4 : 0);
    }
  }
}

// grid: (tiles of every job of the batch, splits); 128 threads.  AK: A's
// unit-stride axis is k (lines are m), else m (lines are k); BK: B's is k
// (lines are n), else n (lines are k).
template <bool AK, bool BK>
static __global__ void __launch_bounds__(kThreads, 4)
    gemm_kernel(const __grid_constant__ Batch b) {
  using SA = StageShape<AK, kBM>;
  using SB = StageShape<BK, kBN>;
  constexpr int kStage = SA::floats + SB::floats;
  extern __shared__ __align__(16) float smem[];
  int j = 0;
  while (j + 1 < b.n_jobs && (int)blockIdx.x >= b.jobs[j + 1].tile0) ++j;
  const Job job = b.jobs[j];
  const int tile = blockIdx.x - job.tile0;
  const int m0 = (tile / job.tiles_n) * kBM, n0 = (tile % job.tiles_n) * kBN;
  const int split = blockIdx.y, k_chunk = b.k_chunk;
  const Member* mem = b.members + job.m0;
  const int nm = job.nm;
  const int tid = threadIdx.x;

  // the k range of member t in this split
  const int k_lo = split * k_chunk;
  auto k_end = [&](int t) { return min(mem[t].K, k_lo + k_chunk); };
  // (t, k): the next step of member t from k, or the first step of the
  // next member with work
  auto next = [&](int& t, int& k) {
    k += kBK;
    while (t < nm && k >= k_end(t))
      if (++t < nm) k = k_lo;
  };

  auto load = [&](int slot, int t, int k0) {
    float* as = smem + slot * kStage;
    float* bs = as + SA::floats;
    const int ke = k_end(t);
    if (AK)
      stage_operand<SA>(as, mem[t].a, m0, job.M, k0, ke, tid);
    else
      stage_operand<SA>(as, mem[t].a, k0, ke, m0, job.M, tid);
    if (BK)
      stage_operand<SB>(bs, mem[t].b, n0, job.N, k0, ke, tid);
    else
      stage_operand<SB>(bs, mem[t].b, k0, ke, n0, job.N, tid);
  };

  constexpr int MI = kWarpM / 16, NI = kWarpN / 8;   // MMA tiles a warp
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * kWarpM, wn = (warp & 1) * kWarpN;
  const int g = lane >> 2, q4 = lane & 3;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;

  // acc += A B over one stage, the warp's quarter of the tile
  auto compute = [&](int slot) {
    const float* as = smem + slot * kStage;
    const float* bs = as + SA::floats;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int n = 0; n < NI; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = wn + n * 8 + g;
          const int k = kk + q4 + q * 4;
          split_tf32(BK ? bs[c * SB::pitch + k] : bs[k * SB::pitch + c],
                     bh[n][q], bl[n][q]);
        }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = wm + i * 16 + g + (q & 1) * 8;
          const int k = kk + q4 + (q >> 1) * 4;
          split_tf32(AK ? as[r * SA::pitch + k] : as[k * SA::pitch + r],
                     ah[q], al[q]);
        }
        // the small terms first
#pragma unroll
        for (int n = 0; n < NI; ++n) mma_tf32(acc[i][n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < NI; ++n) mma_tf32(acc[i][n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < NI; ++n) mma_tf32(acc[i][n], ah, bh[n]);
      }
    }
  };

  // the ring: kStages - 1 stages in flight ahead of the MMAs
  int lt = 0, lk = k_lo - kBK;
  next(lt, lk);
  int ct = lt, ck = lk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (lt < nm) {
      load(s, lt, lk);
      next(lt, lk);
    }
    cp_async_commit();
  }
  int slot = 0;
  while (ct < nm) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (lt < nm) {
      load((slot + kStages - 1) % kStages, lt, lk);
      next(lt, lk);
    }
    cp_async_commit();
    compute(slot);
    next(ct, ck);
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();

  // one plain store per element: the tile, or this split's partial tile
  const bool partial = b.splits > 1;
  float* out = partial ? b.ws + job.ws_off + (size_t)split * job.M * job.N
                       : job.C;
  const size_t scm = partial ? (size_t)job.N : (size_t)job.scm;
  const size_t scn = partial ? 1 : (size_t)job.scn;
  // a thread's two neighbouring columns as one 8-byte store where they are
  // adjacent and aligned: a warp then writes whole 32-byte sectors
  const bool pairs = scn == 1 && scm % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + i * 16 + g + h * 8;
        const int col = n0 + wn + n * 8 + 2 * q4;
        if (r >= job.M) continue;
        float* at = out + r * scm + col * scn;
        if (pairs && col + 1 < job.N) {
          *reinterpret_cast<float2*>(at) =
              make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
        } else {
          if (col < job.N) at[0] = acc[i][n][2 * h];
          if (col + 1 < job.N) at[scn] = acc[i][n][2 * h + 1];
        }
      }
}

// C = the sum of a split product's partial tiles, in split order.
// grid: (element chunks, jobs)
static __global__ void reduce_kernel(const __grid_constant__ Batch b) {
  const Job& job = b.jobs[blockIdx.y];
  const size_t mn = (size_t)job.M * job.N;
  const float* part = b.ws + job.ws_off;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < b.splits; ++k) s += part[k * mn + i];
    job.C[(i / job.N) * job.scm + (i % job.N) * job.scn] = s;
  }
}

// The (group, slot) blocks of gout, [rows, wo * d] with component dd of
// column w at out_start + w * d + dd, rewritten component-major into gT:
// gT[r, out_start + dd * wo + w].
constexpr int kMaxBlocks = 160;
struct Blocks {
  int n;
  int out_start[kMaxBlocks], d[kMaxBlocks], wo[kMaxBlocks];
};
static_assert(sizeof(Blocks) <= 4000, "kernel parameters are limited to 4 KB");

// grid: (row chunks, blocks)
static __global__ void deinterleave_kernel(const float* __restrict__ gout,
                                           int rows, int out_dim,
                                           const __grid_constant__ Blocks bl,
                                           float* __restrict__ gT) {
  const int s0 = bl.out_start[blockIdx.y], d = bl.d[blockIdx.y];
  const int wo = bl.wo[blockIdx.y], width = wo * d;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* src = gout + (size_t)r * out_dim + s0;
    float* dst = gT + (size_t)r * out_dim + s0;
    for (int c = threadIdx.x; c < width; c += blockDim.x)
      dst[(c % d) * wo + c / d] = src[c];
  }
}

// ---------------------------------------------------------------------------
// Host side: descriptors, batches, launches.

// An operand at p with lines ld floats apart, element j of a line at
// start + j.
static inline Operand operand(const float* p, int ld, int start) {
  Operand o{};
  o.p = p;
  o.ld = ld;
  o.start = start;
  o.vec = (reinterpret_cast<uintptr_t>(p + start) & 15) == 0 && ld % 4 == 0;
  return o;
}

enum Kind { kForward = 0, kBackward = 1 };

// Collects products into launches of gemm_kernel (and reduce_kernel for
// split ones), one launch per batch of products with the same operand
// layouts; ``split``: the products reduce over rows and may be split
// (dwsel, dW; the workspace ws holds their partial tiles).  add's a_kc and
// b_kc are gemm_kernel's AK and BK.
class Launcher {
 public:
  Launcher(Kind kind, bool split, float* ws, long long ws_len,
           cudaStream_t s)
      : kind_(kind), split_(split), ws_(ws), ws_len_(ws_len), s_(s) {
    reset();
  }

  // C(m, n) = sum over members, at C[m * scm + n * scn]
  cudaError_t add(float* C, int scm, int scn, int M, int N, bool a_kc,
                  bool b_kc, const Member* members, int nm) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    if (nm > kMaxMembers) return cudaErrorInvalidValue;
    if (b_.n_jobs == kMaxJobs || n_mem_ + nm > kMaxMembers ||
        (b_.n_jobs > 0 && (a_kc != a_kc_ || b_kc != b_kc_))) {
      cudaError_t err = flush();
      if (err != cudaSuccess) return err;
    }
    a_kc_ = a_kc;
    b_kc_ = b_kc;
    Job& j = b_.jobs[b_.n_jobs++];
    j = Job{};
    j.C = C;
    j.scm = scm;
    j.scn = scn;
    j.M = M;
    j.N = N;
    j.m0 = n_mem_;
    j.nm = nm;
    for (int i = 0; i < nm; ++i) {
      b_.members[n_mem_ + i] = members[i];
      max_k_ = std::max(max_k_, members[i].K);
    }
    n_mem_ += nm;
    j.tiles_n = (N + kBN - 1) / kBN;
    j.tile0 = b_.tiles;
    b_.tiles += ((M + kBM - 1) / kBM) * j.tiles_n;
    return cudaSuccess;
  }

  cudaError_t flush() {
    if (b_.n_jobs == 0) return cudaSuccess;
    long long mn = 0;
    for (int i = 0; i < b_.n_jobs; ++i)
      mn += (long long)b_.jobs[i].M * b_.jobs[i].N;
    int splits = 1;
    if (split_ && ws_ != nullptr && max_k_ > 0) {
      splits = (kTargetBlocks + b_.tiles - 1) / b_.tiles;
      splits = std::min(splits, std::max(1, max_k_ / kMinSplitRows));
      splits = (int)std::min<long long>(splits, ws_len_ / mn);
      splits = std::max(1, std::min(splits, 65535));
    }
    int chunk = 1 << 30;
    if (splits > 1) {
      chunk = ((max_k_ + splits - 1) / splits + kBK - 1) / kBK * kBK;
      splits = (max_k_ + chunk - 1) / chunk;
    }
    if (splits == 1) chunk = 1 << 30;
    b_.splits = splits;
    b_.k_chunk = chunk;
    b_.ws = ws_;
    long long off = 0;
    for (int i = 0; i < b_.n_jobs; ++i) {
      b_.jobs[i].ws_off = off;
      off += (long long)splits * b_.jobs[i].M * b_.jobs[i].N;
    }
    cudaError_t err =
        a_kc_ ? (b_kc_ ? launch<true, true>() : launch<true, false>())
              : (b_kc_ ? launch<false, true>() : launch<false, false>());
    if (err != cudaSuccess) return err;
    ++rowmix_launches[kind_];
    if (splits > 1) {
      long long most = 0;
      for (int i = 0; i < b_.n_jobs; ++i)
        most = std::max(most, (long long)b_.jobs[i].M * b_.jobs[i].N);
      const unsigned chunks =
          (unsigned)std::min<long long>((most + 1023) / 1024, 1024);
      reduce_kernel<<<dim3(chunks, b_.n_jobs), 256, 0, s_>>>(b_);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    reset();
    return cudaSuccess;
  }

 private:
  template <bool AK, bool BK>
  cudaError_t launch() {
    constexpr size_t bytes =
        kStages *
        (StageShape<AK, kBM>::floats + StageShape<BK, kBN>::floats) *
        sizeof(float);
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          gemm_kernel<AK, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (err != cudaSuccess) return err;
    }
    gemm_kernel<AK, BK><<<dim3(b_.tiles, b_.splits), kThreads, bytes, s_>>>(
        b_);
    return cudaGetLastError();
  }

  void reset() {
    b_.n_jobs = 0;
    b_.tiles = 0;
    n_mem_ = 0;
    max_k_ = 0;
  }

  Kind kind_;
  bool split_;
  float* ws_;
  long long ws_len_;
  cudaStream_t s_;
  Batch b_;
  bool a_kc_ = true, b_kc_ = true;   // the batch's operand layouts
  int n_mem_, max_k_;
};

// C = A B, A [M, K] (a_kc) or stored transposed as [K, M], B [K, N] or
// stored transposed as [N, K] (b_kc), all with unit-stride rows of their
// stored shape; C [M, N] dense.  ``split``: the reduction may be split
// (over K, into the workspace).
static inline cudaError_t matmul(const float* A, bool a_kc, const float* B,
                                 bool b_kc, float* C, int M, int N, int K,
                                 bool split, float* ws, long long ws_len,
                                 cudaStream_t s) {
  Member m{};
  m.a = operand(A, a_kc ? K : M, 0);
  m.b = operand(B, b_kc ? K : N, 0);
  m.K = K;
  Launcher l(kBackward, split, ws, ws_len, s);
  cudaError_t err = l.add(C, N, 1, M, N, a_kc, b_kc, &m, 1);
  if (err != cudaSuccess) return err;
  return l.flush();
}

// Whether the problems' output columns c_off + w * c_stride cover
// [0, out_dim), and whether their scratch columns [a_col, a_col + kdim)
// cover [0, KM).
static inline bool covers_output(const int* probs, int n_probs,
                                 int out_dim) {
  std::vector<char> seen(out_dim > 0 ? out_dim : 0, 0);
  for (int q = 0; q < n_probs; ++q) {
    const int* pr = probs + q * kProbFields;
    for (int w = 0; w < pr[3]; ++w) {
      const int c = pr[4] + w * pr[5];
      if (c >= 0 && c < out_dim) seen[c] = 1;
    }
  }
  return std::all_of(seen.begin(), seen.end(), [](char c) { return c; });
}

static inline bool covers_scratch(const int* probs, int n_probs, int KM) {
  std::vector<char> seen(KM > 0 ? KM : 0, 0);
  for (int q = 0; q < n_probs; ++q) {
    const int* pr = probs + q * kProbFields;
    for (int k = pr[0]; k < pr[0] + pr[1] && k < KM; ++k) seen[k] = 1;
  }
  return std::all_of(seen.begin(), seen.end(), [](char c) { return c; });
}

// The forward mix of every problem over ``rows`` scratch rows, from the
// problem table on the host; columns of no problem are zeroed.
static inline cudaError_t mix_rows(const float* S, int rows, int KM,
                                   const float* wsel, const int* probs,
                                   int n_probs, float* out, int out_dim,
                                   cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  if (!covers_output(probs, n_probs, out_dim)) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)rows * (size_t)out_dim * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  Launcher l(kForward, false, nullptr, 0, s);
  for (int q = 0; q < n_probs; ++q) {
    const int* pr = probs + q * kProbFields;
    const int a_col = pr[0], kdim = pr[1], b_off = pr[2], wo = pr[3];
    Member m{};
    m.a = operand(S, KM, a_col);
    m.b = operand(wsel + b_off, wo, 0);
    m.K = kdim;
    cudaError_t err = l.add(out + pr[4], out_dim, pr[5], rows, wo, true,
                            false, &m, 1);
    if (err != cudaSuccess) return err;
  }
  return l.flush();
}

// The first gout column of each (group, slot) block: the least c_off of the
// problems that share its mix matrix (b_off).
static inline std::map<int, int> block_starts(const int* probs,
                                              int n_probs) {
  std::map<int, int> first;
  for (int q = 0; q < n_probs; ++q) {
    const int* pr = probs + q * kProbFields;
    auto it = first.find(pr[2]);
    if (it == first.end() || pr[4] < it->second) first[pr[2]] = pr[4];
  }
  return first;
}

// gT = gout with every (group, slot) block component-major: problem q's
// columns start at s0 + (c_off - s0) * wo, s0 its block's first column.
static inline cudaError_t deinterleave(const int* probs, int n_probs,
                                       int rows, int out_dim,
                                       const float* gout, float* gT,
                                       cudaStream_t s) {
  const std::map<int, int> first = block_starts(probs, n_probs);
  Blocks bl{};
  for (int q = 0; q <= n_probs; ++q) {
    if (q == n_probs || bl.n == kMaxBlocks) {
      if (bl.n > 0 && rows > 0) {
        const unsigned grid_x = (unsigned)std::min(rows, 4096);
        deinterleave_kernel<<<dim3(grid_x, bl.n), 128, 0, s>>>(
            gout, rows, out_dim, bl, gT);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
      bl.n = 0;
      if (q == n_probs) break;
    }
    const int* pr = probs + q * kProbFields;
    if (pr[4] != first.at(pr[2])) continue;   // not the block's first
    bl.out_start[bl.n] = pr[4];
    bl.d[bl.n] = pr[5];
    bl.wo[bl.n] = pr[3];
    ++bl.n;
  }
  return cudaSuccess;
}

// The backward's mix products over ``rows`` scratch rows, from the problem
// table on the host:
//   kMixRows:    dS (every column; those of no problem are zeroed)
//   kMixWeights: dwsel (every entry), split over rows
// ws [ws_len]: gout made component-major (rows * out_dim floats), then the
// split products' partial tiles.
enum MixProduct { kMixRows = 1, kMixWeights = 2 };

static inline cudaError_t mix_products(MixProduct which, const int* probs,
                                       int n_probs, int rows, int KM,
                                       int out_dim, const float* S,
                                       const float* wsel, const float* gout,
                                       float* C, int wsel_len, float* ws,
                                       long long ws_len, cudaStream_t s) {
  const bool rows_kind = which == kMixRows;
  if (rows_kind && rows <= 0) return cudaSuccess;
  const long long gt_len = (long long)std::max(rows, 0) * out_dim;
  if (ws == nullptr || ws_len < gt_len) return cudaErrorInvalidValue;
  // owners: the problems that share a scratch block (dS) or a mix matrix
  // (dwsel), in table order
  const int key = rows_kind ? 0 : 2;
  std::vector<std::vector<int>> owners;
  std::vector<char> done(n_probs, 0);
  long long covered = 0;
  for (int q = 0; q < n_probs; ++q) {
    if (done[q]) continue;
    owners.emplace_back();
    for (int r = q; r < n_probs; ++r)
      if (probs[r * kProbFields + key] == probs[q * kProbFields + key]) {
        done[r] = 1;
        owners.back().push_back(r);
      }
    if ((int)owners.back().size() > kMaxMembers) return cudaErrorInvalidValue;
    covered +=
        (long long)probs[q * kProbFields + 1] * probs[q * kProbFields + 3];
  }
  const bool complete = rows_kind ? covers_scratch(probs, n_probs, KM)
                                  : covered == wsel_len;
  if (!complete) {   // columns or entries of no problem stay zero
    const size_t n = rows_kind ? (size_t)rows * KM : (size_t)wsel_len;
    cudaError_t err = cudaMemsetAsync(C, 0, n * sizeof(float), s);
    if (err != cudaSuccess) return err;
  }
  float* gT = ws;
  cudaError_t err = deinterleave(probs, n_probs, rows, out_dim, gout, gT, s);
  if (err != cudaSuccess) return err;
  const std::map<int, int> first = block_starts(probs, n_probs);
  Launcher l(kBackward, !rows_kind, ws + gt_len, ws_len - gt_len, s);
  Member members[kMaxMembers];
  for (const auto& own : owners) {
    const int* p0 = probs + own[0] * kProbFields;
    const int a_col = p0[0], kdim = p0[1], b_off = p0[2], wo = p0[3];
    for (size_t i = 0; i < own.size(); ++i) {
      const int* pr = probs + own[i] * kProbFields;
      const int s0 = first.at(pr[2]), gcol = s0 + (pr[4] - s0) * pr[3];
      Member& m = members[i];
      m = Member{};
      if (rows_kind) {
        // dS[r, a_col + k] += sum_w gT(r, w) wsel_q(k, w), lines of B k
        m.a = operand(gT, out_dim, gcol);
        m.b = operand(wsel + pr[2], pr[3], 0);
        m.K = pr[3];
      } else {
        // dwsel_q(k, w) += sum_r S(r, a_col(q) + k) gT(r, w), lines r
        m.a = operand(S, KM, pr[0]);
        m.b = operand(gT, out_dim, gcol);
        m.K = std::max(rows, 0);
      }
    }
    err = rows_kind ? l.add(C + a_col, KM, 1, rows, kdim, true, true,
                            members, (int)own.size())
                    : l.add(C + b_off, wo, 1, kdim, wo, false, false,
                            members, (int)own.size());
    if (err != cudaSuccess) return err;
  }
  return l.flush();
}

// How many CG paths one block of the sweep kernels walks: the paths are
// split over blockIdx.y until the grid holds about kSweepBlocks blocks, so
// that a small batch (tens of rows) still fills the card.  Paths write
// disjoint scratch rows, so the split needs no synchronisation.
constexpr int kRowsPerBlock = 4;   // blockDim.y of the sweep kernels
constexpr int kSweepBlocks = 2048;

static inline int paths_per_block(int rows, int P) {
  const int row_blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  int chunks = (kSweepBlocks + row_blocks - 1) / row_blocks;
  if (chunks > P) chunks = P;
  if (chunks < 1) chunks = 1;
  return (P + chunks - 1) / chunks;
}

}  // namespace rowmix
