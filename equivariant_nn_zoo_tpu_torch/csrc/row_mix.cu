// C entries of the tensor-core GEMM of row_mix.cuh on its own: the forward
// mix, the backward's mix products and a plain matrix product, for the card
// tests and chip_smoke.py's timings.  The convolution and pairwise kernels
// include row_mix.cuh and launch it from their own entries; this file also
// holds the launch counters they add to.

#include <cuda_runtime.h>

#include "row_mix.cuh"

long long rowmix_launches[4] = {0, 0, 0, 0};

// out [rows, out_dim] = the forward mix of S [rows, KM]; probs: the problem
// table, on the host; bf16: the bfloat16 products
extern "C" int row_mix_forward(const float* S, int rows, int KM,
                               const float* wsel, const int* probs,
                               int n_probs, float* out, int out_dim,
                               int bf16, void* stream) {
  return (int)rowmix::mix_rows(S, rows, KM, wsel, probs, n_probs, out,
                               out_dim, static_cast<cudaStream_t>(stream),
                               bf16 != 0);
}

// which 1: dS [rows, KM] from gout and wsel; 2: dwsel [wsel_len] from S and
// gout (split over rows into ws, ws_len floats)
extern "C" int row_mix_backward(int which, const int* probs, int n_probs,
                                int rows, int KM, int out_dim, const float* S,
                                const float* wsel, const float* gout,
                                float* C, int wsel_len, float* ws, int ws_len,
                                int bf16, void* stream) {
  if (which != rowmix::kMixRows && which != rowmix::kMixWeights)
    return (int)cudaErrorInvalidValue;
  return (int)rowmix::mix_products(
      static_cast<rowmix::MixProduct>(which), probs, n_probs, rows, KM,
      out_dim, S, wsel, gout, C, wsel_len, ws, ws_len,
      static_cast<cudaStream_t>(stream), bf16 != 0);
}

// C [M, N] = A B with A [M, K] (a_kc) or stored as [K, M], B [K, N] or
// stored as [N, K] (b_kc); split: the reduction may be split into ws
extern "C" int row_mix_matmul(const float* A, int a_kc, const float* B,
                              int b_kc, float* C, int M, int N, int K,
                              int split, float* ws, int ws_len, int bf16,
                              void* stream) {
  return (int)rowmix::matmul(A, a_kc != 0, B, b_kc != 0, C, M, N, K,
                             split != 0, ws, ws_len,
                             static_cast<cudaStream_t>(stream), bf16 != 0);
}
