// regression_gains — the singleton-gain sweep, hand-written for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/marginal_gains/kernel.py
// (regression_gains_pallas, body _gains_kernel).  Per lane g and candidate
// column a of X (d, n):
//
//     c = x_aᵀ r_g,  s = ‖Q_gᵀ x_a‖²,  gain = c² / (‖x_a‖² − s)
//
// span-guarded (0 when ‖x_a‖² − s ≤ span_tol·max(‖x_a‖², 1)).  The lane
// axis G carries the DASH guess lattice (one call serves every guess's
// current-state gain); greedy and top-k call it with G = 1.
//
// What bounds it on the H100: f32 arithmetic.  One call is 2·d·n·(k+1)
// flops over d·n elements of X — at d = n = 8192, k = 128 about 17.3
// GFLOP against 268 MB, i.e. ~0.26 ms at the 67 TFLOP/s non-tensor f32
// peak versus ~0.08 ms for the bytes.  Tensor cores are not used: TF32
// breaks the 2e-4 parity with the f32 reference.
//
// Design, two kernels per call:
//   1. gains_partial_kernel<T, WIDE, DO_C = true> of split_proj.cuh, grid
//      (G · basis tiles, ⌈n / BN⌉, S).  Each CTA reduces one contiguous
//      slice of d for a 128-basis × 128-column tile, so one lane fills the
//      card: the wrapper picks S (ops.py::split_plan) from G, d, n, k and
//      the SM count.  The CTA writes its partial projections and c to a
//      workspace (S, G, kp + 1, np).  The filter engine (filter_gains.cu)
//      runs the same kernel without c.
//   2. gains_epilogue_kernel sums the S partials of each (basis vector,
//      column) in a fixed order, squares, sums over the basis and applies
//      the gain and the span guard.  No atomics: two calls on the same
//      inputs give bitwise-equal gains, so greedy's argmax cannot flip
//      between runs on a near-tie.
// The header describes the staging (a 3-stage cp.async ring, 16-byte or
// element copies) and the 8 × 8 register tile.
#include "split_proj.cuh"

namespace {

constexpr int EPI_COLS = 32;  // epilogue CTA: 32 columns × 8 basis strides
constexpr int EPI_SPLIT = 8;

__global__ void __launch_bounds__(EPI_COLS * EPI_SPLIT)
gains_epilogue_kernel(const float* __restrict__ ws, int S, int G, int n,
                      int k, int kp, int np, const float* __restrict__ col_sq,
                      float* __restrict__ out, float span_tol) {
  __shared__ float red[EPI_SPLIT][EPI_COLS];
  const int cx = threadIdx.x, jy = threadIdx.y;
  const int col = blockIdx.x * EPI_COLS + cx;
  const int g = blockIdx.y;
  const long long slice = (long long)G * (kp + 1) * np;
  const float* base = ws + (long long)g * (kp + 1) * np + col;
  float ss = 0.f;
  if (col < n) {
    for (int j = jy; j < k; j += EPI_SPLIT) {
      const float* p = base + (long long)j * np;
      float b = 0.f;
#pragma unroll 4
      for (int s = 0; s < S; ++s) b += p[s * slice];
      ss = fmaf(b, b, ss);
    }
  }
  red[jy][cx] = ss;
  __syncthreads();
  if (jy != 0 || col >= n) return;
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < EPI_SPLIT; ++t) s += red[t][cx];
  float cv = 0.f;
  const float* pc = base + (long long)kp * np;
  for (int t = 0; t < S; ++t) cv += pc[t * slice];
  const float csq = col_sq[col];
  const float denom = csq - s;
  const float floor_ = span_tol * fmaxf(csq, 1.f);
  const float gain = (cv * cv) / fmaxf(denom, 1e-30f);
  out[(long long)g * n + col] = denom > floor_ ? gain : 0.f;
}

}  // namespace

// X: (d, n) f32 or bf16 (x_bf16 != 0); Q: (G, d, k) f32; R: (G, d) f32;
// col_sq: (n,) f32; out: (G, n) f32; ws: ws_elems f32 of scratch, at least
// S · G · (kp + 1) · np with kp = 128·max(1, ⌈k/128⌉), np = 128·⌈n/128⌉.
// wide != 0 promises 16-byte-aligned rows of X and Q.  Slice z of the S
// covers rows [z·rows_per_slice, min((z+1)·rows_per_slice, d)), none empty.
extern "C" int regression_gains_launch(const void* X, int x_bf16, int wide,
                                       int d, int n, int G, const void* Q,
                                       int k, const void* R,
                                       const void* col_sq, void* out,
                                       float span_tol, int S,
                                       int rows_per_slice, void* ws,
                                       long long ws_elems, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = BM * (k > 0 ? (k + BM - 1) / BM : 1);
  const int np = BN * ((n + BN - 1) / BN);
  if (G < 1 || n < 1 || S < 1 || rows_per_slice < TR ||
      rows_per_slice % TR != 0 || (long long)S * rows_per_slice < d ||
      (d > 0 && (long long)(S - 1) * rows_per_slice >= d) ||
      ws_elems < (long long)S * G * (kp + 1) * np)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (x_bf16) {
    err = wide ? launch_partial<__nv_bfloat16, true, true>(
                     X, d, n, G, Q, k, R, S, rows_per_slice, w, kp, np, s)
               : launch_partial<__nv_bfloat16, false, true>(
                     X, d, n, G, Q, k, R, S, rows_per_slice, w, kp, np, s);
  } else {
    err = wide ? launch_partial<float, true, true>(
                     X, d, n, G, Q, k, R, S, rows_per_slice, w, kp, np, s)
               : launch_partial<float, false, true>(
                     X, d, n, G, Q, k, R, S, rows_per_slice, w, kp, np, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 egrid((n + EPI_COLS - 1) / EPI_COLS, G);
  gains_epilogue_kernel<<<egrid, dim3(EPI_COLS, EPI_SPLIT), 0, s>>>(
      w, S, G, n, k, kp, np, static_cast<const float*>(col_sq),
      static_cast<float*>(out), span_tol);
  return static_cast<int>(cudaGetLastError());
}

// The partial kernel (wide staging) for X in bf16 (bf16 != 0) or f32,
// described into out[5]: registers per thread, spill (local) bytes,
// shared-memory bytes per CTA, threads per CTA, CTAs per SM.
extern "C" int regression_gains_kernel_info(int bf16, int* out) {
  return static_cast<int>(bf16 ? describe_partial<__nv_bfloat16, true>(out)
                               : describe_partial<float, true>(out));
}
