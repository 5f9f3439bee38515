// filter_gains — the sample-batched filter engine with its regression
// epilogue, hand-written for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/filter_gains/core.py
// (launch_filter_engine, the shared launch geometry) and
// src/repro/kernels/filter_gains/kernel.py (filter_gains_pallas, epilogue
// _regression_epilogue).  For every guess g < G and sample i < m of the
// DASH (OPT, α) lattice, with s = g·m + i:
//
//     gain[s, a] = (x_aᵀ r_s)² / (‖x_a‖² − ‖Q_gᵀ x_a‖² − ‖D_sᵀ x_a‖²)
//
// span-guarded like the singleton sweep.
//
// What bounds it on the H100: f32 arithmetic, 2·d·n·(G·k + G·m·(b+1))
// flops — at d = n = 8192, G = 6, m = 8, k = 128, b = 10 about 174 GFLOP,
// 2.6 ms at the 67 TFLOP/s non-tensor f32 peak, against 0.08 ms for the
// bytes of X.  Tensor cores are not used: TF32 breaks the 2e-4 parity
// with the f32 reference.
//
// Design: every projection the function needs is one product with one
// stacked basis.  The wrapper (ops.py::pack_basis) packs a row-major
// (d, kp) f32 basis B: the k columns of each Q_g, then for each state s
// the b columns of D_s followed by r_s, then zero columns up to kp, a
// multiple of 128 (so every row of B is 16-byte aligned).  Two launches:
//   1. gains_partial_kernel<T, WIDE, DO_C = false> of split_proj.cuh — the
//      regression singleton sweep's split-d kernel — with one lane of kp
//      basis vectors: grid (kp/128, ⌈n/128⌉, S), the basis tiles of one X
//      panel side by side, so X is read from device memory about once per
//      call and every 8 × 8 register tile is dense.  It writes the partial
//      projections Bᵀx_a of each slice of d to a (S, kp, np) workspace.
//   2. engine_epilogue_kernel sums the S partials of each basis vector in
//      a fixed order and, per (g, column), squares and sums guess g's k
//      base vectors once, then per state its b delta vectors (sd) and
//      reads c = r_sᵀx_a, and writes the guarded ratio.  No atomics: two
//      calls on the same inputs give bitwise-equal gains.
// The wrapper picks S (ops.py::engine_plan) and the copy width.
#include "split_proj.cuh"

namespace {

constexpr int EPI_COLS = 32;  // epilogue CTA: 32 columns × 8 row strides
constexpr int EPI_SPLIT = 8;

// ws: (S, kp, np) partial projections; row g·k + j is Q_g's vector j,
// row G·k + s·(b+1) + j state s's delta j (j < b) or r_s (j = b).
__global__ void __launch_bounds__(EPI_COLS * EPI_SPLIT)
engine_epilogue_kernel(const float* __restrict__ ws, int S, int kp, int np,
                       int n, int G, int m, int k, int b,
                       const float* __restrict__ col_sq,
                       float* __restrict__ out, float span_tol) {
  __shared__ float red[EPI_SPLIT][EPI_COLS];
  const int cx = threadIdx.x, jy = threadIdx.y;
  const int col = blockIdx.x * EPI_COLS + cx;
  const int g = blockIdx.y;
  const long long slice = (long long)kp * np;
  const float* base = ws + col;
  // Basis vector j's projection on column col: its S partials in order.
  auto proj = [&](int j) {
    const float* p = base + (long long)j * np;
    float v = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) v += p[s * slice];
    return v;
  };
  float ss = 0.f;
  if (col < n) {
    for (int j = jy; j < k; j += EPI_SPLIT) {
      const float v = proj(g * k + j);
      ss = fmaf(v, v, ss);
    }
  }
  red[jy][cx] = ss;
  __syncthreads();
  if (col >= n) return;
  float bterm = 0.f;
#pragma unroll
  for (int t = 0; t < EPI_SPLIT; ++t) bterm += red[t][cx];
  const float csq = col_sq[col];
  const float floor_ = span_tol * fmaxf(csq, 1.f);
  for (int i = jy; i < m; i += EPI_SPLIT) {
    const int s = g * m + i;
    const int row0 = G * k + s * (b + 1);
    float sd = 0.f;
    for (int j = 0; j < b; ++j) {
      const float v = proj(row0 + j);
      sd = fmaf(v, v, sd);
    }
    const float c = proj(row0 + b);
    const float denom = (csq - bterm) - sd;
    const float gain = (c * c) / fmaxf(denom, 1e-30f);
    out[(long long)s * n + col] = denom > floor_ ? gain : 0.f;
  }
}

}  // namespace

// X: (d, n) f32 or bf16 (x_bf16 != 0); B: (d, kp) f32, the stacked basis
// of G guesses with k base vectors each and G·m states with b delta
// vectors and one residual each, kp a multiple of 128 at least
// G·k + G·m·(b+1); col_sq: (n,) f32; out: (G, m, n) f32; ws: ws_elems f32
// of scratch, at least S · kp · np with np = 128·⌈n/128⌉.  wide != 0
// promises 16-byte-aligned rows of X and B.  Slice z of the S covers rows
// [z·rows_per_slice, min((z+1)·rows_per_slice, d)), none empty.
extern "C" int filter_gains_launch(const void* X, int x_bf16, int wide, int d,
                                   int n, const void* B, int kp, int G,
                                   int m, int k, int b, const void* col_sq,
                                   void* out, float span_tol, int S,
                                   int rows_per_slice, void* ws,
                                   long long ws_elems, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = BN * ((n + BN - 1) / BN);
  if (G < 1 || m < 1 || n < 1 || k < 0 || b < 0 || kp < BM || kp % BM ||
      (long long)G * k + (long long)G * m * (b + 1) > kp || S < 1 ||
      rows_per_slice < TR || rows_per_slice % TR != 0 ||
      (long long)S * rows_per_slice < d ||
      (d > 0 && (long long)(S - 1) * rows_per_slice >= d) ||
      ws_elems < (long long)S * kp * np)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (x_bf16) {
    err = wide ? launch_partial<__nv_bfloat16, true, false>(
                     X, d, n, 1, B, kp, nullptr, S, rows_per_slice, w, kp,
                     np, s)
               : launch_partial<__nv_bfloat16, false, false>(
                     X, d, n, 1, B, kp, nullptr, S, rows_per_slice, w, kp,
                     np, s);
  } else {
    err = wide ? launch_partial<float, true, false>(
                     X, d, n, 1, B, kp, nullptr, S, rows_per_slice, w, kp,
                     np, s)
               : launch_partial<float, false, false>(
                     X, d, n, 1, B, kp, nullptr, S, rows_per_slice, w, kp,
                     np, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 egrid((n + EPI_COLS - 1) / EPI_COLS, G);
  engine_epilogue_kernel<<<egrid, dim3(EPI_COLS, EPI_SPLIT), 0, s>>>(
      w, S, kp, np, n, G, m, k, b, static_cast<const float*>(col_sq),
      static_cast<float*>(out), span_tol);
  return static_cast<int>(cudaGetLastError());
}

// The engine's partial kernel (wide staging) for X in bf16 (bf16 != 0) or
// f32, described into out[5] as regression_gains_kernel_info does.
extern "C" int filter_gains_kernel_info(int bf16, int* out) {
  return static_cast<int>(bf16 ? describe_partial<__nv_bfloat16, false>(out)
                               : describe_partial<float, false>(out));
}
