// logistic_filter_gains — the sample-batched filter engine with its
// logistic epilogue, hand-written for sm_90a.
//
// Replaces the TPU kernels
// src/repro/kernels/filter_gains/kernel_logistic.py
// (logistic_filter_gains_pallas, epilogue _logistic_epilogue) and, for
// this epilogue, the engine geometry of src/repro/kernels/filter_gains/
// core.py (launch_filter_engine).  Each perturbed state S_g ∪ R_gi of the
// DASH (OPT, α) lattice is fully described by its refit logits η_s,
// s = g·m + i (the refit is glue outside the kernel:
// ClassificationObjective.expand_logits), so the lattice is S = G·m
// states folded guess-major, and per state and candidate column the
// kernel runs the singleton sweep of newton_sweep.cuh.
//
// Design point (as on the TPU): X is fetched from HBM once for all S
// states and all steps.  A CTA stages a slab of NC candidate columns over
// all d rows in shared memory, in X's storage type (NC = 8, 4, 2 or 1:
// the most that fit in 227 KB, at most 8; at d = 8192, 4 f32 or 8 bf16
// columns, 128 KB).  Its 16 warps then take the S states in turn; a warp
// owns one state and all NC columns: its 32 lanes walk the rows, read the
// slab without bank conflicts and η_s, y and ℓ_i(η_si) once per row for
// the NC columns, and each Newton step's sums close with warp shuffles —
// no barrier after the slab is staged.  X is read from HBM once; η_s and
// y come from L2, once per (state, column slab, pass).
//
// The slab is the limit: d rows of one column must fit, d ≤ 58,080 in
// f32 and d ≤ 116,192 in bf16.  logistic_filter_gains_columns returns 0
// above it, and the wrapper raises.
//
// Two launches per call: row_loglik_kernel makes c = ℓ_i(η_si) for all S
// states first (scratch (S, d), allocated by the wrapper), then the sweep.
//
// What bounds it on the H100: the special-function units, as for
// logistic_gains — 8 transcendentals and about 41 flops per element and
// state at steps = 3.  At d = n = 8192, S = 48: 25.8 G transcendentals,
// 6.2 ms at 132 SMs × 16 SFUs × 1.98 GHz, against 2.0 ms of flops at
// 67 TFLOP/s and 0.08 ms for X's 268 MB.
#include "newton_sweep.cuh"

using namespace repro_torch;

constexpr int LF_WARPS = 16;                 // states in flight per CTA
constexpr int LF_THREADS = LF_WARPS * 32;
constexpr int LF_MAX_SMEM = 232448;          // 227 KB, opt-in per kernel

// Rows a slab column is padded to: a multiple of 32 plus 8, so the
// row-major staging stores of a warp spread over the banks.
__host__ __device__ inline int lf_stride(int d) {
  return ((d + 31) / 32) * 32 + 8;
}

// Sums over the 32 lanes of a warp: an xor butterfly leaves the same
// total in every lane (IEEE addition commutes).
struct WarpReduce {
  template <int N>
  __device__ __forceinline__ void operator()(float (&v)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
  }
};

template <typename T, int NC>
__global__ void __launch_bounds__(LF_THREADS, 1)
logistic_filter_kernel(const T* __restrict__ X, const float* __restrict__ y,
                       const float* __restrict__ etas,
                       const float* __restrict__ c_old, int d, int n, int S,
                       int steps, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);   // column c at slab[c·ds + i]
  const int ds = lf_stride(d);
  const int col0 = blockIdx.x * NC;

  // Stage the slab once: consecutive threads take consecutive columns of
  // a row; columns past n are zero.
  for (int e = threadIdx.x; e < d * NC; e += LF_THREADS) {
    const int r = e / NC, c = e % NC;
    const int col = col0 + c;
    slab[c * ds + r] =
        col < n ? X[(long long)r * n + col] : stream_zero<T>();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < S; s += LF_WARPS) {
    const float* es = etas + (long long)s * d;
    const float* cs = c_old + (long long)s * d;
    auto rows = [&](auto&& f) {
#pragma unroll 2
      for (int r = lane; r < d; r += 32) {
        float x[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) x[c] = to_f32(slab[c * ds + r]);
        f(x, es[r], y[r], cs[r]);
      }
    };
    float gain[NC];
    newton_gain_sweep<NC>(steps, rows, WarpReduce{}, gain);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (col0 + c < n) out[(long long)s * n + col0 + c] = gain[c];
    }
  }
}

static size_t lf_smem(int d, int nc, size_t elem) {
  return (size_t)nc * lf_stride(d) * elem;
}

// Columns per slab for this d and storage type: 8, 4, 2 or 1, or 0 when
// one column of d rows does not fit in shared memory.
extern "C" int logistic_filter_gains_columns(int d, int bf16) {
  const size_t elem = bf16 ? 2 : 4;
  for (int nc = 8; nc >= 1; nc /= 2)
    if (lf_smem(d, nc, elem) <= (size_t)LF_MAX_SMEM) return nc;
  return 0;
}

template <typename T, int NC>
static cudaError_t launch_slab(const T* X, const float* y, const float* etas,
                               const float* c_old, int d, int n, int S,
                               int steps, float* out, cudaStream_t s) {
  const size_t smem = lf_smem(d, NC, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      logistic_filter_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + NC - 1) / NC;
  logistic_filter_kernel<T, NC><<<blocks, LF_THREADS, smem, s>>>(
      X, y, etas, c_old, d, n, S, steps, out);
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_logistic_filter(const void* Xv, const float* y,
                                          const float* etas, int d, int n,
                                          int S, int steps, float* c_old,
                                          float* out, cudaStream_t s) {
  const T* X = static_cast<const T*>(Xv);
  launch_row_loglik(y, etas, d, S, c_old, s);
  switch (logistic_filter_gains_columns(d, sizeof(T) == 2)) {
    case 8: return launch_slab<T, 8>(X, y, etas, c_old, d, n, S, steps, out, s);
    case 4: return launch_slab<T, 4>(X, y, etas, c_old, d, n, S, steps, out, s);
    case 2: return launch_slab<T, 2>(X, y, etas, c_old, d, n, S, steps, out, s);
    case 1: return launch_slab<T, 1>(X, y, etas, c_old, d, n, S, steps, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// X: (d, n) f32 or bf16 (bf16 != 0); y: (d,), etas: (S, d) f32; c_old:
// (S, d) f32 scratch; out: (S, n) f32.  All contiguous, on the card.
extern "C" int logistic_filter_gains_launch(const void* X, int bf16,
                                            const void* y, const void* etas,
                                            int d, int n, int S, int steps,
                                            void* c_old, void* out,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* ef = static_cast<const float*>(etas);
  float* cf = static_cast<float*>(c_old);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      bf16 ? launch_logistic_filter<__nv_bfloat16>(X, yf, ef, d, n, S, steps,
                                                   cf, of, s)
           : launch_logistic_filter<float>(X, yf, ef, d, n, S, steps, cf, of,
                                           s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
