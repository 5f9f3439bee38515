// The split-d partial projection shared by the regression singleton sweep
// (marginal_gains.cu) and the regression filter engine (filter_gains.cu).
//
// For lane g of a basis Q (G, d, k) and X (d, n), one CTA computes, over
// one contiguous slice of d (rows_per_slice rows, a multiple of TR), the
// partial projections
//
//     P[z, g, j, a] = Σ_{rows of slice z} Q_g[row, j] · X[row, a]
//
// of a BM-basis × BN-column tile, and with DO_C the partial c = r_gᵀx_a of
// its columns (only the CTAs of the first basis tile).  Each caller's own
// epilogue kernel sums the S slices in a fixed order.
//
// Grid (G · basis tiles, ⌈n / BN⌉, S), the lane index minor, so the CTAs
// that read one X panel run side by side and share it through the L2;
// past 65,535 panels the launch is split into panel ranges.
// 256 threads each keep an 8 × 8 register tile of Q_gᵀX (64 FMAs per 4
// shared-memory vector loads), and with DO_C the c of their 8 columns over
// 2 of every TR rows.  The CTA writes its tile to a workspace (S, G,
// kp + DO_C, np), kp = BM·⌈k/BM⌉ (at least BM), np = BN·⌈n/BN⌉; row kp of
// a (slice, lane) block holds c.
//
// Staging: a 3-stage cp.async ring of TR-row stages of X (upcast on use),
// Q and r in shared memory, one barrier per stage: the copies of stage
// t + 2 are in flight while stage t is multiplied.  The copies are 16
// bytes where every row of X and Q is 16-byte aligned ("wide", the
// wrapper's choice from n, k and the pointers) and one element each
// otherwise (4-byte cp.async; plain loads for bf16, which cp.async cannot
// copy alone).  Ragged d, n and k are zero-filled, no row is read past its
// end, and k = 0 still computes c.  98,688 bytes of ring for f32 X: two
// CTAs per SM at up to 128 registers a thread.
#pragma once

#include <cstdint>

#include "stream.cuh"

// Unnamed: each source that includes this header is a library of its own,
// and its kernels and prepare_partial's once-only attribute setting must
// stay its own (a function-local static of a template with external
// linkage is one object across every library of the process).
namespace {

constexpr int BM = 128;       // basis vectors per CTA tile
constexpr int BN = 128;       // columns per CTA tile
constexpr int TR = 32;        // rows of d per stage
constexpr int STAGES = 3;     // depth of the cp.async ring
constexpr int THREADS = 256;  // 16 × 16 threads, an 8 × 8 tile each

template <typename T>
struct Stage {
  T x[TR][BN];
  float q[TR][BM];
  float r[TR];
};

// The 8 values a thread uses from one staged row: elements 4t..4t+3 and
// 64+4t..64+4t+3 (two conflict-free vector loads per warp).
__device__ __forceinline__ void load8(const float* row, int t, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int t,
                                      float (&v)[8]) {
  const uint2 a = *reinterpret_cast<const uint2*>(row + 4 * t);
  const uint2 b = *reinterpret_cast<const uint2*>(row + 64 + 4 * t);
  const uint32_t w[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 → f32 is exact: the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from global src to shared dst without passing through registers;
// dst is zero-filled and src not read when !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS × COLS tile of src (row stride ld) from (r0, c0) into dst, zero
// outside rows < r1 and columns < c1.  WIDE: 16-byte copies, which needs
// every source row 16-byte aligned; a copy is then wholly in or out.  A
// thread's copies share one column and step RSTEP rows apart, so each
// costs a pointer increment and one row test.
template <bool WIDE, int COLS, int ROWS = TR, typename T>
__device__ __forceinline__ void stage_tile(T (*dst)[COLS], const T* src,
                                           long long ld, int r0, int r1,
                                           int c0, int c1, int tid) {
  constexpr int CH = WIDE ? 16 / sizeof(T) : 1;  // elements per copy
  constexpr int CPR = COLS / CH;                 // copies per row
  constexpr int RSTEP = THREADS / CPR;
  static_assert(ROWS % RSTEP == 0, "a tile's rows split evenly");
  const int row = tid / CPR, cc = (tid % CPR) * CH;
  const bool col_ok = c0 + cc < c1;
  const T* p = src + (long long)(r0 + row) * ld + c0 + cc;
#pragma unroll
  for (int i = 0; i < ROWS / RSTEP; ++i, p += RSTEP * ld) {
    const bool ok = col_ok && r0 + row + i * RSTEP < r1;
    T* d = &dst[row + i * RSTEP][cc];
    if constexpr (WIDE)
      cp_async<16>(d, ok ? p : src, ok);
    else if constexpr (sizeof(T) == 4)
      cp_async<4>(d, ok ? p : src, ok);
    else
      *d = ok ? *p : repro_torch::stream_zero<T>();
  }
}

template <typename T, bool WIDE, bool DO_C>
__global__ void __launch_bounds__(THREADS, 2)
gains_partial_kernel(const T* __restrict__ X, int d, int n, int G,
                     const float* __restrict__ Q, int k,
                     const float* __restrict__ R, int rows_per_slice,
                     float* __restrict__ ws, int kp, int np, int panel0) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
  const int tid = threadIdx.x;
  // A warp covers 8 column groups × 4 basis groups, so each of its
  // vector loads of a staged row reads 128 or 64 distinct bytes.
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int g = blockIdx.x % G, k0 = (blockIdx.x / G) * BM;
  const int col0 = (panel0 + blockIdx.y) * BN;
  const int r0 = blockIdx.z * rows_per_slice;
  const int r1 = min(r0 + rows_per_slice, d);
  const int steps = (r1 - r0 + TR - 1) / TR;
  const bool do_c = DO_C && k0 == 0;
  const float* Qg = Q + (long long)g * d * k;
  const float* Rg = R + (long long)g * d;

  // Stage t of this slice into ring slot t % STAGES; one commit group per
  // call, empty past the last stage, so wait_group counts stay uniform.
  auto issue = [&](int t) {
    if (t < steps) {
      Stage<T>& st = ring[t % STAGES];
      const int s0 = r0 + t * TR;
      stage_tile<WIDE, BN>(st.x, X, n, s0, r1, col0, n, tid);
      stage_tile<WIDE, BM>(st.q, Qg, k, s0, r1, k0, k, tid);
      if (DO_C && tid < TR) {
        const bool ok = s0 + tid < r1;
        cp_async<4>(&st.r[tid], ok ? Rg + s0 + tid : Rg, ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
  float c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage t landed
    __syncthreads();              // everyone's did; slot (t-1) % 3 is free
    issue(t + STAGES - 1);
    const Stage<T>& st = ring[t % STAGES];
#pragma unroll 8
    for (int r = 0; r < TR; ++r) {
      float x[8], b[8];
      load8(st.x[r], tx, x);
      load8(st.q[r], ty, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], b[j], acc[i][j]);
    }
    if (do_c) {
#pragma unroll
      for (int h = 0; h < TR / 16; ++h) {
        float x[8];
        load8(st.x[ty + 16 * h], tx, x);
        const float rv = st.r[ty + 16 * h];
#pragma unroll
        for (int i = 0; i < 8; ++i) c[i] = fmaf(x[i], rv, c[i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Partial projections: row k0 + j of this (slice, lane) block, for the
  // basis vectors below k; the workspace rows are np ≥ n wide, so the
  // 16-byte stores need no column mask.
  float* wsg =
      ws + ((long long)blockIdx.z * G + g) * (long long)(kp + DO_C) * np;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gj = k0 + (j < 4 ? 4 * ty + j : 64 + 4 * ty + j - 4);
    if (gj >= k) continue;
    float* row = wsg + (long long)gj * np + col0;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
  if (!do_c) return;
  // c over the 16 row classes, summed in a fixed order into row kp.
  float(*red)[BN] = reinterpret_cast<float(*)[BN]>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[ty][4 * tx + i] = c[i];
    red[ty][64 + 4 * tx + i] = c[4 + i];
  }
  __syncthreads();
  if (tid < BN) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[t][tid];
    wsg[(long long)kp * np + col0 + tid] = s;
  }
}

template <typename T>
constexpr int RING_BYTES = STAGES * sizeof(Stage<T>);

// Lets the kernel take its ring (over the 48 KB default) and two CTAs'
// rings per SM; once per kernel.
template <typename T, bool WIDE, bool DO_C>
cudaError_t prepare_partial() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        gains_partial_kernel<T, WIDE, DO_C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES<T>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gains_partial_kernel<T, WIDE, DO_C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

// gridDim.y's limit: one launch takes at most this many column panels.
constexpr int MAX_PANELS = 65535;

// The partial kernel over the (G · kp/BM, np/BN, S) grid, in launches of
// at most MAX_PANELS column panels (any n); R may be null without DO_C.
template <typename T, bool WIDE, bool DO_C>
cudaError_t launch_partial(const void* X, int d, int n, int G, const void* Q,
                           int k, const void* R, int S, int rows_per_slice,
                           float* ws, int kp, int np, cudaStream_t stream) {
  const cudaError_t err = prepare_partial<T, WIDE, DO_C>();
  if (err != cudaSuccess) return err;
  for (int p0 = 0; p0 < np / BN; p0 += MAX_PANELS) {
    const int panels = min(np / BN - p0, MAX_PANELS);
    const dim3 grid(G * (kp / BM), panels, S);
    gains_partial_kernel<T, WIDE, DO_C>
        <<<grid, THREADS, RING_BYTES<T>, stream>>>(
            static_cast<const T*>(X), d, n, G, static_cast<const float*>(Q),
            k, static_cast<const float*>(R), rows_per_slice, ws, kp, np, p0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The partial kernel (wide staging) described into out[5]: registers per
// thread, spill (local) bytes, shared-memory bytes per CTA, threads per
// CTA, CTAs per SM.
template <typename T, bool DO_C>
cudaError_t describe_partial(int* out) {
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = prepare_partial<T, true, DO_C>();
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, gains_partial_kernel<T, true, DO_C>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gains_partial_kernel<T, true, DO_C>, THREADS,
        RING_BYTES<T>);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(a.sharedSizeBytes) + RING_BYTES<T>;
  const int vals[5] = {a.numRegs, static_cast<int>(a.localSizeBytes), smem,
                       THREADS, per_sm};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return cudaSuccess;
}

}  // namespace
