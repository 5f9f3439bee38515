// aopt_filter_gains — the sample-batched filter engine with its
// A-optimality (Woodbury) epilogue, hand-written for sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/filter_gains/kernel_aopt.py
// (aopt_filter_gains_pallas, epilogue _aopt_epilogue) and, for this
// epilogue, the engine geometry of src/repro/kernels/filter_gains/core.py
// (launch_filter_engine).  For guess g < G and sample i < m of the DASH
// (OPT, α) lattice, s = g·m + i, the perturbed precision of S_g ∪ R_s
// splits as M_s⁻¹ = M_g⁻¹ − E_s E_sᵀ with E_s (d, b) and F_s = E_sᵀE_s, so
// against the guess's shared solve W_g = M_g⁻¹X (G, d, n):
//
//     wsq = ‖w_ga‖²,  xw = x_aᵀ w_ga                    (per guess)
//     t = E_sᵀ x_a,  u = E_sᵀ w_ga                      (b each)
//     num = wsq − 2 uᵀt + tᵀ F_s t                       (clamped at 0)
//     den = 1 + σ⁻² (xw − ‖t‖²)
//     gain[s, a] = σ⁻² max(num, 0) / max(den, 1e-30)
//
// What bounds it on the H100: f32 arithmetic, about 4·d·b flops per
// (state, candidate) for t and u — at the design lattice (d = 1024,
// n = 65536, G = 12, m = 8, b = 8) 2.06e11 flops, 3.1 ms at the 67 TFLOP/s
// non-tensor f32 peak, against about 1 ms for the bytes (X once, W_g once
// per guess).  No tensor cores: TF32 would break the 2e-4 parity with the
// f32 reference.
//
// Layout (ops.py::aopt_plan, ops.py::pack_factors).  Each sample's b
// Woodbury columns take a slot of bs columns, bs = 8·⌈b/8⌉ for b ≤ 64
// (b = 0 takes one zero group) and 64·⌈b/64⌉ above.  A unit is ms =
// ⌊64/bs⌋ slots (at most m) or, past 64, one sample; its nc = ⌈bs/64⌉
// chunks of 64 columns are one CTA's work.  The wrapper packs each guess's
// factors into Ep (G, d, bw), unit after unit, zero in the unused columns,
// so every staged row is 16-byte aligned.
//
// One launch, a 1-D grid of ⌈n/128⌉ panels × G·units CTAs, the unit index
// minor: the CTAs of all guesses on one X panel run side by side and read
// it through the L2, and each W_g panel is read once per unit.  A CTA of
// 256 threads (8 warps) takes one 128-column panel and one unit:
//   * a 2-stage cp.async ring of 32-row stages of X, W_g (f32 or bf16,
//     upcast on use) and the unit's 64 packed E columns, one barrier per
//     stage (split_proj.cuh's stage_tile and cp_async): 80 KB in f32, so
//     two CTAs share an SM (a third stage would leave one);
//   * each thread an 8-column × 4-candidate register tile of t and of u
//     (64 FMAs per row on one staged x, w and 8 E values); a warp covers 8
//     candidate groups × 4 column groups, so each of its 4 vector loads of a
//     staged row is one shared-memory wavefront;
//   * wsq and xw summed from the staged stored values (bf16 stays bf16's)
//     during the first chunk;
//   * at a chunk's end, −2uᵀt and ‖t‖² of the thread's 8 columns are
//     added to its own entries in shared memory, and t goes to the
//     CTA's block of a global scratch the wrapper allocates (the chunks
//     before the last, b > 64) or to the drained ring (the last);
//   * tᵀF t over the unit's block-diagonal F (the slots' F_s, zero across
//     slots) in 64 × 64 blocks staged in shared memory, the same 8 × 4
//     tile per thread, each thread's columns only against its own slot's;
//   * the per-column-group sums meet in shared memory and close per
//     (slot, candidate) in a fixed order.  No atomics: two calls give the
//     same bits.
// Ragged d, n, m and b are zero-filled; b = 0 gives the singleton
// Sherman–Morrison gain.
#include "split_proj.cuh"

namespace {

using repro_torch::to_f32;

constexpr int AF_TR = 32;       // rows of d per stage
constexpr int AF_STAGES = 2;    // depth of the cp.async ring
constexpr int AF_BN = 128;      // candidates per CTA (BN of split_proj)
constexpr int AF_CH = 64;       // Woodbury columns per chunk
constexpr int AF_FLD = AF_CH + 4;  // row stride of the staged F block

template <typename T>
struct AStage {
  T x[AF_TR][AF_BN];
  T w[AF_TR][AF_BN];
  float e[AF_TR][AF_CH];
};

template <typename T>
constexpr int AF_RING = AF_STAGES * sizeof(AStage<T>);
// After the loop, in the ring's place: t of the last chunk (64, 128) and
// one F block (64, AF_FLD).
constexpr int AF_EPI = (AF_CH * AF_BN + AF_CH * AF_FLD) * 4;
template <typename T>
constexpr int AF_BASE = (AF_RING<T> > AF_EPI) ? AF_RING<T> : AF_EPI;
// Per column group and candidate: the numerator's and ‖t‖²'s sums (2, 8,
// 128), then wsq's and xw's over the two row classes (2, 2, 128).
constexpr int AF_RED = (2 * 8 + 2 * 2) * AF_BN * 4;
// Dynamic shared memory of one CTA.
template <typename T>
constexpr int AF_SMEM = AF_BASE<T> + AF_RED;

// The 4 values of a staged row a thread multiplies: elements 4t..4t+3.
__device__ __forceinline__ void load4(const float* row, int t, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* row, int t,
                                      float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(row + 4 * t);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}

// Geometry of a launch, from ops.py::aopt_plan.
struct AfPlan {
  int bs;     // columns of a sample's slot
  int ms;     // slots per unit
  int nc;     // chunks of 64 columns per unit
  int units;  // units per guess
  int bw;     // packed columns per guess: units · nc · 64
};

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
aopt_filter_kernel(const T* __restrict__ X, const T* __restrict__ W, int d,
                   int n, int G, int m, const float* __restrict__ Ep,
                   const float* __restrict__ F, int b, AfPlan p, float isig2,
                   float* scratch, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  AStage<T>* ring = reinterpret_cast<AStage<T>*>(smem);
  float* const sf = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  // A warp covers 8 candidate groups × 4 column groups: each vector load
  // of a staged row reads 128 (X, W in f32) or 64 distinct bytes.
  const int lane = tid & 31, warp = tid >> 5;
  const int cg = (warp & 3) * 8 + (lane & 7);   // candidates 4cg..4cg+3
  const int kg = (warp >> 2) * 4 + (lane >> 3);  // columns 8kg..8kg+7
  const int U = G * p.units;
  const int unit = blockIdx.x % U;
  const int g = unit / p.units, j = unit % p.units;
  const int col0 = (blockIdx.x / U) * AF_BN;
  const T* Wg = W + (long long)g * d * n;
  const float* Eu = Ep + (long long)g * d * p.bw + j * p.nc * AF_CH;
  const int spc = (d + AF_TR - 1) / AF_TR;       // stages per chunk
  const int steps = p.nc * spc;
  // t of the chunks before the last: rows c·64 + k of this CTA's
  // (nc−1)·64 × 128 block of the scratch.
  const int sep = (p.nc - 1) * AF_CH;
  float* const red = sf + AF_BASE<T> / 4;      // this thread's own entries
  float* const cps = red + 2 * 8 * AF_BN;
  float* const tsep = scratch + (long long)blockIdx.x * sep * AF_BN;

  auto issue = [&](int t) {
    if (t < steps) {
      AStage<T>& st = ring[t % AF_STAGES];
      const int c = t / spc, r0 = (t % spc) * AF_TR;
      stage_tile<WIDE, AF_BN, AF_TR>(st.x, X, n, r0, d, col0, n, tid);
      stage_tile<WIDE, AF_BN, AF_TR>(st.w, Wg, n, r0, d, col0, n, tid);
      stage_tile<true, AF_CH, AF_TR>(st.e, Eu + c * AF_CH, p.bw, r0, d, 0,
                                     AF_CH, tid);
    }
    cp_async_commit();
  };

  float ta[4][8], ua[4][8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < 8; ++k) ta[c][k] = ua[c][k] = 0.f;
  // This thread's sums live in shared memory, not in registers: the
  // numerator and ‖t‖² of its 4 candidates over its 8 columns, and wsq
  // and xw of candidate lc over rows lr, lr + 2, … of each stage.
  float4* const rnum = reinterpret_cast<float4*>(&red[kg * AF_BN + 4 * cg]);
  float4* const rtt =
      reinterpret_cast<float4*>(&red[(8 + kg) * AF_BN + 4 * cg]);
  const int lc = tid % AF_BN, lr = tid / AF_BN;
  float* const psw = &cps[lr * AF_BN + lc];
  float* const psx = &cps[(2 + lr) * AF_BN + lc];
  *rnum = *rtt = make_float4(0.f, 0.f, 0.f, 0.f);
  *psw = *psx = 0.f;

#pragma unroll
  for (int t = 0; t < AF_STAGES - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<AF_STAGES - 2>();  // this thread's stage t landed
    __syncthreads();              // everyone's did; slot (t-1) % 2 is free
    issue(t + AF_STAGES - 1);
    const AStage<T>& st = ring[t % AF_STAGES];
    if (t < spc) {
      float sw = *psw, sx = *psx;
#pragma unroll
      for (int h = 0; h < AF_TR / 2; ++h) {
        const float x = to_f32(st.x[lr + 2 * h][lc]);
        const float w = to_f32(st.w[lr + 2 * h][lc]);
        sw = fmaf(w, w, sw);
        sx = fmaf(x, w, sx);
      }
      *psw = sw;
      *psx = sx;
    }
#pragma unroll 4
    for (int r = 0; r < AF_TR; ++r) {
      float x[4], w[4];
      load4(st.x[r], cg, x);
      load4(st.w[r], cg, w);
      const float4 e0 = *reinterpret_cast<const float4*>(&st.e[r][8 * kg]);
      const float4 e1 =
          *reinterpret_cast<const float4*>(&st.e[r][8 * kg + 4]);
      const float e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          ta[c][k] = fmaf(x[c], e[k], ta[c][k]);
          ua[c][k] = fmaf(w[c], e[k], ua[c][k]);
        }
    }
    if ((t + 1) % spc == 0) {     // a chunk ends (uniform over the CTA)
      const int c = t / spc;
      float pnum[4] = {rnum->x, rnum->y, rnum->z, rnum->w};
      float ptt[4] = {rtt->x, rtt->y, rtt->z, rtt->w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          pnum[cc] = fmaf(-2.f * ua[cc][k], ta[cc][k], pnum[cc]);
          ptt[cc] = fmaf(ta[cc][k], ta[cc][k], ptt[cc]);
        }
      *rnum = make_float4(pnum[0], pnum[1], pnum[2], pnum[3]);
      *rtt = make_float4(ptt[0], ptt[1], ptt[2], ptt[3]);
      if (c + 1 < p.nc) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          *reinterpret_cast<float4*>(
              &tsep[(c * AF_CH + 8 * kg + k) * AF_BN + 4 * cg]) =
              make_float4(ta[0][k], ta[1][k], ta[2][k], ta[3][k]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) ta[cc][k] = ua[cc][k] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is drained: reuse it

  // The last chunk's t to the ring's place; F blocks behind it.
  float* tlast = sf;
  float* Fs = sf + AF_CH * AF_BN;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    *reinterpret_cast<float4*>(&tlast[(8 * kg + k) * AF_BN + 4 * cg]) =
        make_float4(ta[0][k], ta[1][k], ta[2][k], ta[3][k]);
  auto trow = [&](int K) -> const float* {
    return K < sep ? tsep + K * AF_BN : tlast + (K - sep) * AF_BN;
  };

  // tᵀF t: output chunk co against column chunk ci of the unit's
  // block-diagonal F, staged transposed (Fs[l][k] = F_unit[K][L]).
  const float* Fg = F + (long long)g * m * b * b;
  // A slot narrower than a chunk couples only its own columns: the thread
  // runs l over its slot (lb + l), the rest of the block being zero.
  const int lb = p.nc == 1 ? (8 * kg / p.bs) * p.bs : 0;
  const int lw = p.nc == 1 ? min(p.bs, AF_CH - lb) : AF_CH;
  for (int co = 0; b > 0 && co < p.nc; ++co) {
    float tk[4][8], ft[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 8; ++k) ft[c][k] = 0.f;
    for (int ci = 0; ci < p.nc; ++ci) {
      __syncthreads();            // Fs free; every t store visible
      // Thread tid stages column l = tid % 64 of rows k = tid / 64 + 4q.
      const int l = tid % AF_CH, L = ci * AF_CH + l;
      const int slot = L / p.bs, ll = L - slot * p.bs;
      const int i = j * p.ms + slot;
      const bool lok = slot < p.ms && i < m && ll < b;
#pragma unroll 4
      for (int q = 0; q < AF_CH * AF_CH / THREADS; ++q) {
        const int k = tid / AF_CH + (THREADS / AF_CH) * q;
        const int kk = co * AF_CH + k - slot * p.bs;
        const bool ok = lok && kk >= 0 && kk < b;
        Fs[l * AF_FLD + k] =
            ok ? Fg[((long long)i * b + kk) * b + ll] : 0.f;
      }
      __syncthreads();
      if (ci == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v[4];
          load4(trow(co * AF_CH + 8 * kg + k), cg, v);
#pragma unroll
          for (int c = 0; c < 4; ++c) tk[c][k] = v[c];
        }
      }
#pragma unroll 4
      for (int l = lb; l < lb + lw; ++l) {
        float tv[4];
        load4(trow(ci * AF_CH + l), cg, tv);
        const float4 f0 =
            *reinterpret_cast<const float4*>(&Fs[l * AF_FLD + 8 * kg]);
        const float4 f1 =
            *reinterpret_cast<const float4*>(&Fs[l * AF_FLD + 8 * kg + 4]);
        const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < 8; ++k) ft[c][k] = fmaf(f[k], tv[c], ft[c][k]);
      }
    }
    float pnum[4] = {rnum->x, rnum->y, rnum->z, rnum->w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 8; ++k) pnum[c] = fmaf(tk[c][k], ft[c][k], pnum[c]);
    *rnum = make_float4(pnum[0], pnum[1], pnum[2], pnum[3]);
  }
  __syncthreads();                // every thread's sums are in place

  // The column groups' sums close per (slot, candidate) in a fixed order.
  const int gps = (p.bs < AF_CH ? p.bs : AF_CH) / 8;  // groups per slot
  for (int o = tid; o < p.ms * AF_BN; o += THREADS) {
    const int slot = o / AF_BN, a = o % AF_BN;
    const int i = j * p.ms + slot, col = col0 + a;
    if (i >= m || col >= n) continue;
    float num = 0.f, tt = 0.f;
    for (int q = slot * gps; q < (slot + 1) * gps; ++q) {
      num += red[q * AF_BN + a];
      tt += red[(8 + q) * AF_BN + a];
    }
    num += cps[a] + cps[AF_BN + a];
    const float xw = cps[2 * AF_BN + a] + cps[3 * AF_BN + a];
    const float den = 1.f + isig2 * (xw - tt);
    out[((long long)g * m + i) * n + col] =
        isig2 * fmaxf(num, 0.f) / fmaxf(den, 1e-30f);
  }
}

// Lets the kernel take its shared memory (over the 48 KB default) and two
// CTAs' worth per SM; once per instance.
template <typename T, bool WIDE>
cudaError_t prepare_aopt() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        aopt_filter_kernel<T, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, AF_SMEM<T>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(aopt_filter_kernel<T, WIDE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T, bool WIDE>
cudaError_t launch_aopt(const void* X, const void* W, int d, int n, int G,
                        int m, const void* Ep, const void* F, int b,
                        AfPlan p, float isig2, void* scratch, void* out,
                        cudaStream_t s) {
  const cudaError_t err = prepare_aopt<T, WIDE>();
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((n + AF_BN - 1) / AF_BN) * G * p.units;
  aopt_filter_kernel<T, WIDE>
      <<<(unsigned)ctas, THREADS, AF_SMEM<T>, s>>>(
          static_cast<const T*>(X), static_cast<const T*>(W), d, n, G, m,
          static_cast<const float*>(Ep), static_cast<const float*>(F), b, p,
          isig2, static_cast<float*>(scratch), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// X: (d, n), W: (G, d, n), both f32 or both bf16 (bf16 != 0), rows
// 16-byte aligned if wide != 0; Ep: (G, d, bw) f32 factors packed as
// ops.py::pack_factors lays them out for the plan (bs, ms, nc, units, bw);
// F: (G, m, b, b) f32, b ≥ 0; out: (G, m, n) f32.  For nc > 1 the scratch
// holds at least ⌈n/128⌉ · G · units · (nc − 1) · 64 · 128 f32; otherwise
// it is not read.  All contiguous, on the card.
extern "C" int aopt_filter_gains_launch(const void* X, const void* W,
                                        int bf16, int wide, int d, int n,
                                        int G, int m, const void* Ep,
                                        const void* F, int b, int bs, int ms,
                                        int nc, int units, float isig2,
                                        void* scratch,
                                        long long scratch_elems, void* out,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AfPlan p{bs, ms, nc, units, units * nc * AF_CH};
  const long long ctas = (long long)((n + AF_BN - 1) / AF_BN) * G * units;
  const bool one = nc == 1 && bs % 8 == 0 && bs >= 8 && bs >= b &&
                   ms >= 1 && ms * bs <= AF_CH;
  const bool many = nc > 1 && ms == 1 && bs == nc * AF_CH && bs >= b &&
                    bs - AF_CH < b;
  if (G < 1 || m < 1 || n < 1 || d < 1 || b < 0 || !(one || many) ||
      (long long)units * ms < m || (units - 1LL) * ms >= m ||
      ctas > 0x7fffffffLL ||
      (nc > 1 && scratch_elems < ctas * (nc - 1) * AF_CH * AF_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16) {
    err = wide ? launch_aopt<__nv_bfloat16, true>(X, W, d, n, G, m, Ep, F, b,
                                                  p, isig2, scratch, out, s)
               : launch_aopt<__nv_bfloat16, false>(X, W, d, n, G, m, Ep, F,
                                                   b, p, isig2, scratch, out,
                                                   s);
  } else {
    err = wide ? launch_aopt<float, true>(X, W, d, n, G, m, Ep, F, b, p,
                                          isig2, scratch, out, s)
               : launch_aopt<float, false>(X, W, d, n, G, m, Ep, F, b, p,
                                           isig2, scratch, out, s);
  }
  return static_cast<int>(err);
}

// The kernel (wide staging) for X in bf16 (bf16 != 0) or f32, described
// into out[5]: registers per thread, spill (local) bytes, shared-memory
// bytes per CTA, threads per CTA, CTAs per SM.
namespace {
template <typename T>
cudaError_t describe_aopt(int* out) {
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = prepare_aopt<T, true>();
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, aopt_filter_kernel<T, true>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, aopt_filter_kernel<T, true>, THREADS, AF_SMEM<T>);
  if (err != cudaSuccess) return err;
  const int vals[5] = {a.numRegs, static_cast<int>(a.localSizeBytes),
                       static_cast<int>(a.sharedSizeBytes) + AF_SMEM<T>,
                       THREADS, per_sm};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return cudaSuccess;
}
}  // namespace

extern "C" int aopt_filter_kernel_info(int bf16, int* out) {
  return static_cast<int>(bf16 ? describe_aopt<__nv_bfloat16>(out)
                               : describe_aopt<float>(out));
}
