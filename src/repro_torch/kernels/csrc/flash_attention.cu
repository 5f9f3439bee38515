// flash_attention — online-softmax attention with GQA, causal and
// sliding-window masks, logit softcap, q_offset and ragged Sq/Skv,
// hand-written for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel).  It computes the same
// function: s = (q·k)·D^-½ in f32, optionally c·tanh(s/c), masked to
// −1e30 where kpos ≥ Skv, where causal and qpos + q_offset < kpos, or
// where a window is set and qpos + q_offset − kpos ≥ window; the online
// softmax (m, l, acc) in f32; P cast to v's type before P·V; out =
// acc / max(l, 1e-30) in q's type.  q, k, v, o keep the model's
// (B, S, H, D) layout: the kernel reads rows with the head stride, so the
// wrapper neither pads nor transposes.  GQA maps query head h to KV head
// h / (H / Hkv).
//
// No sequential grid on Hopper: on the TPU the last grid axis walked the
// KV blocks of one output block in order, carrying (m, l, acc) in VMEM
// scratch.  Here one CTA owns (b, h, 64 query rows) and loops over the
// KV blocks itself, the state in registers.  KV blocks that lie wholly
// outside the causal or window band of the CTA's rows are skipped: in the
// TPU kernel they add exp(−1e30 − m) = 0 after the correction, so the
// function is the same, and an 8192-token prefill with window 4096 does
// S·W work instead of S².  Inside a visited block a masked entry adds
// p = 0 (the TPU kernel adds exp(−1e30 − m), which is 0 once a row has
// seen a valid key and is wiped by the next correction before that), so a
// row that has no valid key at all comes out 0; such rows have no
// agreed value (the plain version averages V, the TPU kernel averages V
// and its zero padding) and no caller makes them.  −1e30 stays finite so
// that no exp(−inf + inf) makes a NaN.
//
// Two kernels, chosen by dtype:
//   * bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32
//     accumulate), FA2's register layout: 4 warps × 16 query rows, Q
//     fragments held in registers, K and Vᵀ tiles of 64 keys staged in
//     shared memory; the score accumulator becomes the A operand of P·V
//     without a trip through shared memory.  This is the serving path.
//   * f32: CUDA cores (the tensor cores' f32 input is TF32, about three
//     decimal digits, which cannot meet the reference's 2e-5): a 64 × 64
//     score tile per CTA, each of 128 threads 4 rows × 8 keys, P through
//     shared memory.
//
// What bounds it on the H100: the tensor cores.  The valid (q, k) pairs
// of one (b, h) cost 4·D flops each (QKᵀ and P·V): at the serving shape
// (B 4, S 8192, H 32, Hkv 8, D 80, window 4096, causal) 1.03 TFLOP per
// layer, 1.04 ms at 989 TFLOP/s, against 0.125 ms for reading Q, K, V
// and writing O once at 3.35 TB/s.  This first version issues mma.sync
// (not wgmma), stages K and V synchronously (no cp.async or TMA ring)
// and reads each KV tile once per query head, not once per KV group; the
// f32 kernel is bound by the CUDA cores' 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV block
constexpr int THREADS = 128;  // 4 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, n_rep;
  int causal, window, q_offset;
  float scale;    // D^-1/2
  float softcap;  // 0 = off
};

__device__ __forceinline__ bool valid_pair(const Params& p, int qpos,
                                           int kpos) {
  const int rel = qpos - kpos;
  bool ok = kpos < p.Skv;
  if (p.causal) ok = ok && rel >= 0;
  if (p.window > 0) ok = ok && rel < p.window;
  return ok;
}

// Score in natural units → log2 units (exp(s − m) = exp2(t − m₂)), or
// NEG_INF where the pair is masked.
__device__ __forceinline__ float score_log2(const Params& p, float dot,
                                            int qpos, int kpos) {
  float x = dot * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return valid_pair(p, qpos, kpos) ? x * LOG2E : NEG_INF;
}

// The KV blocks [kb0, kb1) that hold a valid key for some row of the
// query block starting at row q0.
__device__ __forceinline__ void kv_block_range(const Params& p, int q0,
                                               int& kb0, int& kb1) {
  const int qlo = q0 + p.q_offset;
  const int qhi = min(q0 + BQ, p.Sq) - 1 + p.q_offset;
  int end = p.Skv;
  if (p.causal) end = min(end, qhi + 1);
  int begin = 0;
  if (p.window > 0) begin = max(0, qlo - p.window + 1);
  kb0 = begin / BK;
  kb1 = end > begin ? (end + BK - 1) / BK : kb0;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct MmaSmem {
  static constexpr int QP = D + 8;   // Q and K row pitch (16 B of pad)
  static constexpr int VP = BK + 8;  // Vᵀ row pitch
  static constexpr int BYTES = (BQ * QP + BK * QP + D * VP) * 2;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_mma_kernel(Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QP = MmaSmem<D>::QP;
  constexpr int VP = MmaSmem<D>::VP;
  constexpr int KT = D / 16;  // k-steps of QKᵀ
  constexpr int NT = BK / 8;  // n-tiles of the score tile
  constexpr int DT = D / 8;   // n-tiles of the output
  constexpr int V8 = D / 8;   // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QP;
  __nv_bfloat16* Vt = Ks + BK * QP;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.n_rep;
  const long long q_pitch = (long long)p.H * D;
  const long long kv_pitch = (long long)(p.H / p.n_rep) * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            (long long)b * p.Sq * q_pitch + (long long)h * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            (long long)b * p.Skv * kv_pitch +
                            (long long)hk * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            (long long)b * p.Skv * kv_pitch +
                            (long long)hk * D;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                      (long long)b * p.Sq * q_pitch + (long long)h * D;

  for (int i = tid; i < BQ * V8; i += THREADS) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * q_pitch + c);
    *reinterpret_cast<uint4*>(Qs + r * QP + c) = val;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt * 16 + 2 * t;
    qf[kt][0] = ld32(Qs + r0 * QP + c);
    qf[kt][1] = ld32(Qs + (r0 + 8) * QP + c);
    qf[kt][2] = ld32(Qs + r0 * QP + c + 8);
    qf[kt][3] = ld32(Qs + (r0 + 8) * QP + c + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  const int qpos0 = q0 + r0 + p.q_offset;

  int kb0, kb1;
  kv_block_range(p, q0, kb0, kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous block's tiles are no longer read
    for (int i = tid; i < BK * V8; i += THREADS) {
      const int r = i / V8, c = (i % V8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.Skv)
        val = *reinterpret_cast<const uint4*>(kg + (k0 + r) * kv_pitch + c);
      *reinterpret_cast<uint4*>(Ks + r * QP + c) = val;
    }
    // Vᵀ: each thread takes two adjacent keys of one 8-wide column chunk
    // and writes 8 words of (key, key + 1) pairs.
    for (int i = tid; i < (BK / 2) * V8; i += THREADS) {
      const int r = (i / V8) * 2, c = (i % V8) * 8;
      uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
      if (k0 + r < p.Skv)
        v0 = *reinterpret_cast<const uint4*>(vg + (k0 + r) * kv_pitch + c);
      if (k0 + r + 1 < p.Skv)
        v1 = *reinterpret_cast<const uint4*>(vg + (k0 + r + 1) * kv_pitch +
                                             c);
      const __nv_bfloat16* e0 = reinterpret_cast<const __nv_bfloat16*>(&v0);
      const __nv_bfloat16* e1 = reinterpret_cast<const __nv_bfloat16*>(&v1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        __nv_bfloat162 pair;
        pair.x = e0[e];
        pair.y = e1[e];
        *reinterpret_cast<__nv_bfloat162*>(Vt + (c + e) * VP + r) = pair;
      }
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (j * 8 + g) * QP + 2 * t;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        mma_bf16(s[j], qf[kt], ld32(krow + kt * 16), ld32(krow + kt * 16 + 8));
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        const float x = score_log2(p, s[j][e], qpos0 + (e >> 1) * 8, kpos);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x == NEG_INF ? 0.f : exp2f(x - m[e >> 1]);
        s[j][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // P·V: the score tiles 2kk, 2kk + 1 are the A operand of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vrow = Vt + (j * 8 + g) * VP + kk * 16 + 2 * t;
        mma_bf16(acc[j], a, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + row * q_pitch + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      __nv_bfloat162 out =
          __floats2bfloat162_rn(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct SimtSmem {
  static constexpr int DP = D + 1;   // odd pitch: conflict-free columns
  static constexpr int PP = BK + 1;
  static constexpr int BYTES = (BQ * DP + BK * DP + BK * D + BQ * PP) * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_simt_kernel(Params p) {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int DP = SimtSmem<D>::DP;
  constexpr int PP = SimtSmem<D>::PP;
  constexpr int DJ = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  // Thread (ty, tx): rows ty + 16i (i < 4), keys tx + 8j (j < 8) and
  // output columns tx + 8j (j < D/8).  The 8 threads of a row are 8
  // adjacent lanes, so row reductions are three xor shuffles.
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.n_rep;
  const long long q_pitch = (long long)p.H * D;
  const long long kv_pitch = (long long)(p.H / p.n_rep) * D;
  const float* qg = static_cast<const float*>(p.q) +
                    (long long)b * p.Sq * q_pitch + (long long)h * D;
  const float* kg = static_cast<const float*>(p.k) +
                    (long long)b * p.Skv * kv_pitch + (long long)hk * D;
  const float* vg = static_cast<const float*>(p.v) +
                    (long long)b * p.Skv * kv_pitch + (long long)hk * D;
  float* og = static_cast<float*>(p.o) + (long long)b * p.Sq * q_pitch +
              (long long)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] = q0 + r < p.Sq ? qg[(q0 + r) * q_pitch + c] : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int kb0, kb1;
  kv_block_range(p, q0, kb0, kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Skv;
      Ks[r * DP + c] = in ? kg[(k0 + r) * kv_pitch + c] : 0.f;
      Vs[r * D + c] = in ? vg[(k0 + r) * kv_pitch + c] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + p.q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = score_log2(p, s[i][j], qpos, k0 + tx + 8 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pe = s[i][j] == NEG_INF ? 0.f : exp2f(s[i][j] - m_new);
        rs += pe;
        Ps[(ty + 16 * i) * PP + tx + 8 * j] = pe;
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[row * q_pitch + tx + 8 * j] = acc[i][j] / den;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, int bytes, dim3 grid, const Params& p,
                   cudaStream_t s) {
  // Above 48 KB a kernel's dynamic shared memory must be allowed first;
  // the call is cheap and idempotent, so every launch makes it.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int bf16, dim3 grid, const Params& p, cudaStream_t s) {
  if (bf16) return launch(flash_mma_kernel<D>, MmaSmem<D>::BYTES, grid, p, s);
  return launch(flash_simt_kernel<D>, SimtSmem<D>::BYTES, grid, p, s);
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Skv, Hkv, D), o: (B, Sq, H, D); all f32
// (bf16 == 0) or all bf16, contiguous, 16-byte aligned, on the card.
// H % Hkv == 0; D ∈ {16, 32, 64, 80, 128}.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a head_dim it has no
// kernel for.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16, int B,
                                      int Sq, int Skv, int H, int Hkv, int D,
                                      int causal, int window, int q_offset,
                                      float scale, float softcap,
                                      void* stream) {
  Params p{q, k, v, o, Sq, Skv, H, H / Hkv, causal, window, q_offset, scale,
           softcap};
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch_d<16>(bf16, grid, p, s); break;
    case 32: err = launch_d<32>(bf16, grid, p, s); break;
    case 64: err = launch_d<64>(bf16, grid, p, s); break;
    case 80: err = launch_d<80>(bf16, grid, p, s); break;
    case 128: err = launch_d<128>(bf16, grid, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
