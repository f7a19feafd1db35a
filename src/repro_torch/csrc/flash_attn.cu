// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with causal and sliding-window masks, f32 or bf16 in, f32 arithmetic.
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/attn/flash.py:35 (_flash_kernel), called through
// _flash_forward (flash.py:97) and flash_attention (flash.py:183). For q
// (B, H, S, D) and k, v (B, H, Sk, D), per query row i:
//
//   s_j = (q_i * f32(1/sqrt(D))) . k_j        masked to -1e30 unless
//         (causal: i >= j) and (window: i - j < window) and j < Sk
//   out_i = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with m, l and acc carried in f32 over key tiles, tiles that no query of
// the block can see skipped, and the finite NEG_INF of the reference: a row
// whose first live tile is all masked accumulates exp(0) = 1 terms that the
// next real key wipes out through alpha = exp(-1e30 - m) = 0, exactly as
// the reference does (with -inf that row would become NaN). Positions are
// absolute, also when Sk != S.
//
// Bound: at the split LM's shape (B 8, H 9, S = Sk = 1024, D 64, f32,
// causal) the two products take 2*B*H*D*S*(S+1) = 9.67 GFLOP (the causal
// half of each), 0.144 ms at the H100's 67 TFLOP/s FP32 rate; q, k, v and
// out are 75.5 MB, 22.5 us at 3.35 TB/s. So it is bound by operations.
// This first version is simple and uses the FP32 FMA units, no tensor cores
// (no wgmma, no TMA):
//
// - one 256-thread block per (b*h, tile of 64 query rows); a loop over
//   64-key tiles inside the block takes the place of the TPU's sequential
//   nk grid axis;
// - the q tile (pre-scaled), the k and v tiles and the 64x64 probability
//   tile live in shared memory as f32, rows padded to D+1 / 65 floats so
//   that lanes reading different rows of one column hit different banks
//   (at D = 128 that is 113 KB: dynamic shared memory, opted in at launch);
// - thread (tr, tc) = (tid / 16, tid % 16) owns rows tr + 16a and key
//   columns tc + 16b (a, b < 4) of the score tile, and rows tr + 16a and
//   output columns tc + 16c of the accumulator, so a row's max and sum are
//   a 16-lane shuffle reduction and alpha never leaves registers;
// - ragged S and Sk are masked in the kernel: out-of-range q rows load as 0
//   and are not stored, out-of-range k and v rows load as 0 and are masked
//   by position (as the reference pads them with zeros and masks kv_len).
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError() (or
// cudaErrorInvalidValue for a head dim it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kLP = kBK + 1;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * kLP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int64_t S,
                 int64_t Sk, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int64_t bh = blockIdx.x;
  const int64_t q_lo = (int64_t)blockIdx.y * kBQ;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  T* ob = out + bh * S * D;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int64_t row = q_lo + r;
    sQ[r * LD + c] = row < S ? to_f32(qb[row * D + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  const int64_t q_hi = q_lo + kBQ - 1;  // last query row of the block
  const int64_t nk = (Sk + kBK - 1) / kBK;
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int64_t k_lo = kt * kBK;
    // tile-level skip, uniform over the block: no query here sees a key
    if (causal && k_lo > q_hi) break;
    if (window >= 0 && k_lo + kBK - 1 <= q_lo - window) continue;

    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int64_t row = k_lo + r;
      const bool in = row < Sk;
      sK[r * LD + c] = in ? to_f32(kb[row * D + c]) : 0.f;
      sV[r * LD + c] = in ? to_f32(vb[row * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sQ[(tr + 16 * a) * LD + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = sK[(tc + 16 * b) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kv[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t qpos = q_lo + tr + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t kpos = k_lo + tc + 16 * b;
        bool ok = kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && (qpos - kpos) < window;
        s[a][b] = ok ? s[a][b] : kNegInf;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        sP[(tr + 16 * a) * kLP + tc + 16 * b] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();  // the whole probability tile is written

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = sP[(tr + 16 * a) * kLP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[j * LD + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = q_lo + tr + 16 * a;
    if (row >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(&ob[row * D + tc + 16 * c], acc[a][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t BH, int64_t S, int64_t Sk, float scale, int causal,
                   int window, cudaStream_t stream) {
  // opt in to > 48 KB of shared memory; the attribute belongs to the current
  // device, so it is set at every launch (one runtime call beside a kernel
  // of ~0.5 ms) rather than once per process
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)BH, (unsigned)((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Sk, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int64_t BH, int64_t S, int64_t Sk, int64_t D,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  switch (D) {
#define FLASH_CASE(d) \
  case d:             \
    return launch<T, d>(q, k, v, out, BH, S, Sk, scale, causal, window, stream);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// window < 0: no sliding window. Returns a cudaError_t as int.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* out, int64_t B,
                                     int64_t H, int64_t S, int64_t Sk,
                                     int64_t D, int dtype, float scale,
                                     int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H <= 0 || B * H > 0x7fffffffLL || S <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, out, B * H, S, Sk, D, scale,
                                  causal, window, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, B * H, S, Sk, D,
                                          scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
