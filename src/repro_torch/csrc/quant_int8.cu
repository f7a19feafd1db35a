// int8 link boundary for Hopper (sm_90a): per-row absmax quantize ->
// dequantize in one pass, with an optional residual epilogue; and the wire
// format's two halves on their own, quantize (int8 codes + f32 row scales)
// and dequantize.
//
// Replaces the Pallas TPU kernels of the JAX package,
// src/repro/kernels/quant/int8.py:40 (_quant_dequant_kernel) and
// src/repro/kernels/quant/int8.py:48 (_quant_dequant_residual_kernel),
// called through quant_dequant_int8 (int8.py:104). Per row of the (M, D)
// tensor, in f32:
//
//   scale = max(absmax(row) * f32(1/127), 1e-8)
//   out   = clip(rint(x / scale), -127, 127) * scale  [+ residual]
//
// cast to the output type (f32, or bf16 rounded to nearest even). The
// reference's source says absmax / 127, but XLA compiles that division by a
// constant into a multiply by f32(1/127), and the residual epilogue into
// one fused multiply-add; the kernel computes what the reference computes.
//
// Bound: the kernel is memory-bound. It does a handful of operations per
// element and must read x (and the residual) once and write out once:
// (2 or 3) * M * D * bytes over 3.35 TB/s on an H100 SXM. On the split-
// learning main path (MobileNetV2 cut, M = 12544 rows of D = 32 f32) that
// is 3.2 MB, about 0.96 us, so a launch costs more than the traffic.
// Design against that bound: one warp per row, 8 rows per 256-thread block,
// lanes striding over D so that a warp reads 32 neighbouring elements (one
// 128-byte line for f32) per step; the row's absmax is a warp shuffle
// reduction, so no shared memory and no second kernel; the codes and the
// scale never leave registers. The second pass over the row re-reads it
// from L1/L2, not from device memory. D is masked per lane and need not be
// a multiple of 32 (tinycnn cuts have D = 8 or 16).
//
// Bit-exactness with the plain PyTorch version (and the JAX reference):
// IEEE division x / scale (no fast math), rintf (round half to even, as
// jnp.round / torch.round), q * scale rounded on its own (__fmul_rn) or,
// with the residual, one explicit __fmaf_rn, and NaN propagated through
// the max, the scale floor and the clip as jnp.max / jnp.maximum /
// jnp.clip propagate it.
//
// The wire format's halves replace src/repro/kernels/quant/int8.py:27
// (_quant_kernel, called through quantize_int8 at :69) and :36
// (_dequant_kernel, through dequantize_int8 at :87):
//
//   quantize:   scale = max(absmax(row) * f32(1/127), 1e-8)     (M, 1) f32
//               codes = clip(rint(x / scale), -127, 127)        (M, D) int8
//   dequantize: out   = codes * scale, cast to the output type
//
// with the fused kernel's row absmax and scale arithmetic, and a NaN code
// (a row holding NaN) written as 0, as XLA converts NaN to an integer.
// Both are memory-bound like the fused kernel: quantize reads x and writes
// M * D codes and M scales, dequantize the other way round; at the split
// LM's cut, (8192, 576) f32, that is 23.6 MB, 7.05 us at 3.35 TB/s. Same
// layout: one warp per row, lanes striding over D.
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// max that returns NaN when either side is NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <typename TIn, typename TOut, bool kResidual>
__global__ void __launch_bounds__(kThreads)
quant_dequant_int8_kernel(const TIn* __restrict__ x,
                          const TIn* __restrict__ residual,
                          TOut* __restrict__ out, int64_t m, int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // ragged end: whole warps drop out together
  const TIn* xr = x + row * d;

  float amax = 0.0f;
  for (int64_t j = lane; j < d; j += 32) amax = nan_max(amax, fabsf(load_f32(xr + j)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float s = amax * (1.0f / 127.0f);
  const float scale = isnan(s) ? s : fmaxf(s, 1e-8f);

  TOut* orow = out + row * d;
  const TIn* rrow = kResidual ? residual + row * d : nullptr;
  for (int64_t j = lane; j < d; j += 32) {
    float q = rintf(load_f32(xr + j) / scale);
    q = isnan(q) ? q : fminf(fmaxf(q, -127.0f), 127.0f);
    const float y = kResidual ? __fmaf_rn(q, scale, load_f32(rrow + j))
                              : __fmul_rn(q, scale);
    store(orow + j, y);
  }
}

template <typename TIn, typename TOut>
void launch(const void* x, const void* residual, void* out, int64_t m,
            int64_t d, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (residual != nullptr) {
    quant_dequant_int8_kernel<TIn, TOut, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const TIn*>(x), static_cast<const TIn*>(residual),
        static_cast<TOut*>(out), m, d);
  } else {
    quant_dequant_int8_kernel<TIn, TOut, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const TIn*>(x), nullptr, static_cast<TOut*>(out), m, d);
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const TIn* __restrict__ x, int8_t* __restrict__ codes,
                     float* __restrict__ scales, int64_t m, int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;
  const TIn* xr = x + row * d;

  float amax = 0.0f;
  for (int64_t j = lane; j < d; j += 32) amax = nan_max(amax, fabsf(load_f32(xr + j)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float s = amax * (1.0f / 127.0f);
  const float scale = isnan(s) ? s : fmaxf(s, 1e-8f);
  if (lane == 0) scales[row] = scale;

  int8_t* crow = codes + row * d;
  for (int64_t j = lane; j < d; j += 32) {
    const float q = rintf(load_f32(xr + j) / scale);
    crow[j] = isnan(q) ? int8_t{0}
                       : static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       TOut* __restrict__ out, int64_t m, int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;
  const float scale = scales[row];
  const int8_t* crow = codes + row * d;
  TOut* orow = out + row * d;
  for (int64_t j = lane; j < d; j += 32)
    store(orow + j, __fmul_rn(static_cast<float>(crow[j]), scale));
}

unsigned row_blocks(int64_t m) {
  return static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// x (M, D) in dtype code in_dtype -> codes (M, D) int8, scales (M, 1) f32.
extern "C" int quantize_int8_launch(const void* x, void* codes, void* scales,
                                    int64_t m, int64_t d, int in_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* c = static_cast<int8_t*>(codes);
  auto* s = static_cast<float*>(scales);
  if (in_dtype == 0) {
    quantize_int8_kernel<float><<<row_blocks(m), kThreads, 0, st>>>(
        static_cast<const float*>(x), c, s, m, d);
  } else if (in_dtype == 1) {
    quantize_int8_kernel<__nv_bfloat16><<<row_blocks(m), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), c, s, m, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// codes (M, D) int8, scales (M, 1) f32 -> out (M, D) in dtype code out_dtype.
extern "C" int dequantize_int8_launch(const void* codes, const void* scales,
                                      void* out, int64_t m, int64_t d,
                                      int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* s = static_cast<const float*>(scales);
  if (out_dtype == 0) {
    dequantize_int8_kernel<float><<<row_blocks(m), kThreads, 0, st>>>(
        c, s, static_cast<float*>(out), m, d);
  } else if (out_dtype == 1) {
    dequantize_int8_kernel<__nv_bfloat16><<<row_blocks(m), kThreads, 0, st>>>(
        c, s, static_cast<__nv_bfloat16*>(out), m, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 = float32, 1 = bfloat16. residual may be null; when given
// it has x's dtype and shape. Returns a cudaError_t (0 = success); an
// unknown dtype code returns cudaErrorInvalidValue without launching.
extern "C" int quant_dequant_int8_launch(const void* x, const void* residual,
                                         void* out, int64_t m, int64_t d,
                                         int in_dtype, int out_dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == 0 && out_dtype == 0) {
    launch<float, float>(x, residual, out, m, d, st);
  } else if (in_dtype == 0 && out_dtype == 1) {
    launch<float, __nv_bfloat16>(x, residual, out, m, d, st);
  } else if (in_dtype == 1 && out_dtype == 0) {
    launch<__nv_bfloat16, float>(x, residual, out, m, d, st);
  } else if (in_dtype == 1 && out_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, residual, out, m, d, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
