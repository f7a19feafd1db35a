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
// is 3.2 MB, about 0.96 us, so a launch and one DRAM round trip cost more
// than the traffic; on the split LM's cut, (8192, 576) f32, 37.7 MB, 11.3 us.
//
// Two paths; the C launch function picks one on the host (make_plan):
//
// The vector path, for rows of whole 16-byte chunks: D * sizeof(in) a
// multiple of 16, every pointer aligned to its access width (x and the
// residual 16 bytes, out the bytes a lane stores of one chunk, the codes 4
// or 8), and at most 32 * kVecMaxChunks chunks a row. A row of C chunks
// (4 f32 or 8 bf16 each) is served by G lanes, G the smallest power of two
// >= C, capped at 32, so a warp serves 32 / G neighbouring rows and reads
// 512 contiguous bytes per load instruction; each lane holds V = ceil(C /
// G) chunks (a template value, up to 8: 32 registers of raw bits). All V
// loads (and the residual's) are issued before the row's absmax, which is
// log2(G) xor shuffles inside the lane group; the quantize and store pass
// works from the registers, so the row is read from memory once. Each lane
// stores whole chunks: 16 bytes of f32 (two 16-byte stores for bf16 in,
// f32 out), 8 or 16 bytes of bf16, the codes packed into one 32-bit (f32
// in) or 64-bit (bf16 in) word, byte k holding element k of the chunk. Rows
// past M and chunks past C load nothing, add 0 to the max and store
// nothing, but every lane takes part in every shuffle (no early return).
// At (12544, 32) f32: G = 8, V = 1, 4 rows a warp, 392 blocks of 256
// threads, one wave on 132 SMs; at (8192, 576) f32: G = 32, V = 5, the
// fifth chunk on half the lanes.
//
// The generic path, for everything else (D * sizeof(in) not a multiple of
// 16, a misaligned pointer such as a contiguous view at an odd storage
// offset, more than 32 * kVecMaxChunks chunks): one warp per row, 8 rows a
// block, lanes striding over D one element at a time, the second pass
// re-reading the row from L1/L2.
//
// quant_int8_launch_plan returns the path, G, V, the blocks and the
// resident blocks an SM for a shape; kernels/quant/int8.py mirrors the rule.
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
// LM's cut, (8192, 576) f32, that is 23.6 MB, 7.05 us at 3.35 TB/s.
// quantize takes the fused kernel's two paths under the same rule, the
// first lane of a row's group writing its scale; dequantize keeps one warp
// per row, lanes striding over D.
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

// ---- the vector path -------------------------------------------------

constexpr int kChunkBytes = 16;
constexpr int kVecMaxChunks = 8;   // chunks a lane holds at most (V)

// elements in one 16-byte chunk of T
template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return kChunkBytes / static_cast<int>(sizeof(T));
}

// a chunk's elements as f32, in memory order (a bf16 is the high half of
// its f32, so the conversion is exact)
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[4]) {
  f[0] = __uint_as_float(c.x);
  f[1] = __uint_as_float(c.y);
  f[2] = __uint_as_float(c.z);
  f[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float (&f)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);             // the lower address
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// one chunk's N results to p, aligned to the bytes stored
template <int N>
__device__ __forceinline__ void store_chunk(float* p, const float (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<uint4*>(p + i) =
        make_uint4(__float_as_uint(y[i]), __float_as_uint(y[i + 1]),
                   __float_as_uint(y[i + 2]), __float_as_uint(y[i + 3]));
}
template <int N>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float (&y)[N]) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    w[i] = bf16_bits(y[2 * i]) | (bf16_bits(y[2 * i + 1]) << 16);
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A lane's place in the vector path: its row (lanes G * k .. G * k + G - 1
// of a warp serve the warp's row k) and its first chunk in that row.
template <int G>
struct Lane {
  int64_t row;
  int sub;    // the lane's index in its row's group; chunks sub + v * G
  bool live;  // row < m
  __device__ __forceinline__ Lane(int64_t m) {
    const int lane = threadIdx.x & 31;
    row = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
           (threadIdx.x >> 5)) * (32 / G) + lane / G;
    sub = lane % G;
    live = row < m;
  }
};

// this lane's V chunks of a row, zeros for chunks (or a row) past the end
template <int G, int V>
__device__ __forceinline__ void load_chunks(const uint4* row, bool live,
                                            int sub, int64_t chunks,
                                            uint4 (&c)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t j = sub + static_cast<int64_t>(v) * G;
    c[v] = make_uint4(0u, 0u, 0u, 0u);
    if (live && j < chunks) c[v] = __ldg(row + j);
  }
}

// The row's scale from its lanes' chunks: the absmax over the lane's
// elements, then over the G lanes of the group by xor shuffles (offsets <
// G stay inside the group). Every lane of the warp calls it.
template <typename TIn, int G, int V>
__device__ __forceinline__ float row_scale(const uint4 (&c)[V]) {
  float amax = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float f[chunk_elems<TIn>()];
    unpack(c[v], f);
#pragma unroll
    for (int e = 0; e < chunk_elems<TIn>(); ++e)
      amax = nan_max(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax * (1.0f / 127.0f);
  return isnan(s) ? s : fmaxf(s, 1e-8f);
}

// x, residual, out: (m, chunks * chunk_elems<TIn>()) rows of whole chunks
template <typename TIn, typename TOut, bool kResidual, int G, int V>
__global__ void __launch_bounds__(kThreads)
quant_dequant_int8_vec(const TIn* __restrict__ x,
                       const TIn* __restrict__ residual,
                       TOut* __restrict__ out, int64_t m, int64_t chunks) {
  constexpr int N = chunk_elems<TIn>();
  const Lane<G> l(m);
  const int64_t base = (l.live ? l.row : 0) * chunks;   // in chunks
  uint4 xv[V], rv[kResidual ? V : 1];
  if constexpr (kResidual)
    load_chunks<G, V>(reinterpret_cast<const uint4*>(residual) + base,
                      l.live, l.sub, chunks, rv);
  load_chunks<G, V>(reinterpret_cast<const uint4*>(x) + base, l.live, l.sub,
                    chunks, xv);
  const float scale = row_scale<TIn, G, V>(xv);

  TOut* orow = out + base * N;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t j = l.sub + static_cast<int64_t>(v) * G;
    if (!(l.live && j < chunks)) continue;
    float f[N], r[N], y[N];
    unpack(xv[v], f);
    if constexpr (kResidual) unpack(rv[v], r);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float q = rintf(f[e] / scale);
      q = isnan(q) ? q : fminf(fmaxf(q, -127.0f), 127.0f);
      if constexpr (kResidual) {
        y[e] = __fmaf_rn(q, scale, r[e]);
      } else {
        y[e] = __fmul_rn(q, scale);
      }
    }
    store_chunk(orow + j * N, y);
  }
}

// x: (m, chunks * chunk_elems<TIn>()); codes the same shape; scales (m,)
template <typename TIn, int G, int V>
__global__ void __launch_bounds__(kThreads)
quantize_int8_vec(const TIn* __restrict__ x, int8_t* __restrict__ codes,
                  float* __restrict__ scales, int64_t m, int64_t chunks) {
  constexpr int N = chunk_elems<TIn>();
  const Lane<G> l(m);
  const int64_t base = (l.live ? l.row : 0) * chunks;
  uint4 xv[V];
  load_chunks<G, V>(reinterpret_cast<const uint4*>(x) + base, l.live, l.sub,
                    chunks, xv);
  const float scale = row_scale<TIn, G, V>(xv);
  if (l.live && l.sub == 0) scales[l.row] = scale;

  int8_t* crow = codes + base * N;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t j = l.sub + static_cast<int64_t>(v) * G;
    if (!(l.live && j < chunks)) continue;
    float f[N];
    unpack(xv[v], f);
    uint32_t w[N / 4] = {};
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float q = rintf(f[e] / scale);
      const int8_t code =
          isnan(q) ? int8_t{0}
                   : static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
      w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(code))
                  << (8 * (e % 4));                   // little-endian
    }
    if constexpr (N == 4) {
      *reinterpret_cast<uint32_t*>(crow + j * N) = w[0];
    } else {
      *reinterpret_cast<uint2*>(crow + j * N) = make_uint2(w[0], w[1]);
    }
  }
}

// ---- the launch plan ---------------------------------------------------

// the (G, V) pairs the plan can choose; each is one instantiation
#define QUANT_INT8_SHAPES(X)                                                \
  X(1, 1) X(2, 1) X(4, 1) X(8, 1) X(16, 1) X(32, 1) X(32, 2) X(32, 3)       \
  X(32, 4) X(32, 5) X(32, 6) X(32, 7) X(32, 8)

struct Plan {
  bool vector;
  int g, v;               // lanes a row, chunks a lane (generic: 32, 0)
  int64_t rows_per_block;
  int64_t blocks;
  int64_t chunks;         // 16-byte chunks a row (vector path)
};

// in_size: bytes of an input element; aligned: every pointer at a multiple
// of its access width
Plan make_plan(int64_t m, int64_t d, int in_size, bool aligned) {
  Plan p{};
  const int64_t row_bytes = d * in_size;
  p.chunks = row_bytes / kChunkBytes;
  p.vector = aligned && row_bytes % kChunkBytes == 0 &&
             p.chunks <= 32 * kVecMaxChunks;
  if (p.vector) {
    p.g = 1;
    while (p.g < p.chunks && p.g < 32) p.g <<= 1;
    p.v = static_cast<int>((p.chunks + p.g - 1) / p.g);
    p.rows_per_block = kWarpsPerBlock * (32 / p.g);
  } else {
    p.g = 32;
    p.v = 0;
    p.rows_per_block = kWarpsPerBlock;
  }
  p.blocks = (m + p.rows_per_block - 1) / p.rows_per_block;
  return p;
}

template <typename TIn, typename TOut, bool kResidual>
const void* fused_kernel(const Plan& p) {
  if (!p.vector)
    return (const void*)&quant_dequant_int8_kernel<TIn, TOut, kResidual>;
  switch (p.g * 16 + p.v) {
#define QUANT_INT8_FUSED(G, V) \
  case G * 16 + V:             \
    return (const void*)&quant_dequant_int8_vec<TIn, TOut, kResidual, G, V>;
    QUANT_INT8_SHAPES(QUANT_INT8_FUSED)
#undef QUANT_INT8_FUSED
    default: return nullptr;
  }
}

template <typename TIn>
const void* quantize_kernel(const Plan& p) {
  if (!p.vector) return (const void*)&quantize_int8_kernel<TIn>;
  switch (p.g * 16 + p.v) {
#define QUANT_INT8_QUANT(G, V) \
  case G * 16 + V: return (const void*)&quantize_int8_vec<TIn, G, V>;
    QUANT_INT8_SHAPES(QUANT_INT8_QUANT)
#undef QUANT_INT8_QUANT
    default: return nullptr;
  }
}

// dtype code -> bytes of an element (0 for an unknown code)
int dtype_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

// kernel codes: 0 quant_dequant_int8, 1 the same with a residual, 2
// quantize_int8 (out_dtype unused)
const void* kernel_of(const Plan& p, int kernel, int in_dtype,
                      int out_dtype) {
  const bool f32 = in_dtype == 0;
  if (kernel == 2) {
    if (dtype_size(in_dtype) == 0) return nullptr;
    return f32 ? quantize_kernel<float>(p) : quantize_kernel<__nv_bfloat16>(p);
  }
  if (dtype_size(in_dtype) == 0 || dtype_size(out_dtype) == 0 ||
      (kernel != 0 && kernel != 1))
    return nullptr;
  const bool res = kernel == 1, f32_out = out_dtype == 0;
  using bf16 = __nv_bfloat16;
  if (f32 && f32_out)
    return res ? fused_kernel<float, float, true>(p)
               : fused_kernel<float, float, false>(p);
  if (f32)
    return res ? fused_kernel<float, bf16, true>(p)
               : fused_kernel<float, bf16, false>(p);
  if (f32_out)
    return res ? fused_kernel<bf16, float, true>(p)
               : fused_kernel<bf16, float, false>(p);
  return res ? fused_kernel<bf16, bf16, true>(p)
             : fused_kernel<bf16, bf16, false>(p);
}

bool aligned_to(const void* ptr, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// the bytes a vector-path lane stores at once for one chunk of out
int64_t out_store_width(int in_size, int out_size) {
  const int64_t w = (kChunkBytes / in_size) * out_size;
  return w < kChunkBytes ? w : kChunkBytes;
}

// args: the kernel's parameters, the last one the plan's chunks (vector)
// or D (generic)
int launch_planned(const void* fn, const Plan& p, void** args, void* stream) {
  const cudaError_t err =
      cudaLaunchKernel(fn, dim3(static_cast<unsigned>(p.blocks)),
                       dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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
  const int in_size = dtype_size(in_dtype);
  if (m <= 0 || d <= 0 || in_size == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = aligned_to(x, kChunkBytes) &&
                       aligned_to(codes, kChunkBytes / in_size) &&
                       aligned_to(scales, sizeof(float));
  const Plan p = make_plan(m, d, in_size, aligned);
  const void* fn = kernel_of(p, 2, in_dtype, 0);
  if (fn == nullptr || p.blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t n = p.vector ? p.chunks : d;
  void* args[] = {&x, &codes, &scales, &m, &n};
  return launch_planned(fn, p, args, stream);
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
// unknown dtype code returns cudaErrorInvalidValue without launching. The
// path follows make_plan, with the alignment read off the pointers.
extern "C" int quant_dequant_int8_launch(const void* x, const void* residual,
                                         void* out, int64_t m, int64_t d,
                                         int in_dtype, int out_dtype,
                                         void* stream) {
  const int in_size = dtype_size(in_dtype), out_size = dtype_size(out_dtype);
  if (m <= 0 || d <= 0 || in_size == 0 || out_size == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      aligned_to(x, kChunkBytes) &&
      (residual == nullptr || aligned_to(residual, kChunkBytes)) &&
      aligned_to(out, out_store_width(in_size, out_size));
  const Plan p = make_plan(m, d, in_size, aligned);
  const void* fn = kernel_of(p, residual != nullptr ? 1 : 0, in_dtype,
                             out_dtype);
  if (fn == nullptr || p.blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t n = p.vector ? p.chunks : d;
  void* args[] = {&x, &residual, &out, &m, &n};
  return launch_planned(fn, p, args, stream);
}

// The launch quant_dequant_int8_launch (kernel 0, or 1 with a residual) or
// quantize_int8_launch (kernel 2) makes for an (m, d) input of in_dtype
// into out_dtype, with every pointer aligned to its access width (aligned
// != 0) or not, on the current device. plan[0..6]: vector path (1) or
// generic (0), lanes a row G, chunks a lane V (0 on the generic path), rows
// a block, blocks, threads a block, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int quant_int8_launch_plan(int64_t m, int64_t d, int in_dtype,
                                      int out_dtype, int aligned, int kernel,
                                      int64_t* plan) {
  const int in_size = dtype_size(in_dtype);
  if (m <= 0 || d <= 0 || in_size == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(m, d, in_size, aligned != 0);
  const void* fn = kernel_of(p, kernel, in_dtype, out_dtype);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t out[7] = {p.vector ? 1 : 0, p.g, p.v, p.rows_per_block,
                          p.blocks, kThreads, resident};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return 0;
}
