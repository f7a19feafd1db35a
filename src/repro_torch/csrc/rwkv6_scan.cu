// RWKV-6 ("Finch") WKV recurrence for Hopper (sm_90a), from a zero state.
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/rwkv/scan.py:51 (rwkv6_scan, body _rwkv_kernel at
// :28). Per (batch b, head h), with an hd x hd f32 state S and S_0 = 0:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// i.e. y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]) and
// S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]. r, k, v, w are (B, H, T, hd)
// f32, u is (H, hd) f32, y is (B, H, T, hd) f32; the final state S_T,
// (B, H, hd, hd), is written only when the caller passes a pointer for it.
// hd is a multiple of 16 from 16 to 256.
//
// Checkpoints for the backward (csrc/rwkv6_scan_bwd.cu): when the caller
// passes a buffer, the kernel writes the state S^(cC) reached after cC
// steps, for c = 0 .. ceil(T / C) - 1, into ckpt (B, H, ceil(T / C), hd,
// hd) f32, row-major per state. C is the compile-time constant
// RWKV6_CHECKPOINT_EVERY = 16 (rwkv6_scan.h), shared with the backward.
// Without a buffer the kernel is compiled without the write.
//
// Bound: per (b, h, t) the kernel must read 4 hd-vectors and write one
// (5 * hd * 4 bytes) and does about 6 hd^2 FLOP (two FMAs, one multiply
// and one add per state element). At the rwkv6-7b training shape
// (4, 64, 1024, 64) that is 335.5 MB (0.100 ms at 3.35 TB/s) and 6.4 GFLOP
// (0.096 ms at 67 TFLOP/s FP32): the two bounds meet. What holds it above
// both is the recurrence itself: T dependent steps per (b, h), each a
// barrier and an hd-long chain of FMAs, with only B * H = 256 blocks of
// 64 threads to spread over 132 SMs. The checkpoints add hd^2 * 4 bytes
// every C steps (268 MB at that shape with C = 16).
//
// Design, hd <= 64. The TPU kernel carries S in VMEM across a sequential
// grid axis; Hopper runs blocks in no order, so here one block of hd
// threads owns one (b, h) and loops over all of T itself (no time tiles:
// any T works, and the reference's block shrink is not carried over).
// Thread j keeps column j of S, hd f32 values, in registers for the whole
// sequence. At each step thread i stages (r_t[i], k_t[i], w_t[i], u[i]) in
// shared memory as one float4, so that the inner loop reads each row's four
// operands with one broadcast 16-byte load: shared-memory instructions, not
// FMAs, limited a first version that read four separate arrays (0.82 ms at
// the main shape). The stage is double buffered so that one
// __syncthreads() per step suffices: a buffer is rewritten two steps later,
// after a barrier that every reader of it has passed. Thread j keeps
// v_t[j] in a register, and loads step t+1's values into registers while
// it computes step t, so the global loads overlap the FMA chain. The y sum
// runs in four partial accumulators to shorten its dependency chain.
//
// Design, hd > 64. A column of 256 floats does not fit one thread's
// registers, and hd threads of more than 64 registers each do not fit an
// SM's register file either. The columns of S evolve independently, so a
// second grid axis cuts them into chunks of SPLIT_COLS columns, and NS = 2
// (hd <= 128) or 4 threads share a column, each holding hd / NS of its rows
// (at most 64 registers). The NS threads of a column are neighbouring lanes
// of one warp and add their parts of y_t[j] with warp shuffles. Every block
// stages the (r, k, w, u) rows of all hd rows, as above, without the
// register prefetch.
//
// Neither path divides by w (it may underflow to 0).
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_scan.h"

namespace {

constexpr int SPLIT_COLS = 16;  // columns of S per block when hd > 64
constexpr int CKPT_EVERY = RWKV6_CHECKPOINT_EVERY;

template <int HD, bool CKPT>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ s_out, float* __restrict__ ckpt,
                  int64_t t_len, int n_heads) {
  __shared__ float4 stage[2][HD];  // (r_t[i], k_t[i], w_t[i], u[i])

  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t base = bh * t_len * HD + j;
  const float uj = u[h * HD + j];
  const int64_t n_ckpt = CKPT ? rwkv6_n_checkpoints(t_len) : 0;

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = 0.0f;

  float rn = r[base], kn = k[base], vn = v[base], wn = w[base];
  for (int64_t t = 0; t < t_len; ++t) {
    if (CKPT && t % CKPT_EVERY == 0) {
      float* cp = ckpt + (bh * n_ckpt + t / CKPT_EVERY) * HD * HD + j;
#pragma unroll
      for (int i = 0; i < HD; ++i) cp[i * HD] = S[i];
    }
    const float4* row = stage[t & 1];
    stage[t & 1][j] = make_float4(rn, kn, wn, uj);
    const float vj = vn;
    __syncthreads();
    if (t + 1 < t_len) {  // prefetch step t+1 while step t computes
      const int64_t o = base + (t + 1) * HD;
      rn = r[o];
      kn = k[o];
      vn = v[o];
      wn = w[o];
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float4 p = row[i];
      const float kv = p.y * vj;
      acc[i & 3] = fmaf(p.x, fmaf(p.w, kv, S[i]), acc[i & 3]);
      S[i] = fmaf(p.z, S[i], kv);
    }
    y[base + t * HD] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  if (s_out != nullptr) {
    float* so = s_out + bh * HD * HD + j;
#pragma unroll
    for (int i = 0; i < HD; ++i) so[i * HD] = S[i];
  }
}

// hd > 64: block (bh, column chunk) of SPLIT_COLS * NS threads; thread
// (column c, slice q) = threadIdx.x (c * NS + q) holds rows q * RS ..
// q * RS + RS - 1 of column blockIdx.y * SPLIT_COLS + c.
template <int HD, int NS, bool CKPT>
__global__ void __launch_bounds__(SPLIT_COLS * NS)
rwkv6_scan_split_kernel(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ u, float* __restrict__ y,
                        float* __restrict__ s_out, float* __restrict__ ckpt,
                        int64_t t_len, int n_heads) {
  constexpr int NT = SPLIT_COLS * NS;
  constexpr int RS = HD / NS;  // rows of S per thread
  __shared__ float4 stage[2][HD];

  const int tid = threadIdx.x;
  const int q = tid % NS;
  const int j = blockIdx.y * SPLIT_COLS + tid / NS;
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t base = bh * t_len * HD;
  const int64_t n_ckpt = CKPT ? rwkv6_n_checkpoints(t_len) : 0;
  const int64_t row0 = static_cast<int64_t>(q) * RS;

  float S[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) S[i] = 0.0f;

  for (int64_t t = 0; t < t_len; ++t) {
    const int64_t o = base + t * HD;
    if (CKPT && t % CKPT_EVERY == 0) {
      float* cp = ckpt + (bh * n_ckpt + t / CKPT_EVERY) * HD * HD
                  + row0 * HD + j;
#pragma unroll
      for (int i = 0; i < RS; ++i) cp[i * HD] = S[i];
    }
    float4* buf = stage[t & 1];
    for (int i = tid; i < HD; i += NT)
      buf[i] = make_float4(r[o + i], k[o + i], w[o + i], u[h * HD + i]);
    const float vj = v[o + j];
    __syncthreads();
    const float4* row = buf + row0;
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const float4 p = row[i];
      const float kv = p.y * vj;
      acc[i & 1] = fmaf(p.x, fmaf(p.w, kv, S[i]), acc[i & 1]);
      S[i] = fmaf(p.z, S[i], kv);
    }
    float yj = acc[0] + acc[1];
#pragma unroll
    for (int off = NS / 2; off > 0; off >>= 1)
      yj += __shfl_xor_sync(0xffffffffu, yj, off);
    if (q == 0) y[o + j] = yj;
  }
  if (s_out != nullptr) {
    float* so = s_out + bh * HD * HD + row0 * HD + j;
#pragma unroll
    for (int i = 0; i < RS; ++i) so[i * HD] = S[i];
  }
}

template <int HD>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, float* y, float* s_out, float* ckpt, int64_t bh,
            int64_t t_len, int n_heads, cudaStream_t stream) {
  if constexpr (HD <= 64) {
    const unsigned grid = static_cast<unsigned>(bh);
    if (ckpt != nullptr)
      rwkv6_scan_kernel<HD, true><<<grid, HD, 0, stream>>>(
          r, k, v, w, u, y, s_out, ckpt, t_len, n_heads);
    else
      rwkv6_scan_kernel<HD, false><<<grid, HD, 0, stream>>>(
          r, k, v, w, u, y, s_out, nullptr, t_len, n_heads);
  } else {
    constexpr int NS = HD <= 128 ? 2 : 4;
    const dim3 grid(static_cast<unsigned>(bh), HD / SPLIT_COLS);
    if (ckpt != nullptr)
      rwkv6_scan_split_kernel<HD, NS, true><<<grid, SPLIT_COLS * NS, 0,
                                              stream>>>(
          r, k, v, w, u, y, s_out, ckpt, t_len, n_heads);
    else
      rwkv6_scan_split_kernel<HD, NS, false><<<grid, SPLIT_COLS * NS, 0,
                                               stream>>>(
          r, k, v, w, u, y, s_out, nullptr, t_len, n_heads);
  }
}

}  // namespace

// r, k, v, w: (B, H, T, hd) f32 contiguous; u: (H, hd) f32; y: (B, H, T,
// hd) f32; s_out: (B, H, hd, hd) f32 or null; ckpt: (B, H, ceil(T /
// RWKV6_CHECKPOINT_EVERY), hd, hd) f32 or null. hd is a multiple of 16 from
// 16 to 256. Returns a cudaError_t (0 = success); a shape it does not take
// returns cudaErrorInvalidValue without launching.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 void* s_out, void* ckpt, int64_t batch,
                                 int64_t n_heads, int64_t t_len, int64_t hd,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * n_heads;
  if (bh <= 0 || t_len <= 0 || bh > 0x7fffffff || n_heads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(s_out);
  auto* cf = static_cast<float*>(ckpt);
  const int nh = static_cast<int>(n_heads);
  switch (hd) {
#define RWKV6_CASE(HD)                                                     \
  case HD:                                                                 \
    launch<HD>(rf, kf, vf, wf, uf, yf, sf, cf, bh, t_len, nh, st);         \
    break;
    RWKV6_CASE(16) RWKV6_CASE(32) RWKV6_CASE(48) RWKV6_CASE(64)
    RWKV6_CASE(80) RWKV6_CASE(96) RWKV6_CASE(112) RWKV6_CASE(128)
    RWKV6_CASE(144) RWKV6_CASE(160) RWKV6_CASE(176) RWKV6_CASE(192)
    RWKV6_CASE(208) RWKV6_CASE(224) RWKV6_CASE(240) RWKV6_CASE(256)
#undef RWKV6_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
