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
//
// Bound: per (b, h, t) the kernel must read 4 hd-vectors and write one
// (5 * hd * 4 bytes) and does about 6 hd^2 FLOP (two FMAs, one multiply
// and one add per state element). At the rwkv6-7b training shape
// (4, 64, 1024, 64) that is 335.5 MB (0.100 ms at 3.35 TB/s) and 6.4 GFLOP
// (0.096 ms at 67 TFLOP/s FP32): the two bounds meet. What holds it above
// both is the recurrence itself: T dependent steps per (b, h), each a
// barrier and an hd-long chain of FMAs, with only B * H = 256 blocks of
// 64 threads to spread over 132 SMs.
//
// Design. The TPU kernel carries S in VMEM across a sequential grid axis;
// Hopper runs blocks in no order, so here one block of hd threads owns one
// (b, h) and loops over all of T itself (no time tiles: any T works, and
// the reference's block shrink is not carried over). Thread j keeps column
// j of S, hd f32 values, in registers for the whole sequence. At each step
// thread i stages (r_t[i], k_t[i], w_t[i], u[i]) in shared memory as one
// float4, so that the inner loop reads each row's four operands with one
// broadcast 16-byte load: shared-memory instructions, not FMAs, limited a
// first version that read four separate arrays (0.82 ms at the main
// shape). The stage is double buffered so that one __syncthreads() per
// step suffices: a buffer is rewritten two steps later, after a barrier
// that every reader of it has passed. Thread j keeps v_t[j] in a register,
// and loads step t+1's values into registers while it computes step t, so
// the global loads overlap the FMA chain. The y sum runs in four partial
// accumulators to shorten its dependency chain. The kernel never divides
// by w (it may underflow to 0).
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ s_out, int64_t t_len, int n_heads) {
  __shared__ float4 stage[2][HD];  // (r_t[i], k_t[i], w_t[i], u[i])

  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t base = bh * t_len * HD + j;
  const float uj = u[h * HD + j];

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = 0.0f;

  float rn = r[base], kn = k[base], vn = v[base], wn = w[base];
  for (int64_t t = 0; t < t_len; ++t) {
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

template <int HD>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, float* y, float* s_out, int64_t bh, int64_t t_len,
            int n_heads, cudaStream_t stream) {
  rwkv6_scan_kernel<HD><<<static_cast<unsigned>(bh), HD, 0, stream>>>(
      r, k, v, w, u, y, s_out, t_len, n_heads);
}

}  // namespace

// r, k, v, w: (B, H, T, hd) f32 contiguous; u: (H, hd) f32; y: (B, H, T,
// hd) f32; s_out: (B, H, hd, hd) f32 or null. hd is 16, 32, 48 or 64.
// Returns a cudaError_t (0 = success); a shape it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* y,
                                 void* s_out, int64_t batch, int64_t n_heads,
                                 int64_t t_len, int64_t hd, void* stream) {
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
  const int nh = static_cast<int>(n_heads);
  switch (hd) {
    case 16: launch<16>(rf, kf, vf, wf, uf, yf, sf, bh, t_len, nh, st); break;
    case 32: launch<32>(rf, kf, vf, wf, uf, yf, sf, bh, t_len, nh, st); break;
    case 48: launch<48>(rf, kf, vf, wf, uf, yf, sf, bh, t_len, nh, st); break;
    case 64: launch<64>(rf, kf, vf, wf, uf, yf, sf, bh, t_len, nh, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
