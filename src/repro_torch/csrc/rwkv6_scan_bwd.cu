// Backward of the RWKV-6 WKV recurrence (csrc/rwkv6_scan.cu) for Hopper
// (sm_90a): the vector-Jacobian product of all five inputs.
//
// Replaces the reference's gradient, which is JAX's autodiff of the
// lax.scan oracle (src/repro/kernels/rwkv/ref.py:9-26, and the time mix's
// own scan in src/repro/models/ssm.py:97-106); its Pallas kernel has no
// backward. With y_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t =
// diag(w_t) S_{t-1} + k_t^T v_t, S_0 = 0, the cotangents gy (B, H, T, hd)
// and G_T = dL/dS_T (B, H, hd, hd) (or 0), going back in t:
//
//   dr_t[i] = sum_j gy_t[j] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//   dk_t[i] = sum_j (G_t[i][j] + u[i] r_t[i] gy_t[j]) v_t[j]
//   dv_t[j] = sum_i k_t[i] (G_t[i][j] + u[i] r_t[i] gy_t[j])
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] sum_j gy_t[j] v_t[j]
//   G_{t-1} = diag(w_t) G_t + r_t^T gy_t
//
// S_{t-1} is recomputed forward, never recovered by dividing by w, which
// underflows to exactly 0 in practice. The forward kernel writes the state
// every C steps (ckpt, (B, H, ceil(T / C), hd, hd); C is the compile-time
// RWKV6_CHECKPOINT_EVERY = 16 of rwkv6_scan.h); for each segment of C
// steps, last segment first, a block reloads its checkpoint, recomputes the
// segment's C states into its own slice of a scratch buffer, then sweeps
// the segment backwards.
//
// Layout. A block owns one (b, h) and a chunk of CW columns of S and G
// (CW = 64, 32 or 16: the largest that divides hd); thread i owns row i
// (the block has hd threads, rounded up to whole warps), holding
// G_t[i][chunk] in registers for the whole sweep. So dr, dk and dw are sums
// inside a thread, over the chunk's columns; with more than one chunk
// (hd = 48, 80, ...) the chunks' partial sums meet by atomicAdd in outputs
// the caller zeroed. dv_t needs a sum over the rows, i.e. across threads:
// each warp reduce-scatters its CW-vector of k_t[i] (G + u r gy) with
// shuffles (CW - 1 shuffles a thread, not 5 CW), and the warps' parts meet
// in a double-buffered shared array, one __syncthreads() a step. du is
// summed over T in f64 (a sum of T terms, where f32 would lose about
// sqrt(T) roundings of its magnitude) per (b, chunk, h) into du_part
// (B, hd / CW, H, hd); the caller adds those over B and the chunks. gy_t
// and v_t are read by every thread of the block at the same address
// (broadcast loads from L1).
//
// Memory. The checkpoints are B H ceil(T / C) hd^2 * 4 bytes (268 MB at
// (4, 64, 1024, 64) with C = 16, in place of the per-step states that
// autograd of the plain loop keeps); the scratch is B H C hd * hd_pad * 4
// bytes (67 MB there). Each thread reads back only scratch it wrote itself,
// so the scratch needs no barrier.
//
// Bound: the kernel must read r, k, v, w, gy and write dr, dk, dv, dw,
// 9 hd-vectors per (b, h, t), plus the checkpoints once (and G_T, u); it
// does about 12 hd^2 FLOP per (b, h, t) (2 hd^2 to recompute S, about
// 10 hd^2 for the five sums and the G update). At (4, 64, 1024, 64): 604 MB
// + 268 MB of checkpoints (0.26 ms at 3.35 TB/s) and 12.9 GFLOP (0.19 ms at
// 67 TFLOP/s FP32). As in the forward, what holds it above both is the T
// dependent steps per block, each a barrier.
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_scan.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CKPT_EVERY = RWKV6_CHECKPOINT_EVERY;

__host__ __device__ constexpr int cols_of(int hd) {
  return hd % 64 == 0 ? 64 : (hd % 32 == 0 ? 32 : 16);
}

// Reduce-scatter of a LEN-vector c over the 32 lanes of a warp (LEN a power
// of two, 16 to 64). At each level a lane keeps one half of its vector and
// adds its partner's copy of that half. On return c[0 .. max(LEN/32, 1) - 1]
// hold the warp's sums of columns col, col + 1, ...
template <int LEN, int OFF>
__device__ __forceinline__ void reduce_scatter(float* c, int lane, int& col) {
  if constexpr (OFF >= 1) {
    if constexpr (LEN > 1) {
      constexpr int HALF = LEN / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int m = 0; m < HALF; ++m) {
        const float send = up ? c[m] : c[m + HALF];
        const float keep = up ? c[m + HALF] : c[m];
        c[m] = keep + __shfl_xor_sync(FULL, send, OFF);
      }
      if (up) col += HALF;
      reduce_scatter<HALF, OFF / 2>(c, lane, col);
    } else {
      c[0] += __shfl_xor_sync(FULL, c[0], OFF);
      reduce_scatter<1, OFF / 2>(c, lane, col);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__((HD + 31) / 32 * 32)
rwkv6_scan_bwd_kernel(const float* __restrict__ r,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ gy,
                      const float* __restrict__ gs,
                      const float* __restrict__ ckpt,
                      float* __restrict__ dr, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du_part, float* scratch,
                      int64_t t_len, int n_heads) {
  constexpr int CW = cols_of(HD);
  constexpr int NCH = HD / CW;
  constexpr int NT = (HD + 31) / 32 * 32;
  constexpr int NW = NT / 32;
  constexpr int PER_LANE = CW >= 32 ? CW / 32 : 1;
  __shared__ float red[2][NW][CW];

  const int i = threadIdx.x;  // row of S and G
  const int lane = i & 31;
  const int warp = i >> 5;
  const bool row_ok = i < HD;
  const int64_t bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int col0 = chunk * CW;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t b = bh / n_heads;
  const int64_t base = bh * t_len * HD;
  const int64_t n_ckpt = rwkv6_n_checkpoints(t_len);
  const float ui = row_ok ? u[h * HD + i] : 0.0f;
  // this block's scratch: CKPT_EVERY slots of CW x NT, thread i at [.][j][i]
  float* my_scratch =
      scratch + (bh * NCH + chunk) * (CKPT_EVERY * CW * NT) + i;

  float G[CW];
  if (gs != nullptr && row_ok) {
    const float* g0 = gs + (bh * HD + i) * HD + col0;
#pragma unroll
    for (int j = 0; j < CW; ++j) G[j] = g0[j];
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) G[j] = 0.0f;
  }
  double du_acc = 0.0;  // a sum over T: f64, as the plain version keeps it

  for (int64_t c = n_ckpt - 1; c >= 0; --c) {
    const int64_t t0 = c * CKPT_EVERY;
    const int len = static_cast<int>(
        t_len - t0 < CKPT_EVERY ? t_len - t0 : CKPT_EVERY);
    {  // slot s <- S^(t0 + s), the state step t0 + s starts from
      float S[CW];
      const float* cp = ckpt + ((bh * n_ckpt + c) * HD + i) * HD + col0;
#pragma unroll
      for (int j = 0; j < CW; ++j) S[j] = row_ok ? cp[j] : 0.0f;
      for (int s = 0; s < len; ++s) {
        float* slot = my_scratch + static_cast<int64_t>(s) * CW * NT;
#pragma unroll
        for (int j = 0; j < CW; ++j) slot[j * NT] = S[j];
        if (s + 1 < len) {
          const int64_t o = base + (t0 + s) * HD;
          const float ki = row_ok ? k[o + i] : 0.0f;
          const float wi = row_ok ? w[o + i] : 0.0f;
          const float4* v4 = reinterpret_cast<const float4*>(v + o + col0);
#pragma unroll
          for (int j4 = 0; j4 < CW / 4; ++j4) {
            const float4 vv = __ldg(v4 + j4);
            S[4 * j4 + 0] = fmaf(wi, S[4 * j4 + 0], ki * vv.x);
            S[4 * j4 + 1] = fmaf(wi, S[4 * j4 + 1], ki * vv.y);
            S[4 * j4 + 2] = fmaf(wi, S[4 * j4 + 2], ki * vv.z);
            S[4 * j4 + 3] = fmaf(wi, S[4 * j4 + 3], ki * vv.w);
          }
        }
      }
    }
    for (int s = len - 1; s >= 0; --s) {
      const int64_t t = t0 + s;
      const int64_t o = base + t * HD;
      float ri = 0.0f, ki = 0.0f, wi = 0.0f;
      if (row_ok) {
        ri = r[o + i];
        ki = k[o + i];
        wi = w[o + i];
      }
      const float bi = ui * ri;
      const float* slot = my_scratch + static_cast<int64_t>(s) * CW * NT;
      const float4* gy4 = reinterpret_cast<const float4*>(gy + o + col0);
      const float4* v4 = reinterpret_cast<const float4*>(v + o + col0);
      float dri = 0.0f, dki = 0.0f, dwi = 0.0f, gv = 0.0f;
      float cv[CW];
#pragma unroll
      for (int j4 = 0; j4 < CW / 4; ++j4) {
        const float4 gq = __ldg(gy4 + j4);
        const float4 vq = __ldg(v4 + j4);
        const float gys[4] = {gq.x, gq.y, gq.z, gq.w};
        const float vs[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * j4 + e;
          const float sj = slot[j * NT];
          const float g = G[j];
          dri = fmaf(gys[e], sj, dri);
          dki = fmaf(g, vs[e], dki);
          dwi = fmaf(g, sj, dwi);
          gv = fmaf(gys[e], vs[e], gv);
          cv[j] = ki * fmaf(bi, gys[e], g);
          G[j] = fmaf(wi, g, ri * gys[e]);
        }
      }
      dri = fmaf(ui * ki, gv, dri);
      dki = fmaf(bi, gv, dki);
      du_acc += static_cast<double>(ri * ki * gv);
      if (row_ok) {
        if constexpr (NCH == 1) {
          dr[o + i] = dri;
          dk[o + i] = dki;
          dw[o + i] = dwi;
        } else {
          atomicAdd(dr + o + i, dri);
          atomicAdd(dk + o + i, dki);
          atomicAdd(dw + o + i, dwi);
        }
      }
      int col = 0;
      reduce_scatter<CW, 16>(cv, lane, col);
      float* part = &red[t & 1][warp][0];
      if (CW >= 32 || (lane & 1) == 0) {
#pragma unroll
        for (int m = 0; m < PER_LANE; ++m) part[col + m] = cv[m];
      }
      // one barrier a step: red[t & 1] is written again two steps later,
      // after the next step's barrier, which its readers here pass first
      __syncthreads();
      if (i < CW) {
        float acc = 0.0f;
#pragma unroll
        for (int wp = 0; wp < NW; ++wp) acc += red[t & 1][wp][i];
        dv[o + col0 + i] = acc;
      }
    }
  }
  if (row_ok)
    du_part[((b * NCH + chunk) * n_heads + h) * HD + i] =
        static_cast<float>(du_acc);
}

template <int HD>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, const float* gy, const float* gs,
            const float* ckpt, float* dr, float* dk, float* dv, float* dw,
            float* du_part, float* scratch, int64_t bh, int64_t t_len,
            int n_heads, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(bh), HD / cols_of(HD));
  rwkv6_scan_bwd_kernel<HD><<<grid, (HD + 31) / 32 * 32, 0, stream>>>(
      r, k, v, w, u, gy, gs, ckpt, dr, dk, dv, dw, du_part, scratch, t_len,
      n_heads);
}

}  // namespace

// Column chunks per (b, h) at head size hd (du_part's second axis, and
// whether dr/dk/dw must be zeroed first: > 1), or 0 for a head size the
// kernel does not take.
extern "C" int rwkv6_scan_bwd_chunks(int64_t hd) {
  if (hd < 16 || hd > 256 || hd % 16) return 0;
  return static_cast<int>(hd / cols_of(static_cast<int>(hd)));
}

// Scratch floats the kernel needs: B H C hd hd_pad, hd_pad = hd rounded up
// to a multiple of 32.
extern "C" int64_t rwkv6_scan_bwd_scratch_floats(int64_t batch,
                                                 int64_t n_heads,
                                                 int64_t hd) {
  return batch * n_heads * CKPT_EVERY * hd * ((hd + 31) / 32 * 32);
}

// r, k, v, w, gy: (B, H, T, hd) f32 contiguous, 16-byte aligned; u: (H, hd);
// gs: (B, H, hd, hd) or null (G_T = 0); ckpt: (B, H, ceil(T / C), hd, hd)
// from rwkv6_scan_launch (C = RWKV6_CHECKPOINT_EVERY); dr, dk, dv, dw:
// (B, H, T, hd), zeroed when rwkv6_scan_bwd_chunks(hd) > 1; du_part: (B,
// chunks, H, hd); scratch: rwkv6_scan_bwd_scratch_floats(...) floats.
// Returns a cudaError_t (0 = success); a shape it does not take returns
// cudaErrorInvalidValue without launching.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* gy, const void* gs, const void* ckpt, void* dr,
    void* dk, void* dv, void* dw, void* du_part, void* scratch, int64_t batch,
    int64_t n_heads, int64_t t_len, int64_t hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * n_heads;
  if (bh <= 0 || t_len <= 0 || bh > 0x7fffffff || n_heads > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* gyf = static_cast<const float*>(gy);
  const auto* gsf = static_cast<const float*>(gs);
  const auto* cf = static_cast<const float*>(ckpt);
  auto* drf = static_cast<float*>(dr);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* dwf = static_cast<float*>(dw);
  auto* duf = static_cast<float*>(du_part);
  auto* scf = static_cast<float*>(scratch);
  const int nh = static_cast<int>(n_heads);
  switch (hd) {
#define RWKV6_BWD_CASE(HD)                                                 \
  case HD:                                                                 \
    launch<HD>(rf, kf, vf, wf, uf, gyf, gsf, cf, drf, dkf, dvf, dwf, duf,  \
               scf, bh, t_len, nh, st);                                    \
    break;
    RWKV6_BWD_CASE(16) RWKV6_BWD_CASE(32) RWKV6_BWD_CASE(48)
    RWKV6_BWD_CASE(64) RWKV6_BWD_CASE(80) RWKV6_BWD_CASE(96)
    RWKV6_BWD_CASE(112) RWKV6_BWD_CASE(128) RWKV6_BWD_CASE(144)
    RWKV6_BWD_CASE(160) RWKV6_BWD_CASE(176) RWKV6_BWD_CASE(192)
    RWKV6_BWD_CASE(208) RWKV6_BWD_CASE(224) RWKV6_BWD_CASE(240)
    RWKV6_BWD_CASE(256)
#undef RWKV6_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
