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
//   dr_t[i] = sum_j gy_t[j] S_{t-1}[i][j] + u[i] k_t[i] gv_t
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + u[i] r_t[i] gv_t
//   dv_t[j] = sum_i k_t[i] G_t[i][j] + gy_t[j] sum_i u[i] r_t[i] k_t[i]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b,t} r_t[i] k_t[i] gv_t,     gv_t = sum_j gy_t[j] v_t[j]
//   G_{t-1} = diag(w_t) G_t + r_t^T gy_t
//
// S_{t-1} is recomputed forward, never recovered by dividing by w, which
// underflows to exactly 0 in practice. The forward kernel writes the state
// every C steps (ckpt, (B, H, ceil(T / C), hd, hd); C is the compile-time
// RWKV6_CHECKPOINT_EVERY = 16 of rwkv6_scan.h); the backward takes the
// segments of C steps last first, recomputes each one's states from its
// checkpoint and sweeps it backwards. du is summed over T in f64 (a sum of
// T terms, where f32 would lose about sqrt(T) roundings of its magnitude)
// per (b, h) into du_part; the caller adds those over B.
//
// Bound: the kernel must read r, k, v, w, gy and write dr, dk, dv, dw,
// 9 hd-vectors per (b, h, t), plus the checkpoints once (and G_T, u); it
// does about 14 hd^2 FLOP per (b, h, t) (3 hd^2 to recompute S, 2 hd^2
// for each of dr, dk, dv, dw, 3 hd^2 for the G update). At (4, 64, 1024,
// 64): 604 MB + 268 MB of checkpoints (0.26 ms at 3.35 TB/s) and 15.0
// GFLOP (0.22 ms at 67 TFLOP/s FP32). What holds it above both is the T
// dependent steps of each (b, h), each ending in a barrier.
//
// Design, hd <= 64 ("resident"): what it does about the three limits of
// the kernel's first version (kept below for hd > 64), which took 5.58 ms
// at that shape on an H100 80GB HBM3 at 700 W with 256 blocks of 2 warps,
// its segment states in a global scratch and atomics at hd 48:
//
// 1. Warps. One block owns one (b, h) and all its hd/16 column chunks:
//    thread (chunk c, row i) keeps G[i][16c .. 16c+15] in registers for the
//    whole sweep (rows padded to whole warps, so a warp is 32 rows of one
//    chunk). At hd 64 that is 256 threads, and 2 blocks fit an SM (112 KB
//    of shared memory and 128 registers a thread, no spills), so all
//    B H = 256 recurrences of the rwkv6-7b shape are resident in one wave
//    on 132 SMs, each scheduler switching between 4 warps, not 1. dr, dk
//    and dw are sums over the chunks: each thread's chunk partial meets the
//    others in shared memory behind the step's one barrier, and no atomics
//    are used, so the gradients are the same bits run to run. dv_t's sum
//    over rows is a 16-column reduce-scatter in each warp (16 shuffles a
//    thread) whose parts meet in shared memory the same way. Both arrays
//    are double-buffered, so one barrier a step suffices: a buffer is
//    written again two steps later, after a barrier its readers have passed.
//    gv_t and sum_i u r_t k_t are formed once per segment for its 16 steps.
// 2. Segment states on chip, in two levels. For each segment the block
//    recomputes from the checkpoint the sub-checkpoints every SUB = 4 steps
//    into shared memory (4 slots of hd^2 floats, 64 KB at hd 64), then
//    sweeps each sub-segment back, last first: its last HELD = 2 states
//    are recomputed into registers at once, each earlier one from the
//    sub-checkpoint when its turn comes (a third state in registers
//    spilled, for no gain in time). A thread reads back only what it
//    wrote, so this needs no barrier. It costs 1.75 recomputed states a
//    step (about 3.5 hd^2 more FLOP) in place of the 8.6 GB of scratch
//    traffic a call that the first version sent through L2 and HBM (67 MB
//    of scratch in flight, larger than the 50 MB L2).
// 3. Inputs staged asynchronously. A segment's r, k, w, gy, v rows (20 KB
//    at hd 64) are copied into shared memory with 16-byte cp.async, double
//    buffered and issued one segment ahead; the next segment's checkpoint
//    is copied the same way into the slot the sweep has just freed (slots
//    rotate by one each segment). No step waits on device memory; each
//    reads gy_t and v_t as broadcast loads and its row's r, k, w from
//    shared memory.
// At (4, 64, 1024, 64) this design takes 1.11 ms on an H100 80GB HBM3 at
// 700 W (chip_smoke.py), 23% of its bound.
//
// Design, hd > 64 ("split", the first version): a block owns one (b, h)
// and a chunk of CW = 64, 32 or 16 columns (the largest that divides hd), a
// thread per row; it recomputes each segment's C states into a global
// scratch (B H C hd hd_pad floats), and the chunks' dr/dk/dw partials meet
// by atomicAdd in outputs the caller zeroed. A resident block would not fit
// there: at hd 256 it would be 16 chunks x 256 rows = 4096 threads (a
// block takes 1024) and 1 MB of sub-checkpoints.
//
// Next step: the chunked ("segment-parallel") form, which turns a segment
// into 16 x hd x hd products for the tensor cores; this design's steps are
// rank-1 updates and matrix-vector products, which no tensor core takes.
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_scan.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CKPT_EVERY = RWKV6_CHECKPOINT_EVERY;
constexpr int SUB = 4;  // steps whose states a thread holds in registers
static_assert(CKPT_EVERY % SUB == 0, "SUB must divide the checkpoint interval");
constexpr int NSUB = CKPT_EVERY / SUB;  // sub-checkpoint slots a segment uses
// of a sub-segment's states, those held in registers (the last HELD); each
// earlier one is recomputed from its sub-checkpoint when its turn comes.
// With 3 the hd-64 kernel spilled at its 128 registers.
constexpr int HELD = 2;
static_assert(HELD >= 1 && HELD < SUB, "HELD must be in [1, SUB)");
constexpr int CC = 16;                  // columns a thread holds (hd <= 64)
constexpr int RESIDENT_MAX_HD = 64;
enum { IN_R, IN_K, IN_W, IN_GY, IN_V, N_IN };  // staged arrays, in this order

__host__ __device__ constexpr int cols_of(int hd) {
  return hd % 64 == 0 ? 64 : (hd % 32 == 0 ? 32 : 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// ---- hd <= 64: one block per (b, h), every column chunk in it

template <int HD>
struct Resident {
  static constexpr int NCH = HD / CC;                 // column chunks
  static constexpr int ROWS = (HD + 31) / 32 * 32;    // rows, whole warps
  static constexpr int NT = NCH * ROWS;               // threads
  static constexpr int NWARP = NT / 32;
  static constexpr int WPC = ROWS / 32;               // warps per chunk
  static constexpr int NOUT = (4 * HD + NT - 1) / NT; // outputs a thread writes
  // shared memory in floats, in this order (each a multiple of 4)
  static constexpr int SUBCK = NSUB * CC * NT;        // [NSUB][CC/4][NT] float4
  static constexpr int STAGE = N_IN * CKPT_EVERY * HD;  // one segment's rows
  static constexpr int RED = 3 * NCH * HD;            // dr, dk, dw partials
  static constexpr int DVRED = NWARP * CC;            // dv partials per warp
  static constexpr int FLOATS =  // ... then gv, sum u r k, u, du (f64)
      SUBCK + 2 * STAGE + 2 * RED + 2 * DVRED + 2 * CKPT_EVERY + 3 * HD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(Resident<HD>::NT, 2)
rwkv6_scan_bwd_resident(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ gy,
                        const float* __restrict__ gs,
                        const float* __restrict__ ckpt,
                        float* __restrict__ dr, float* __restrict__ dk,
                        float* __restrict__ dv, float* __restrict__ dw,
                        float* __restrict__ du_part, int64_t t_len,
                        int n_heads) {
  using L = Resident<HD>;
  constexpr int NT = L::NT;
  extern __shared__ float4 smem[];
  float4* subck = smem;                               // sub-checkpoints
  float* stage = reinterpret_cast<float*>(smem) + L::SUBCK;  // [2][N_IN][C][HD]
  float* red = stage + 2 * L::STAGE;                  // [2][3][NCH][HD]
  float* dvred = red + 2 * L::RED;                    // [2][NWARP][CC]
  float* gvs = dvred + 2 * L::DVRED;                  // [C] gy_t . v_t
  float* ruks = gvs + CKPT_EVERY;                     // [C] sum_i u r_t k_t
  float* us = ruks + CKPT_EVERY;                      // [HD] u of this head
  double* dus = reinterpret_cast<double*>(us + HD);   // [HD] du, f64

  const int tid = threadIdx.x;
  const int chunk = tid / L::ROWS;
  const int i = tid % L::ROWS;  // row of S and G
  const bool row_ok = i < HD;
  const int ir = row_ok ? i : 0;
  const int col0 = chunk * CC;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t b = bh / n_heads;
  const int64_t base = bh * t_len * HD;
  const int n_ckpt = static_cast<int>(rwkv6_n_checkpoints(t_len));

  for (int x = tid; x < HD; x += NT) {
    us[x] = u[h * HD + x];
    dus[x] = 0.0;  // each entry read and written by this thread alone
  }
  if (!row_ok) {  // padding rows hold S = G = 0 throughout
#pragma unroll
    for (int q = 0; q < NSUB * CC / 4; ++q)
      subck[q * NT + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  auto seg_len = [&](int c) {
    const int64_t rest = t_len - static_cast<int64_t>(c) * CKPT_EVERY;
    return static_cast<int>(rest < CKPT_EVERY ? rest : CKPT_EVERY);
  };
  // segment c's r, k, w, gy, v rows -> stage buffer c & 1 (all threads)
  auto stage_segment = [&](int c) {
    const int n4 = seg_len(c) * HD / 4;
    const int64_t src0 = base + static_cast<int64_t>(c) * CKPT_EVERY * HD;
    float* dst = stage + (c & 1) * L::STAGE;
    const float* srcs[N_IN] = {r, k, w, gy, v};
#pragma unroll
    for (int a = 0; a < N_IN; ++a)
      for (int q = tid; q < n4; q += NT)
        cp_async16(dst + a * CKPT_EVERY * HD + 4 * q, srcs[a] + src0 + 4 * q);
  };
  // this thread's 16 values of checkpoint c -> its own part of a slot
  auto fetch_ckpt = [&](int c, int slot) {
    if (row_ok) {
      const float* src = ckpt + ((bh * n_ckpt + c) * HD + i) * HD + col0;
#pragma unroll
      for (int j4 = 0; j4 < CC / 4; ++j4)
        cp_async16(&subck[(slot * (CC / 4) + j4) * NT + tid], src + 4 * j4);
    }
  };
  auto load_slot = [&](float (&S)[CC], int slot) {
#pragma unroll
    for (int j4 = 0; j4 < CC / 4; ++j4) {
      const float4 q = subck[(slot * (CC / 4) + j4) * NT + tid];
      S[4 * j4] = q.x;
      S[4 * j4 + 1] = q.y;
      S[4 * j4 + 2] = q.z;
      S[4 * j4 + 3] = q.w;
    }
  };
  auto store_slot = [&](const float (&S)[CC], int slot) {
#pragma unroll
    for (int j4 = 0; j4 < CC / 4; ++j4)
      subck[(slot * (CC / 4) + j4) * NT + tid] =
          make_float4(S[4 * j4], S[4 * j4 + 1], S[4 * j4 + 2], S[4 * j4 + 3]);
  };

  float G[CC];
#pragma unroll
  for (int j = 0; j < CC; ++j)
    G[j] = (gs != nullptr && row_ok) ? gs[(bh * HD + i) * HD + col0 + j]
                                     : 0.0f;
  int slot0 = 0;  // the slot that holds the current segment's checkpoint
  stage_segment(n_ckpt - 1);
  fetch_ckpt(n_ckpt - 1, slot0);
  cp_async_commit();

  for (int c = n_ckpt - 1; c >= 0; --c) {
    const int64_t t0 = static_cast<int64_t>(c) * CKPT_EVERY;
    const int len = seg_len(c);
    cp_async_wait_all();  // this segment's rows and checkpoint have landed
    __syncthreads();      // ... for every thread's copies
    if (c > 0) {
      stage_segment(c - 1);  // into the buffer segment c + 1 used
      cp_async_commit();
    }
    const float* st = stage + (c & 1) * L::STAGE;
    const float* rs = st + IN_R * CKPT_EVERY * HD;
    const float* ks = st + IN_K * CKPT_EVERY * HD;
    const float* ws = st + IN_W * CKPT_EVERY * HD;
    const float* gys = st + IN_GY * CKPT_EVERY * HD;
    const float* vs = st + IN_V * CKPT_EVERY * HD;

    // gv_s and sum_i u r_s k_s for the segment's steps, 16 lanes a step;
    // read after each step's barrier, written again after the next
    // segment's first barrier
    for (int s0 = 0; s0 < CKPT_EVERY; s0 += NT / 16) {
      const int s = s0 + tid / 16;
      float gv = 0.0f, ruk = 0.0f;
      if (s < len) {
        for (int x = tid & 15; x < HD; x += 16) {
          gv = fmaf(gys[s * HD + x], vs[s * HD + x], gv);
          ruk = fmaf(us[x] * rs[s * HD + x], ks[s * HD + x], ruk);
        }
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        gv += __shfl_xor_sync(FULL, gv, off);
        ruk += __shfl_xor_sync(FULL, ruk, off);
      }
      if (s < len && (tid & 15) == 0) {
        gvs[s] = gv;
        ruks[s] = ruk;
      }
    }

    // S <- S_{s+1} = diag(w_s) S_s + k_s^T v_s, this thread's 16 columns
    auto advance = [&](float (&S)[CC], int s) {
      const float ki = row_ok ? ks[s * HD + ir] : 0.0f;
      const float wi = row_ok ? ws[s * HD + ir] : 0.0f;
      const float4* v4 = reinterpret_cast<const float4*>(vs + s * HD + col0);
#pragma unroll
      for (int j4 = 0; j4 < CC / 4; ++j4) {
        const float4 q = v4[j4];
        S[4 * j4] = fmaf(wi, S[4 * j4], ki * q.x);
        S[4 * j4 + 1] = fmaf(wi, S[4 * j4 + 1], ki * q.y);
        S[4 * j4 + 2] = fmaf(wi, S[4 * j4 + 2], ki * q.z);
        S[4 * j4 + 3] = fmaf(wi, S[4 * j4 + 3], ki * q.w);
      }
    };
    // one reverse step t0 + s from S = S_{t-1}: G_t -> G_{t-1}, outputs
    auto step = [&](const float (&S)[CC], int s) {
      const float ri = row_ok ? rs[s * HD + ir] : 0.0f;
      const float ki = row_ok ? ks[s * HD + ir] : 0.0f;
      const float wi = row_ok ? ws[s * HD + ir] : 0.0f;
      const float4* gy4 =
          reinterpret_cast<const float4*>(gys + s * HD + col0);
      const float4* v4 = reinterpret_cast<const float4*>(vs + s * HD + col0);
      float dri = 0.0f, dki = 0.0f, dwi = 0.0f;
      // the 4 columns of group j4: sums into dri, dki, dwi; G updated;
      // out[e] = k_i G[i][4 j4 + e], this row's part of dv
      auto columns = [&](int j4, float (&out)[4]) {
        const float4 gq = gy4[j4];
        const float4 vq = v4[j4];
        const float gq_[4] = {gq.x, gq.y, gq.z, gq.w};
        const float vq_[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * j4 + e;
          const float g = G[j];
          dri = fmaf(gq_[e], S[j], dri);
          dki = fmaf(g, vq_[e], dki);
          dwi = fmaf(g, S[j], dwi);
          out[e] = ki * g;
          G[j] = fmaf(wi, g, ri * gq_[e]);
        }
      };
      // dv's reduce-scatter over the warp, its first level (lanes 16 apart
      // swap halves) taken as soon as a column and its partner 8 columns on
      // are done, so that 8 partial sums are live, not 16
      const bool up = (lane & 16) != 0;
      float cv[CC / 2];
#pragma unroll
      for (int p = 0; p < CC / 8; ++p) {
        float lo[4], hi[4];
        columns(p, lo);
        columns(p + CC / 8, hi);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cv[4 * p + e] = (up ? hi[e] : lo[e]) +
                          __shfl_xor_sync(FULL, up ? lo[e] : hi[e], 16);
      }
      int col = up ? CC / 2 : 0;
      reduce_scatter<CC / 2, 8>(cv, lane, col);  // 32 / CC lanes a column
      float* rb = red + (s & 1) * L::RED;
      float* vb = dvred + (s & 1) * L::DVRED;
      if (row_ok) {
        rb[(0 * L::NCH + chunk) * HD + i] = dri;
        rb[(1 * L::NCH + chunk) * HD + i] = dki;
        rb[(2 * L::NCH + chunk) * HD + i] = dwi;
      }
      if (lane % (32 / CC) == 0) vb[warp * CC + col] = cv[0];
      __syncthreads();
      const int64_t o = base + (t0 + s) * HD;
      const float gv = gvs[s];
#pragma unroll
      for (int m = 0; m < L::NOUT; ++m) {
        const int x = tid + m * NT;
        if (x < 4 * HD) {
          const int kind = x / HD;  // 0 dr, 1 dk, 2 dw, 3 dv
          const int y = x % HD;
          float acc = 0.0f;
          if (kind < 3) {
#pragma unroll
            for (int cc = 0; cc < L::NCH; ++cc)
              acc += rb[(kind * L::NCH + cc) * HD + y];
          } else {
#pragma unroll
            for (int p = 0; p < L::WPC; ++p)
              acc += vb[((y / CC) * L::WPC + p) * CC + y % CC];
          }
          if (kind == 0) {
            const float ry = rs[s * HD + y], ky = ks[s * HD + y];
            dr[o + y] = fmaf(us[y] * ky, gv, acc);
            dus[y] += static_cast<double>(ry * ky * gv);
          } else if (kind == 1) {
            dk[o + y] = fmaf(us[y] * rs[s * HD + y], gv, acc);
          } else if (kind == 2) {
            dw[o + y] = acc;
          } else {
            dv[o + y] = fmaf(gys[s * HD + y], ruks[s], acc);
          }
        }
      }
    };

    // level 1: sub-checkpoints S_{t0 + SUB q}, q = 1 .. nsub - 1
    const int nsub = (len + SUB - 1) / SUB;
    {
      float S[CC];
      load_slot(S, slot0);
      for (int s = 0; s < (nsub - 1) * SUB; ++s) {
        advance(S, s);
        if ((s + 1) % SUB == 0) store_slot(S, (slot0 + (s + 1) / SUB) % NSUB);
      }
    }
    // level 2: each sub-segment, last first. Its last HELD states are
    // recomputed into registers at once, each earlier one from the slot
    // when its turn comes
    for (int q = nsub - 1; q >= 0; --q) {
      const int sa = q * SUB;
      const int n = len - sa < SUB ? len - sa : SUB;
      const int slot = (slot0 + q) % NSUB;
      if (q == 0 && c > 0) {  // slot0 + 1 is free: the next checkpoint
        fetch_ckpt(c - 1, (slot0 + 1) % NSUB);
        cp_async_commit();
      }
      float Ss[HELD][CC];  // S_{sa + SUB - HELD} .. S_{sa + SUB - 1}
      if (n > SUB - HELD) {
        float S[CC];
        load_slot(S, slot);
#pragma unroll
        for (int m = 1; m < SUB; ++m) {
          if (m < n) {
            advance(S, sa + m - 1);
            if (m >= SUB - HELD) {
#pragma unroll
              for (int j = 0; j < CC; ++j) Ss[m - (SUB - HELD)][j] = S[j];
            }
          }
        }
      }
#pragma unroll
      for (int m = SUB - 1; m >= SUB - HELD; --m)
        if (m < n) step(Ss[m - (SUB - HELD)], sa + m);
#pragma unroll
      for (int m = SUB - HELD - 1; m >= 0; --m) {
        if (m < n) {
          float S[CC];
          load_slot(S, slot);
#pragma unroll
          for (int j = 0; j < m; ++j) advance(S, sa + j);
          step(S, sa + m);
        }
      }
    }
    slot0 = (slot0 + 1) % NSUB;
  }
  for (int x = tid; x < HD; x += NT)
    du_part[(b * n_heads + h) * HD + x] = static_cast<float>(dus[x]);
}

// ---- hd > 64: a block per (b, h, column chunk), states in a global scratch

template <int HD>
__global__ void __launch_bounds__((HD + 31) / 32 * 32)
rwkv6_scan_bwd_split(const float* __restrict__ r,
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
  double du_acc = 0.0;

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

// Opt the resident kernel of head size HD in to its shared memory (above 48
// KB) and to the largest shared-memory carveout, so that 2 blocks fit an SM.
// The attributes belong to the current device, so this runs at every launch:
// two runtime calls beside a kernel of about a millisecond.
template <int HD>
cudaError_t prepare() {
  if constexpr (HD <= RESIDENT_MAX_HD) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_bwd_resident<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Resident<HD>::BYTES));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(rwkv6_scan_bwd_resident<HD>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }
  return cudaSuccess;
}

// The launch of head size HD for bh (b, h) pairs: cfg = {blocks, threads a
// block, dynamic shared bytes, resident blocks per SM}.
template <int HD>
cudaError_t configure(int64_t bh, int64_t* cfg) {
  int per_sm = 0;
  cudaError_t e = prepare<HD>();
  if constexpr (HD <= RESIDENT_MAX_HD) {
    using L = Resident<HD>;
    cfg[0] = bh;
    cfg[1] = L::NT;
    cfg[2] = static_cast<int64_t>(L::BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rwkv6_scan_bwd_resident<HD>, L::NT, L::BYTES);
  } else {
    constexpr int NT = (HD + 31) / 32 * 32;
    cfg[0] = bh * (HD / cols_of(HD));
    cfg[1] = NT;
    cfg[2] = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rwkv6_scan_bwd_split<HD>, NT, 0);
  }
  cfg[3] = per_sm;
  return e;
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* gy,
                   const float* gs, const float* ckpt, float* dr, float* dk,
                   float* dv, float* dw, float* du_part, float* scratch,
                   int64_t bh, int64_t t_len, int n_heads,
                   cudaStream_t stream) {
  cudaError_t e = prepare<HD>();
  if (e != cudaSuccess) return e;
  if constexpr (HD <= RESIDENT_MAX_HD) {
    using L = Resident<HD>;
    rwkv6_scan_bwd_resident<HD>
        <<<static_cast<unsigned>(bh), L::NT, L::BYTES, stream>>>(
            r, k, v, w, u, gy, gs, ckpt, dr, dk, dv, dw, du_part, t_len,
            n_heads);
  } else {
    const dim3 grid(static_cast<unsigned>(bh), HD / cols_of(HD));
    rwkv6_scan_bwd_split<HD><<<grid, (HD + 31) / 32 * 32, 0, stream>>>(
        r, k, v, w, u, gy, gs, ckpt, dr, dk, dv, dw, du_part, scratch, t_len,
        n_heads);
  }
  return cudaGetLastError();
}

bool head_size_ok(int64_t hd) {
  return hd >= 16 && hd <= 256 && hd % 16 == 0;
}

}  // namespace

// du_part's second axis at head size hd, and whether dr/dk/dw must be
// zeroed first (> 1: the split path's chunks meet by atomicAdd); 0 for a
// head size the kernel does not take.
extern "C" int rwkv6_scan_bwd_chunks(int64_t hd) {
  if (!head_size_ok(hd)) return 0;
  if (hd <= RESIDENT_MAX_HD) return 1;
  return static_cast<int>(hd / cols_of(static_cast<int>(hd)));
}

// Scratch floats the kernel needs: none at hd <= 64; B H C hd hd_pad above
// (hd_pad = hd rounded up to a multiple of 32).
extern "C" int64_t rwkv6_scan_bwd_scratch_floats(int64_t batch,
                                                 int64_t n_heads,
                                                 int64_t hd) {
  if (hd <= RESIDENT_MAX_HD) return 0;
  return batch * n_heads * CKPT_EVERY * hd * ((hd + 31) / 32 * 32);
}

#define RWKV6_BWD_HEAD_SIZES(X)                                             \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)    \
  X(192) X(208) X(224) X(240) X(256)

// The launch that rwkv6_scan_bwd_launch makes for (batch, n_heads, hd) on
// the current device: cfg[0] blocks, cfg[1] threads a block, cfg[2] dynamic
// shared bytes, cfg[3] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int rwkv6_scan_bwd_launch_config(int64_t batch, int64_t n_heads,
                                            int64_t hd, int64_t* cfg) {
  switch (hd) {
#define RWKV6_BWD_CFG(HD) \
  case HD: return static_cast<int>(configure<HD>(batch * n_heads, cfg));
    RWKV6_BWD_HEAD_SIZES(RWKV6_BWD_CFG)
#undef RWKV6_BWD_CFG
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r, k, v, w, gy: (B, H, T, hd) f32 contiguous, 16-byte aligned; u: (H, hd);
// gs: (B, H, hd, hd) or null (G_T = 0); ckpt: (B, H, ceil(T / C), hd, hd)
// from rwkv6_scan_launch (C = RWKV6_CHECKPOINT_EVERY), 16-byte aligned; dr,
// dk, dv, dw: (B, H, T, hd), zeroed when rwkv6_scan_bwd_chunks(hd) > 1;
// du_part: (B, chunks, H, hd); scratch: rwkv6_scan_bwd_scratch_floats(...)
// floats (null when that is 0). Returns a cudaError_t (0 = success); a
// shape it does not take returns cudaErrorInvalidValue without launching.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* gy, const void* gs, const void* ckpt, void* dr,
    void* dk, void* dv, void* dw, void* du_part, void* scratch, int64_t batch,
    int64_t n_heads, int64_t t_len, int64_t hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * n_heads;
  if (bh <= 0 || t_len <= 0 || bh > 0x7fffffff || n_heads > 0x7fffffff ||
      t_len > 0x7fffffff)
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
#define RWKV6_BWD_CASE(HD)                                                  \
  case HD:                                                                  \
    return static_cast<int>(launch<HD>(rf, kf, vf, wf, uf, gyf, gsf, cf,    \
                                       drf, dkf, dvf, dwf, duf, scf, bh,    \
                                       t_len, nh, st));
    RWKV6_BWD_HEAD_SIZES(RWKV6_BWD_CASE)
#undef RWKV6_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
