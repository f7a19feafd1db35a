// RWKV-6 ("Finch") WKV recurrence for Hopper (sm_90a), from a zero state
// or from a carried one.
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/rwkv/scan.py:51 (rwkv6_scan, body _rwkv_kernel at
// :28). Per (batch b, head h), with an hd x hd f32 state S that starts at
// S_0 (s_in, (B, H, hd, hd) f32, when the caller passes it; else 0):
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
// hd) f32, row-major per state. The first is S_0 itself (s_in's bits, or
// zeros), so the backward's recompute needs no other change for a carried
// state. C is the compile-time constant
// RWKV6_CHECKPOINT_EVERY = 16 (rwkv6_scan.h), shared with the backward.
// Without a buffer the kernel is compiled without the write.
//
// Bound: per (b, h, t) the kernel must read 4 hd-vectors and write one
// (5 * hd * 4 bytes) and does about 5 hd^2 FLOP (the k v product, the
// w S + k v update and r S as FMAs). At the rwkv6-7b training shape (4,
// 64, 1024, 64) that is 335.5 MB (0.100 ms at 3.35 TB/s) and 5.4 GFLOP
// (0.081 ms at 67 TFLOP/s FP32). Training always asks for the checkpoints,
// hd^2 * 4 bytes every C steps: 268.4 MB more at that shape, so the call
// it makes is bound by 604.0 MB, 0.180 ms. What holds the kernel above
// both is the recurrence: T dependent steps per (b, h), on B H = 256
// independent recurrences at that shape.
//
// Design, hd <= 64 ("resident"). The TPU kernel carries S in VMEM across
// a sequential grid axis; Hopper runs blocks in no order, so one block
// owns one (b, h) and loops over all of T itself. The first version (one
// thread per column of S, one barrier a step, inputs fetched one step
// ahead, 256 blocks of 2 warps) took 0.69 ms at the rwkv6-7b shape (0.78
// ms with checkpoints) on an H100 80GB HBM3 at 700 W. What this design
// does about its limits:
//
// 1. Shared-memory delivery. A warp's LDS.128 delivers 512 bytes, 4 of
//    the SM's 128-byte cycles, broadcast or not. One thread per column
//    reads r, k, w of every row for 3 FLOP a row: the first version spent
//    about 1000 such cycles a step per SM, which is its time. Here a
//    thread holds a tile of RS = 8 rows x CS = 4 columns of S (32
//    registers at hd 64) and each r, k, w it loads serves 4 columns: about
//    280 delivery cycles a step. (4 columns of 4 rows, 16 warps an SM, was
//    slower; 8 columns of 4 rows was faster without checkpoints and slower
//    with them.)
// 2. No barrier a step. The columns of S evolve independently and y_t[j]
//    needs column j alone. The NQ = 8 threads that hold a group of CS
//    columns are neighbouring lanes of one warp; they add their parts of
//    y_t with a reduce-scatter (4 shuffles), so no step waits for another
//    warp. At hd 64 a block is 128 threads and all 256 (b, h) of the
//    rwkv6-7b shape are resident in one wave on 132 SMs.
// 3. Inputs staged a segment ahead. A segment is the C = 16 steps between
//    checkpoints; its r, k, w, v rows are four contiguous spans (4 KB each
//    at hd 64), copied by 16-byte cp.async (offsets computed once) into a
//    ring of three buffers: while segment c runs, segment c + 1 has landed
//    and segment c + 2 is in flight. One __syncthreads() a segment (T / C
//    + 2 a call, against T) publishes the copies and frees the buffers.
//    Each row's 16-byte chunks go where the NQ slices' chunks of one load
//    sit side by side (16 NQ contiguous bytes): those LDS.128 have no bank
//    conflict and no pass repacks the rows.
// 4. The bonus out of the row loop: y_t[j] = sum_i r_i S[i][j] + v_j
//    sum_i u_i r_i k_i. The scalar is formed once a step for the block, for
//    segment c + 1 while segment c runs (16 lanes a step); a row then costs
//    k_i v_j, one FMA into y and the update S = fmaf(w_i, S, k_i v_j),
//    which is the first version's, so S_T and the checkpoints are the same
//    bits and only the order of y's sum differs. Nothing divides by w (it
//    may underflow to 0).
// 5. Coalesced outputs. A segment's y rows collect in shared memory and
//    all threads store them as float4 after the next barrier. Checkpoints
//    take the same way (see stage_checkpoint): stored from registers, each
//    warp store covered 8 rows of 64 bytes, and those stores held the step
//    loop's loads behind them for 0.07 ms a call, whether the lines went
//    to HBM or stayed in L2; as whole rows they cost 0.034 ms. (A bulk
//    copy per row from shared memory, cp.async.bulk, cost 0.06 ms.) No
//    atomics: two calls give the same bits.
//
// At (4, 64, 1024, 64) on an H100 80GB HBM3 at 700 W (chip_smoke.py) this
// design takes 0.275 ms (0.309 ms with checkpoints, 58% of that call's
// bound), against 0.69 ms (0.78 ms) before. The step loop runs about 126
// instructions a thread a step (96 of them FP32); at 2 warps a scheduler
// that is about half of what the schedulers could dispatch in that time, so
// latency, not a throughput limit, holds it now.
//
// A carried state (the decode path: T = 1 steps from S_0 != 0, one call a
// layer a token) is read once into the registers that hold S, each thread
// its own tile (resident) or its column's rows (split), with the same loads
// that store S_T; with no s_in those registers start at zero as before, and
// nothing else in the step loop changes. At T = 1 the call is bound by S_0
// in and S_T out, 2 hd^2 4 bytes per (b, h).
//
// Design, hd > 64 ("split"). A column of 256 floats does not fit one thread's
// registers, and hd threads of more than 64 registers each do not fit an
// SM's register file either. The columns of S evolve independently, so a
// second grid axis cuts them into chunks of SPLIT_COLS columns, and NS = 2
// (hd <= 128) or 4 threads share a column, each holding hd / NS of its rows
// (at most 64 registers). The NS threads of a column are neighbouring lanes
// of one warp and add their parts of y_t[j] with warp shuffles. Every block
// stages the (r, k, w, u) rows of all hd rows in shared memory as float4,
// one barrier a step. Only hd 128 and 256 configurations use it.
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_scan.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT_COLS = 16;  // columns of S per block when hd > 64
constexpr int CKPT_EVERY = RWKV6_CHECKPOINT_EVERY;
constexpr int RESIDENT_MAX_HD = 64;
constexpr int NSTAGE = 3;  // segments in the staging ring
enum { IN_R, IN_K, IN_W, IN_V, N_IN };  // staged arrays, in this order

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

// Reduce-scatter of a LEN-vector c over groups of 2 OFF lanes (LEN a power
// of two). At each level a lane keeps one half of its vector (the upper
// half if lane & OFF) and adds its partner's copy of that half; once one
// value is left, partners add it whole. On return c[0] holds the group's
// sum of the column that the kept halves name.
template <int LEN, int OFF>
__device__ __forceinline__ void reduce_scatter(float* c, int lane) {
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
      reduce_scatter<HALF, OFF / 2>(c, lane);
    } else {
      c[0] += __shfl_xor_sync(FULL, c[0], OFF);
      reduce_scatter<1, OFF / 2>(c, lane);
    }
  }
}

// ---- hd <= 64: one block per (b, h), a thread per tile of RS x CS of S

template <int HD>
struct Resident {
  // NQ threads share a group of CS columns (NQ, CS powers of two; NQ
  // divides 32 and NT is whole warps): hd 16 4 x 2, 32 8 x 4, 48 4 x 2,
  // 64 8 x 4
  static constexpr int NQ = HD % 32 == 0 ? 8 : 4;
  static constexpr int CS = HD % 32 == 0 ? 4 : 2;
  static constexpr int RS = HD / NQ;       // rows of S a thread holds
  static constexpr int NC4 = RS / 4;       // its 16-byte chunks of a row
  static constexpr int NT = HD / CS * NQ;  // threads
  static constexpr int ROW4 = HD / 4;      // 16-byte chunks of a row
  static constexpr int STAGE = N_IN * CKPT_EVERY * HD;  // floats a segment
  // a checkpoint in shared memory: row-major, row i at i hd + 4 (i / RS),
  // so that the NQ slices' 16-byte stores of a quarter warp fall in
  // distinct banks
  static constexpr int CKBUF = HD * HD + 4 * NQ;
  // shared memory in floats, in this order (each a multiple of 4)
  static constexpr int FLOATS = NSTAGE * STAGE    // the staging ring
                                + 2 * CKPT_EVERY * HD  // y rows, 2 segments
                                + 2 * CKPT_EVERY       // sum u r k, 2 segments
                                + HD                   // u of the head
                                + 2 * CKBUF;           // checkpoints, 2
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(RS % 4 == 0 && NT % 32 == 0 && 32 % NQ == 0, "tile");
};

// Where chunk c (4 floats) of a staged r, k or w row goes: chunk m4 of
// slice q = c / NC4 lands at m4 * NQ + q, so that the NQ slices' m4-th
// chunks are one contiguous 16 NQ bytes.
template <int HD>
__device__ __forceinline__ int swizzle(int c) {
  using L = Resident<HD>;
  return (c % L::NC4) * L::NQ + c / L::NC4;
}

// CS consecutive floats (CS 2, or a multiple of 4), aligned to 4 CS bytes
template <int CS>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[CS]) {
  if constexpr (CS == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  } else {
#pragma unroll
    for (int m = 0; m < CS; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + m);
      x[m] = q.x, x[m + 1] = q.y, x[m + 2] = q.z, x[m + 3] = q.w;
    }
  }
}
template <int CS>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[CS]) {
  if constexpr (CS == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int m = 0; m < CS; m += 4)
      *reinterpret_cast<float4*>(p + m) =
          make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
  }
}

template <int HD, bool CKPT>
__global__ void __launch_bounds__(Resident<HD>::NT, 2)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u,
                  const float* __restrict__ s_in, float* __restrict__ y,
                  float* __restrict__ s_out, float* __restrict__ ckpt,
                  int64_t t_len, int n_heads) {
  using L = Resident<HD>;
  constexpr int NT = L::NT;
  constexpr int NQ = L::NQ;
  constexpr int CS = L::CS;
  constexpr int RS = L::RS;
  constexpr int ROW4 = L::ROW4;
  constexpr int SEG = CKPT_EVERY * HD;  // floats of one array a segment
  extern __shared__ float4 smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [NSTAGE][N_IN][C][HD]
  float* ys = stage + NSTAGE * L::STAGE;          // [2][C][HD]
  float* ruks = ys + 2 * SEG;                     // [2][C] sum_i u r_t k_t
  float* us = ruks + 2 * CKPT_EVERY;              // [HD]
  float* ckbuf = us + HD;                         // [2][CKBUF] checkpoints

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = tid % NQ;        // slice: rows q RS .. q RS + RS - 1
  const int j0 = tid / NQ * CS;  // columns j0 .. j0 + CS - 1
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % n_heads);
  const int64_t base = bh * t_len * HD;
  const int n_seg = static_cast<int>(rwkv6_n_checkpoints(t_len));

  auto seg_len = [&](int c) {
    const int64_t rest = t_len - static_cast<int64_t>(c) * CKPT_EVERY;
    return static_cast<int>(rest < CKPT_EVERY ? rest : CKPT_EVERY);
  };
  // segment c's r, k, w (chunks swizzled) and v rows -> ring slot c % 3:
  // this thread copies chunks tid + n NT (n < CPT) of each array, whose
  // places in the slot are fixed
  constexpr int CPT = CKPT_EVERY * ROW4 / NT;
  static_assert(CKPT_EVERY * ROW4 % NT == 0, "whole chunks a thread");
  int cp_step[CPT], cp_at[CPT], cp_vat[CPT];
#pragma unroll
  for (int n = 0; n < CPT; ++n) {
    const int x = tid + n * NT, s = x / ROW4, cc = x % ROW4;
    cp_step[n] = s;
    cp_at[n] = s * HD + 4 * swizzle<HD>(cc);
    cp_vat[n] = s * HD + 4 * cc;
  }
  auto stage_segment = [&](int c) {
    const int len = seg_len(c);
    const int64_t src0 = base + static_cast<int64_t>(c) * SEG + 4 * tid;
    float* dst = stage + (c % NSTAGE) * L::STAGE;
#pragma unroll
    for (int n = 0; n < CPT; ++n)
      if (cp_step[n] < len) {
        const int64_t g = src0 + 4 * n * NT;
        cp_async16(dst + IN_R * SEG + cp_at[n], r + g);
        cp_async16(dst + IN_K * SEG + cp_at[n], k + g);
        cp_async16(dst + IN_W * SEG + cp_at[n], w + g);
        cp_async16(dst + IN_V * SEG + cp_vat[n], v + g);
      }
  };
  // sum_i u_i r_t[i] k_t[i] for segment c's steps -> ruks[c & 1], 16 lanes
  // a step, each over the chunks p, p + 16, ... of the row
  auto bonus = [&](int c) {
    const int len = seg_len(c);
    const float* st = stage + (c % NSTAGE) * L::STAGE;
    const float4* u4 = reinterpret_cast<const float4*>(us);
    for (int s0 = 0; s0 < CKPT_EVERY; s0 += NT / 16) {
      const int s = s0 + tid / 16;
      float acc = 0.0f;
      if (s < len) {
        const float4* r4 =
            reinterpret_cast<const float4*>(st + IN_R * SEG + s * HD);
        const float4* k4 =
            reinterpret_cast<const float4*>(st + IN_K * SEG + s * HD);
        for (int cc = tid % 16; cc < ROW4; cc += 16) {
          const float4 rq = r4[swizzle<HD>(cc)], kq = k4[swizzle<HD>(cc)];
          const float4 uq = u4[cc];
          acc = fmaf(uq.x * rq.x, kq.x, acc);
          acc = fmaf(uq.y * rq.y, kq.y, acc);
          acc = fmaf(uq.z * rq.z, kq.z, acc);
          acc = fmaf(uq.w * rq.w, kq.w, acc);
        }
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        acc += __shfl_xor_sync(FULL, acc, off);
      if (s < len && tid % 16 == 0) ruks[(c & 1) * CKPT_EVERY + s] = acc;
    }
  };
  // segment c's y rows, collected in ys[c & 1], to y (all threads, float4)
  auto store_y = [&](int c) {
    const int n4 = seg_len(c) * ROW4;
    const float4* src = reinterpret_cast<const float4*>(ys + (c & 1) * SEG);
    float4* dst = reinterpret_cast<float4*>(
        y + base + static_cast<int64_t>(c) * SEG);
    for (int x = tid; x < n4; x += NT) dst[x] = src[x];
  };

  // S[4 m4 + e][m] is row q RS + 4 m4 + e, column j0 + m: S_0's tile of
  // s_in, or zero
  float S[RS][CS];
  if (s_in != nullptr) {
    const float* p = s_in + bh * HD * HD + static_cast<int64_t>(q) * RS * HD
                     + j0;
#pragma unroll
    for (int i = 0; i < RS; ++i) load_cols<CS>(p + i * HD, S[i]);
  } else {
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int m = 0; m < CS; ++m) S[i][m] = 0.0f;
  }
  // this thread's tile of the state to S_T (row-major hd x hd)
  auto store_tile = [&](float* dst) {
    float* p = dst + static_cast<int64_t>(q) * RS * HD + j0;
#pragma unroll
    for (int i = 0; i < RS; ++i) store_cols<CS>(p + i * HD, S[i]);
  };
  // A checkpoint goes through shared memory: each thread's tile into
  // ckbuf[c & 1] at the start of segment c, then, after the next barrier,
  // out to ckpt in whole rows (a warp stores 512 contiguous bytes, where
  // its tiles span 8 rows of 64 bytes: stored from registers, those
  // scattered rows held the loads of the step loop behind them).
  auto ck_row = [&](int i) { return i * HD + 4 * (i / RS); };
  auto stage_checkpoint = [&](int c) {
    float* dst = ckbuf + (c & 1) * L::CKBUF + j0;
#pragma unroll
    for (int i = 0; i < RS; ++i)
      store_cols<CS>(dst + ck_row(q * RS + i), S[i]);
  };
  auto store_checkpoint = [&](int c) {
    const float* src = ckbuf + (c & 1) * L::CKBUF;
    float4* dst =
        reinterpret_cast<float4*>(ckpt + (bh * n_seg + c) * HD * HD);
    for (int x = tid; x < HD * ROW4; x += NT)
      dst[x] = *reinterpret_cast<const float4*>(src + ck_row(x / ROW4) +
                                                4 * (x % ROW4));
  };

  for (int x = tid; x < HD; x += NT) us[x] = u[h * HD + x];
  stage_segment(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  bonus(0);
  if (n_seg > 1) {
    stage_segment(1);
    cp_async_commit();
  }

  // after the reduce-scatter this lane holds y_t[j0 + col]; of the NQ / CS
  // lanes that hold it, the first stores it
  int col = 0;
#pragma unroll
  for (int len = CS, off = NQ / 2; len > 1; len /= 2, off /= 2)
    if (q & off) col += len / 2;
  const bool writer = (q & (NQ / CS - 1)) == 0;

  for (int c = 0; c < n_seg; ++c) {
    // One barrier a segment. Before it: this thread's copies of segment
    // c + 1 have landed. After it: every thread's have, ruks[c & 1],
    // ys[(c - 1) & 1] and ckbuf[(c - 1) & 1] are written, and every thread
    // is done with segment c - 1 (its ring slot and the ruks, ys and
    // ckbuf buffers it read are free again).
    cp_async_wait_all();
    __syncthreads();
    if (c + 2 < n_seg) {
      stage_segment(c + 2);  // into segment c - 1's slot
      cp_async_commit();
    }
    if (c + 1 < n_seg) bonus(c + 1);
    if (c > 0) store_y(c - 1);
    if (CKPT) {
      if (c > 0) store_checkpoint(c - 1);
      stage_checkpoint(c);
    }

    const int len = seg_len(c);
    const float* st = stage + (c % NSTAGE) * L::STAGE;
    const float* ruk = ruks + (c & 1) * CKPT_EVERY;
    float* yrow = ys + (c & 1) * SEG;
#pragma unroll 4
    for (int s = 0; s < len; ++s) {
      const float4* r4 =
          reinterpret_cast<const float4*>(st + IN_R * SEG + s * HD) + q;
      const float4* k4 =
          reinterpret_cast<const float4*>(st + IN_K * SEG + s * HD) + q;
      const float4* w4 =
          reinterpret_cast<const float4*>(st + IN_W * SEG + s * HD) + q;
      const float* vrow = st + IN_V * SEG + s * HD;
      float vv[CS];
      load_cols<CS>(vrow + j0, vv);
      float acc[CS];
#pragma unroll
      for (int m = 0; m < CS; ++m) acc[m] = 0.0f;
#pragma unroll
      for (int m4 = 0; m4 < L::NC4; ++m4) {
        const float4 rq = r4[m4 * NQ], kq = k4[m4 * NQ], wq = w4[m4 * NQ];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int m = 0; m < CS; ++m) {
            float& Sim = S[4 * m4 + e][m];
            const float kv = kk[e] * vv[m];
            acc[m] = fmaf(rr[e], Sim, acc[m]);  // r_t S_{t-1}
            Sim = fmaf(ww[e], Sim, kv);
          }
      }
      reduce_scatter<CS, NQ / 2>(acc, lane);
      if (writer)
        yrow[s * HD + j0 + col] = fmaf(vrow[j0 + col], ruk[s], acc[0]);
    }
  }
  __syncthreads();
  if (CKPT) store_checkpoint(n_seg - 1);
  store_y(n_seg - 1);
  if (s_out != nullptr) store_tile(s_out + bh * HD * HD);
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
                        const float* __restrict__ u,
                        const float* __restrict__ s_in,
                        float* __restrict__ y, float* __restrict__ s_out,
                        float* __restrict__ ckpt, int64_t t_len,
                        int n_heads) {
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

  float S[RS];  // rows row0 .. row0 + RS - 1 of column j: S_0's, or zero
  if (s_in != nullptr) {
    const float* si = s_in + bh * HD * HD + row0 * HD + j;
#pragma unroll
    for (int i = 0; i < RS; ++i) S[i] = si[i * HD];
  } else {
#pragma unroll
    for (int i = 0; i < RS; ++i) S[i] = 0.0f;
  }

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

// Opt a resident kernel in to its shared memory (above 48 KB at hd 64) and
// to the largest shared-memory carveout, so that 2 blocks fit an SM.
template <typename Kernel>
cudaError_t opt_in(Kernel* fn, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The attributes belong to the current device, so this runs at every
// launch: four runtime calls beside a launch of a fraction of a millisecond.
template <int HD>
cudaError_t prepare() {
  if constexpr (HD <= RESIDENT_MAX_HD) {
    cudaError_t e = opt_in(rwkv6_scan_kernel<HD, true>, Resident<HD>::BYTES);
    if (e != cudaSuccess) return e;
    return opt_in(rwkv6_scan_kernel<HD, false>, Resident<HD>::BYTES);
  }
  return cudaSuccess;
}

// The launch of head size HD for bh (b, h) pairs, with checkpoints (as a
// training step runs it): cfg = {blocks, threads a block, dynamic shared
// bytes, resident blocks per SM}.
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
          &per_sm, rwkv6_scan_kernel<HD, true>, L::NT, L::BYTES);
  } else {
    constexpr int NS = HD <= 128 ? 2 : 4;
    cfg[0] = bh * (HD / SPLIT_COLS);
    cfg[1] = SPLIT_COLS * NS;
    cfg[2] = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rwkv6_scan_split_kernel<HD, NS, true>, SPLIT_COLS * NS,
          0);
  }
  cfg[3] = per_sm;
  return e;
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s_in,
                   float* y, float* s_out, float* ckpt, int64_t bh,
                   int64_t t_len, int n_heads, cudaStream_t stream) {
  cudaError_t e = prepare<HD>();
  if (e != cudaSuccess) return e;
  if constexpr (HD <= RESIDENT_MAX_HD) {
    using L = Resident<HD>;
    const unsigned grid = static_cast<unsigned>(bh);
    if (ckpt != nullptr)
      rwkv6_scan_kernel<HD, true><<<grid, L::NT, L::BYTES, stream>>>(
          r, k, v, w, u, s_in, y, s_out, ckpt, t_len, n_heads);
    else
      rwkv6_scan_kernel<HD, false><<<grid, L::NT, L::BYTES, stream>>>(
          r, k, v, w, u, s_in, y, s_out, nullptr, t_len, n_heads);
  } else {
    constexpr int NS = HD <= 128 ? 2 : 4;
    const dim3 grid(static_cast<unsigned>(bh), HD / SPLIT_COLS);
    if (ckpt != nullptr)
      rwkv6_scan_split_kernel<HD, NS, true><<<grid, SPLIT_COLS * NS, 0,
                                              stream>>>(
          r, k, v, w, u, s_in, y, s_out, ckpt, t_len, n_heads);
    else
      rwkv6_scan_split_kernel<HD, NS, false><<<grid, SPLIT_COLS * NS, 0,
                                               stream>>>(
          r, k, v, w, u, s_in, y, s_out, nullptr, t_len, n_heads);
  }
  return cudaGetLastError();
}

}  // namespace

#define RWKV6_HEAD_SIZES(X)                                                 \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)    \
  X(192) X(208) X(224) X(240) X(256)

// The launch that rwkv6_scan_launch makes with checkpoints for (batch,
// n_heads, hd) on the current device: cfg[0] blocks, cfg[1] threads a
// block, cfg[2] dynamic shared bytes, cfg[3] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
extern "C" int rwkv6_scan_launch_config(int64_t batch, int64_t n_heads,
                                        int64_t hd, int64_t* cfg) {
  switch (hd) {
#define RWKV6_CFG(HD) \
  case HD: return static_cast<int>(configure<HD>(batch * n_heads, cfg));
    RWKV6_HEAD_SIZES(RWKV6_CFG)
#undef RWKV6_CFG
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r, k, v, w: (B, H, T, hd) f32 contiguous, 16-byte aligned; u: (H, hd)
// f32; s_in: (B, H, hd, hd) f32, 16-byte aligned, the state S_0 the scan
// starts from, or null (S_0 = 0); y: (B, H, T, hd) f32, 16-byte aligned;
// s_out: (B, H, hd, hd) f32 or null; ckpt: (B, H, ceil(T / RWKV6_CHECKPOINT_EVERY), hd, hd) f32 or null.
// hd is a multiple of 16 from 16 to 256. Returns a cudaError_t (0 =
// success); a shape it does not take returns cudaErrorInvalidValue without
// launching.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* s_in, void* y, void* s_out,
                                 void* ckpt, int64_t batch,
                                 int64_t n_heads, int64_t t_len, int64_t hd,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * n_heads;
  if (bh <= 0 || t_len <= 0 || bh > 0x7fffffff || n_heads > 0x7fffffff ||
      rwkv6_n_checkpoints(t_len) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sif = static_cast<const float*>(s_in);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(s_out);
  auto* cf = static_cast<float*>(ckpt);
  const int nh = static_cast<int>(n_heads);
  switch (hd) {
#define RWKV6_CASE(HD)                                                     \
  case HD:                                                                 \
    return static_cast<int>(                                               \
        launch<HD>(rf, kf, vf, wf, uf, sif, yf, sf, cf, bh, t_len, nh, st));
    RWKV6_HEAD_SIZES(RWKV6_CASE)
#undef RWKV6_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
