// Flash attention forward for Hopper (sm_90a) on the tensor cores:
// online-softmax attention with causal and sliding-window masks, f32 or
// bf16 in and out, f32 softmax state.
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
// the reference does (with -inf that row would become NaN). A row that no
// key may see at all (a window with Sk < S) comes out as the mean of the
// values of the key tiles its block does not skip, rows past Sk counted as
// zeros, or as 0 when the block skips every tile; the plain version gives
// the mean of all Sk values there (ROADMAP, queue 3). Positions are
// absolute, also when Sk != S.
//
// Arithmetic: both products on the tensor cores with mma.sync (valid on
// sm_90a), f32 accumulators.
// - float32, 3xTF32 on m16n8k8: each operand x is split into hi = x rounded
//   to TF32 (to nearest, ties away: cvt.rna.tf32 done as two integer
//   operations) and lo = x - hi, exact in f32 and read by the MMA truncated
//   to TF32, so hi + lo is x to 2^-21 relative; a.b is taken as
//   a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the lo.lo term, ~2^-21 relative, is
//   dropped). Emulated on the CPU (tests/test_torch_flash_tf32.py), one
//   TF32 pass is 8.5e-4 to 1.0e-3 from float32 attention at standard
//   normal inputs (S 257 and 1024, D 64, causal), over the 2e-5 the
//   reference holds the kernel to; 3xTF32 is within 1.2e-6 over the CPU
//   sweep; on the card the kernel is within ~7e-6 of its plain version
//   (chip_smoke.py). q * scale is computed once per block; the q, k, v and
//   p fragments are split in registers as they are used (holding q's hi
//   and lo would double its registers).
// - bfloat16: m16n8k16 bf16 for q k^T, the product scaled by f32(1/sqrt(D))
//   in f32 (q * scale rounded to bf16 would change the input); p rounded to
//   bf16 for p v, as flash kernels do.
// - exp is exp2(x log2 e) (one MUFU.EX2), exact at x = 0.
//
// Layout. One block per (b*h, tile of BQ query rows; BQ = 128, or 64 for
// f32 at D > 208), launched last tile first, so that under a causal mask
// the blocks that see the most keys are scheduled first and do not form the
// tail. Each warp owns 32 rows (two m16 tiles, f32 at D <= 64: 4 warps,
// each k and v fragment split once for both) or 16 rows (f32 at D > 64 and
// bf16: BQ / 16 warps). A loop over 64-key tiles inside the block takes the
// place of the TPU's sequential nk grid axis. K and V tiles are copied with
// 16-byte cp.async into two shared-memory stages, tile k+1 in flight while
// tile k is multiplied; rows past Sk (and q rows past S) are zero-filled by
// the copy (src-size 0) and masked by position, and only tiles that cross a
// mask edge are masked per element. Under a causal mask with no window a
// warp leaves out a tile its block loads when all its keys lie after the
// warp's last row (no row of the warp can be all masked then). The score
// fragment stays in registers and feeds p v without a trip through shared
// memory:
// - f32: the m16n8k8 C fragment holds key columns (2t, 2t+1) where the A
//   fragment wants (t, t+4). The sum over keys does not care about their
//   order, so key 2t of a tile is taken as k-index t and key 2t+1 as t+4,
//   in p and in the rows of v alike: no shuffle. The same permutation of
//   the head dim makes the q and k fragment loads 8-byte loads.
// - bf16: the m16n8k16 C fragment is the A fragment's layout already.
// Shared rows are padded so that fragment loads hit distinct banks: f32 q
// and k rows D+8 floats, v rows D+4, bf16 rows D+8. Shared memory: f32
// D=64 106 KB (two blocks an SM), D=128 202 KB (one); bf16 D=64 54 KB,
// D=256 198 KB. Dynamic shared memory, opted in at every launch.
//
// Head dims above 128 (pixtral-12b's 160). In f32 two stages of k and v do
// not fit beside a 128-row q tile (D=160: 250 KB of the 227 KB a block may
// have), so at D > 128 the f32 kernel keeps ONE stage of k and one of v and
// overlaps them with each other: v of tile kt is copied while q k^T of tile
// kt runs, k of tile kt+1 while p v of tile kt runs (D=160: 167 KB; D=208:
// 215 KB). From D = 224 the q tile is 64 rows (4 warps; D=256: 197 KB). p v
// splits the output's n-tiles 8 at a time there, so that one k-step's v
// fragments (2 x 4 registers an n-tile) are not all live beside the
// accumulator (D/2 registers). bf16 keeps two stages and 128 rows at every
// D; its q fragments (D/4 registers) stay in registers. Registers a thread
// of the new instantiations (nvcc 12.8 -Xptxas -v, as chip_smoke.py prints
// them), f32 / bf16:
//   D     144  160  176  192  208  224  240  256
//   f32   176  175  196  206  211  248  235  232   no spills
//   bf16  220  229  240  250  255  255  255  255   spills at 240 (8 B
//         stores, 16 B loads) and 256 (84 B stores, 44 B loads, 32 B
//         stack): q's 64 fragment registers beside a 128-register
//         accumulator; no path runs bf16 above 160.
//
// Bound: at the split LM's shape (B 8, H 9, S = Sk = 1024, D 64, f32,
// causal) the two products take 2*B*H*D*S*(S+1) = 9.67 GFLOP (the causal
// half of each); in 3xTF32 that is 29.0 GFLOP of TF32 at 495 TFLOP/s,
// 0.0586 ms; q, k, v and out are 75.5 MB, 22.5 us at 3.35 TB/s. So it is
// bound by operations on the tensor cores. What still holds it back (its
// times are in PERF.md): the splits, exps, masks and address arithmetic
// issue about four instructions per MMA from the same warps; every warp
// re-reads and re-splits the whole k and v tile; and mma.sync reaches a
// part of the tensor-core rate that only wgmma (B from shared memory, a
// warpgroup per 64 rows) reaches in full.
//
// C interface for ctypes: the launch goes on the caller's stream, nothing
// is allocated here, and the return value is cudaGetLastError() (or
// cudaErrorInvalidValue for a head dim or a length it does not take).
// q, k, v and out must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // keys per tile
constexpr int kNT = kBK / 8;   // n-tiles of 8 keys in a score tile
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxShared = 232448;  // the opt-in limit a block, sm_90

// Per dtype and head dim: the query rows of a block (BQ), its threads (f32:
// MT m16 tiles of 16 query rows per warp, BQ / (16 MT) warps; bf16: one m16
// tile per warp), the stages of k and v, and the shared-memory rows, padded
// so that fragment loads hit distinct banks.
template <typename T, int D>
struct Cfg;
template <int D>
struct Cfg<float, D> {
  static constexpr int BQ = D <= 208 ? 128 : 64;
  static constexpr int MT = D <= 64 ? 2 : 1;
  static constexpr int kThreads = 32 * BQ / (16 * MT);
  // D > 128: one k and one v stage, copied in turns (the note above)
  static constexpr bool kSplitKV = D > 128;
  static constexpr int kStages = kSplitKV ? 1 : 2;
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = D + 4;
  static constexpr size_t bytes =
      sizeof(float) * (BQ * LDQ + kStages * kBK * (LDK + LDV));
  static_assert(bytes <= kMaxShared, "f32 tiles exceed shared memory");
};
template <int D>
struct Cfg<__nv_bfloat16, D> {
  static constexpr int BQ = 128;
  static constexpr int kThreads = 32 * BQ / 16;
  static constexpr int LD = D + 8;
  static constexpr size_t bytes = sizeof(uint16_t) * (BQ + 4 * kBK) * LD;
  static_assert(bytes <= kMaxShared, "bf16 tiles exceed shared memory");
};

// ---- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo for the tensor cores: hi is x rounded to TF32, to nearest
// with ties away from zero (cvt.rna.tf32.f32 on the bits: add half a TF32
// ulp to the magnitude, clear the 13 low bits: two integer operations,
// where cvt.rna adds a test for inf and NaN that these inputs never need),
// and
// lo = x - hi exactly in f32, passed unrounded: the MMA reads the top 19
// bits of a .tf32 operand, so it takes lo truncated to TF32 and
// hi + lo reproduces x to 2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: m16n8k8, tf32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32 over N n-tiles, into c[j0 + j] for j0 + j < M (j0 is a constant
// once the caller's loop is unrolled): c[j0 + j] += a_lo b_hi[j] +
// a_hi b_lo[j] + a_hi b_hi[j], the small terms first, one pass over j per
// term so that N independent MMAs stand between two that add into the same
// accumulator
template <int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][4], int j0,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j0 + j < M) mma_tf32(c[j0 + j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j0 + j < M) mma_tf32(c[j0 + j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j0 + j < M) mma_tf32(c[j0 + j], ah, bh[j]);
}
// c += a b: m16n8k16, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// exp(x) for x <= 0 as exp2(x log2 e): one MUFU.EX2 and its denormal fix-up
// where expf takes a longer range reduction; x = 0 (a row whose scores are
// all the finite NEG_INF so far) still gives exactly 1
__device__ __forceinline__ float exp_(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// ---- shared pieces of both kernels

// Copy rows [row0, row0 + ROWS) of a (rows, D) array into shared memory
// with row stride LD elements, 16 bytes per cp.async, by NTHREADS threads;
// rows at or past `nrows` are zero-filled.
template <typename T, int D, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int nrows) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = D / kChunk;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NTHREADS) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    const bool in = row0 + r < nrows;
    const T* g = in ? src + (int64_t)(row0 + r) * D + c : src;
    cp_async16(dst + r * LD + c, g, in ? 16 : 0);
  }
}

// The key tiles [begin, end) a block of query rows [q_lo, q_lo + BQ)
// sees: the reference's tile-skip rules (causal: no key past the block's
// last query; window: no key tile wholly before q_lo - window + 1).
template <int BQ>
__device__ __forceinline__ void key_tiles(int q_lo, int Sk, int causal,
                                          int window, int& begin, int& end) {
  const int nk = (Sk + kBK - 1) / kBK;
  end = causal ? min(nk, (q_lo + BQ - 1) / kBK + 1) : nk;
  begin = 0;
  if (window >= 0) {
    const int x = q_lo - window - kBK + 1;  // skip tile kt iff kt*kBK <= x
    if (x >= 0) begin = x / kBK + 1;
  }
}

// True when some score of the key tile may be masked for some query row in
// [r_first, r_last]
__device__ __forceinline__ bool tile_needs_mask(int r_first, int r_last,
                                                int k_lo, int Sk, int causal,
                                                int window) {
  return k_lo + kBK > Sk || (causal && k_lo + kBK - 1 > r_first) ||
         (window >= 0 && r_last - k_lo >= window);
}

// True when a warp with query rows [r_first, r_last] can leave out a key
// tile the block loads: under a causal mask with no window every row sees
// key 0 and no key of the tile, so the tile changes none of its rows. (A
// window can mask a row everywhere; such rows take the tile's exp(0) terms,
// so the warp computes every tile of its block.)
__device__ __forceinline__ bool warp_skips(int r_last, int k_lo, int causal,
                                           int window) {
  return causal && window < 0 && k_lo > r_last;
}

// One online-softmax step on the score fragment of a 16-row x 64-key
// tile. This thread holds rows r0 and r0 + 8 (s[j][0..1] and s[j][2..3])
// and keys k0 + 8j, k0 + 8j + 1 of n-tile j. Masks, takes the new row
// maxima over the quad, turns s into exp(s - m_new), folds the row sums
// into this thread's partial l, and returns alpha = exp(m_old - m_new).
__device__ __forceinline__ void online_softmax(float (&s)[kNT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int r0,
                                               int k0, int Sk, int causal,
                                               int window, bool mask) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = r0 + (e >> 1) * 8;
        const int kpos = k0 + 8 * j + (e & 1);
        bool ok = kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && qpos - kpos < window;
        if (!ok) s[j][e] = kNegInf;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = exp_(m[r] - mx);
    m[r] = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][2 * r] = exp_(s[j][2 * r] - mx);
      s[j][2 * r + 1] = exp_(s[j][2 * r + 1] - mx);
      rs += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + rs;
  }
}

// acc *= alpha per row (rows r0 and r0 + 8)
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// The row sums over the quad and out = acc / max(l, 1e-30) for rows r0 and
// r0 + 8 that are below S; `store(row, col, a, b)` writes columns col and
// col + 1.
template <int N, typename Store>
__device__ __forceinline__ void finish(const float (&acc)[N][4],
                                       const float (&l)[2], int r0, int t,
                                       int S, Store store) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int j = 0; j < N; ++j)
      store(row, 8 * j + 2 * t, acc[j][2 * r] / denom,
            acc[j][2 * r + 1] / denom);
  }
}

// ---- float32: 3xTF32

template <int D>
__global__ void __launch_bounds__(Cfg<float, D>::kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
              int Sk, float scale, int causal, int window) {
  using C = Cfg<float, D>;
  constexpr int MT = C::MT, NTH = C::kThreads, BQ = C::BQ;
  constexpr bool kSplit = C::kSplitKV;
  constexpr int KS = D / 8;  // k-steps of q k^T
  constexpr int NO = D / 8;  // n-tiles of the output
  // output n-tiles a pass of p v (the last pass of D = 144, 176, 208, 240
  // takes the remaining 2 or 6)
  constexpr int NC = D > 128 ? 8 : NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][LDQ]: q * scale
  float* sK = sQ + BQ * C::LDQ;                     // [kStages][kBK][LDK]
  float* sV = sK + C::kStages * kBK * C::LDK;       // [kStages][kBK][LDV]

  const int64_t bh = blockIdx.x;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16 * MT;              // the warp's rows in the block
  const int r_first = q_lo + rw, r_last = r_first + 16 * MT - 1;

  int kt_begin, kt_end;
  key_tiles<BQ>(q_lo, Sk, causal, window, kt_begin, kt_end);
  auto load_k = [&](int kt, int st) {
    if (kt < kt_end)
      load_tile<float, D, C::LDK, kBK, NTH>(sK + st * kBK * C::LDK, kb,
                                            kt * kBK, Sk);
  };
  auto load_v = [&](int kt, int st) {
    if (kt < kt_end)
      load_tile<float, D, C::LDV, kBK, NTH>(sV + st * kBK * C::LDV, vb,
                                            kt * kBK, Sk);
  };
  // q and the first key tile in one group; then the second tile (two
  // stages) or the first tile's v (one stage) in the next
  load_tile<float, D, C::LDQ, BQ, NTH>(sQ, qb, q_lo, S);
  load_k(kt_begin, 0);
  if constexpr (kSplit) {
    cp_async_commit();
    load_v(kt_begin, 0);
  } else {
    load_v(kt_begin, 0);
    cp_async_commit();
    load_k(kt_begin + 1, 1);
    load_v(kt_begin + 1, 1);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // q * scale once, in place, each warp its own rows
  for (int i = lane; i < 16 * MT * D; i += 32) {
    float* x = sQ + (rw + i / D) * C::LDQ + i % D;
    *x *= scale;
  }
  __syncwarp();

  float acc[MT][NO][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = kSplit ? 0 : (kt - kt_begin) & 1;
    if (!kSplit && kt > kt_begin) {
      cp_async_wait<1>();  // tile kt has landed
      __syncthreads();
    }
    const float* cK = sK + st * kBK * C::LDK;
    const float* cV = sV + st * kBK * C::LDV;
    const int k_lo = kt * kBK;
    const bool live = !warp_skips(r_last, k_lo, causal, window);

    // s = (q * scale) k^T; the head dim permuted within each k-step:
    // k-index t is column 8ks + 2t, t + 4 is 8ks + 2t + 1
    float s[MT][kNT][4];
    if (live) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* qr = sQ + (rw + 16 * mt + g) * C::LDQ + 8 * ks + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(qr);
          const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * C::LDQ);
          split_tf32(x0.x, ah[mt][0], al[mt][0]);
          split_tf32(x1.x, ah[mt][1], al[mt][1]);
          split_tf32(x0.y, ah[mt][2], al[mt][2]);
          split_tf32(x1.y, ah[mt][3], al[mt][3]);
        }
        uint32_t bh_[kNT][2], bl_[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              cK + (8 * j + g) * C::LDK + 8 * ks + 2 * t);
          split_tf32(kv.x, bh_[j][0], bl_[j][0]);
          split_tf32(kv.y, bh_[j][1], bl_[j][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(s[mt], 0, ah[mt], al[mt], bh_, bl_);
      }
    }

    if constexpr (kSplit) {
      __syncthreads();     // every warp is done with k of tile kt
      load_k(kt + 1, 0);   // in flight while p v of tile kt runs
      cp_async_commit();
      cp_async_wait<1>();  // v of tile kt has landed
      __syncthreads();
    }

    if (live) {
      const bool mask =
          tile_needs_mask(r_first, r_last, k_lo, Sk, causal, window);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float alpha[2];
        online_softmax(s[mt], m[mt], l[mt], alpha, r_first + 16 * mt + g,
                       k_lo + 2 * t, Sk, causal, window, mask);
        rescale(acc[mt], alpha);
      }

      // acc += p v, keys permuted: k-index t is key 8kk + 2t, t + 4 is
      // 8kk + 2t + 1, which is where the C fragment of s holds them
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(s[mt][kk][0], ph[mt][0], pl[mt][0]);
          split_tf32(s[mt][kk][2], ph[mt][1], pl[mt][1]);
          split_tf32(s[mt][kk][1], ph[mt][2], pl[mt][2]);
          split_tf32(s[mt][kk][3], ph[mt][3], pl[mt][3]);
        }
        const float* vr = cV + (8 * kk + 2 * t) * C::LDV + g;
#pragma unroll
        for (int j0 = 0; j0 < NO; j0 += NC) {
          uint32_t bh_[NC][2], bl_[NC][2];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            if (j0 + j >= NO) continue;
            split_tf32(vr[8 * (j0 + j)], bh_[j][0], bl_[j][0]);
            split_tf32(vr[C::LDV + 8 * (j0 + j)], bh_[j][1], bl_[j][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(acc[mt], j0, ph[mt], pl[mt], bh_, bl_);
        }
      }
    }

    __syncthreads();  // every warp is done with stage st
    if constexpr (kSplit) {
      load_v(kt + 1, 0);   // in flight while q k^T of tile kt + 1 runs
      cp_async_commit();
      cp_async_wait<1>();  // k of tile kt + 1 has landed
      __syncthreads();
    } else {
      load_k(kt + 2, st);
      load_v(kt + 2, st);
      cp_async_commit();
    }
  }

  float* ob = out + bh * S * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    finish(acc[mt], l[mt], r_first + 16 * mt + g, t, S,
           [&](int row, int col, float a, float b) {
             *reinterpret_cast<float2*>(ob + (int64_t)row * D + col) =
                 make_float2(a, b);
           });
}

// ---- bfloat16

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(Cfg<__nv_bfloat16, D>::kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int S, int Sk, float scale,
               int causal, int window) {
  using C = Cfg<__nv_bfloat16, D>;
  constexpr int LD = C::LD, NTH = C::kThreads, BQ = C::BQ;
  constexpr int KS = D / 16;  // k-steps of q k^T
  constexpr int NO = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);  // [BQ][LD]
  uint16_t* sK = sQ + BQ * LD;                            // [2][kBK][LD]
  uint16_t* sV = sK + 2 * kBK * LD;                       // [2][kBK][LD]

  const int64_t bh = blockIdx.x;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) + bh * S * D;
  const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + bh * Sk * D;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + bh * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  const int r_first = q_lo + rw, r_last = r_first + 15;

  int kt_begin, kt_end;
  key_tiles<BQ>(q_lo, Sk, causal, window, kt_begin, kt_end);
  auto load_kv = [&](int kt, int st) {
    if (kt < kt_end) {
      load_tile<uint16_t, D, LD, kBK, NTH>(sK + st * kBK * LD, kb, kt * kBK,
                                           Sk);
      load_tile<uint16_t, D, LD, kBK, NTH>(sV + st * kBK * LD, vb, kt * kBK,
                                           Sk);
    }
    cp_async_commit();
  };
  load_tile<uint16_t, D, LD, BQ, NTH>(sQ, qb, q_lo, S);
  load_kv(kt_begin, 0);
  load_kv(kt_begin + 1, 1);
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qa[KS][4];
  {
    const uint16_t* qr = sQ + (rw + g) * LD + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = ld32(qr + 16 * ks);
      qa[ks][1] = ld32(qr + 8 * LD + 16 * ks);
      qa[ks][2] = ld32(qr + 16 * ks + 8);
      qa[ks][3] = ld32(qr + 8 * LD + 16 * ks + 8);
    }
  }

  float acc[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt > kt_begin) {
      cp_async_wait<1>();
      __syncthreads();
    }
    const uint16_t* cK = sK + st * kBK * LD;
    const uint16_t* cV = sV + st * kBK * LD;
    const int k_lo = kt * kBK;

    if (!warp_skips(r_last, k_lo, causal, window)) {
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const uint16_t* kr = cK + (8 * j + g) * LD + 16 * ks + 2 * t;
          const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
          mma_bf16(s[j], qa[ks], b);
        }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;

      float alpha[2];
      online_softmax(
          s, m, l, alpha, r_first + g, k_lo + 2 * t, Sk, causal, window,
          tile_needs_mask(r_first, r_last, k_lo, Sk, causal, window));
      rescale(acc, alpha);

      // acc += p v over k-steps of 16 keys (score n-tiles 2kk and 2kk + 1)
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint16_t* vr = cV + (16 * kk + 2 * t) * LD + g;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const uint32_t b[2] = {
              vr[8 * j] | ((uint32_t)vr[LD + 8 * j] << 16),
              vr[8 * LD + 8 * j] | ((uint32_t)vr[9 * LD + 8 * j] << 16)};
          mma_bf16(acc[j], pa, b);
        }
      }
    }

    __syncthreads();
    load_kv(kt + 2, st);
  }

  __nv_bfloat16* ob = out + bh * S * D;
  finish(acc, l, r_first + g, t, S, [&](int row, int col, float a, float b) {
    *reinterpret_cast<uint32_t*>(ob + (int64_t)row * D + col) =
        pack_bf16(a, b);
  });
}

// ---- launch

// Opt in to > 48 KB of shared memory and launch. The attribute belongs to
// the current device, so it is set at every launch (one runtime call beside
// a kernel of ~0.1 ms) rather than once per process. The grid's y extent is
// one block row per BQ query rows, at most 65535.
template <typename T, int D, typename Kernel>
cudaError_t launch(Kernel kernel, const void* q, const void* k, const void* v,
                   void* out, int64_t BH, int S, int Sk, float scale,
                   int causal, int window, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int tiles = (S + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)BH, (unsigned)tiles);
  kernel<<<grid, C::kThreads, C::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Sk, scale, causal,
      window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v,
                     void* out, int64_t BH, int S, int Sk, float scale,
                     int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(flash_fwd_f32<D>, q, k, v, out, BH, S, Sk, scale,
                            causal, window, stream);
  return launch<__nv_bfloat16, D>(flash_fwd_bf16<D>, q, k, v, out, BH, S, Sk,
                                  scale, causal, window, stream);
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
  // positions are int inside the kernel; launch() checks the grid's y
  if (B * H <= 0 || B * H > 0x7fffffffLL || S <= 0 || Sk <= 0 ||
      S > (1LL << 30) || Sk > (1LL << 30) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
#define FLASH_CASE(d)                                                        \
  case d:                                                                    \
    return (int)launch_d<d>(dtype, q, k, v, out, B * H, (int)S, (int)Sk,     \
                            scale, causal, window, st);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    FLASH_CASE(144)
    FLASH_CASE(160)
    FLASH_CASE(176)
    FLASH_CASE(192)
    FLASH_CASE(208)
    FLASH_CASE(224)
    FLASH_CASE(240)
    FLASH_CASE(256)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
