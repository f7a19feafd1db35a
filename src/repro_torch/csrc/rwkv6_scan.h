// Shared by csrc/rwkv6_scan.cu and csrc/rwkv6_scan_bwd.cu: when a gradient
// is wanted the forward writes the state every RWKV6_CHECKPOINT_EVERY steps,
// and the backward recomputes each segment of that many steps from it.
// kernels/rwkv/ref.py's CHECKPOINT_EVERY is the same number; each library
// exports it (rwkv6_checkpoint_every) and its loader refuses a mismatch.
#pragma once

#include <stdint.h>

constexpr int RWKV6_CHECKPOINT_EVERY = 16;

// included once per library: each exports its own copy
extern "C" int rwkv6_checkpoint_every() { return RWKV6_CHECKPOINT_EVERY; }

// checkpoints of a T-step scan: ceil(T / RWKV6_CHECKPOINT_EVERY)
__host__ __device__ constexpr int64_t rwkv6_n_checkpoints(int64_t t_len) {
  return (t_len + RWKV6_CHECKPOINT_EVERY - 1) / RWKV6_CHECKPOINT_EVERY;
}
