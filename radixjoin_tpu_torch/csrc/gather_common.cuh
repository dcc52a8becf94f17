// Shared declarations of the port's gather kernels (window_gather.cu,
// blocked_window_gather.cu, paged_window_gather.cu).
//
// Tables travel to a kernel as a by-value struct of up to RJT_MAX_TABLES
// device pointers, so one launch serves K tables that share one index
// stream without staging the pointer list in device memory. The Python
// wrappers (radixjoin_tpu_torch/ops/kernels.py) split longer lists into
// several launches.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RJT_MAX_TABLES 8

struct RjtTables {
  const void* in[RJT_MAX_TABLES];
  void* out[RJT_MAX_TABLES];
  long long len[RJT_MAX_TABLES];
};

// Dynamic shared memory above the 48 KB default needs an explicit opt-in
// per kernel; the wrappers keep every launch at or below 96 KB.
template <typename K>
static inline cudaError_t rjt_allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static inline int rjt_pack_tables(RjtTables* tabs, int k,
                                  const void* const* ins, void* const* outs,
                                  const long long* lens) {
  if (k < 1 || k > RJT_MAX_TABLES) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < k; ++t) {
    tabs->in[t] = ins[t];
    tabs->out[t] = outs[t];
    tabs->len[t] = lens[t];
  }
  return 0;
}
