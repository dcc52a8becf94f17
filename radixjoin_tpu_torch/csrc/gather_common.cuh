// Shared declarations of the port's gather kernels (window_gather.cu,
// blocked_window_gather.cu, resident_gather.cu; paged_window_gather.cu takes
// the shared-memory opt-in and the bulk-copy helpers from here).
//
// Tables travel to a kernel as a by-value struct of up to RJT_MAX_TABLES
// descriptors (source, destination, length, element size), so one launch
// serves K tables of any mix of 1-, 4- and 8-byte elements that share one
// index stream, without staging the descriptor list in device memory. The
// Python wrappers (radixjoin_tpu_torch/ops/kernels.py) split longer lists
// into several launches.
//
// Row ownership. A warp covers RJT_WARP_ROWS = 128 consecutive output rows,
// and lane l owns two pairs of them: rows 2l, 2l + 1 and 64 + 2l, 64 + 2l + 1
// of the warp's span. One 8-byte load brings a pair's indices, and one
// store writes a pair of a table's values (16 bytes for 8-byte elements, 8
// for 4-byte, 2 for 1-byte), so that every load and store instruction of
// the warp covers one contiguous run of device memory whatever the element
// size. (Four consecutive rows a thread, with one 16-byte index load, made
// the two 16-byte stores of an 8-byte table interleave at a 32-byte
// stride across the warp, each filling half of every sector it touched:
// on an H100, window_gather over 8 int64 tables and 4 Mi rows took 0.25 ms
// that way, 0.17 ms with plain 8-byte stores and 0.16-0.17 ms with this
// layout in the same harness.) Outputs are never read again by the kernel
// and leave with the streaming (evict-first) policy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RJT_MAX_TABLES 16
#define RJT_ROWS 4  // rows a thread owns: an even number
#define RJT_WARP_ROWS (32 * RJT_ROWS)

struct RjtTables {
  const void* in[RJT_MAX_TABLES];
  void* out[RJT_MAX_TABLES];
  long long len[RJT_MAX_TABLES];
  int elem[RJT_MAX_TABLES];  // element size in bytes: 1, 4 or 8
  // byte offset of the table's copy in dynamic shared memory, or -1 for a
  // table that is read from device memory (window_gather.cu)
  int smem_off[RJT_MAX_TABLES];
};

// Dynamic shared memory above the 48 KB default needs an explicit opt-in
// per kernel, up to the card's limit (227 KB a block on Hopper).
template <typename K>
static inline cudaError_t rjt_allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static inline int rjt_pack_tables(RjtTables* tabs, int k,
                                  const void* const* ins, void* const* outs,
                                  const long long* lens, const int* elems) {
  if (k < 1 || k > RJT_MAX_TABLES) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < k; ++t) {
    if (elems[t] != 1 && elems[t] != 4 && elems[t] != 8)
      return (int)cudaErrorInvalidValue;
    tabs->in[t] = ins[t];
    tabs->out[t] = outs[t];
    tabs->len[t] = lens[t];
    tabs->elem[t] = elems[t];
    tabs->smem_off[t] = -1;
  }
  return 0;
}

__device__ __forceinline__ bool rjt_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Staging a table in shared memory with one bulk asynchronous copy
// (cp.async.bulk): one thread initialises an mbarrier (followed by a block
// barrier), announces the bytes that will arrive, issues the copies, and
// every thread waits for the barrier's phase. Source and destination must
// be 16-byte aligned and the size a multiple of 16 bytes. A barrier used
// again completes its phases with parity 0, 1, 0, ...; a buffer that
// threads have read may be refilled by a bulk copy only after a block
// barrier and rjt_fence_proxy_async().
__device__ __forceinline__ uint32_t rjt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void rjt_mbar_init(uint32_t bar_addr) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void rjt_mbar_expect(uint32_t bar_addr,
                                                uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          bar_addr),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void rjt_bulk_copy(void* smem_dst, const void* src,
                                              uint32_t bytes,
                                              uint32_t bar_addr) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(rjt_smem_addr(smem_dst)),
      "l"(src), "r"(bytes), "r"(bar_addr)
      : "memory");
}

// Waits until the barrier's phase of the given parity (0 or 1) completed.
__device__ __forceinline__ void rjt_mbar_wait(uint32_t bar_addr,
                                              uint32_t parity) {
  uint32_t arrived = 0;
  while (!arrived) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(arrived)
        : "r"(bar_addr), "r"(parity)
        : "memory");
  }
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before its later async-proxy ones (a bulk copy into a buffer just read).
__device__ __forceinline__ void rjt_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Row r (0 .. RJT_ROWS - 1) of this thread in the warp span from warp_row0.
__device__ __forceinline__ long long rjt_row(long long warp_row0, int r) {
  return warp_row0 + (r >> 1) * 64 + 2 * (threadIdx.x & 31) + (r & 1);
}

// The indices of this thread's rows, `fill` for rows at or past n: one
// 8-byte streaming load a pair where the stream is 8-byte aligned (`vec`)
// and both rows are real, scalar loads otherwise.
__device__ __forceinline__ void rjt_load_rows(const int32_t* __restrict__ idx,
                                              long long warp_row0,
                                              long long n, bool vec, int fill,
                                              int (&v)[RJT_ROWS]) {
#pragma unroll
  for (int r = 0; r < RJT_ROWS; r += 2) {
    const long long j = rjt_row(warp_row0, r);
    if (vec && j + 2 <= n) {
      const int2 q = __ldcs(reinterpret_cast<const int2*>(idx + j));
      v[r] = q.x;
      v[r + 1] = q.y;
    } else {
      v[r] = j < n ? __ldcs(idx + j) : fill;
      v[r + 1] = j + 1 < n ? __ldcs(idx + j + 1) : fill;
    }
  }
}

// Writes this thread's values to `out`: one store a pair where `out` is
// aligned to a pair of elements and both rows are real.
template <typename T>
__device__ __forceinline__ void rjt_store_rows(T* __restrict__ out,
                                               long long warp_row0,
                                               long long n,
                                               const T (&val)[RJT_ROWS]) {
  const bool vec =
      (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)) == 0;
#pragma unroll
  for (int r = 0; r < RJT_ROWS; r += 2) {
    const long long j = rjt_row(warp_row0, r);
    if (vec && j + 2 <= n) {
      if constexpr (sizeof(T) == 8) {
        __stcs(reinterpret_cast<longlong2*>(out + j),
               make_longlong2((long long)val[r], (long long)val[r + 1]));
      } else if constexpr (sizeof(T) == 4) {
        __stcs(reinterpret_cast<int2*>(out + j),
               make_int2((int)val[r], (int)val[r + 1]));
      } else {
        __stcs(reinterpret_cast<unsigned short*>(out + j),
               (unsigned short)((unsigned int)val[r] |
                                ((unsigned int)val[r + 1] << 8)));
      }
    } else {
      if (j < n) __stcs(out + j, val[r]);
      if (j + 1 < n) __stcs(out + j + 1, val[r + 1]);
    }
  }
}
