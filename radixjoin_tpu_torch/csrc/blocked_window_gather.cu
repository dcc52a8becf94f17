// blocked_window_gather_multi: vals[t][j] = tables[t][idx[j]] on a monotone
// (block-windowed) index stream, plus the window-hit flag ok[j].
//
// Replaces radixjoin_tpu/ops/pallas_kernels.py::blocked_window_gather_multi
// (body _bwg_kernel). The join engine calls it for the CSR / device-CSR
// expansion lookups on the monotone owner stream pidx and for every payload
// column gathered along that stream.
//
// Semantics kept from the TPU kernel, bit for bit:
//   * each block of 1024 consecutive outputs picks the window start
//     clip(min(idx in block) // 1024, 0, kmax - 1) * 1024 with
//     kmax = ceil(longest table / 1024), and covers 2048 entries from there;
//   * ok[j] = 1 iff idx[j] lies in its block's window;
//   * a table shorter than the longest reads 0 past its end (the TPU kernel
//     zero-pads the tables to the longest);
//   * a ragged last block takes its minimum over its real rows only, which
//     equals the TPU kernel's minimum over the edge-padded index tail.
//
// The TPU caller patches ok = 0 rows with a second, full gather behind a
// lax.cond. Eager PyTorch has no lax.cond, and a host sync on the miss
// count would stall the stream, so this kernel patches in place: a missed
// row reads its value straight from device memory (through L2). vals is
// therefore already the final tables[t][idx[j]] everywhere, and ok is
// still returned for parity and diagnosis.
//
// What bounds it on the card: device-memory bytes. Per output row it reads
// one 4-byte index and writes K elements plus the 4-byte flag; the window
// reads add 2048 elements per table per block, i.e. about two elements per
// output. The design: one block per 1024 outputs, one thread per output;
// the block reduces its own window start with warp shuffles (the TPU kernel
// needed a scalar-prefetch pass for it), stages each table's 2048-entry
// window in shared memory with coalesced loads, and gathers from there.

#include <climits>

#include "gather_common.cuh"

#define RJT_BWG_BLK 1024
#define RJT_BWG_WIN 1024
#define RJT_BWG_SPAN (2 * RJT_BWG_WIN)

template <typename T>
__global__ void __launch_bounds__(RJT_BWG_BLK)
bwg_kernel(RjtTables tabs, int k, const int32_t* __restrict__ idx,
           long long n, long long kmax, int32_t* __restrict__ ok_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  __shared__ int warp_min[RJT_BWG_BLK / 32];
  __shared__ long long s_base;

  const long long j = (long long)blockIdx.x * RJT_BWG_BLK + threadIdx.x;
  const bool real = j < n;
  const int v = real ? idx[j] : INT_MAX;

  // block minimum: warp shuffles, then the first warp over the warp minima
  int m = v;
  for (int off = 16; off > 0; off >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_min[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) {
      // truncating and flooring division differ only for m < 0, where the
      // clamp below sends both to 0
      long long q = m / RJT_BWG_WIN;
      const long long hi = kmax - 1 > 0 ? kmax - 1 : 0;
      q = q < 0 ? 0 : (q > hi ? hi : q);
      s_base = q * RJT_BWG_WIN;
    }
  }
  __syncthreads();
  const long long base = s_base;

  for (int t = 0; t < k; ++t) {
    const T* src = static_cast<const T*>(tabs.in[t]);
    const long long len = tabs.len[t];
    for (int i = threadIdx.x; i < RJT_BWG_SPAN; i += blockDim.x) {
      const long long p = base + i;
      win[t * RJT_BWG_SPAN + i] = p < len ? src[p] : T(0);
    }
  }
  __syncthreads();
  if (!real) return;

  const long long rel = (long long)v - base;
  const bool ok = rel >= 0 && rel < RJT_BWG_SPAN;
  for (int t = 0; t < k; ++t) {
    T val;
    if (ok) {
      val = win[t * RJT_BWG_SPAN + (int)rel];
    } else {
      const T* src = static_cast<const T*>(tabs.in[t]);
      const long long len = tabs.len[t];
      const long long p = v < 0 ? 0 : (v >= len ? len - 1 : (long long)v);
      val = src[p];
    }
    static_cast<T*>(tabs.out[t])[j] = val;
  }
  if (ok_out != nullptr) ok_out[j] = ok ? 1 : 0;
}

template <typename T>
static int launch_bwg(const RjtTables& tabs, int k, const int32_t* idx,
                      long long n, long long kmax, int32_t* ok,
                      cudaStream_t stream) {
  const size_t smem = (size_t)k * RJT_BWG_SPAN * sizeof(T);
  cudaError_t err = rjt_allow_smem(bwg_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + RJT_BWG_BLK - 1) / RJT_BWG_BLK;
  bwg_kernel<T><<<(unsigned int)grid, RJT_BWG_BLK, smem, stream>>>(
      tabs, k, idx, n, kmax, ok);
  return (int)cudaGetLastError();
}

// ``ok`` may be null (a later launch over more tables of the same stream
// need not rewrite the flags). Returns 0 or the CUDA error code.
extern "C" int rjt_blocked_window_gather(int device, int elem_bytes, int k,
                                         const void* const* tables,
                                         void* const* outs,
                                         const long long* lens,
                                         const int32_t* idx, long long n,
                                         long long kmax, int32_t* ok,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  RjtTables tabs;
  int rc = rjt_pack_tables(&tabs, k, tables, outs, lens);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_bwg<uint8_t>(tabs, k, idx, n, kmax, ok, s);
    case 4: return launch_bwg<int32_t>(tabs, k, idx, n, kmax, ok, s);
    case 8: return launch_bwg<long long>(tabs, k, idx, n, kmax, ok, s);
  }
  return (int)cudaErrorInvalidValue;
}
