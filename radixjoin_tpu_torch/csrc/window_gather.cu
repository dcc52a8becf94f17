// window_gather: out[t][j] = tables[t][idx[j]] for K small tables that share
// one index stream.
//
// Replaces radixjoin_tpu/ops/pallas_kernels.py::window_gather (the K-pass
// Mosaic lane-gather, body _window_gather_kernel), which the join engine
// calls for unique-scatter slot lookups, CSR count/start lookups and payload
// gathers from sources of at most WINDOW_GATHER_MAX = 4096 rows.
//
// What bounds it on the card: device-memory bytes. Every output row costs
// one 4-byte index read, shared by all K tables, and K element writes; the
// tables themselves are small (the engine routes at most 4096 entries here,
// the device-time harness up to WINDOW_GATHER_TABLE_MAX = 16384) and stay
// on chip.
// The design follows from that: each block copies the K tables into shared
// memory once (coalesced), then walks a grid-stride loop in which a thread
// reads one index, reads K shared-memory words and writes K coalesced
// outputs. The grid is capped at a few blocks per SM so that each block's
// table load is paid back over thousands of outputs.
//
// Elements are copied as raw 1-, 4- or 8-byte words, so int32, int64 and
// bool (as uint8) columns all gather natively. Indices are clamped to
// [0, w) on the card: callers pass them clamped already, and the clamp only
// keeps an out-of-contract index inside the table.

#include "gather_common.cuh"

template <typename T>
__global__ void window_gather_kernel(RjtTables tabs, int k, int w,
                                     const int32_t* __restrict__ idx,
                                     long long n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  for (int t = 0; t < k; ++t) {
    const T* src = static_cast<const T*>(tabs.in[t]);
    for (int i = threadIdx.x; i < w; i += blockDim.x) smem[t * w + i] = src[i];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    int i = idx[j];
    i = min(max(i, 0), w - 1);
    for (int t = 0; t < k; ++t) static_cast<T*>(tabs.out[t])[j] = smem[t * w + i];
  }
}

template <typename T>
static int launch_window_gather(const RjtTables& tabs, int k, int w,
                                const int32_t* idx, long long n, int grid,
                                int block, cudaStream_t stream) {
  const size_t smem = (size_t)k * w * sizeof(T);
  cudaError_t err = rjt_allow_smem(window_gather_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  window_gather_kernel<T><<<grid, block, smem, stream>>>(tabs, k, w, idx, n);
  return (int)cudaGetLastError();
}

// Returns 0 or the CUDA error code of the launch.
extern "C" int rjt_window_gather(int device, int elem_bytes, int k,
                                 const void* const* tables, void* const* outs,
                                 int w, const int32_t* idx, long long n,
                                 int grid, int block, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  RjtTables tabs;
  long long lens[RJT_MAX_TABLES];
  for (int t = 0; t < RJT_MAX_TABLES; ++t) lens[t] = w;
  int rc = rjt_pack_tables(&tabs, k, tables, outs, lens);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_window_gather<uint8_t>(tabs, k, w, idx, n, grid, block, s);
    case 4: return launch_window_gather<int32_t>(tabs, k, w, idx, n, grid, block, s);
    case 8: return launch_window_gather<long long>(tabs, k, w, idx, n, grid, block, s);
  }
  return (int)cudaErrorInvalidValue;
}
