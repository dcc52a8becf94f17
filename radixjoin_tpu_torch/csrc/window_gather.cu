// window_gather: out[t][j] = tables[t][idx[j]] for K small tables of one
// length w that share one index stream.
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
// on chip. What is scarce is the number of independent reads and stores a
// thread keeps in flight, and the shared memory a block may hold.
//
// The design: one launch serves all K tables of any mix of element sizes.
// A persistent block copies the tables into shared memory once, up to the
// opt-in limit: thread 0 issues one bulk asynchronous copy (cp.async.bulk)
// per table and all threads wait on its mbarrier; a table whose address or
// size is not a multiple of 16 bytes is copied by a scalar loop instead.
// Tables past the budget stay in device memory and are read with
// ld.global.nc (they are a few KB and live in L1 / L2), so no list of
// tables needs a second launch over the index stream. Then each warp walks
// a grid-stride loop over spans of 128 rows, a thread owning two pairs of
// them (gather_common.cuh): two 8-byte index loads, issued one span ahead,
// 4 independent table reads per table, and one streaming store per pair
// and table.
//
// Elements are copied as raw 1-, 4- or 8-byte words, so int32, int64 and
// bool (as uint8) columns all gather natively. Indices are clamped to
// [0, w) on the card: callers pass them clamped already, and the clamp only
// keeps an out-of-contract index inside the table.

#include "gather_common.cuh"

#define RJT_WG_MAX_THREADS 1024

template <typename T>
__device__ __forceinline__ void wg_gather_table(const T* __restrict__ src,
                                                const T* staged, T* out,
                                                const int (&v)[RJT_ROWS],
                                                long long jw, long long n) {
  T val[RJT_ROWS];
  if (staged != nullptr) {
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) val[r] = staged[v[r]];
  } else {
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) val[r] = __ldg(src + v[r]);
  }
  rjt_store_rows<T>(out, jw, n, val);
}

__global__ void __launch_bounds__(RJT_WG_MAX_THREADS)
window_gather_kernel(RjtTables tabs, int k, int w,
                     const int32_t* __restrict__ idx, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;

  // stage the tables that have a place in shared memory
  const uint32_t bar_addr = rjt_smem_addr(&bar);
  if (threadIdx.x == 0) rjt_mbar_init(bar_addr);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t bulk_bytes = 0;
    for (int t = 0; t < k; ++t) {
      const uint32_t bytes = (uint32_t)w * tabs.elem[t];
      if (tabs.smem_off[t] >= 0 && rjt_aligned16(tabs.in[t]) &&
          (bytes & 15) == 0)
        bulk_bytes += bytes;
    }
    rjt_mbar_expect(bar_addr, bulk_bytes);
    for (int t = 0; t < k; ++t) {
      const uint32_t bytes = (uint32_t)w * tabs.elem[t];
      if (tabs.smem_off[t] >= 0 && rjt_aligned16(tabs.in[t]) &&
          (bytes & 15) == 0)
        rjt_bulk_copy(smem + tabs.smem_off[t], tabs.in[t], bytes, bar_addr);
    }
  }
  for (int t = 0; t < k; ++t) {
    const int bytes = w * tabs.elem[t];
    if (tabs.smem_off[t] >= 0 &&
        !(rjt_aligned16(tabs.in[t]) && (bytes & 15) == 0)) {
      const unsigned char* src = static_cast<const unsigned char*>(tabs.in[t]);
      unsigned char* dst = smem + tabs.smem_off[t];
      if (tabs.elem[t] == 8) {
        for (int i = threadIdx.x; i < w; i += blockDim.x)
          reinterpret_cast<long long*>(dst)[i] =
              reinterpret_cast<const long long*>(src)[i];
      } else if (tabs.elem[t] == 4) {
        for (int i = threadIdx.x; i < w; i += blockDim.x)
          reinterpret_cast<int32_t*>(dst)[i] =
              reinterpret_cast<const int32_t*>(src)[i];
      } else {
        for (int i = threadIdx.x; i < w; i += blockDim.x) dst[i] = src[i];
      }
    }
  }
  rjt_mbar_wait(bar_addr, 0);
  __syncthreads();

  const bool idx_vec = (reinterpret_cast<uintptr_t>(idx) & 7) == 0;
  const int warps = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps * RJT_WARP_ROWS;
  long long jw =
      ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * RJT_WARP_ROWS;
  int v[RJT_ROWS];
  if (jw < n) rjt_load_rows(idx, jw, n, idx_vec, 0, v);
  for (; jw < n; jw += stride) {
    // the next span's indices are on their way while this one is gathered
    int vn[RJT_ROWS];
    if (jw + stride < n) rjt_load_rows(idx, jw + stride, n, idx_vec, 0, vn);
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) v[r] = min(max(v[r], 0), w - 1);
    for (int t = 0; t < k; ++t) {
      const unsigned char* staged =
          tabs.smem_off[t] >= 0 ? smem + tabs.smem_off[t] : nullptr;
      switch (tabs.elem[t]) {
        case 8:
          wg_gather_table<long long>(
              static_cast<const long long*>(tabs.in[t]),
              reinterpret_cast<const long long*>(staged),
              static_cast<long long*>(tabs.out[t]), v, jw, n);
          break;
        case 4:
          wg_gather_table<int32_t>(
              static_cast<const int32_t*>(tabs.in[t]),
              reinterpret_cast<const int32_t*>(staged),
              static_cast<int32_t*>(tabs.out[t]), v, jw, n);
          break;
        default:
          wg_gather_table<uint8_t>(static_cast<const uint8_t*>(tabs.in[t]),
                                   staged,
                                   static_cast<uint8_t*>(tabs.out[t]), v, jw,
                                   n);
      }
    }
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) v[r] = vn[r];
  }
}

// One launch for k <= RJT_MAX_TABLES tables of w entries each, of any mix
// of element sizes (elems[t] in {1, 4, 8}). smem_offs[t] is the 16-byte
// aligned place of table t in the ``smem_bytes`` of dynamic shared memory,
// or -1 for a table left in device memory. Returns 0 or the CUDA error code
// of the launch.
extern "C" int rjt_window_gather(int device, int k, const void* const* tables,
                                 void* const* outs, const int* elems,
                                 const int* smem_offs, int smem_bytes, int w,
                                 const int32_t* idx, long long n,
                                 int sm_count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  RjtTables tabs;
  long long lens[RJT_MAX_TABLES];
  for (int t = 0; t < RJT_MAX_TABLES; ++t) lens[t] = w;
  int rc = rjt_pack_tables(&tabs, k, tables, outs, lens, elems);
  if (rc) return rc;
  for (int t = 0; t < k; ++t) {
    const int off = smem_offs[t];
    if (off >= 0 && ((off & 15) != 0 || off + w * elems[t] > smem_bytes))
      return (int)cudaErrorInvalidValue;
    tabs.smem_off[t] = off;
  }
  err = rjt_allow_smem(window_gather_kernel, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // the most threads a block may have while two blocks still share an SM;
  // a block that fills the SM's shared memory alone takes all 1024
  const int block = smem_bytes > 100 * 1024 ? RJT_WG_MAX_THREADS : 512;
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, window_gather_kernel, block, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long rows_per_block = (long long)block * RJT_ROWS;
  const long long want = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)per_sm * sm_count;
  const int grid = (int)(want < cap ? want : cap);
  window_gather_kernel<<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
      tabs, k, w, idx, n);
  return (int)cudaGetLastError();
}
