// blocked_window_gather_multi: vals[t][j] = tables[t][idx[j]] on a monotone
// (block-windowed) index stream, plus the window-hit flag ok[j].
//
// Replaces radixjoin_tpu/ops/pallas_kernels.py::blocked_window_gather_multi
// (body _bwg_kernel). The join engine calls it for the CSR / device-CSR
// expansion lookups on the monotone owner stream pidx and for every payload
// column gathered along that stream.
//
// Semantics kept from the TPU kernel, bit for bit:
//   * each tile of 1024 consecutive outputs picks the window start
//     clip(min(idx in tile) // 1024, 0, kmax - 1) * 1024 with
//     kmax = ceil(longest table / 1024), and covers 2048 entries from there;
//   * ok[j] = 1 iff idx[j] lies in its tile's window;
//   * a table shorter than the longest reads 0 past its end inside the
//     window (the TPU kernel zero-pads the tables to the longest);
//   * a ragged last tile takes its minimum over its real rows only, which
//     equals the TPU kernel's minimum over the edge-padded index tail.
//
// The TPU caller patches ok = 0 rows with a second, full gather behind a
// lax.cond. Eager PyTorch has no lax.cond, and a host sync on the miss
// count would stall the stream, so this kernel patches in place: a missed
// row reads its value straight from device memory. vals is therefore
// already the final tables[t][idx[j]] everywhere, and ok (optional: a null
// pointer skips it) is still produced for parity and diagnosis.
//
// What bounds it on the card: device-memory bytes. Per output row it reads
// one 4-byte index and writes one element per table plus the 4-byte flag;
// the table entries a monotone stream touches are read once.
//
// The design stages nothing: a monotone stream reads neighbouring entries,
// which coalesce in L1, so every thread reads its entries with
// ld.global.nc, and the window only decides ok and the zero pad. (A variant
// that copied what a tile reads of each table into a two-stage cp.async
// ring in shared memory was built and timed beside this one on an H100:
// it was 2-27% slower at the join's own call shapes and 9-16% faster only
// on a stream so sparse that each window entry is read about once, so it
// was dropped.) Blocks are persistent over 1024-output tiles; a thread owns
// RJT_ROWS outputs in pairs (gather_common.cuh) and loads the next tile's
// indices before it gathers the current one; the tile's minimum comes from
// warp reductions; all tables of any mix of element sizes ride one launch;
// outputs leave as streaming stores of a pair each.

#include <climits>

#include "gather_common.cuh"

#define RJT_BWG_TILE 1024
#define RJT_BWG_WIN 1024
#define RJT_BWG_SPAN (2 * RJT_BWG_WIN)
#define RJT_BWG_THREADS (RJT_BWG_TILE / RJT_ROWS)
#define RJT_BWG_WARPS (RJT_BWG_THREADS / 32)

// The window start of a tile, from the tile's indices held RJT_ROWS a
// thread. Holds one __syncthreads.
__device__ __forceinline__ long long bwg_window_start(
    const int (&v)[RJT_ROWS], long long jw, long long n, long long kmax,
    int* s_min) {
  int lo = INT_MAX;
#pragma unroll
  for (int r = 0; r < RJT_ROWS; ++r)
    if (rjt_row(jw, r) < n) lo = min(lo, v[r]);
  lo = __reduce_min_sync(0xffffffffu, lo);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = lo;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < RJT_BWG_WARPS; ++w) lo = min(lo, s_min[w]);
  // truncating and flooring division differ only for lo < 0, where the
  // clamp below sends both to 0
  long long q = lo / RJT_BWG_WIN;
  const long long top = kmax - 1 > 0 ? kmax - 1 : 0;
  q = q < 0 ? 0 : (q > top ? top : q);
  return q * RJT_BWG_WIN;
}

// One table's RJT_ROWS values of a thread. hit[r] says that row r lies in
// the window, where an index past a shorter table's end reads the zero pad.
template <typename T>
__device__ __forceinline__ void bwg_gather_table(
    const T* __restrict__ src, long long len, T* __restrict__ out,
    const int (&v)[RJT_ROWS], const bool (&hit)[RJT_ROWS], long long jw,
    long long n) {
  T val[RJT_ROWS];
#pragma unroll
  for (int r = 0; r < RJT_ROWS; ++r) {
    const long long p =
        v[r] < 0 ? 0 : (v[r] >= len ? len - 1 : (long long)v[r]);
    val[r] = __ldg(src + p);
    if (hit[r] && v[r] >= len) val[r] = T(0);
  }
  rjt_store_rows<T>(out, jw, n, val);
}

__global__ void __launch_bounds__(RJT_BWG_THREADS)
bwg_kernel(RjtTables tabs, int k, const int32_t* __restrict__ idx,
           long long n, long long kmax, int32_t* __restrict__ ok_out,
           long long ntiles) {
  // the minima of two tiles in turn, so that one barrier a tile is enough
  __shared__ int s_min[2][RJT_BWG_WARPS];

  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  const bool idx_vec = (reinterpret_cast<uintptr_t>(idx) & 7) == 0;
  // first row of this warp's span within a tile
  const int warp_off = (threadIdx.x >> 5) * RJT_WARP_ROWS;

  int v[RJT_ROWS];
  long long jw = tile * RJT_BWG_TILE + warp_off;
  rjt_load_rows(idx, jw, n, idx_vec, INT_MAX, v);
  for (int it = 0;; ++it) {
    const long long base = bwg_window_start(v, jw, n, kmax, s_min[it & 1]);
    const long long next = tile + gridDim.x;
    const long long jn = next * RJT_BWG_TILE + warp_off;
    int vn[RJT_ROWS];
    if (next < ntiles) rjt_load_rows(idx, jn, n, idx_vec, INT_MAX, vn);

    bool hit[RJT_ROWS];
    int okv[RJT_ROWS];
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) {
      const long long d = (long long)v[r] - base;
      hit[r] = d >= 0 && d < RJT_BWG_SPAN;
      okv[r] = hit[r] ? 1 : 0;
    }
    for (int t = 0; t < k; ++t) {
      const long long len = tabs.len[t];
      switch (tabs.elem[t]) {
        case 8:
          bwg_gather_table<long long>(
              static_cast<const long long*>(tabs.in[t]), len,
              static_cast<long long*>(tabs.out[t]), v, hit, jw, n);
          break;
        case 4:
          bwg_gather_table<int32_t>(
              static_cast<const int32_t*>(tabs.in[t]), len,
              static_cast<int32_t*>(tabs.out[t]), v, hit, jw, n);
          break;
        default:
          bwg_gather_table<uint8_t>(
              static_cast<const uint8_t*>(tabs.in[t]), len,
              static_cast<uint8_t*>(tabs.out[t]), v, hit, jw, n);
      }
    }
    if (ok_out != nullptr) rjt_store_rows<int32_t>(ok_out, jw, n, okv);

    if (next >= ntiles) break;
    tile = next;
    jw = jn;
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) v[r] = vn[r];
  }
}

// One launch for k <= RJT_MAX_TABLES tables of any mix of element sizes
// (elems[t] in {1, 4, 8}). ``ok`` may be null. Returns 0 or the CUDA error
// code.
extern "C" int rjt_blocked_window_gather(int device, int k,
                                         const void* const* tables,
                                         void* const* outs,
                                         const long long* lens,
                                         const int* elems,
                                         const int32_t* idx, long long n,
                                         long long kmax, int32_t* ok,
                                         int sm_count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  RjtTables tabs;
  int rc = rjt_pack_tables(&tabs, k, tables, outs, lens, elems);
  if (rc) return rc;
  // as many persistent blocks as the card holds at once
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bwg_kernel, RJT_BWG_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long ntiles = (n + RJT_BWG_TILE - 1) / RJT_BWG_TILE;
  const long long cap = (long long)per_sm * sm_count;
  const unsigned int grid = (unsigned int)(ntiles < cap ? ntiles : cap);
  bwg_kernel<<<grid, RJT_BWG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tabs, k, idx, n, kmax, ok, ntiles);
  return (int)cudaGetLastError();
}
