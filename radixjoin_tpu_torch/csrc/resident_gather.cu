// resident_gather: out[j] = table[pos(j)] over an int32 table held on chip
// when it fits, for the in-kernel gather experiments of the TPU tools.
//
// Replaces four TPU kernels that differ only in how an output position maps
// to a table entry (the Pallas kernel bodies are named beside each map):
//   * tools/expt_pallas.py::_pallas_gather — bodies case_pallas_take and
//     case_pallas_take_unique (FULL), case_pallas_ta_lanes (LANE);
//   * tools/expt_primitives.py::case_gather_pallas_vmem (FULL);
//   * tools/expt_gather2.py::_mk — bodies build_2level (FULL), build_lanes
//     (LANE), build_rows (ROW), build_sub (SUBLANE);
//   * tools/expt_pallas.py::case_pallas_onehot_mxu (ONEHOT).
// With the table seen as t2 = table viewed (w / 128, 128):
//   FULL     table[idx[j]]                      (idx clamped to [0, w))
//   LANE     t2[0, idx[j] & 127]
//   ROW      t2[idx[j] >> 7, 0]                 (row clamped to the table)
//   SUBLANE  t2[idx[b0 + j % 128] & 7, 0]       (b0: start of j's block of
//                                                blk outputs)
//   ONEHOT   int32(float32(table))[idx[j]], and 0 for idx[j] outside [0, w)
//
// ONEHOT. The TPU kernel forms the (blk, w) one-hot matrix of a block of
// indices and multiplies it with the float32 table, because the MXU is the
// TPU's fast way to a dynamic gather. Its value is the table entry rounded
// through float32 (the identity below 2^24 in magnitude), or 0 for an
// all-zero one-hot row. On this card shared memory serves a dynamic read at
// full rate, so the product is dropped: carried over to the CUDA cores it
// cost w multiply-adds an output (4.5 ms for 2^24 outputs and w = 2048 on
// an H100 at 700 W, against 0.08 ms for index_select), and on the tensor
// cores an exact n x w x 8 product of 8-bit planes is several times the
// library call's time before one one-hot element is formed. Each block
// instead rounds the table through float32 once, on its way into shared
// memory (__float2int_rz(__int2float_rn(v)): exact for every int32 below
// 2^31 - 64, where float32 rounds to 2^31), and gathers from there; a test
// on the index, not a clamp, writes the 0.
//
// The TPU designs keep the whole table in VMEM for every grid step. Hopper
// has at most 227 KB of shared memory per block, so there are two routes in
// this kernel, chosen by the caller per launch:
//   * SMEM — a persistent block stages the table in shared memory (opt-in
//     above 48 KB) with one bulk asynchronous copy (cp.async.bulk and an
//     mbarrier); a table whose address or size is not a multiple of 16
//     bytes, and the ONEHOT map's rounded copy, by a plain loop;
//   * L2   — the table stays in device memory and is read with ld.global.nc,
//     so repeated entries are served by L2 (50 MB) and L1.
// What bounds it on the card: device-memory bytes, a 4-byte index read and a
// 4-byte output write per row, once the table is on chip. The L2 route adds
// a 32-byte sector from L2 per row for 4 bytes used, and that sector
// traffic, not device memory, is its limit for a table larger than L1.
//
// The design is the row ownership of gather_common.cuh: a warp walks a
// grid-stride loop over spans of 128 consecutive rows, a lane owning two
// pairs of them; 8-byte streaming index loads, issued one span ahead of the
// table reads they feed; four independent table reads in flight a thread;
// 8-byte streaming stores, so that the index and output streams do not
// evict the table from L2. SUBLANE reads the indices of the head span of
// its block of blk outputs at the lane's own offsets: spans are 128 rows
// aligned to 128, and blk is a multiple of 128 that divides n (the wrapper
// checks both), so j % 128 is the row's offset in its span and every span
// lies inside one block.

#include "gather_common.cuh"

enum RjtMap { RJT_MAP_FULL = 0, RJT_MAP_LANE = 1, RJT_MAP_ROW = 2,
              RJT_MAP_SUBLANE = 3, RJT_MAP_ONEHOT = 4 };

#define RJT_RG_MAX_THREADS 1024

// The value of an output whose index is v. `limit` is the last table entry
// (FULL, ONEHOT) or the last table row (ROW); every position fits an int
// because v does.
template <int MAP, bool SMEM>
__device__ __forceinline__ int32_t rg_value(const int32_t* __restrict__ table,
                                            const int32_t* s_tab, int v,
                                            int limit) {
  int p;
  if (MAP == RJT_MAP_LANE) {
    p = v & 127;
  } else if (MAP == RJT_MAP_ROW) {
    p = min(max(v >> 7, 0), limit) * 128;
  } else if (MAP == RJT_MAP_SUBLANE) {
    p = (v & 7) * 128;
  } else if (MAP == RJT_MAP_ONEHOT) {
    if ((unsigned int)v > (unsigned int)limit) return 0;
    p = v;
  } else {
    p = min(max(v, 0), limit);
  }
  return SMEM ? s_tab[p] : __ldg(table + p);
}

// Where the indices of the span of rows at j0 are: the span itself, or for
// SUBLANE the head span of its block of blk outputs (blk a multiple of
// RJT_WARP_ROWS; span numbers fit 32 bits for any n an int32 index reaches).
template <int MAP>
__device__ __forceinline__ long long rg_index_span(long long j0, int blk) {
  if (MAP != RJT_MAP_SUBLANE) return j0;
  const unsigned int span = (unsigned int)(j0 / RJT_WARP_ROWS);
  return (long long)(span - span % (unsigned int)(blk / RJT_WARP_ROWS)) *
         RJT_WARP_ROWS;
}

template <int MAP, bool SMEM>
__global__ void __launch_bounds__(RJT_RG_MAX_THREADS)
resident_gather_kernel(const int32_t* __restrict__ table, int w, int limit,
                       const int32_t* __restrict__ idx,
                       int32_t* __restrict__ out, long long n, int blk) {
  extern __shared__ __align__(16) int32_t s_tab[];
  __shared__ __align__(8) unsigned long long bar;
  if (SMEM) {
    // w is the number of entries to stage; uniform over the block
    if (MAP != RJT_MAP_ONEHOT && rjt_aligned16(table) && (w & 3) == 0) {
      const uint32_t bar_addr = rjt_smem_addr(&bar);
      if (threadIdx.x == 0) rjt_mbar_init(bar_addr);
      __syncthreads();
      if (threadIdx.x == 0) {
        rjt_mbar_expect(bar_addr, (uint32_t)w * 4u);
        rjt_bulk_copy(s_tab, table, (uint32_t)w * 4u, bar_addr);
      }
      rjt_mbar_wait(bar_addr, 0);
    } else {
      for (int i = threadIdx.x; i < w; i += blockDim.x) {
        const int32_t t = table[i];
        s_tab[i] =
            MAP == RJT_MAP_ONEHOT ? __float2int_rz(__int2float_rn(t)) : t;
      }
    }
    __syncthreads();
  }

  const bool idx_vec = (reinterpret_cast<uintptr_t>(idx) & 7) == 0;
  const int warps = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps * RJT_WARP_ROWS;
  long long jw =
      ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * RJT_WARP_ROWS;
  int v[RJT_ROWS];
  if (jw < n)
    rjt_load_rows(idx, rg_index_span<MAP>(jw, blk), n, idx_vec, 0, v);
  for (; jw < n; jw += stride) {
    // the next span's indices are on their way while this one is gathered
    int vn[RJT_ROWS];
    if (jw + stride < n)
      rjt_load_rows(idx, rg_index_span<MAP>(jw + stride, blk), n, idx_vec, 0,
                    vn);
    int32_t val[RJT_ROWS];
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r)
      val[r] = rg_value<MAP, SMEM>(table, s_tab, v[r], limit);
    rjt_store_rows<int32_t>(out, jw, n, val);
#pragma unroll
    for (int r = 0; r < RJT_ROWS; ++r) v[r] = vn[r];
  }
}

template <int MAP, bool SMEM>
static int launch_resident(const int32_t* table, long long w,
                           const int32_t* idx, int32_t* out, long long n,
                           int blk, int sm_count, cudaStream_t s) {
  auto kernel = resident_gather_kernel<MAP, SMEM>;
  const size_t smem = SMEM ? (size_t)w * sizeof(int32_t) : 0;
  cudaError_t err = rjt_allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // the most threads a block may have while two blocks still share an SM;
  // a table that fills the SM's shared memory alone gets all 1024
  const int block = smem > 100 * 1024 ? RJT_RG_MAX_THREADS : 512;
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long rows_per_block = (long long)block * RJT_ROWS;
  const long long want = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)per_sm * sm_count;
  const int grid = (int)(want < cap ? want : cap);
  const long long last =
      (MAP == RJT_MAP_ROW ? (w >> 7) : w) - 1;  // row or entry
  const int limit = (int)(last < INT32_MAX ? last : INT32_MAX);
  kernel<<<grid, block, smem, s>>>(table, SMEM ? (int)w : 0, limit, idx, out,
                                   n, blk);
  return (int)cudaGetLastError();
}

template <int MAP>
static int launch_route(int use_smem, const int32_t* table, long long w,
                        const int32_t* idx, int32_t* out, long long n,
                        int blk, int sm_count, cudaStream_t s) {
  return use_smem ? launch_resident<MAP, true>(table, w, idx, out, n, blk,
                                               sm_count, s)
                  : launch_resident<MAP, false>(table, w, idx, out, n, blk,
                                                sm_count, s);
}

// Returns 0 or the CUDA error code of the launch. ONEHOT takes the SMEM
// route only.
extern "C" int rjt_resident_gather(int device, int map, int use_smem,
                                   const int32_t* table, long long w,
                                   const int32_t* idx, int32_t* out,
                                   long long n, int blk, int sm_count,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (w < 1 || blk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (map) {
    case RJT_MAP_FULL:
      return launch_route<RJT_MAP_FULL>(use_smem, table, w, idx, out, n, blk,
                                        sm_count, s);
    case RJT_MAP_LANE:
      return launch_route<RJT_MAP_LANE>(use_smem, table, w, idx, out, n, blk,
                                        sm_count, s);
    case RJT_MAP_ROW:
      return launch_route<RJT_MAP_ROW>(use_smem, table, w, idx, out, n, blk,
                                       sm_count, s);
    case RJT_MAP_SUBLANE:
      return launch_route<RJT_MAP_SUBLANE>(use_smem, table, w, idx, out, n,
                                           blk, sm_count, s);
    case RJT_MAP_ONEHOT:
      if (!use_smem) break;
      return launch_resident<RJT_MAP_ONEHOT, true>(table, w, idx, out, n,
                                                   blk, sm_count, s);
  }
  return (int)cudaErrorInvalidValue;
}
