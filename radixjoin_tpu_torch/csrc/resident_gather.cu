// resident_gather: out[j] = table[pos(j)] with the table held on chip when
// it fits, for the in-kernel gather experiments of the TPU tools.
//
// Replaces three TPU kernels that differ only in how an output position maps
// to a table entry (the Pallas kernel bodies are named beside each map):
//   * tools/expt_pallas.py::_pallas_gather — bodies case_pallas_take and
//     case_pallas_take_unique (FULL), case_pallas_ta_lanes (LANE);
//   * tools/expt_primitives.py::case_gather_pallas_vmem (FULL);
//   * tools/expt_gather2.py::_mk — bodies build_2level (FULL), build_lanes
//     (LANE), build_rows (ROW), build_sub (SUBLANE).
// With the table seen as t2 = table viewed (w / 128, 128):
//   FULL     table[idx[j]]                      (idx clamped to [0, w))
//   LANE     t2[0, idx[j] & 127]
//   ROW      t2[idx[j] >> 7, 0]                 (row clamped to the table)
//   SUBLANE  t2[idx[b0 + j % 128] & 7, 0]       (b0: start of j's block of
//                                                blk outputs)
//
// The TPU design keeps the whole table in VMEM for every grid step. Hopper
// has at most 227 KB of shared memory per block, so there are two routes in
// this kernel, chosen by the caller per launch:
//   * SMEM — each block stages the table in shared memory (opt-in above
//     48 KB) and serves a grid-stride run of outputs from it;
//   * L2   — the table stays in device memory and is read with __ldg, so
//     repeated entries are served by L2 (50 MB) and the read-only cache.
// What bounds it on the card: device-memory bytes (a 4-byte index read and
// a 4-byte output write per row) once the table is on chip; the L2 route
// adds a random 32-byte sector read per row for tables larger than L2.

#include <cuda_runtime.h>
#include <stdint.h>

enum RjtMap { RJT_MAP_FULL = 0, RJT_MAP_LANE = 1, RJT_MAP_ROW = 2,
              RJT_MAP_SUBLANE = 3 };

template <int MAP>
__device__ __forceinline__ long long rjt_position(
    const int32_t* __restrict__ idx, long long j, long long w, int blk) {
  if (MAP == RJT_MAP_SUBLANE) {
    const long long b0 = (j / blk) * blk;
    return (long long)(idx[b0 + (j & 127)] & 7) * 128;
  }
  const int v = idx[j];
  if (MAP == RJT_MAP_LANE) return v & 127;
  if (MAP == RJT_MAP_ROW) {
    long long r = v >> 7;
    const long long rows = w >> 7;
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
    return r * 128;
  }
  long long p = v;
  return p < 0 ? 0 : (p >= w ? w - 1 : p);
}

template <int MAP, bool SMEM>
__global__ void resident_gather_kernel(const int32_t* __restrict__ table,
                                       long long w,
                                       const int32_t* __restrict__ idx,
                                       int32_t* __restrict__ out, long long n,
                                       int blk) {
  extern __shared__ __align__(16) int32_t s_tab[];
  if (SMEM) {
    for (long long i = threadIdx.x; i < w; i += blockDim.x) s_tab[i] = table[i];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const long long p = rjt_position<MAP>(idx, j, w, blk);
    out[j] = SMEM ? s_tab[p] : __ldg(table + p);
  }
}

template <int MAP>
static int launch_resident(int use_smem, const int32_t* table, long long w,
                           const int32_t* idx, int32_t* out, long long n,
                           int blk, int grid, int block, cudaStream_t s) {
  if (use_smem) {
    const size_t smem = (size_t)w * sizeof(int32_t);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          resident_gather_kernel<MAP, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    resident_gather_kernel<MAP, true><<<grid, block, smem, s>>>(
        table, w, idx, out, n, blk);
  } else {
    resident_gather_kernel<MAP, false><<<grid, block, 0, s>>>(
        table, w, idx, out, n, blk);
  }
  return (int)cudaGetLastError();
}

// Returns 0 or the CUDA error code of the launch.
extern "C" int rjt_resident_gather(int device, int map, int use_smem,
                                   const int32_t* table, long long w,
                                   const int32_t* idx, int32_t* out,
                                   long long n, int blk, int grid, int block,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (map) {
    case RJT_MAP_FULL:
      return launch_resident<RJT_MAP_FULL>(use_smem, table, w, idx, out, n,
                                           blk, grid, block, s);
    case RJT_MAP_LANE:
      return launch_resident<RJT_MAP_LANE>(use_smem, table, w, idx, out, n,
                                           blk, grid, block, s);
    case RJT_MAP_ROW:
      return launch_resident<RJT_MAP_ROW>(use_smem, table, w, idx, out, n,
                                          blk, grid, block, s);
    case RJT_MAP_SUBLANE:
      return launch_resident<RJT_MAP_SUBLANE>(use_smem, table, w, idx, out,
                                              n, blk, grid, block, s);
  }
  return (int)cudaErrorInvalidValue;
}
