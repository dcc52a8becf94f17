// onehot_gather: out[j] = int32(onehot(idx[j]) . float32(table)), the
// gather from a small table written as a one-hot product.
//
// Replaces tools/expt_pallas.py::case_pallas_onehot_mxu, which forms the
// (blk, w) one-hot matrix of a block of indices in VMEM and multiplies it
// with the float32 table on the MXU. The product is exact for table values
// below 2^24 in magnitude: each output sums one table value and w - 1 zeros.
// An index outside [0, w) has an all-zero one-hot row and yields 0.
//
// The Hopper design: FP32 FMAs on the CUDA cores, not the tensor cores.
// TF32 would round table values of 2^11 and above, and the exact bf16 route
// (three 8-bit planes through mma.sync) triples the work for a kernel that
// exists to price the one-hot formulation. Each block stages the table in
// shared memory as float32; each thread holds RJT_OH_ROWS indices and walks
// the table once, so one shared-memory read (a broadcast: every lane reads
// the same entry) feeds RJT_OH_ROWS FMAs. What bounds it on the card: FP32
// issue rate, w multiply-adds per output (2^24 x 2048 = 3.4e10 at the
// tool's default shape), against 8 bytes of device memory per output.

#include <cuda_runtime.h>
#include <stdint.h>

#define RJT_OH_ROWS 8
#define RJT_OH_BLOCK 256

__global__ void __launch_bounds__(RJT_OH_BLOCK)
onehot_gather_kernel(const int32_t* __restrict__ table, int w,
                     const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, long long n) {
  extern __shared__ __align__(16) float s_tabf[];
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    s_tabf[i] = __int2float_rn(table[i]);
  __syncthreads();
  const long long tile = (long long)RJT_OH_BLOCK * RJT_OH_ROWS;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n;
       t0 += (long long)gridDim.x * tile) {
    int v[RJT_OH_ROWS];
    float acc[RJT_OH_ROWS];
#pragma unroll
    for (int r = 0; r < RJT_OH_ROWS; ++r) {
      const long long j = t0 + (long long)r * RJT_OH_BLOCK + threadIdx.x;
      v[r] = j < n ? idx[j] : -1;
      acc[r] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < w; ++k) {
      const float t = s_tabf[k];
#pragma unroll
      for (int r = 0; r < RJT_OH_ROWS; ++r)
        acc[r] = fmaf(v[r] == k ? 1.0f : 0.0f, t, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RJT_OH_ROWS; ++r) {
      const long long j = t0 + (long long)r * RJT_OH_BLOCK + threadIdx.x;
      if (j < n) out[j] = __float2int_rz(acc[r]);
    }
  }
}

// Returns 0 or the CUDA error code of the launch.
extern "C" int rjt_onehot_gather(int device, const int32_t* table, int w,
                                 const int32_t* idx, int32_t* out,
                                 long long n, int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const size_t smem = (size_t)w * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(onehot_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  onehot_gather_kernel<<<grid, RJT_OH_BLOCK, smem,
                         static_cast<cudaStream_t>(stream)>>>(table, w, idx,
                                                              out, n);
  return (int)cudaGetLastError();
}
