// paged_window_gather: out[p, r] = body[p, idx[p, r]], one gather window per
// page.
//
// Replaces radixjoin_tpu/ops/pallas_kernels.py::paged_window_gather (body
// _paged_gather_kernel). The device page decode
// (radixjoin_tpu_torch/storage/device_decode.py) calls it to move each
// page's packed non-null values to their row positions: body is the raw
// 8 KiB page upload viewed as 2048 little-endian int32 words, and idx holds
// the word of each row (INT32: 1920 rows a page; INT64/FP64: the two words
// of each of 960 rows, the int64 reassembly staying in torch).
//
// What bounds it on the card: device-memory bytes. Per page it reads the
// 8 KiB body and Ro 4-byte indices and writes Ro words; nothing else.
// The design: one block per page copies the body into shared memory with
// coalesced loads, then its threads gather the Ro words from there, so the
// random reads never leave the SM. Indices are clamped to [0, w) on the
// card; callers pass them in range already.

#include "gather_common.cuh"

__global__ void paged_gather_kernel(const int32_t* __restrict__ body,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int w, int ro) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* page = reinterpret_cast<int32_t*>(smem_raw);
  const long long p = blockIdx.x;
  const int32_t* src = body + p * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) page[i] = src[i];
  __syncthreads();
  const int32_t* ix = idx + p * ro;
  int32_t* o = out + p * ro;
  for (int r = threadIdx.x; r < ro; r += blockDim.x) {
    int i = ix[r];
    i = min(max(i, 0), w - 1);
    o[r] = page[i];
  }
}

// Returns 0 or the CUDA error code of the launch.
extern "C" int rjt_paged_window_gather(int device, const int32_t* body,
                                       const int32_t* idx, int32_t* out,
                                       long long npages, int w, int ro,
                                       int block, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (npages <= 0 || ro <= 0) return 0;
  const size_t smem = (size_t)w * sizeof(int32_t);
  err = rjt_allow_smem(paged_gather_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  paged_gather_kernel<<<(unsigned int)npages, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(body, idx, out,
                                                              w, ro);
  return (int)cudaGetLastError();
}
