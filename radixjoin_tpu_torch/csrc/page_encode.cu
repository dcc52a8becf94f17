// page_encode: dense fixed-width columns -> row-aligned 8 KiB pages, the
// layout of radixjoin_tpu_torch/storage/device_decode.py::
// encode_fixed_aligned, byte for byte. A page holds R rows (1,920 INT32,
// 960 INT64 / FP64; the trailing page the rest):
//   [0:2)  u16 num_rows, [2:4) u16 num_values (non-null rows),
//   [db:)  the non-null values packed in row order, db = max(4, width),
//   tail   the NULL bitmap, ceil(num_rows / 8) bytes at the page's end, bit
//          i (little bit order) set where row i is non-null,
// and zeros everywhere else. FP64 arrives as its int64 bit pattern (as the
// engine keeps it on the card) and its bytes are copied as they are.
//
// No Pallas original: the JAX package encodes result pages on the host.
// On the card the fused executor encodes its root's fixed-width columns
// here before the fetch, so the host takes the pages as they are.
//
// What bounds it on the card: device-memory bytes. Each row is read once
// (its value and its validity byte) and each page written once: 5 bytes in
// and 4.27 out an INT32 row, 9 in and 8.53 out an INT64 row.
//
// The design: one block a page, every column of the call in one launch
// (the columns travel by value as pointer arrays, up to PE_MAX_COLS; the
// grid is the sum of the columns' pages, a block finds its column among
// the page offsets). A block of 256 threads stages its page in 8 KiB of
// shared memory:
//   1. each warp takes chunks of 32 rows (chunk c, c + 8, ...); a lane
//      loads its row's value and validity byte, coalesced across the warp,
//      every chunk's loads issued before the first is used;
//   2. the staged page is zeroed (16-byte stores) meanwhile;
//   3. __ballot_sync of the validity gives the chunk's 32-bit bitmap word
//      and, by popcount, its non-null count;
//   4. one warp scans the chunk counts (a block-wide exclusive scan): each
//      non-null row's rank is its chunk's base plus the non-null lanes
//      below it in the word, so consecutive lanes write consecutive values
//      (no bank conflicts);
//   5. values are written at their rank, the bitmap words at the page's
//      end byte by byte (a trailing page's bitmap need not start on a
//      word), the header by one thread;
//   6. the page leaves by coalesced 16-byte streaming stores, zeros
//      included, so the output needs no memset.
// No atomics, no host sync, no scratch; the launch runs on the caller's
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

#define PE_MAX_COLS 16
#define PE_THREADS 256
#define PE_WARPS (PE_THREADS / 32)
#define PE_PAGE 8192
// chunks of 32 rows in a full page: 1920 / 32 for INT32, 960 / 32 for INT64
#define PE_CHUNKS_MAX 60

struct PeCols {
  const void* val[PE_MAX_COLS];
  const uint8_t* valid[PE_MAX_COLS];
  uint8_t* out[PE_MAX_COLS];
  long long first_page[PE_MAX_COLS + 1];  // page offsets; [k] = grid size
  int elem[PE_MAX_COLS];                  // value bytes: 4 or 8
  int k;
};

template <typename T>
__device__ __forceinline__ void pe_encode_page(
    const T* __restrict__ val, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ out, long long page, long long n, uint4* staged,
    int* chunk_base) {
  constexpr int kRows = sizeof(T) == 4 ? 1920 : 960;
  constexpr int kChunks = kRows / 32;
  constexpr int kPerWarp = (kChunks + PE_WARPS - 1) / PE_WARPS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = page * kRows;
  const long long left = n - row0;
  const int nr = left < kRows ? (int)left : kRows;

  // 1. loads: chunk warp + 8 i, row 32 chunk + lane of the page
  T v[kPerWarp];
  bool ok[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int r = (warp + PE_WARPS * i) * 32 + lane;
    ok[i] = false;
    v[i] = 0;
    if (r < nr) {
      ok[i] = __ldg(valid + row0 + r) != 0;
      v[i] = __ldg(val + row0 + r);
    }
  }
  // 2. the staged page starts as zeros
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int q = threadIdx.x; q < PE_PAGE / 16; q += PE_THREADS) staged[q] = zero;
  // 3. each chunk's bitmap word and count
  unsigned int word[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    word[i] = __ballot_sync(0xffffffffu, ok[i]);
    const int c = warp + PE_WARPS * i;
    if (lane == 0 && c < kChunks) chunk_base[c] = __popc(word[i]);
  }
  __syncthreads();
  // 4. exclusive scan of the chunk counts by the first warp, two a lane
  if (warp == 0) {
    const int a = 2 * lane < kChunks ? chunk_base[2 * lane] : 0;
    const int b = 2 * lane + 1 < kChunks ? chunk_base[2 * lane + 1] : 0;
    int incl = a + b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const int excl = incl - a - b;
    if (2 * lane < kChunks) chunk_base[2 * lane] = excl;
    if (2 * lane + 1 < kChunks) chunk_base[2 * lane + 1] = excl + a;
    if (lane == 31) {
      // header: num_rows, num_values (both below 2^16)
      reinterpret_cast<uint32_t*>(staged)[0] =
          (uint32_t)nr | ((uint32_t)incl << 16);
    }
  }
  __syncthreads();
  // 5. values at their rank, bitmap bytes at the page's end
  T* region = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(staged) +
                                   (sizeof(T) < 4 ? 4 : sizeof(T)));
  uint8_t* bytes = reinterpret_cast<uint8_t*>(staged);
  const int nb = (nr + 7) / 8;
  const unsigned int below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int c = warp + PE_WARPS * i;
    if (c >= kChunks || c * 32 >= nr) continue;
    if (ok[i]) region[chunk_base[c] + __popc(word[i] & below)] = v[i];
    const int b = 4 * c + lane;
    if (lane < 4 && b < nb)
      bytes[PE_PAGE - nb + b] = (uint8_t)(word[i] >> (8 * lane));
  }
  __syncthreads();
  // 6. the whole page out
  uint4* dst = reinterpret_cast<uint4*>(out + page * PE_PAGE);
  for (int q = threadIdx.x; q < PE_PAGE / 16; q += PE_THREADS)
    __stcs(dst + q, staged[q]);
}

__global__ void __launch_bounds__(PE_THREADS)
page_encode_kernel(PeCols cols, long long n) {
  __shared__ uint4 staged[PE_PAGE / 16];
  __shared__ int chunk_base[PE_CHUNKS_MAX];
  const long long b = blockIdx.x;
  int c = 0;
  while (c + 1 < cols.k && b >= cols.first_page[c + 1]) ++c;
  const long long page = b - cols.first_page[c];
  if (cols.elem[c] == 4) {
    pe_encode_page<int32_t>(static_cast<const int32_t*>(cols.val[c]),
                            cols.valid[c], cols.out[c], page, n, staged,
                            chunk_base);
  } else {
    pe_encode_page<long long>(static_cast<const long long*>(cols.val[c]),
                              cols.valid[c], cols.out[c], page, n, staged,
                              chunk_base);
  }
}

// Encode the first n rows of k <= PE_MAX_COLS columns (values vals[t] of
// elems[t] bytes, validity bytes valids[t]) into outs[t], each
// ceil(n / R) pages of 8 KiB, in one launch on ``stream``. Returns 0 or a
// CUDA error code.
extern "C" int rjt_encode_pages(int device, int k, const void* const* vals,
                                const void* const* valids, void* const* outs,
                                const int* elems, long long n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > PE_MAX_COLS || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  PeCols cols;
  cols.k = k;
  cols.first_page[0] = 0;
  for (int t = 0; t < k; ++t) {
    if (elems[t] != 4 && elems[t] != 8) return (int)cudaErrorInvalidValue;
    const long long rows = elems[t] == 4 ? 1920 : 960;
    cols.val[t] = vals[t];
    cols.valid[t] = static_cast<const uint8_t*>(valids[t]);
    cols.out[t] = static_cast<uint8_t*>(outs[t]);
    cols.elem[t] = elems[t];
    cols.first_page[t + 1] = cols.first_page[t] + (n + rows - 1) / rows;
    if (reinterpret_cast<uintptr_t>(outs[t]) & 15)
      return (int)cudaErrorInvalidValue;
  }
  for (int t = k; t < PE_MAX_COLS; ++t) {
    cols.val[t] = nullptr;
    cols.valid[t] = nullptr;
    cols.out[t] = nullptr;
    cols.elem[t] = 0;
    cols.first_page[t + 1] = cols.first_page[k];
  }
  const long long grid = cols.first_page[k];
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  page_encode_kernel<<<(unsigned int)grid, PE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(cols, n);
  return (int)cudaGetLastError();
}
