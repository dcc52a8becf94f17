// unique_probe: the probe of a unique-key join against its dense key-window
// slot table, and, where the join node has a learned output pad, the
// compaction of its matches, in one pass over the probe. For probe row i:
//   off   = key[i] - base                      (64-bit, wrapping)
//   found = valid[i] && 0 <= off < r_pad && slots[off] >= 0
//   bidx  = found ? slots[off] : 0
// Probe-shaped (pad 0): bidx[i], found[i] for every probe row and the exact
// count of matches, total. Compacted (pad P > 0): the matches in probe
// order, j-th match at slot j < P: pidx[j] (its probe row), bidx[j] (its
// build row), live[j] = 1; total, the exact count, also past P (the rows past
// P are dropped and the engine reruns the plan without the pad); the dead
// tail j >= total holds pidx = the last match's row (row 0 without a
// match), bidx = that row's build row (0 without a match), live = 0.
//
// No Pallas original: on the card this replaces the JAX package's
// join_unique_scatter_impl (radixjoin_tpu/ops/join.py) after the slot
// table's scatter, and the owner recovery of _compact_probe_shaped
// (radixjoin_tpu/plan/executor.py), whose values it gives bit for bit,
// dead tail included. Written as torch it is some twenty passes over the
// probe (widen, subtract, compare, clamp, gather, mask, cast, cumsum, the
// owner recovery, then a gather of every column at probe size before the
// compaction): 11.5 ms a 2^27-row probe of a star's fact table on an H100.
//
// What bounds it on the card: device-memory bytes. It must read each probe
// key (4 or 8 bytes) and validity byte once, and write what it returns:
// 5 bytes a probe row probe-shaped, 9 bytes an output slot compacted. What
// stands in the way is the slot lookup: a random 4-byte read of the table
// (4 MiB for a star's 2^20-key dimension) for every valid in-window row.
// Those reads hit L2, but one a row took a 2^27-row probe to 1.05 ms, 19%
// of its bound, however many bytes the keys were. So where the window is at
// most 2^20 keys, a bitmap of the slots that hold a row (a bit a slot, at
// most 128 KiB, built by slot_bits_kernel) is staged in each block's
// shared memory, and only a row whose bit is set reads its slot: after a
// star's filter, about one row in a thousand.
//
// The design. A tile is 512 probe rows a warp: in chunk c (0 .. 3) lane l
// holds rows 128 c + 4 l .. + 3 of its warp's span, so each load is
// coalesced across the warp (16 bytes of int32 keys, or two 16-byte loads
// of int64 keys, and 4 validity bytes a lane) and every load of the tile is
// issued before the first lookup. With the bitmap a block is 1,024 threads
// (a 128 KiB bitmap leaves one block an SM, and a block that large keeps
// enough loads in flight); without it, 256. Both kernels are persistent
// grids that stage the bitmap once. Probe-shaped: tiles in a grid stride,
// bidx by 16-byte stores, found by 4-byte stores, the block's count added
// to total by one atomic at its end (total is zeroed on the stream first).
// Compacted: tiles taken in order from an atomic counter; a tile scans its
// match counts (warp shuffles, then the warps' totals), publishes its count
// and last match in a 64-bit status word (flag, count and last row + 1 in
// one word, so one load sees all three) and its first warp reads the words
// of the tiles before it, 32 at a time, until one holds an inclusive prefix
// (the decoupled look-back of owner_recovery.cu's scan). Each match then
// writes its slot below P. Once its last tile is done, a block waits for
// the last tile's inclusive word (every tile is then held by a running
// block, so the wait ends), reads the total and the last match, and fills
// its share of the dead tail; block 0 writes total. The scratch (a status
// word a tile and the tile counter) is allocated by the wrapper a call and
// zeroed here on the stream, so calls share no state.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <map>
#include <mutex>
#include <tuple>

#define UP_FULL_MASK 0xffffffffu

constexpr int kUpVec = 4;     // rows a lane a chunk
constexpr int kUpChunks = 4;  // chunks a warp a tile
constexpr int kUpChunkRows = 32 * kUpVec;              // 128
constexpr int kUpWarpRows = kUpChunks * kUpChunkRows;  // 512
// threads a block without and with the staged bitmap
constexpr int kUpThreads = 256;
constexpr int kUpBitsThreads = 1024;
// the widest window whose bitmap is staged: 2^20 slots, 128 KiB
constexpr long long kUpBitsMaxSlots = 1LL << 20;

// status word of a tile: flag in bits 62-63, match count in bits 31-61,
// last match row + 1 (0 for none) in bits 0-30
constexpr unsigned long long kUpAggregate = 1ull;
constexpr unsigned long long kUpInclusive = 2ull;
constexpr unsigned long long kUp31 = 0x7fffffffull;

__device__ __forceinline__ unsigned long long up_status(
    unsigned long long flag, long long count, int last1) {
  return (flag << 62) | (((unsigned long long)count & kUp31) << 31) |
         ((unsigned long long)last1 & kUp31);
}
__device__ __forceinline__ unsigned long long up_flag(unsigned long long s) {
  return s >> 62;
}
__device__ __forceinline__ long long up_count(unsigned long long s) {
  return (long long)((s >> 31) & kUp31);
}
__device__ __forceinline__ int up_last1(unsigned long long s) {
  return (int)(s & kUp31);
}
__device__ __forceinline__ void up_store(unsigned long long* p,
                                         unsigned long long s) {
  *reinterpret_cast<volatile unsigned long long*>(p) = s;
}
__device__ __forceinline__ unsigned long long up_load(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// What a probe looks up: the slot table and, where staged, the bitmap of
// its filled slots in shared memory.
struct UpTable {
  const int32_t* slots;
  long long r_pad;
  long long base;
  const uint32_t* bits;  // shared memory, or null
};

// bits[w] bit b set where slots[32 w + b] holds a build row, for w below
// `words` (a multiple of 4; slots past r_pad read as empty). One warp a
// word, in a grid stride.
__global__ void slot_bits_kernel(const int32_t* __restrict__ slots,
                                 long long r_pad, uint32_t* __restrict__ bits,
                                 long long words) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       w < words; w += warps) {
    const long long i = 32 * w + lane;
    const uint32_t b =
        __ballot_sync(UP_FULL_MASK, i < r_pad && __ldg(slots + i) >= 0);
    if (lane == 0) bits[w] = b;
  }
}

// The block's copy of the bitmap (words a multiple of 4), then a barrier.
__device__ __forceinline__ void up_stage_bits(const uint32_t* __restrict__ g,
                                              long long words, uint32_t* s) {
  for (long long w = 4LL * threadIdx.x; w < words; w += 4LL * blockDim.x)
    *reinterpret_cast<uint4*>(s + w) =
        __ldg(reinterpret_cast<const uint4*>(g + w));
  __syncthreads();
}

// The four keys and validity bytes of rows p .. p + 3 (zero validity past
// n). `whole`: all four are real and the loads may be 16 (keys) and 4
// (validity) bytes wide.
template <typename KeyT>
__device__ __forceinline__ void up_load4(const KeyT* __restrict__ keys,
                                         const uint8_t* __restrict__ valid,
                                         long long p, long long n, bool whole,
                                         KeyT (&k)[kUpVec], uint32_t& v) {
  if (whole) {
    if constexpr (sizeof(KeyT) == 4) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(keys + p));
      k[0] = q.x, k[1] = q.y, k[2] = q.z, k[3] = q.w;
    } else {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(keys + p));
      const longlong2 b =
          __ldcs(reinterpret_cast<const longlong2*>(keys + p + 2));
      k[0] = a.x, k[1] = a.y, k[2] = b.x, k[3] = b.y;
    }
    v = __ldcs(reinterpret_cast<const unsigned int*>(valid + p));
  } else {
    v = 0;
#pragma unroll
    for (int e = 0; e < kUpVec; ++e) {
      k[e] = 0;
      if (p + e < n) {
        k[e] = keys[p + e];
        v |= (uint32_t)(valid[p + e] != 0) << (8 * e);
      }
    }
  }
}

// The build row of one probe row, -1 where it does not match: its key is
// invalid, outside the window, or its slot (or bit) empty.
__device__ __forceinline__ int up_lookup(long long key, bool valid,
                                         const UpTable& t) {
  const unsigned long long off =
      (unsigned long long)key - (unsigned long long)t.base;
  if (!valid || off >= (unsigned long long)t.r_pad) return -1;
  if (t.bits && !((t.bits[off >> 5] >> (off & 31)) & 1u)) return -1;
  return __ldg(t.slots + off);
}

__device__ __forceinline__ int up_warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(UP_FULL_MASK, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

__device__ __forceinline__ int up_warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(UP_FULL_MASK, v, d));
  return v;
}

__device__ __forceinline__ long long up_warp_sum64(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(UP_FULL_MASK, v, d);
  return v;
}

// The matches of every tile before `tile` (count, last row + 1), by warp 0:
// lane l reads the word of tile end - l, waits until all 32 are published,
// and stops at the nearest tile whose word is inclusive.
__device__ __forceinline__ void up_look_back(
    const unsigned long long* status, long long tile, int lane,
    long long& count, int& last1) {
  count = 0;
  last1 = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long q = end - lane;
    unsigned long long s =
        q >= 0 ? up_load(status + q) : up_status(kUpInclusive, 0, 0);
    while (__any_sync(UP_FULL_MASK, up_flag(s) == 0)) {
      if (up_flag(s) == 0) {
        __nanosleep(32);
        s = up_load(status + q);
      }
    }
    const unsigned incl =
        __ballot_sync(UP_FULL_MASK, up_flag(s) == kUpInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    count += up_warp_sum64(lane <= stop ? up_count(s) : 0LL);
    last1 = max(last1, up_warp_max(lane <= stop ? up_last1(s) : 0));
    if (incl) return;
  }
}

// The probe of one tile: keys, validity and lookups of the thread's 16 rows
// (hit: the build row, -1 where the row does not match).
template <typename KeyT>
__device__ __forceinline__ void up_probe_tile(
    const KeyT* __restrict__ keys, const uint8_t* __restrict__ valid,
    long long n, const UpTable& t, bool vec, long long warp_row0, int lane,
    int (&hit)[kUpChunks][kUpVec]) {
  KeyT k[kUpChunks][kUpVec];
  uint32_t v[kUpChunks];
#pragma unroll
  for (int c = 0; c < kUpChunks; ++c) {
    const long long p = warp_row0 + c * kUpChunkRows + kUpVec * lane;
    up_load4<KeyT>(keys, valid, p, n, vec && p + kUpVec <= n, k[c], v[c]);
  }
#pragma unroll
  for (int c = 0; c < kUpChunks; ++c)
#pragma unroll
    for (int e = 0; e < kUpVec; ++e)
      hit[c][e] = up_lookup((long long)k[c][e], (v[c] >> (8 * e)) & 0xff, t);
}

// The table a block probes: the bitmap staged in its shared memory where
// BITS (bits_words words of it).
template <bool BITS>
__device__ __forceinline__ UpTable up_table(const int32_t* slots,
                                            long long r_pad, long long base,
                                            const uint32_t* bits,
                                            long long bits_words) {
  extern __shared__ __align__(16) uint32_t up_smem_bits[];
  if (BITS) up_stage_bits(bits, bits_words, up_smem_bits);
  return UpTable{slots, r_pad, base, BITS ? up_smem_bits : nullptr};
}

// Probe-shaped: tiles in a grid stride.
template <typename KeyT, int THREADS, bool BITS>
__global__ void __launch_bounds__(THREADS)
unique_probe_kernel(const KeyT* __restrict__ keys,
                    const uint8_t* __restrict__ valid, long long n,
                    const int32_t* __restrict__ slots, long long r_pad,
                    long long base, const uint32_t* __restrict__ bits,
                    long long bits_words, int32_t* __restrict__ bidx,
                    uint8_t* __restrict__ found,
                    unsigned long long* __restrict__ total, long long tiles,
                    int vec) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int warp_count[kWarps];
  const UpTable table = up_table<BITS>(slots, r_pad, base, bits, bits_words);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long warp_row0 =
        tile * kWarps * kUpWarpRows + (long long)warp * kUpWarpRows;
    int hit[kUpChunks][kUpVec];
    up_probe_tile<KeyT>(keys, valid, n, table, vec != 0, warp_row0, lane,
                        hit);
#pragma unroll
    for (int c = 0; c < kUpChunks; ++c) {
      const long long p = warp_row0 + c * kUpChunkRows + kUpVec * lane;
      int b[kUpVec];
      uint32_t f = 0;
#pragma unroll
      for (int e = 0; e < kUpVec; ++e) {
        const bool m = hit[c][e] >= 0;
        b[e] = m ? hit[c][e] : 0;
        f |= (uint32_t)m << (8 * e);
        count += m;
      }
      if (vec && p + kUpVec <= n) {
        __stcs(reinterpret_cast<int4*>(bidx + p),
               make_int4(b[0], b[1], b[2], b[3]));
        __stcs(reinterpret_cast<unsigned int*>(found + p), f);
      } else {
#pragma unroll
        for (int e = 0; e < kUpVec; ++e) {
          if (p + e < n) {
            bidx[p + e] = b[e];
            found[p + e] = (uint8_t)((f >> (8 * e)) & 1);
          }
        }
      }
    }
  }
  count = up_warp_incl_sum(count, lane);
  if (lane == 31) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long block = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) block += warp_count[w];
    if (block) atomicAdd(total, (unsigned long long)block);
  }
}

// Compacted: tiles in order from the tile counter, then the dead tail.
template <typename KeyT, int THREADS, bool BITS>
__global__ void __launch_bounds__(THREADS)
unique_probe_compact_kernel(const KeyT* __restrict__ keys,
                            const uint8_t* __restrict__ valid, long long n,
                            const int32_t* __restrict__ slots, long long r_pad,
                            long long base, const uint32_t* __restrict__ bits,
                            long long bits_words, int32_t* __restrict__ pidx,
                            int32_t* __restrict__ bidx,
                            uint8_t* __restrict__ live, long long pad,
                            long long* __restrict__ total,
                            unsigned long long* status, unsigned int* counter,
                            long long tiles, int vec) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int warp_count[kWarps];
  __shared__ int warp_last[kWarps];
  __shared__ long long tile_prefix;
  __shared__ unsigned int tile_id;
  __shared__ long long all_count;
  __shared__ int all_last;
  const UpTable table = up_table<BITS>(slots, r_pad, base, bits, bits_words);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (;;) {
    if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1u);
    __syncthreads();
    const long long tile = tile_id;
    if (tile >= tiles) break;
    const long long warp_row0 =
        tile * kWarps * kUpWarpRows + (long long)warp * kUpWarpRows;
    int hit[kUpChunks][kUpVec];
    up_probe_tile<KeyT>(keys, valid, n, table, vec != 0, warp_row0, lane,
                        hit);
    // each chunk's matches: the lane's exclusive offset in the warp's
    // span, the warp's count and its last match row
    int excl[kUpChunks];
    int warp_total = 0, last = -1;
#pragma unroll
    for (int c = 0; c < kUpChunks; ++c) {
      int cnt = 0;
#pragma unroll
      for (int e = 0; e < kUpVec; ++e) {
        cnt += hit[c][e] >= 0;
        if (hit[c][e] >= 0)
          last = (int)(warp_row0 + c * kUpChunkRows + kUpVec * lane + e);
      }
      const int incl = up_warp_incl_sum(cnt, lane);
      excl[c] = warp_total + incl - cnt;
      warp_total += __shfl_sync(UP_FULL_MASK, incl, 31);
    }
    last = up_warp_max(last);
    if (lane == 0) {
      warp_count[warp] = warp_total;
      warp_last[warp] = last;
    }
    __syncthreads();
    int warp_prefix = 0, tile_count = 0, tile_last = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) warp_prefix += warp_count[w];
      tile_count += warp_count[w];
      tile_last = max(tile_last, warp_last[w]);
    }
    if (warp == 0) {
      if (tile == 0) {
        if (lane == 0) {
          up_store(status, up_status(kUpInclusive, tile_count, tile_last + 1));
          tile_prefix = 0;
        }
      } else {
        if (lane == 0)
          up_store(status + tile,
                   up_status(kUpAggregate, tile_count, tile_last + 1));
        long long before;
        int before_last1;
        up_look_back(status, tile, lane, before, before_last1);
        if (lane == 0) {
          up_store(status + tile,
                   up_status(kUpInclusive, before + tile_count,
                             max(before_last1, tile_last + 1)));
          tile_prefix = before;
        }
      }
    }
    __syncthreads();
    const long long first = tile_prefix + warp_prefix;
    if (first < pad) {
#pragma unroll
      for (int c = 0; c < kUpChunks; ++c) {
        long long j = first + excl[c];
#pragma unroll
        for (int e = 0; e < kUpVec; ++e) {
          if (hit[c][e] >= 0) {
            if (j < pad) {
              pidx[j] =
                  (int)(warp_row0 + c * kUpChunkRows + kUpVec * lane + e);
              bidx[j] = hit[c][e];
              live[j] = 1;
            }
            ++j;
          }
        }
      }
    }
    __syncthreads();  // tile_id, the warp totals and tile_prefix are reused
  }

  // the dead tail: wait for the last tile's inclusive word
  if (threadIdx.x == 0) {
    unsigned long long s = up_load(status + tiles - 1);
    while (up_flag(s) != kUpInclusive) {
      __nanosleep(64);
      s = up_load(status + tiles - 1);
    }
    all_count = up_count(s);
    all_last = up_last1(s) - 1;
  }
  __syncthreads();
  const long long count = all_count;
  if (blockIdx.x == 0 && threadIdx.x == 0) *total = count;
  if (count >= pad) return;
  int fill_p = 0, fill_b = 0;
  if (count > 0) {
    fill_p = all_last;
    fill_b = up_lookup((long long)keys[fill_p], true, table);
  }
  for (long long j = count + (long long)blockIdx.x * THREADS + threadIdx.x;
       j < pad; j += (long long)gridDim.x * THREADS) {
    pidx[j] = fill_p;
    bidx[j] = fill_b;
    live[j] = 0;
  }
}

// Blocks of a kernel instance that fit an SM with `smem` bytes of dynamic
// shared memory, once a kernel, device and size. The kernel's shared-memory
// opt-in is set to the most any call of it takes (`smem_max`), the same
// value whatever the call, so that it holds for every size.
template <typename Kernel>
static cudaError_t up_blocks_per_sm(Kernel kernel, int threads, int device,
                                    int smem, int smem_max, int* per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> fits;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   device, smem);
  const auto it = fits.find(key);
  if (it != fits.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  int fit = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  *per_sm = fits[key] = fit < 1 ? 1 : fit;
  return cudaSuccess;
}

template <typename KeyT, int THREADS, bool BITS>
static int up_launch(int device, const KeyT* keys, const uint8_t* valid,
                     long long n, const int32_t* slots, long long r_pad,
                     long long base, uint32_t* bits, long long bits_words,
                     int32_t* out_a, int32_t* out_b, uint8_t* live,
                     long long pad, long long* total,
                     unsigned long long* scratch, int vec, int sm_count,
                     cudaStream_t s) {
  const long long tile_rows = (long long)THREADS / 32 * kUpWarpRows;
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const int smem = BITS ? (int)(bits_words * sizeof(uint32_t)) : 0;
  const int smem_max = BITS ? (int)(kUpBitsMaxSlots / 8) : 0;
  cudaError_t err;
  if (BITS) {
    const long long want = (bits_words + 7) / 8;  // 8 warps a block
    const long long grid = want < 4LL * sm_count ? want : 4LL * sm_count;
    slot_bits_kernel<<<(unsigned int)grid, 256, 0, s>>>(slots, r_pad, bits,
                                                         bits_words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 1;
  if (pad == 0) {
    auto kernel = unique_probe_kernel<KeyT, THREADS, BITS>;
    err = up_blocks_per_sm(kernel, THREADS, device, smem, smem_max, &per_sm);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(total, 0, sizeof(long long), s);
    if (err != cudaSuccess) return (int)err;
    const long long cap = (long long)per_sm * sm_count;
    kernel<<<(unsigned int)(tiles < cap ? tiles : cap), THREADS, smem, s>>>(
        keys, valid, n, slots, r_pad, base, bits, bits_words, out_a, live,
        reinterpret_cast<unsigned long long*>(total), tiles, vec);
    return (int)cudaGetLastError();
  }
  auto kernel = unique_probe_compact_kernel<KeyT, THREADS, BITS>;
  err = up_blocks_per_sm(kernel, THREADS, device, smem, smem_max, &per_sm);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0,
                        (size_t)(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)per_sm * sm_count;
  kernel<<<(unsigned int)(tiles < cap ? tiles : cap), THREADS, smem, s>>>(
      keys, valid, n, slots, r_pad, base, bits, bits_words, out_a, out_b,
      live, pad, total, scratch,
      reinterpret_cast<unsigned int*>(scratch + tiles), tiles, vec);
  return (int)cudaGetLastError();
}

template <typename KeyT>
static int up_route(int device, const KeyT* keys, const uint8_t* valid,
                    long long n, const int32_t* slots, long long r_pad,
                    long long base, uint32_t* bits, long long bits_words,
                    int32_t* out_a, int32_t* out_b, uint8_t* live,
                    long long pad, long long* total,
                    unsigned long long* scratch, int vec, int sm_count,
                    cudaStream_t s) {
  if (bits)
    return up_launch<KeyT, kUpBitsThreads, true>(
        device, keys, valid, n, slots, r_pad, base, bits, bits_words, out_a,
        out_b, live, pad, total, scratch, vec, sm_count, s);
  return up_launch<KeyT, kUpThreads, false>(
      device, keys, valid, n, slots, r_pad, base, nullptr, 0, out_a, out_b,
      live, pad, total, scratch, vec, sm_count, s);
}

// The probe of n keys (int32, or int64 where key_i64) with their validity
// bytes against slots (r_pad int32). bits: bits_words uint32 of scratch for
// the bitmap (bits_words = ceil(r_pad / 32) rounded up to 4; r_pad at most
// 2^20), or null to look every in-window row up in the table. pad 0: bidx
// into out_a (n int32), found into live (n bytes), the count into total.
// pad > 0: pidx into out_a, bidx into out_b, live (pad each), the count
// into total; scratch holds scratch_words >= ceil(n / tile rows) + 1 words
// (tile rows: 4,096 without the bitmap, 16,384 with it). n is at least 1
// and below 2^31 - 1. Returns 0 or the CUDA error code.
extern "C" int rjt_unique_probe(int device, const void* keys, int key_i64,
                                const uint8_t* valid, long long n,
                                const int32_t* slots, long long r_pad,
                                long long base, uint32_t* bits,
                                long long bits_words, int32_t* out_a,
                                int32_t* out_b, uint8_t* live, long long pad,
                                long long* total, unsigned long long* scratch,
                                long long scratch_words, int sm_count,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // a row + 1 and a count travel in 31 bits of a tile's status word
  if (n < 1 || n >= (long long)INT_MAX || r_pad < 1 || pad < 0 ||
      sm_count < 1)
    return (int)cudaErrorInvalidValue;
  if (bits && (r_pad > kUpBitsMaxSlots || bits_words % 4 != 0 ||
               bits_words < (r_pad + 31) / 32 ||
               (reinterpret_cast<uintptr_t>(bits) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const long long tile_rows =
      (long long)(bits ? kUpBitsThreads : kUpThreads) / 32 * kUpWarpRows;
  if (pad > 0 && scratch_words < (n + tile_rows - 1) / tile_rows + 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte key loads and bidx stores, 4-byte validity loads and stores
  uintptr_t wide = reinterpret_cast<uintptr_t>(keys);
  uintptr_t narrow = reinterpret_cast<uintptr_t>(valid);
  if (pad == 0) {
    wide |= reinterpret_cast<uintptr_t>(out_a);
    narrow |= reinterpret_cast<uintptr_t>(live);
  }
  const int vec = (wide & 15) == 0 && (narrow & 3) == 0;
  if (key_i64)
    return up_route<long long>(device, static_cast<const long long*>(keys),
                               valid, n, slots, r_pad, base, bits,
                               bits_words, out_a, out_b, live, pad, total,
                               scratch, vec, sm_count, s);
  return up_route<int32_t>(device, static_cast<const int32_t*>(keys), valid,
                           n, slots, r_pad, base, bits, bits_words, out_a,
                           out_b, live, pad, total, scratch, vec, sm_count,
                           s);
}
