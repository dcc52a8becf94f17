// owner_recovery: for every output slot 0 <= j < s_pad of a join expansion,
//   owner[j] = clamp(max{i : emits[i], offsets[i] <= j, offsets[i] < s_pad},
//                    0, n - 1)                 (an empty max is -1)
// and cummax_i32: out[j] = max(x[0 .. j]) over an int32 stream.
//
// No Pallas original: these replace, on the card, a formulation the JAX
// package writes with XLA ops for the TPU and holds to the JAX functions'
// values. The JAX package recovers the owner of every output slot of a join
// expansion (radixjoin_tpu/ops/join.py: join_expand_impl,
// _merge_owner_recovery, join_csr_impl; radixjoin_tpu/plan/executor.py:
// _compact_probe_shaped) by scattering each emitting row's id at its output
// start with marker.at[starts].max(iota, mode="drop"), every other row into
// one sentinel slot past the end, then lax.cummax and a clip: "two cheap
// vector ops instead of a per-slot binary search (TPU gathers are slow)".
// join_merge_impl's run_start and probe_at_start are two more lax.cummax
// scans. On the card the sentinel slot is one address that most rows of a
// join hit with an atomic, and torch's 1-D cummax is a slow scan.
//
// What bounds it on the card: device-memory bytes. owner_recovery must read
// n offsets (4 or 8 bytes) and n emit flags and write s_pad int32 owners;
// cummax_i32 reads and writes n int32.
//
// The design:
//   1. owner[0, s_pad) := -1 (cudaMemsetAsync of 0xff bytes);
//   2. scatter: an emitting row whose start lies below s_pad does a
//      fire-and-forget atomicMax of its id at owner[start]; every other row
//      writes nothing, so no address is contended (a start below 0 counts as
//      0: it is <= every j). Rows go four a thread, with one 4-byte load of
//      their flags and 16-byte loads of their offsets where aligned;
//   3. an inclusive max-scan of owner in place, the clamp fused into its
//      store: one pass with decoupled look-back. A block takes a tile id from
//      an atomic counter (so every tile before it belongs to a block already
//      running), scans its 4096 values in registers (each warp 512
//      consecutive values as four coalesced 16-byte loads a thread, then
//      warp shuffles), publishes its aggregate in a 64-bit status word (flag
//      and value in one word, so one load sees both), and its first warp
//      reads the status words of the tiles before it 32 at a time until one
//      holds an inclusive prefix. Every value is read once and written once.
// cummax_i32 is step 3 alone, from its input into a fresh output.
// The scratch (tile status words and the tile counter) is allocated by the
// wrapper and zeroed here on the stream before the scan, so the sequence
// replays under CUDA-graph capture.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define RJT_SCAN_THREADS 256
#define RJT_SCAN_VEC 4     // int32 a 16-byte load
#define RJT_SCAN_CHUNKS 4  // 16-byte loads a thread
#define RJT_SCAN_WARP_ITEMS (32 * RJT_SCAN_VEC * RJT_SCAN_CHUNKS)
#define RJT_SCAN_TILE (RJT_SCAN_THREADS / 32 * RJT_SCAN_WARP_ITEMS)  // 4096
#define RJT_SCATTER_THREADS 256
#define RJT_SCATTER_BLOCKS_PER_SM 8

// status word of a tile: flag in the high 32 bits, value in the low 32
#define RJT_FLAG_AGGREGATE 1ull
#define RJT_FLAG_INCLUSIVE 2ull
#define RJT_FULL_MASK 0xffffffffu

__device__ __forceinline__ unsigned long long rjt_status(
    unsigned long long flag, int value) {
  return (flag << 32) | (unsigned int)value;
}

__device__ __forceinline__ void rjt_status_store(unsigned long long* p,
                                                 unsigned long long s) {
  *reinterpret_cast<volatile unsigned long long*>(p) = s;
}

__device__ __forceinline__ unsigned long long rjt_status_load(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ int rjt_warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(RJT_FULL_MASK, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

__device__ __forceinline__ int rjt_warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(RJT_FULL_MASK, v, d));
  return v;
}

// The max of the inclusive prefixes of every tile before ``tile`` (INT_MIN
// for tile 0), by warp 0 of the block: lane l reads the status of tile
// end - l, waits until all 32 are published, and stops at the nearest tile
// that carries an inclusive prefix.
__device__ __forceinline__ int rjt_look_back(const unsigned long long* status,
                                             long long tile, int lane) {
  int prefix = INT_MIN;
  for (long long end = tile - 1;; end -= 32) {
    const long long q = end - lane;
    unsigned long long s = q >= 0 ? rjt_status_load(status + q)
                                  : rjt_status(RJT_FLAG_INCLUSIVE, INT_MIN);
    while (__any_sync(RJT_FULL_MASK, (s >> 32) == 0)) {
      if ((s >> 32) == 0) {
        __nanosleep(32);
        s = rjt_status_load(status + q);
      }
    }
    const unsigned incl =
        __ballot_sync(RJT_FULL_MASK, (s >> 32) == RJT_FLAG_INCLUSIVE);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    const int v = lane <= stop ? (int)(unsigned int)(s & 0xffffffffull)
                               : INT_MIN;
    prefix = max(prefix, rjt_warp_max(v));
    if (incl) return prefix;
  }
}

// out[j] = min(max(max(in[0 .. j]), lo), hi) for j < n. ``in`` may be
// ``out``: a thread reads its values before it writes them, and no thread
// reads another's. ``vec``: in and out start on 16 bytes.
__global__ void __launch_bounds__(RJT_SCAN_THREADS)
max_scan_kernel(const int32_t* in, int32_t* out, long long n, int lo, int hi,
                unsigned long long* status, unsigned int* counter, int vec) {
  __shared__ int warp_total[RJT_SCAN_THREADS / 32];
  __shared__ int tile_prefix;
  __shared__ unsigned int tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1u);
  __syncthreads();
  const long long tile = tile_id;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base =
      tile * RJT_SCAN_TILE + (long long)warp * RJT_SCAN_WARP_ITEMS;
  const bool whole = vec && base + RJT_SCAN_WARP_ITEMS <= n;

  // chunk c of the warp covers base + 128 c .. + 127; lane l holds its
  // values 4 l .. 4 l + 3
  int v[RJT_SCAN_CHUNKS][RJT_SCAN_VEC];
#pragma unroll
  for (int c = 0; c < RJT_SCAN_CHUNKS; ++c) {
    const long long p = base + c * (32 * RJT_SCAN_VEC) + lane * RJT_SCAN_VEC;
    if (whole) {
      const int4 q = *reinterpret_cast<const int4*>(in + p);
      v[c][0] = q.x, v[c][1] = q.y, v[c][2] = q.z, v[c][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < RJT_SCAN_VEC; ++e)
        v[c][e] = p + e < n ? in[p + e] : INT_MIN;
    }
  }
  int carry = INT_MIN;  // max of the warp's earlier chunks
#pragma unroll
  for (int c = 0; c < RJT_SCAN_CHUNKS; ++c) {
#pragma unroll
    for (int e = 1; e < RJT_SCAN_VEC; ++e) v[c][e] = max(v[c][e], v[c][e - 1]);
    const int incl = rjt_warp_inclusive_max(v[c][RJT_SCAN_VEC - 1], lane);
    int excl = __shfl_up_sync(RJT_FULL_MASK, incl, 1);
    excl = max(lane == 0 ? INT_MIN : excl, carry);
#pragma unroll
    for (int e = 0; e < RJT_SCAN_VEC; ++e) v[c][e] = max(v[c][e], excl);
    carry = max(carry, __shfl_sync(RJT_FULL_MASK, incl, 31));
  }
  if (lane == 0) warp_total[warp] = carry;
  __syncthreads();
  int warp_prefix = INT_MIN, tile_total = INT_MIN;
#pragma unroll
  for (int w = 0; w < RJT_SCAN_THREADS / 32; ++w) {
    const int t = warp_total[w];
    if (w < warp) warp_prefix = max(warp_prefix, t);
    tile_total = max(tile_total, t);
  }
  if (warp == 0) {
    if (tile == 0) {
      if (lane == 0) {
        rjt_status_store(status, rjt_status(RJT_FLAG_INCLUSIVE, tile_total));
        tile_prefix = INT_MIN;
      }
    } else {
      if (lane == 0)
        rjt_status_store(status + tile,
                         rjt_status(RJT_FLAG_AGGREGATE, tile_total));
      const int prefix = rjt_look_back(status, tile, lane);
      if (lane == 0) {
        rjt_status_store(status + tile,
                         rjt_status(RJT_FLAG_INCLUSIVE,
                                    max(prefix, tile_total)));
        tile_prefix = prefix;
      }
    }
  }
  __syncthreads();
  const int prefix = max(tile_prefix, warp_prefix);
#pragma unroll
  for (int c = 0; c < RJT_SCAN_CHUNKS; ++c) {
    const long long p = base + c * (32 * RJT_SCAN_VEC) + lane * RJT_SCAN_VEC;
    int r[RJT_SCAN_VEC];
#pragma unroll
    for (int e = 0; e < RJT_SCAN_VEC; ++e)
      r[e] = min(max(max(v[c][e], prefix), lo), hi);
    if (whole) {
      *reinterpret_cast<int4*>(out + p) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < RJT_SCAN_VEC; ++e)
        if (p + e < n) out[p + e] = r[e];
    }
  }
}

template <typename OffT>
__device__ __forceinline__ void scatter_row(int32_t* owner, long long s_pad,
                                            OffT off, bool emits, long long i) {
  if (emits && (long long)off < s_pad)
    atomicMax(owner + (off < 0 ? 0 : (long long)off), (int)i);
}

// owner[offsets[i]] max= i for every emitting row i with offsets[i] < s_pad.
// ``vec``: offsets start on 16 bytes and emits on 4, so rows go four a
// thread with one load of their flags and 16-byte loads of their offsets.
template <typename OffT>
__global__ void __launch_bounds__(RJT_SCATTER_THREADS)
owner_scatter_kernel(const OffT* __restrict__ offsets,
                     const uint8_t* __restrict__ emits, long long n,
                     int32_t* owner, long long s_pad, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long quads = n / 4;
    for (long long k = first; k < quads; k += stride) {
      const uint32_t f =
          __ldg(reinterpret_cast<const uint32_t*>(emits) + k);
      if (f == 0) continue;
      OffT o[4];
      if constexpr (sizeof(OffT) == 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(offsets) + k);
        o[0] = (OffT)q.x, o[1] = (OffT)q.y, o[2] = (OffT)q.z, o[3] = (OffT)q.w;
      } else {
        const longlong2 a =
            __ldg(reinterpret_cast<const longlong2*>(offsets) + 2 * k);
        const longlong2 b =
            __ldg(reinterpret_cast<const longlong2*>(offsets) + 2 * k + 1);
        o[0] = (OffT)a.x, o[1] = (OffT)a.y, o[2] = (OffT)b.x, o[3] = (OffT)b.y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        scatter_row<OffT>(owner, s_pad, o[e], (f >> (8 * e)) & 0xff,
                          4 * k + e);
    }
    done = quads * 4;
  }
  for (long long i = done + first; i < n; i += stride)
    scatter_row<OffT>(owner, s_pad, __ldg(offsets + i), __ldg(emits + i) != 0,
                      i);
}

static int launch_max_scan(const int32_t* in, int32_t* out, long long n,
                           int lo, int hi, unsigned long long* scratch,
                           long long scratch_words, cudaStream_t stream) {
  const long long tiles = (n + RJT_SCAN_TILE - 1) / RJT_SCAN_TILE;
  if (scratch_words < tiles + 1 || tiles > (long long)UINT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(tiles + 1) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((reinterpret_cast<uintptr_t>(in) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  max_scan_kernel<<<(unsigned int)tiles, RJT_SCAN_THREADS, 0, stream>>>(
      in, out, n, lo, hi, scratch,
      reinterpret_cast<unsigned int*>(scratch + tiles), vec);
  return (int)cudaGetLastError();
}

// owner (s_pad int32) from offsets (n int32, or int64 where offsets_i64)
// and emits (n bytes, 0 or 1). ``scratch`` holds at least
// ceil(s_pad / 4096) + 1 words. Returns 0 or the CUDA error code.
extern "C" int rjt_owner_recovery(int device, const void* offsets,
                                  int offsets_i64, const uint8_t* emits,
                                  long long n, int32_t* owner, long long s_pad,
                                  unsigned long long* scratch,
                                  long long scratch_words, int sm_count,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (s_pad <= 0) return 0;
  if (n < 0 || n > (long long)INT_MAX || s_pad > (long long)INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(owner, 0xff, (size_t)s_pad * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int vec = (reinterpret_cast<uintptr_t>(offsets) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(emits) & 3) == 0;
    const long long want =
        (n / 4 + RJT_SCATTER_THREADS - 1) / RJT_SCATTER_THREADS + 1;
    const long long cap = (long long)sm_count * RJT_SCATTER_BLOCKS_PER_SM;
    const unsigned int grid = (unsigned int)(want < cap ? want : cap);
    if (offsets_i64)
      owner_scatter_kernel<long long><<<grid, RJT_SCATTER_THREADS, 0, s>>>(
          static_cast<const long long*>(offsets), emits, n, owner, s_pad, vec);
    else
      owner_scatter_kernel<int32_t><<<grid, RJT_SCATTER_THREADS, 0, s>>>(
          static_cast<const int32_t*>(offsets), emits, n, owner, s_pad, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_max_scan(owner, owner, s_pad, 0, (int)(n - 1), scratch,
                         scratch_words, s);
}

// out = the inclusive running max of x (n int32). ``scratch`` holds at least
// ceil(n / 4096) + 1 words. Returns 0 or the CUDA error code.
extern "C" int rjt_cummax_i32(int device, const int32_t* x, int32_t* out,
                              long long n, unsigned long long* scratch,
                              long long scratch_words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  return launch_max_scan(x, out, n, INT_MIN, INT_MAX, scratch, scratch_words,
                         static_cast<cudaStream_t>(stream));
}
