// owner_recovery: the owner row of every output slot 0 <= j < s_pad of a
// join expansion, from the exclusive prefix sum ``offsets`` of n
// non-negative counts and their sum ``total``:
//   owner[j] = clamp(upper_bound(offsets, min(j, total - 1)) - 1, 0, n - 1)
// (upper_bound: the number of offsets at most its argument). For a slot
// below min(total, s_pad) that is the row whose run holds it; in the dead
// tail, the last row with a non-zero count; with total = 0, row 0.
// Precondition, which the kernel does not check (it would cost a host
// sync): offsets is non-decreasing, offsets[0] >= 0 and total >= offsets[n-1].
// Offsets that break it (an int32 cumsum that wrapped) give unspecified
// owners, and the kernel still reads and writes only inside its buffers.
// And cummax_i32: out[j] = max(x[0 .. j]) over an int32 stream.
//
// No Pallas original: these replace, on the card, a formulation the JAX
// package writes with XLA ops for the TPU and are held to its values. The
// JAX package recovers the owner of every output slot of a join expansion
// (radixjoin_tpu/ops/join.py: join_expand_impl, _merge_owner_recovery,
// join_csr_impl; radixjoin_tpu/plan/executor.py: _compact_probe_shaped) by
// scattering the id of each row with a non-zero count at its output start
// (every other row into one sentinel slot past the end), then lax.cummax
// and a clip: "two cheap vector ops instead of a per-slot binary search
// (TPU gathers are slow)". Every caller's offsets are a prefix sum of
// counts, so on the card the owner is a sorted search instead. The merge
// join's run_start and probe_at_start are two more lax.cummax scans.
//
// What bounds both on the card: device-memory bytes. owner_recovery must
// read n offsets (4 or 8 bytes) and one scalar and write s_pad int32
// owners; cummax_i32 reads and writes n int32.
//
// owner_recovery, one launch, no fill, no atomics, no scratch. Both the
// slots' keys min(j, total - 1) and the offsets are sorted, so the owners
// come from a merge of the two streams (a "load-balanced search"): a slot's
// owner is the number of rows merged before it, less one, a row going
// before a slot whose key it does not exceed. Rows past every key (the
// trailing rows of count 0) write nothing and are left out; the remaining
// rows and the s_pad slots are cut into equal runs along the merge, one a
// block (four blocks of 256 threads a SM), so a run holds as much work
// whatever the counts. Each block finds where its run starts and ends (the
// merge-path split of a diagonal: 128 probes a round in device memory, each
// half of the block on one end), streams its offsets into an eight-chunk
// shared-memory ring by bulk copies (cp.async.bulk on mbarriers, kept
// several tiles ahead) and walks the run in tiles of 2,044 merge items.
// A tile's end is found among the staged offsets (256 probes a round).
// Within it, each row of a non-zero count writes its id at the slot of its
// offset in a staging buffer (four rows a thread, one 16-byte load), a
// block max-scan from the tile's first row less one carries each id over
// its run, and the slots leave clamped, by 16-byte stores. Offsets that do
// not start on 16 bytes (a view) are staged by plain loads in the same
// kernel; int64 offsets are compared at their width.
//
// cummax_i32: one pass with decoupled look-back. A block takes a tile id
// from an atomic counter (so every tile before it belongs to a block already
// running), scans its 4096 values in registers (each warp 512 consecutive
// values as four coalesced 16-byte loads a thread, then warp shuffles),
// publishes its aggregate in a 64-bit status word (flag and value in one
// word, so one load sees both), and its first warp reads the status words of
// the tiles before it 32 at a time until one holds an inclusive prefix.
// Every value is read once and written once. The scratch (tile status words
// and the tile counter) is allocated by the wrapper a call and zeroed here on
// the stream before the scan, so the pair replays under CUDA-graph capture
// and calls share no state. (A persistent grid on a bulk-copy ring, with
// scratch kept across calls, measured no faster on the H100: PERF.md.)

#include <climits>
#include <map>
#include <mutex>

#include "gather_common.cuh"

#define RJT_FULL_MASK 0xffffffffu

// ---------------------------------------------------------------------------
// owner_recovery
// ---------------------------------------------------------------------------

constexpr int kOwnThreads = 256;
constexpr int kOwnSpan = 8;  // consecutive owners a thread scans a tile
// the staging buffer of a tile's owners, from the tile's first slot rounded
// down to 4; a tile of kOwnTile merge items holds at most kOwnTile slots
constexpr int kOwnStage = kOwnThreads * kOwnSpan;
constexpr int kOwnTile = kOwnStage - 4;  // merge items a tile: 2044
constexpr int kOwnHalf = kOwnThreads / 2;  // probes of one block split
constexpr int kOwnChunkRows = 1024;        // offsets a bulk copy
constexpr int kOwnSlots = 8;               // ring chunks
constexpr int kOwnRingRows = kOwnSlots * kOwnChunkRows;  // a power of two

template <typename OffT>
constexpr int own_smem() {
  return kOwnRingRows * (int)sizeof(OffT) + kOwnStage * 4;
}

// The key of slot b (below s_pad): min(b, total - 1).
__device__ __forceinline__ long long own_key(long long b, long long last) {
  return b < last ? b : last;
}

// Whether row offset x passes before a slot of key k (at the offsets'
// width: an int32 key against int32 offsets stays 32-bit).
template <typename OffT>
__device__ __forceinline__ bool own_le(OffT x, long long k) {
  return (long long)x <= k;
}

template <typename OffT>
__device__ __forceinline__ bool own_le(OffT x, int k) {
  if constexpr (sizeof(OffT) == 4)
    return x <= k;
  else
    return x <= (long long)k;
}

// Whether x lies in [lo, lo + len), by one unsigned compare.
template <typename OffT>
__device__ __forceinline__ bool own_in(OffT x, int lo, unsigned len) {
  if constexpr (sizeof(OffT) == 4)
    return (uint32_t)x - (uint32_t)lo < len;
  else
    return (unsigned long long)x - (unsigned long long)(long long)lo < len;
}

// Chunk c of the block's rows: [base + c R, min(base + (c + 1) R, a1)) into
// its ring slot. Bulk route: one bulk copy, from a start that is a multiple
// of 16 bytes, rounded up to 16 bytes within the array; the last few rows of
// an array whose end is not, by plain loads before the barrier's arrival.
template <typename OffT>
__device__ __forceinline__ void own_fetch(OffT* ring, const OffT* off,
                                          long long n, long long base,
                                          long long c, long long a1,
                                          uint32_t bar) {
  constexpr long long kAlign = 16 / sizeof(OffT);
  const long long cs = base + c * kOwnChunkRows;
  const long long ce = min(cs + kOwnChunkRows, a1);
  OffT* dst = ring + (c % kOwnSlots) * kOwnChunkRows;
  const long long cb =
      max(cs, min((ce + kAlign - 1) & ~(kAlign - 1), n & ~(kAlign - 1)));
  for (long long r = cb; r < ce; ++r) dst[r - cs] = off[r];
  const uint32_t bytes = (uint32_t)((cb - cs) * (long long)sizeof(OffT));
  rjt_mbar_expect(bar, bytes);
  if (bytes) rjt_bulk_copy(dst, off + cs, bytes, bar);
}

template <typename OffT>
__device__ __forceinline__ void own_load_chunk(OffT* ring, const OffT* off,
                                               long long base, long long c,
                                               long long a1) {
  const long long cs = base + c * kOwnChunkRows;
  const long long ce = min(cs + kOwnChunkRows, a1);
  OffT* dst = ring + (c % kOwnSlots) * kOwnChunkRows;
  for (long long r = cs + threadIdx.x; r < ce; r += blockDim.x)
    dst[r - cs] = off[r];
}

// Four consecutive staged offsets from ring position p (a multiple of 4).
template <typename OffT>
__device__ __forceinline__ void own_row4(const OffT* ring, int p, OffT (&o)[4]);

template <>
__device__ __forceinline__ void own_row4<int32_t>(const int32_t* ring, int p,
                                                  int32_t (&o)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(ring + p);
  o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
}

template <>
__device__ __forceinline__ void own_row4<long long>(const long long* ring,
                                                    int p, long long (&o)[4]) {
  const longlong2 a = *reinterpret_cast<const longlong2*>(ring + p);
  const longlong2 b = *reinterpret_cast<const longlong2*>(ring + p + 2);
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}

// VEC: offsets start on 16 bytes (the bulk-copy route). total_i64: the
// total is an int64 (else int32) scalar.
//
// Within a tile of the block's run, with rows [ta, ta1) and slots [tb, tb1):
// owner(b) = ta - 1 + (the tile's rows whose offset does not exceed key(b)),
// clamped. Those rows are a prefix of the tile's, so the owner is the last
// of them: each row of a non-zero count (the last of a run of equal
// offsets; a run that a tile's end cuts has its offset past the tile's
// slots) writes its id at the slot of its offset, and a max-scan of the
// slots from ta - 1 carries it over its run. No two rows write one slot.
// Rows and slots are counted from the block's first staged row and as
// int32 (s_pad and n are below 2^31); offsets compare at their width.
template <typename OffT, bool VEC>
__global__ void __launch_bounds__(kOwnThreads, 4)
owner_merge_kernel(const OffT* __restrict__ off, long long n,
                   const void* total_p, int total_i64,
                   int32_t* __restrict__ out, long long s_pad) {
  extern __shared__ __align__(16) unsigned char own_smem_buf[];
  OffT* ring = reinterpret_cast<OffT*>(own_smem_buf);
  int32_t* stage = reinterpret_cast<int32_t*>(
      own_smem_buf + kOwnRingRows * sizeof(OffT));
  __shared__ __align__(8) unsigned long long bars[kOwnSlots];
  __shared__ long long split_lo[2], split_hi[2];
  __shared__ __align__(16) int warp_part[kOwnThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long total =
      total_i64 ? *static_cast<const long long*>(total_p)
                : (long long)*static_cast<const int*>(total_p);
  // key(b) = min(b, last) for b < s_pad; -1 when total is 0
  const int last = (int)max(-1LL, min(total, s_pad) - 1);
  const int hi_row = (int)(n - 1);  // the clamp's top (-1 when n is 0)
  // Rows whose offset passes every key (the trailing rows of count 0, past
  // the total) come after every slot and write nothing: the merge leaves
  // them out, so that no block walks them. n_rows = upper_bound(offsets,
  // last), by rounds of kOwnThreads probes, the same in every block (its
  // probes hit L2 after the first block's).
  long long n_rows;
  {
    long long lo = 0, hi = n;
    while (lo < hi) {
      const long long span = hi - lo;
      const long long m = lo + span * tid / kOwnThreads;
      const int c = __syncthreads_count(own_le<OffT>(off[m], (long long)last));
      if (c == 0) {
        hi = lo;
      } else {
        const long long nlo = lo + span * (c - 1) / kOwnThreads + 1;
        if (c < kOwnThreads) hi = lo + span * c / kOwnThreads;
        lo = nlo;
      }
    }
    n_rows = lo;
  }
  const long long items_all = n_rows + s_pad;
  const long long per_block = (items_all + gridDim.x - 1) / gridDim.x;
  const long long d0 = (long long)blockIdx.x * per_block;
  const long long d1 = min(d0 + per_block, items_all);
  if (d0 >= d1) return;

  // The merge-path splits of diagonals d0 (first half of the block) and d1
  // (second half): the rows among the first d items of the merge, a row
  // going before a slot whose key it does not exceed. Rounds of kOwnHalf
  // evenly spaced probes narrow the range to the gap after the last probe
  // that passed; both halves run the same rounds (block barriers).
  {
    const int half = tid / kOwnHalf, g = tid % kOwnHalf;
    const long long d = half ? d1 : d0;
    if (g == 0) {
      split_lo[half] = max(0LL, d - s_pad);
      split_hi[half] = min(d, n_rows);
    }
    __syncthreads();
    for (;;) {
      const long long lo = split_lo[half], hi = split_hi[half];
      if (lo >= hi && split_lo[1 - half] >= split_hi[1 - half]) break;
      const long long span = hi - lo;
      const long long m = lo + span * g / kOwnHalf;
      const bool p = lo < hi && own_le<OffT>(off[m], own_key(d - 1 - m, last));
      const unsigned votes = __ballot_sync(RJT_FULL_MASK, p);
      if (lane == 0) warp_part[warp] = __popc(votes);
      __syncthreads();
      if (g == 0 && lo < hi) {
        int c = 0;
        for (int w = half * kOwnHalf / 32; w < (half + 1) * kOwnHalf / 32; ++w)
          c += warp_part[w];
        // probes 0 .. c - 1 passed: the split lies in (m_{c-1}, m_c]
        if (c == 0) {
          split_hi[half] = lo;
        } else {
          split_lo[half] = lo + span * (c - 1) / kOwnHalf + 1;
          if (c < kOwnHalf) split_hi[half] = lo + span * c / kOwnHalf;
        }
      }
      __syncthreads();
    }
  }
  const long long a0 = split_lo[0], a1 = split_lo[1];
  const int b0 = (int)(d0 - a0), b1 = (int)(d1 - a1);
  if (b0 >= b1) return;  // rows only: nothing to write

  // rows from `base` (a multiple of 4, so that bulk copies start on 16
  // bytes and four rows load at once): row base + r is ring slot r & mask
  const long long base = a0 & ~3LL;
  const int ra1_block = (int)(a1 - base);
  // a block with no rows fetches nothing (a copy of the rows below a0 that
  // no tile waits for would still be in flight at the block's exit)
  const int nchunks =
      a0 < a1 ? (ra1_block + kOwnChunkRows - 1) / kOwnChunkRows : 0;
  const uint32_t bar0 = rjt_smem_addr(bars);
  int issued = min(kOwnSlots, nchunks);
  if (VEC) {
    if (tid == 0) {
      for (int s = 0; s < kOwnSlots; ++s) rjt_mbar_init(bar0 + 8 * s);
      for (int c = 0; c < issued; ++c)
        own_fetch<OffT>(ring, off, n, base, c, a1, bar0 + 8 * (c % kOwnSlots));
    }
  } else {
    for (int c = 0; c < issued; ++c)
      own_load_chunk<OffT>(ring, off, base, c, a1);
  }
#pragma unroll
  for (int g = 0; g < kOwnSpan / 4; ++g)  // no writer: -1, under every id
    reinterpret_cast<int4*>(stage)[kOwnSpan / 4 * tid + g] =
        make_int4(-1, -1, -1, -1);
  __syncthreads();

  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int ra = (int)(a0 - base), tb = b0;
  long long td = d0;
  while (td < d1) {
    const int items = (int)min((long long)kOwnTile, d1 - td);
    const int rows_end = min(ra + items, ra1_block);
    if (VEC && rows_end > ra) {
      for (int c = ra / kOwnChunkRows; c <= (rows_end - 1) / kOwnChunkRows;
           ++c)
        rjt_mbar_wait(bar0 + 8 * (c % kOwnSlots), (c / kOwnSlots) & 1);
    }
    // the tile's end: rows ra1 - ra of its items, by rounds of kOwnThreads
    // probes among the staged rows (every thread computes the same range)
    int ra1;
    if (td + items == d1) {
      ra1 = ra1_block;
      __syncthreads();  // the previous tile's scan reset is done
    } else {
      int lo = max(0, items - (b1 - tb)), hi = min(items, ra1_block - ra);
      if (lo >= hi) __syncthreads();  // the same, with no round to do it
      while (lo < hi) {
        const int span = hi - lo;
        const int m = lo + span * tid / kOwnThreads;
        const int k = (int)min((long long)tb + items - 1 - m, (long long)last);
        const int c = __syncthreads_count(
            own_le<OffT>(ring[(ra + m) & (kOwnRingRows - 1)], k));
        if (c == 0) {
          hi = lo;
        } else {
          const int nlo = lo + span * (c - 1) / kOwnThreads + 1;
          if (c < kOwnThreads) hi = lo + span * c / kOwnThreads;
          lo = nlo;
        }
      }
      ra1 = ra + lo;
    }
    const int tb1 = (int)(td + items - base - ra1);
    const int tb_al = tb & ~3;
    // each row of a non-zero count writes its id at its slot: four rows a
    // thread, from the multiple of 4 at or below ra. A row writes where its
    // offset lies in [tb_al, min(last, tb1 - 1)]: for a prefix sum no row
    // of the tile lies below tb, and the lower end keeps offsets that break
    // the precondition (an int32 cumsum that wrapped) inside the buffer.
    const unsigned keys =
        (unsigned)(max(min(last, tb1 - 1), tb_al - 1) - tb_al + 1);
    for (int r4 = (ra & ~3) + 4 * tid; r4 < ra1; r4 += 4 * kOwnThreads) {
      OffT o[4];
      own_row4<OffT>(ring, r4 & (kOwnRingRows - 1), o);
      const OffT next =
          r4 + 4 < ra1 ? ring[(r4 + 4) & (kOwnRingRows - 1)] : (OffT)0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r4 + e;
        const OffT nx = e < 3 ? o[e + 1] : next;
        if (r >= ra && r < ra1 && own_in<OffT>(o[e], tb_al, keys) &&
            (r + 1 == ra1 || nx > o[e]))
          stage[(int)o[e] - tb_al] = (int)(base + r);
      }
    }
    __syncthreads();
    // refill the slots of chunks wholly before the next tile's first row
    if (VEC) {
      const int keep = ra1 / kOwnChunkRows + kOwnSlots;
      if (tid == kOwnThreads - 1 && issued < nchunks && issued < keep) {
        rjt_fence_proxy_async();
        for (; issued < nchunks && issued < keep; ++issued)
          own_fetch<OffT>(ring, off, n, base, issued, a1,
                          bar0 + 8 * (issued % kOwnSlots));
      }
    } else {
      for (const int keep = ra1 / kOwnChunkRows + kOwnSlots;
           issued < nchunks && issued < keep; ++issued)
        own_load_chunk<OffT>(ring, off, base, issued, a1);
    }
    // max-scan from ta - 1 of the staged ids at positions [0, tb1 - tb_al):
    // kOwnSpan consecutive positions a thread, which it resets to -1
    const int q0 = kOwnSpan * tid;
    const bool mine = q0 < tb1 - tb_al;
    int v[kOwnSpan];
#pragma unroll
    for (int g = 0; g < kOwnSpan / 4; ++g) {
      int4 q = make_int4(-1, -1, -1, -1);
      if (mine) {
        int4* p = reinterpret_cast<int4*>(stage + q0) + g;
        q = *p;
        *p = make_int4(-1, -1, -1, -1);
      }
      v[4 * g] = q.x, v[4 * g + 1] = q.y, v[4 * g + 2] = q.z, v[4 * g + 3] = q.w;
    }
#pragma unroll
    for (int e = 1; e < kOwnSpan; ++e) v[e] = max(v[e], v[e - 1]);
    int incl = v[kOwnSpan - 1];
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int o = __shfl_up_sync(RJT_FULL_MASK, incl, dd);
      if (lane >= dd) incl = max(incl, o);
    }
    int prefix = __shfl_up_sync(RJT_FULL_MASK, incl, 1);
    if (lane == 0) prefix = -1;
    if (lane == 31) warp_part[warp] = incl;
    __syncthreads();
    prefix = max(prefix, (int)(base + ra) - 1);
#pragma unroll
    for (int w = 0; w < kOwnThreads / 32; ++w)
      if (w < warp) prefix = max(prefix, warp_part[w]);
    if (mine) {
#pragma unroll
      for (int g = 0; g < kOwnSpan / 4; ++g) {
        const int b = tb_al + q0 + 4 * g;
        int r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r[e] = min(max(max(v[4 * g + e], prefix), 0), hi_row);
        if (vec_out && b >= tb && b + 4 <= tb1) {
          *reinterpret_cast<int4*>(out + b) =
              make_int4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (b + e >= tb && b + e < tb1) out[b + e] = r[e];
        }
      }
    }
    ra = ra1;
    tb = tb1;
    td += items;
  }
}

// Blocks of an owner kernel instance that fit an SM, once a device; the
// shared-memory opt-in with it (dynamic and static shared memory together
// may pass the 48 KB default even where the dynamic part alone does not).
template <typename OffT, bool VEC>
static cudaError_t own_blocks_per_sm(int device, int* per_sm) {
  static std::mutex mu;
  static std::map<int, int> fits;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = fits.find(device);
  if (it != fits.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      owner_merge_kernel<OffT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, own_smem<OffT>());
  if (err != cudaSuccess) return err;
  int fit = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, owner_merge_kernel<OffT, VEC>, kOwnThreads, own_smem<OffT>());
  if (err != cudaSuccess) return err;
  *per_sm = fits[device] = fit < 1 ? 1 : fit;
  return cudaSuccess;
}

template <typename OffT, bool VEC>
static int own_launch(int device, const OffT* off, long long n,
                      const void* total, int total_i64, int32_t* out,
                      long long s_pad, int sm_count, cudaStream_t s) {
  int per_sm = 1;
  const cudaError_t err = own_blocks_per_sm<OffT, VEC>(device, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long items = n + s_pad;
  const long long want = (items + kOwnTile - 1) / kOwnTile;
  const long long cap = (long long)per_sm * sm_count;
  const long long grid = want < cap ? want : cap;
  owner_merge_kernel<OffT, VEC><<<(unsigned int)grid, kOwnThreads,
                                  own_smem<OffT>(), s>>>(
      off, n, total, total_i64, out, s_pad);
  return (int)cudaGetLastError();
}

// owner (s_pad int32) from offsets (n int32, or int64 where offsets_i64) and
// total (one int32, or int64 where total_i64, on the device). Returns 0 or
// the CUDA error code.
extern "C" int rjt_owner_recovery(int device, const void* offsets,
                                  int offsets_i64, long long n,
                                  const void* total, int total_i64,
                                  int32_t* owner, long long s_pad,
                                  int sm_count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (s_pad <= 0) return 0;
  // slot and row positions are int32 in the kernel, a tile's span past them
  if (n < 0 || n > (long long)INT_MAX - kOwnStage ||
      s_pad > (long long)INT_MAX - kOwnStage || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(offsets) & 15) == 0;
  if (offsets_i64) {
    const long long* o = static_cast<const long long*>(offsets);
    return vec ? own_launch<long long, true>(device, o, n, total, total_i64,
                                             owner, s_pad, sm_count, s)
               : own_launch<long long, false>(device, o, n, total, total_i64,
                                              owner, s_pad, sm_count, s);
  }
  const int32_t* o = static_cast<const int32_t*>(offsets);
  return vec ? own_launch<int32_t, true>(device, o, n, total, total_i64,
                                         owner, s_pad, sm_count, s)
             : own_launch<int32_t, false>(device, o, n, total, total_i64,
                                          owner, s_pad, sm_count, s);
}

// ---------------------------------------------------------------------------
// cummax_i32
// ---------------------------------------------------------------------------

#define RJT_SCAN_THREADS 256
#define RJT_SCAN_VEC 4     // int32 a 16-byte load
#define RJT_SCAN_CHUNKS 4  // 16-byte loads a thread
#define RJT_SCAN_WARP_ITEMS (32 * RJT_SCAN_VEC * RJT_SCAN_CHUNKS)
#define RJT_SCAN_TILE (RJT_SCAN_THREADS / 32 * RJT_SCAN_WARP_ITEMS)  // 4096

// status word of a tile: flag in the high 32 bits, value in the low 32
#define RJT_FLAG_AGGREGATE 1ull
#define RJT_FLAG_INCLUSIVE 2ull

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

// out[j] = max(in[0 .. j]) for j < n. ``vec``: in and out start on 16 bytes.
__global__ void __launch_bounds__(RJT_SCAN_THREADS)
max_scan_kernel(const int32_t* in, int32_t* out, long long n,
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
    for (int e = 0; e < RJT_SCAN_VEC; ++e) r[e] = max(v[c][e], prefix);
    if (whole) {
      *reinterpret_cast<int4*>(out + p) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int e = 0; e < RJT_SCAN_VEC; ++e)
        if (p + e < n) out[p + e] = r[e];
    }
  }
}

// out = the inclusive running max of x (n int32). ``scratch`` holds at least
// ceil(n / 4096) + 1 words. Returns 0 or the CUDA error code.
extern "C" int rjt_cummax_i32(int device, const int32_t* x, int32_t* out,
                              long long n, unsigned long long* scratch,
                              long long scratch_words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long tiles = (n + RJT_SCAN_TILE - 1) / RJT_SCAN_TILE;
  if (scratch_words < tiles + 1 || tiles > (long long)UINT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(
      scratch, 0, (size_t)(tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  max_scan_kernel<<<(unsigned int)tiles, RJT_SCAN_THREADS, 0, s>>>(
      x, out, n, scratch, reinterpret_cast<unsigned int*>(scratch + tiles),
      vec);
  return (int)cudaGetLastError();
}
