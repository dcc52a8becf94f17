// paged_window_gather: out[p, r] = body[p, clamp(idx[p, r], 0, w - 1)], one
// gather window per page.
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
// 8 KiB body and Ro 4-byte indices and writes Ro words; nothing else. A
// decode sees from about 70 pages a column (S1's tables at scale 0.1) to
// 18,878 (cast_info at scale 1.0), so both the latency of one page and the
// rate over many count.
//
// The design. Persistent blocks, as many as fit the card (capped by the
// pages), walk the pages p = blockIdx.x, p += gridDim.x. On the vector
// route each page's body arrives by one bulk copy (cp.async.bulk, completed
// on an mbarrier) into a ring of kPwgSlots shared-memory page slots: the
// bodies of a block's first pages are requested at its start, and a slot
// is refilled with the body of the page kPwgSlots ahead as soon as every
// thread has read it, so the next pages are in flight while one is
// gathered. A thread owns four consecutive rows of a trip of the block over
// the page's Ro rows: one 16-byte streaming index load, issued one trip
// ahead of the gather it feeds, four shared-memory reads and one 16-byte
// streaming (evict-first) store; the outputs go to the decode's next torch
// op, not back to this kernel. The vector route needs body, idx and out
// 16-byte aligned, w and Ro multiples of 4 (every decode call: a fresh
// upload, w = 2048, Ro = 1920). Other inputs take the scalar route of the
// same kernel: one page slot filled by a plain loop, 4-byte loads and
// stores, four rows a thread at a stride of the block.
//
// Measured and left out (PERF.md): 1, 2 or 4 slots, 128 or 512 threads and
// plain stores; slicing a page's rows over several blocks when the pages
// are fewer than the card's block slots (slower at 131 pages with the
// inputs in L2, as a decode has them); index rows staged by the body's
// bulk copy (faster only on inputs in L2, and it caps Ro by shared memory).

#include <map>
#include <mutex>
#include <set>

#include "gather_common.cuh"

constexpr int kPwgThreads = 256;    // threads a block
constexpr int kPwgSlots = 3;        // page slots of the vector route's ring
constexpr int kPwgMaxWidth = 12288; // the widest page the wrapper takes

// Row k of this thread in the trip that starts at row t0: four consecutive
// rows (vector route) or four rows a block apart (scalar route).
template <bool VEC>
__device__ __forceinline__ int pwg_row(int t0, int k) {
  return VEC ? t0 + 4 * (int)threadIdx.x + k
             : t0 + k * (int)blockDim.x + (int)threadIdx.x;
}

// This thread's indices of the trip at t0 of a page's index row `ix` (0 for
// rows at or past ro). On the vector route t0 and ro are multiples of 4, so
// a thread's four rows are all real or all past ro.
template <bool VEC>
__device__ __forceinline__ void pwg_load(const int32_t* __restrict__ ix,
                                         int t0, int ro, int (&v)[4]) {
  if (VEC) {
    const int r = pwg_row<true>(t0, 0);
    if (r < ro) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(ix + r));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = pwg_row<false>(t0, k);
      v[k] = r < ro ? __ldcs(ix + r) : 0;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void pwg_store(int32_t* __restrict__ o, int t0,
                                          int ro, const int (&val)[4]) {
  if (VEC) {
    const int r = pwg_row<true>(t0, 0);
    if (r < ro)
      __stcs(reinterpret_cast<int4*>(o + r),
              make_int4(val[0], val[1], val[2], val[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = pwg_row<false>(t0, k);
      if (r < ro) __stcs(o + r, val[k]);
    }
  }
}

// One thread requests a page body of w words into a ring slot.
__device__ __forceinline__ void pwg_fetch(int32_t* slot, const int32_t* src,
                                          int w, uint32_t bar) {
  rjt_mbar_expect(bar, (uint32_t)w * 4u);
  rjt_bulk_copy(slot, src, (uint32_t)w * 4u, bar);
}

template <bool VEC>
__global__ void __launch_bounds__(kPwgThreads)
paged_gather_kernel(const int32_t* __restrict__ body,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, long long npages, int w,
                    int ro) {
  // kPwgSlots page slots on the vector route, one on the scalar route
  extern __shared__ __align__(16) int32_t ring[];
  __shared__ __align__(8) unsigned long long bars[kPwgSlots];
  const uint32_t bar0 = rjt_smem_addr(bars);
  const int trip = 4 * (int)blockDim.x;  // rows one trip of the block covers
  long long p = blockIdx.x;              // the grid never exceeds the pages
  if (VEC) {
    if (threadIdx.x == 0)
      for (int s = 0; s < kPwgSlots; ++s) rjt_mbar_init(bar0 + 8 * s);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < kPwgSlots; ++s) {
        const long long ps = p + (long long)s * gridDim.x;
        if (ps < npages)
          pwg_fetch(ring + s * w, body + ps * w, w, bar0 + 8 * s);
      }
  }
  int t0 = 0;
  int v[4];
  pwg_load<VEC>(idx + p * ro, t0, ro, v);
  // i counts the pages this block finished: page i sits in slot
  // i % kPwgSlots, whose barrier completes its (i / kPwgSlots)-th
  // phase when the body has landed
  for (unsigned int i = 0;;) {
    const int slot = VEC ? (int)(i % kPwgSlots) : 0;
    const int32_t* page = ring + slot * w;
    if (t0 == 0) {  // the page's first trip waits for its body
      if (VEC) {
        rjt_mbar_wait(bar0 + 8 * slot, (i / kPwgSlots) & 1u);
      } else {
        __syncthreads();  // every thread has read the previous body
        const int32_t* src = body + p * w;
        for (int j = threadIdx.x; j < w; j += blockDim.x) ring[j] = src[j];
        __syncthreads();
      }
    }
    // the next trip's indices are on their way while this one is gathered
    long long pn = p;
    int n0 = t0 + trip;
    if (n0 >= ro) {
      pn = p + gridDim.x;
      n0 = 0;
    }
    int vn[4] = {0, 0, 0, 0};
    if (pn < npages) pwg_load<VEC>(idx + pn * ro, n0, ro, vn);
    int val[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) val[k] = page[min(max(v[k], 0), w - 1)];
    pwg_store<VEC>(out + p * ro, t0, ro, val);
    if (pn != p) {  // the page is done
      if (pn >= npages) break;
      if (VEC) {
        __syncthreads();  // every thread has read the slot: refill it
        const long long pr = p + (long long)kPwgSlots * gridDim.x;
        if (threadIdx.x == 0 && pr < npages) {
          rjt_fence_proxy_async();
          pwg_fetch(ring + slot * w, body + pr * w, w, bar0 + 8 * slot);
        }
      }
      ++i;
    }
    p = pn;
    t0 = n0;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = vn[k];
  }
}

template <bool VEC>
static size_t pwg_smem(int w) {
  return (size_t)(VEC ? kPwgSlots : 1) * (size_t)w * sizeof(int32_t);
}

// Blocks of the route that fit an SM at width w. The shared-memory opt-in
// and the occupancy query cost host time of the order of a small decode's
// kernel, so each is made once in the process: the opt-in once a device, at
// the widest page (a setting of the whole process, which no later call
// lowers), and the occupancy once a device and width.
template <bool VEC>
static cudaError_t pwg_blocks_per_sm(int device, int w, int* per_sm) {
  static std::mutex mu;
  static std::set<int> opted_in;
  static std::map<std::pair<int, int>, int> fits;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(device, w);
  const auto it = fits.find(key);
  if (it != fits.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  cudaError_t err;
  if (!opted_in.count(device)) {
    err = rjt_allow_smem(paged_gather_kernel<VEC>,
                         pwg_smem<VEC>(kPwgMaxWidth));
    if (err != cudaSuccess) return err;
    opted_in.insert(device);
  }
  int fit = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, paged_gather_kernel<VEC>, kPwgThreads, pwg_smem<VEC>(w));
  if (err != cudaSuccess) return err;
  *per_sm = fits[key] = fit > 0 ? fit : 1;
  return cudaSuccess;
}

template <bool VEC>
static int pwg_launch(int device, const int32_t* body, const int32_t* idx,
                      int32_t* out, long long npages, int w, int ro,
                      int sm_count, cudaStream_t s) {
  int per_sm = 1;
  const cudaError_t err = pwg_blocks_per_sm<VEC>(device, w, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)per_sm * sm_count;
  const int grid = (int)(npages < cap ? npages : cap);
  paged_gather_kernel<VEC><<<grid, kPwgThreads, pwg_smem<VEC>(w), s>>>(
      body, idx, out, npages, w, ro);
  return (int)cudaGetLastError();
}

// Returns 0 or the CUDA error code of the launch. `vec` asks for the vector
// route, which the inputs must allow (16-byte aligned body, idx and out; w
// and ro multiples of 4).
extern "C" int rjt_paged_window_gather(int device, const int32_t* body,
                                       const int32_t* idx, int32_t* out,
                                       long long npages, int w, int ro,
                                       int vec, int sm_count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (npages <= 0 || ro <= 0) return 0;
  if (w < 1 || w > kPwgMaxWidth || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!vec)
    return pwg_launch<false>(device, body, idx, out, npages, w, ro,
                             sm_count, s);
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(body) | reinterpret_cast<uintptr_t>(idx) |
      reinterpret_cast<uintptr_t>(out);
  if ((any & 15) || (w & 3) || (ro & 3)) return (int)cudaErrorInvalidValue;
  return pwg_launch<true>(device, body, idx, out, npages, w, ro, sm_count,
                          s);
}
