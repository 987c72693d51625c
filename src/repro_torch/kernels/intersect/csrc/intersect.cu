// Sorted-list membership against n further lists in one launch:
// flags[i] = a[i] != PAD and a[i] is in every list b_j, where the lists are
// concatenated in bs with int32 bounds boff[0..n] (one list, bs whole,
// where boff is null).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/intersect/kernel.py,
// intersect_kernel (body _intersect_tile), which tiled both lists by 512,
// skipped tile pairs whose docid ranges are disjoint and compared each
// overlapping pair densely on the VPU, one list per call.  The plain
// PyTorch version of the same function is ../ref.py:intersect_all_ref, the
// AND of intersect_ref over the lists.
//
// What bounds it on an H100: latency, not bytes.  The bytes it must move
// (a and the lists read once, the flags written once) take a few tenths of
// a microsecond at 3.35 TB/s for lists of ~10^5 docids.  What costs is the
// chain of dependent loads each answer waits for, and the launches: a
// binary search of 10^5 docids in device memory is ~17 dependent loads,
// and a conjunctive query of n + 1 terms used to make n launches.
//
// What the design does about it:
//   * one launch per conjunctive query, for all n further lists;
//   * each CTA takes a tile of 256 elements of a, one a thread.  For each
//     list, one warp finds the tile's window [lower_bound(a_first),
//     upper_bound(a_last)) of the list by a 32-ary search (each lane
//     probes one pivot, a ballot keeps the part that holds the bound: four
//     rounds of one load each for 10^5 docids), the windows of up to four
//     lists at once, one warp per bound;
//   * the CTA stages each window into shared memory with 16-byte loads, in
//     passes of 2,048 docids where it is longer, and every thread
//     binary-searches its element there;
//   * a thread's flag is the AND over the lists, written once; a CTA with
//     no element left in the AND skips the remaining lists.  PAD
//     (INT32_MAX) in a never matches, whatever the lists hold.  The result
//     is exact and a rerun gives the same bytes.
//
// Interface: plain C functions, which launch on the caller's stream and
// return cudaGetLastError(): ix_launch, and ix_empty_launch, an empty
// kernel on ix_launch's grid for the same |a| (the launch floor that
// chip_smoke.py measures beside the kernel).  The Python wrapper
// (../kernel.py) allocates the output; the kernel allocates nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // elements of a per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLists = kWarps / 2;       // windows found at once
constexpr int kBuf = 2048;               // docids staged per pass (8 KB)
constexpr int32_t kPad = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// First index in [lo, hi) of sorted b with b[idx] >= key (hi if none), by
// one warp: each round every lane probes one of 32 pivots spread over the
// range, and the ballot of "pivot < key" keeps the part between two of
// them (a range of n shrinks to under n / 32).
__device__ int warp_lower_bound(const int32_t* __restrict__ b, int lo,
                                int hi, int32_t key, int lane) {
  while (lo < hi) {
    const int n = hi - lo;
    const int idx =
        lo + static_cast<int>(static_cast<long long>(lane + 1) * n / 33);
    const unsigned less = __ballot_sync(kFull, __ldg(b + idx) < key);
    const int c = __popc(less);            // pivots below key: a prefix
    const int left = __shfl_sync(kFull, idx, c > 0 ? c - 1 : 0);
    const int right = __shfl_sync(kFull, idx, c < 32 ? c : 31);
    if (c > 0) lo = left + 1;
    if (c < 32) hi = right;
  }
  return lo;
}

// s[0, len) = src[0, len), 16-byte loads where src allows them
__device__ void stage(int32_t* s, const int32_t* __restrict__ src, int len,
                      int tid) {
  const int head = min(
      len, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) &
                            15) / 4);
  if (tid < head) s[tid] = __ldg(src + tid);
  const int nvec = (len - head) / 4;
  const int4* v = reinterpret_cast<const int4*>(src + head);
  for (int k = tid; k < nvec; k += kThreads) {
    const int4 q = __ldg(v + k);
    int32_t* d = s + head + 4 * k;
    d[0] = q.x;
    d[1] = q.y;
    d[2] = q.z;
    d[3] = q.w;
  }
  for (int k = head + 4 * nvec + tid; k < len; k += kThreads)
    s[k] = __ldg(src + k);
}

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const int32_t* __restrict__ a, int na,
                 const int32_t* __restrict__ bs,
                 const int32_t* __restrict__ boff, int nlists, int nb,
                 uint8_t* __restrict__ flags) {
  __shared__ int32_t s_buf[kBuf];
  __shared__ int s_win[2][kLists];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + tid;
  const int32_t x = i < na ? __ldg(a + i) : kPad;
  // the tile's window keys, read beside x: a is sorted, so a PAD last
  // element (PAD entries come last) bounds the window at PAD, which leaves
  // out the PAD entries of the lists and holds every real docid
  const int32_t lo_key = __ldg(a + i0);
  const int32_t last = __ldg(a + min(i0 + kThreads, na) - 1);
  const int32_t hi_key = last == kPad ? kPad : last + 1;
  bool hit = x != kPad;
  for (int j0 = 0; j0 < nlists; j0 += kLists) {
    const int jn = min(kLists, nlists - j0);
    if (warp < 2 * jn) {                     // warp 2q + e: list j0 + q
      const int jl = j0 + (warp >> 1);
      const int b0 = boff ? min(max(__ldg(boff + jl), 0), nb) : 0;
      const int b1 = boff ? min(max(__ldg(boff + jl + 1), b0), nb) : nb;
      const int r = warp_lower_bound(bs, b0, b1,
                                     (warp & 1) ? hi_key : lo_key, lane);
      if (lane == 0) s_win[warp & 1][warp >> 1] = r;
    }
    __syncthreads();
    for (int q = 0; q < jn; ++q) {
      const int w0 = s_win[0][q];
      const int w1 = s_win[1][q];
      bool found = false;
      for (int c0 = w0; c0 < w1; c0 += kBuf) {
        const int len = min(kBuf, w1 - c0);
        stage(s_buf, bs + c0, len, tid);
        __syncthreads();
        if (hit && !found) {
          int lo = 0, hi = len;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_buf[mid] < x) lo = mid + 1;
            else hi = mid;
          }
          found = lo < len && s_buf[lo] == x;
        }
        __syncthreads();
      }
      hit = hit && found;
    }
    // more lists to go: stop where the AND is already empty
    if (j0 + kLists < nlists && !__syncthreads_or(hit)) break;
  }
  if (i < na) flags[i] = hit;
}

__global__ void empty_kernel() {}

int grid_for(int na) { return (na + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int ix_launch(const void* a, int na, const void* bs,
                         const void* boff, int nlists, int nb, void* flags,
                         void* stream) {
  if (na < 0 || nb < 0 || nlists < 1 || (boff == nullptr && nlists != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (na > 0) {
    intersect_kernel<<<grid_for(na), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), na, static_cast<const int32_t*>(bs),
        static_cast<const int32_t*>(boff), nlists, nb,
        static_cast<uint8_t*>(flags));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ix_empty_launch(int na, void* stream) {
  if (na < 1) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<grid_for(na), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
