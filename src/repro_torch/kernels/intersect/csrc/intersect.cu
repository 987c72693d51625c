// Sorted-list membership: flags[i] = a[i] in b, one CUDA thread per a[i].
//
// Replaces: the Pallas TPU kernel src/repro/kernels/intersect/kernel.py,
// intersect_kernel (body _intersect_tile), which tiled both lists by 512,
// skipped tile pairs whose docid ranges are disjoint and compared each
// overlapping pair densely on the VPU.  The plain PyTorch version of the
// same function is ../ref.py:intersect_ref.
//
// What bounds it on an H100: memory and launch latency.  The work is
// na binary searches of log2(nb) steps; the bytes it must move are a once
// (4 B each), b once (4 B each) and the flags once (1 B each).  The lists
// of a conjunctive query are at most ~10^5 docids, so one launch moves
// well under 1 MB: a few tenths of a microsecond at 3.35 TB/s, far below
// the launch latency of the card.
//
// What the design does about it: nothing is tiled.  Each thread runs a
// lower-bound binary search for its a[i] in b straight from device memory;
// b's upper levels are read by every thread and stay in L1/L2, so the
// search costs about one DRAM read per thread.  PAD (INT32_MAX) entries of
// a never match, whatever b holds.  The result is exact and a rerun gives
// the same bytes.
//
// Interface: a plain C function, ix_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the output; the kernel allocates nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
intersect_kernel(const int32_t* __restrict__ a, int na,
                 const int32_t* __restrict__ b, int nb,
                 uint8_t* __restrict__ flags) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= na) return;
  const int32_t x = a[i];
  int lo = 0, hi = nb;              // first index with b[idx] >= x
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(b + mid) < x) lo = mid + 1;
    else hi = mid;
  }
  flags[i] = x != INT_MAX && lo < nb && __ldg(b + lo) == x;
}

}  // namespace

extern "C" int ix_launch(const void* a, int na, const void* b, int nb,
                         void* flags, void* stream) {
  if (na < 0 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (na > 0) {
    const int grid = (na + kThreads - 1) / kThreads;
    intersect_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), na, static_cast<const int32_t*>(b),
        nb, static_cast<uint8_t*>(flags));
  }
  return static_cast<int>(cudaGetLastError());
}
