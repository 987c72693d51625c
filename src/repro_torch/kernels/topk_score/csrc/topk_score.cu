// Dense score accumulation: a deterministic scatter-add of (docid, weight)
// postings into a float32 vector over docids [0, n_docs), docid 0 zeroed.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/topk_score/kernel.py,
// score_kernel (body _score_tile), which built each 1024-docid tile of the
// vector as a one-hot matrix product on the MXU, skipping posting tiles
// whose docid range missed it.  The plain PyTorch version of the same
// function is ../ref.py:score_ref.
//
// What bounds it on an H100: memory and launch latency.  The bytes it must
// move are 8 B per posting (docid and weight, read once) and 4 B per docid
// of the output (written once); a ranked query over the WSJ1-like stream
// has up to a few hundred thousand postings, a few MB, about a microsecond
// at 3.35 TB/s.  The one-hot product the TPU used trades n_docs times more
// operations for dense memory access; a GPU scatters instead.
//
// What the design does about it, and about determinism:
//   * a float atomicAdd scatter into device memory would sum each docid's
//     weights in a different order on each run; instead one CUDA block owns
//     one tile of kTile docids and accumulates it in shared memory, so no
//     two blocks touch the same output;
//   * the input is a run of segments (one per query term), each with
//     distinct docids in ascending order.  For each segment in order the
//     block binary-searches the segment for its tile's [lo, hi) docid range
//     and adds that slice, then synchronises.  Within a segment no docid
//     repeats, so the adds of one pass never collide (the shared-memory
//     atomicAdd only guards a caller that breaks the contract), and across
//     passes every docid receives its weights in input order: the result
//     is the same bits on every run and equals the plain version, which
//     adds segment by segment too;
//   * each tile is written to device memory once, coalesced, with docid 0
//     (the padding bucket) written as zero.
//
// Interface: a plain C function, ts_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the output; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;   // docids per CUDA block: 8 KB of shared memory

// First index in [l, h) of the ascending segment whose docid is >= key.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ d,
                                           int l, int h, int key) {
  while (l < h) {
    const int m = l + ((h - l) >> 1);
    if (__ldg(d + m) < key) l = m + 1;
    else h = m;
  }
  return l;
}

__global__ void __launch_bounds__(kThreads)
score_kernel(const int32_t* __restrict__ docids,
             const float* __restrict__ weights,
             const int32_t* __restrict__ offsets, int nseg,
             float* __restrict__ out, int n_docs) {
  __shared__ float acc[kTile];
  __shared__ int range[2];
  const int lo = blockIdx.x * kTile;
  const int hi = min(lo + kTile, n_docs);
  for (int i = threadIdx.x; i < kTile; i += kThreads) acc[i] = 0.f;
  for (int s = 0; s < nseg; ++s) {
    if (threadIdx.x < 2)
      range[threadIdx.x] = lower_bound(docids, offsets[s], offsets[s + 1],
                                       threadIdx.x == 0 ? lo : hi);
    __syncthreads();      // the range is set; the last pass's adds are done
    const int a = range[0];
    const int b = range[1];
    for (int i = a + threadIdx.x; i < b; i += kThreads) {
      const int d = docids[i];
      if (d >= lo && d < hi) atomicAdd(&acc[d - lo], weights[i]);
    }
    __syncthreads();      // this pass's adds land before the next pass
  }
  for (int d = lo + threadIdx.x; d < hi; d += kThreads)
    out[d] = d == 0 ? 0.f : acc[d - lo];
}

}  // namespace

extern "C" int ts_launch(const void* docids, const void* weights,
                         const void* offsets, int nseg, void* out, int n_docs,
                         void* stream) {
  if (nseg < 0 || n_docs < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_docs > 0) {
    const int grid = (n_docs + kTile - 1) / kTile;
    score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(docids),
        static_cast<const float*>(weights),
        static_cast<const int32_t*>(offsets), nseg, static_cast<float*>(out),
        n_docs);
  }
  return static_cast<int>(cudaGetLastError());
}
