// Dense score accumulation: a deterministic scatter-add of (docid, weight)
// postings into a float32 vector over docids [0, n_docs), docid 0 zeroed.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/topk_score/kernel.py,
// score_kernel (body _score_tile), which built each 1024-docid tile of the
// vector as a one-hot matrix product on the MXU, skipping posting tiles
// whose docid range missed it.  The plain PyTorch version of the same
// function is ../ref.py:score_ref.
//
// What bounds it on an H100: latency, not bytes.  The bytes it must move
// are 8 B per posting (docid and weight, read once) and 4 B per docid of
// the output (written once): a ranked query over the WSJ1-like stream has
// up to ~290k postings in 1-4 segments over ~99k docids, 2.7 MB, under a
// microsecond at 3.35 TB/s.  What a launch costs is the chain of dependent
// loads each block makes before it can add, and how many SMs share the
// work.  The one-hot product the TPU used trades n_docs times more
// operations for dense memory access; a GPU scatters instead.
//
// What the design does about it, and about determinism:
//   * a float atomicAdd scatter into device memory would sum each docid's
//     weights in a different order on each run; instead one CUDA block owns
//     one tile of kTile = 512 docids and builds it in shared memory, so no
//     two blocks touch the same output.  At ~99k docids that is 193 blocks,
//     one or two on every SM, all resident at once (2,048-docid tiles gave
//     49 blocks for 132 SMs; 256-docid tiles were as fast at 4 segments and
//     slower at 9 and 40, where their blocks make twice the searches);
//   * the input is a run of segments (one per query term), each with
//     distinct docids in ascending order.  A tile's slice of a segment is
//     found by two searches, for the tile's lo and hi docids.  One warp
//     runs each search: each step its lanes probe 32 evenly spaced entries
//     and a ballot of those below the key cuts the range 32-fold (four
//     dependent loads for ~70k postings, where a binary search makes
//     seventeen).  The 16 warps of a block search eight segments at once;
//   * up to kChunk segments are staged together: segment j's slice is
//     scattered into its own shared row part[j][.], zeroed first.  Within
//     a segment no docid repeats, so no two adds meet (the shared-memory
//     atomicAdd only guards a caller that breaks the contract) and all the
//     slices are scattered in one pass, with no barrier between segments.
//     Then thread t sums column t over the rows in segment order.  A docid
//     that a segment lacks adds +0.0, which changes no sum here (a sum that
//     starts at +0.0 never becomes -0.0), so every docid receives its
//     weights in input order: the result is the same bits on every run and
//     equals the plain version, which adds segment by segment too;
//   * each tile is written to device memory once, coalesced, with docid 0
//     (the padding bucket) written as zero.
//
// Interface: a plain C function, ts_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the output; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = kThreads;      // docids per CUDA block, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;           // segments staged at once: 32 KB of rows
constexpr int kLoads = 4;            // postings in flight per thread
constexpr unsigned kFull = 0xffffffffu;

// First index in [l, h) of the ascending run d whose docid is >= key, found
// by the whole warp (every lane returns it): each step probes 32 evenly
// spaced entries, and the count of those below key narrows the range.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ d,
                                                int l, int h, int key,
                                                int lane) {
  while (l < h) {
    const int step = (h - l + 31) >> 5;
    const int i = l + lane * step;
    const bool below = i < h && __ldg(d + i) < key;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c == 0) break;                   // d[l] >= key
    // probes 0 .. c-1 (at l, l + step, ...) are below key; probe c (or h)
    // is not
    const int nh = min(h, l + c * step);
    l += (c - 1) * step + 1;
    h = nh;
  }
  return l;
}

__global__ void __launch_bounds__(kThreads)
score_kernel(const int32_t* __restrict__ docids,
             const float* __restrict__ weights,
             const int32_t* __restrict__ offsets, int nseg,
             float* __restrict__ out, int n_docs) {
  __shared__ float part[kChunk][kTile];  // one row per staged segment
  __shared__ int slice[kChunk][2];       // each segment's [a, b) in the tile
  __shared__ int start[kChunk + 1];      // where each slice begins, flat
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int lo = blockIdx.x * kTile;
  const int hi = min(lo + kTile, n_docs);
  float acc = 0.f;
  for (int s0 = 0; s0 < nseg; s0 += kChunk) {
    const int ns = min(kChunk, nseg - s0);
    for (int j = 0; j < ns; ++j) part[j][t] = 0.f;
    for (int p = warp; p < 2 * ns; p += kWarps) {
      const int s = s0 + (p >> 1);
      const int b = warp_lower_bound(docids, offsets[s], offsets[s + 1],
                                     (p & 1) ? hi : lo, lane);
      if (lane == 0) slice[p >> 1][p & 1] = b;
    }
    __syncthreads();      // slices found, rows zeroed
    if (warp == 0) {      // start[] = exclusive prefix sum of the lengths
      const int len = lane < ns ? max(0, slice[lane][1] - slice[lane][0])
                                : 0;
      int sum = len;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, sum, off);
        if (lane >= off) sum += v;
      }
      if (lane <= ns) start[lane] = sum - len;
    }
    __syncthreads();
    // every slice of the chunk at once: f runs over their concatenation
    const int total = start[ns];
    for (int f0 = 0; f0 < total; f0 += kThreads * kLoads) {
      int dd[kLoads], jj[kLoads];
      float ww[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int f = f0 + u * kThreads + t;
        jj[u] = -1;
        if (f < total) {
          int j = 0;
          while (start[j + 1] <= f) ++j;
          const int i = slice[j][0] + (f - start[j]);
          dd[u] = __ldg(docids + i);
          ww[u] = __ldg(weights + i);
          jj[u] = j;
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (jj[u] >= 0 && dd[u] >= lo && dd[u] < hi)
          atomicAdd(&part[jj[u]][dd[u] - lo], ww[u]);
    }
    __syncthreads();      // every slice has landed
    for (int j = 0; j < ns; ++j) acc += part[j][t];    // in segment order
    __syncthreads();      // the rows are read before the next chunk
  }
  const int d = lo + t;
  if (d < hi) out[d] = d == 0 ? 0.f : acc;
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
