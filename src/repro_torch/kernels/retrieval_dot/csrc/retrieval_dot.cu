// Two-tower candidate scores: out (q, n) = Q (q, d) · C (n, d)ᵀ, float32
// inputs, float32 accumulation.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/retrieval_dot/kernel.py,
// retrieval_dot_kernel (body _dot_tile), which padded Q and C to
// (128, 512, 128) tiles and accumulated each (128, 512) output block over
// the d axis on the MXU, grid step by grid step.  The plain PyTorch version
// of the same function is ../ref.py:retrieval_dot_ref.
//
// What bounds it on an H100: memory.  The serving shape is one user against
// many candidates (q = 1, d = 256): every candidate row is read once and
// used for 2·q·d operations, a quarter of an operation per byte at q = 1,
// far below the ~20 operations per byte at which 67 TFLOP/s of float32
// would be the limit.  At the retrieval_cand shape (1 × 1,000,448 × 256)
// the kernel must read 1.02 GB: about 0.31 ms at 3.35 TB/s.  To stream at
// that rate the card needs some tens of KB of loads in flight on every SM.
//
// What the design does about it: it reads C once, with many 16-byte loads
// in flight, and keeps everything else on chip.
//   * A group of kLanes = 16 lanes owns one candidate row, so a warp works
//     on two rows at once.  Each lane issues kLoads = 4 float4 loads of its
//     row before it uses any of them: at d = 256 the whole row is in flight
//     at once, 2 KB a warp.  The loads of one instruction cover 256
//     contiguous bytes of a row.  They are streaming loads (evict-first):
//     C is read once.  This applies when d % 4 == 0 and both bases are
//     16-byte aligned; otherwise the same loop runs on scalars.
//   * Q is tiny (q·d floats) and read by every row, so it is read through
//     the read-only cache (L1) and not staged: no shared memory, no barrier,
//     and a block starts loading C at once.  Up to kTileQ query rows are
//     scored per pass over a row; the row's later passes (q > kTileQ) read
//     it again.  Each lane keeps one partial sum per query row.
//   * The partial sums of a row meet in a fixed xor-butterfly of shuffles
//     within the group (offsets 8, 4, 2, 1), so every run adds in the same
//     order and a rerun gives the same bits.  Lane j of the group writes
//     query j's score.
//   * The grid covers the rows in one pass, kRowsPerBlock = 16 rows a
//     block: blocks that finish make room for the next ones, which start
//     loading at once.  (On an H100 at 1 × 73,474 × 256 and 1 × 1,000,448
//     × 256 this was as fast as or faster than a persistent grid of one to
//     four waves of what the occupancy query allows, and faster than a
//     variant that streams C through shared memory by bulk copies; the
//     streaming loads were faster than plain read-only ones.)
//   * Offsets into C and into the output are 64-bit (n · d passes 2^31 at
//     the retrieval_cand shape).
//   * No tensor cores: TF32 would break parity with the float32 plain
//     version, and the work is bound by bytes, not operations.
//
// Interface: a plain C function, rd_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the output; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanes = 16;                       // lanes per candidate row
constexpr int kRowsPerWarp = 32 / kLanes;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kLoads = 4;                        // loads in flight per lane
constexpr int kTileQ = 8;                        // query rows per pass
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileQ <= kLanes, "lane j of a group writes query j");

template <int TQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
retrieval_dot_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ c, int64_t n, int d,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;                 // lane within the row group
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5)) * kRowsPerWarp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  const int dv = VEC ? d / 4 : d;                // row length in load units
  // the warp's loop bound is uniform, so the shuffles see every lane
  for (int64_t base = first; base < n; base += stride) {
    const int64_t row = base + lane / kLanes;
    const bool valid = row < n;
    const int64_t at = (valid ? row : 0) * dv;
    for (int q0 = 0; q0 < nq; q0 += TQ) {
      const int tq = min(TQ, nq - q0);
      float acc[TQ];
#pragma unroll
      for (int j = 0; j < TQ; ++j) acc[j] = 0.f;
      for (int k0 = 0; k0 < dv; k0 += kLanes * kLoads) {
        if (VEC) {
          const float4* c4 = reinterpret_cast<const float4*>(c) + at;
          const float4* q4 = reinterpret_cast<const float4*>(q);
          float4 v[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int k = k0 + u * kLanes + sub;
            v[u] = valid && k < dv ? __ldcs(c4 + k)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int k = k0 + u * kLanes + sub;
            if (k < dv) {
#pragma unroll
              for (int j = 0; j < TQ; ++j) {
                const float4 w = __ldg(
                    q4 + static_cast<int64_t>(q0 + min(j, tq - 1)) * dv + k);
                acc[j] = fmaf(w.x, v[u].x, acc[j]);
                acc[j] = fmaf(w.y, v[u].y, acc[j]);
                acc[j] = fmaf(w.z, v[u].z, acc[j]);
                acc[j] = fmaf(w.w, v[u].w, acc[j]);
              }
            }
          }
        } else {
          float v[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int k = k0 + u * kLanes + sub;
            v[u] = valid && k < dv ? __ldcs(c + at + k) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int k = k0 + u * kLanes + sub;
            if (k < dv) {
#pragma unroll
              for (int j = 0; j < TQ; ++j)
                acc[j] = fmaf(__ldg(q + static_cast<int64_t>(
                                            q0 + min(j, tq - 1)) * dv + k),
                              v[u], acc[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          acc[j] += __shfl_xor_sync(kFull, acc[j], off);
      }
      if (valid) {
#pragma unroll
        for (int j = 0; j < TQ; ++j)
          if (sub == j && j < tq)
            out[static_cast<int64_t>(q0 + j) * n + row] = acc[j];
      }
    }
  }
}

template <int TQ>
int launch(const float* q, int nq, const float* c, int64_t n, int d,
           float* out, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  // one pass over the rows; past 2^30 blocks the blocks stride
  const int64_t want = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const int grid = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  if (vec)
    retrieval_dot_kernel<TQ, true><<<grid, kThreads, 0, stream>>>(
        q, nq, c, n, d, out);
  else
    retrieval_dot_kernel<TQ, false><<<grid, kThreads, 0, stream>>>(
        q, nq, c, n, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rd_launch(const void* q, int nq, const void* c, long long n,
                         int d, void* out, void* stream) {
  if (nq < 0 || n < 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* cf = static_cast<const float*>(c);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return nq == 1 ? launch<1>(qf, nq, cf, n, d, of, s)
                 : launch<kTileQ>(qf, nq, cf, n, d, of, s);
}
