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
// the kernel must read 1.02 GB: about 0.31 ms at 3.35 TB/s.
//
// What the design does about it: it streams C once per tile of up to
// kTileQ query rows and keeps everything else on chip.
//   * Each block stages a tile of up to kTileQ rows of Q in shared memory
//     (zero rows past q); a loop over tiles covers q > kTileQ.
//   * One warp takes one candidate row at a time (rows strided over all
//     warps of the grid); its lanes read the row with coalesced 16-byte
//     float4 loads along d, 512 bytes per warp and step, when d % 4 == 0 and
//     both bases are 16-byte aligned; a scalar loop covers the rest of the
//     row (all of it otherwise).  Each lane keeps one partial sum per query
//     row of the tile.
//   * The partial sums of a row meet in a fixed xor-butterfly of warp
//     shuffles (offsets 16, 8, 4, 2, 1), so every run adds in the same
//     order and a rerun gives the same bits.  Lane j writes query j's score.
//   * Offsets into C and into the output are 64-bit (n · d passes 2^31 at
//     the retrieval_cand shape).
//   * No tensor cores: TF32 would break parity with the float32 plain
//     version, and the work is bound by bytes, not operations.
//   * One block holds 8 warps; the grid is capped at 8 blocks per SM, the
//     most the SM keeps resident, and strides over the rows.
//
// Interface: a plain C function, rd_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the output; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = 8;
constexpr int kMaxD = 4096;          // kTileQ · kMaxD floats of shared memory
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int TQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
retrieval_dot_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ c, int64_t n, int d,
                     float* __restrict__ out) {
  extern __shared__ float4 qs4[];              // (TQ, d) floats
  float* qs = reinterpret_cast<float*>(qs4);
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  const int d4 = VEC ? d / 4 : 0;
  for (int q0 = 0; q0 < nq; q0 += TQ) {
    const int tq = min(TQ, nq - q0);
    __syncthreads();                           // the last tile is done
    for (int i = threadIdx.x; i < TQ * d; i += kThreads) {
      const int j = i / d;
      qs[i] = j < tq ? q[static_cast<int64_t>(q0 + j) * d + (i - j * d)]
                     : 0.f;
    }
    __syncthreads();
    for (int64_t row = first; row < n; row += stride) {
      const float* cr = c + row * d;
      float acc[TQ];
#pragma unroll
      for (int j = 0; j < TQ; ++j) acc[j] = 0.f;
      if (VEC) {
        const float4* c4 = reinterpret_cast<const float4*>(cr);
        for (int k = lane; k < d4; k += 32) {
          const float4 v = __ldg(c4 + k);
#pragma unroll
          for (int j = 0; j < TQ; ++j) {
            const float4 w = reinterpret_cast<const float4*>(qs + j * d)[k];
            acc[j] = fmaf(w.x, v.x, acc[j]);
            acc[j] = fmaf(w.y, v.y, acc[j]);
            acc[j] = fmaf(w.z, v.z, acc[j]);
            acc[j] = fmaf(w.w, v.w, acc[j]);
          }
        }
      }
      for (int k = 4 * d4 + lane; k < d; k += 32) {
        const float v = __ldg(cr + k);
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[j] = fmaf(qs[j * d + k], v, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[j] += __shfl_xor_sync(kFull, acc[j], off);
      }
#pragma unroll
      for (int j = 0; j < TQ; ++j)
        if (lane == j && j < tq)
          out[static_cast<int64_t>(q0 + j) * n + row] = acc[j];
    }
  }
}

template <int TQ, bool VEC>
int launch(const float* q, int nq, const float* c, int64_t n, int d,
           float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * TQ * d;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(retrieval_dot_kernel<TQ, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (n + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(want < cap ? want : cap);
  retrieval_dot_kernel<TQ, VEC><<<grid, kThreads, smem, stream>>>(
      q, nq, c, n, d, out);
  return static_cast<int>(cudaGetLastError());
}

template <int TQ>
int launch_tq(const float* q, int nq, const float* c, int64_t n, int d,
              float* out, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  return vec ? launch<TQ, true>(q, nq, c, n, d, out, stream)
             : launch<TQ, false>(q, nq, c, n, d, out, stream);
}

}  // namespace

extern "C" int rd_launch(const void* q, int nq, const void* c, long long n,
                         int d, void* out, void* stream) {
  if (nq < 0 || n < 0 || d < 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* cf = static_cast<const float*>(c);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return nq == 1 ? launch_tq<1>(qf, nq, cf, n, d, of, s)
                 : launch_tq<kTileQ>(qf, nq, cf, n, d, of, s);
}
