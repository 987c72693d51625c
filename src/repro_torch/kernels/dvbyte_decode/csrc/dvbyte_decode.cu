// Double-VByte block decode: (NB, B) uint8 blocks with [start, end) payload
// bounds -> (g, f, valid), each (NB, B), one potential posting per byte
// position: at the terminator byte of every primary code, its gap g and
// frequency f; zero and invalid everywhere else.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/dvbyte_decode/kernel.py,
// dvbyte_decode_kernel (body _decode_tile), which decoded a VMEM tile of
// 256 blocks with log-step scans across byte positions and a loop over the
// B positions for Algorithm 2's escape pairing, vectorised across blocks.
// The plain PyTorch version of the same function is
// ../../../core/device_index.py:decode_blocks (re-exported by ../ref.py).
//
// What bounds it on an H100: memory.  It reads B + 8 bytes per block and
// writes 9 bytes per byte position (two int32 and one bool), so the output
// is nine times the input; the decode itself is a few integer operations
// per byte.
//
// What the design does about it:
//   * one thread decodes one block sequentially, as the paper's decoder
//     does, with Algorithm 2's escape pairing as a one-value look-back (an
//     escape primary waits for the next value, which completes its f).
//     Blocks with end <= start skip the decode and come out all zero;
//   * a CUDA block of kRows threads handles kRows consecutive blocks: their
//     bytes are staged into shared memory with coalesced loads, each thread
//     writes its decoded row into shared memory (rows padded to an odd
//     number of 32-bit words, so the threads of a warp hit distinct banks),
//     and the CUDA block then writes the three outputs to device memory
//     coalesced, rather than each thread writing its own row with a stride
//     of B elements;
//   * the result is exact integer arithmetic; a rerun gives the same bytes.
//
// Interface: a plain C function, dv_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the outputs; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // blocks (and threads) per CUDA block

struct Layout {
  int in_stride;    // bytes per staged input row (odd number of words)
  int out_stride;   // int32 words per staged g or f row (odd)
  int v_stride;     // bytes per staged valid row (odd number of words)
};

__global__ void __launch_bounds__(kRows)
decode_kernel(const uint8_t* __restrict__ blocks,
              const int32_t* __restrict__ start,
              const int32_t* __restrict__ end, int nb, int B, int F,
              Layout L, int32_t* __restrict__ g_out,
              int32_t* __restrict__ f_out, uint8_t* __restrict__ v_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* s_g = reinterpret_cast<int32_t*>(smem);
  int32_t* s_f = s_g + kRows * L.out_stride;
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_f + kRows * L.out_stride);
  uint8_t* s_v = s_in + kRows * L.in_stride;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = nb - row0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const uint8_t* src = blocks + row0 * B;
  for (int i = tid; i < rows * B; i += kRows) {
    const int r = i / B;
    s_in[r * L.in_stride + (i - r * B)] = src[i];
  }
  int32_t* g = s_g + tid * L.out_stride;
  int32_t* f = s_f + tid * L.out_stride;
  uint8_t* v = s_v + tid * L.v_stride;
  for (int p = 0; p < B; ++p) {
    g[p] = 0;
    f[p] = 0;
    v[p] = 0;
  }
  __syncthreads();

  if (tid < rows) {
    const int st = max(0, start[row0 + tid]);
    const int en = min(B, end[row0 + tid]);
    const uint8_t* row = s_in + tid * L.in_stride;
    uint32_t acc = 0;
    int k = 0;
    int pending = -1;          // position of an escape primary awaiting f
    for (int p = st; p < en; ++p) {
      const uint32_t b = row[p];
      acc += (b & 0x7fu) << (7 * min(k, 4));
      if (b & 0x80u) {
        ++k;
        continue;
      }
      const int val = static_cast<int>(acc);
      acc = 0;
      k = 0;
      if (val <= 0) continue;        // null byte: not a value
      if (pending >= 0) {            // consumed: completes the escape
        f[pending] = F + val - 1;
        pending = -1;
        continue;
      }
      const int m = val % F;
      g[p] = m > 0 ? 1 + val / F : val / F;
      v[p] = 1;
      if (m > 0) f[p] = m;
      else pending = p;
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * B; i += kRows) {
    const int r = i / B;
    const int c = i - r * B;
    const long long o = row0 * B + i;
    g_out[o] = s_g[r * L.out_stride + c];
    f_out[o] = s_f[r * L.out_stride + c];
    v_out[o] = s_v[r * L.v_stride + c];
  }
}

}  // namespace

extern "C" int dv_launch(const void* blocks, const void* start,
                         const void* end, int nb, int B, int F, void* g,
                         void* f, void* valid, void* stream) {
  if (nb < 0 || B < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  L.in_stride = (((B + 3) / 4) | 1) * 4;
  L.out_stride = B | 1;
  L.v_stride = L.in_stride;
  const size_t smem = static_cast<size_t>(kRows) *
                      (2 * 4 * L.out_stride + L.in_stride + L.v_stride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nb > 0) {
    const int grid = (nb + kRows - 1) / kRows;
    decode_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(end),
        nb, B, F, L, static_cast<int32_t*>(g), static_cast<int32_t*>(f),
        static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
