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
// What bounds it on an H100: memory, and mostly the writes.  It reads 8
// bytes of bounds per block and the B bytes of a block only where
// end > start, and writes 9 bytes per byte position (two int32 and one
// bool) for every block.  On the split path most gathered blocks lie past
// their term's chain (end = 0), so the launch is mostly a stream of zeros;
// the decode itself is a few integer operations per byte.
//
// What the design does about it:
//   * no shared memory and no staging: each half-warp owns one block (two
//     a warp, eight a CTA), each lane four consecutive byte positions, and
//     every output is stored straight from registers, coalesced, 16 bytes
//     a lane for g and f and 4 for valid (B = 64 and aligned rows;
//     otherwise one element at a time), with the streaming (evict-first)
//     hint, since the outputs are several times the L2; nothing but
//     registers, capped at 40, limits the CTAs on an SM (48 warps), and
//     the CTAs in flight write neighbouring rows;
//   * the bounds are read first; a warp whose two blocks are both empty
//     stores zeros and never reads their bytes;
//   * a non-empty block is decoded by its 16 lanes at once, in the closed
//     form of decode_blocks: __ballot_sync masks of terminators, each code
//     starting after the previous terminator (clz of the mask below it),
//     payload prefix sums and the running maximum of the sums at
//     terminators by half-warp scans, values > 0 ranked by __popcll,
//     Algorithm 2's escape pairing by the parity of the run of escapes
//     before each value, and a consumed value's F + v - 1 moved to its
//     primary by one shuffle from the lane of the nearest one to the right;
//   * every step mirrors the plain version's arithmetic in 32-bit wrapping
//     integers, so the result is bit-identical for any bytes, and a rerun
//     gives the same bytes.
//
// Interface: a plain C function, dv_launch, which launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper (../kernel.py)
// allocates the outputs; the kernel allocates nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                  // 4 warps: 8 blocks a CTA
constexpr int kCtasPerSm = 12;                 // registers capped at 40
constexpr int kRowsPerCta = kThreads / 16;     // a half-warp per block
constexpr int kPer = 4;                        // byte positions per lane
constexpr int kMaxB = 16 * kPer;               // 64: one bit per position
constexpr unsigned kFull = 0xffffffffu;

// bit i of the low 16 bits of x -> bit 4i of the result
__device__ __forceinline__ uint64_t spread4(uint32_t x) {
  uint64_t v = x & 0xffffu;
  v = (v | (v << 24)) & 0x000000ff000000ffull;
  v = (v | (v << 12)) & 0x000f000f000f000full;
  v = (v | (v << 6)) & 0x0303030303030303ull;
  v = (v | (v << 3)) & 0x1111111111111111ull;
  return v;
}

// The block's 64-bit mask of positions 4j + k (lane j of this half-warp)
// where pred[k] holds; shift is 16 times the half-warp's index.
__device__ __forceinline__ uint64_t row_mask(const bool (&pred)[kPer],
                                             int shift) {
  uint64_t m = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    m |= spread4(__ballot_sync(kFull, pred[k]) >> shift) << k;
  return m;
}

__device__ __forceinline__ uint64_t below(int p) {   // bits [0, p)
  return (1ull << p) - 1;
}

__device__ __forceinline__ int highest(uint64_t m) {  // m != 0
  return 63 - __clzll(static_cast<long long>(m));
}

// Decode the four byte positions p0 .. p0 + 3 that this lane holds (their
// bytes in w) of its half-warp's block, whose payload is [st, en), into
// g, f and prim.  Every lane of the warp calls it together (ballots and
// shuffles); the lanes of an empty block (st >= en) come out all zero.
__device__ __forceinline__ void decode(uint32_t w, int p0, int st, int en,
                                       int j, int shift, int F,
                                       int (&g)[kPer], int (&f)[kPer],
                                       bool (&prim)[kPer]) {
  bool inside[kPer], term[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = p0 + k;
    inside[k] = p >= st && p < en;
    term[k] = inside[k] && !((w >> (8 * k)) & 0x80u);
  }
  const uint64_t T = row_mask(term, shift);

  // payload of each byte, shifted by its place in its code
  uint32_t csum[kPer];
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = p0 + k;
    const uint64_t bt = T & below(p);
    const int code_start = max(bt ? highest(bt) + 1 : 0, st);
    const int place = min(max(p - code_start, 0), 4);
    const uint32_t pay =
        inside[k] ? (((w >> (8 * k)) & 0x7fu) << (7 * place)) : 0u;
    run += pay;
    csum[k] = run;
  }
  // inclusive prefix sums across the block (32-bit wrapping)
  uint32_t incl = run;
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, d, 16);
    if (j >= d) incl += v;
  }
  const uint32_t excl = incl - run;
  int lane_max = INT_MIN;                      // of the sums at terminators
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    csum[k] += excl;
    if (term[k]) lane_max = max(lane_max, static_cast<int>(csum[k]));
  }
  int imax = lane_max;
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const int v = __shfl_up_sync(kFull, imax, d, 16);
    if (j >= d) imax = max(imax, v);
  }
  int carry = __shfl_up_sync(kFull, imax, 1, 16);
  if (j == 0) carry = INT_MIN;
  // value at a terminator: its sum less the largest sum at an earlier
  // terminator (at least 0), as decode_blocks takes it
  int value[kPer], mod[kPer];
  bool isv[kPer], non_esc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t prev = static_cast<uint32_t>(max(carry, 0));
    value[k] = term[k] ? static_cast<int>(csum[k] - prev) : 0;
    if (term[k]) carry = max(carry, static_cast<int>(csum[k]));
    isv[k] = term[k] && value[k] > 0;
    mod[k] = isv[k] ? value[k] % F : 0;
    non_esc[k] = isv[k] && mod[k] != 0;
  }
  const uint64_t V = row_mask(isv, shift);
  const uint64_t E = row_mask(non_esc, shift);

  // Algorithm 2: a value is consumed (completes its predecessor's escape)
  // iff the run of escapes right before it has odd length
  int fpatch[kPer];
  bool pos_patch[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = p0 + k;
    const int rank = __popcll(V & (below(p) | (1ull << p)));
    const uint64_t eb = E & below(p);
    const int last_ne =
        eb ? __popcll(V & (below(highest(eb)) | (1ull << highest(eb)))) : 0;
    const bool consumed = isv[k] && ((rank - 1 - last_ne) & 1);
    prim[k] = isv[k] && !consumed;
    const int v = value[k];
    g[k] = prim[k] ? (mod[k] > 0 ? 1 + v / F : v / F) : 0;
    f[k] = prim[k] && mod[k] > 0 ? mod[k] : 0;
    fpatch[k] = consumed ? static_cast<int>(static_cast<uint32_t>(F) +
                                            static_cast<uint32_t>(v) - 1u)
                         : 0;
    pos_patch[k] = fpatch[k] > 0;
  }
  // an escape primary takes the nearest positive patch at or after it:
  // inside the lane, or the first one of the lane holding the nearest one
  // further right
  const uint64_t P = row_mask(pos_patch, shift);
  int first = 0;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k)
    if (pos_patch[k]) first = fpatch[k];
  const uint64_t after = j == 15 ? 0 : P & ~below(p0 + kPer);
  const int src =
      after ? (__ffsll(static_cast<long long>(after)) - 1) / kPer : j;
  int held = __shfl_sync(kFull, first, src, 16);
  if (!after) held = 0;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    if (pos_patch[k]) held = fpatch[k];
    if (prim[k] && f[k] == 0) f[k] = held;
  }
}

// Store one block's four positions p0 .. p0 + 3 of this lane.
template <bool kVec>
__device__ __forceinline__ void store(long long base, int p0, int B,
                                      const int (&g)[kPer],
                                      const int (&f)[kPer],
                                      const bool (&prim)[kPer],
                                      int32_t* __restrict__ g_out,
                                      int32_t* __restrict__ f_out,
                                      uint8_t* __restrict__ v_out) {
  if (kVec) {
    __stcs(reinterpret_cast<int4*>(g_out + base),
           make_int4(g[0], g[1], g[2], g[3]));
    __stcs(reinterpret_cast<int4*>(f_out + base),
           make_int4(f[0], f[1], f[2], f[3]));
    __stcs(reinterpret_cast<unsigned int*>(v_out + base),
           static_cast<unsigned int>(prim[0]) |
               static_cast<unsigned int>(prim[1]) << 8 |
               static_cast<unsigned int>(prim[2]) << 16 |
               static_cast<unsigned int>(prim[3]) << 24);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (p0 + k < B) {
        g_out[base + k] = g[k];
        f_out[base + k] = f[k];
        v_out[base + k] = prim[k];
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
decode_kernel(const uint8_t* __restrict__ blocks,
              const int32_t* __restrict__ start,
              const int32_t* __restrict__ end, int nb, int B, int F,
              int32_t* __restrict__ g_out, int32_t* __restrict__ f_out,
              uint8_t* __restrict__ v_out) {
  const int lane = threadIdx.x & 31;
  const int j = lane & 15;                     // lane within the block
  const int shift = lane & 16;                 // this block's ballot bits
  const int p0 = kPer * j;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 4;
  const bool has = row < nb;
  int st = 0, en = 0;
  if (has) {
    st = max(0, __ldg(start + row));
    en = min(B, __ldg(end + row));
  }
  const bool busy = en > st;
  const long long base = row * B + p0;
  int g[kPer] = {0, 0, 0, 0};
  int f[kPer] = {0, 0, 0, 0};
  bool prim[kPer] = {false, false, false, false};
  if (__any_sync(kFull, busy)) {               // uniform across the warp
    uint32_t w = 0;
    if (busy) {
      if (kVec) {
        w = __ldg(reinterpret_cast<const uint32_t*>(blocks + base));
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (p0 + k < B)
            w |= static_cast<uint32_t>(blocks[base + k]) << (8 * k);
      }
    }
    decode(w, p0, st, en, j, shift, F, g, f, prim);
  }
  if (has) store<kVec>(base, p0, B, g, f, prim, g_out, f_out, v_out);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

}  // namespace

extern "C" int dv_launch(const void* blocks, const void* start,
                         const void* end, int nb, int B, int F, void* g,
                         void* f, void* valid, void* stream) {
  if (nb < 0 || B < 1 || B > kMaxB || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    const int grid = (nb + kRowsPerCta - 1) / kRowsPerCta;
    const bool vec = B == kMaxB && aligned(blocks, 4) && aligned(g, 16) &&
                     aligned(f, 16) && aligned(valid, 4);
    auto kernel = vec ? decode_kernel<true> : decode_kernel<false>;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(end),
        nb, B, F, static_cast<int32_t*>(g), static_cast<int32_t*>(f),
        static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
