// Fused decode -> docid chaining -> score -> select, one CUDA block per query.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/fused_query/kernel.py,
// fused_query_kernel (body _tile_kernel -> ref.fused_tile), which answered a
// tile of queries per grid step with the (tq, cap+1) accumulator in VMEM.
// The plain PyTorch version of the same function is ../ref.py:fused_tile.
//
// What bounds it on an H100: memory, not arithmetic.  Per query it must read
// its packed chain blocks (PB x B bytes per image part) and the per-slot
// metadata, and it must touch a dense (cap+1)-entry accumulator row: one
// zeroing write, one read-modify-write per posting, and the reads of the
// final selection or bitmap.  At cap = 2^17 one row is 512 KB, more than a
// block's 227 KB of shared memory, so the row lives in device memory; a
// batch of 32 rows (16.8 MB) stays resident in the 50 MB L2.  The decode
// itself is a few integer operations per byte.
//
// What the design does about it:
//   * one block per query owns that query's accumulator row, so no two
//     blocks ever touch the same address;
//   * chain blocks are staged into shared memory with coalesced loads, one
//     B-byte row per thread, padded to an odd number of 32-bit words so the
//     per-thread sequential decode reads are free of bank conflicts;
//   * term segments are processed one at a time, separated by
//     __syncthreads().  Within a doc-level term segment every docid occurs at
//     most once, so the accumulator read-modify-writes need no atomics, and
//     the adds run in term-major order -- the order of the plain version --
//     which makes the result deterministic, bit for bit, from run to run;
//   * the float arithmetic uses the round-to-nearest intrinsics, so no
//     multiply-add is contracted into an FMA the plain version does not do;
//   * selection is kk rounds of a block-wide argmax in canonical order
//     (score descending, docid ascending), each round excluding what the
//     earlier rounds chose.
//
// Interface: a plain C function, fq_launch, which launches on the caller's
// stream and returns cudaGetLastError().  Outputs and scratch are allocated
// by the Python wrapper (../kernel.py); the kernel allocates nothing.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kConjunctive = 0, kRankedTfidf = 1, kBm25 = 2 };

struct Part {
  const uint8_t* gat;     // (Q, pb, B) packed chain blocks
  const int32_t* start;   // (Q, pb) first payload byte
  const int32_t* end;     // (Q, pb) one past the last payload byte (0 = pad)
  const int32_t* seg;     // (Q, pb) owning term segment
  const int32_t* lastd0;  // (Q, pb) docid base of the segment's head block
  const int32_t* dnum0;   // (Q, pb) b-gap base (-1: frozen, absolute chain)
  const float* widf;      // (Q, pb) idf weight of the owning term
  int pb;
};

struct Args {
  Part part[2];
  int nparts;
  int B, F, cap, mode, kk;
  int row_stride;           // bytes per staged row in shared memory
  const int32_t* nterms;    // (Q,)
  const float* doclens;     // (ndoclens,)
  int ndoclens;
  const float* norm;        // (2,) bm25 normalisation
  const uint32_t* alive;    // packed liveness bits, or null
  int32_t* hits;            // (Q, cap+1) scratch, conjunctive
  float* score;             // (Q, cap+1) scratch, ranked
  uint8_t* matches;         // (Q, cap+1) out, conjunctive
  int32_t* top_d;           // (Q, kk) out, ranked
  float* top_s;             // (Q, kk) out, ranked
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ bool alive_bit(const uint32_t* alive, int d) {
  return alive == nullptr || ((alive[d >> 5] >> (d & 31)) & 1u);
}

// Gap of the first value of a block: the leading code is always a primary.
__device__ int first_gap(const uint8_t* row, int st, int en, int F) {
  uint32_t acc = 0;
  int k = 0;
  for (int p = st; p < en; ++p) {
    const uint32_t b = row[p];
    acc += (b & 0x7fu) << (7 * min(k, 4));
    if (b & 0x80u) {
      ++k;
      continue;
    }
    const int v = static_cast<int>(acc);
    acc = 0;
    k = 0;
    if (v > 0) {
      const int m = v % F;
      return m > 0 ? 1 + v / F : v / F;
    }
  }
  return 0;
}

__device__ __forceinline__ void add_posting(const Args& a, int d, int f,
                                            float widf, int32_t* hits,
                                            float* score) {
  if (d < 0 || d > a.cap) return;
  if (a.mode == kConjunctive) {
    hits[d] += 1;
    return;
  }
  const float fv = static_cast<float>(f);
  float w;
  if (a.mode == kBm25) {
    const float dl = a.doclens[min(d, a.ndoclens - 1)];
    const float den = __fadd_rn(__fadd_rn(fv, a.norm[0]),
                                __fmul_rn(a.norm[1], dl));
    w = __fmul_rn(__fdiv_rn(__fmul_rn(fv, 1.9f), den), widf);
  } else {
    w = __fmul_rn(log1pf(fv), widf);
  }
  score[d] = __fadd_rn(score[d], w);
}

// Decode one block (Algorithm 2 with escape pairing) and add every posting.
// ``base`` is the block's first docid minus its first gap.
__device__ void decode_block(const Args& a, const uint8_t* row, int st, int en,
                             int base, float widf, int32_t* hits,
                             float* score) {
  const int F = a.F;
  uint32_t acc = 0;
  int k = 0;
  int within = 0;
  bool pending = false;   // an escape primary awaiting its pair
  int pending_doc = 0;
  for (int p = st; p < en; ++p) {
    const uint32_t b = row[p];
    acc += (b & 0x7fu) << (7 * min(k, 4));
    if (b & 0x80u) {
      ++k;
      continue;
    }
    const int v = static_cast<int>(acc);
    acc = 0;
    k = 0;
    if (v <= 0) continue;            // null byte: not a value
    if (pending) {                   // consumed: completes the escape
      add_posting(a, pending_doc, F + v - 1, widf, hits, score);
      pending = false;
      continue;
    }
    const int m = v % F;
    within += m > 0 ? 1 + v / F : v / F;
    const int d = base + within;
    if (m > 0) {
      add_posting(a, d, m, widf, hits, score);
    } else {
      pending = true;
      pending_doc = d;
    }
  }
  if (pending) add_posting(a, pending_doc, 0, widf, hits, score);
}

// Block-wide inclusive prefix sum; *total receives the sum of all threads.
__device__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  if (w == 0) {
    int x = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += n;
    }
    if (lane < kWarps) s_warp[lane] = x;
  }
  __syncthreads();
  const int pre = w > 0 ? s_warp[w - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();
  return v + pre;
}

// First slot after ``cur`` that leaves segment ``sid`` (or pb).
__device__ int segment_end(const Part& P, size_t row, int cur, int sid,
                           int* s_slot) {
  int e = P.pb;
  for (int base = cur + 1; base < P.pb; base += kThreads) {
    const int s = base + threadIdx.x;
    const bool edge = s < P.pb && (P.seg[row + s] != sid || P.end[row + s] == 0);
    if (threadIdx.x == 0) *s_slot = P.pb;
    __syncthreads();
    if (edge) atomicMin(s_slot, s);
    __syncthreads();
    e = *s_slot;
    __syncthreads();
    if (e < P.pb) break;
  }
  return e;
}

// Canonical order: higher score first, then lower docid.
__device__ __forceinline__ bool better(float s, int d, float bs, int bd) {
  return s > bs || (s == bs && d < bd);
}

__global__ void __launch_bounds__(kThreads) fused_query_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t s_rows[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_int[2];
  __shared__ float s_red_s[kWarps];
  __shared__ int s_red_d[kWarps];

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int ncol = a.cap + 1;
  const bool conj = a.mode == kConjunctive;
  int32_t* hits = a.hits + static_cast<size_t>(q) * ncol;
  float* score = a.score + static_cast<size_t>(q) * ncol;

  for (int d = tid; d < ncol; d += kThreads) {
    if (conj) hits[d] = 0;
    else score[d] = 0.f;
  }
  __syncthreads();

  for (int pi = 0; pi < a.nparts; ++pi) {
    const Part& P = a.part[pi];
    const size_t row = static_cast<size_t>(q) * P.pb;
    int cur = 0;
    while (cur < P.pb) {
      if (P.end[row + cur] == 0) break;      // pad slots fill the rest
      const int sid = P.seg[row + cur];
      const int e = segment_end(P, row, cur, sid, &s_int[1]);
      int carry = 0;
      for (int base = cur; base < e; base += kThreads) {
        const int n = min(kThreads, e - base);
        const uint8_t* src = P.gat + (row + base) * a.B;
        for (int i = tid; i < n * a.B; i += kThreads) {
          const int r = i / a.B;
          s_rows[r * a.row_stride + (i - r * a.B)] = src[i];
        }
        __syncthreads();
        const int s = base + tid;
        const bool act = tid < n;
        const uint8_t* mine = s_rows + tid * a.row_stride;
        int st = 0, en = 0, fg = 0;
        if (act) {
          st = P.start[row + s];
          en = P.end[row + s];
          fg = first_gap(mine, st, en, a.F);
        }
        if (base == cur && tid == 0) s_int[0] = fg;   // the head's first gap
        int total;
        const int incl = block_scan(fg, s_warp, &total) + carry;
        const int fg_head = s_int[0];
        if (act) {
          const int dn0 = P.dnum0[row + s];
          const int dnum_eff = dn0 < 0 ? fg_head : dn0;
          const int first = s == cur ? P.lastd0[row + s] + fg
                                     : dnum_eff + (incl - fg_head);
          decode_block(a, mine, st, en, first - fg, P.widf[row + s], hits,
                       score);
        }
        carry += total;
        __syncthreads();   // staged rows reused; this segment's adds done
      }
      cur = e;
    }
  }

  if (conj) {
    const int nt = a.nterms[q];
    uint8_t* out = a.matches + static_cast<size_t>(q) * ncol;
    for (int d = tid; d < ncol; d += kThreads)
      out[d] = d > 0 && nt > 0 && hits[d] == nt && alive_bit(a.alive, d);
    return;
  }

  const int lane = tid & 31;
  const int w = tid >> 5;
  float prev_s = 0.f;
  int prev_d = -1;
  for (int r = 0; r < a.kk; ++r) {
    float bs = neg_inf();
    int bd = INT_MAX;
    for (int d = tid; d < ncol; d += kThreads) {
      const float v = alive_bit(a.alive, d) ? score[d] : 0.f;
      const bool after = r == 0 || v < prev_s || (v == prev_s && d > prev_d);
      if (after && better(v, d, bs, bd)) {
        bs = v;
        bd = d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_down_sync(kFull, bs, o);
      const int od = __shfl_down_sync(kFull, bd, o);
      if (better(os, od, bs, bd)) {
        bs = os;
        bd = od;
      }
    }
    if (lane == 0) {
      s_red_s[w] = bs;
      s_red_d[w] = bd;
    }
    __syncthreads();
    if (w == 0) {
      bs = lane < kWarps ? s_red_s[lane] : neg_inf();
      bd = lane < kWarps ? s_red_d[lane] : INT_MAX;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float os = __shfl_down_sync(kFull, bs, o);
        const int od = __shfl_down_sync(kFull, bd, o);
        if (better(os, od, bs, bd)) {
          bs = os;
          bd = od;
        }
      }
      if (lane == 0) {
        a.top_s[static_cast<size_t>(q) * a.kk + r] = bs;
        a.top_d[static_cast<size_t>(q) * a.kk + r] = bd;
        s_red_s[0] = bs;
        s_red_d[0] = bd;
      }
    }
    __syncthreads();
    prev_s = s_red_s[0];
    prev_d = s_red_d[0];
    __syncthreads();
  }
}

}  // namespace

extern "C" int fq_launch(const void* const* part_ptrs, const int* part_pb,
                         int nparts, int Q, int B, int F, int cap, int mode,
                         int kk, const void* nterms, const void* doclens,
                         int ndoclens, const void* norm, const void* alive,
                         void* acc, void* matches, void* top_d, void* top_s,
                         void* stream) {
  if (nparts < 1 || nparts > 2) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  for (int i = 0; i < nparts; ++i) {
    const void* const* p = part_ptrs + 7 * i;
    a.part[i].gat = static_cast<const uint8_t*>(p[0]);
    a.part[i].start = static_cast<const int32_t*>(p[1]);
    a.part[i].end = static_cast<const int32_t*>(p[2]);
    a.part[i].seg = static_cast<const int32_t*>(p[3]);
    a.part[i].lastd0 = static_cast<const int32_t*>(p[4]);
    a.part[i].dnum0 = static_cast<const int32_t*>(p[5]);
    a.part[i].widf = static_cast<const float*>(p[6]);
    a.part[i].pb = part_pb[i];
  }
  a.nparts = nparts;
  a.B = B;
  a.F = F;
  a.cap = cap;
  a.mode = mode;
  a.kk = kk;
  a.row_stride = (((B + 3) / 4) | 1) * 4;
  a.nterms = static_cast<const int32_t*>(nterms);
  a.doclens = static_cast<const float*>(doclens);
  a.ndoclens = ndoclens;
  a.norm = static_cast<const float*>(norm);
  a.alive = static_cast<const uint32_t*>(alive);
  a.hits = static_cast<int32_t*>(acc);
  a.score = static_cast<float*>(acc);
  a.matches = static_cast<uint8_t*>(matches);
  a.top_d = static_cast<int32_t*>(top_d);
  a.top_s = static_cast<float*>(top_s);
  const size_t smem = static_cast<size_t>(kThreads) * a.row_stride;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Q > 0)
    fused_query_kernel<<<Q, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
